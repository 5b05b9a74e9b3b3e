"""The decode kernels (`csrc/decode_pack.cu`): build, binding and
wrappers. Counterpart of the reference's `etl_tpu/ops/pallas_kernel.py`.

- `decode_pack(bmat, lengths, specs, nibble)`: the reference's
  `bitpack.parse_and_pack` words (K1).
- `filter_pack_compact(bmat, lengths, row_flags, specs, nibble, pred)`:
  the fused row filter in one launch (K2c: K2's walk with the compaction
  folded in by a decoupled look-back) → (words, keep_mask, counts), equal
  to `parse_and_pack(pred=…)` in `words[:, :count]`, the mask and the
  count; columns at or past the count are not written.
- `prepare_decode_pack_shards`, `prepare_filtered_shards`: the same
  launches on each shard's row block of a mesh (`row_blocks`,
  parallel/mesh.py), each called with its shard's device current
  (`device_scope`).
- `decode_pack_filtered(bmat, lengths, row_flags, specs, nibble, pred)`:
  the same function with the reference's full contract (zeros behind the
  survivors), in two launches: `filter_pack` (K2: filter, words × keep,
  keep mask, per-block survivor counts) and `compact_packed` (the
  compaction epilogue). It is the route for a layout whose word tile
  does not fit K2c (`fused_walk`).

Each wrapper sends a CPU tensor to its plain version (`bitpack.
parse_and_pack_plain`, `filter_pack_plain`, `compact_packed_plain`), a
CUDA tensor to its kernel, and raises for any other device. There is no
fallback: a kernel that fails to build or to launch raises. The
`prepare_*` functions do a wrapper's host work (descriptors, the walk,
outputs, the look-back's status buffer) and return the launch, so a
caller can time the launch alone; each wrapper is its prepare, called.

The kernels are compiled with nvcc at first use, as a shared library
with a plain C interface that this module loads with ctypes: a source
that includes no PyTorch header builds in seconds. The build and load go
through the program store (`ops/program_store.py`, `LIBRARY`): a process
loads the library the store holds for this source, these flags, this
nvcc, this CUDA runtime and this card, and builds only on a miss. `launches`,
`filter_launches`, `compact_launches` and `fused_launches` count the
launches of K1, K2, the epilogue and K2c in this process;
`tag_launches` counts them again under the decode tag of the launching
context (`DECODE_TAG`: a shard pod's, say), so that pods sharing the
process are each held to their own launches.

K1 and K2 stage each block's 256 rows through shared memory. `tile_rows`
picks, by shape, how: 256-row tiles where they fit SMEM_BUDGET ("tile"),
else sub-tiles of 128, 64 or 32 rows (one warp's rows) walked in steps
("subtile"), else no tile at all ("direct": the same row body reads
global memory), which is also the choice for a base pointer that is not
16-byte aligned. `path_launches` counts K1's, K2's and K2c's launches by
path. K2c keeps a block's words in a word tile beside the rows' tile.
K1 parses two rows a thread where every column takes the loop-free
integer parse in a tile (`rows_per_thread`), one otherwise; K2 one.
"""

from __future__ import annotations

import contextvars
import ctypes
import os
import shutil
import threading
from pathlib import Path

import torch

from ..models.pgtypes import CellKind
from . import parsers
from .bitpack import (compact_packed_plain, filter_pack_plain,
                      layout_for_specs, parse_and_pack_plain,
                      unpack_keep_mask)
from .predicate import P_CMP, P_NULLTEST
from .program_store import Acquired, Library, acquire

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "decode_pack.cu"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# kind codes of the kernel's column descriptor (enum Kind in the source)
KIND_CODES = {
    CellKind.BOOL: 0, CellKind.I16: 1, CellKind.I32: 2, CellKind.U32: 3,
    CellKind.I64: 4, CellKind.F32: 5, CellKind.F64: 6, CellKind.DATE: 7,
    CellKind.TIME: 8, CellKind.TIMESTAMP: 9, CellKind.TIMESTAMPTZ: 10,
}
# descriptor layout (DESC_* in the source)
DESC_SLOT0 = 4
MAX_SLOTS = 6
DESC_STRIDE = DESC_SLOT0 + 4 * MAX_SLOTS
COMP_OK = -1

INT_KINDS = (CellKind.I16, CellKind.I32, CellKind.U32, CellKind.I64)

# the fixed byte positions each parser reads: narrower fields are refused
# (the reference fails at trace time on them; the engine's gather widths
# are never this narrow)
MIN_WIDTH = {
    CellKind.DATE: 10, CellKind.TIME: 8, CellKind.TIMESTAMP: 19,
    CellKind.TIMESTAMPTZ: 19, CellKind.F32: 9, CellKind.F64: 9,
}

# rows per block of K1 and K2 (FILTER_BLOCK in the source)
FILTER_BLOCK = 256
# dynamic shared memory a K1 or K2 block may take: two blocks fit in one
# H100 SM's 228 KB
SMEM_BUDGET = 100 * 1024

launches = 0
filter_launches = 0
compact_launches = 0
fused_launches = 0
path_launches = {"tile": 0, "subtile": 0, "direct": 0}
#: (decode tag, "k1" | "k2" | "epilogue" | "k2c") → launches under it
tag_launches: dict = {}
#: the decode tag of the calling context. A `DecodePipeline` takes the
#: tag of the context that builds it onto its worker thread, so the
#: launches (and routed batches) of everything a tagged task spawns count
#: under the tag; None counts nowhere but in the totals
DECODE_TAG: contextvars.ContextVar = contextvars.ContextVar(
    "etl_decode_tag", default=None)
build_seconds: float | None = None
build_log = ""

_lib: ctypes.CDLL | None = None
_lock = threading.Lock()
_load_lock = threading.Lock()
_desc_cache: dict = {}  # (specs, nibble, device) → descriptor on device
_pred_cache: dict = {}  # (program, referenced columns, spec columns, device)
_DESC_CACHE_MAX = 64
# K2c's look-back state per (device, stream): launches on one stream run
# one after the other, so each stream has its own status buffer
_scan_states: dict = {}
EPOCH_LIMIT = 1 << 30  # epochs are 30 bits of a status word


def current_tag():
    """The decode tag launches and routed batches count under here: the
    calling worker thread's (see `DECODE_TAG`), else the context's."""
    tag = getattr(threading.current_thread(), "decode_tag", None)
    return tag if tag is not None else DECODE_TAG.get()


def _count_tag(kernel: str) -> None:
    tag = current_tag()
    if tag is not None:
        key = (tag, kernel)
        tag_launches[key] = tag_launches.get(key, 0) + 1


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the decode kernel cannot be built "
                       "(set NVCC or CUDA_HOME)")


def nvcc_command(source: Path, out: Path) -> list[str]:
    """The nvcc command that builds `source` into the shared library
    `out`."""
    return [_nvcc(), *NVCC_FLAGS, "-o", str(out), str(source)]


def load_library() -> Acquired:
    """Acquire the kernel library through the program store and make it
    this module's (a build sets `build_seconds` and `build_log`)."""
    global _lib, build_seconds, build_log
    with _load_lock:
        got = acquire(LIBRARY)
        if got.build_seconds is not None:
            build_seconds, build_log = got.build_seconds, got.build_log
        _lib = got.lib
        return got


def load() -> ctypes.CDLL:
    """The kernel library, acquired at first use."""
    lib = _lib
    return lib if lib is not None else load_library().lib


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a built kernel library."""
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.etl_decode_pack.restype = i32
    lib.etl_decode_pack.argtypes = [
        vp, i64,  # bmat, row_bytes
        vp, i32, i32,  # lengths, u8, cols
        vp, i32,  # desc, nibble
        vp, i64, i32,  # out, R, words
        i32, i32, vp]  # tile_rows, rows a thread, stream
    lib.etl_filter_pack.restype = i32
    lib.etl_filter_pack.argtypes = [
        vp, i64, vp, i32, i32, vp, i32,  # bmat … nibble (as above)
        vp, vp, i32,  # flags, pred, pred_ints
        vp, vp, vp,  # words, mask, block_counts
        i64, i32, i32, vp]  # R, words, tile_rows, stream
    lib.etl_filter_pack_compact.restype = i32
    lib.etl_filter_pack_compact.argtypes = [
        vp, i64, vp, i32, i32, vp, i32,  # bmat … nibble (as above)
        vp, vp, i32,  # flags, pred, pred_ints
        vp, vp, vp,  # out, mask, counts
        vp, vp, ctypes.c_uint64, ctypes.c_uint32,  # status, ticket, base, epoch
        i64, i32, i32, i32, vp]  # R, words, tile_rows, rows a thread, stream
    lib.etl_compact_packed.restype = i32
    lib.etl_compact_packed.argtypes = [
        vp, vp, vp, vp, vp,  # words, mask, block_counts, out, counts
        i64, i32, vp]  # R, words, stream
    lib.etl_copy_2d.restype = i32
    lib.etl_copy_2d.argtypes = [vp, i64, vp, i64, i64, i64, vp]
    lib.etl_filter_block_rows.restype = i32
    lib.etl_filter_block_rows.argtypes = []
    if lib.etl_filter_block_rows() != FILTER_BLOCK:
        raise RuntimeError("FILTER_BLOCK disagrees with the source")
    lib.etl_cuda_error_string.restype = ctypes.c_char_p
    lib.etl_cuda_error_string.argtypes = [ctypes.c_int]
    return lib


LIBRARY = Library("decode_pack", SOURCE, _nvcc, NVCC_FLAGS, bind, cuda=True)


def descriptor(specs: tuple, nibble: bool) -> list[int]:
    """The kernel's column-descriptor table for one spec set: per dense
    column kind, width, byte offset in a row of bmat, slot count, then
    (component index, bit offset, bits, zigzag) per packed slot."""
    layout = layout_for_specs(specs)
    table: list[int] = []
    w_off = 0
    for (_, kind, width, _), slots in zip(specs, layout.slots):
        comps = parsers.COLUMN_COMPONENTS[kind]
        row = [KIND_CODES[kind], width, w_off // 2 if nibble else w_off,
               len(slots)]
        for s in slots:
            row += [COMP_OK if s.comp == "ok" else comps.index(s.comp),
                    s.bit_off, s.bits, int(s.zigzag)]
        table += row + [0] * (DESC_STRIDE - len(row))
        w_off += width
    return table


def _check(bmat: torch.Tensor, lengths: torch.Tensor, specs: tuple,
           nibble: bool) -> None:
    widths = [w for _, _, w, _ in specs]
    total = sum(widths)
    if bmat.dim() != 2 or lengths.dim() != 2:
        raise ValueError("bmat and lengths must be 2-D")
    if bmat.dtype != torch.uint8:
        raise ValueError(f"bmat must be uint8, got {bmat.dtype}")
    if lengths.dtype not in (torch.uint8, torch.int32):
        raise ValueError(f"lengths must be uint8 or int32, got {lengths.dtype}")
    if bmat.shape[1] != (total // 2 if nibble else total) \
            or lengths.shape != (bmat.shape[0], len(specs)):
        raise ValueError(f"shapes {tuple(bmat.shape)}, {tuple(lengths.shape)}"
                         f" do not fit specs {specs} (nibble={nibble})")
    for _, kind, w, _ in specs:
        if w < MIN_WIDTH.get(kind, 1) or (nibble and w % 2):
            raise ValueError(f"width {w} unsupported for {kind.name}"
                             f" (nibble={nibble})")


def decode_pack(bmat: torch.Tensor, lengths: torch.Tensor, specs: tuple,
                nibble: bool, out: torch.Tensor | None = None,
                walk: int | None = None) -> torch.Tensor:
    """Parse and bit-pack every dense column → uint32[n_words, R].

    `bmat` u8[R, ΣW] (u8[R, ΣW/2] planar nibble pairs when `nibble`),
    `lengths` u8 or int32 [R, n_dense], `specs` the engine's
    (col, kind, gather_width, bit_width) tuples. On CUDA, `out` may give
    an int32 or uint32 [n_words, R] buffer to fill; `walk` forces the
    tile rows (256, 128, 64, 32 with one row a thread; 0 direct) in place
    of `tile_rows`'s
    choice, for tests; the call launches on the current stream and does
    not synchronise."""
    return prepare_decode_pack(bmat, lengths, specs, nibble, out, walk)()


def prepare_decode_pack(bmat: torch.Tensor, lengths: torch.Tensor,
                        specs: tuple, nibble: bool,
                        out: torch.Tensor | None = None,
                        walk: int | None = None):
    """`decode_pack`'s host work; returns its launch."""
    _check(bmat, lengths, specs, nibble)
    if bmat.device.type == "cpu" and lengths.device.type == "cpu":
        return _reads(lambda: parse_and_pack_plain(bmat, lengths, specs,
                                                   nibble), bmat, lengths)
    if bmat.device.type != "cuda" or lengths.device != bmat.device:
        raise ValueError(f"decode_pack: unsupported devices {bmat.device}, "
                         f"{lengths.device}")
    lib = load()
    dev = bmat.device
    bmat = bmat.contiguous()
    lengths = lengths.contiguous()
    desc = _device_desc(specs, nibble, dev)
    R = bmat.shape[0]
    n_words = layout_for_specs(specs).n_words
    if out is None:
        out = torch.empty((n_words, R), dtype=torch.int32, device=dev)
    elif out.shape != (n_words, R) or out.device != dev \
            or out.dtype not in (torch.int32, torch.uint32) \
            or not out.is_contiguous():
        raise ValueError("decode_pack: bad output buffer")
    stream = torch.cuda.current_stream(dev).cuda_stream
    rows = tile_rows(bmat, lengths, None, len(specs), 0) if walk is None \
        else walk
    rpt = rows_per_thread(specs, nibble, rows)
    args = (bmat.data_ptr(), bmat.shape[1], lengths.data_ptr(),
            int(lengths.dtype == torch.uint8), len(specs), desc.data_ptr(),
            int(nibble), out.data_ptr(), R, n_words, rows, rpt, stream)

    def launch():
        global launches
        _raise_on(lib, lib.etl_decode_pack(*args), "decode kernel")
        with _lock:
            launches += 1
            path_launches[path_of(rows)] += 1
            _count_tag("k1")
        return out.view(torch.uint32)

    launch.outputs = (out,)
    return _reads(launch, bmat, lengths)


def tile_bytes(rows: int, row_bytes: int, n_cols: int, lengths_u8: bool,
               pred_ints: int, filtered: bool, tile_words: int = 0) -> int:
    """Dynamic shared memory of one K1 (K2 when `filtered`) block with
    tiles of `rows` rows (0: direct, no tile), plus K2c's word tile of
    `tile_words` words a row for FILTER_BLOCK rows, 16-byte aligned: the
    source's `tile_layout` (`etl_tile_bytes`)."""
    total = 0
    if rows:
        stride = row_bytes + 4 if row_bytes % 8 == 0 else row_bytes
        per_row = stride + n_cols * (1 if lengths_u8 else 4) + int(filtered)
        total = rows * per_row + 4 * (n_cols * DESC_STRIDE
                                      + (pred_ints if filtered else 0))
    if tile_words:
        total = -(-total // 16) * 16 + 4 * tile_words * FILTER_BLOCK
    return total


def tile_rows(bmat: torch.Tensor, lengths: torch.Tensor, flags, n_cols: int,
              pred_ints: int) -> int:
    """Rows a K1 or K2 block (K2 when `flags` is given) stages at once:
    256, else the largest of 128, 64, 32 whose tile fits SMEM_BUDGET; 0
    (direct) when none fits or a base pointer is not 16-byte aligned."""
    ptrs = [bmat.data_ptr(), lengths.data_ptr()] \
        + ([] if flags is None else [flags.data_ptr()])
    if any(p % 16 for p in ptrs):
        return 0
    for rows in (256, 128, 64, 32):
        if tile_bytes(rows, bmat.shape[1], n_cols,
                      lengths.dtype == torch.uint8, pred_ints,
                      flags is not None) <= SMEM_BUDGET:
            return rows
    return 0


def fused_walk(bmat: torch.Tensor, lengths: torch.Tensor,
               flags: torch.Tensor, n_cols: int, pred_ints: int,
               n_words: int) -> int | None:
    """The route of a filtered decode, by shape: the walk K2c takes (256,
    else the largest of 128, 64, 32 rows whose tile fits SMEM_BUDGET
    beside the word tile; 0, direct with the word tile alone, where a
    base pointer is not 16-byte aligned), or None where the word tile does
    not fit beside the smallest (32-row) sub-tile: then the decode takes
    the two-launch route, K2 + the epilogue (`decode_pack_filtered`)."""
    fits = [rows for rows in (256, 128, 64, 32)
            if tile_bytes(rows, bmat.shape[1], n_cols,
                          lengths.dtype == torch.uint8, pred_ints, True,
                          n_words) <= SMEM_BUDGET]
    if not fits:
        return None
    if any(p % 16 for p in (bmat.data_ptr(), lengths.data_ptr(),
                            flags.data_ptr())):
        return 0
    return fits[0]


def rows_per_thread(specs: tuple, nibble: bool, rows: int) -> int:
    """K1's rows a thread with tiles of `rows` rows: 2 where every column
    is an integer of at most 16 nibble symbols (the loop-free parse, whose
    two rows' chains interleave) in a tile of 64 rows or more, else 1."""
    return 2 if rows >= 64 and nibble and all(
        k in INT_KINDS and w <= 16 for _, k, w, _ in specs) else 1


def path_of(rows: int) -> str:
    return "tile" if rows == FILTER_BLOCK else "subtile" if rows else "direct"


def pred_descriptor(pred, specs: tuple) -> list[int]:
    """The kernel's predicate descriptor for one filter on one spec set:
    [n_instr, n_ref, the referenced columns' spec slots, then the postfix
    program (`pred.program`) with columns mapped to spec slots, then the
    index K2's single parse reads: the last referenced slot, len(specs) + 1
    offsets into the leaf list, a referenced flag per slot, and the leaf
    list (per slot in spec order, the instruction numbers of its
    comparison leaves)]."""
    if not pred.kernel_supported:
        raise ValueError(f"row filter {pred.filter!r} is outside the "
                         f"kernel's envelope")
    slot_of = {col: (j, kind) for j, (col, kind, _, _) in enumerate(specs)}
    kinds = {b.index: b.kind for b in pred.cols.values()}
    for col, kind in kinds.items():
        if col not in slot_of or slot_of[col][1] is not kind:
            raise ValueError(f"referenced column {col} ({kind.name}) is "
                             f"not a dense column of the specs")
    table = [len(pred.program), len(kinds)]
    refs = [slot_of[c][0] for c in pred.referenced_indices]
    table += refs
    leaves: list[list[int]] = [[] for _ in specs]
    for i, ins in enumerate(pred.program):
        col = slot_of[ins[1]][0] if ins[0] in (P_CMP, P_NULLTEST) else 0
        table += [ins[0], col, *ins[2:]]
        if ins[0] == P_CMP:
            leaves[col].append(i)
    table.append(max(refs, default=-1))
    offsets = [0]
    for col in leaves:
        offsets.append(offsets[-1] + len(col))
    table += offsets + [int(j in refs) for j in range(len(specs))]
    for col in leaves:
        table += col
    return table


def _device_desc(specs: tuple, nibble: bool, dev) -> torch.Tensor:
    key = (specs, nibble, dev)
    with _lock:
        desc = _desc_cache.get(key)
        if desc is None:
            if len(_desc_cache) >= _DESC_CACHE_MAX:
                _desc_cache.pop(next(iter(_desc_cache)))
            desc = torch.tensor(descriptor(specs, nibble), dtype=torch.int32,
                                device=dev)
            _desc_cache[key] = desc
    return desc


def _device_pred(pred, specs: tuple, dev) -> torch.Tensor:
    # keyed on what the descriptor is made of: the bound program names
    # replicated column indices, so one filter text on two tables whose
    # filter column sits at different positions gives two descriptors
    key = (pred.program, pred.referenced_indices,
           tuple((c, k) for c, k, _, _ in specs), dev)
    with _lock:
        desc = _pred_cache.get(key)
        if desc is None:
            if len(_pred_cache) >= _DESC_CACHE_MAX:
                _pred_cache.pop(next(iter(_pred_cache)))
            desc = torch.tensor(pred_descriptor(pred, specs),
                                dtype=torch.int32, device=dev)
            _pred_cache[key] = desc
    return desc


def _reads(launch, *inputs):
    """`launch`, its `inputs` attribute set to the row tensors it reads
    (the IR tier's shard-locality check reads it)."""
    launch.inputs = inputs
    return launch


def _raise_on(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: "
                           + lib.etl_cuda_error_string(rc).decode())


def filter_pack(bmat: torch.Tensor, lengths: torch.Tensor,
                row_flags: torch.Tensor, specs: tuple, nibble: bool, pred,
                walk: int | None = None):
    """K2: evaluate the row filter `pred` (a predicate.CompiledRowFilter)
    and pack the words of the kept rows → (words uint32[n_words, R], zero
    on dropped rows; keep_mask uint32[⌈R/32⌉]; block_counts
    int32[⌈R/FILTER_BLOCK⌉]). `row_flags` u8[R]: 0 dead, 1 live, 2 live +
    force-keep. `walk` as for `decode_pack`."""
    return prepare_filter_pack(bmat, lengths, row_flags, specs, nibble,
                               pred, walk)()


def _filter_inputs(what: str, bmat, lengths, row_flags, specs, nibble,
                   pred) -> tuple | None:
    """Checks of a filter wrapper's inputs; None for CPU tensors (the
    plain version), else (lib, the contiguous inputs, the column and
    predicate descriptors on the device, n_words)."""
    _check(bmat, lengths, specs, nibble)
    R = bmat.shape[0]
    if row_flags.shape != (R,) or row_flags.dtype != torch.uint8:
        raise ValueError("row_flags must be uint8[R]")
    devs = {bmat.device, lengths.device, row_flags.device}
    if devs == {torch.device("cpu")}:
        return None
    if len(devs) != 1 or bmat.device.type != "cuda":
        raise ValueError(f"{what}: unsupported devices {devs}")
    lib = load()
    dev = bmat.device
    return (lib, bmat.contiguous(), lengths.contiguous(),
            row_flags.contiguous(), _device_desc(specs, nibble, dev),
            _device_pred(pred, specs, dev), layout_for_specs(specs).n_words)


def prepare_filter_pack(bmat: torch.Tensor, lengths: torch.Tensor,
                        row_flags: torch.Tensor, specs: tuple, nibble: bool,
                        pred, walk: int | None = None):
    """`filter_pack`'s host work; returns its launch."""
    got = _filter_inputs("filter_pack", bmat, lengths, row_flags, specs,
                         nibble, pred)
    if got is None:
        return _reads(lambda: filter_pack_plain(
            bmat, lengths, row_flags, specs, nibble, pred, FILTER_BLOCK),
            bmat, lengths, row_flags)
    lib, bmat, lengths, row_flags, desc, pdesc, n_words = got
    dev, R = bmat.device, bmat.shape[0]
    words = torch.empty((n_words, R), dtype=torch.int32, device=dev)
    mask = torch.empty(-(-R // 32), dtype=torch.int32, device=dev)
    counts = torch.empty(-(-R // FILTER_BLOCK), dtype=torch.int32,
                         device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rows = tile_rows(bmat, lengths, row_flags, len(specs), pdesc.numel()) \
        if walk is None else walk
    args = (bmat.data_ptr(), bmat.shape[1], lengths.data_ptr(),
            int(lengths.dtype == torch.uint8), len(specs), desc.data_ptr(),
            int(nibble), row_flags.data_ptr(), pdesc.data_ptr(),
            pdesc.numel(), words.data_ptr(), mask.data_ptr(),
            counts.data_ptr(), R, n_words, rows, stream)

    def launch():
        global filter_launches
        _raise_on(lib, lib.etl_filter_pack(*args), "filter kernel")
        with _lock:
            filter_launches += 1
            path_launches[path_of(rows)] += 1
            _count_tag("k2")
        return words.view(torch.uint32), mask.view(torch.uint32), counts

    launch.outputs = (words, mask, counts)
    return _reads(launch, bmat, lengths, row_flags)


def compact_packed(words: torch.Tensor, keep_mask: torch.Tensor,
                   block_counts: torch.Tensor):
    """The compaction epilogue: the kept rows of `words` uint32[n_words, R]
    (the set bits of `keep_mask`) move in order to the front, zeros
    behind → (words_compacted uint32[n_words, R], counts int32[1]).
    `block_counts` holds the survivors of each FILTER_BLOCK rows, as
    `filter_pack` leaves them."""
    return prepare_compact_packed(words, keep_mask, block_counts)()


def prepare_compact_packed(words: torch.Tensor, keep_mask: torch.Tensor,
                           block_counts: torch.Tensor):
    """`compact_packed`'s host work; returns its launch. The inputs may
    be outputs of a K2 launch prepared but not yet made."""
    n_words, R = words.shape
    if keep_mask.shape != (-(-R // 32),) \
            or block_counts.shape != (-(-R // FILTER_BLOCK),):
        raise ValueError("compact_packed: mask or counts do not fit words")
    devs = {words.device, keep_mask.device, block_counts.device}
    if devs == {torch.device("cpu")}:
        def plain():
            keep = torch.zeros(R, dtype=torch.bool)
            keep[torch.from_numpy(unpack_keep_mask(keep_mask.numpy(),
                                                   R))] = True
            out, _, counts = compact_packed_plain(words, keep)
            return out, counts
        return plain
    if len(devs) != 1 or words.device.type != "cuda":
        raise ValueError(f"compact_packed: unsupported devices {devs}")
    lib = load()
    dev = words.device
    words, keep_mask = words.contiguous(), keep_mask.contiguous()
    block_counts = block_counts.contiguous()
    out = torch.empty((n_words, R), dtype=torch.int32, device=dev)
    counts = torch.empty(1, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    args = (words.data_ptr(), keep_mask.data_ptr(), block_counts.data_ptr(),
            out.data_ptr(), counts.data_ptr(), R, n_words, stream)

    def launch():
        global compact_launches
        _raise_on(lib, lib.etl_compact_packed(*args), "compaction kernel")
        with _lock:
            compact_launches += 1
            _count_tag("epilogue")
        return out.view(torch.uint32), counts

    return launch


def decode_pack_filtered(bmat: torch.Tensor, lengths: torch.Tensor,
                         row_flags: torch.Tensor, specs: tuple, nibble: bool,
                         pred):
    """The fused publication row filter: parse, filter by `pred`, pack and
    compact → (words_compacted uint32[n_words, R], keep_mask
    uint32[⌈R/32⌉], counts int32[1]), the reference's
    `parse_and_pack(pred=…)` bit for bit. On CUDA: `filter_pack` then
    `compact_packed` on the current stream, without synchronising."""
    return prepare_decode_pack_filtered(bmat, lengths, row_flags, specs,
                                        nibble, pred)()


def _plain_filtered(bmat, lengths, row_flags, specs, nibble, pred):
    _check(bmat, lengths, specs, nibble)
    return _reads(lambda: parse_and_pack_plain(
        bmat, lengths, specs, nibble, pred=pred, row_flags=row_flags),
        bmat, lengths, row_flags)


def prepare_decode_pack_filtered(bmat: torch.Tensor, lengths: torch.Tensor,
                                 row_flags: torch.Tensor, specs: tuple,
                                 nibble: bool, pred):
    """`decode_pack_filtered`'s host work, for both launches; returns
    the launch of both."""
    if {bmat.device, lengths.device, row_flags.device} \
            == {torch.device("cpu")}:
        return _plain_filtered(bmat, lengths, row_flags, specs, nibble, pred)
    k2 = prepare_filter_pack(bmat, lengths, row_flags, specs, nibble, pred)
    words, mask, block_counts = k2.outputs
    epi = prepare_compact_packed(words, mask, block_counts)

    def launch():
        k2()
        out, counts = epi()
        return out, mask.view(torch.uint32), counts

    return _reads(launch, *k2.inputs)


def filter_pack_compact(bmat: torch.Tensor, lengths: torch.Tensor,
                        row_flags: torch.Tensor, specs: tuple, nibble: bool,
                        pred, walk: int | None = None, rpt: int | None = None):
    """K2c: the fused row filter in one launch → (words uint32[n_words, R],
    keep_mask uint32[⌈R/32⌉], counts int32[1]). `words[:, :counts[0]]`,
    the mask and the count equal the reference's `parse_and_pack(pred=…)`
    (`compact_packed` of K2's words) bit for bit; on CUDA, columns at or
    past the count are NOT written (they hold whatever the allocation
    held), so a caller reads `words[:, :count]` only — the engine fetches
    a count-sized slice. `decode_pack_filtered` keeps the full contract,
    zeros behind. On CPU tensors the plain version (zeros behind).
    `walk` as for `decode_pack`, `rpt` forces the rows a thread (1 or 2)
    in place of `compact_rows_per_thread`'s choice; on CUDA a layout whose
    word tile does not fit (`fused_walk` None) raises: the caller takes
    `decode_pack_filtered` for it. Launches on the current stream, with
    that stream's status buffer, and does not synchronise."""
    return prepare_filter_pack_compact(bmat, lengths, row_flags, specs,
                                       nibble, pred, walk, rpt)()


class _ScanState:
    """K2c's look-back buffer on one stream: int64 [1 + blocks], the
    ticket counter then one status word per logical block; `tickets` is
    how far the launches made so far advanced the counter, `epoch` the
    last launch's epoch."""

    __slots__ = ("buf", "tickets", "epoch")

    def __init__(self, blocks: int, dev):
        self.buf = torch.zeros(1 + blocks, dtype=torch.int64, device=dev)
        self.tickets = 0
        self.epoch = 0


def scan_state(dev, blocks: int) -> _ScanState:
    """The status buffer of the current stream of `dev`, grown (a new
    zeroed buffer, on the stream) to hold `blocks` status words."""
    key = (dev, torch.cuda.current_stream(dev).cuda_stream)
    with _lock:
        st = _scan_states.get(key)
        if st is None or st.buf.numel() < 1 + blocks:
            st = _scan_states[key] = _ScanState(blocks, dev)
    return st


def compact_rows_per_thread(specs: tuple, nibble: bool, rows: int) -> int:
    """K2c's rows a thread with tiles of `rows` rows (0: direct): 2 on
    256-row tiles of the layouts where K1 takes two (`rows_per_thread`:
    every column a nibble integer of at most 16 symbols), 128 threads a
    block at most 64 registers, so 8 blocks fit an SM and the main path's
    1,024 blocks are resident at once; else 1 (longer parses under that
    register cap spill)."""
    return 2 if rows == FILTER_BLOCK \
        and rows_per_thread(specs, nibble, rows) == 2 else 1


def prepare_filter_pack_compact(bmat: torch.Tensor, lengths: torch.Tensor,
                                row_flags: torch.Tensor, specs: tuple,
                                nibble: bool, pred, walk: int | None = None,
                                rpt: int | None = None):
    """`filter_pack_compact`'s host work (descriptors, the walk, outputs,
    the stream's status buffer); returns its launch, which takes the
    launch's epoch and ticket base and advances them once it launched."""
    got = _filter_inputs("filter_pack_compact", bmat, lengths, row_flags,
                         specs, nibble, pred)
    if got is None:
        return _plain_filtered(bmat, lengths, row_flags, specs, nibble, pred)
    lib, bmat, lengths, row_flags, desc, pdesc, n_words = got
    dev, R = bmat.device, bmat.shape[0]
    if R >= 1 << 31:
        raise ValueError("filter_pack_compact: more rows than int32 counts")
    rows = fused_walk(bmat, lengths, row_flags, len(specs), pdesc.numel(),
                      n_words) if walk is None else walk
    if rows is None:
        raise ValueError("filter_pack_compact: the word tile does not fit "
                         "shared memory; use decode_pack_filtered")
    if rpt is None:
        rpt = compact_rows_per_thread(specs, nibble, rows)
    blocks = -(-R // FILTER_BLOCK)
    out = torch.empty((n_words, R), dtype=torch.int32, device=dev)
    mask = torch.empty(-(-R // 32), dtype=torch.int32, device=dev)
    counts = (torch.empty if R else torch.zeros)(1, dtype=torch.int32,
                                                 device=dev)
    st = scan_state(dev, blocks)
    stream = torch.cuda.current_stream(dev).cuda_stream
    head = (bmat.data_ptr(), bmat.shape[1], lengths.data_ptr(),
            int(lengths.dtype == torch.uint8), len(specs), desc.data_ptr(),
            int(nibble), row_flags.data_ptr(), pdesc.data_ptr(),
            pdesc.numel(), out.data_ptr(), mask.data_ptr(), counts.data_ptr(),
            st.buf.data_ptr() + 8, st.buf.data_ptr())

    def launch():
        global fused_launches
        with _lock:
            epoch = st.epoch + 1
            if epoch == EPOCH_LIMIT:  # every 2^30 launches: a clean buffer
                st.buf[1:].zero_()
                epoch = 1
            rc = lib.etl_filter_pack_compact(*head, st.tickets, epoch, R,
                                             n_words, rows, rpt, stream)
            _raise_on(lib, rc, "fused filter kernel")
            st.epoch = epoch
            st.tickets += blocks
            fused_launches += 1
            path_launches[path_of(rows)] += 1
            _count_tag("k2c")
        return out.view(torch.uint32), mask.view(torch.uint32), counts

    return _reads(launch, bmat, lengths, row_flags)


def prepare_filtered(bmat: torch.Tensor, lengths: torch.Tensor,
                     row_flags: torch.Tensor, specs: tuple, nibble: bool,
                     pred):
    """The engine's filtered device step, prepared: K2c
    (`filter_pack_compact`) where the layout's word tile fits
    (`fused_walk`), else K2 + the epilogue (`decode_pack_filtered`),
    chosen by shape before any launch (`fused_launches` counts the first
    route's launches, `filter_launches` and `compact_launches` the
    second's)."""
    got = _filter_inputs("filtered decode", bmat, lengths, row_flags, specs,
                         nibble, pred)
    if got is None:
        return _plain_filtered(bmat, lengths, row_flags, specs, nibble, pred)
    _, bmat, lengths, row_flags, _, pdesc, n_words = got
    rows = fused_walk(bmat, lengths, row_flags, len(specs), pdesc.numel(),
                      n_words)
    if rows is None:
        return prepare_decode_pack_filtered(bmat, lengths, row_flags, specs,
                                            nibble, pred)
    return prepare_filter_pack_compact(bmat, lengths, row_flags, specs,
                                       nibble, pred, walk=rows)


def row_blocks(t: torch.Tensor, n_shards: int) -> list:
    """`t`'s rows (leading dimension) in `n_shards` contiguous blocks of
    R / n_shards rows: views, shard s's block at rows [s·rps, (s+1)·rps).
    Raises where the shard count does not divide the rows."""
    R = t.shape[0]
    if n_shards < 1 or R % n_shards:
        raise ValueError(f"{R} rows do not split into {n_shards} shards")
    rps = R // n_shards
    return [t[s * rps:(s + 1) * rps] for s in range(n_shards)]


def device_scope(dev: torch.device):
    """The context a shard's host work and launch run in: its card made
    current (a kernel launches into the current device's context), or
    nothing on the CPU."""
    import contextlib

    return torch.cuda.device(dev) if dev.type == "cuda" \
        else contextlib.nullcontext()


def prepare_shards(prepare, *blocks, rest: tuple = ()) -> list:
    """One prepared launch a shard: `prepare(*shard's blocks, *rest)`
    with the shard's device current (the device of its first block).
    `blocks` are lists, one tensor a shard each (`row_blocks`, or
    per-shard uploads). Each launch is a wrapper's own — counted, on the
    current stream of the device current when it is called (K2c with
    that stream's status buffer: shards on one stream run one after the
    other, shards on other cards have buffers of their own), and not
    synchronising; the caller calls it with its shard's device current
    (`device_scope`)."""
    out = []
    for args in zip(*blocks):
        with device_scope(args[0].device):
            out.append(prepare(*args, *rest))
    return out


def prepare_decode_pack_shards(bmats: list, lengths: list, specs: tuple,
                               nibble: bool) -> list:
    """K1 on each shard's row block (X1-mesh's parse and pack): one
    prepared launch a shard (`prepare_shards`)."""
    return prepare_shards(prepare_decode_pack, bmats, lengths,
                          rest=(specs, nibble))


def prepare_filtered_shards(bmats: list, lengths: list, flags: list,
                            specs: tuple, nibble: bool, pred) -> list:
    """The filtered decode on each shard's row block: K2c (or K2 + the
    epilogue, by shape) compacting to the front of the block, one count
    a shard — the reference's shard-local `compact_packed(words, keep,
    n_shards)`. One prepared launch a shard (`prepare_shards`)."""
    return prepare_shards(prepare_filtered, bmats, lengths, flags,
                          rest=(specs, nibble, pred))


def copy_columns(dst: torch.Tensor, src: torch.Tensor, n_cols: int) -> None:
    """Asynchronous copy of the first `n_cols` columns of every row of the
    CUDA matrix `src` [n, R] into `dst` [n, ≥ n_cols] (pinned host memory
    for a non-blocking fetch) on the current stream: one strided
    cudaMemcpy2DAsync, no kernel."""
    if src.device.type != "cuda" or not src.is_contiguous() \
            or not dst.is_contiguous() or dst.shape[0] != src.shape[0] \
            or dst.shape[1] < n_cols or dst.element_size() \
            != src.element_size():
        raise ValueError("copy_columns: bad buffers")
    lib = load()
    es = src.element_size()
    _raise_on(lib, lib.etl_copy_2d(
        dst.data_ptr(), dst.shape[1] * es, src.data_ptr(), src.shape[1] * es,
        n_cols * es, src.shape[0],
        torch.cuda.current_stream(src.device).cuda_stream), "strided copy")
