"""Bit-packed device→host result transport.

Copy of the host half of the reference's `etl_tpu/ops/bitpack.py` (the
layout and `unpack_host`, numpy) plus the plain PyTorch version of its
device half: `pack_plain`, `parse_and_pack_plain`, `filter_pack_plain`
and `compact_packed_plain`, the plain versions of the CUDA kernels in
`csrc/decode_pack.cu` (ops/decode_kernel.py), with the reference's
`n_shards` (X1-mesh: `shard_fallback_counts`, shard-local compaction),
and `unpack_keep_mask` / `join_keep_masks`.

Layout (per row): for each dense column in spec order — 1 ok bit, then
each nonzero-width component (parsers.COLUMN_COMPONENTS order), signed
components zigzag-encoded. Fields straddle word boundaries; total width
rounds up to whole uint32 words. The device emits `uint32[n_words, R]`,
the host unpacks with vectorized shifts.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..models.pgtypes import CellKind
from . import parsers

# hard magnitude caps per (kind, component): the parser's ok-check bounds
# the value independently of text width (e.g. an I32 is range-checked), so
# bits never exceed these even for huge gather widths
_DAYS_ZZ_BITS = 23  # year 1..9999 → days ∈ [-719162, 2932896]; zigzag max
#                     = 5,865,792 < 2^23 — 22 bits would corrupt late dates
_MS_BITS = 27  # 0..86_399_999 ms of day
_MS_TZ_ZZ_BITS = 29  # ms shifted by ±16h tz → zigzag
_US_BITS = 10  # 0..999


def _zz_bits(vmax: int) -> int:
    """Bits for zigzag(v), |v| ≤ vmax (zigzag(-m) = 2m-1, zigzag(m) = 2m)."""
    return max(1, (2 * vmax).bit_length())


def _dec_bits(digits: int) -> int:
    """Bits for a non-negative decimal of `digits` chars."""
    if digits <= 0:
        return 0
    return (10**digits - 1).bit_length()


def component_bits(kind: CellKind, comp: str, width: int) -> tuple[int, bool]:
    """(bits, zigzag) for one component given the column's max text width.
    bits == 0 means the component is statically zero and is not packed."""
    d = width  # max text chars ⇒ max decimal digits (sign char only shrinks)
    if kind is CellKind.BOOL:
        return 1, False
    if kind is CellKind.I16:
        return min(_zz_bits(10**min(d, 5) - 1), _zz_bits(32768)), True
    if kind is CellKind.I32:
        if d >= 10:
            return 32, True  # zigzag(int32) always fits 32 bits
        return _zz_bits(10**d - 1), True
    if kind is CellKind.U32:
        return min(_dec_bits(d), 32), False
    if kind is CellKind.I64:
        if comp == "neg":
            return 1, False
        if comp == "l0":
            return _dec_bits(min(d, 9)), False
        if comp == "l1":
            return _dec_bits(min(max(d - 9, 0), 9)), False
        if comp == "l2":
            # ok requires ≤ 19 digits ⇒ top limb ≤ 9
            return (4 if d > 18 else 0), False
    if kind in (CellKind.F32, CellKind.F64):
        if comp == "neg":
            return 1, False
        if comp == "l0":
            return _dec_bits(min(d, 9)), False
        if comp == "l1":
            # mantissa digit count is capped by the parser's fast path (18);
            # limb1 holds digits 9..17 from the right
            return _dec_bits(min(max(d - 9, 0), 9)), False
        if comp == "ea":
            return _zz_bits(22), True  # |exp_adj| ≤ 22 when ok
        if comp == "sp":
            return 2, False
    if kind is CellKind.DATE:
        return _DAYS_ZZ_BITS, True
    if kind is CellKind.TIME:
        return (_MS_BITS, False) if comp == "ms" else (_US_BITS, False)
    if kind is CellKind.TIMESTAMP:
        if comp == "days":
            return _DAYS_ZZ_BITS, True
        return (_MS_BITS, False) if comp == "ms" else (_US_BITS, False)
    if kind is CellKind.TIMESTAMPTZ:
        if comp == "days":
            return _DAYS_ZZ_BITS, True
        return (_MS_TZ_ZZ_BITS, True) if comp == "ms" else (_US_BITS, False)
    raise AssertionError((kind, comp))


def saturation_width(kind: CellKind) -> int:
    """Text width beyond which the layout stops changing — bit widths are
    clamped here so drifting field lengths (e.g. suppressed trailing
    fractional-second zeros) keep one layout (and, in the reference, one
    compiled program)."""
    if kind is CellKind.BOOL:
        return 1
    if kind in (CellKind.DATE, CellKind.TIME, CellKind.TIMESTAMP,
                CellKind.TIMESTAMPTZ):
        return 1  # layout is fixed for these kinds
    if kind is CellKind.I16:
        return 5
    if kind in (CellKind.I32, CellKind.U32):
        return 10
    if kind is CellKind.I64:
        return 19
    if kind in (CellKind.F32, CellKind.F64):
        return 18
    raise AssertionError(kind)


@dataclasses.dataclass(frozen=True)
class FieldSlot:
    comp: str  # component name, or "ok"
    bit_off: int
    bits: int
    zigzag: bool


@dataclasses.dataclass(frozen=True)
class BitLayout:
    """Static packing plan for one (specs, widths) signature."""

    slots: tuple[tuple[FieldSlot, ...], ...]  # per dense column
    n_words: int
    kinds: tuple[CellKind, ...]

    @property
    def total_bits(self) -> int:
        return sum(s.bits for col in self.slots for s in col)


def layout_for_specs(specs: tuple[tuple[int, CellKind, int, int], ...]
                     ) -> BitLayout:
    """THE projection from engine 4-tuple specs (col, kind, gather_width,
    bit_width) to the packed layout. Every site that touches the packed
    words — the plain version, the CUDA kernel's descriptor, the host
    completion — must derive the layout through this one function;
    disagreement silently misreads columns."""
    return build_layout(tuple((i, k, bw) for i, k, _, bw in specs))


def build_layout(specs: tuple[tuple[int, CellKind, int], ...]) -> BitLayout:
    """specs: (col_index, kind, max_text_width) per dense column."""
    cols: list[tuple[FieldSlot, ...]] = []
    off = 0
    for _, kind, width in specs:
        slots = [FieldSlot("ok", off, 1, False)]
        off += 1
        for comp in parsers.COLUMN_COMPONENTS[kind]:
            bits, zz = component_bits(kind, comp, width)
            if bits == 0:
                continue
            slots.append(FieldSlot(comp, off, bits, zz))
            off += bits
        cols.append(tuple(slots))
    return BitLayout(tuple(cols), max(1, -(-off // 32)),
                     tuple(k for _, k, _ in specs))


def pack_plain(layout: BitLayout, columns) -> torch.Tensor:
    """Pack per-column (ok bool[R], comps name→int64[R] holding int32
    values) into uint32[n_words, R]. The words are built in int64 with
    explicit 32-bit masks (CPU torch has no shifts on uint32) and leave
    as int32 bit patterns viewed as uint32, which needs no uint32
    arithmetic on any device."""
    R = columns[0][0].shape[0]
    dev = columns[0][0].device
    words = [torch.zeros(R, dtype=torch.int64, device=dev)
             for _ in range(layout.n_words)]
    for (ok, comps), slots in zip(columns, layout.slots):
        for s in slots:
            if s.comp == "ok":
                v = ok.long()
            else:
                raw = comps[s.comp]
                if s.zigzag:
                    raw = (raw << 1) ^ (raw >> 31)
                v = raw & 0xFFFFFFFF
            v = v & ((1 << s.bits) - 1)
            w, sh = divmod(s.bit_off, 32)
            words[w] = words[w] | ((v << sh) & 0xFFFFFFFF)
            if sh + s.bits > 32:
                words[w + 1] = words[w + 1] | (v >> (32 - sh))
    return parsers.wrap32(torch.stack(words, dim=0)).to(torch.int32) \
        .view(torch.uint32)


def _keep_mask(keep: torch.Tensor) -> torch.Tensor:
    """keep bool[R] → uint32[⌈R/32⌉]: 32 keep bits to a word, little bit
    order, padding bits zero."""
    R = keep.shape[0]
    bits = torch.zeros(-(-R // 32) * 32, dtype=torch.int64,
                       device=keep.device)
    bits[:R] = keep.long()
    shifts = torch.arange(32, dtype=torch.int64, device=keep.device)
    mask = (bits.view(-1, 32) << shifts).sum(dim=1)
    return parsers.wrap32(mask).to(torch.int32).view(torch.uint32)


def _mask_bits(mask: torch.Tensor, n: int) -> torch.Tensor:
    """keep mask uint32[⌈n/32⌉] → keep bool[n]."""
    m = mask.view(torch.int32).long() & 0xFFFFFFFF
    shifts = torch.arange(32, dtype=torch.int64, device=mask.device)
    return ((m[:, None] >> shifts) & 1).flatten()[:n].bool()


def join_keep_masks(masks, rps: int) -> torch.Tensor:
    """The keep mask of a whole batch from its shards' masks, each
    uint32[⌈rps/32⌉] over a block of `rps` rows, joined bit by bit: a
    block whose row count is not a multiple of 32 ends inside a word."""
    return _keep_mask(torch.cat([_mask_bits(m, rps) for m in masks]))


def compact_packed_plain(words: torch.Tensor, keep: torch.Tensor,
                         n_shards: int = 1):
    """Row compaction, shard-local (the reference's
    `bitpack.compact_packed`): the rows split into `n_shards` blocks of
    R / n_shards rows; in each block the kept rows of `words`
    uint32[n_words, R] move, in order, to the front of the block, and
    every position of the block at or after its survivor count is zero.
    Nothing crosses a block boundary.

    Returns (words_compacted uint32[n_words, R], keep_mask
    uint32[⌈R/32⌉], counts int32[n_shards]: the survivors of each block).
    With one shard, the plain version of the compaction epilogue in
    `csrc/decode_pack.cu`; with more, of K2c launched on each block."""
    R = keep.shape[0]
    if n_shards < 1 or R % n_shards:
        raise ValueError(f"{R} rows do not split into {n_shards} shards")
    rps = R // n_shards
    w = words.view(torch.int32)
    out = torch.zeros_like(w)
    counts = []
    for s in range(n_shards):
        k = keep[s * rps:(s + 1) * rps]
        n = int(k.sum())
        out[:, s * rps:s * rps + n] = w[:, s * rps:(s + 1) * rps][:, k]
        counts.append(n)
    counts = torch.tensor(counts, dtype=torch.int32, device=keep.device)
    return out.view(torch.uint32), _keep_mask(keep), counts


def shard_fallback_counts(words: torch.Tensor, lengths: torch.Tensor,
                          layout: "BitLayout", n_shards: int = 1
                          ) -> torch.Tensor:
    """int32[n_shards]: per block of R / n_shards rows, the fallback
    candidates — rows with a field of nonzero length whose packed ok bit
    is clear (the reference's `parse_and_pack(n_shards=…)` second
    output). A zero-length field (NULL, TOAST, a phantom slot, the mesh's
    all-NULL padding rows) is not a failure. Torch ops on the words'
    device, no synchronisation: on a shard's device it reduces that
    shard's block there."""
    w = words.view(torch.int32)
    R = w.shape[1]
    if n_shards < 1 or R % n_shards:
        raise ValueError(f"{R} rows do not split into {n_shards} shards")
    ok = [next(s for s in slots if s.comp == "ok").bit_off
          for slots in layout.slots]
    # one shift a column, then whole-matrix ops: the count costs a few
    # launches more than the columns, whatever their number
    bits = torch.stack([w[o // 32] >> (o % 32) for o in ok])  # [C, R]
    bad = ((bits & 1) == 0) & (lengths.T > 0)
    return bad.any(dim=0).view(n_shards, -1).sum(dim=1, dtype=torch.int32)


def unpack_keep_mask(mask: np.ndarray, n_rows: int) -> np.ndarray:
    """Host half of the keep-mask transport: set-bit positions →
    survivor row indices, ascending (== compaction order)."""
    bits = np.unpackbits(np.ascontiguousarray(mask).view(np.uint8),
                         bitorder="little")[:n_rows]
    return np.flatnonzero(bits).astype(np.int64)


def _parse_pack(bmat: torch.Tensor, lengths: torch.Tensor, specs: tuple,
                nibble: bool, ref_cols: frozenset):
    """Parse and pack every dense column → (words uint32[n_words, R],
    colmap: replicated index → (comps, ok, is_null) of `ref_cols`)."""
    layout = layout_for_specs(specs)
    columns = []
    colmap: dict = {}
    w_off = 0
    for j, (col_idx, kind, width, _bw) in enumerate(specs):
        if nibble:
            b = parsers.unpack_nibbles(
                bmat[:, w_off // 2 : (w_off + width) // 2], width)
        else:
            b = bmat[:, w_off : w_off + width].long()
        w_off += width
        lens = lengths[:, j].long()
        comps, ok = parsers.parse_column(kind, b, lens)
        columns.append((ok, comps))
        if col_idx in ref_cols:
            colmap[col_idx] = (comps, ok, lens == 0)
    return pack_plain(layout, columns), colmap


def parse_and_pack_plain(bmat: torch.Tensor, lengths: torch.Tensor,
                         specs: tuple, nibble: bool, pred=None,
                         row_flags: torch.Tensor | None = None,
                         n_shards: int | None = None):
    """The plain version of the decode kernels: per-column parse
    (parsers.parse_column) + bit-pack (pack_plain) of the packed field
    bytes `bmat` u8[R, ΣW] (u8[R, ΣW/2] planar nibble pairs when
    `nibble`) and `lengths` [R, n_dense] → uint32[n_words, R], the words
    of the reference's `bitpack.parse_and_pack`, bit for bit.

    With `pred` (a predicate.CompiledRowFilter — the fused publication
    row filter) and `row_flags` [R] (0 dead / 1 live / 2 live +
    force-keep), the filter evaluates over the parsed components and the
    survivors compact to the front: returns (words_compacted, keep_mask,
    counts) as the reference's `parse_and_pack(pred=…)` does.

    With `n_shards` (X1-mesh: rows in `n_shards` blocks of R / n_shards)
    the compaction is shard-local (`compact_packed_plain`, one count a
    block) and the per-block fallback-candidate counts
    (`shard_fallback_counts`, over every row, kept or not) come last:
    (words, shard_bad), or (words_compacted, keep_mask, counts,
    shard_bad) under a filter."""
    layout = layout_for_specs(specs)
    if pred is None:
        words = _parse_pack(bmat, lengths, specs, nibble, frozenset())[0]
        if n_shards is None:
            return words
        return words, shard_fallback_counts(words, lengths, layout,
                                            n_shards)
    words, masked, keep = _filter_words(bmat, lengths, row_flags, specs,
                                        nibble, pred)
    if n_shards is None:
        return compact_packed_plain(masked, keep)
    return (*compact_packed_plain(masked, keep, n_shards),
            shard_fallback_counts(words, lengths, layout, n_shards))


def _filter_words(bmat: torch.Tensor, lengths: torch.Tensor,
                  row_flags: torch.Tensor, specs: tuple, nibble: bool, pred):
    """(words, words × keep, both uint32[n_words, R], keep bool[R]): the
    parse, the filter and the zeroing of dropped rows that K2 does."""
    words, colmap = _parse_pack(bmat, lengths, specs, nibble,
                                frozenset(pred.referenced_indices))
    keep = pred.device_keep(colmap, row_flags.long())
    masked = torch.where(keep[None, :], words.view(torch.int32), 0) \
        .view(torch.uint32)
    return words, masked, keep


def filter_pack_plain(bmat: torch.Tensor, lengths: torch.Tensor,
                      row_flags: torch.Tensor, specs: tuple, nibble: bool,
                      pred, block_rows: int):
    """The plain version of the filter kernel (K2) alone: (words × keep
    uint32[n_words, R], keep_mask uint32[⌈R/32⌉], survivor counts
    int32[⌈R/block_rows⌉] per block of `block_rows` rows)."""
    _, words, keep = _filter_words(bmat, lengths, row_flags, specs, nibble,
                                   pred)
    R = keep.shape[0]
    padded = torch.zeros(-(-R // block_rows) * block_rows, dtype=torch.int32,
                         device=keep.device)
    padded[:R] = keep.to(torch.int32)
    return (words, _keep_mask(keep),
            padded.view(-1, block_rows).sum(dim=1, dtype=torch.int32))


def unpack_host(layout: BitLayout, words: np.ndarray, col: int,
                n: int) -> tuple[np.ndarray, list[np.ndarray]]:
    """Extract (ok bool[n], components as int64[n] in COLUMN_COMPONENTS
    order, zeros substituted for omitted ones) for dense column `col` from
    fetched uint32[n_words, R]."""
    kind = layout.kinds[col]
    slots = {s.comp: s for s in layout.slots[col]}

    def get(s: FieldSlot) -> np.ndarray:
        w, sh = divmod(s.bit_off, 32)
        if sh + s.bits <= 32:
            v = (words[w, :n] >> np.uint32(sh)).astype(np.uint64)
        else:
            v = ((words[w, :n].astype(np.uint64) >> np.uint64(sh))
                 | (words[w + 1, :n].astype(np.uint64) << np.uint64(32 - sh)))
        v &= np.uint64((1 << s.bits) - 1)
        u = v.astype(np.int64)
        if s.zigzag:
            u = (u >> 1) ^ -(u & 1)
        return u

    ok = get(slots["ok"]).astype(np.bool_)
    comps = []
    for name in parsers.COLUMN_COMPONENTS[kind]:
        s = slots.get(name)
        comps.append(get(s) if s is not None
                     else np.zeros(n, dtype=np.int64))
    return ok, comps
