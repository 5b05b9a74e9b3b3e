"""The egress render kernel (`csrc/egress_render.cu`): build, binding and
wrapper. Counterpart of the reference's device egress program
(`etl_tpu/ops/egress.py::build_egress_program`, an XLA program).

- `render(words, pspecs, plan)`: packed decode words uint32[n_words, R]
  → (ebytes uint8[R, plan.total_width], elens int32[R, len(plan.slots)]),
  `egress.render_plain` byte for byte on every row.
- `prepare_render_shards(words, pspecs, plan)`: the reference's
  row-sharded egress (`build_egress_fn(…, mesh=)`), one launch on each
  shard's words; the caller joins the text and lengths along rows.

The wrapper sends a CPU tensor to the plain version and a CUDA tensor to
the kernel, and raises for any other device. There is no fallback: a
kernel that fails to build or to launch raises. `prepare_render` does the
wrapper's host work (the plan's descriptor, outputs) and returns the
launch, so a caller can time the launch alone. The library is built with
nvcc at first use through the program store (`LIBRARY`), as the decode
kernels are, and loaded with ctypes; `launches` counts the kernel's
launches in this process.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from .bitpack import layout_for_specs
from .decode_kernel import (_PKG, KIND_CODES, NVCC_FLAGS, _nvcc, _reads,
                            prepare_shards)
from .egress import (EGRESS_MAX_COLS, RENDER_COMPONENTS, EgressPlan,
                     render_plain)
from .program_store import Acquired, Library, acquire

SOURCE = _PKG / "csrc" / "egress_render.cu"
# descriptor layout (DESC_* in the source)
DESC_COMP0 = 4
MAX_COMPS = 4
DESC_STRIDE = DESC_COMP0 + 4 * MAX_COMPS

launches = 0
build_seconds: float | None = None
build_log = ""

_lib: ctypes.CDLL | None = None
_lock = threading.Lock()
_load_lock = threading.Lock()
_desc_cache: dict = {}  # (pspecs, plan, device) → descriptor on device
_DESC_CACHE_MAX = 64


def load_library() -> Acquired:
    """Acquire the render library through the program store and make it
    this module's (a build sets `build_seconds` and `build_log`)."""
    global _lib, build_seconds, build_log
    with _load_lock:
        got = acquire(LIBRARY)
        if got.build_seconds is not None:
            build_seconds, build_log = got.build_seconds, got.build_log
        _lib = got.lib
        return got


def load() -> ctypes.CDLL:
    """The render library, acquired at first use."""
    lib = _lib
    return lib if lib is not None else load_library().lib


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a built render library."""
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.etl_egress_render.restype = i32
    lib.etl_egress_render.argtypes = [
        vp, i64, vp, i32, i32,  # words, R, desc, columns, total width
        vp, vp, vp]  # ebytes, elens, stream
    for name, want in (("etl_egress_max_cols", EGRESS_MAX_COLS),
                       ("etl_egress_desc_stride", DESC_STRIDE)):
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = i32, []
        if fn() != want:
            raise RuntimeError(f"{name} disagrees with the source")
    lib.etl_egress_error_string.restype = ctypes.c_char_p
    lib.etl_egress_error_string.argtypes = [i32]
    return lib


LIBRARY = Library("egress_render", SOURCE, _nvcc, NVCC_FLAGS, bind,
                  cuda=True)


def descriptor(pspecs: tuple, plan: EgressPlan) -> list[int]:
    """The kernel's plan descriptor: per rendered column its kind, width,
    byte offset in a row of ebytes and a 0, then (present, bit_off, bits,
    zigzag) for each of the kind's `RENDER_COMPONENTS`, zeros for a
    component the layout omitted and past the kind's components."""
    layout = layout_for_specs(pspecs)
    table: list[int] = []
    for slot, kind, width, off in zip(plan.slots, plan.kinds, plan.widths,
                                      plan.offsets):
        fields = {s.comp: s for s in layout.slots[slot]}
        row = [KIND_CODES[kind], width, off, 0]
        for comp in RENDER_COMPONENTS[kind]:
            s = fields.get(comp)
            row += [0, 0, 0, 0] if s is None \
                else [1, s.bit_off, s.bits, int(s.zigzag)]
        table += row + [0] * (DESC_STRIDE - len(row))
    return table


def _device_desc(pspecs: tuple, plan: EgressPlan, dev) -> torch.Tensor:
    key = (pspecs, plan, dev)
    with _lock:
        desc = _desc_cache.get(key)
        if desc is None:
            if len(_desc_cache) >= _DESC_CACHE_MAX:
                _desc_cache.pop(next(iter(_desc_cache)))
            desc = torch.tensor(descriptor(pspecs, plan), dtype=torch.int32,
                                device=dev)
            _desc_cache[key] = desc
    return desc


def _raise_on(lib, rc: int) -> None:
    if rc != 0:
        raise RuntimeError("egress render launch failed: "
                           + lib.etl_egress_error_string(rc).decode())


def render(words: torch.Tensor, pspecs: tuple, plan: EgressPlan):
    """Render the words of one decode → (ebytes, elens). On CUDA the
    launch goes on the current stream and does not synchronise."""
    return prepare_render(words, pspecs, plan)()


def prepare_render(words: torch.Tensor, pspecs: tuple, plan: EgressPlan):
    """`render`'s host work; returns its launch. The words may be the
    output of a decode launch prepared but not yet made."""
    n_words = layout_for_specs(pspecs).n_words
    if words.dim() != 2 or words.shape[0] != n_words \
            or words.dtype not in (torch.int32, torch.uint32):
        raise ValueError(f"render: words {tuple(words.shape)} "
                         f"{words.dtype} do not fit the layout's "
                         f"{n_words} words")
    if not plan.slots or len(plan.slots) > EGRESS_MAX_COLS:
        raise ValueError("render: the plan renders no column or more than "
                         f"{EGRESS_MAX_COLS}")
    if words.device.type == "cpu":
        return _reads(lambda: render_plain(words, pspecs, plan), words)
    if words.device.type != "cuda":
        raise ValueError(f"render: unsupported device {words.device}")
    lib = load()
    dev = words.device
    words = words.contiguous()
    desc = _device_desc(pspecs, plan, dev)
    R = words.shape[1]
    ebytes = torch.empty((R, plan.total_width), dtype=torch.uint8,
                         device=dev)
    elens = torch.empty((R, len(plan.slots)), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    args = (words.data_ptr(), R, desc.data_ptr(), len(plan.slots),
            plan.total_width, ebytes.data_ptr(), elens.data_ptr(), stream)

    def launch():
        global launches
        if R:
            _raise_on(lib, lib.etl_egress_render(*args))
            with _lock:
                launches += 1
        return ebytes, elens

    launch.outputs = (ebytes, elens)
    return _reads(launch, words)


def prepare_render_shards(words: list, pspecs: tuple,
                          plan: EgressPlan) -> list:
    """The render on each shard's words (X2-mesh: the words of a row
    block in, its text and lengths out — the render is elementwise along
    rows): one prepared launch a shard, prepared with the shard's device
    current and called so (`decode_kernel.prepare_shards`)."""
    return prepare_shards(prepare_render, words, rest=(pspecs, plan))
