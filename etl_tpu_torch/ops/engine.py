"""DeviceDecoder: the GPU decode engine, on one device.

Port of the reference's `etl_tpu/ops/engine.py` without device egress,
the mesh, the program store or autotune. Pipeline per batch:

  StagedBatch (host, ops/staging.py)
    → host pack: the C packers gather every dense-column field into ONE
      [R, ΣW] byte matrix (planar nibble pairs, [R, ΣW/2], when every
      dense kind fits the 15-symbol alphabet) plus [R, C] lengths, written
      straight into pinned host buffers
    → device: a non-blocking H2D copy, the parse-and-pack kernel
      (ops/decode_kernel.py, csrc/decode_pack.cu) on the current stream
      emitting the bit-packed uint32[n_words, R] words (ops/bitpack.py),
      a non-blocking D2H copy into pinned memory and an event
    → host: exact numpy combines into int64/f64 columns
    → CPU-oracle fallback decode for flagged rows (BC dates, 17-digit
      floats, oversized fields, nibble-alphabet violations)
    → ColumnarBatch (typed columnar + validity + TOAST masks; text
      columns as Arrow-layout TextArrays)

With a publication row filter (`schema.row_predicate`) the device step is
the fused filter (`decode_kernel.prepare_filtered`: K2c, one launch that
filters, packs and compacts, or K2 + the compaction epilogue where the
layout's word tile does not fit) over a per-row disposition vector
(`_row_flags`);
only the survivor count and the 1-bit-per-row keep mask come back with
the dispatch, then a count-sized slice of the compacted words
(`staging.slice_rows`), and the batch assembles over the survivors only
(`StagedBatch.gather_rows`). Its `source_rows` holds each survivor's
staged-row index. A filter the kernel cannot evaluate (text, NUMERIC or
float columns; a postfix program deeper than its stack) applies host-side
after an unfiltered decode (`CompiledRowFilter.host_keep`), with the same
result.

The serial `decode`/`decode_async` run the two stages back to back;
`ops/pipeline.py` runs them on a worker thread with a CUDA stream of its
own: `_pack_stage` (the host pack, into a staging arena's pinned buffers
where the pipeline leases one) and `_dispatch_stage` (uploads, the
launch, the fetch of the words or of the keep mask and count, all on the
current stream, which `_PendingDecode` keeps: a filtered decode's
count-sized second fetch runs on it too, ordered after the kernel).

The packing uses the EXACT specs of each batch: the reference's canonical
layouts (program_store.canonical_plan) only share compiled programs, and
the kernel takes its specs as a runtime descriptor table, so there is
nothing to share. The decoded batch is the same either way.

`device="cpu"` runs the kernel's plain version (bitpack.
parse_and_pack_plain) on CPU tensors: the tests' path. On `"cuda"` there
is no fallback: no card, a failed build or a failed launch raises.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any

import numpy as np
import torch

import logging

from ..models.errors import ErrorKind, EtlError
from ..models.pgtypes import CellKind
from ..models.schema import ReplicatedTableSchema
from ..models.table_row import (Column, ColumnarBatch, TextArray, _to_dense,
                                dense_dtype)
from ..postgres.codec.copy_text import unescape_copy_field
from ..postgres.codec.text import parse_cell_text
from ..telemetry.metrics import (ETL_DECODE_DEVICE_SECONDS_TOTAL,
                                 ETL_DECODE_KERNEL_SECONDS_TOTAL,
                                 ETL_DECODE_ROUTED_DEVICE_ROWS_TOTAL,
                                 ETL_DECODE_ROUTED_ORACLE_ROWS_TOTAL,
                                 registry)
from . import decode_kernel
from .bitpack import (layout_for_specs, saturation_width, unpack_host,
                      unpack_keep_mask)
from .predicate import RowFilterError, compile_row_filter
from .staging import ArenaLease, StagedBatch, bucket_width, slice_rows

# kinds parsed on device; everything else is host-object
DEVICE_KINDS = frozenset({
    CellKind.BOOL, CellKind.I16, CellKind.I32, CellKind.U32, CellKind.I64,
    CellKind.F32, CellKind.F64, CellKind.DATE, CellKind.TIME,
    CellKind.TIMESTAMP, CellKind.TIMESTAMPTZ,
})

# minimum gather widths: enough for the parsers' fixed column positions
# (larger fields fall back via the oversize check)
_MIN_WIDTH = {
    CellKind.DATE: 16,
    CellKind.TIME: 16,
    CellKind.TIMESTAMP: 32,
    CellKind.TIMESTAMPTZ: 32,
    CellKind.F32: 16,
    CellKind.F64: 16,
}
MAX_FIELD_WIDTH = 2048  # beyond this a field goes to CPU fallback

# kinds whose text always fits the 15-symbol nibble alphabet (framer.c):
# digits, sign, dot, colon, space. BOOL ('t'/'f') doesn't; neither do
# floats (PG prints exponent forms).
_NIBBLE_KINDS = frozenset({
    CellKind.I16, CellKind.I32, CellKind.U32, CellKind.I64,
    CellKind.DATE, CellKind.TIME,
    CellKind.TIMESTAMP, CellKind.TIMESTAMPTZ,
})

# object kinds whose Postgres text IS the exact destination form: kept as
# text columns, parsed to Python objects only on value() access
_LAZY_TEXT_KINDS = frozenset({
    CellKind.STRING, CellKind.NUMERIC, CellKind.UUID, CellKind.JSON,
    CellKind.TIMETZ, CellKind.INTERVAL,
})


_TORCH_DTYPE = {np.dtype(np.uint8): torch.uint8,
                np.dtype(np.int32): torch.int32}


def round_up_even(n: int) -> int:
    return (n + 1) & ~1


def accelerator_backend(device: str | torch.device) -> bool:
    """True when decoders on `device` run on a card (CUDA). Gates
    policies that only pay off with a device across the transfer link:
    backlog mega-batching grows seals toward device-size batches, which
    on the CPU's plain versions only makes each batch larger and
    slower."""
    return torch.device(device).type == "cuda"


@dataclasses.dataclass(frozen=True)
class _ColSpec:
    index: int  # position among replicated columns
    kind: CellKind


def _combine(kind: CellKind, rows: list) -> np.ndarray:
    """Exact host-side combine of packed device rows (ordered per
    parsers.COLUMN_COMPONENTS) into the column dtype."""
    if kind is CellKind.BOOL:
        return rows[0].astype(np.bool_)
    if kind in (CellKind.I16, CellKind.I32, CellKind.U32):
        return rows[0].astype(dense_dtype(kind))
    if kind is CellKind.I64:
        neg, l0, l1, l2 = rows
        v = (l2.astype(np.int64) * 10**18 + l1.astype(np.int64) * 10**9
             + l0.astype(np.int64))
        return np.where(neg != 0, -v, v)
    if kind in (CellKind.F32, CellKind.F64):
        neg, l0, l1, ea, sp = rows
        m = (l1.astype(np.int64) * 10**9 + l0.astype(np.int64)) \
            .astype(np.float64)
        ea = ea.astype(np.int64)
        v = np.where(ea >= 0, m * np.power(10.0, np.clip(ea, 0, 22)),
                     m / np.power(10.0, np.clip(-ea, 0, 22)))
        v = np.where(neg != 0, -v, v)
        v = np.where(sp == 1, np.nan, v)
        v = np.where(sp == 2, np.inf, v)
        v = np.where(sp == 3, -np.inf, v)
        return v.astype(dense_dtype(kind))
    if kind is CellKind.DATE:
        return rows[0].astype(np.int32)
    if kind is CellKind.TIME:
        return rows[0].astype(np.int64) * 1000 + rows[1].astype(np.int64)
    if kind in (CellKind.TIMESTAMP, CellKind.TIMESTAMPTZ):
        days, ms, us = rows
        return (days.astype(np.int64) * 86_400_000_000
                + ms.astype(np.int64) * 1000 + us.astype(np.int64))
    raise AssertionError(kind)


class _PinnedPool:
    """Reusable page-locked host buffers keyed by (shape, dtype): pinning
    is a slow CUDA call, and a steady stream reuses a handful of
    shapes. A buffer returns to the pool when the decode that used it has
    completed (its D2H event has fired). Under the decode pipeline the
    worker thread takes buffers and the consumer thread gives them back,
    so a lock guards the free lists."""

    def __init__(self, max_per_key: int = 4):
        self.max_per_key = max_per_key
        self._lock = threading.Lock()
        self._free: dict[tuple, list[torch.Tensor]] = {}

    def take(self, shape: tuple, dtype: torch.dtype) -> torch.Tensor:
        with self._lock:
            free = self._free.get((tuple(shape), dtype))
            if free:
                return free.pop()
        return torch.empty(shape, dtype=dtype, pin_memory=True)

    def give_back(self, bufs) -> None:
        with self._lock:
            for b in bufs:
                free = self._free.setdefault((tuple(b.shape), b.dtype), [])
                if len(free) < self.max_per_key:
                    free.append(b)


@dataclasses.dataclass
class _Packed:
    """Output of the pack stage: the host byte matrix and lengths (pinned
    on CUDA), whether they are nibble-packed, the rows the
    nibble packer flagged, the pinned buffers of the decoder's own pool to
    return once the decode completes (an arena's go back with its lease),
    and for a fused-filter batch the filter and its row disposition
    vector; `pack_s` is the stage's host time."""

    bmat: np.ndarray
    lengths: np.ndarray
    nibble: bool
    bad_rows: np.ndarray | None
    pinned: tuple = ()
    pred: Any = None
    row_flags: np.ndarray | None = None
    pack_s: float = 0.0


@dataclasses.dataclass
class _Filtered:
    """The in-flight half of a fused-filter dispatch: the compiled filter,
    the row disposition vector it ran over, the compacted words (left on
    the device on CUDA, where only the first `counts[0]` columns need be
    written) and the keep mask and survivor count (host tensors; on CUDA
    pinned, landing behind the dispatch's last event)."""

    pred: Any
    row_flags: np.ndarray
    words: torch.Tensor
    mask: torch.Tensor
    counts: torch.Tensor


class _PendingDecode:
    """Handle for an in-flight decode; `result()` completes it. On CUDA
    the words land in pinned memory behind `event` (the counterpart of
    the reference's `copy_to_host_async`), so the host stages and packs
    the next batches while the copy runs; a filtered decode brings back
    only its keep mask and survivor count that way, and fetches a
    count-sized slice of its words at `result()`. After `result()`,
    `timings` holds the batch's stage times in ms — pack, launch (the
    kernel wrapper's host time: its preparation and the launch call; on
    the CPU the plain version's run) and assemble on the host clock, and
    on CUDA h2d, kernel and d2h (plus d2h_words for a filtered decode)
    from the stream's events, `kernel_ms` bracketing the launches alone —
    and `fetched_bytes`, the bytes of results brought from the device.
    `stream` is the CUDA stream the decode was dispatched on (None on the
    CPU): the filtered second fetch is enqueued there, whichever thread
    completes the decode."""

    __slots__ = ("_decoder", "_staged", "_specs", "_packed", "_words",
                 "_events", "_pack_s", "_launch_s", "_filtered", "_done",
                 "stream", "timings")

    def __init__(self, decoder: "DeviceDecoder", staged: StagedBatch,
                 specs: tuple, packed: _Packed | None, words,
                 pack_s: float = 0.0, events: tuple = (),
                 filtered: _Filtered | None = None, launch_s: float = 0.0,
                 stream=None):
        self._decoder = decoder
        self._staged = staged
        self._specs = specs
        self._packed = packed
        self._words = words
        self._pack_s = pack_s
        self._launch_s = launch_s
        self._events = events  # CUDA: before H2D, after H2D, kernel, D2H
        self.stream = stream
        self._filtered = filtered
        self._done: ColumnarBatch | None = None
        self.timings: dict | None = None

    def result(self) -> ColumnarBatch:
        if self._done is None:
            self._done = self._decoder._complete(self)
        return self._done


class DeviceDecoder:
    """Schema-bound batch decoder on one device (`"cuda"` by default,
    `"cpu"` for the plain version).

    Routing has two routes: "device" (the kernel, or its plain version on
    `device="cpu"`) and "oracle" (the CPU codec row by row). The
    reference's third route, the same XLA program on the host CPU for
    mid-size flushes, has no counterpart yet. The default
    `device_min_rows` is therefore the reference's HOST_MIN_ROWS = 64,
    not its DEVICE_MIN_ROWS = 131,072: that threshold was set by a
    45-80 ms tunnel round trip to a remote TPU, while the card here sits
    on the local PCIe bus."""

    DEVICE_MIN_ROWS = 64

    def __init__(self, schema: ReplicatedTableSchema, *,
                 device: str | torch.device = "cuda",
                 numeric_mode: str = "text",
                 device_min_rows: int | None = None):
        self.schema = schema
        self.device = torch.device(device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("DeviceDecoder(device='cuda'): no CUDA "
                                   "device is available")
            decode_kernel.load()
        elif self.device.type != "cpu":
            raise ValueError(f"unsupported device {self.device}")
        self.device_min_rows = self.DEVICE_MIN_ROWS \
            if device_min_rows is None else device_min_rows
        self._pinned = _PinnedPool()
        self._dense: list[_ColSpec] = []
        self._object: list[_ColSpec] = []
        for i, c in enumerate(schema.replicated_columns):
            kind = c.kind
            if kind is CellKind.NUMERIC and numeric_mode == "f64":
                kind = CellKind.F64
            if kind in DEVICE_KINDS:
                self._dense.append(_ColSpec(i, kind))
            else:
                self._object.append(_ColSpec(i, kind))
        if len(self._dense) > 250:
            # the C packers handle 256 columns; the tail spills to the
            # host-object path
            self._object.extend(self._dense[250:])
            self._dense = self._dense[:250]
        # publication row filter: compiled ONCE here, never per batch. An
        # unparseable/unbindable filter degrades to None with a warning:
        # the batch then decodes unfiltered, which is only correct when
        # the server still filters
        self._row_filter = None
        rf = getattr(schema, "row_predicate", None)
        if rf is not None:
            try:
                self._row_filter = compile_row_filter(rf, schema)
            except RowFilterError:
                logging.getLogger("etl_tpu_torch.ops").warning(
                    "row filter %r on %s is outside the client-side "
                    "envelope; decoding UNFILTERED (server-side filtering "
                    "must cover this table)", getattr(rf, "sql", rf),
                    schema.name, exc_info=True)

    # -- internals ----------------------------------------------------------

    def _widths(self, staged: StagedBatch) -> tuple[int, ...]:
        out = []
        for spec in self._dense:
            need = max(staged.max_field_len(spec.index),
                       _MIN_WIDTH.get(spec.kind, 4))
            out.append(bucket_width(need, hi=MAX_FIELD_WIDTH))
        return tuple(out)

    def _specs(self, staged: StagedBatch,
               widths: tuple[int, ...]) -> tuple:
        """(col_index, kind, gather_width, bit_width) per dense column.
        bit_width bounds the packed-output field sizes from the column's
        actual max text length (even, clamped at the kind's saturation
        width)."""
        out = []
        for spec, w in zip(self._dense, widths):
            bw = round_up_even(
                min(max(staged.max_field_len(spec.index), 1), w,
                    saturation_width(spec.kind)))
            out.append((spec.index, spec.kind, w, bw))
        return tuple(out)

    def _can_nibble(self, widths: tuple[int, ...]) -> bool:
        return (all(s.kind in _NIBBLE_KINDS for s in self._dense)
                and all(w % 2 == 0 and w <= 255 for w in widths)
                and len(self._dense) > 0)

    def _pack_host(self, staged: StagedBatch, widths: tuple[int, ...],
                   arena: ArenaLease | None = None) -> _Packed:
        """Gather all dense fields into one byte matrix: nibble-packed C
        path (halves the upload) when the column mix allows, raw C pass
        otherwise, numpy for fields wider than the u8 lengths allow. On
        CUDA the buffers are pinned, so the upload can run async. With an
        `arena` the buffers come from its lease (returned when the
        pipeline releases it), else from the decoder's pinned pool (on
        CUDA) or fresh (on the CPU)."""
        from ..native import pack_bmat, pack_bmat_nibble

        R = staged.row_capacity
        cols = [s.index for s in self._dense]
        pinned: list[torch.Tensor] = []
        cuda = self.device.type == "cuda"

        def buf(shape, dtype):
            tdtype = _TORCH_DTYPE[np.dtype(dtype)]
            if arena is not None:
                return arena.take(shape, tdtype, pinned=cuda).numpy()
            if not cuda:
                return np.empty(shape, dtype=dtype)
            t = self._pinned.take(shape, tdtype)
            pinned.append(t)
            return t.numpy()

        offsets = np.ascontiguousarray(staged.offsets)
        lens_in = np.ascontiguousarray(staged.lengths)
        total_w = sum(widths)
        ldtype = np.uint8 if max(widths, default=0) <= 255 else np.int32
        if ldtype is np.uint8 and self._can_nibble(widths):
            bmat = buf((R, total_w // 2), np.uint8)
            lengths = buf((R, len(cols)), np.uint8)
            bad = np.empty(R, dtype=np.uint8)
            if pack_bmat_nibble(staged.data, offsets, lens_in, cols,
                                list(widths), bmat, lengths, bad):
                return _Packed(bmat, lengths, True, bad, tuple(pinned))
        bmat = buf((R, total_w), np.uint8)
        lengths = buf((R, len(cols)), ldtype)
        if ldtype is np.uint8 and pack_bmat(staged.data, offsets, lens_in,
                                            cols, list(widths), bmat,
                                            lengths):
            return _Packed(bmat, lengths, False, None, tuple(pinned))
        bmat[:] = 0
        lengths[:] = 0
        data = staged.data
        n = len(data)
        cap = staged.row_capacity
        w_off = 0
        for j, (col, w) in enumerate(zip(cols, widths)):
            offs = staged.offsets[:, col].astype(np.int64)
            lens = np.minimum(staged.lengths[:, col], w)
            lengths[:cap, j] = lens
            idx = offs[:, None] + np.arange(w, dtype=np.int64)[None, :]
            np.clip(idx, 0, max(n - 1, 0), out=idx)
            if n:
                g = data[idx]
                mask = np.arange(w, dtype=np.int32)[None, :] < lens[:, None]
                bmat[:cap, w_off : w_off + w] = np.where(mask, g, 0)
            w_off += w
        return _Packed(bmat, lengths, False, None, tuple(pinned))

    def _device_filter_for(self, staged: StagedBatch):
        """The CompiledRowFilter to FUSE into this batch's device step, or
        None. Requires: a filter, a batch the caller allows filtering on
        (insert/COPY streams only), a predicate the kernel can evaluate
        (every referenced column device-parsed with an exact comparison,
        a postfix program that fits the kernel's stack) over dense
        columns. Anything else falls back to `_host_filter_for`'s
        post-decode mask — correct, just without the fetch-bytes win."""
        rf = self._row_filter
        if rf is None or not staged.allow_row_filter \
                or not rf.kernel_supported:
            return None
        dense_idx = frozenset(s.index for s in self._dense)
        if not frozenset(rf.referenced_indices) <= dense_idx:
            return None
        return rf

    def _host_filter_for(self, staged: StagedBatch):
        """The filter to apply host-side AFTER an unfiltered decode (the
        oracle route, and device routes whose predicate is outside the
        kernel's envelope)."""
        rf = self._row_filter
        if rf is None or not staged.allow_row_filter:
            return None
        return rf

    def _row_flags(self, staged: StagedBatch, specs: tuple, pred,
                   bad_rows) -> np.ndarray:
        """Per-row disposition vector for the fused filter: 0 dead (bucket
        padding), 1 live, 2 live + force-keep. Force-keep marks rows whose
        predicate-referenced device values cannot be trusted (COPY
        escapes, nibble-alphabet violations, oversized or TOASTed
        referenced fields): the device keeps them unconditionally and the
        host re-evaluates after oracle fixup, so the compacted output
        equals the host oracle's."""
        n = staged.n_rows
        flags = np.zeros(staged.row_capacity, dtype=np.uint8)
        flags[:n] = 1
        force = np.zeros(n, dtype=bool)
        fb = staged.cpu_fallback_rows
        if len(fb):
            force[fb[fb < n]] = True
        if bad_rows is not None:
            force |= bad_rows[:n].astype(bool)
        widths = {i: w for i, _, w, _ in specs}
        for j in pred.referenced_indices:
            if staged.max_field_len(j) > widths[j]:
                force |= staged.lengths[:n, j] > widths[j]
            toast_col = staged.toast[:n, j]
            if toast_col.any():
                force |= toast_col
        flags[:n][force] = 2
        return flags

    def _pack_stage(self, staged: StagedBatch, specs: tuple,
                    arena: ArenaLease | None = None) -> _Packed:
        """Stage 1: the host gather of all dense fields (into `arena`'s
        buffers where given) and, for a fused-filter batch, its row
        disposition vector. Host work only (numpy and the C packers):
        safe on any thread."""
        pred = self._device_filter_for(staged)
        t0 = time.perf_counter()
        widths = tuple(w for _, _, w, _ in specs)
        packed = self._pack_host(staged, widths, arena)
        if pred is not None:
            packed.pred = pred
            packed.row_flags = self._row_flags(staged, specs, pred,
                                               packed.bad_rows)
        packed.pack_s = time.perf_counter() - t0
        return packed

    def _dispatch_stage(self, staged: StagedBatch, specs: tuple,
                        packed: _Packed) -> _PendingDecode:
        """Stage 2: start the device work on the packed inputs and return
        the in-flight handle. CUDA: the kernel wrapper's host work first
        (descriptors, the walk, outputs, the look-back's status buffer:
        `prepare_*`), then non-blocking H2D from pinned buffers, the
        launch alone between two events on the current stream,
        non-blocking D2H into a pinned buffer, and an event for
        `_PendingDecode.result()` to wait on. A fused-filter dispatch
        uploads its row flags too and fetches only the keep mask and the
        survivor count here."""
        pred, flags, pack_s = packed.pred, packed.row_flags, packed.pack_s
        bmat_h = torch.from_numpy(packed.bmat)
        lengths_h = torch.from_numpy(packed.lengths)
        if self.device.type == "cpu":
            t0 = time.perf_counter()
            if pred is None:
                words = decode_kernel.decode_pack(bmat_h, lengths_h, specs,
                                                  packed.nibble)
                return _PendingDecode(self, staged, specs, packed, words,
                                      pack_s,
                                      launch_s=time.perf_counter() - t0)
            out = decode_kernel.prepare_filtered(
                bmat_h, lengths_h, torch.from_numpy(flags), specs,
                packed.nibble, pred)()
            return _PendingDecode(self, staged, specs, packed, None, pack_s,
                                  filtered=_Filtered(pred, flags, *out),
                                  launch_s=time.perf_counter() - t0)
        stream = torch.cuda.current_stream(self.device)
        bmat_d = torch.empty(bmat_h.shape, dtype=bmat_h.dtype,
                             device=self.device)
        lengths_d = torch.empty(lengths_h.shape, dtype=lengths_h.dtype,
                                device=self.device)
        if pred is not None:
            flags_h = self._pinned.take(flags.shape, torch.uint8)
            flags_h.numpy()[:] = flags
            packed.pinned = packed.pinned + (flags_h,)
            flags_d = torch.empty(flags.shape, dtype=torch.uint8,
                                  device=self.device)
        t0 = time.perf_counter()
        if pred is None:
            launch = decode_kernel.prepare_decode_pack(
                bmat_d, lengths_d, specs, packed.nibble)
        else:
            launch = decode_kernel.prepare_filtered(
                bmat_d, lengths_d, flags_d, specs, packed.nibble, pred)
        launch_s = time.perf_counter() - t0
        ev = tuple(torch.cuda.Event(enable_timing=True) for _ in range(4))
        ev[0].record(stream)
        bmat_d.copy_(bmat_h, non_blocking=True)
        lengths_d.copy_(lengths_h, non_blocking=True)
        if pred is not None:
            flags_d.copy_(flags_h, non_blocking=True)
        ev[1].record(stream)
        t0 = time.perf_counter()
        out = launch()
        launch_s += time.perf_counter() - t0
        ev[2].record(stream)
        if pred is None:
            words_h = self._pinned.take(tuple(out.shape), torch.int32)
            words_h.copy_(out.view(torch.int32), non_blocking=True)
            ev[3].record(stream)
            packed.pinned = packed.pinned + (words_h,)
            return _PendingDecode(self, staged, specs, packed, words_h,
                                  pack_s, ev, launch_s=launch_s,
                                  stream=stream)
        words_d, mask_d, counts_d = out
        mask_h = self._pinned.take(tuple(mask_d.shape), torch.int32)
        counts_h = self._pinned.take((1,), torch.int32)
        mask_h.copy_(mask_d.view(torch.int32), non_blocking=True)
        counts_h.copy_(counts_d, non_blocking=True)
        ev[3].record(stream)
        packed.pinned = packed.pinned + (mask_h, counts_h)
        return _PendingDecode(self, staged, specs, packed, None, pack_s, ev,
                              _Filtered(pred, flags, words_d, mask_h,
                                        counts_h), launch_s, stream)

    def _gather_text(self, staged: StagedBatch, spec: _ColSpec,
                     valid: np.ndarray) -> TextArray:
        """Vectorized gather of a text column into Arrow layout: no
        per-row Python objects."""
        from ..native import gather_string

        n = staged.n_rows
        lens = np.where(valid[:n], staged.lengths[:n, spec.index], 0)
        total = int(lens.sum())
        offsets = np.zeros(n + 1, dtype=np.int32)
        values = np.empty(total, dtype=np.uint8)
        validity = valid[:n].copy()
        if total:
            wrote = gather_string(
                staged.data, np.ascontiguousarray(staged.offsets[:n]),
                np.ascontiguousarray(staged.lengths[:n]),
                np.ascontiguousarray(validity, dtype=np.uint8), spec.index,
                offsets, values)
            if wrote != total:
                raise EtlError(ErrorKind.INVALID_DATA,
                               f"text gather of column {spec.index} wrote "
                               f"{wrote} of {total} bytes")
        return TextArray(offsets, values, validity)

    def _decode_object_column(self, staged: StagedBatch, spec: _ColSpec,
                              valid: np.ndarray) -> Any:
        if spec.kind in _LAZY_TEXT_KINDS:
            return self._gather_text(staged, spec, valid)
        col = self.schema.replicated_columns[spec.index]
        n = staged.n_rows
        out: list[Any] = [None] * n
        offs = staged.offsets[:, spec.index]
        lens = staged.lengths[:, spec.index]
        data = staged.data
        for i in np.flatnonzero(valid[:n]):
            text = data[offs[i] : offs[i] + lens[i]].tobytes().decode("utf-8")
            out[i] = parse_cell_text(text, col.type_oid)
        return out

    def _cpu_fixup(self, staged: StagedBatch, rows: np.ndarray,
                   columns: list[Column]) -> None:
        """Re-decode flagged rows with the CPU oracle and patch columns."""
        cols = self.schema.replicated_columns
        for c in columns:
            if c.is_text and rows.size:
                # fixup needs mutability — densify, PARSING lazy text so
                # the column's value type stays consistent across rows
                if c.lazy_text_oid is not None:
                    oid = c.lazy_text_oid
                    c.data = [None if v is None else parse_cell_text(v, oid)
                              for v in c.data.to_pylist()]
                    c.lazy_text_oid = None
                else:
                    c.data = c.data.to_pylist()
        for i in rows:
            for j, col in enumerate(cols):
                c = columns[j]
                raw = staged.field_bytes(int(i), j)
                if raw is None:
                    continue
                if staged.copy_escapes:
                    raw = unescape_copy_field(raw)
                value = parse_cell_text(raw.decode("utf-8"), col.type_oid)
                if c.is_dense:
                    try:
                        c.data[i] = _to_dense(c.schema.kind, value) \
                            if value is not None else 0
                    except (OverflowError, ValueError) as e:
                        # value doesn't fit the column's declared type —
                        # corrupt data, same as a Rust i32 parse failure
                        raise EtlError(
                            ErrorKind.ROW_CONVERSION_FAILED,
                            f"row {i} col {col.name}: value out of range "
                            f"for {col.type_name}: {value!r}") from e
                else:
                    c.data[i] = value
                c.validity[i] = value is not None

    def _assemble(self, staged: StagedBatch, specs: tuple,
                  packed_np: np.ndarray | None,
                  bad_rows=None) -> tuple[ColumnarBatch, np.ndarray]:
        """Fetched packed words (+ the staged bookkeeping they index) →
        typed columns + CPU fixup; also returns the fixed-up rows. For a
        fused-filter decode `staged` is the COMPACTED view
        (`StagedBatch.gather_rows`) and `packed_np` the survivors' words,
        so every index here lives in the compacted space."""
        n = staged.n_rows
        cols = self.schema.replicated_columns
        valid_full = ~staged.nulls & ~staged.toast

        columns: list[Column] = [None] * len(cols)  # type: ignore[list-item]
        fallback = set(int(r) for r in staged.cpu_fallback_rows)
        if packed_np is None and self._dense:
            # small batch: every row goes to the oracle once
            fallback.update(range(n))
        if bad_rows is not None:
            # nibble pack flagged bytes outside the symbol alphabet
            fallback.update(np.flatnonzero(bad_rows[:n]).tolist())
        if packed_np is not None:
            for spec, (_, _, w, _) in zip(self._dense, specs):
                if staged.max_field_len(spec.index) > w:
                    too_big = staged.lengths[:n, spec.index] > w
                    fallback.update(np.flatnonzero(too_big).tolist())

        layout = layout_for_specs(specs) if packed_np is not None else None
        for j, spec in enumerate(self._dense):
            valid = valid_full[:n, spec.index].copy()
            toast_col = staged.toast[:n, spec.index]
            if packed_np is None:
                data = np.zeros(n, dtype=dense_dtype(spec.kind))
            else:
                ok, comps = unpack_host(layout, packed_np, j, n)
                bad = ~ok & valid
                if bad.any():
                    fallback.update(np.flatnonzero(bad).tolist())
                data = _combine(spec.kind, comps)
            columns[spec.index] = Column(
                cols[spec.index], data, valid,
                toast_col if toast_col.any() else None)

        for spec in self._object:
            valid = valid_full[:, spec.index]
            toast_col = staged.toast[:n, spec.index]
            data_list = self._decode_object_column(
                staged, spec,
                valid & ~np.isin(np.arange(staged.row_capacity),
                                 list(fallback)) if fallback else valid)
            lazy_oid = None
            if spec.kind in _LAZY_TEXT_KINDS \
                    and spec.kind is not CellKind.STRING:
                lazy_oid = cols[spec.index].type_oid
            columns[spec.index] = Column(
                cols[spec.index], data_list, valid[:n].copy(),
                toast_col if toast_col.any() else None,
                lazy_text_oid=lazy_oid)

        rows = np.zeros(0, dtype=np.int64)
        if fallback:
            rows = np.asarray(sorted(r for r in fallback if r < n),
                              dtype=np.int64)
            self._cpu_fixup(staged, rows, columns)
        return ColumnarBatch(self.schema, columns), rows

    def _complete(self, p: _PendingDecode) -> ColumnarBatch:
        """Wait for the words of an in-flight decode, assemble the batch,
        record the stage times and return the pinned buffers."""
        if p._events:
            p._events[-1].synchronize()
        p.timings = {"pack_ms": p._pack_s * 1e3}
        if p._packed is not None:  # the device route: a kernel wrapper ran
            p.timings["launch_ms"] = p._launch_s * 1e3
        if p._events:
            ev = p._events
            p.timings.update(h2d_ms=ev[0].elapsed_time(ev[1]),
                             kernel_ms=ev[1].elapsed_time(ev[2]),
                             d2h_ms=ev[2].elapsed_time(ev[3]))
        if p._filtered is not None:
            batch, fetched = self._complete_filtered(p)
        else:
            t0 = time.perf_counter()
            words = p._words
            fetched = 0
            if isinstance(words, torch.Tensor):
                fetched = words.numel() * words.element_size()
                words = words.numpy().view(np.uint32)
            batch, _ = self._assemble(
                p._staged, p._specs, words,
                p._packed.bad_rows if p._packed is not None else None)
            host_rf = self._host_filter_for(p._staged)
            if host_rf is not None:
                # predicate outside the kernel's envelope (or an oracle-
                # routed batch): the same filter applies host-side over
                # the decoded batch — correct, without the fetch win
                surv = np.flatnonzero(host_rf.host_keep(batch)) \
                    .astype(np.int64)
                batch = batch.take(surv)
                batch.source_rows = surv
            p.timings["assemble_ms"] = (time.perf_counter() - t0) * 1e3
        p.timings["fetched_bytes"] = fetched
        if p._events:
            registry.counter_inc(ETL_DECODE_KERNEL_SECONDS_TOTAL,
                                 p.timings["kernel_ms"] / 1e3)
            registry.counter_inc(ETL_DECODE_DEVICE_SECONDS_TOTAL, sum(
                p.timings[k] for k in ("h2d_ms", "kernel_ms", "d2h_ms",
                                       "d2h_words_ms")
                if k in p.timings) / 1e3)
        if p._packed is not None:
            self._pinned.give_back(p._packed.pinned)
            p._packed = None
        p._words = p._filtered = None
        return batch

    def _complete_filtered(self, p: _PendingDecode
                           ) -> tuple[ColumnarBatch, int]:
        """Completion of a fused filter dispatch: read the survivor count
        and the keep mask, fetch a count-sized slice of the compacted
        words (fetched bytes scale with selectivity), assemble over the
        COMPACTED staged view, then re-judge force-kept and fixed-up
        survivors exactly on their decoded values. Returns the batch and
        the bytes fetched from the device."""
        f = p._filtered
        staged = p._staged
        R = staged.row_capacity
        mask_np = f.mask.numpy().view(np.uint32)
        S = int(f.counts[0])
        fetched = mask_np.nbytes + f.counts.numel() * 4
        survivors = unpack_keep_mask(mask_np, R)
        if len(survivors) != S:
            raise EtlError(ErrorKind.INVALID_DATA,
                           f"filtered decode: keep mask holds "
                           f"{len(survivors)} survivors, count says {S}")
        Sb = slice_rows(S, R)
        n_words = f.words.shape[0]
        if not Sb:
            words_np = np.zeros((n_words, 0), dtype=np.uint32)
        elif f.words.device.type == "cpu":
            words_np = f.words[:, :Sb].numpy()
        else:
            # count-sized slice: only the survivors' words (and the
            # slice's pad slack) cross the link. It runs on the dispatch
            # stream, whichever thread completes the decode: ordered
            # after the kernel there, and the words, allocated on that
            # stream, are read on no other
            stream = p.stream
            words_h = self._pinned.take((n_words, Sb), torch.int32)
            p._packed.pinned = p._packed.pinned + (words_h,)
            ev = tuple(torch.cuda.Event(enable_timing=True)
                       for _ in range(2))
            with torch.cuda.stream(stream):
                ev[0].record(stream)
                decode_kernel.copy_columns(words_h,
                                           f.words.view(torch.int32), Sb)
                ev[1].record(stream)
            ev[1].synchronize()
            p.timings["d2h_words_ms"] = ev[0].elapsed_time(ev[1])
            words_np = words_h.numpy().view(np.uint32)
        fetched += words_np.nbytes
        words_np = words_np[:, :S]
        t0 = time.perf_counter()
        bad_rows = p._packed.bad_rows
        cstaged = staged.gather_rows(survivors)
        cbad = bad_rows[survivors] if bad_rows is not None else None
        batch, fixup_rows = self._assemble(cstaged, p._specs, words_np, cbad)
        # exact arbitration for rows the device could not judge: force-
        # kept rows and every fixed-up row re-evaluate on their DECODED
        # values; rows the re-check rejects compact out host-side
        suspect = f.row_flags[survivors] > 1
        if len(fixup_rows):
            suspect[fixup_rows] = True
        if suspect.any():
            final = ~suspect | f.pred.host_keep(batch)
            if not final.all():
                sel = np.flatnonzero(final).astype(np.int64)
                batch = batch.take(sel)
                survivors = survivors[sel]
        batch.source_rows = survivors
        p.timings["assemble_ms"] = (time.perf_counter() - t0) * 1e3
        return batch, fetched

    # -- public -------------------------------------------------------------

    def _route(self, staged: StagedBatch) -> tuple[str, tuple]:
        """Pick the decode path for this batch: ("device"|"oracle",
        specs); the routed rows count in the routing counters."""
        cols = self.schema.replicated_columns
        if len(cols) != staged.n_cols:
            raise ValueError(
                f"staged batch has {staged.n_cols} cols, schema expects "
                f"{len(cols)}")
        if self._dense and staged.n_rows >= self.device_min_rows:
            registry.counter_inc(ETL_DECODE_ROUTED_DEVICE_ROWS_TOTAL,
                                 staged.n_rows)
            return "device", self._specs(staged, self._widths(staged))
        registry.counter_inc(ETL_DECODE_ROUTED_ORACLE_ROWS_TOTAL,
                             staged.n_rows)
        return "oracle", ()

    def decode_async(self, staged: StagedBatch) -> _PendingDecode:
        """Dispatch the device work and return immediately; stage the next
        batch while this one is in flight."""
        mode, specs = self._route(staged)
        if mode == "oracle":
            return _PendingDecode(self, staged, (), None, None)
        return self._dispatch_stage(staged, specs,
                                    self._pack_stage(staged, specs))

    def decode(self, staged: StagedBatch) -> ColumnarBatch:
        return self.decode_async(staged).result()
