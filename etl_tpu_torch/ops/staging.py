"""Host staging: ragged WAL/COPY field bytes → fixed-shape arrays.

Copy of the reference's `etl_tpu/ops/staging.py`. It converts ragged
inputs — pgoutput TupleData values or raw COPY text chunks — into the
dense layout the engine packs for the device:

    data     uint8[capacity]      concatenated field bytes (zero-padded)
    offsets  int32[R, C]          start of each field in `data`
    lengths  int32[R, C]          field byte length
    nulls    bool[R, C]           SQL NULL ('n' tuple kind / COPY \\N)
    toast    bool[R, C]           TOAST-unchanged ('u' tuple kind)

Row counts are bucketed (ROW_BUCKETS); column count C is static per
schema. The COPY path is vectorized numpy; rows containing escape
sequences are flagged for the CPU fallback decoder.

The staging arenas (`StagingArenaPool`) hold the pack stage's buffers as
torch host tensors, page-locked for a CUDA decoder so its upload runs
asynchronously; a lock guards the pool, since the decode pipeline's
worker thread takes buffers that its consumer thread gives back.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Sequence

import numpy as np
import torch

from ..models.errors import ErrorKind, EtlError
from ..postgres.codec.pgoutput import (TUPLE_NULL, TUPLE_TEXT,
                                       TUPLE_UNCHANGED_TOAST, TupleData)

ROW_BUCKETS = (256, 1024, 4096, 16384, 65536, 131072, 262144)


def pad_to_multiple(n: int, multiple: int) -> int:
    """Round `n` up to a multiple of `multiple` (≥1). The mesh decode
    pads row capacity with all-NULL rows so that a bucket the shard
    count does not divide still splits into equal row blocks."""
    if multiple <= 1:
        return n
    return -(-n // multiple) * multiple


def bucket_rows(n: int) -> int:
    """Row-capacity bucket for `n` rows. Staging does not know the mesh:
    the engine pads to the shard count at pack time (`pad_to_multiple`)."""
    for b in ROW_BUCKETS:
        if n <= b:
            return b
    return ((n + ROW_BUCKETS[-1] - 1) // ROW_BUCKETS[-1]) * ROW_BUCKETS[-1]


def bucket_pow2(n: int, lo: int = 8, hi: int = 2048) -> int:
    b = lo
    while b < n and b < hi:
        b *= 2
    return b


def bucket_width(n: int, hi: int = 2048) -> int:
    """Field-width bucket: multiples of 4 up to 32 (tight — upload bytes are
    precious over the device link), then powers of two."""
    if n <= 32:
        return max(4, (n + 3) & ~3)
    return bucket_pow2(n, lo=64, hi=hi)


@dataclass
class StagedBatch:
    """Fixed-shape staging of `n_rows` ragged rows × C fields."""

    data: np.ndarray  # uint8[cap]
    offsets: np.ndarray  # int32[R, C]
    lengths: np.ndarray  # int32[R, C]
    nulls: np.ndarray  # bool[R, C]
    toast: np.ndarray  # bool[R, C]
    n_rows: int  # valid rows (R may be larger: bucketed)
    cpu_fallback_rows: np.ndarray = field(
        default_factory=lambda: np.zeros(0, dtype=np.int64))
    # rows needing the exact CPU decoder (escapes, oversized fields)
    copy_escapes: bool = False  # True: field bytes may carry COPY escapes
    # False: the caller forbids publication row-filter compaction on this
    # batch (runs carrying updates/deletes or old tuples: client-side
    # filtering covers insert/COPY streams only)
    allow_row_filter: bool = True
    _maxlens: np.ndarray | None = field(default=None, repr=False,
                                        compare=False)

    @property
    def row_capacity(self) -> int:
        return self.offsets.shape[0]

    @property
    def n_cols(self) -> int:
        return self.offsets.shape[1]

    def field_bytes(self, row: int, col: int) -> bytes | None:
        """Raw bytes of one field (CPU fallback path)."""
        if self.nulls[row, col] or self.toast[row, col]:
            return None
        off, ln = int(self.offsets[row, col]), int(self.lengths[row, col])
        return self.data[off : off + ln].tobytes()

    def max_field_len(self, col: int) -> int:
        if self.n_rows == 0:
            return 0
        if self._maxlens is None:
            # one pass over all columns, cached: _widths/_specs/_complete
            # each consult per-column maxima on the hot path
            object.__setattr__(self, "_maxlens",
                               self.lengths[: self.n_rows].max(axis=0))
        return int(self._maxlens[col])

    def gather_rows(self, rows: np.ndarray) -> "StagedBatch":
        """Row-compacted view over the SAME data buffer: the per-row
        bookkeeping arrays gather by `rows` (survivor indices from the
        fused filter's compaction), so the host completion — object
        columns, validity, CPU fixup — runs against the compacted index
        space with zero byte copies."""
        fb = self.cpu_fallback_rows
        if len(fb):
            fb = np.flatnonzero(np.isin(rows, fb)).astype(np.int64)

        def take(a):  # np.take: an order of magnitude faster than a[rows]
            return np.take(a, rows, axis=0)

        return StagedBatch(
            self.data, take(self.offsets), take(self.lengths),
            take(self.nulls), take(self.toast), len(rows),
            cpu_fallback_rows=fb, copy_escapes=self.copy_escapes,
            allow_row_filter=False)


def slice_rows(n: int, capacity: int) -> int:
    """Fetch-slice granularity of a filtered decode: survivor counts
    round up to multiples of max(R/16, 256) rows, so the words fetch
    scales with selectivity while its pad slack stays under ~1/16 of the
    batch (the slack term of the `bench --selectivity` gate)."""
    if n <= 0:
        return 0
    step = max(256, capacity // 16)
    return min(capacity, -(-n // step) * step)


def stage_tuples(tuples: Sequence[TupleData], n_cols: int) -> StagedBatch:
    """Stage decoded pgoutput tuples. (The zero-copy path that never builds
    TupleData lives in the native framer; this is the portable version.)"""
    n = len(tuples)
    cap_rows = bucket_rows(n)
    offsets = np.zeros((cap_rows, n_cols), dtype=np.int32)
    lengths = np.zeros((cap_rows, n_cols), dtype=np.int32)
    nulls = np.zeros((cap_rows, n_cols), dtype=np.bool_)
    toast = np.zeros((cap_rows, n_cols), dtype=np.bool_)
    nulls[n:, :] = True  # padding rows are all-NULL

    chunks: list[bytes] = []
    pos = 0
    for i, tup in enumerate(tuples):
        if len(tup) != n_cols:
            raise EtlError(ErrorKind.SCHEMA_MISMATCH,
                           f"tuple {i} has {len(tup)} cols, expected {n_cols}")
        for j, (kind, val) in enumerate(zip(tup.kinds, tup.values)):
            if kind == TUPLE_NULL:
                nulls[i, j] = True
            elif kind == TUPLE_UNCHANGED_TOAST:
                toast[i, j] = True
            elif kind != TUPLE_TEXT:
                # binary tuple format is never requested in START_REPLICATION;
                # staging it as text would silently corrupt values
                raise EtlError(ErrorKind.UNSUPPORTED_TYPE,
                               f"tuple {i} col {j}: binary format not enabled")
            else:
                assert val is not None
                offsets[i, j] = pos
                lengths[i, j] = len(val)
                chunks.append(val)
                pos += len(val)
    data = np.frombuffer(b"".join(chunks), dtype=np.uint8) if chunks else \
        np.zeros(0, dtype=np.uint8)
    return StagedBatch(data, offsets, lengths, nulls, toast, n)


def synthetic_staged_batch(n_cols: int, row_capacity: int) -> StagedBatch:
    """An all-NULL staged batch at an exact row capacity: the IR tier
    (`analysis/ir/catalog.py`) takes the minimum-width device signature
    of a schema from one, through the engine's own `_widths`/`_specs`, so
    the layouts it checks cannot drift from what batches of that schema
    get."""
    return StagedBatch(
        np.zeros(0, dtype=np.uint8),
        np.zeros((row_capacity, n_cols), dtype=np.int32),
        np.zeros((row_capacity, n_cols), dtype=np.int32),
        np.ones((row_capacity, n_cols), dtype=np.bool_),
        np.zeros((row_capacity, n_cols), dtype=np.bool_),
        row_capacity)


_NULL_FIELD_BYTES = (92, 78)  # "\\N"


def stage_copy_chunk(chunk: bytes, n_cols: int) -> StagedBatch:
    """Stage a chunk of COPY text rows (newline-terminated) with a fully
    vectorized delimiter scan. Rows whose fields contain backslash escapes
    (other than a bare \\N null) are routed to `cpu_fallback_rows`."""
    if not chunk:
        return StagedBatch(np.zeros(0, np.uint8), np.zeros((0, n_cols), np.int32),
                           np.zeros((0, n_cols), np.int32),
                           np.zeros((0, n_cols), np.bool_),
                           np.zeros((0, n_cols), np.bool_), 0)
    if not chunk.endswith(b"\n"):
        chunk += b"\n"
    data = np.frombuffer(chunk, dtype=np.uint8)
    is_tab = data == 9
    is_nl = data == 10
    delim_pos = np.flatnonzero(is_tab | is_nl)
    nl_pos = np.flatnonzero(is_nl)
    n_rows = len(nl_pos)
    # each row must contribute exactly n_cols delimiters (C-1 tabs + 1 nl)
    if len(delim_pos) != n_rows * n_cols:
        raise EtlError(
            ErrorKind.COPY_FORMAT_INVALID,
            f"COPY chunk: {len(delim_pos)} delimiters for {n_rows} rows × "
            f"{n_cols} cols")
    ends = delim_pos.reshape(n_rows, n_cols)
    if not np.array_equal(ends[:, -1], nl_pos):
        raise EtlError(ErrorKind.COPY_FORMAT_INVALID,
                       "COPY chunk: ragged rows (tab/newline mismatch)")
    starts = np.empty_like(ends)
    starts[:, 0] = np.concatenate(([0], nl_pos[:-1] + 1))
    starts[:, 1:] = ends[:, :-1] + 1
    lengths = (ends - starts).astype(np.int32)
    offsets = starts.astype(np.int32)

    # NULL detection: field == b"\\N"
    first = data[np.minimum(starts, len(data) - 1)]
    second = data[np.minimum(starts + 1, len(data) - 1)]
    nulls = (lengths == 2) & (first == _NULL_FIELD_BYTES[0]) \
        & (second == _NULL_FIELD_BYTES[1])

    # escape detection per row: any backslash in the row span that is not
    # a \N (chunks with no backslash at all — the common case — skip the
    # cumsum, which costs ~5ms/MiB on the copy hot path)
    is_bs = data == 92
    if is_bs.any():
        bs_cum = np.concatenate(([0], np.cumsum(is_bs)))
        row_start = starts[:, 0]
        row_end = ends[:, -1]
        bs_in_row = bs_cum[row_end] - bs_cum[row_start]
        nulls_in_row = nulls.sum(axis=1)
        fallback = np.flatnonzero(bs_in_row != nulls_in_row)
    else:
        fallback = np.zeros(0, dtype=np.int64)

    cap_rows = bucket_rows(n_rows)
    if cap_rows != n_rows:
        pad = cap_rows - n_rows

        def padrc(a, fill=0):
            return np.concatenate([a, np.full((pad, n_cols), fill, a.dtype)])

        offsets = padrc(offsets)
        lengths = padrc(lengths)
        nulls = padrc(nulls, True)
    toast = np.zeros((cap_rows, n_cols), dtype=np.bool_)
    lengths = np.where(nulls, 0, lengths)
    return StagedBatch(data, offsets, lengths, nulls, toast, n_rows,
                       cpu_fallback_rows=fallback, copy_escapes=True)


# ---------------------------------------------------------------------------
# staging arenas: reusable pack buffers
# ---------------------------------------------------------------------------


class ArenaLease:
    """The set of pool buffers one in-flight decode holds. `take` hands
    out a pooled (or fresh) host tensor; `release` returns every taken
    buffer to the pool at once — called by the pipeline's fetch stage
    after the device result lands, the earliest point reuse cannot race
    the host→device copy of the batch that packed into them."""

    __slots__ = ("_pool", "_taken", "_released")

    def __init__(self, pool: "StagingArenaPool"):
        self._pool = pool
        self._taken: list[torch.Tensor] = []
        self._released = False

    def take(self, shape: tuple, dtype: torch.dtype,
             pinned: bool = False) -> torch.Tensor:
        t = self._pool._take(shape, dtype, pinned)
        self._taken.append(t)
        return t

    def release(self) -> None:
        if self._released:
            return
        self._released = True
        self._pool._give_back(self._taken)
        self._taken = []

    def __enter__(self) -> "ArenaLease":
        return self

    def __exit__(self, *exc) -> None:
        self.release()


class StagingArenaPool:
    """Preallocated pack-buffer pool, bucketed by (shape, dtype, pinned).

    The pack stage writes the byte matrix + lengths for every batch; with
    a fresh (and, for a CUDA decoder, page-locked) buffer per batch the
    host allocator churns tens of MB per dispatch on the hot loop. Pack
    shapes are already coarse — row capacities are bucketed (ROW_BUCKETS)
    and gather widths are bucketed (bucket_width) — so a handful of
    arenas per (row_capacity, widths) signature covers a steady-state
    stream, and the bounded in-flight window (ops/pipeline.py) caps how
    many are ever out at once.

    The C packers overwrite every row up to capacity (zero-padding each
    field to its width), so a reused dirty buffer is safe without
    re-zeroing.
    """

    def __init__(self, max_per_bucket: int = 4):
        self.max_per_bucket = max_per_bucket
        self._lock = threading.Lock()
        self._free: dict[tuple, list[torch.Tensor]] = {}
        # buffers handed out and not yet returned (the leak check of the
        # pipeline tests reads this)
        self.outstanding = 0

    def lease(self) -> ArenaLease:
        return ArenaLease(self)

    def _take(self, shape: tuple, dtype: torch.dtype,
              pinned: bool) -> torch.Tensor:
        key = (tuple(shape), dtype, pinned)
        with self._lock:
            bucket = self._free.get(key)
            t = bucket.pop() if bucket else None
            self.outstanding += 1
        from ..telemetry.metrics import (ETL_STAGING_ARENA_REQUESTS_TOTAL,
                                         registry)

        registry.counter_inc(ETL_STAGING_ARENA_REQUESTS_TOTAL, 1.0,
                             {"result": "hit" if t is not None else "miss"})
        if t is None:
            t = torch.empty(tuple(shape), dtype=dtype, pin_memory=pinned)
        return t

    def _give_back(self, tensors: list[torch.Tensor]) -> None:
        with self._lock:
            self.outstanding -= len(tensors)
            for t in tensors:
                key = (tuple(t.shape), t.dtype, t.is_pinned())
                bucket = self._free.setdefault(key, [])
                if len(bucket) < self.max_per_bucket:
                    bucket.append(t)

    def stats(self) -> dict:
        with self._lock:
            return {"buckets": len(self._free),
                    "free_arrays": sum(len(v) for v in self._free.values()),
                    "free_bytes": sum(t.numel() * t.element_size()
                                      for v in self._free.values()
                                      for t in v),
                    "outstanding": self.outstanding}


#: process-wide pool shared by every decode pipeline (arenas are keyed by
#: exact shape, so cross-table sharing is free and the bound is global)
ARENA_POOL = StagingArenaPool()
