"""Host staging: ragged WAL field bytes → fixed-shape arrays.

Copy of the reference's `etl_tpu/ops/staging.py`, cut to what the WAL
decode path and the fused row filter use (no COPY chunk staging or arena
pool yet). It converts ragged pgoutput TupleData values into the
dense layout the engine packs for the device:

    data     uint8[capacity]      concatenated field bytes (zero-padded)
    offsets  int32[R, C]          start of each field in `data`
    lengths  int32[R, C]          field byte length
    nulls    bool[R, C]           SQL NULL ('n' tuple kind)
    toast    bool[R, C]           TOAST-unchanged ('u' tuple kind)

Row counts are bucketed (ROW_BUCKETS); column count C is static per
schema.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Sequence

import numpy as np

from ..models.errors import ErrorKind, EtlError
from ..postgres.codec.pgoutput import (TUPLE_NULL, TUPLE_TEXT,
                                       TUPLE_UNCHANGED_TOAST, TupleData)

ROW_BUCKETS = (256, 1024, 4096, 16384, 65536, 131072, 262144)


def bucket_rows(n: int) -> int:
    """Row-capacity bucket for `n` rows."""
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
