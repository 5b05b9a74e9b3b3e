"""Benchmark: WAL records/s decoded on the pgbench CDC workload, on the GPU.

The decode mode of the repo's `bench.py`, on the port: the same workload
(pgbench_accounts insert CDC, 262,144 rows a batch), the same schema and
the same CPU baseline (per-message `decode_logical_message` +
`decode_insert`). Each measured window frames and stages 6 batches
(`stage_wal_batch`) and decodes them through `DeviceDecoder(device=
"cuda")` with two batches in flight.

    python -m etl_tpu_torch.bench

prints ONE JSON line with the keys of `bench.py` (`metric`, `value`,
`unit`, `vs_baseline`, `engine`, `backend`) plus `device_name`,
`power_limit` and `parity`: the first batch against the port's CPU
decode of the same staged batch, and a sample of rows against the CPU
oracle. It exits non-zero, printing no result, when there is no card.

    python -m etl_tpu_torch.bench --selectivity

runs the reference's `--selectivity` mode (`etl_tpu/benchmarks/
harness.py::run_selectivity`) on the card: the `filter_bench` table at
262,144 rows under publication filters `v < t` keeping 0.1, 0.5 and 0.9
of the rows, each decoded by the fused filter kernel, by the CPU decoder
(the kernel's plain version) and by the oracle route (every row through
the CPU codec, then `host_keep`). It prints one JSON line and exits 0
only when, at every point, the three compacted batches and their
`source_rows` are identical and the filtered decode fetched at most
(measured keep + 0.11) of the unfiltered decode's bytes.

    python -m etl_tpu_torch.bench --copy [--rows N]
    python -m etl_tpu_torch.bench --streaming [--events N]
        [--arrival-rate N] [--row-filter SQL]

run the replication runtime: the reference's `harness.run_table_copy`
(1,000,000 rows) and `run_table_streaming` (500,000 insert events in
500-row transactions, a 30 ms fill window) on the port's `Pipeline` with
the CUDA engine, on pgbench_accounts through the fake walsender, into a
destination that resolves and counts every decoded batch. Each prints one
JSON line (rows/s and MiB/s; events/s and p50/p95 lag, the stage sums,
the run sizes and the device busy share) and exits 0 only when every
check holds: delivered count and digest, order, identity, a 512-row
oracle sample, and for the copy that every chunk took the device route.
"""

from __future__ import annotations

import asyncio
import hashlib
import json
import random
import subprocess
import sys
import threading
import time

import numpy as np

N_ROWS = 262_144
N_ITERS = 7
N_BATCHES = 6
IN_FLIGHT = 2
CPU_SAMPLE_ROWS = 16_384  # CPU path timed on a sample, scaled (it's O(n))


# ≈ 0.5 ms of card clock before a timed launch: longer than any wrapper's
# host time, so the events time the card's own work (device_ms)
HOLD_CYCLES = 1_000_000


def pgbench_rows(n_rows: int) -> list[tuple[int, int, int]]:
    """(aid, bid, abalance) of the workload's rows, from its seed: bid
    uniform on 1..10, abalance on [-10^9, 10^9)."""
    rng = random.Random(7)
    return [(i + 1, rng.randrange(1, 11), rng.randrange(-10**9, 10**9))
            for i in range(n_rows)]


def build_workload(n_rows: int) -> list[bytes]:
    """pgbench_accounts insert stream: begin + n inserts + commit."""
    from .postgres.codec import pgoutput

    ts = 1_700_000_000_000_000
    payloads = [pgoutput.encode_begin(0x5000, ts, 99)]
    for aid, bid, abalance in pgbench_rows(n_rows):
        payloads.append(pgoutput.encode_insert(
            16384, [str(aid).encode(), str(bid).encode(),
                    str(abalance).encode(), b" " * 84]))
    payloads.append(pgoutput.encode_commit(0x5000, 0x5008, ts))
    return payloads


def make_schema():
    from .models import (ColumnSchema, Oid, ReplicatedTableSchema, TableName,
                         TableSchema)

    return ReplicatedTableSchema.with_all_columns(TableSchema(
        16384, TableName("public", "pgbench_accounts"),
        (ColumnSchema("aid", Oid.INT4, nullable=False, primary_key_ordinal=1),
         ColumnSchema("bid", Oid.INT4),
         ColumnSchema("abalance", Oid.INT4),
         ColumnSchema("filler", Oid.BPCHAR, modifier=88))))


def bench_cpu(payloads, schema) -> float:
    """Reference-architecture CPU path: per-message decode into events;
    records/s on the fastest of 5 passes over a sample."""
    from .models.lsn import Lsn
    from .postgres.codec import decode_insert, decode_logical_message
    from .postgres.codec.pgoutput import InsertMessage

    sample = payloads[1 : 1 + CPU_SAMPLE_ROWS]
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        ordinal = 0
        for p in sample:
            msg = decode_logical_message(p)
            if isinstance(msg, InsertMessage):
                decode_insert(msg, schema, Lsn(1), Lsn(2), ordinal)
                ordinal += 1
        times.append(time.perf_counter() - t0)
    return len(sample) / min(times)


def card_info() -> str:
    """`name, power.limit` of card 0 as nvidia-smi reports them."""
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return res.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


def device_ms(fn, iters: int, flush=None, hold: bool = True) -> float:
    """Mean device ms of `fn()` over `iters` runs after 3 warm-ups; with
    `flush`, it runs before each timed launch, outside the events. With
    `hold`, the stream spins HOLD_CYCLES on the card before the start
    event, so the host has enqueued the start event, `fn` and the end
    event before the card reaches them: the events then time the card's
    own work. Without it (the timer of the first two slices), a launch
    whose host-side wrapper takes longer than the flush runs on the card
    is timed with the host's enqueue gap in it."""
    import torch

    for _ in range(3):
        fn()
    total = 0.0
    for _ in range(iters):
        if flush is not None:
            flush()
        if hold:
            torch.cuda._sleep(HOLD_CYCLES)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        total += a.elapsed_time(b)
    return total / iters


def batch_digest(batch) -> str:
    """sha256 over every column's validity, TOAST mask and values."""
    h = hashlib.sha256()
    for c in batch.columns:
        h.update(np.ascontiguousarray(c.validity).tobytes())
        if c.toast_unchanged is not None:
            h.update(np.ascontiguousarray(c.toast_unchanged).tobytes())
        if c.is_dense:
            h.update(np.ascontiguousarray(c.data).tobytes())
        elif c.is_text:
            h.update(c.data.offsets.tobytes())
            h.update(c.data.values.tobytes())
            h.update(c.data.validity.tobytes())
        else:
            h.update(repr(list(c.data)).encode())
    return h.hexdigest()


def batches_equal(a, b) -> bool:
    """Same rows: validity, dense bits (where valid) and values."""
    if a.num_rows != b.num_rows:
        return False
    for ca, cb in zip(a.columns, b.columns):
        if not np.array_equal(ca.validity, cb.validity):
            return False
        if ca.is_dense and cb.is_dense:
            da = np.where(ca.validity, ca.data, 0)
            db = np.where(cb.validity, cb.data, 0)
            if da.tobytes() != db.tobytes():
                return False
        elif any(ca.value(i) != cb.value(i) for i in range(a.num_rows)
                 if ca.validity[i]):
            return False
    return True


def oracle_sample_ok(batch, payloads, schema, k: int, seed: int) -> bool:
    """`k` random rows of `batch` against the CPU oracle `decode_insert`:
    row i is insert payload s + 1, s = i or, in a filtered batch,
    `batch.source_rows[i]`."""
    from .models.lsn import Lsn
    from .postgres.codec import decode_insert, decode_logical_message

    rows = np.random.default_rng(seed).choice(batch.num_rows, size=k,
                                              replace=False)
    src = batch.source_rows if batch.source_rows is not None \
        else np.arange(batch.num_rows)
    for i in rows:
        ev = decode_insert(decode_logical_message(payloads[int(src[i]) + 1]),
                           schema, Lsn(1), Lsn(2), 0)
        if [c.value(int(i)) for c in batch.columns] != ev.row.values:
            return False
    return True


def filtered_batches_identical(a, b) -> bool:
    """Equality of two compacted decode outputs, INCLUDING the survivor
    row mapping (`source_rows`) — a filter that dropped the right count
    but the wrong rows fails here. Copy of the reference's
    `harness._filtered_batches_identical`."""
    if a.num_rows != b.num_rows:
        return False
    sa, sb = a.source_rows, b.source_rows
    if (sa is None) != (sb is None):
        return False
    if sa is not None and not np.array_equal(sa, sb):
        return False
    for ca, cb in zip(a.columns, b.columns):
        if not np.array_equal(ca.validity, cb.validity):
            return False
        if ca.is_dense and cb.is_dense:
            if not np.array_equal(ca.data[ca.validity],
                                  cb.data[cb.validity]):
                return False
        else:
            for i in range(a.num_rows):
                if ca.validity[i] and ca.value(i) != cb.value(i):
                    return False
    return True


def decode_stream(decoder, stage, n_batches: int, on_batch=None) -> float:
    """Frame, stage and decode `n_batches` batches with IN_FLIGHT of them
    in flight; calls `on_batch(pending)` on each completed handle in
    order. Returns the wall seconds, ending after the last result."""
    t0 = time.perf_counter()
    pending = []
    for _ in range(n_batches):
        pending.append(decoder.decode_async(stage().staged))
        if len(pending) > IN_FLIGHT:
            p = pending.pop(0)
            p.result()
            if on_batch is not None:
                on_batch(p)
    for p in pending:
        p.result()
        if on_batch is not None:
            on_batch(p)
    return time.perf_counter() - t0


def filter_bench_schema():
    """The reference selectivity bench's table (`harness.run_selectivity`):
    id INT8 primary key, v INT4, note TEXT."""
    from .models import (ColumnSchema, Oid, ReplicatedTableSchema, TableName,
                         TableSchema)

    return ReplicatedTableSchema.with_all_columns(TableSchema(
        16384, TableName("public", "filter_bench"),
        (ColumnSchema("id", Oid.INT8, nullable=False, primary_key_ordinal=1),
         ColumnSchema("v", Oid.INT4),
         ColumnSchema("note", Oid.TEXT))))


def run_selectivity(n_rows: int = N_ROWS, device: str = "cuda",
                    n_iters: int = 5, keep_fractions=(0.1, 0.5, 0.9),
                    fetch_slack: float = 0.11) -> dict:
    """Fused-filter decode across publication-filter selectivities: per
    point, rows/s of the filtered decode on `device` (best of `n_iters`
    decodes of a staged batch), identity of the compacted batch and its
    `source_rows` between that decode, the CPU decoder and the oracle
    route, and the fetched-bytes ratio against the unfiltered decode,
    gated at (measured keep + `fetch_slack`). The slack covers the keep
    mask (1 bit a row), the count and the fetch-slice granularity
    (`staging.slice_rows`)."""
    from .ops import decode_kernel
    from .ops.engine import DeviceDecoder
    from .ops.predicate import parse_row_filter
    from .ops.wal import concat_payloads, stage_wal_batch
    from .postgres.codec.pgoutput import encode_insert

    rng = np.random.RandomState(11)
    vals = rng.randint(-1_000_000, 1_000_000, size=n_rows)
    payloads = [encode_insert(16384, [str(i).encode(), str(int(v)).encode(),
                                      b"n-%d" % i])
                for i, v in enumerate(vals)]
    buf, offs, lens = concat_payloads(payloads)

    def stage():
        return stage_wal_batch(buf, offs, lens, 3).staged

    def decode(dec, staged):
        p = dec.decode_async(staged)
        return p.result(), p.timings["fetched_bytes"]

    def best_rate(dec):
        times = []
        for _ in range(n_iters):
            s = stage()
            t0 = time.perf_counter()
            dec.decode(s)
            times.append(time.perf_counter() - t0)
        return n_rows / min(times)

    plain = filter_bench_schema()
    base = DeviceDecoder(plain, device=device, device_min_rows=1)
    _, unfiltered_bytes = decode(base, stage())
    unfiltered_rate = best_rate(base)
    out = {"mode": "selectivity", "rows": n_rows, "device": device,
           "unfiltered_rows_per_sec": unfiltered_rate,
           "unfiltered_fetched_bytes": int(unfiltered_bytes),
           "fetch_slack": fetch_slack, "points": []}
    all_ok = True
    for keep in keep_fractions:
        sql = f"v < {int(-1_000_000 + 2_000_000 * keep)}"
        rts = plain.with_row_predicate(parse_row_filter(sql))
        dec = DeviceDecoder(rts, device=device, device_min_rows=1)
        before = decode_kernel.filter_launches + decode_kernel.fused_launches
        batch, filtered_bytes = decode(dec, stage())
        launched = decode_kernel.filter_launches \
            + decode_kernel.fused_launches - before
        cpu = DeviceDecoder(rts, device="cpu", device_min_rows=1) \
            .decode(stage())
        oracle = DeviceDecoder(rts, device="cpu", device_min_rows=10**9) \
            .decode(stage())
        identical = filtered_batches_identical(batch, cpu) \
            and filtered_batches_identical(batch, oracle)
        measured_keep = batch.num_rows / n_rows
        ratio = filtered_bytes / unfiltered_bytes
        fetch_ok = ratio <= measured_keep + fetch_slack
        rate = best_rate(dec)
        out["points"].append({
            "row_filter": sql, "target_keep": keep,
            "measured_keep": measured_keep, "survivors": batch.num_rows,
            "rows_per_sec": rate,
            "speedup_vs_unfiltered": rate / unfiltered_rate,
            "filtered_fetched_bytes": int(filtered_bytes),
            "fetched_bytes_ratio": ratio,
            "fetch_reduction_ok": bool(fetch_ok),
            "kernel_plain_oracle_identical": bool(identical),
            "filter_kernel_launches": launched,
        })
        all_ok = all_ok and identical and fetch_ok
    out["ok"] = bool(all_ok)
    return out


# ---------------------------------------------------------------------------
# the replication runtime: table copy and CDC streaming through Pipeline
# ---------------------------------------------------------------------------

PGBENCH_TID = 16384
FILLER_WIDTH = 84


def pgbench_table(n_rows: int, seed: int, first_aid: int = 1) -> dict:
    """Seeded pgbench_accounts rows as arrays: aid (first_aid, first_aid
    + 1, ...), bid uniform on 1..10, abalance on [-10^9, 10^9) and an
    84-byte lowercase filler."""
    rng = np.random.default_rng(seed)
    return {"aid": np.arange(first_aid, first_aid + n_rows, dtype=np.int64),
            "bid": rng.integers(1, 11, n_rows),
            "abalance": rng.integers(-10**9, 10**9, n_rows),
            "filler": rng.integers(97, 123, (n_rows, FILLER_WIDTH),
                                   dtype=np.uint8)}


def table_text_rows(t: dict) -> list:
    """The rows as the fake database holds them: one list of field texts
    a row."""
    filler = t["filler"].view(f"S{FILLER_WIDTH}").ravel()
    return [[str(a), str(b), str(c), f.decode()] for a, b, c, f in
            zip(t["aid"].tolist(), t["bid"].tolist(), t["abalance"].tolist(),
                filler.tolist())]


def table_payloads(t: dict) -> list:
    """pgoutput INSERT payloads of the rows (the CDC producer's stream)."""
    from .postgres.codec.pgoutput import encode_insert

    filler = t["filler"].view(f"S{FILLER_WIDTH}").ravel().tolist()
    return [encode_insert(PGBENCH_TID, [str(a).encode(), str(b).encode(),
                                        str(c).encode(), f])
            for a, b, c, f in zip(t["aid"].tolist(), t["bid"].tolist(),
                                  t["abalance"].tolist(), filler)]


def _mix64(x: np.ndarray) -> np.ndarray:
    """splitmix64's finalizer, elementwise on uint64."""
    x = x ^ (x >> np.uint64(30))
    x = x * np.uint64(0xBF58476D1CE4E5B9)
    x = x ^ (x >> np.uint64(27))
    x = x * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


def _rows_digest(aid, bid, abalance, fhash, flen, valid) -> int:
    """Order-independent digest of rows: the uint64 sum of a mixed hash of
    each row's four fields (NULLs hash as a sentinel)."""
    with np.errstate(over="ignore"):
        h = np.zeros(len(aid), dtype=np.uint64)
        for k, col in enumerate((aid, bid, abalance, fhash, flen)):
            v = np.asarray(col).astype(np.int64).view(np.uint64)
            v = np.where(valid[k] if k < 4 else valid[3], v,
                         np.uint64(0x9E3779B97F4A7C15))
            h = _mix64(h ^ (v + np.uint64(k + 1)))
        return int(h.sum(dtype=np.uint64))


def _text_hash(offsets: np.ndarray, values: np.ndarray) -> np.ndarray:
    """Per-row polynomial hash of a text column's bytes (uint64)."""
    lens = np.diff(offsets.astype(np.int64))
    pos = np.arange(len(values), dtype=np.int64) \
        - np.repeat(offsets[:-1].astype(np.int64), lens)
    with np.errstate(over="ignore"):
        w = values.astype(np.uint64) * (pos.astype(np.uint64)
                                        * np.uint64(1_000_003)
                                        + np.uint64(7))
        cum = np.concatenate([[np.uint64(0)], np.cumsum(w, dtype=np.uint64)])
        return cum[offsets[1:].astype(np.int64)] \
            - cum[offsets[:-1].astype(np.int64)]


def table_digest(t: dict, rows: np.ndarray | None = None) -> int:
    """`_rows_digest` of the written rows (a subset with `rows`)."""
    sel = slice(None) if rows is None else rows
    f = t["filler"][sel]
    n = len(f)
    offsets = np.arange(n + 1, dtype=np.int64) * FILLER_WIDTH
    valid = [np.ones(n, dtype=bool)] * 4
    return _rows_digest(t["aid"][sel], t["bid"][sel], t["abalance"][sel],
                        _text_hash(offsets, f.ravel()),
                        np.full(n, FILLER_WIDTH), valid)


def batch_rows_digest(batch) -> int:
    """`_rows_digest` of a decoded pgbench ColumnarBatch."""
    aid, bid, abal, filler = batch.columns
    text = filler.data
    return _rows_digest(aid.data, bid.data, abal.data,
                        _text_hash(text.offsets, text.values),
                        np.diff(text.offsets.astype(np.int64)),
                        [aid.validity, bid.validity, abal.validity,
                         filler.validity])


def _counting_destination():
    """A destination that resolves every decoded batch as it arrives (so
    the decode stays on the measured path), counts its rows, records the
    arrival time of each commit LSN it carries, and keeps the batches for
    the checks made after the measured window."""
    from .destinations.base import Destination, WriteAck
    from .models.event import DecodedBatchEvent

    class CountingDestination(Destination):
        def __init__(self):
            self.rows_delivered = 0
            self.copied: list = []
            self.events: list = []  # (batch, change types, commits, ords)
            self.arrivals: list = []  # (commit LSN, perf_counter)
            self.other_events = 0

        async def startup(self):
            return None

        async def write_table_rows(self, schema, batch):
            self.rows_delivered += batch.num_rows
            self.copied.append(batch)
            return WriteAck.durable()

        async def write_events(self, events):
            for e in events:
                if not isinstance(e, DecodedBatchEvent):
                    self.other_events += 1
                    continue
                b = e.batch  # resolves the decode
                now = time.perf_counter()
                self.rows_delivered += b.num_rows
                self.events.append((b, e.change_types,
                                    np.asarray(e.commit_lsns),
                                    np.asarray(e.tx_ordinals)))
                for lsn in np.unique(e.commit_lsns).tolist():
                    self.arrivals.append((int(lsn), now))
            return WriteAck.durable()

        async def drop_table(self, table_id, schema=None):
            return None

        async def truncate_table(self, table_id):
            return None

    return CountingDestination()


def _pipeline(db, dest, device: str, max_fill_ms: int = 40):
    """The port's Pipeline on the fake walsender, CUDA engine on
    `device`, with the subsystems the port has not ported passed off."""
    from .config import (BatchConfig, BatchEngine, PipelineConfig,
                         PoisonConfig, SupervisionConfig)
    from .postgres.fake import FakeSource
    from .runtime import Pipeline
    from .store import NotifyingStore

    store = NotifyingStore()
    config = PipelineConfig(
        pipeline_id=1, publication_name="pub",
        batch=BatchConfig(max_fill_ms=max_fill_ms,
                          batch_engine=BatchEngine.CUDA, device=device),
        supervision=SupervisionConfig(enabled=False),
        poison=PoisonConfig(enabled=False))
    return Pipeline(config=config, store=store, destination=dest,
                    source_factory=lambda: FakeSource(db)), store


def _counters() -> dict:
    """Snapshot of the runtime's decode counters and stage sums."""
    from .ops import decode_kernel
    from .telemetry import metrics as m

    r = m.registry
    out = {"k1_launches": decode_kernel.launches,
           "k2c_launches": decode_kernel.fused_launches,
           "k2_launches": decode_kernel.filter_launches,
           "epilogue_launches": decode_kernel.compact_launches}
    for key, name in (("device_rows", m.ETL_DECODE_ROUTED_DEVICE_ROWS_TOTAL),
                      ("oracle_rows", m.ETL_DECODE_ROUTED_ORACLE_ROWS_TOTAL),
                      ("device_s", m.ETL_DECODE_DEVICE_SECONDS_TOTAL),
                      ("kernel_s", m.ETL_DECODE_KERNEL_SECONDS_TOTAL),
                      ("overlap_s",
                       m.ETL_DECODE_PIPELINE_OVERLAP_SECONDS_TOTAL)):
        out[key] = r.get_counter(name)
    for key, name in (("pack", m.ETL_DECODE_PACK_SECONDS),
                      ("dispatch", m.ETL_DECODE_DISPATCH_SECONDS),
                      ("fetch", m.ETL_DECODE_FETCH_SECONDS)):
        n, total = r.sum_histogram(name)
        out[f"{key}_n"], out[f"{key}_s"] = n, total
    return out


def _delta(a: dict, b: dict) -> dict:
    return {k: b[k] - a[k] for k in a}


def _run_sizes() -> dict:
    """The assembler's sealed-run row counts so far, by bucket."""
    from .telemetry import metrics as m

    return m.registry.get_histogram_buckets(m.ETL_ASSEMBLER_RUN_ROWS)


def _oracle_sample_ok(batches: list, t: dict, n: int, seed: int,
                      first_aid: int) -> bool:
    """`n` delivered rows, sampled across the batches, against the CPU
    oracle route (every row through the CPU codec) on the same rows'
    INSERT payloads."""
    from .ops.engine import DeviceDecoder
    from .ops.wal import concat_payloads, stage_wal_batch

    rng = np.random.default_rng(seed)
    total = sum(b.num_rows for b in batches)
    if total == 0:
        return False
    picks = np.sort(rng.choice(total, size=min(n, total), replace=False))
    got, starts = [], np.cumsum([0] + [b.num_rows for b in batches])
    for p in picks.tolist():
        k = int(np.searchsorted(starts, p, side="right") - 1)
        b = batches[k]
        got.append([c.value(p - int(starts[k])) for c in b.columns])
    idx = np.asarray([g[0] - first_aid for g in got], dtype=np.int64)
    sub = {k: v[idx] for k, v in t.items()}
    payloads = table_payloads(sub)
    oracle = DeviceDecoder(make_schema(), device="cpu",
                           device_min_rows=10**9)
    want = oracle.decode(stage_wal_batch(*concat_payloads(payloads),
                                         4).staged)
    return all([c.value(i) for c in want.columns] == g
               for i, g in enumerate(got))


async def run_table_copy(n_rows: int = 1_000_000, device: str = "cuda",
                         seed: int = 7) -> dict:
    """Initial-copy throughput: the port of the reference's
    `harness.run_table_copy` on the port's Pipeline, at its default 1M
    rows, on pgbench_accounts (BASELINE.json configs[0]'s table). The
    Pipeline runs until the table is READY; the counting destination keeps
    every batch. Checks: K1 launched, every chunk on the device route,
    the delivered row count and an order-independent digest over all
    columns equal the written rows', and 512 sampled rows equal the CPU
    oracle's decode."""
    from .models.table_state import TableStateType
    from .postgres.codec.copy_text import encode_copy_row
    from .postgres.fake import FakeDatabase

    t = pgbench_table(n_rows, seed)
    rows = table_text_rows(t)
    copy_bytes = sum(len(encode_copy_row(r)) + 1 for r in rows)
    db = FakeDatabase()
    db.create_table(make_schema().table_schema, rows=rows)
    db.create_publication("pub", [PGBENCH_TID])
    dest = _counting_destination()
    pipeline, store = _pipeline(db, dest, device)
    c0 = _counters()
    t0 = time.perf_counter()
    await pipeline.start()
    t_started = time.perf_counter()
    await asyncio.wait_for(
        store.notify_on(PGBENCH_TID, TableStateType.READY), 600)
    t_copied = time.perf_counter()
    await pipeline.shutdown_and_wait()
    t_done = time.perf_counter()
    d = _delta(c0, _counters())
    copy_s = t_copied - t_started
    digest_ok = sum(batch_rows_digest(b) for b in dest.copied) % (1 << 64) \
        == table_digest(t)
    out = {
        "mode": "table_copy", "rows": n_rows, "device": device,
        "rows_delivered": dest.rows_delivered,
        "copy_bytes": copy_bytes,
        "pipeline_start_ms": (t_started - t0) * 1e3,
        "copy_wait_ms": copy_s * 1e3,
        "shutdown_ms": (t_done - t_copied) * 1e3,
        "rows_per_second": n_rows / copy_s,
        "mib_per_second": copy_bytes / (1 << 20) / copy_s,
        "batches": len(dest.copied),
        "batch_rows": sorted(b.num_rows for b in dest.copied),
        "k1_launches": int(d["k1_launches"]),
        "device_rows": int(d["device_rows"]),
        "oracle_rows": int(d["oracle_rows"]),
        "pack_s": d["pack_s"], "dispatch_s": d["dispatch_s"],
        "fetch_s": d["fetch_s"], "overlap_s": d["overlap_s"],
        "device_s": d["device_s"], "kernel_s": d["kernel_s"],
        "device_busy_share": d["device_s"] / copy_s,
        "count_ok": dest.rows_delivered == n_rows,
        "digest_ok": bool(digest_ok),
        "oracle_sample_ok": _oracle_sample_ok(dest.copied, t, 512, seed, 1),
    }
    out["device_route_ok"] = (out["device_rows"] == n_rows
                              and out["oracle_rows"] == 0
                              and out["k1_launches"] > 0) \
        if device == "cuda" else out["oracle_rows"] == 0
    out["ok"] = bool(out["count_ok"] and out["digest_ok"]
                     and out["oracle_sample_ok"] and out["device_route_ok"])
    return out


async def run_table_streaming(n_events: int = 500_000, tx_size: int = 500,
                              max_fill_ms: int = 30,
                              arrival_rate: int | None = None,
                              device: str = "cuda",
                              row_filter: str | None = None,
                              seed: int = 8, warmup_events: int = 17_000
                              ) -> dict:
    """CDC throughput and end-to-end replication lag: the port of the
    reference's `harness.run_table_streaming` (its defaults: 500,000
    insert events, 500-row transactions, a 30 ms fill window) on the
    port's Pipeline, into the counting destination, on pgbench_accounts
    (BASELINE.json configs[0]'s table), which starts empty. Lag is the
    destination's arrival of a commit LSN minus the source commit's time.
    `arrival_rate` paces production to N events/s in 10 ms ticks; None
    produces as fast as possible. With `row_filter` the publication
    carries that filter and the walsender ships every row (offload mode,
    `server_row_filtering = False`): the client's fused filter keeps the
    matching rows. Payloads are encoded before the window; warm-up
    transactions (`warmup_events`, rows of other aids) run first.

    Checks over the measured window: the delivered rows are exactly the
    produced rows (those matching the filter, with one), by count and by
    an order-independent digest over all columns; every row arrives once
    with its (commit LSN, ordinal) in order, and the identity arrays of
    each event are compacted with its rows (each row's ordinal names the
    produced row it is); 512 sampled rows equal the CPU oracle's
    decode."""
    from .models.table_state import TableStateType
    from .ops.pipeline import global_admission
    from .postgres.fake import FakeDatabase

    t = pgbench_table(n_events, seed, first_aid=1)
    payloads = table_payloads(t)
    keep = np.ones(n_events, dtype=bool) if row_filter is None \
        else _filter_truth(row_filter, t)
    warm = pgbench_table(warmup_events, seed + 1, first_aid=n_events + 1)
    warm_payloads = table_payloads(warm)
    db = FakeDatabase()
    db.create_table(make_schema().table_schema)
    row_filters = None
    if row_filter is not None:
        row_filters = {PGBENCH_TID: (row_filter, lambda r: True)}
        db.server_row_filtering = False
    db.create_publication("pub", [PGBENCH_TID], row_filters=row_filters)
    dest = _counting_destination()
    pipeline, store = _pipeline(db, dest, device, max_fill_ms)
    await pipeline.start()
    await asyncio.wait_for(
        store.notify_on(PGBENCH_TID, TableStateType.READY), 60)

    async def wait_rows(n: int) -> None:
        while dest.rows_delivered < n:
            if pipeline._apply_task is not None \
                    and pipeline._apply_task.done():
                pipeline._apply_task.result()
                raise RuntimeError("pipeline stopped before delivering")
            await asyncio.sleep(0.01)

    # warm-up off the clock: pinned buffers and the runs' first shapes
    w = 0
    warm_keep = np.ones(warmup_events, dtype=bool) if row_filter is None \
        else _filter_truth(row_filter, warm)
    for wave in (200, 800, 3000, warmup_events - 4000):
        tx = db.transaction()
        for p in warm_payloads[w:w + wave]:
            tx.insert_preencoded(PGBENCH_TID, p)
        w += wave
        await tx.commit()
        await asyncio.wait_for(wait_rows(int(warm_keep[:w].sum())), 120)
    dest.events.clear()
    dest.arrivals.clear()
    base = dest.rows_delivered
    want_rows = int(keep.sum())
    commit_times: dict = {}
    commits: list = []
    sizes0 = _run_sizes()
    c0 = _counters()
    t_prod0 = time.perf_counter()
    produced = 0
    tick = 0.01
    per_tick = max(1, int(arrival_rate * tick)) if arrival_rate else tx_size
    next_t = t_prod0
    while produced < n_events:
        tx = db.transaction()
        for p in payloads[produced:produced + per_tick]:
            tx.insert_preencoded(PGBENCH_TID, p)
        lsn = int(await tx.commit())
        commit_times[lsn] = time.perf_counter()
        commits.append((lsn, produced, min(produced + per_tick, n_events)))
        produced = commits[-1][2]
        if arrival_rate:
            next_t += tick
            delay = next_t - time.perf_counter()
            if delay > 0:
                await asyncio.sleep(delay)
    t_prod1 = time.perf_counter()
    await asyncio.wait_for(wait_rows(base + want_rows), 600)
    t_e2e = time.perf_counter()
    d = _delta(c0, _counters())
    sizes1 = _run_sizes()
    await pipeline.shutdown_and_wait()
    window = t_e2e - t_prod0
    lags = sorted((at - commit_times[lsn]) * 1e3
                  for lsn, at in dest.arrivals if lsn in commit_times)

    def pct(q):
        return lags[min(len(lags) - 1, int(q * len(lags)))] if lags else None

    # identity: each delivered row's (commit LSN, ordinal) names one
    # produced row; the row's aid must be that row's
    first_of = {lsn: lo for lsn, lo, _ in commits}
    commits_all = np.concatenate([e[2] for e in dest.events]) \
        if dest.events else np.zeros(0, np.uint64)
    ords_all = np.concatenate([e[3] for e in dest.events]) \
        if dest.events else np.zeros(0, np.uint64)
    aids = np.concatenate([e[0].columns[0].data for e in dest.events]) \
        if dest.events else np.zeros(0, np.int32)
    compacted = all(len(e[1]) == len(e[2]) == len(e[3]) == e[0].num_rows
                    for e in dest.events)
    src = np.asarray([first_of.get(int(c), -1) for c in commits_all],
                     dtype=np.int64) + ords_all.astype(np.int64)
    known = (src >= 0) & (src < n_events)
    identity_ok = bool(compacted and known.all()
                       and np.array_equal(aids.astype(np.int64),
                                          t["aid"][src[known]])
                       and keep[src].all())
    key = commits_all.astype(np.uint64) * np.uint64(1 << 20) \
        + ords_all.astype(np.uint64)
    order_ok = bool(len(key) == want_rows and np.all(np.diff(key) > 0)
                    and set(np.unique(commits_all).tolist())
                    == {lsn for lsn, lo, hi in commits if keep[lo:hi].any()})
    delivered = dest.rows_delivered - base
    digest = sum(batch_rows_digest(e[0]) for e in dest.events) % (1 << 64)
    batches = [e[0] for e in dest.events]
    sched = global_admission()
    threads = _pipeline_threads(timeout_s=5.0)
    out = {
        "mode": "table_streaming", "events": n_events, "tx_size": tx_size,
        "max_fill_ms": max_fill_ms, "arrival_rate": arrival_rate,
        "device": device, "row_filter": row_filter,
        "producer_events_per_second": n_events / (t_prod1 - t_prod0),
        "end_to_end_events_per_second": n_events / window,
        "delivered_rows": delivered, "want_rows": want_rows,
        "keep_share": delivered / n_events,
        "lag_p50_ms": pct(0.5), "lag_p95_ms": pct(0.95),
        "lag_max_ms": lags[-1] if lags else None,
        "decoded_events": len(dest.events),
        "run_rows": {k: sizes1.get(k, 0) - sizes0.get(k, 0)
                     for k in sizes1},
        "k1_launches": int(d["k1_launches"]),
        "k2c_launches": int(d["k2c_launches"]),
        "k2_launches": int(d["k2_launches"]),
        "epilogue_launches": int(d["epilogue_launches"]),
        "device_rows": int(d["device_rows"]),
        "oracle_rows": int(d["oracle_rows"]),
        "pack_s": d["pack_s"], "dispatch_s": d["dispatch_s"],
        "fetch_s": d["fetch_s"], "overlap_s": d["overlap_s"],
        "overlap_ratio": d["overlap_s"] / d["pack_s"] if d["pack_s"] else 0,
        "device_s": d["device_s"], "kernel_s": d["kernel_s"],
        "device_busy_share": d["device_s"] / window,
        "count_ok": delivered == want_rows,
        "digest_ok": digest == table_digest(t, np.flatnonzero(keep)),
        "order_ok": order_ok, "identity_ok": identity_ok,
        "oracle_sample_ok": _oracle_sample_ok(batches, t, 512, seed, 1),
        "after_shutdown": {"pipeline_threads": threads,
                           "admission_in_flight": sched.in_flight,
                           "admission_tenants": sorted(
                               sched.stats()["tenants"])},
    }
    out["shutdown_ok"] = (not threads and sched.in_flight == 0
                          and not out["after_shutdown"]["admission_tenants"])
    out["ok"] = bool(out["count_ok"] and out["digest_ok"] and out["order_ok"]
                     and out["identity_ok"] and out["oracle_sample_ok"])
    return out


def _pipeline_threads(timeout_s: float) -> list:
    """Names of decode-pipeline worker threads still alive, after giving
    closed pipelines up to `timeout_s` to let their workers exit."""
    deadline = time.monotonic() + timeout_s
    while True:
        names = [th.name for th in threading.enumerate()
                 if th.name.startswith("etl-")
                 and th.name.endswith("-pipeline")]
        if not names or time.monotonic() >= deadline:
            return names
        time.sleep(0.01)


def _filter_truth(sql: str, t: dict) -> np.ndarray:
    """The rows of `t` a publication filter keeps: the filter's host
    evaluation over a batch built from the written values (no decode)."""
    from .models.table_row import Column, ColumnarBatch, TextArray
    from .ops.predicate import compile_row_filter, parse_row_filter

    schema = make_schema()
    n = len(t["aid"])
    ok = np.ones(n, dtype=bool)
    cols = [Column(c, t[c.name].astype(np.int32), ok)
            for c in schema.replicated_columns[:3]]
    text = TextArray(np.arange(n + 1, dtype=np.int32) * FILLER_WIDTH,
                     t["filler"].ravel(), ok)
    cols.append(Column(schema.replicated_columns[3], text, ok))
    return np.asarray(compile_row_filter(parse_row_filter(sql), schema)
                      .host_keep(ColumnarBatch(schema, cols)), dtype=bool)


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(prog="python -m etl_tpu_torch.bench")
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--selectivity", action="store_true",
                      help="the fused row filter across selectivities")
    mode.add_argument("--copy", action="store_true",
                      help="initial table copy through the Pipeline")
    mode.add_argument("--streaming", action="store_true",
                      help="CDC streaming through the Pipeline")
    ap.add_argument("--rows", type=int, default=1_000_000,
                    help="--copy: rows of the table")
    ap.add_argument("--events", type=int, default=500_000,
                    help="--streaming: insert events")
    ap.add_argument("--arrival-rate", type=int, default=None,
                    help="--streaming: paced events/s (default: as fast "
                         "as possible)")
    ap.add_argument("--row-filter", default=None,
                    help="--streaming: a publication row filter applied "
                         "by the client (offload mode), e.g. 'bid <= 5'")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("etl_tpu_torch.bench: no CUDA device; nothing measured",
              file=sys.stderr)
        return 1
    if args.copy or args.streaming:
        res = asyncio.run(
            run_table_copy(args.rows) if args.copy else
            run_table_streaming(args.events, arrival_rate=args.arrival_rate,
                                row_filter=args.row_filter))
        res["device_name"] = torch.cuda.get_device_name(0)
        res["power_limit"] = card_info().split(",")[-1].strip()
        print(json.dumps(res))
        return 0 if res["ok"] else 1
    if args.selectivity:
        res = run_selectivity()
        res["device_name"] = torch.cuda.get_device_name(0)
        res["power_limit"] = card_info().split(",")[-1].strip()
        print(json.dumps(res))
        return 0 if res["ok"] else 1
    from .ops.engine import DeviceDecoder
    from .ops.wal import concat_payloads, stage_wal_batch

    payloads = build_workload(N_ROWS)
    schema = make_schema()
    cpu_rps = bench_cpu(payloads, schema)
    buf, offs, lens = concat_payloads(payloads)

    def stage():
        return stage_wal_batch(buf, offs, lens, 4)

    decoder = DeviceDecoder(schema, device="cuda")
    first = decoder.decode(stage().staged)  # warm-up: descriptors, pinning
    cpu_first = DeviceDecoder(schema, device="cpu").decode(stage().staged)
    digest = batch_digest(first)
    digests_ok = True
    rates = []
    for _ in range(N_ITERS):
        done: list = []
        dt = decode_stream(decoder, stage, N_BATCHES, done.append)
        rates.append(N_BATCHES * N_ROWS / dt)
        # checked outside the timed window
        digests_ok = digests_ok and all(
            batch_digest(p.result()) == digest for p in done)
    rates.sort()
    med = rates[len(rates) // 2]
    parity = {
        "first_batch_equals_cpu_decode": batches_equal(first, cpu_first),
        "every_batch_same_digest": digests_ok,
        "oracle_sample_rows": 256,
        "oracle_sample_equal": oracle_sample_ok(first, payloads, schema, 256,
                                                seed=7),
    }
    result = {
        "metric": "wal_records_per_sec_decoded",
        "value": round(med),
        "unit": "records/s",
        "vs_baseline": round(med / cpu_rps, 2),
        "vs_baseline_peak": round(rates[-1] / cpu_rps, 2),
        "cpu_baseline_records_per_sec": round(cpu_rps),
        "peak_records_per_sec": round(rates[-1]),
        "engine": "cuda_kernel",
        "backend": "cuda",
        "device_name": torch.cuda.get_device_name(0),
        "power_limit": card_info().split(",")[-1].strip(),
        "workload": f"pgbench insert CDC, {N_ROWS} rows/batch, "
                    f"{N_BATCHES} batches/window, {IN_FLIGHT} in flight",
        "measurement_windows": N_ITERS,
        "parity": parity,
    }
    print(json.dumps(result))
    return 0 if all(v for k, v in parity.items()
                    if k != "oracle_sample_rows") else 1


if __name__ == "__main__":
    sys.exit(main())
