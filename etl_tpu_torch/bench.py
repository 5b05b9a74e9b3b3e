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

    python -m etl_tpu_torch.bench --egress [--rows N]

runs the reference's `--egress --device` mode (`harness.run_egress`) at
262,144 rows: rows/s and bytes/s of the BigQuery proto, ClickHouse TSV
and Snowpipe NDJSON encoders, the Parquet writer where pyarrow imports,
and of the TSV and NDJSON fast paths on batches whose decode launched
the egress render kernel. It exits 0 only when both fast paths used the
device text and equal the columnar oracle byte for byte.

    python -m etl_tpu_torch.bench --wire [--rows N] [--events N]
        [--row-filter SQL] [--destination memory|clickhouse|bigquery|
        snowflake] [--profile PATH]

runs the replicator binary over the Postgres wire protocol
(`run_wire_replicator`): COPY, CDC and a restart against the fake server
in a child process, into the named destination (a warehouse one against
its HTTP fake in another child process); with `--profile`, cProfile of
the event loop into PATH and the destination's share of it.

    python -m etl_tpu_torch.bench [--device cpu] --smoke | --ack-latency
        MS | --poison | --exactly-once | --workload PROFILE|all |
        --multi-pipeline | --sharded K | --coldstart | --mode lag|wide_row
        | --mesh-check [--mesh-rows N] [--mesh-shards 8]

are the reference's harness modes (`etl_tpu_torch/benchmarks/`), each
held to its floor in BENCH_FLOOR.json (`benchmarks/smoke.py`), one JSON
line each, exit 0 only when the gate holds; `--smoke` runs every gate
the port has and lists the rest under `not_ported`. They decode on the
card unless `--device cpu` is given (the kernels' plain versions).

    python -m etl_tpu_torch.bench --autoscale | --fleet

are the reference's two gates of pure arithmetic (the scaling policy's
reaction ticks; the fleet reconciler's converge ticks, zero double
actuations and the actuation trace's digest): they run without a card.
"""

from __future__ import annotations

import asyncio
import hashlib
import json
import os
import random
import subprocess
import sys
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


def make_schema(table_id: int = 16384, name: str = "pgbench_accounts"):
    """pgbench_accounts' schema; `table_id` and `name` give a table of
    the same shape another identity (a publication of several)."""
    from .models import (ColumnSchema, Oid, ReplicatedTableSchema, TableName,
                         TableSchema)

    return ReplicatedTableSchema.with_all_columns(TableSchema(
        table_id, TableName("public", name),
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


#: the filter of the mesh check's filtered half (the reference's)
MESH_CHECK_FILTER = "abalance < 0"


def run_mesh_check(n_rows: int = 65_536, n_shards: int = 8,
                   device: str = "cuda", iters: int = 3) -> dict:
    """The reference's `bench.py --mesh-check` on the port: pgbench
    batches of `n_rows` rows decoded by a single-device decoder and by
    the same decoder on an `n_shards` mesh over the devices at hand
    (`parallel.mesh.shard_mesh`: the shards repeat the one card, or the
    CPU), unfiltered and under `abalance < 0`. The sharded batches must
    equal the single-device ones, `source_rows` included; on a card each
    sharded batch must launch K1 (K2c, or K2 + the epilogue, filtered)
    once a shard. The seconds (best of `iters` decodes, staging off the
    clock) are recorded, not gated: one card's shards run one after the
    other on its stream, so they measure the mesh's overhead, not a
    division of work."""
    from .ops import decode_kernel as dk
    from .ops.engine import DeviceDecoder
    from .ops.predicate import parse_row_filter
    from .ops.wal import concat_payloads, stage_wal_batch
    from .parallel.mesh import shard_mesh

    schema = make_schema()
    buf, offs, lens = concat_payloads(build_workload(n_rows))

    def stage():
        return stage_wal_batch(buf, offs, lens, 4).staged

    mesh = shard_mesh(n_shards, device)
    out = {"mode": "mesh_check", "device": device,
           "devices": len(set(mesh.flat)), "mesh_shards": mesh.size,
           "mesh_devices": [str(d) for d in mesh.flat], "rows": n_rows,
           "row_filter": MESH_CHECK_FILTER}
    fschema = schema.with_row_predicate(parse_row_filter(MESH_CHECK_FILTER))
    single, fsingle = (DeviceDecoder(s, device=device, device_min_rows=0,
                                     mesh=None) for s in (schema, fschema))
    sharded, fsharded = (DeviceDecoder(s, device=device, device_min_rows=0,
                                       mesh=mesh, mesh_min_rows=0)
                         for s in (schema, fschema))

    def launches():
        return {"k1": dk.launches,
                "filtered": dk.fused_launches + dk.filter_launches}

    b1 = single.decode(stage())
    before = launches()
    b8 = sharded.decode(stage())
    k1 = launches()["k1"] - before["k1"]
    fb1 = fsingle.decode(stage())
    before = launches()
    fb8 = fsharded.decode(stage())
    kf = launches()["filtered"] - before["filtered"]
    identical = batches_equal(b1, b8) and b8.num_rows == n_rows
    filtered_identical = (
        filtered_batches_identical(fb1, fb8)
        and fb1.source_rows is not None and fb8.source_rows is not None
        and 0 < fb1.num_rows < n_rows)
    cuda = mesh.flat[0].type == "cuda"

    def best(dec) -> float:
        ts = []
        for _ in range(iters):
            staged = stage()
            t0 = time.perf_counter()
            dec.decode(staged)
            ts.append(time.perf_counter() - t0)
        return min(ts)

    out.update({
        "sharded_equals_single": bool(identical),
        "filtered_sharded_equals_single": bool(filtered_identical),
        "filtered_survivors": int(fb1.num_rows),
        "k1_launches_per_batch": k1,
        "filtered_launches_per_batch": kf,
        # plain versions on the CPU launch nothing
        "launches_ok": (k1, kf) == ((mesh.size, mesh.size) if cuda
                                    else (0, 0)),
        "single_decode_s": best(single),
        "sharded_decode_s": best(sharded),
        "filtered_single_decode_s": best(fsingle),
        "filtered_sharded_decode_s": best(fsharded),
    })
    out["ok"] = bool(identical and filtered_identical
                     and out["launches_ok"])
    return out


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


def table_payloads(t: dict, table_id: int = PGBENCH_TID) -> list:
    """pgoutput INSERT payloads of the rows (the CDC producer's stream)
    into `table_id`."""
    from .postgres.codec.pgoutput import encode_insert

    filler = t["filler"].view(f"S{FILLER_WIDTH}").ravel().tolist()
    return [encode_insert(table_id, [str(a).encode(), str(b).encode(),
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


def _text_buffers(col) -> tuple:
    """(offsets, values) of a text column: a TextArray's own buffers, or
    built from the strings of a batch transposed from rows."""
    data = col.data
    if hasattr(data, "offsets"):
        return data.offsets, data.values
    enc = [(v or "").encode() for v in data]
    offsets = np.zeros(len(enc) + 1, dtype=np.int64)
    offsets[1:] = np.cumsum([len(b) for b in enc])
    return offsets, np.frombuffer(b"".join(enc), dtype=np.uint8)


def batch_rows_digest(batch) -> int:
    """`_rows_digest` of a decoded pgbench ColumnarBatch."""
    return _rows_digest(*_rows_arrays([batch]))


def _rows_arrays(batches: list) -> tuple:
    """The `_rows_digest` inputs of pgbench batches, concatenated: aid,
    bid, abalance, the filler's hash and length, and the four validity
    masks."""
    cols: list = [[] for _ in range(9)]
    for b in batches:
        aid, bid, abal, filler = b.columns
        offsets, values = _text_buffers(filler)
        for k, v in enumerate((aid.data, bid.data, abal.data,
                               _text_hash(offsets, values),
                               np.diff(offsets.astype(np.int64)),
                               aid.validity, bid.validity, abal.validity,
                               filler.validity)):
            cols[k].append(np.asarray(v))
    arrs = [np.concatenate(c) if c else np.zeros(0) for c in cols]
    return (*arrs[:5], arrs[5:])


def poison_rows(t: dict, rate: float, seed: int) -> np.ndarray:
    """Mark a seeded `rate` of the table's rows as poison: their filler
    starts with `POISON` (every other filler is lowercase), the value
    `PoisonRejectingDestination` refuses. Returns the boolean mask."""
    n = len(t["aid"])
    mask = np.zeros(n, dtype=bool)
    k = int(round(rate * n))
    if k:
        mask[np.random.default_rng(seed).choice(n, size=k,
                                                replace=False)] = True
        t["filler"][mask, :6] = np.frombuffer(b"POISON", dtype=np.uint8)
    return mask


def _counting_destination():
    """A destination that resolves every decoded batch as it arrives (so
    the decode stays on the measured path), counts its rows, records the
    arrival time of each commit LSN it carries, and keeps the batches for
    the checks made after the measured window. Per-row INSERT events (the
    poison isolator's probe writes expand the batches of a failed flush)
    are kept the same way: each consecutive run of them in a write becomes
    one ColumnarBatch. Dropping the table drops the copied rows (a
    restarted table sync recopies)."""
    return _counting_class()()


def _counting_class():
    from .destinations.base import Destination, WriteAck
    from .models.event import ChangeType, DecodedBatchEvent, InsertEvent
    from .models.table_row import ColumnarBatch

    class CountingDestination(Destination):
        def __init__(self):
            self.rows_delivered = 0
            self.copied: list = []
            self.events: list = []  # (batch, change types, commits, ords)
            self.arrivals: list = []  # (commit LSN, perf_counter)
            self.decoded_rows: list = []  # rows of each decoded event
            self.other_events = 0

        async def startup(self):
            return None

        async def write_table_rows(self, schema, batch):
            self.rows_delivered += batch.num_rows
            self.copied.append(batch)
            return WriteAck.durable()

        async def write_events(self, events):
            rows: list = []
            for e in events:
                if isinstance(e, InsertEvent):
                    rows.append(e)
                    continue
                self._keep_rows(rows)
                if not isinstance(e, DecodedBatchEvent):
                    self.other_events += 1
                    continue
                b = e.batch  # resolves the decode
                self.decoded_rows.append(b.num_rows)
                self._keep(b, e.change_types, np.asarray(e.commit_lsns),
                           np.asarray(e.tx_ordinals))
            self._keep_rows(rows)
            return WriteAck.durable()

        def _keep(self, b, change_types, commits, ordinals) -> None:
            now = time.perf_counter()
            self.rows_delivered += b.num_rows
            self.events.append((b, change_types, commits, ordinals))
            for lsn in np.unique(commits).tolist():
                self.arrivals.append((int(lsn), now))

        def _keep_rows(self, rows: list) -> None:
            if not rows:
                return
            b = ColumnarBatch.from_rows(rows[0].schema,
                                        [e.row for e in rows])
            self._keep(b, np.full(len(rows), int(ChangeType.INSERT),
                                  dtype=np.uint8),
                       np.asarray([int(e.commit_lsn) for e in rows],
                                  dtype=np.uint64),
                       np.asarray([e.tx_ordinal for e in rows],
                                  dtype=np.uint64))
            rows.clear()

        async def drop_table(self, table_id, schema=None):
            self.rows_delivered -= sum(b.num_rows for b in self.copied)
            self.copied.clear()

        async def truncate_table(self, table_id):
            return None

    return CountingDestination


def _tsv_destination():
    """The counting destination as a ClickHouse-shaped sink that declares
    the `tsv` encoder: each coalesced batch of a CDC write is rendered to
    its TSV body on the clock, as `ClickHouseDestination.
    write_event_batches` does (`render_batch_tsv_fast` over the batch and
    its device-rendered text), minus the HTTP insert, with no fallback
    around it; rows and arrivals count after the render. The bodies, and
    each decoded event's row count and whether it carried device text,
    are kept for the checks made after the measured window."""
    from .destinations.base import WriteAck, sequential_batch_program
    from .destinations.clickhouse import render_batch_tsv_fast
    from .destinations.util import (change_type_batch, count_egress_write,
                                    sequence_number_buffer)
    from .models.event import DecodedBatchEvent

    class TsvDestination(_counting_class()):
        egress_encoder = "tsv"

        def __init__(self):
            super().__init__()
            self.writes: list = []  # (CoalescedBatch, body, used_device)
            self.decoded: list = []  # (rows, carried device text)
            self.render_s = 0.0

        async def write_event_batches(self, events):
            for e in events:
                if isinstance(e, DecodedBatchEvent):
                    self.decoded_rows.append(e.batch.num_rows)
                    self.decoded.append((e.batch.num_rows,
                                         e.batch.device_egress is not None))
            for op in sequential_batch_program(events):
                if op[0] == "rows":
                    raise RuntimeError("a CDC write fell to the row path")
                if op[0] != "batch":
                    self.other_events += 1
                    continue
                _, schema, cb = op
                t0 = time.perf_counter()
                # the row path renders with_ordinal(0): a constant key
                seq_buf = sequence_number_buffer(
                    cb.commit_lsns, cb.tx_ordinals,
                    np.zeros(cb.num_rows, dtype=np.uint64))
                body, used = render_batch_tsv_fast(
                    schema, cb.batch, change_type_batch(cb.change_types),
                    seq_buf, egress=cb.egress)
                count_egress_write(used)
                now = time.perf_counter()
                self.render_s += now - t0
                self.writes.append((cb, body, used))
                self.rows_delivered += cb.num_rows
                self.events.append((cb.batch, cb.change_types,
                                    np.asarray(cb.commit_lsns),
                                    np.asarray(cb.tx_ordinals)))
                for lsn in np.unique(cb.commit_lsns).tolist():
                    self.arrivals.append((int(lsn), now))
            return WriteAck.durable()

    return TsvDestination()


def tsv_checks(dest, device_min_rows: int) -> dict:
    """The checks of a TSV destination's writes: every body equals
    `render_batch_tsv_columnar` on the same batch and metadata; every
    decoded batch of at least `device_min_rows` rows (the device route,
    or on a card below its measured threshold the host route, whose
    plain render carries the same text) carried rendered text and every
    oracle-routed one none; and a write used the text exactly when all
    its batches carried it."""
    from .destinations.clickhouse import render_batch_tsv_columnar
    from .destinations.util import change_type_batch, sequence_number_batch

    identical = True
    for cb, body, _ in dest.writes:
        labels = [t.decode() for t in
                  change_type_batch(cb.change_types).tolist()]
        seqs = [q.decode() for q in sequence_number_batch(
            cb.commit_lsns, cb.tx_ordinals,
            np.zeros(cb.num_rows, dtype=np.uint64))]
        identical &= body == render_batch_tsv_columnar(cb.schema, cb.batch,
                                                       labels, seqs)
    return {
        "bodies_identical": bool(identical),
        "device_runs_carried_text": all(
            carried == (rows >= device_min_rows)
            for rows, carried in dest.decoded),
        "used_device_when_carried": all(
            used == (cb.egress is not None) for cb, _, used in dest.writes),
        "writes": len(dest.writes),
        "device_writes": sum(used for _, _, used in dest.writes),
        "decoded_batches": len(dest.decoded),
        "device_batches": sum(c for _, c in dest.decoded),
        "render_s": dest.render_s,
    }


def _pipeline(db, dest, device: str, max_fill_ms: int = 40, *,
              subsystems: str = "off", store=None, **overrides):
    """The port's Pipeline on the fake walsender, CUDA engine on
    `device`. `subsystems="off"` passes supervision and poison-pill
    isolation off (the runtime by itself); `"default"` keeps
    PipelineConfig's defaults for every field but the pipeline id, the
    publication and the batch (both on). `overrides` replace config
    fields (`poison=`, `supervision=`); `store` defaults to a
    NotifyingStore."""
    from .config import (BatchConfig, BatchEngine, PipelineConfig,
                         PoisonConfig, SupervisionConfig)
    from .postgres.fake import FakeSource
    from .runtime import Pipeline
    from .store import NotifyingStore

    if store is None:
        store = NotifyingStore()
    fields = {} if subsystems == "default" else dict(
        supervision=SupervisionConfig(enabled=False),
        poison=PoisonConfig(enabled=False))
    fields.update(overrides)
    config = PipelineConfig(
        pipeline_id=1, publication_name="pub",
        batch=fields.pop("batch", None) or BatchConfig(
            max_fill_ms=max_fill_ms, batch_engine=BatchEngine.CUDA,
            device=device),
        **fields)
    return Pipeline(config=config, store=store, destination=dest,
                    source_factory=lambda: FakeSource(db)), store


async def _wait_ready(store, tid: int, timeout: float) -> None:
    """Until the table is READY: the NotifyingStore's notification, or a
    poll of a durable store's state."""
    from .models.table_state import TableStateType

    if hasattr(store, "notify_on"):
        await asyncio.wait_for(store.notify_on(tid, TableStateType.READY),
                               timeout)
        return

    async def poll():
        while True:
            st = await store.get_table_state(tid)
            if st is not None and st.type is TableStateType.READY:
                return
            await asyncio.sleep(0.01)

    await asyncio.wait_for(poll(), timeout)


def _counters() -> dict:
    """Snapshot of the runtime's decode counters and stage sums."""
    from .ops import decode_kernel, egress_kernel, engine
    from .telemetry import metrics as m

    r = m.registry
    out = {"device_batches": engine.routed_device_batches,
           "small_oracle_rows": engine.routed_small_rows,
           "k1_launches": decode_kernel.launches,
           "k2c_launches": decode_kernel.fused_launches,
           "k2_launches": decode_kernel.filter_launches,
           "epilogue_launches": decode_kernel.compact_launches,
           "egress_launches": egress_kernel.launches}
    for key, name in (("device_rows", m.ETL_DECODE_ROUTED_DEVICE_ROWS_TOTAL),
                      ("oracle_rows", m.ETL_DECODE_ROUTED_ORACLE_ROWS_TOTAL),
                      ("device_s", m.ETL_DECODE_DEVICE_SECONDS_TOTAL),
                      ("kernel_s", m.ETL_DECODE_KERNEL_SECONDS_TOTAL),
                      ("egress_s", m.ETL_EGRESS_RENDER_SECONDS_TOTAL),
                      ("d2h_egress_s", m.ETL_EGRESS_FETCH_SECONDS_TOTAL),
                      ("overlap_s",
                       m.ETL_DECODE_PIPELINE_OVERLAP_SECONDS_TOTAL),
                      ("mesh_batches", m.ETL_DECODE_MESH_BATCHES_TOTAL),
                      ("mesh_padded_rows",
                       m.ETL_DECODE_MESH_PADDED_ROWS_TOTAL)):
        out[key] = r.get_counter(name)
    for path in ("device", "host"):  # columnar wire writes, by text source
        out[f"{path}_writes"] = r.get_counter(m.ETL_EGRESS_WRITES_TOTAL,
                                              {"path": path})
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
        "oracle_sample_ok": await asyncio.to_thread(
            _oracle_sample_ok, dest.copied, t, 512, seed, 1),
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
                              seed: int = 8, warmup_events: int = 17_000,
                              tsv: bool = False, subsystems: str = "off",
                              poison_rate: float = 0.0,
                              store_dir: str | None = None) -> dict:
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
    matching rows. With `tsv` the destination is `_tsv_destination`,
    which declares the `tsv` encoder and renders every write's TSV body on
    the clock: each device run then also launches the egress render
    kernel. Payloads are encoded before the window; warm-up transactions
    (`warmup_events`, rows of other aids) run first.

    Checks over the measured window: the delivered rows are exactly the
    produced rows (those matching the filter, with one), by count and by
    an order-independent digest over all columns; every row arrives once
    with its (commit LSN, ordinal) in order, and the identity arrays of
    each event are compacted with its rows (each row's ordinal names the
    produced row it is); 512 sampled rows equal the CPU oracle's
    decode. With `tsv`: every body equals the columnar oracle's, device
    runs carry device text and their writes use it, and the render kernel
    launched once per device run (as often as K1).

    `subsystems="default"` runs PipelineConfig's defaults (supervision and
    poison-pill isolation on; see `_pipeline`) and adds checks: the
    supervisor started, the destination is wrapped in a
    SupervisedDestination, no degrade event, health `healthy` at the end,
    and K1 launched once per device run. `poison_rate` > 0 (with the
    defaults) marks that share of the rows poison (`poison_rows`), wraps
    the destination in a PoisonRejectingDestination and keeps the state in
    a SqliteStore under `store_dir`, with `PoisonConfig(budget_rows=
    1_000_000)`, the reference harness's poison settings: the poison rows
    are the ones not delivered, and the checks add that each is on the
    dead-letter store exactly once under its WAL key, that every
    isolation's probe writes are within `bisection_bound`, and that
    `python -m etl_tpu_torch.dlq --sqlite ... list` in another process
    lists the same entries."""
    from .ops.engine import DeviceDecoder
    from .ops.pipeline import global_admission
    from .postgres.fake import FakeDatabase
    from .runtime import poison as poison_mod

    t = pgbench_table(n_events, seed, first_aid=1)
    poisoned = poison_rows(t, poison_rate, seed + 2)
    payloads = table_payloads(t)
    keep = np.ones(n_events, dtype=bool) if row_filter is None \
        else _filter_truth(row_filter, t)
    keep &= ~poisoned
    warm = pgbench_table(warmup_events, seed + 1, first_aid=n_events + 1)
    warm_payloads = table_payloads(warm)
    db = FakeDatabase()
    db.create_table(make_schema().table_schema)
    row_filters = None
    if row_filter is not None:
        row_filters = {PGBENCH_TID: (row_filter, lambda r: True)}
        db.server_row_filtering = False
    db.create_publication("pub", [PGBENCH_TID], row_filters=row_filters)
    dest = _tsv_destination() if tsv else _counting_destination()
    sink, store, overrides = dest, None, {}
    if poison_rate > 0:
        from .config import PoisonConfig
        from .destinations import PoisonRejectingDestination
        from .store import SqliteStore

        sink = PoisonRejectingDestination(dest)
        store = SqliteStore(os.path.join(store_dir, "state.db"), 1)
        await store.connect()
        overrides["poison"] = PoisonConfig(budget_rows=1_000_000)
    pipeline, store = _pipeline(db, sink, device, max_fill_ms,
                                subsystems=subsystems, store=store,
                                **overrides)
    degrades: list = []
    if pipeline.supervisor is not None:
        pipeline.supervisor.add_listener(
            lambda ev: degrades.append(ev) if ev.kind == "degrade" else None)
    poison_mod.reset_isolation_trace()
    await pipeline.start()
    await _wait_ready(store, PGBENCH_TID, 60)

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
    dest.decoded_rows.clear()
    if tsv:
        dest.writes.clear()
        dest.decoded.clear()
        dest.render_s = 0.0
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
    supervised = None
    if pipeline.supervisor is not None:
        from .supervision import SupervisedDestination

        pipeline.supervisor.sweep_once()
        snap = pipeline.health_snapshot()
        supervised = {
            "started": pipeline.supervisor.started,
            "wrapped": isinstance(pipeline.active_destination,
                                  SupervisedDestination),
            "health": snap["health"]["state"],
            "reasons": snap["health"]["reasons"],
            "events": [{"kind": e.kind, "component": e.component}
                       for e in pipeline.supervisor.events],
            "degrade_events": len(degrades)}
    dlq = None
    if poison_rate > 0:
        dlq = await _dlq_checks(store, commits, poisoned, t, n_events)
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
        # zero off the mesh (the reference's streaming report's too)
        "mesh_batches": int(d["mesh_batches"]),
        "mesh_padded_rows": int(d["mesh_padded_rows"]),
        "count_ok": delivered == want_rows,
        "digest_ok": digest == table_digest(t, np.flatnonzero(keep)),
        "order_ok": order_ok, "identity_ok": identity_ok,
        "oracle_sample_ok": await asyncio.to_thread(
            _oracle_sample_ok, batches, t, 512, seed, 1),
        "after_shutdown": {"pipeline_threads": threads,
                           "admission_in_flight": sched.in_flight,
                           "admission_tenants": sorted(
                               sched.stats()["tenants"])},
    }
    out["shutdown_ok"] = (not threads and sched.in_flight == 0
                          and not out["after_shutdown"]["admission_tenants"])
    out["ok"] = bool(out["count_ok"] and out["digest_ok"] and out["order_ok"]
                     and out["identity_ok"] and out["oracle_sample_ok"])
    # device runs of the window: the batches the decoders routed to the
    # device (smaller runs take the host route, on a card below its
    # measured threshold, or the oracle)
    out["device_runs"] = int(d["device_batches"])
    out["k1_per_device_run_ok"] = \
        out["k1_launches"] == out["device_runs"]
    if supervised is not None:
        out["supervision"] = supervised
        out["supervision_ok"] = bool(
            supervised["started"] and supervised["wrapped"]
            and supervised["degrade_events"] == 0
            and "device-degraded" not in supervised["reasons"]
            and supervised["health"] == "healthy"
            and (device != "cuda" or out["k1_per_device_run_ok"]))
        out["ok"] = bool(out["ok"] and out["supervision_ok"])
    if dlq is not None:
        out["dlq"] = dlq
        out["ok"] = bool(out["ok"] and dlq["ok"])
    if tsv:
        out.update(egress_launches=int(d["egress_launches"]),
                   egress_s=d["egress_s"], d2h_egress_s=d["d2h_egress_s"],
                   tsv=tsv_checks(dest, DeviceDecoder.DEVICE_MIN_ROWS
                                  if DeviceDecoder.PINNED_MIN_ROWS is None
                                  else DeviceDecoder.PINNED_MIN_ROWS))
        out["tsv"]["render_share"] = out["tsv"]["render_s"] / window
        out["ok"] = bool(
            out["ok"] and out["tsv"]["bodies_identical"]
            and out["tsv"]["device_runs_carried_text"]
            and out["tsv"]["used_device_when_carried"]
            and out["egress_launches"] == out["k1_launches"]
            and (device != "cuda" or out["egress_launches"] > 0))
    return out


#: `run_device_degrade`: how long the held fetch blocks (past the 0.5 s
#: stall deadline), and the degrade's cooldown
DEGRADE_STALL_S = 1.0
DEGRADE_COOLDOWN_S = 3.0
#: the poisoned stream's share of poison rows (BENCH_FLOOR.json
#: `poison_rate`)
POISON_RATE = 0.001


async def _pgbench_into(dest, *, copy_rows: int, n_events: int,
                        device: str, seed: int, tx_size: int, stored_rows,
                        what: str) -> tuple[dict, dict]:
    """pgbench_accounts copied and streamed into `dest`: the port's
    Pipeline on the fake walsender, the CUDA engine on `device`.
    `copy_rows` seeded rows are copied until READY, then `n_events`
    inserts stream in `tx_size`-row transactions until `stored_rows()`
    (what the destination holds, `what` in a timeout's message) reaches
    every row; then the pipeline shuts down, and the destination with
    it. Returns (the run's seconds, rates and counter deltas with
    `launches_ok`: on the card K1 launched once per device-routed batch;
    the written rows as `pgbench_table`'s arrays, copy then stream)."""
    from .postgres.fake import FakeDatabase

    t_copy = pgbench_table(copy_rows, seed)
    t_cdc = pgbench_table(n_events, seed + 1, first_aid=copy_rows + 1)
    payloads = table_payloads(t_cdc)
    db = FakeDatabase()
    db.create_table(make_schema().table_schema,
                    rows=table_text_rows(t_copy))
    db.create_publication("pub", [PGBENCH_TID])
    pipeline, store = _pipeline(db, dest, device)
    out: dict = {"copy_rows": copy_rows, "events": n_events,
                 "tx_size": tx_size, "device": device}
    want = copy_rows + n_events
    try:
        c0 = _counters()
        t0 = time.perf_counter()
        await pipeline.start()
        await _wait_ready(store, PGBENCH_TID, 900)
        out["copy_s"] = time.perf_counter() - t0
        t1 = time.perf_counter()
        for lo in range(0, n_events, tx_size):
            tx = db.transaction()
            for p in payloads[lo:lo + tx_size]:
                tx.insert_preencoded(PGBENCH_TID, p)
            await tx.commit()
        await _until(lambda: stored_rows() >= want, 900, what)
        out["cdc_s"] = time.perf_counter() - t1
        out["events_per_second"] = n_events / out["cdc_s"]
        out["rows_per_second"] = copy_rows / out["copy_s"]
        await pipeline.shutdown_and_wait()  # shuts the destination down
        out.update(_delta(c0, _counters()))
    finally:
        await pipeline.shutdown_and_wait()
    on_card = device.split(":")[0] == "cuda"
    out["launches_ok"] = out["device_batches"] > 0 and (
        out["k1_launches"] == out["device_batches"] if on_card
        else out["k1_launches"] == 0)
    cols = {k: np.concatenate([t_copy[k], t_cdc[k]])
            for k in ("aid", "bid", "abalance", "filler")}
    return out, cols


def _pgbench_rows_check(t, cols: dict) -> dict:
    """A pyarrow table read back from a destination against the written
    rows: `digest_ok` by `table_digest`, `rows_ok` by count, digest and
    column by column."""
    digest_ok = _arrow_rows_digest(t) == table_digest(cols)
    return {"digest_ok": digest_ok,
            "rows_ok": bool(t.num_rows == len(cols["aid"]) and digest_ok
                            and _arrow_rows_equal(t, cols))}


async def run_lake_cdc(copy_rows: int = 1_000_000,
                       n_events: int = 500_000, *, device: str = "cuda",
                       seed: int = 7, tx_size: int = 500,
                       warehouse_path: str | None = None) -> dict:
    """pgbench_accounts copied and streamed into the lake
    (`_pgbench_into`) through a `LakeDestination` (its defaults: Parquet
    files, compaction at 8 CDC files) in `warehouse_path` (a temporary
    directory by default). Checks: the lake's `read_current` holds
    exactly the written rows (`_pgbench_rows_check`), and on the card K1
    launched once per device-routed batch. `current` is that view
    (sorted by aid), read through a fresh `LakeDestination` after the
    pipeline's shutdown. Needs pyarrow
    (`destinations.util.require_pyarrow`)."""
    import tempfile

    from .destinations.lake import LakeConfig, LakeDestination
    from .destinations.util import require_pyarrow

    require_pyarrow("the lake run")
    tmp = None
    if warehouse_path is None:
        tmp = tempfile.TemporaryDirectory()
        warehouse_path = tmp.name
    dest = LakeDestination(LakeConfig(warehouse_path))

    def stored_rows() -> int:
        (n,) = dest._catalog().execute(
            "SELECT COALESCE(SUM(f.row_count), 0) FROM lake_files f JOIN "
            "lake_tables t ON t.table_id = f.table_id AND f.generation = "
            "t.generation WHERE f.table_id = ?", (PGBENCH_TID,)).fetchone()
        return int(n)

    try:
        out, cols = await _pgbench_into(
            dest, copy_rows=copy_rows, n_events=n_events, device=device,
            seed=seed, tx_size=tx_size, stored_rows=stored_rows,
            what="the lake's rows")
        reader = LakeDestination(LakeConfig(warehouse_path))
        await reader.startup()
        try:
            current = reader.read_current(PGBENCH_TID).sort_by("aid")
            out["cdc_files"] = reader.current_cdc_file_count(PGBENCH_TID)
            out["history"] = [(h["operation"], h["outcome"])
                              for h in reader.maintenance_history()]
        finally:
            await reader.shutdown()
    finally:
        if tmp is not None:
            tmp.cleanup()
    out["mode"] = "lake_cdc"
    out["lake_rows"] = current.num_rows
    out["current"] = current
    out.update(_pgbench_rows_check(current, cols))
    out["ok"] = bool(out["rows_ok"] and out["launches_ok"])
    return out


def iceberg_live_rows(table, key: str):
    """The live rows of a fake catalog's table, read the way an Iceberg
    engine reads them: the snapshot chain, each snapshot's Avro manifest
    list, its manifests, their Parquet data files, then the CDC collapse
    (per key the row of the greatest `_CHANGE_SEQUENCE_NUMBER`, a later
    snapshot winning a tie, DELETEs dropped). Returns (pyarrow.Table sorted
    by `key`, the number of data files read)."""
    import pyarrow as pa
    import pyarrow.compute as pc
    import pyarrow.parquet as pq

    from .testing.avro_reader import read_avro_ocf

    parts = []
    for snap in table.snapshots:
        _, manifests, _ = read_avro_ocf(snap["manifest-list"])
        for m in manifests:
            _, entries, _ = read_avro_ocf(m["manifest_path"])
            parts += [pq.read_table(e["data_file"]["file_path"])
                      for e in entries]
    t = pa.concat_tables(parts, promote_options="default")
    t = t.append_column("_order", pa.array(np.arange(t.num_rows)))
    t = t.set_column(
        t.schema.get_field_index("_CHANGE_SEQUENCE_NUMBER"),
        "_CHANGE_SEQUENCE_NUMBER",
        pc.fill_null(t.column("_CHANGE_SEQUENCE_NUMBER"), ""))
    t = t.sort_by([(key, "ascending"),
                   ("_CHANGE_SEQUENCE_NUMBER", "ascending"),
                   ("_order", "ascending")])
    keys = t.column(key).to_numpy()
    last = np.ones(len(keys), dtype=bool)
    last[:-1] = keys[1:] != keys[:-1]
    t = t.filter(pa.array(last))
    t = t.filter(pc.not_equal(t.column("_CHANGE_TYPE"), "DELETE"))
    return t.drop_columns(["_order"]), len(parts)


def _arrow_text_buffers(t, name: str) -> tuple:
    """(offsets, values) of a pyarrow table's string column."""
    import pyarrow as pa

    col = t.column(name).combine_chunks()
    off_type = np.int64 if pa.types.is_large_string(col.type) else np.int32
    offsets = np.frombuffer(col.buffers()[1], dtype=off_type)[
        col.offset:col.offset + len(col) + 1]
    return offsets, np.frombuffer(col.buffers()[2], dtype=np.uint8)


def _arrow_rows_digest(t) -> int:
    """`_rows_digest` of pgbench rows held in a pyarrow table."""
    offsets, values = _arrow_text_buffers(t, "filler")
    valid = [np.asarray(t.column(k).is_valid())
             for k in ("aid", "bid", "abalance", "filler")]
    return _rows_digest(
        *(t.column(k).to_numpy(zero_copy_only=False)
          for k in ("aid", "bid", "abalance")),
        _text_hash(offsets, values), np.diff(offsets.astype(np.int64)),
        valid)


def _arrow_rows_equal(t, cols: dict) -> bool:
    """A pyarrow table of pgbench rows equals `cols` (`pgbench_table`'s
    arrays, in its row order) column by column."""
    if t.num_rows != len(cols["aid"]) or t.column("filler").null_count:
        return False
    offsets, values = _arrow_text_buffers(t, "filler")
    start = int(offsets[0])
    return bool(
        all(np.array_equal(t.column(k).to_numpy(), cols[k])
            for k in ("aid", "bid", "abalance"))
        and np.array_equal(offsets - start, np.arange(
            t.num_rows + 1, dtype=np.int64) * FILLER_WIDTH)
        and np.array_equal(
            values[start:start + t.num_rows * FILLER_WIDTH],
            cols["filler"].ravel()))


async def run_iceberg_cdc(copy_rows: int = 1_000_000,
                          n_events: int = 500_000, *, device: str = "cuda",
                          seed: int = 7, tx_size: int = 500,
                          warehouse_path: str | None = None) -> dict:
    """pgbench_accounts copied and streamed into Iceberg
    (`_pgbench_into`) through an `IcebergDestination` committing to the
    port's `FakeIcebergCatalog` in this process (it validates each
    commit's whole metadata chain), its Parquet data files in
    `warehouse_path` (a temporary directory by default). Checks: the live
    rows read back through the snapshot chain, the manifests, Parquet and
    the CDC collapse (`iceberg_live_rows`) equal the written rows
    (`_pgbench_rows_check`), the catalog rejected nothing, and on the
    card K1 launched once per device-routed batch. Needs pyarrow
    (`destinations.util.require_pyarrow`)."""
    import tempfile

    from .destinations.iceberg import IcebergConfig, IcebergDestination
    from .destinations.util import escaped_table_name, require_pyarrow
    from .testing.fake_iceberg import FakeIcebergCatalog

    require_pyarrow("the Iceberg run")
    tmp = None
    if warehouse_path is None:
        tmp = tempfile.TemporaryDirectory()
        warehouse_path = tmp.name
    catalog = FakeIcebergCatalog()
    await catalog.start()
    config = IcebergConfig(catalog.url(), warehouse_path)
    name = escaped_table_name(make_schema().name)

    def committed_rows() -> int:
        t = catalog.tables.get((config.namespace, name))
        return 0 if t is None else sum(
            int(s["summary"].get("added-records", 0)) for s in t.snapshots)

    try:
        out, cols = await _pgbench_into(
            IcebergDestination(config), copy_rows=copy_rows,
            n_events=n_events, device=device, seed=seed, tx_size=tx_size,
            stored_rows=committed_rows,
            what="the Iceberg table's committed rows")
        table = catalog.table(config.namespace, name)
        t2 = time.perf_counter()
        live, files = iceberg_live_rows(table, "aid")
        out["read_s"] = time.perf_counter() - t2
        out["snapshots"] = len(table.snapshots)
        out["data_files"] = files
        out["rejections"] = list(catalog.rejections)
    finally:
        await catalog.stop()
        if tmp is not None:
            tmp.cleanup()
    out["mode"] = "iceberg_cdc"
    out["live_rows"] = live.num_rows
    out.update(_pgbench_rows_check(live, cols))
    out["rows_ok"] = bool(out["rows_ok"] and not out["rejections"])
    out["ok"] = bool(out["rows_ok"] and out["launches_ok"])
    return out


async def run_device_degrade(copy_rows: int = 200_000,
                             n_events: int = 100_000,
                             device: str = "cuda") -> dict:
    """The supervisor's host-oracle degrade, driven by a real stall: the
    reference's default config with `SupervisionConfig(check_interval_s=
    0.1, stall_deadline_s=0.5, device_degrade_threshold=1,
    device_degrade_cooldown_s=3)` copies a seeded pgbench_accounts table
    of `copy_rows` rows in 256 KiB chunks while the `PIPELINE_FETCH`
    failpoint holds the third chunk's fetch for `DEGRADE_STALL_S` (longer
    than the stall deadline). The fetch blocks its thread (copy fetches run in
    `asyncio.to_thread`, off the event loop the supervisor sweeps on), the
    partition's `decode:copy:...` heartbeat stays busy with its progress
    frozen, and the supervisor degrades every decoder to the host oracle.
    After READY and the degrade, `n_events // 5` insert events stream
    while the degrade holds; once the cooldown lapses, the rest.

    Checks: a `degrade` event fired; from the event (emitted after the
    engine is forced, which no routing decision can straddle) until the
    last moment the degrade held, the device-routed rows and batches
    stayed flat while the oracle-routed rows rose; K1 launched once per
    device-routed batch over the whole run (batches routed before the
    degrade may launch after it, behind the held fetch's window slot and
    admission ticket, and are reported); the degrade lifted (the engine
    no longer forced, the `device-degraded` health reason gone) and the
    events streamed after it launched K1; the copied rows (a restarted
    table sync drops and recopies) and the streamed rows equal the
    written ones by count and digest, the streamed ones once each in
    (commit LSN, ordinal) order. Restarts the supervisor made are
    reported, not refused."""
    from .chaos import failpoints
    from .config import BatchConfig, BatchEngine, SupervisionConfig
    from .ops import engine
    from .postgres.fake import FakeDatabase

    stall_s, cooldown_s = DEGRADE_STALL_S, DEGRADE_COOLDOWN_S
    t = pgbench_table(copy_rows, 9)
    cdc = pgbench_table(n_events, 10, first_aid=copy_rows + 1)
    payloads = table_payloads(cdc)
    db = FakeDatabase()
    db.create_table(make_schema().table_schema, rows=table_text_rows(t))
    db.create_publication("pub", [PGBENCH_TID])
    dest = _counting_destination()
    sup = SupervisionConfig(check_interval_s=0.1, stall_deadline_s=0.5,
                            device_degrade_threshold=1,
                            device_degrade_cooldown_s=cooldown_s)
    pipeline, store = _pipeline(
        db, dest, device, subsystems="default", supervision=sup,
        batch=BatchConfig(max_size_bytes=256 * 1024, max_fill_ms=30,
                          batch_engine=BatchEngine.CUDA, device=device))
    marks: dict = {}

    def snap() -> dict:
        c = _counters()
        return {"k1": int(c["k1_launches"]), "oracle": int(c["oracle_rows"]),
                "device": int(c["device_rows"]),
                "batches": int(c["device_batches"]),
                "at": time.perf_counter()}

    def on_event(ev) -> None:
        if ev.kind == "degrade" and "degrade" not in marks:
            marks["degrade"] = snap()
            marks["component"] = ev.component

    async def watch() -> None:
        # the last sample taken while the degrade still held
        while True:
            if "degrade" in marks and engine.host_oracle_forced():
                marks["last_forced"] = snap()
            await asyncio.sleep(0.02)

    pipeline.supervisor.add_listener(on_event)
    engine.clear_forced_oracle()
    failpoints.arm_stall(failpoints.PIPELINE_FETCH, duration_s=stall_s,
                         times=1, after_hits=2)
    watcher = asyncio.ensure_future(watch())
    c0 = _counters()
    t0 = time.perf_counter()
    produced = 0
    commits: list = []

    async def produce(upto: int) -> None:
        nonlocal produced
        while produced < upto:
            tx = db.transaction()
            hi = min(produced + 500, upto)
            for p in payloads[produced:hi]:
                tx.insert_preencoded(PGBENCH_TID, p)
            commits.append((int(await tx.commit()), produced, hi))
            produced = hi

    async def delivered(n: int, timeout: float) -> None:
        async def poll():
            while dest.rows_delivered < n:
                if pipeline._apply_task.done():
                    pipeline._apply_task.result()
                    raise RuntimeError("pipeline stopped before delivering")
                await asyncio.sleep(0.01)

        await asyncio.wait_for(poll(), timeout)

    try:
        await pipeline.start()
        await _wait_ready(store, PGBENCH_TID, 600)
        t_ready = time.perf_counter()
        copied = dest.rows_delivered
        deadline = time.monotonic() + stall_s + cooldown_s + 10
        while "degrade" not in marks and time.monotonic() < deadline:
            await asyncio.sleep(0.01)
        await produce(n_events // 5)
        await delivered(copied + produced, 300)
        # the cooldown lapses on its own: wait for the engine and for the
        # sweep to lift the health reason
        deadline = time.monotonic() + cooldown_s + 30
        while (engine.host_oracle_forced() or "device-degraded"
               in pipeline.supervisor.health.reasons) \
                and time.monotonic() < deadline:
            await asyncio.sleep(0.05)
        lifted = not engine.host_oracle_forced() \
            and "device-degraded" not in pipeline.supervisor.health.reasons
        c_lift = _counters()
        await produce(n_events)
        await delivered(copied + n_events, 300)
        t_done = time.perf_counter()
        c_end = _counters()
        health = pipeline.health_snapshot()["health"]
        events = [{"kind": e.kind, "component": e.component}
                  for e in pipeline.supervisor.events]
    finally:
        watcher.cancel()
        failpoints.disarm_all()
        if pipeline._apply_task is not None:
            await pipeline.shutdown_and_wait()
        engine.clear_forced_oracle()
    d = _delta(c0, c_end)
    after = _delta(c_lift, c_end)
    streamed = dest.events  # the CDC rows (copied ones are in `copied`)
    commits_all = np.concatenate([e[2] for e in streamed]) \
        if streamed else np.zeros(0, np.uint64)
    ords_all = np.concatenate([e[3] for e in streamed]) \
        if streamed else np.zeros(0, np.uint64)
    key = commits_all.astype(np.uint64) * np.uint64(1 << 20) \
        + ords_all.astype(np.uint64)
    # a restarted apply worker re-streams from durable progress: rows past
    # it arrive again (at-least-once), so the streamed rows are held to
    # the truth by key, and to once-each order only without a restart
    uniq, first = np.unique(key, return_index=True)
    rows = _rows_arrays([e[0] for e in streamed])
    restarts = [e for e in events if e["kind"] == "restart"]
    at, last = marks.get("degrade"), marks.get("last_forced")
    out = {
        "mode": "device_degrade", "copy_rows": copy_rows,
        "events": n_events, "device": device, "stall_s": stall_s,
        "cooldown_s": cooldown_s,
        "degrade_fired": "degrade" in marks,
        "degrade_component": marks.get("component"),
        "degrade_at_s": marks["degrade"]["at"] - t0
        if "degrade" in marks else None,
        "ready_at_s": t_ready - t0, "done_at_s": t_done - t0,
        # K1 launches here are of batches routed before the degrade
        "while_degraded": None if last is None else {
            "seconds": last["at"] - at["at"],
            "k1_launches": last["k1"] - at["k1"],
            "device_batches": last["batches"] - at["batches"],
            "device_rows": last["device"] - at["device"],
            "oracle_rows": last["oracle"] - at["oracle"]},
        "lifted": bool(lifted),
        "after_lift": {"k1_launches": int(after["k1_launches"]),
                       "device_rows": int(after["device_rows"]),
                       "oracle_rows": int(after["oracle_rows"])},
        "k1_launches": int(d["k1_launches"]),
        "device_batches": int(d["device_batches"]),
        "device_rows": int(d["device_rows"]),
        "oracle_rows": int(d["oracle_rows"]),
        "restarts": restarts,
        "supervision_events": events, "health_at_end": health["state"],
        "copy_ok": bool(
            sum(b.num_rows for b in dest.copied) == copy_rows
            and sum(batch_rows_digest(b) for b in dest.copied) % (1 << 64)
            == table_digest(t)),
        "cdc_rows_delivered": len(key),
        "cdc_once_in_order": bool(len(key) == n_events
                                  and np.all(np.diff(key) > 0)),
        "cdc_ok": bool(
            len(uniq) == n_events
            and _rows_digest(*(a[first] for a in rows[:5]),
                             [v[first] for v in rows[5]])
            == table_digest(cdc)),
    }
    out["cdc_ok"] = bool(out["cdc_ok"] and (
        out["cdc_once_in_order"]
        or any(r["component"] == "apply" for r in restarts)))
    wd = out["while_degraded"]
    out["device_flat_while_degraded"] = bool(
        wd is not None and wd["device_batches"] == 0
        and wd["device_rows"] == 0)
    out["oracle_rose_while_degraded"] = bool(wd is not None
                                             and wd["oracle_rows"] > 0)
    # the plain versions on the CPU launch nothing
    out["k1_per_device_batch"] = out["k1_launches"] == (
        out["device_batches"] if device == "cuda" else 0)
    out["k1_after_lift"] = out["after_lift"]["k1_launches"] > 0 \
        if device == "cuda" else out["after_lift"]["oracle_rows"] == 0
    out["ok"] = bool(out["degrade_fired"]
                     and out["device_flat_while_degraded"]
                     and out["k1_per_device_batch"]
                     and out["oracle_rose_while_degraded"] and out["lifted"]
                     and out["k1_after_lift"] and out["copy_ok"]
                     and out["cdc_ok"])
    return out


async def _dlq_checks(store, commits: list, poisoned: np.ndarray, t: dict,
                      n_events: int) -> dict:
    """The dead-letter side of a poisoned stream, read once the healthy
    rows are delivered: every poison row is on the store exactly once
    under its WAL key (commit LSN, ordinal) with its own values, every
    isolation's probe writes are within `bisection_bound`, and the DLQ
    CLI in another process (`python -m etl_tpu_torch.dlq --sqlite ...
    list`) lists the same entries while the pipeline still holds the
    file open."""
    from .dlq.codec import decode_cell
    from .runtime import poison as poison_mod

    want = int(poisoned.sum())
    deadline = time.monotonic() + 60
    entries = await store.list_dead_letters(status=None)
    while len(entries) < want and time.monotonic() < deadline:
        await asyncio.sleep(0.05)
        entries = await store.list_dead_letters(status=None)
    first_of = {lsn: lo for lsn, lo, _ in commits}
    src = np.asarray([first_of.get(e.commit_lsn, -10**12) + e.tx_ordinal
                      for e in entries], dtype=np.int64)
    known = bool(((src >= 0) & (src < n_events)).all())
    values_ok = known and all(
        decode_cell(json.loads(e.payload)["values"][0]) == int(t["aid"][i])
        and decode_cell(json.loads(e.payload)["values"][3]).startswith(
            "POISON")
        for e, i in zip(entries, src.tolist()))
    traces = list(poison_mod.ISOLATION_TRACE)
    probe_writes = sum(tr["probe_writes"] for tr in traces)
    bound_ok = all(tr["probe_writes"] <= poison_mod.bisection_bound(
        tr["rows"], tr["tables"], tr["poison_rows"]) for tr in traces)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "etl_tpu_torch.dlq", "--sqlite", store.path,
         "--pipeline-id", str(store.pipeline_id), "list", "--status",
         "all"],
        capture_output=True, text=True, timeout=300, cwd=root,
        env={**os.environ, "PYTHONPATH": root})
    cli_s = time.perf_counter() - t0
    listed = json.loads(proc.stdout) if proc.returncode == 0 else {}
    cli_ok = proc.returncode == 0 and sorted(
        (d["commit_lsn"], d["tx_ordinal"], d["entry_id"])
        for d in listed.get("entries", [])) == sorted(
        (e.commit_lsn, e.tx_ordinal, e.entry_id) for e in entries)
    out = {
        "poison_rows": want, "entries": len(entries),
        "exactly_once": bool(
            known and len(entries) == want
            and set(src.tolist()) == set(np.flatnonzero(poisoned).tolist())
            and all(e.attempts == 1 for e in entries)),
        "values_ok": bool(values_ok),
        "isolations": len(traces), "probe_writes": probe_writes,
        "probe_bound": sum(poison_mod.bisection_bound(
            tr["rows"], tr["tables"], tr["poison_rows"]) for tr in traces),
        "bound_ok": bool(bound_ok and traces),
        "isolated_poison_rows": sum(tr["poison_rows"] for tr in traces),
        "cli_ok": bool(cli_ok), "cli_s": cli_s,
        "cli_stderr": proc.stderr[-2000:] if proc.returncode else "",
    }
    out["ok"] = bool(out["exactly_once"] and out["values_ok"]
                     and out["bound_ok"] and out["cli_ok"])
    return out


def _pipeline_threads(timeout_s: float) -> list:
    """The port's decode-pipeline worker threads still alive (`describe_
    thread` of each), after giving closed pipelines up to `timeout_s` to
    let their workers exit."""
    from .ops.pipeline import describe_thread, worker_threads

    deadline = time.monotonic() + timeout_s
    while True:
        left = worker_threads()
        if not left or time.monotonic() >= deadline:
            return [describe_thread(th) for th in left]
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


def _egress_batch(n_rows: int, egress: str | None = None,
                  device: str = "cuda"):
    """The reference's `harness._egress_batch` on the port: a decoded
    batch of the pgbench-CDC column mix (id INT8, bucket INT4, val FLOAT8,
    note TEXT) through the real staging and decode path on `device`; with
    `egress` the decode launches the render kernel and the batch carries
    `device_egress`. Returns (schema, batch, the decode's timings)."""
    from .models import (ColumnSchema, Oid, ReplicatedTableSchema, TableName,
                         TableSchema)
    from .ops.engine import DeviceDecoder
    from .ops.wal import concat_payloads, stage_wal_batch
    from .postgres.codec.pgoutput import encode_insert

    tid = 16390
    schema = ReplicatedTableSchema.with_all_columns(TableSchema(
        tid, TableName("public", "bench_egress"),
        (ColumnSchema("id", Oid.INT8, nullable=False, primary_key_ordinal=1),
         ColumnSchema("bucket", Oid.INT4),
         ColumnSchema("val", Oid.FLOAT8),
         ColumnSchema("note", Oid.TEXT))))
    payloads = [encode_insert(tid, [str(i).encode(), str(i % 97).encode(),
                                    (b"%d.5" % i), b"note-%d" % i])
                for i in range(n_rows)]
    staged = stage_wal_batch(*concat_payloads(payloads), 4).staged
    decoder = DeviceDecoder(schema, device=device, egress=egress)
    decoder.decode(staged)  # warm-up: descriptors, pinned buffers
    pending = decoder.decode_async(staged)
    return schema, pending.result(), pending.timings


def run_egress(n_rows: int = N_ROWS, n_iters: int = 3,
               device: str = "cuda") -> dict:
    """Each destination encoder in isolation (ColumnarBatch → wire bytes):
    the port of the reference's `harness.run_egress(device=True)`. Rows/s
    and bytes/s of the BigQuery proto encoder, the ClickHouse TSV and the
    Snowpipe NDJSON columnar renderers on a batch decoded without egress,
    then of the TSV and NDJSON fast paths on batches decoded with it
    (`device_{tsv,json}_*`: the buffers attached, the fast path used them,
    its bytes equal the columnar oracle's) and of the same fast paths on
    the host twins (`host_{tsv,json}_*`). The Parquet row-group writer
    (the lake's and Iceberg's: Arrow record batch with the CDC columns →
    one Parquet table in memory) is measured where pyarrow imports, and
    `parquet` says why not where it does not. Min over `n_iters` of the
    host clock."""
    from .destinations import bq_proto
    from .destinations.clickhouse import (render_batch_tsv_columnar,
                                          render_batch_tsv_fast)
    from .destinations.snowflake import (encode_batch_ndjson,
                                         encode_batch_ndjson_fast,
                                         offset_token_batch)
    from .benchmarks.smoke import PYARROW_MISSING, pyarrow_importable
    from .destinations.util import (CHANGE_SEQUENCE_COLUMN,
                                    CHANGE_TYPE_COLUMN, change_type_arrow,
                                    change_type_batch, sequence_number_arrow,
                                    sequence_number_batch,
                                    sequence_number_buffer)
    from .ops.egress import ENCODER_JSON, ENCODER_TSV

    schema, batch, _ = _egress_batch(n_rows, device=device)
    cts = np.zeros(n_rows, dtype=np.int64)
    lsns = np.arange(n_rows, dtype=np.uint64) + (1 << 40)
    txos = np.arange(n_rows, dtype=np.uint64)
    ords = np.arange(n_rows, dtype=np.uint64)

    def timed(fn):
        times, nbytes = [], 0
        for _ in range(n_iters):
            t0 = time.perf_counter()
            nbytes = fn()
            times.append(time.perf_counter() - t0)
        dt = min(times)
        return round(n_rows / dt), round(nbytes / dt)

    def bq():
        labels = change_type_batch(cts).tolist()
        seqs = sequence_number_batch(lsns, txos, ords)
        return sum(len(r) for r in bq_proto.encode_batch(schema, batch,
                                                         labels, seqs))

    def clickhouse():
        labels = [t.decode() for t in change_type_batch(cts).tolist()]
        seqs = [q.decode() for q in sequence_number_batch(lsns, txos, ords)]
        return len(render_batch_tsv_columnar(schema, batch, labels, seqs))

    def snowpipe():
        lines = encode_batch_ndjson(schema, batch, ["insert"] * n_rows,
                                    offset_token_batch(lsns, txos))
        return sum(len(ln) for ln in lines)

    def parquet():
        import io

        import pyarrow as pa
        import pyarrow.parquet as pq

        rb = batch.to_arrow()
        rb = rb.append_column(CHANGE_TYPE_COLUMN, change_type_arrow(cts))
        rb = rb.append_column(CHANGE_SEQUENCE_COLUMN,
                              sequence_number_arrow(lsns, txos, ords))
        sink = io.BytesIO()
        pq.write_table(pa.Table.from_batches([rb]), sink)
        return sink.tell()

    out: dict = {"mode": "egress", "rows": n_rows, "iters": n_iters,
                 "device": device}
    encoders = [("bq_proto", bq), ("clickhouse_tsv", clickhouse),
                ("snowpipe_ndjson", snowpipe)]
    if pyarrow_importable():
        encoders.insert(2, ("parquet", parquet))
    else:
        out["parquet"] = f"not measured: {PYARROW_MISSING}"
    for name, fn in encoders:
        out[f"{name}_rows_per_sec"], out[f"{name}_bytes_per_sec"] = timed(fn)

    seq_buf = sequence_number_buffer(lsns, txos, ords)
    seq_strs = [q.decode() for q in sequence_number_batch(lsns, txos, ords)]
    _, tsv_batch, tsv_timings = _egress_batch(n_rows, ENCODER_TSV, device)
    dev_tsv = tsv_batch.device_egress
    used = {}

    def tsv():
        body, used["tsv"] = render_batch_tsv_fast(
            schema, tsv_batch, "UPSERT", seq_buf, egress=dev_tsv)
        return len(body)

    out["device_tsv_attached"] = dev_tsv is not None
    out["device_tsv_rows_per_sec"], out["device_tsv_bytes_per_sec"] = \
        timed(tsv)
    # the same fast path on the host twins (no device text): what the
    # device text buys the encoder
    out["host_tsv_rows_per_sec"], out["host_tsv_bytes_per_sec"] = timed(
        lambda: len(render_batch_tsv_fast(schema, tsv_batch, "UPSERT",
                                          seq_buf)[0]))
    out["device_tsv_used_device"] = used["tsv"]
    out["device_tsv_identical"] = render_batch_tsv_fast(
        schema, tsv_batch, "UPSERT", seq_buf, egress=dev_tsv)[0] \
        == render_batch_tsv_columnar(schema, tsv_batch, "UPSERT", seq_strs)
    out["device_tsv_decode_timings"] = tsv_timings

    _, json_batch, json_timings = _egress_batch(n_rows, ENCODER_JSON, device)
    dev_json = json_batch.device_egress
    ops = ["insert"] * n_rows
    seqs = offset_token_batch(lsns, txos)

    def ndjson():
        lines, used["json"] = encode_batch_ndjson_fast(
            schema, json_batch, ops, seqs, egress=dev_json)
        return sum(len(ln) for ln in lines)

    out["device_json_attached"] = dev_json is not None
    out["device_json_rows_per_sec"], out["device_json_bytes_per_sec"] = \
        timed(ndjson)
    out["host_json_rows_per_sec"], out["host_json_bytes_per_sec"] = timed(
        lambda: sum(len(ln) for ln in encode_batch_ndjson_fast(
            schema, json_batch, ops, seqs)[0]))
    out["device_json_used_device"] = used["json"]
    out["device_json_identical"] = encode_batch_ndjson_fast(
        schema, json_batch, ops, seqs, egress=dev_json)[0] \
        == encode_batch_ndjson(schema, json_batch, ops, seqs)
    out["device_json_decode_timings"] = json_timings
    out["ok"] = all(out[f"device_{e}_{k}"] for e in ("tsv", "json")
                    for k in ("attached", "used_device", "identical"))
    return out


# ---------------------------------------------------------------------------
# the replicator binary over the Postgres wire protocol
# ---------------------------------------------------------------------------

#: the SCRAM password of the fake server the wire runs start
WIRE_PASSWORD = "wire-scram-secret"
#: the largest share of a wire CDC window's rows that may go to the
#: oracle, each in a run of fewer than the decoder's `device_min_rows`
#: rows: the fill timer cuts runs between row frames, more often the
#: slower the host (PERF.md §6)
WIRE_CDC_ORACLE_SHARE_MAX = 0.01


def free_port() -> int:
    """A TCP port on 127.0.0.1 that nothing listens on now."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


async def http_get(port: int, path: str,
                   headers: dict | None = None) -> tuple:
    """(status, body) of one HTTP/1.1 GET to 127.0.0.1:`port`, with
    `headers` added."""
    extra = "".join(f"{k}: {v}\r\n" for k, v in (headers or {}).items())
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    try:
        writer.write(f"GET {path} HTTP/1.1\r\nHost: 127.0.0.1\r\n"
                     f"{extra}Connection: close\r\n\r\n".encode())
        await writer.drain()
        raw = await reader.read()
    finally:
        writer.close()
    head, _, body = raw.partition(b"\r\n\r\n")
    return int(head.split()[1]), body


def write_replicator_config(config_dir: str, *, server_port: int,
                            metrics_port: int, device: str,
                            store: dict, max_fill_ms: int = 30,
                            destination: dict | None = None) -> None:
    """The replicator's `base.yaml`, written in YAML's JSON subset: the
    reference's default PipelineConfig (supervision and poison on) but for
    the pipeline id, the publication, the connection and the batch (the
    CUDA engine on `device`, the runtime phases' 30 ms fill window);
    `destination` (a memory one by default); `store`; `/metrics` and
    `/health` on `metrics_port`. The password comes from
    APP_PG_CONNECTION__PASSWORD."""
    os.makedirs(config_dir, exist_ok=True)
    doc = {"pipeline_id": 1, "publication_name": "pub",
           "pg_connection": {"host": "127.0.0.1", "port": server_port,
                             "name": "postgres", "username": "etl"},
           "batch": {"max_fill_ms": max_fill_ms, "batch_engine": "cuda",
                     "device": device},
           "destination": destination or {"type": "memory"},
           "store": store,
           "metrics_port": metrics_port}
    with open(os.path.join(config_dir, "base.yaml"), "w") as f:
        json.dump(doc, f, indent=2)


class _ReplicatorTap:
    """What a run reads of `replicator.run_replicator` without an option of
    its own: each destination the registry builds, with its writes counted
    and stamped on arrival (the commit LSNs of the inserts of each write,
    at `time.perf_counter()` after it), and the time the replicator logs
    `pipeline started`."""

    def __init__(self):
        self.dests: list = []
        self.inserts = 0
        self.copied = 0
        self.arrivals: dict = {}  # commit LSN → first arrival
        self.started_at: "float | None" = None

    def __enter__(self):
        import logging

        from . import replicator

        tap = self

        def build(doc):
            dest = tap._real_build(doc)
            tap._stamp(dest)
            tap.dests.append(dest)
            return dest

        class _Started(logging.Handler):
            def emit(self, record):
                if record.getMessage() == "pipeline started":
                    tap.started_at = time.perf_counter()

        self._real_build = replicator.build_destination
        replicator.build_destination = build
        self._logger = logging.getLogger("etl_tpu_torch.replicator")
        self._level = self._logger.level
        self._handler = _Started()
        self._logger.addHandler(self._handler)
        self._logger.setLevel(logging.INFO)
        return self

    def __exit__(self, *exc):
        from . import replicator

        replicator.build_destination = self._real_build
        self._logger.removeHandler(self._handler)
        self._logger.setLevel(self._level)

    def _stamp(self, dest) -> None:
        """Count and stamp a memory destination's writes (a warehouse
        destination's arrivals are stamped by its fake)."""
        from .models.event import InsertEvent

        if not hasattr(dest, "events"):
            return

        write_events, write_rows = dest.write_events, dest.write_table_rows
        tap = self

        async def stamped_events(events):
            n0 = len(dest.events)
            ack = await write_events(events)
            now = time.perf_counter()
            new = [e for e in dest.events[n0:] if type(e) is InsertEvent]
            tap.inserts += len(new)
            for lsn in {int(e.commit_lsn) for e in new}:
                tap.arrivals.setdefault(lsn, now)
            return ack

        async def stamped_rows(schema, batch):
            ack = await write_rows(schema, batch)
            tap.copied += batch.num_rows
            return ack

        dest.write_events = stamped_events
        dest.write_table_rows = stamped_rows


def _rows_of(values: list) -> tuple:
    """`_rows_digest` inputs of decoded pgbench rows given as value lists."""
    n = len(values)
    if n == 0:
        z = np.zeros(0, dtype=np.int64)
        return z, z, z, z, z, [np.zeros(0, dtype=bool)] * 4
    aid, bid, abal, filler = zip(*values)
    enc = [f.encode() for f in filler]
    offsets = np.zeros(n + 1, dtype=np.int64)
    offsets[1:] = np.cumsum([len(b) for b in enc])
    text = np.frombuffer(b"".join(enc), dtype=np.uint8)
    return (np.asarray(aid, dtype=np.int64), np.asarray(bid, dtype=np.int64),
            np.asarray(abal, dtype=np.int64), _text_hash(offsets, text),
            np.diff(offsets), [np.ones(n, dtype=bool)] * 4)


def _sample_batch(values: list, n: int, seed: int):
    """`n` of the rows, picked with `seed`, as one ColumnarBatch."""
    from .models.table_row import ColumnarBatch, TableRow

    rng = np.random.default_rng(seed)
    picks = rng.choice(len(values), size=min(n, len(values)), replace=False)
    return ColumnarBatch.from_rows(make_schema(),
                                   [TableRow(list(values[i])) for i in picks])


async def _until(cond, timeout_s: float, what: str, interval: float = 0.01):
    """Poll `cond` (a function, or a coroutine function) until it returns
    something true; raise after `timeout_s`."""
    deadline = time.perf_counter() + timeout_s
    while True:
        got = cond()
        if asyncio.iscoroutine(got):
            got = await got
        if got:
            return got
        if time.perf_counter() > deadline:
            raise RuntimeError(f"timed out waiting for {what}")
        await asyncio.sleep(interval)


async def run_wire_replicator(copy_rows: int = 1_000_000,
                              n_events: int = 500_000, *,
                              device: str = "cuda",
                              row_filter: str | None = None, seed: int = 7,
                              warmup_events: int = 17_000,
                              restart_events: int = 20_000,
                              destination: str = "memory") -> dict:
    """The replicator binary's main path over the Postgres wire protocol,
    in process: `replicator.run_replicator(config_dir)`, the function
    `python -m etl_tpu_torch.replicator` runs, on this thread's event loop
    (its SIGTERM handler needs the main thread), against a fake server
    with SCRAM auth in a child process (`testing.pg_process`) that owns
    the database and the producer. The config is
    `write_replicator_config`'s, with the store in a PostgresStore on the
    same server. The run:

    - `/health` polled from the start: 503 `starting` until the pipeline
      starts, then 200 `healthy`;
    - the initial copy of `copy_rows` seeded pgbench_accounts rows
      (phase 6's table) over COPY until the table is READY in the
      PostgresStore (read on the server): rows/s and MiB/s from the
      replicator's `pipeline started` to READY;
    - warm-up transactions off the clock, then `n_events` inserts in
      500-row transactions committed as fast as the child can
      (phase 7's stream), until every row arrived: events/s over the
      producer's first commit to the last arrival, and the lag of each
      commit (its arrival at the destination minus the child's commit
      time, one clock);
    - the slot's confirmed flush reaching the last commit's LSN,
      `/metrics` with the decode counters, then SIGTERM to this process:
      `run_replicator` returns, and no decode worker, admission ticket or
      tenant is left;
    - with `restart_events`, a second lifetime on the same store after
      that many inserts: no copy again, exactly those rows once each.

    `destination` is `memory` (the rows are read in process), or
    `clickhouse`, `bigquery` or `snowflake`: the registry builds that
    destination against its HTTP fake in a child process of its own
    (`testing.http_process`), which tallies what arrives; arrivals are
    stamped there.

    With `row_filter` the publication carries it in the catalog and the
    walsender ships every row (offload mode): the client reads the filter
    from pg_publication_tables and its fused filter keeps the matching
    rows. Checks (each a key, `ok` all of them): counts and digests of the
    copied and streamed rows against the written rows (the filter's truth
    with one), each insert once (in (commit LSN, ordinal) order with the
    memory destination) with its row, 512 sampled rows against the CPU
    oracle, and the launches of the run (both lifetimes) against its
    device-routed batches. A warehouse destination adds: the delivered
    text of 512 seeded rows (256 copied, 256 streamed) byte for byte
    against the host encoder on the written row (BigQuery: the decoded
    row, read by both decoders), the render kernel once per unfiltered
    device-routed batch with device-rendered writes counted, its DDL once
    a lifetime, and its commit seam's records."""
    import signal
    import tempfile

    from . import replicator
    from .ops.pipeline import global_admission
    from .testing.pg_process import PgServerProcess

    tx_size = 500
    http = destination != "memory"
    out: dict = {"mode": "wire_replicator", "copy_rows": copy_rows,
                 "events": n_events, "tx_size": tx_size, "device": device,
                 "row_filter": row_filter, "store": "postgres",
                 "destination": destination}
    first_aid = copy_rows + 1
    t_copy = pgbench_table(copy_rows, seed)
    t_cdc = pgbench_table(n_events, seed + 1, first_aid=first_aid)
    copy_keep = np.ones(copy_rows, dtype=bool) if row_filter is None \
        else _filter_truth(row_filter, t_copy)
    keep = np.ones(n_events, dtype=bool) if row_filter is None \
        else _filter_truth(row_filter, t_cdc)

    def kept(t: dict) -> int:
        return len(t["aid"]) if row_filter is None \
            else int(_filter_truth(row_filter, t).sum())

    env_key = "APP_PG_CONNECTION__PASSWORD"
    env_before = os.environ.get(env_key)
    os.environ[env_key] = WIRE_PASSWORD
    server = PgServerProcess(password=WIRE_PASSWORD)
    call = server.call
    fake = None

    async def acall(cmd, **kw):
        return await asyncio.to_thread(call, cmd, **kw)

    async def fcall(cmd, **kw):
        return await asyncio.to_thread(fake.call, cmd, **kw)

    tmp = tempfile.TemporaryDirectory()
    config_dir = os.path.join(tmp.name, "config")
    try:
        dest_doc = {"type": "memory"}
        watch = None
        if http:
            from .testing.http_process import HttpServerProcess

            fake = HttpServerProcess(destination)
            dest_doc = fake.destination_doc()
            watch = _watch_aids(t_copy, copy_keep, t_cdc, keep, seed)
            fake.call("watch", aids=watch)
        copy_bytes = call("table", n_rows=copy_rows, seed=seed)["copy_bytes"]
        call("publication", name="pub", row_filter=row_filter,
             offload=row_filter is not None)
        metrics_port = free_port()
        write_replicator_config(config_dir, server_port=server.port,
                                metrics_port=metrics_port, device=device,
                                store={"type": "postgres"},
                                destination=dest_doc)
        c_start = _counters()

        async def delivered() -> int:
            """CDC rows delivered so far, over both lifetimes."""
            if http:
                return (await fcall("count"))["cdc_rows"]
            return tap.inserts

        async def until_delivered(want: int, timeout_s: float, what: str):
            async def done():
                return await delivered() >= want

            await _until(done, timeout_s, what,
                         interval=0.02 if http else 0.01)

        with _ReplicatorTap() as tap:
            # -- lifetime 1 ----------------------------------------------------
            t0 = time.perf_counter()
            task = asyncio.ensure_future(
                replicator.run_replicator(config_dir))
            health: list = []

            async def healthy():
                if task.done():
                    task.result()
                    raise RuntimeError("the replicator stopped")
                try:
                    status, body = await http_get(metrics_port, "/health")
                except OSError:
                    return False
                doc = json.loads(body)
                if not health or health[-1] != (status, doc):
                    health.append((status, doc))
                return status == 200

            await _until(healthy, 600, "/health 200", interval=0.002)
            out["health"] = [[s, d] for s, d in health]
            out["health_ok"] = bool(
                health[0] == (503, {"status": "starting"})
                and health[-1] == (200, {"status": "healthy"}))
            dest = tap.dests[0]

            async def ready():
                raw = await acall("state", pipeline_id=1,
                                  table_id=PGBENCH_TID)
                return raw is not None and json.loads(raw)["state"] \
                    == "ready"

            await _until(ready, 900, "READY in the PostgresStore")
            t_ready = time.perf_counter()
            c_copied = _counters()
            copy_s = t_ready - tap.started_at
            out.update({
                "pipeline_start_ms": (tap.started_at - t0) * 1e3,
                "copy_wait_ms": copy_s * 1e3, "copy_bytes": copy_bytes,
                "rows_per_second": copy_rows / copy_s,
                "mib_per_second": copy_bytes / (1 << 20) / copy_s,
                "rows_delivered": (await fcall("count"))["copy_rows"]
                if http else tap.copied})
            dc = _delta(c_start, c_copied)
            out["copy_stages"] = {k: dc[k] for k in (
                "device_rows", "oracle_rows", "device_batches",
                "k1_launches", "k2c_launches", "egress_launches",
                "device_s", "kernel_s")}
            out["copy_stages"]["device_busy_share"] = dc["device_s"] / copy_s

            # warm-up off the clock: 200, 800, 3000 and the rest, rows of
            # other aids, each wave seeded on its own
            w = want = 0
            for k, wave in enumerate((200, 800, 3000, warmup_events - 4000)):
                wave_first = first_aid + n_events + w
                want += kept(pgbench_table(wave, seed + 10 + k,
                                           first_aid=wave_first))
                await acall("prepare", n_events=wave, seed=seed + 10 + k,
                            first_aid=wave_first)
                await acall("produce", tx_size=tx_size)
                w += wave
                await until_delivered(want, 120, "warm-up rows")
            base = await delivered()
            n_events_before = 0 if http else len(dest.events)
            tap.arrivals.clear()
            await acall("prepare", n_events=n_events, seed=seed + 1,
                        first_aid=first_aid)
            c0 = _counters()
            prod = await acall("produce", tx_size=tx_size)
            want_rows = int(keep.sum())
            await until_delivered(base + want_rows, 900, "the CDC rows")
            t_e2e = time.perf_counter()
            d = _delta(c0, _counters())
            last_lsn = prod["commits"][-1][0]

            async def confirmed():
                s = await acall("slot", name="supabase_etl_apply_1")
                return s is not None and s["confirmed_flush"] >= last_lsn

            await _until(confirmed, 120, "the slot's confirmed flush")
            status, metrics = await http_get(metrics_port, "/metrics")
            lines = metrics.decode().splitlines()
            out["metrics_ok"] = status == 200 and any(
                ln.startswith("etl_decode_routed_device_rows_total ")
                and float(ln.split()[-1]) > 0 for ln in lines)
            os.kill(os.getpid(), signal.SIGTERM)
            await asyncio.wait_for(task, 120)
            sched = global_admission()
            threads = _pipeline_threads(timeout_s=5.0)
            out["after_shutdown"] = {
                "pipeline_threads": threads,
                "admission_in_flight": sched.in_flight,
                "admission_tenants": sorted(sched.stats()["tenants"])}
            out["shutdown_ok"] = (not threads and sched.in_flight == 0
                                  and not sched.stats()["tenants"])
            if http:
                report1 = await fcall("report")
            else:
                cdc_events = [e for e in dest.events[n_events_before:]
                              if type(e).__name__ == "InsertEvent"]
                copied_values = [r.values
                                 for r in dest.table_rows[PGBENCH_TID]]

            # -- lifetime 2 ----------------------------------------------------
            restart = None
            if restart_events:
                r_first = first_aid + n_events + warmup_events
                t_r = pgbench_table(restart_events, seed + 3,
                                    first_aid=r_first)
                await acall("prepare", n_events=restart_events,
                            seed=seed + 3, first_aid=r_first)
                r_prod = await acall("produce", tx_size=tx_size)
                task = asyncio.ensure_future(
                    replicator.run_replicator(config_dir))
                health.clear()
                await _until(healthy, 600, "/health 200 after the restart",
                             interval=0.005)
                dest2 = tap.dests[1]
                r_keep = np.ones(restart_events, dtype=bool) \
                    if row_filter is None else _filter_truth(row_filter, t_r)
                r_want = base + want_rows + int(r_keep.sum())
                await until_delivered(r_want, 120, "the rows inserted while "
                                      "the replicator was down")
                await asyncio.sleep(0.3)  # a duplicate would land here
                os.kill(os.getpid(), signal.SIGTERM)
                await asyncio.wait_for(task, 120)
                want_aids = t_r["aid"][r_keep].tolist()
                if http:
                    report2 = await fcall("report")
                    r_lsns = {lsn for lsn, _, _ in r_prod["commits"]}
                    got = sorted(_cdc_keys(report2, r_lsns)[2].tolist())
                    copied_again = _copy_tally(report2)[0] \
                        - _copy_tally(report1)[0]
                else:
                    got = sorted(e.row.values[0] for e in dest2.events
                                 if type(e).__name__ == "InsertEvent")
                    copied_again = len(dest2.table_rows.get(PGBENCH_TID,
                                                            []))
                restart = {
                    "rows": len(got), "copied_again": copied_again,
                    "health": [[s, d] for s, d in health],
                    "ok": bool(got == want_aids and copied_again == 0)}
        c_end = _counters()
        if http:
            report = await fcall("report")
    finally:
        server.close()
        if fake is not None:
            fake.close()
        tmp.cleanup()
        if env_before is None:
            os.environ.pop(env_key, None)
        else:
            os.environ[env_key] = env_before

    # -- checks, off the clock ----------------------------------------------
    commit_times = {lsn: t for (lsn, _, _), t in
                    zip(prod["commits"], prod["times"])}
    first_of = {lsn: lo for lsn, lo, _ in prod["commits"]}
    if http:
        n_copied, copy_digest = _copy_tally(report1)
        lsn, ordinal, aids = _cdc_keys(report1, set(commit_times))
        cdc_digest = _cdc_digest(report1, set(commit_times))
        arrivals = {}
        for tab in report1["tables"].values():
            for u, at in tab["arrivals"].items():
                arrivals[u] = min(at, arrivals.get(u, at))
    else:
        n_copied = len(copied_values)
        copy_digest = _rows_digest(*_rows_of(copied_values))
        values = [e.row.values for e in cdc_events]
        lsn = np.asarray([int(e.commit_lsn) for e in cdc_events],
                         dtype=np.uint64)
        ordinal = np.asarray([e.tx_ordinal for e in cdc_events],
                             dtype=np.uint64)
        aids = np.asarray([v[0] for v in values], dtype=np.int64)
        cdc_digest = _rows_digest(*_rows_of(values))
        arrivals = tap.arrivals
    out["copy_count_ok"] = n_copied == int(copy_keep.sum())
    out["copy_digest_ok"] = copy_digest \
        == table_digest(t_copy, np.flatnonzero(copy_keep))
    window = t_e2e - prod["t0"]
    lags = sorted((at - commit_times[u]) * 1e3
                  for u, at in arrivals.items() if u in commit_times)

    def pct(q):
        return lags[min(len(lags) - 1, int(q * len(lags)))] if lags else None

    src = np.asarray([first_of.get(int(u), -1) for u in lsn.tolist()],
                     dtype=np.int64) + ordinal.astype(np.int64)
    known = (src >= 0) & (src < n_events)
    key = list(zip(lsn.tolist(), ordinal.tolist()))
    once = len(set(key)) == len(key)
    out.update({
        "producer_events_per_second": n_events / (prod["t1"] - prod["t0"]),
        "events_per_second": n_events / window,
        "delivered_rows": len(key), "want_rows": want_rows,
        "keep_share": len(key) / n_events,
        "lag_p50_ms": pct(0.5), "lag_p95_ms": pct(0.95),
        "lag_max_ms": lags[-1] if lags else None,
        "device_rows": int(d["device_rows"]),
        "oracle_rows": int(d["oracle_rows"]),
        "small_oracle_rows": int(d["small_oracle_rows"]),
        "device_batches": int(d["device_batches"]),
        "pack_s": d["pack_s"], "dispatch_s": d["dispatch_s"],
        "fetch_s": d["fetch_s"], "overlap_s": d["overlap_s"],
        "device_s": d["device_s"], "kernel_s": d["kernel_s"],
        "egress_s": d["egress_s"], "d2h_egress_s": d["d2h_egress_s"],
        "device_busy_share": d["device_s"] / window,
        "count_ok": len(key) == want_rows,
        "digest_ok": cdc_digest == table_digest(t_cdc, np.flatnonzero(keep)),
        # the memory destination keeps WAL order; a warehouse orders by
        # `_CHANGE_SEQUENCE_NUMBER`, so there each key once is the check
        "order_ok": bool(once and (http or key == sorted(key))),
        "identity_ok": bool(known.all() and np.array_equal(
            aids, t_cdc["aid"][src[known]]) and keep[src[known]].all()),
        "restart": restart,
    })
    if http:
        await asyncio.to_thread(_warehouse_checks, out, destination, report,
                                watch, t_copy, t_cdc, first_aid, prod, seed)
    else:
        out["oracle_sample_ok"] = await asyncio.to_thread(
            _oracle_sample_ok, [_sample_batch(values, 512, seed)], t_cdc,
            512, seed, first_aid)
        if copied_values:
            out["copy_oracle_sample_ok"] = await asyncio.to_thread(
                _oracle_sample_ok, [_sample_batch(copied_values, 512, seed)],
                t_copy, 512, seed, 1)
    # the launches of the whole run (both lifetimes) against its
    # device-routed batches: K1 for each unfiltered one, K2c (or K2 and
    # the epilogue) for each filtered one; a destination that declares an
    # encoder, the render after each K1
    run = _delta(c_start, c_end)
    out["run"] = {k: int(run[k]) for k in (
        "device_batches", "k1_launches", "k2c_launches", "k2_launches",
        "epilogue_launches", "egress_launches", "device_rows",
        "oracle_rows")}
    out["run"]["device_writes"] = int(run["device_writes"])
    out["run"]["host_writes"] = int(run["host_writes"])
    r = out["run"]
    renders = http and row_filter is None
    if device != "cuda":  # the plain versions count no launch
        out["launches_ok"] = r["device_batches"] > 0 and (
            not renders or r["device_writes"] > 0)
    elif row_filter is None:
        out["launches_ok"] = (
            r["k1_launches"] == r["device_batches"] > 0
            and r["k2c_launches"] == r["k2_launches"] == 0
            and r["egress_launches"] == (r["k1_launches"] if renders
                                         else 0)
            and (not renders or r["device_writes"] > 0))
    else:
        out["launches_ok"] = (
            r["k2c_launches"] + r["k2_launches"] == r["device_batches"] > 0
            and r["k1_launches"] == 0 and r["egress_launches"] == 0
            and r["epilogue_launches"] == r["k2_launches"])
    out["copy_oracle_free"] = out["copy_stages"]["oracle_rows"] == 0
    # the CDC window routes to the oracle only runs below the decoder's
    # size floor (the reference's routing rule), and few of them: a
    # degrade or any other host route fails the run
    out["cdc_oracle_ok"] = (
        out["small_oracle_rows"] == out["oracle_rows"]
        <= WIRE_CDC_ORACLE_SHARE_MAX * n_events)
    out["ok"] = bool(
        out["health_ok"] and out["copy_count_ok"] and out["copy_digest_ok"]
        and out.get("copy_oracle_sample_ok", True) and out["count_ok"]
        and out["digest_ok"] and out["order_ok"] and out["identity_ok"]
        and out["oracle_sample_ok"] and out["metrics_ok"]
        and out["shutdown_ok"] and out["launches_ok"]
        and out["copy_oracle_free"] and out["cdc_oracle_ok"]
        and out.get("warehouse_ok", True)
        and (restart is None or restart["ok"]))
    return out


#: rows whose delivered text a warehouse run holds against the host
#: encoder: this many seeded aids of the copy, as many of the CDC window
WIRE_WATCH_ROWS = 256


def _watch_aids(t_copy: dict, copy_keep, t_cdc: dict, keep, seed: int):
    """Seeded aids of delivered rows: WIRE_WATCH_ROWS of the copied ones
    and as many of the streamed ones."""
    rng = np.random.default_rng(seed + 5)
    out = []
    for t, k in ((t_copy, copy_keep), (t_cdc, keep)):
        aids = t["aid"][k]
        if len(aids):
            out += rng.choice(aids, size=min(WIRE_WATCH_ROWS, len(aids)),
                              replace=False).tolist()
    return sorted(int(a) for a in out)


def _copy_tally(report: dict) -> tuple:
    """(rows, digest) of the copied rows a fake received."""
    n = digest = 0
    for tab in report["tables"].values():
        rows, d = tab["by_lsn"].get(0, (0, 0))
        n += rows
        digest = (digest + d) % (1 << 64)
    return n, digest


def _cdc_keys(report: dict, lsns: set) -> tuple:
    """(commit LSN, ordinal, aid) of the CDC rows of the commits `lsns`
    that a fake received, in arrival order."""
    parts = [(t["lsn"], t["ordinal"], t["aid"])
             for t in report["tables"].values()]
    if not parts:
        z = np.zeros(0, dtype=np.uint64)
        return z, z, np.zeros(0, dtype=np.int64)
    lsn, ordinal, aid = (np.concatenate(p) for p in zip(*parts))
    sel = np.isin(lsn, np.fromiter(lsns, dtype=np.uint64, count=len(lsns)))
    return lsn[sel], ordinal[sel], aid[sel]


def _cdc_digest(report: dict, lsns: set) -> int:
    digest = 0
    for tab in report["tables"].values():
        for u, (_, d) in tab["by_lsn"].items():
            if u in lsns:
                digest = (digest + d) % (1 << 64)
    return digest


def _warehouse_checks(out: dict, destination: str, report: dict,
                      watch: list, t_copy: dict, t_cdc: dict,
                      first_aid: int, prod: dict, seed: int) -> None:
    """A warehouse run's own checks, from its fake's report after every
    lifetime: the watched rows' delivered text against the host encoder
    on the written row, once each, and through the CPU oracle; each
    sequence key once; the DDL once a lifetime; the commit seam's
    records."""
    from .models.table_row import ColumnarBatch, TableRow

    schema = make_schema()
    seq_of = {}
    for lsn, lo, hi in prod["commits"]:
        for i in range(lo, hi):
            seq_of[first_aid + i] = (lsn, i - lo)

    def written(aid: int) -> list:
        t, i = (t_copy, aid - 1) if aid < first_aid \
            else (t_cdc, aid - first_aid)
        return [int(t["aid"][i]), int(t["bid"][i]), int(t["abalance"][i]),
                t["filler"][i].tobytes().decode()]

    def want_item(aid: int, got):
        """What the host encoder sends for the written row of `aid`, with
        the sequence key the destination gives it."""
        batch = ColumnarBatch.from_rows(schema, [TableRow(written(aid))])
        cdc = aid >= first_aid
        lsn, txo = seq_of[aid] if cdc else (0, 0)
        if destination == "clickhouse":
            from .destinations.clickhouse import render_batch_tsv_columnar

            # the copy's third key is the row's place in its batch
            third = got.rstrip(b"\n").rsplit(b"/", 1)[-1].decode() \
                if not cdc else f"{0:016x}"
            seq = f"{lsn:016x}/{txo:016x}/{third}"
            return render_batch_tsv_columnar(schema, batch, "UPSERT", [seq])
        if destination == "snowflake":
            from .destinations.snowflake import encode_batch_ndjson
            from .destinations.snowpipe import ZERO_OFFSET, offset_token

            seq = offset_token(lsn, txo) if cdc else ZERO_OFFSET
            return encode_batch_ndjson(schema, batch, "insert", [seq])[0]
        doc = dict(zip(("aid", "bid", "abalance", "filler"), written(aid)))
        doc["_CHANGE_TYPE"] = "UPSERT"
        third = got["_CHANGE_SEQUENCE_NUMBER"][34:]
        doc["_CHANGE_SEQUENCE_NUMBER"] = f"{lsn:016x}/{txo:016x}/{third}"
        return doc

    delivered = report["watched"]
    bad = [a for a in watch if len(delivered.get(a, [])) != 1
           or delivered[a][0] != want_item(a, delivered[a][0])]
    out["watched_rows"] = len(watch)
    out["watched_bad"] = bad[:8]
    out["watched_ok"] = bool(watch) and not bad
    # the watched rows as decoded values, through the CPU oracle
    rows = [written(a) for a in watch if a not in bad]
    copy_rows = [r for r in rows if r[0] < first_aid]
    cdc_rows = [r for r in rows if r[0] >= first_aid]
    out["oracle_sample_ok"] = bool(cdc_rows) and _oracle_sample_ok(
        [_sample_batch(cdc_rows, len(cdc_rows), seed)], t_cdc,
        len(cdc_rows), seed, first_aid)
    if copy_rows:
        out["copy_oracle_sample_ok"] = _oracle_sample_ok(
            [_sample_batch(copy_rows, len(copy_rows), seed)], t_copy,
            len(copy_rows), seed, 1)
    # every CDC row's sequence key once, over both lifetimes
    lsn, ordinal, _ = _cdc_keys(report, {
        u for t in report["tables"].values() for u in t["by_lsn"] if u})
    keys = np.stack([lsn, ordinal], axis=1) if len(lsn) \
        else np.zeros((0, 2), dtype=np.uint64)
    _, counts = np.unique(keys, axis=0, return_counts=True)
    out["seq_arrivals"] = {str(k): int(v) for k, v in zip(
        *np.unique(counts, return_counts=True))}
    out["seq_once_ok"] = bool(len(lsn)) and bool((counts == 1).all())
    out["dedup_inserts"] = report["dedup_inserts"]
    out["fake_requests"] = report["requests"]
    out["fake_body_bytes"] = report["body_bytes"]
    lifetimes = 2 if out["restart"] is not None else 1
    if destination == "clickhouse":
        st = report["statements"]
        data = [q for q in st if q.startswith("CREATE TABLE")
                and "_etl_commit_log" not in q]
        views = [q for q in st if q.startswith("CREATE OR REPLACE VIEW")]
        dbs = [q for q in st if q.startswith("CREATE DATABASE")]
        out["ddl"] = {"create_database": len(dbs), "create_table": len(data),
                      "create_view": len(views)}
        out["ddl_ok"] = len(dbs) == len(data) == len(views) == lifetimes
        log = report["commit_log"]
        high = max((r[1], r[2]) for r in log) if log else None
        last = prod["commits"][-1][0]
        out["commit_log"] = {"records": len(log), "high": high}
        # the seam recorded every flush, up to the window's last commit
        out["seam_ok"] = bool(log) and all(r[4] == 0 for r in log) \
            and high is not None and high[0] >= last
    elif destination == "bigquery":
        out["pb_mismatches"] = report["pb_mismatches"]
        st = [q for q in report["statements"]
              if q.startswith("POST ") and q.split()[1].endswith("/tables")
              and "_etl_commit_marker" not in q]
        out["ddl"] = {"create_table": len(st)}
        out["ddl_ok"] = len(st) == lifetimes
        marker = json.loads(report["commit_log"][-1]) \
            if report["commit_log"] else {}
        out["commit_log"] = {"records": len(report["commit_log"]),
                             "high": marker.get("high")}
        out["seam_ok"] = bool(marker.get("high")) \
            and marker["high"][0] >= prod["commits"][-1][0] \
            and report["pb_mismatches"] == 0
    else:
        tokens = [t for ts in report["committed_tokens"].values()
                  for t in ts]
        cdc_tokens = [t for t in tokens if not t.startswith("0" * 16)]
        out["commit_log"] = {"records": len(tokens),
                             "cdc_tokens": len(cdc_tokens)}
        out["ddl"] = {}
        out["ddl_ok"] = True
        # each offset token committed once, in order on its channel
        out["seam_ok"] = bool(cdc_tokens) and all(
            ts == sorted(set(ts)) for ts in
            report["committed_tokens"].values())
    out["warehouse_ok"] = bool(out["watched_ok"] and out["ddl_ok"]
                               and out["seam_ok"] and out["seq_once_ok"])


#: where a destination's work on the loop lives: its module, the wire-text
#: assembly it calls, the HTTP client
_DESTINATION_CODE = (os.sep + os.path.join("etl_tpu_torch", "destinations")
                     + os.sep,
                     os.sep + os.path.join("etl_tpu_torch", "ops",
                                           "egress.py"),
                     os.sep + "aiohttp" + os.sep, os.sep + "yarl" + os.sep,
                     os.sep + "multidict" + os.sep)


def destination_share(prof) -> dict:
    """The destination's share of the profiled loop: the own time of the
    functions in `_DESTINATION_CODE` over the own time of all, and its
    five largest."""
    import pstats

    st = pstats.Stats(prof)
    total = dest = 0.0
    top = []
    for (path, line, name), (_, _, tt, _, _) in st.stats.items():
        total += tt
        if any(part in path for part in _DESTINATION_CODE):
            dest += tt
            top.append((tt, f"{os.path.basename(path)}:{line}:{name}"))
    top.sort(reverse=True)
    return {"profiled_s": total, "destination_s": dest,
            "destination_share": dest / total if total else 0.0,
            "top": [[n, t] for t, n in top[:5]]}


def _sqlite_ready(path: str, pipeline_id: int):
    """A predicate: the pgbench table READY in the SQLite store at `path`.
    The fake server's producer writes WAL only, never the table's rows,
    so inserts made before READY would be missing from a copy taken
    after them."""
    import sqlite3

    def ready() -> bool:
        db = sqlite3.connect(f"file:{path}?mode=ro", uri=True)
        try:
            row = db.execute(
                "SELECT state FROM etl_replication_state WHERE "
                "pipeline_id = ? AND table_id = ? AND is_current = 1",
                (pipeline_id, PGBENCH_TID)).fetchone()
        except sqlite3.OperationalError:  # not created yet
            return False
        finally:
            db.close()
        return row is not None and json.loads(row[0])["state"] == "ready"

    return ready


async def _replicator_process(server, config_dir: str, metrics_port: int,
                              out: dict, *, ready, copy_rows: int,
                              n_events: int, seed: int,
                              before_stop=None) -> None:
    """`python -m etl_tpu_torch.replicator --config-dir config_dir` as a
    process against `server` (a `PgServerProcess` holding the seeded
    table): `/health` answers 200, `ready()` holds, the server produces
    `n_events` inserts in 500-row transactions, the slot's confirmed
    flush reaches their last commit, `before_stop()` (a coroutine
    function) runs, then SIGTERM. Records `health`, `health_s`, `ready_s`,
    `confirmed_s`, `exit_code`, `stopped_cleanly` (and `stderr_tail` on a
    non-zero exit) in `out`."""
    import signal

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "PYTHONPATH": root,
           "APP_PG_CONNECTION__PASSWORD": WIRE_PASSWORD}
    t0 = time.perf_counter()
    proc = await asyncio.create_subprocess_exec(
        sys.executable, "-m", "etl_tpu_torch.replicator",
        "--config-dir", config_dir, cwd=root, env=env,
        stdout=asyncio.subprocess.DEVNULL, stderr=asyncio.subprocess.PIPE)
    stderr_task = asyncio.ensure_future(proc.stderr.read())
    try:
        async def healthy():
            if proc.returncode is not None:
                raise RuntimeError(
                    f"the replicator exited {proc.returncode}: "
                    f"{(await stderr_task).decode()[-3000:]}")
            try:
                status, body = await http_get(metrics_port, "/health")
            except OSError:
                return False
            out["health"] = [status, json.loads(body)]
            return status == 200

        await _until(healthy, 600, "the replicator's /health 200", 0.05)
        out["health_s"] = time.perf_counter() - t0
        await _until(ready, 600, "READY in the store", 0.05)
        out["ready_s"] = time.perf_counter() - t0
        server.call("prepare", n_events=n_events, seed=seed + 1,
                    first_aid=copy_rows + 1)
        prod = await asyncio.to_thread(server.call, "produce", tx_size=500)
        last_lsn = prod["commits"][-1][0]

        async def confirmed():
            s = await asyncio.to_thread(server.call, "slot",
                                        name="supabase_etl_apply_1")
            return s is not None and s["confirmed_flush"] >= last_lsn

        await _until(confirmed, 600, "the slot's confirmed flush", 0.05)
        out["confirmed_s"] = time.perf_counter() - t0
        if before_stop is not None:
            await before_stop()
        proc.send_signal(signal.SIGTERM)
        out["exit_code"] = await asyncio.wait_for(proc.wait(), 120)
    finally:
        if proc.returncode is None:
            proc.kill()
            await proc.wait()
    err = (await stderr_task).decode()
    out["stopped_cleanly"] = "pipeline stopped cleanly" in err
    if out["exit_code"] != 0:
        out["stderr_tail"] = err[-3000:]


async def run_replicator_binary(copy_rows: int = 100_000,
                                n_events: int = 10_000, *,
                                device: str = "cuda",
                                seed: int = 7) -> dict:
    """`python -m etl_tpu_torch.replicator --config-dir DIR` as a process,
    with a SqliteStore, against the fake server in a child process
    (`_replicator_process`): its `/health` answers 200 over HTTP, the
    table is READY in the store, the slot's confirmed flush reaches the
    last commit of `n_events` inserts, SIGTERM exits 0; then the DLQ CLI
    as processes on dead letters a PostgresStore appended on the same
    server: `--postgres ... list` and `replay --destination-json` (a
    memory destination) exit 0 and name the same entries."""
    import tempfile

    from .config import PgConnectionConfig
    from .dlq.codec import encode_row_event
    from .models.event import InsertEvent
    from .models.lsn import Lsn
    from .models.table_row import TableRow
    from .store import DeadLetterEntry, PostgresStore
    from .testing.pg_process import PgServerProcess

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "PYTHONPATH": root,
           "APP_PG_CONNECTION__PASSWORD": WIRE_PASSWORD}
    out: dict = {"mode": "replicator_binary", "copy_rows": copy_rows,
                 "events": n_events, "store": "sqlite"}
    with tempfile.TemporaryDirectory() as tmp, \
            PgServerProcess(password=WIRE_PASSWORD) as server:
        config_dir = os.path.join(tmp, "config")
        server.call("table", n_rows=copy_rows, seed=seed)
        server.call("publication", name="pub", row_filter=None,
                    offload=False)
        metrics_port = free_port()
        write_replicator_config(
            config_dir, server_port=server.port, metrics_port=metrics_port,
            device=device, store={"type": "sqlite",
                                  "path": os.path.join(tmp, "state.db")})
        await _replicator_process(
            server, config_dir, metrics_port, out,
            ready=_sqlite_ready(os.path.join(tmp, "state.db"), 1),
            copy_rows=copy_rows, n_events=n_events, seed=seed)

        # the DLQ CLI over the wire
        store = PostgresStore(PgConnectionConfig(
            host="127.0.0.1", port=server.port, name="postgres",
            username="etl", password=WIRE_PASSWORD), 7)
        await store.connect()
        schema = make_schema()
        await store.store_table_schema(schema, 1)
        entries = []
        for i in range(3):
            ev = InsertEvent(Lsn(99 + i), Lsn(100 + i), i, schema,
                             TableRow([i, 1, -i, "x" * FILLER_WIDTH]))
            change, payload = encode_row_event(ev)
            entries.append(DeadLetterEntry(
                entry_id=0, table_id=PGBENCH_TID, commit_lsn=100 + i,
                tx_ordinal=i, change_type=change, payload=payload,
                error_kind="DESTINATION_REJECTED", detail="smoke"))
        ids = await store.append_dead_letters(entries)
        await store.close()
        dest_json = os.path.join(tmp, "dest.json")
        with open(dest_json, "w") as f:
            json.dump({"type": "memory"}, f)
        dsn = (f"host=127.0.0.1 port={server.port} dbname=postgres "
               f"user=etl password={WIRE_PASSWORD}")
        cli = {}
        for name, argv in (("list", ["list"]),
                           ("replay", ["replay", "--destination-json",
                                       dest_json]),
                           ("list_after", ["list"])):
            t = time.perf_counter()
            p = await asyncio.create_subprocess_exec(
                sys.executable, "-m", "etl_tpu_torch.dlq", "--postgres", dsn,
                "--pipeline-id", "7", *argv, cwd=root, env=env,
                stdout=asyncio.subprocess.PIPE,
                stderr=asyncio.subprocess.PIPE)
            so, se = await asyncio.wait_for(p.communicate(), 120)
            cli[name] = {"rc": p.returncode, "s": time.perf_counter() - t,
                         "out": json.loads(so) if p.returncode == 0
                         else so.decode()[-500:],
                         "stderr": se.decode()[-500:]}
        out["dlq_cli"] = cli
        out["dlq_ok"] = bool(
            all(c["rc"] == 0 for c in cli.values())
            and [e["entry_id"] for e in cli["list"]["out"]["entries"]] == ids
            and cli["replay"]["out"]["replayed"] == ids
            and cli["list_after"]["out"]["count"] == 0)
    out["ok"] = bool(out["exit_code"] == 0 and out["stopped_cleanly"]
                     and out["health"] == [200, {"status": "healthy"}]
                     and out["dlq_ok"])
    return out


async def run_example_replicator(copy_rows: int = 10_000,
                                 n_events: int = 10_000, *,
                                 device: str = "cuda",
                                 seed: int = 7) -> dict:
    """`python -m etl_tpu_torch.replicator --config-dir DIR` as a process
    on the port's example config (`examples/config/base.yaml`, read
    through the port's loader: `batch_engine: cuda`), rewritten only
    where it must name this machine: the fake server's address (a
    `PgServerProcess` holding a seeded pgbench_accounts and the config's
    publication), a free `/metrics` port, the lake's warehouse and the
    SQLite store in a temporary directory, and `batch.device` where
    `device` is not the config's, driven by `_replicator_process`.
    Checks: `/health` answers 200, the slot's confirmed flush reaches the last of `n_events` inserts,
    `/metrics` shows device-routed rows (and kernel seconds on the
    card), SIGTERM exits 0, and the lake read afterwards holds exactly
    the written rows (count and `table_digest`)."""
    import tempfile

    import yaml

    from .destinations.lake import LakeConfig, LakeDestination
    from .examples import CONFIG_DIR, load_example_config
    from .testing.pg_process import PgServerProcess

    config, _ = load_example_config(environ={})
    out: dict = {"mode": "example_replicator", "copy_rows": copy_rows,
                 "events": n_events, "device": device,
                 "batch_engine": config.batch.batch_engine.value}
    with open(CONFIG_DIR / "base.yaml") as f:
        doc = yaml.safe_load(f)
    with tempfile.TemporaryDirectory() as tmp, \
            PgServerProcess(password=WIRE_PASSWORD) as server:
        server.call("table", n_rows=copy_rows, seed=seed)
        server.call("publication", name=doc["publication_name"],
                    row_filter=None, offload=False)
        metrics_port = free_port()
        doc["pg_connection"].update(host="127.0.0.1", port=server.port)
        doc["destination"]["warehouse_path"] = os.path.join(tmp, "lake")
        doc["store"]["path"] = os.path.join(tmp, "state.db")
        doc["metrics_port"] = metrics_port
        if device != doc["batch"].get("device", "cuda"):
            doc["batch"]["device"] = device
        out["rewritten"] = ["pg_connection.host", "pg_connection.port",
                            "destination.warehouse_path", "store.path",
                            "metrics_port"] + (
            ["batch.device"] if doc["batch"]["device"] != "cuda" else [])
        config_dir = os.path.join(tmp, "config")
        os.makedirs(config_dir)
        with open(os.path.join(config_dir, "base.yaml"), "w") as f:
            yaml.safe_dump(doc, f)

        async def read_metrics():
            from .benchmarks.control_plane import _metric

            _, body = await http_get(metrics_port, "/metrics")
            text = body.decode()
            out["device_rows"] = _metric(
                text, "etl_decode_routed_device_rows_total")
            out["kernel_s"] = _metric(text,
                                      "etl_decode_kernel_seconds_total")

        await _replicator_process(
            server, config_dir, metrics_port, out,
            ready=_sqlite_ready(doc["store"]["path"], doc["pipeline_id"]),
            copy_rows=copy_rows, n_events=n_events, seed=seed,
            before_stop=read_metrics)
        reader = LakeDestination(LakeConfig(doc["destination"]
                                            ["warehouse_path"]))
        await reader.startup()
        try:
            current = reader.read_current(PGBENCH_TID).sort_by("aid")
        finally:
            await reader.shutdown()
    t_copy = pgbench_table(copy_rows, seed)
    t_cdc = pgbench_table(n_events, seed + 1, first_aid=copy_rows + 1)
    cols = {k: np.concatenate([t_copy[k], t_cdc[k]])
            for k in ("aid", "bid", "abalance", "filler")}
    out["lake_rows"] = current.num_rows
    out["rows_ok"] = bool(current.num_rows == copy_rows + n_events
                          and _arrow_rows_digest(current)
                          == table_digest(cols))
    on_card = device.split(":")[0] == "cuda"
    out["device_work_ok"] = out["device_rows"] > 0 and (
        out["kernel_s"] > 0 if on_card else True)
    out["ok"] = bool(out["batch_engine"] == "cuda"
                     and out["health"] == [200, {"status": "healthy"}]
                     and out["exit_code"] == 0 and out["stopped_cleanly"]
                     and out["rows_ok"] and out["device_work_ok"])
    return out


async def run_example_control_plane(timeout_s: float = 120.0) -> dict:
    """`python -m etl_tpu_torch.examples.control_plane --port P` as a
    process on a free port with a bearer key of its own: `GET
    /openapi.json` with the key answers 200 with the OpenAPI document, a
    `/v1` route answers 200 with the key and 401 without, and SIGTERM
    stops it with exit code 0."""
    import secrets
    import signal
    import tempfile

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    key = secrets.token_urlsafe(24)
    env = {**os.environ, "PYTHONPATH": root, "ETL_API_KEY": key}
    bearer = {"Authorization": f"Bearer {key}"}
    out: dict = {"mode": "example_control_plane"}
    with tempfile.TemporaryDirectory() as tmp:
        port = free_port()
        out["port"] = port
        t0 = time.perf_counter()
        proc = await asyncio.create_subprocess_exec(
            sys.executable, "-m", "etl_tpu_torch.examples.control_plane",
            "--port", str(port), "--work-dir", tmp, cwd=root, env=env,
            stdout=asyncio.subprocess.PIPE, stderr=asyncio.subprocess.PIPE)
        try:
            async def up():
                if proc.returncode is not None:
                    raise RuntimeError(f"the control plane exited "
                                       f"{proc.returncode}")
                try:
                    status, _ = await http_get(port, "/openapi.json",
                                               bearer)
                except OSError:
                    return False
                return status == 200

            await _until(up, timeout_s, "the control plane's /openapi.json",
                         0.05)
            out["up_s"] = time.perf_counter() - t0
            status, body = await http_get(port, "/openapi.json", bearer)
            doc = json.loads(body)
            out["openapi"] = [status, doc.get("openapi"),
                              len(doc.get("paths", {}))]
            out["tenants_with_key"] = (await http_get(
                port, "/v1/tenants", bearer))[0]
            out["tenants_without_key"] = (await http_get(
                port, "/v1/tenants"))[0]
            proc.send_signal(signal.SIGTERM)
            out["exit_code"] = await asyncio.wait_for(proc.wait(), 60)
        finally:
            if proc.returncode is None:
                proc.kill()
                await proc.wait()
        stdout = (await proc.stdout.read()).decode()
        out["lines"] = stdout.splitlines()
    out["ok"] = bool(out["openapi"][0] == 200 and out["openapi"][2] > 0
                     and out["tenants_with_key"] == 200
                     and out["tenants_without_key"] == 401
                     and out["exit_code"] == 0
                     and f"Authorization: Bearer {key}" in out["lines"]
                     and out["lines"][-1] == "control plane stopped")
    return out


def _run_harness_mode(args, ap) -> "dict | None":
    """The harness mode the flags ask for (etl_tpu_torch/benchmarks), its
    BENCH_FLOOR.json gate applied; None for the modes of this module."""
    from .benchmarks import harness, smoke

    device = args.device
    engine = args.engine
    if args.smoke:
        return smoke.run_smoke(device=device)
    if args.mode == "lag":
        return asyncio.run(harness.run_lag_vs_rate(device=device))
    if args.mode == "wide_row":
        return harness.run_wide_row(device=device)
    if args.mesh_check:
        return run_mesh_check(args.mesh_rows, args.mesh_shards,
                              device=device)
    floors = smoke.load_floors()
    if args.coldstart:
        return harness.run_coldstart(
            n_tables=floors.get("coldstart_tables", 3),
            rows_per_tx=floors.get("coldstart_rows_per_tx", 800),
            txs_per_table=floors.get("coldstart_txs_per_table", 2),
            device=device)
    if args.ack_latency is not None:
        return smoke.gate_ack(asyncio.run(harness.run_ack_latency(
            ack_ms=args.ack_latency, engine=engine or "cpu",
            device=device)), floors)
    if args.poison:
        return smoke.gate_poison(asyncio.run(harness.run_poison_streaming(
            rate=floors.get("poison_rate", 0.001), seed=args.seed,
            target_ops=args.poison_ops
            or floors.get("poison_smoke_ops", 12_000),
            device=device)), floors)
    if args.exactly_once:
        return smoke.gate_exactly_once(asyncio.run(harness.run_exactly_once(
            n_events=floors.get("exactly_once_smoke_events", 3_000),
            engine=engine or "cpu", device=device)), floors)
    if args.workload is not None:
        from .workloads import profile_names

        names = profile_names() if args.workload == "all" \
            else [args.workload]
        return smoke.gate_workload(asyncio.run(harness.run_workload_matrix(
            names, seed=args.seed, engine=engine or "cuda",
            device=device)), floors)
    if args.multi_pipeline:
        profiles = args.streams.split(",") if args.streams \
            else floors.get("multi_pipeline_smoke_profiles")
        return smoke.gate_multi(asyncio.run(harness.run_multi_pipeline(
            profiles=profiles, seed=args.seed, engine=engine or "cuda",
            device=device)), floors)
    if args.sharded is not None:
        if args.sharded < 2:
            ap.error("--sharded needs K >= 2 (the single-shard baseline "
                     "runs automatically)")
        target = floors.get("sharded_bench_ops", 12_000)

        async def both():
            sharded = await harness.run_sharded_processes(
                shards=args.sharded, seed=args.seed, target_ops=target,
                engine=engine or "cuda", device=device)
            single = await harness.run_sharded_processes(
                shards=1, seed=args.seed, target_ops=target,
                engine=engine or "cuda", device=device)
            return sharded, single

        sharded, single = asyncio.run(both())
        return smoke.gate_sharded(sharded, floors, single=single)
    return None


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
    mode.add_argument("--egress", action="store_true",
                      help="each destination encoder in isolation, with "
                           "and without device-rendered text")
    mode.add_argument("--wire", action="store_true",
                      help="the replicator over the Postgres wire protocol "
                           "(run_wire_replicator: COPY, CDC, a restart)")
    ap.add_argument("--rows", type=int, default=None,
                    help="--copy, --wire: rows of the table (1,000,000); "
                         f"--egress: rows of the batch ({N_ROWS})")
    ap.add_argument("--events", type=int, default=500_000,
                    help="--streaming, --wire: insert events")
    ap.add_argument("--arrival-rate", type=int, default=None,
                    help="--streaming: paced events/s (default: as fast "
                         "as possible)")
    ap.add_argument("--row-filter", default=None,
                    help="--streaming, --wire: a publication row filter "
                         "applied by the client (offload mode), e.g. "
                         "'bid <= 5'")
    ap.add_argument("--destination", default="memory",
                    choices=("memory", "clickhouse", "bigquery",
                             "snowflake"),
                    help="--wire: the replicator's destination; a "
                         "warehouse one writes over HTTP to its fake in a "
                         "child process (testing.http_process)")
    ap.add_argument("--profile", default=None, metavar="PATH",
                    help="--wire: profile the event loop's thread "
                         "(cProfile), write its top functions to PATH and "
                         "report the destination's share of it")
    # the reference's harness modes (etl_tpu_torch/benchmarks), each held
    # to its floor in BENCH_FLOOR.json
    mode.add_argument("--mode", default=None,
                      choices=("decode", "lag", "wide_row"),
                      help="lag: p50/p95 lag at 25/50/75 %% of the probed "
                           "maximum; wide_row: 100 columns of 10 kinds "
                           "through the decoder (decode: the default "
                           "headline)")
    mode.add_argument("--ack-latency", dest="ack_latency", type=float,
                      default=None, metavar="MS",
                      help="windowed-ack A/B: the same backlog against "
                           "acks MS ms late, at the default write window "
                           "and at window=1 (ack_window_speedup_floor)")
    mode.add_argument("--poison", action="store_true",
                      help="clean vs 0.1 %%-poisoned CDC with isolation "
                           "live (poison_ratio_floor)")
    mode.add_argument("--exactly-once", dest="exactly_once",
                      action="store_true",
                      help="plain vs transactional sink drains and a "
                           "hard-kill restart leg "
                           "(exactly_once_ratio_floor)")
    mode.add_argument("--workload", default=None, metavar="PROFILE",
                      help="a workload profile ('all': every profile) "
                           "through the full pipeline with end-state "
                           "verification (workload_floors)")
    mode.add_argument("--multi-pipeline", dest="multi_pipeline",
                      action="store_true",
                      help="verified streams sharing the admission "
                           "scheduler (multi_pipeline_events_per_sec_floor)")
    mode.add_argument("--sharded", type=int, default=None, metavar="K",
                      help="K shard replicator processes and a K = 1 "
                           "baseline (sharded_events_per_sec_floor, and "
                           "strictly above the baseline)")
    mode.add_argument("--coldstart", action="store_true",
                      help="two replicator lifetimes on one program-cache "
                           "directory at the coldstart_* sizes: the warm "
                           "restart must build nothing, load from disk "
                           "and decode no row on the oracle")
    mode.add_argument("--mesh-check", dest="mesh_check",
                      action="store_true",
                      help="single-device decode against an 8-shard mesh "
                           "over the --device's devices (the one card "
                           "repeated, or the CPU), unfiltered and under "
                           "abalance < 0: byte-identical batches and "
                           "source_rows, one launch a shard (seconds "
                           "recorded, not gated)")
    ap.add_argument("--mesh-rows", dest="mesh_rows", type=int,
                    default=65_536,
                    help="--mesh-check: rows of the batch (65,536)")
    ap.add_argument("--mesh-shards", dest="mesh_shards", type=int,
                    default=8, help="--mesh-check: shards of the mesh (8)")
    mode.add_argument("--smoke", action="store_true",
                      help="every ported gate of BENCH_FLOOR.json at its "
                           "smoke size; the rest listed under not_ported")
    mode.add_argument("--autoscale", action="store_true",
                      help="the seeded surge→drain timeline through the "
                           "scaling policy with the applied K looped back "
                           "(autoscale_reaction_ticks_max, no scale-down "
                           "inside the cooldown, back to the starting K, "
                           "the same trace twice); pure arithmetic, it "
                           "needs no device")
    mode.add_argument("--fleet", action="store_true",
                      help="fleet converge gate: a 100-pipeline seeded "
                           "FleetSpec reconciles onto an empty simulated "
                           "fleet and through one add/remove/resize "
                           "edit; gates working ticks <= "
                           "fleet_converge_ticks_max, zero "
                           "double-actuations (journal-verified), "
                           "observed == quota-clamped placement, and a "
                           "deterministic actuation trace; pure "
                           "arithmetic, it needs no device")
    ap.add_argument("--streams", default=None, metavar="P1,P2,...",
                    help="--multi-pipeline: the workload profiles "
                         "(default: multi_pipeline_smoke_profiles)")
    ap.add_argument("--poison-ops", dest="poison_ops", type=int,
                    default=None, metavar="N",
                    help="--poison: row ops a pass (default: "
                         "poison_smoke_ops)")
    ap.add_argument("--seed", type=int, default=7,
                    help="the workload seed of the harness modes")
    ap.add_argument("--engine", default=None, choices=("cuda", "cpu"),
                    help="--ack-latency, --exactly-once: cpu (their "
                         "default, the per-tuple path, as in the "
                         "reference) or cuda; --workload, "
                         "--multi-pipeline, --sharded: cuda (default) or "
                         "cpu")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="the torch device of the CUDA engine's decoders "
                         "for the harness modes: cuda (the default; no "
                         "card fails the run) or cpu (the kernels' plain "
                         "versions)")
    args = ap.parse_args(argv)
    if args.autoscale:
        # the policy's arithmetic over a synthetic timeline: no pipeline
        # and no device, as in the reference
        from .benchmarks import harness, smoke

        out = harness.run_autoscale_bench(
            seed=args.seed, reaction_ticks_max=smoke.load_floors().get(
                "autoscale_reaction_ticks_max", 3))
        print(json.dumps(out))
        return 0 if out["ok"] else 1
    if args.fleet:
        # host-side reconciliation arithmetic over a simulated fleet: no
        # pipeline and no device, as in the reference
        from .benchmarks import harness, smoke

        floors = smoke.load_floors()
        out = harness.run_fleet_bench(
            seed=args.seed,
            fleet_size=floors.get("fleet_bench_pipelines", 100),
            converge_ticks_max=floors.get("fleet_converge_ticks_max", 3))
        out.pop("actuation_trace")  # its digest stands for it
        print(json.dumps(out))
        return 0 if out["ok"] else 1
    if args.device == "cuda" and not torch.cuda.is_available():
        print("etl_tpu_torch.bench: no CUDA device; nothing measured",
              file=sys.stderr)
        return 1
    harness_out = _run_harness_mode(args, ap)
    if harness_out is not None:
        if args.device == "cuda":
            harness_out["device_name"] = torch.cuda.get_device_name(0)
            harness_out["power_limit"] = card_info().split(",")[-1].strip()
        print(json.dumps(harness_out))
        return 0 if harness_out["ok"] else 1
    if args.device == "cpu":
        ap.error("--device cpu applies to the harness modes only")
    if args.egress:
        res = run_egress(args.rows or N_ROWS)
        res["device_name"] = torch.cuda.get_device_name(0)
        res["power_limit"] = card_info().split(",")[-1].strip()
        print(json.dumps(res))
        return 0 if res["ok"] else 1
    if args.wire:
        import cProfile
        import pstats

        prof = cProfile.Profile() if args.profile else None
        if prof is not None:
            prof.enable()
        res = asyncio.run(run_wire_replicator(
            1_000_000 if args.rows is None else args.rows, args.events,
            row_filter=args.row_filter, destination=args.destination))
        if prof is not None:
            prof.disable()
            res["profile"] = destination_share(prof)
            with open(args.profile, "w") as f:
                st = pstats.Stats(prof, stream=f)
                st.sort_stats("tottime").print_stats(45)
                st.sort_stats("cumulative").print_stats(45)
        res.pop("health", None)
        res["device_name"] = torch.cuda.get_device_name(0)
        res["power_limit"] = card_info().split(",")[-1].strip()
        print(json.dumps(res))
        return 0 if res["ok"] else 1
    if args.copy or args.streaming:
        res = asyncio.run(
            run_table_copy(args.rows or 1_000_000) if args.copy else
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
