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
"""

from __future__ import annotations

import hashlib
import json
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


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(prog="python -m etl_tpu_torch.bench")
    ap.add_argument("--selectivity", action="store_true",
                    help="the fused row filter across selectivities")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("etl_tpu_torch.bench: no CUDA device; nothing measured",
              file=sys.stderr)
        return 1
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
