"""Benchmark harness: the reference's `etl_tpu/benchmarks/harness.py`
modes on the port's pipeline.

Modes (the reference's names and gates; `python -m etl_tpu_torch.bench`
applies the floors of BENCH_FLOOR.json):
  lag_vs_rate         p50/p95 lag at fixed offered loads (`bench.
                      run_table_streaming`, paced)
  workload_streaming  one workload profile through the full pipeline with
                      end-state verification; `run_workload_matrix` over
                      many (gate `workload_floors`)
  multi_pipeline      N verified streams sharing the process's
                      `AdmissionScheduler` (gate
                      `multi_pipeline_events_per_sec_floor`)
  sharded_processes   K shard replicators as K OS processes
                      (`shard_worker`; gate `sharded_events_per_sec_floor`)
  wide_row            100 columns of 10 kinds through `DeviceDecoder`
  ack_latency         windowed vs window=1 drains against late acks (gate
                      `ack_window_speedup_floor`)
  poison_streaming    clean vs poisoned CDC (gate `poison_ratio_floor`)
  exactly_once        plain vs transactional sink drains and a hard-kill
                      restart leg (gate `exactly_once_ratio_floor`)
  autoscale           the seeded surge→drain timeline through the scaling
                      policy, the applied K looped back (gate
                      `autoscale_reaction_ticks_max`; pure arithmetic, no
                      pipeline and no device)
  fleet               a seeded fleet reconciled onto an empty simulated
                      fleet and through one versioned edit (gate
                      `fleet_converge_ticks_max`; pure arithmetic)
  coldstart           two replicator lifetimes (`coldstart_worker`
                      subprocesses) on one program-cache directory:
                      the cold start builds, the warm restart builds
                      nothing (the `coldstart_*` sizes)

Engines: the reference's "tpu" engine is the port's `BatchEngine.CUDA`,
its decoders on `device` ("cuda", the card, unless the caller asks for
"cpu", where the kernels' plain versions run); its "cpu" engine is the
port's per-tuple `BatchEngine.CPU`. As in the reference, the ack-latency
and exactly-once drains default to the per-tuple engine, so that they
measure the ack window and the commit seam alone; both take
`engine="cuda"` as well. Every mode reports the engine it ran and the
kernel launches and device-routed batches over its run
(`kernel_counts`): on the card each device-routed batch is one launch of
K1, of K2c, or of K2 (with the epilogue).

The port builds its libraries synchronously at `Pipeline.start`
(ops/program_store.py), so the reference's background-compile waits and
`_compile_metrics` have no counterpart here.
"""

from __future__ import annotations

import asyncio
import statistics
import time

from ..config import BatchEngine


def _median(xs):
    return statistics.median(xs)


def _pipeline_metrics() -> dict:
    """Snapshot of the decode-pipeline stage metrics (ops/pipeline.py):
    per-stage totals + the overlap counters. Benches report the DELTA over
    their measured window (snapshot before and after, subtract)."""
    from ..telemetry.metrics import (
        ETL_DECODE_DISPATCH_SECONDS, ETL_DECODE_FETCH_SECONDS,
        ETL_DECODE_PACK_SECONDS, ETL_DECODE_PIPELINE_OVERLAP_SECONDS_TOTAL,
        ETL_DECODE_PIPELINE_PACK_SECONDS_TOTAL, registry)

    out = {}
    for key, name in (("pack", ETL_DECODE_PACK_SECONDS),
                      ("dispatch", ETL_DECODE_DISPATCH_SECONDS),
                      ("fetch", ETL_DECODE_FETCH_SECONDS)):
        count, total = registry.get_histogram(name)
        out[f"{key}_batches"] = count
        out[f"{key}_seconds"] = total
    out["overlap_seconds"] = registry.get_counter(
        ETL_DECODE_PIPELINE_OVERLAP_SECONDS_TOTAL)
    out["pipeline_pack_seconds"] = registry.get_counter(
        ETL_DECODE_PIPELINE_PACK_SECONDS_TOTAL)
    return out


def _admission_metrics() -> dict:
    """Snapshot of the fair batch-admission scheduler and mesh-sharded
    decode counters (ops/pipeline.AdmissionScheduler, the engine's mesh
    path). Per-tenant labels roll up via sum_* — benches report the
    delta over their measured window. The mesh counters stay at zero
    where no decoder has a mesh (`mesh="auto"` on one card)."""
    from ..telemetry.metrics import (
        ETL_DECODE_ADMISSION_BYPASS_GRANTS_TOTAL,
        ETL_DECODE_ADMISSION_GRANTS_TOTAL,
        ETL_DECODE_ADMISSION_STARVATION_GRANTS_TOTAL,
        ETL_DECODE_ADMISSION_WAIT_SECONDS, ETL_DECODE_MESH_BATCHES_TOTAL,
        ETL_DECODE_MESH_PADDED_ROWS_TOTAL, ETL_DECODE_MESH_ROWS_TOTAL,
        registry)

    waits, wait_seconds = registry.sum_histogram(
        ETL_DECODE_ADMISSION_WAIT_SECONDS)
    return {
        "admission_grants": registry.sum_counter(
            ETL_DECODE_ADMISSION_GRANTS_TOTAL),
        "admission_starvation_grants": registry.sum_counter(
            ETL_DECODE_ADMISSION_STARVATION_GRANTS_TOTAL),
        "admission_bypass_grants": registry.sum_counter(
            ETL_DECODE_ADMISSION_BYPASS_GRANTS_TOTAL),
        "admission_waits": waits,
        "admission_wait_seconds": wait_seconds,
        "mesh_batches": registry.get_counter(ETL_DECODE_MESH_BATCHES_TOTAL),
        "mesh_rows": registry.get_counter(ETL_DECODE_MESH_ROWS_TOTAL),
        "mesh_padded_rows": registry.get_counter(
            ETL_DECODE_MESH_PADDED_ROWS_TOTAL),
    }


def _filter_metrics() -> dict:
    """Snapshot of the fused publication-row-filter counters: rows
    compacted out of decode output and the bytes the packed-result fetch
    moved (delta over a window)."""
    from ..telemetry.metrics import (ETL_DECODE_FETCHED_BYTES_TOTAL,
                                     ETL_DECODE_ROWS_FILTERED_TOTAL,
                                     registry)

    return {
        "decode_rows_filtered": registry.get_counter(
            ETL_DECODE_ROWS_FILTERED_TOTAL),
        "decode_fetched_bytes": registry.get_counter(
            ETL_DECODE_FETCHED_BYTES_TOTAL),
    }


def kernel_counts() -> dict:
    """Snapshot of this process's kernel launches (the wrappers' counts,
    incremented only where a kernel launches on the card) and of the
    batches the decoders routed to the device route (on the CPU the
    kernels' plain versions decode those, and nothing launches)."""
    from ..ops import decode_kernel, engine

    return {"k1_launches": decode_kernel.launches,
            "k2c_launches": decode_kernel.fused_launches,
            "k2_launches": decode_kernel.filter_launches,
            "epilogue_launches": decode_kernel.compact_launches,
            "device_batches": engine.routed_device_batches}


def counts_delta(before: dict) -> dict:
    """`kernel_counts` since `before`, and `launches`: the batches that
    launched a kernel (K1, K2c, or K2 with the epilogue)."""
    now = kernel_counts()
    d = {k: now[k] - before[k] for k in now}
    d["launches"] = d["k1_launches"] + d["k2c_launches"] + d["k2_launches"]
    return d


def launches_ok_for(counts: dict, device: str, engine: str) -> bool:
    """On the card every device-routed batch launched one kernel; off it
    (the per-tuple engine, or the plain versions on the CPU) none did."""
    if engine != "cuda" or device.split(":")[0] != "cuda":
        return counts["launches"] == 0
    return counts["launches"] == counts["device_batches"]


def _engine(engine: str) -> BatchEngine:
    if engine not in ("cuda", "cpu"):
        raise ValueError(f"engine must be 'cuda' or 'cpu', got {engine!r} "
                         "(the reference's 'tpu' is the port's 'cuda')")
    return BatchEngine(engine)


# ---------------------------------------------------------------------------
# lag vs offered load
# ---------------------------------------------------------------------------


async def run_lag_vs_rate(fractions: tuple = (0.25, 0.5, 0.75),
                          probe_events: int = 60_000,
                          max_fill_ms: int = 5,
                          per_rate_cap: int = 240_000,
                          device: str = "cuda",
                          warmup_events: int = 17_000) -> dict:
    """p50/p95 end-to-end replication lag at fixed offered loads.

    The drain-style streaming bench saturates the pipeline, so its lag
    percentiles measure queue depth, not latency. This mode first probes
    the sustainable maximum, then replays at the given fractions of it
    with paced production and reports real lag per rate. The fill window
    is 5 ms — a lag-oriented batching config, reported in the output.
    Each run is the port's `bench.run_table_streaming` (pgbench_accounts
    into the counting destination, CUDA engine on `device`), whose own
    checks (count, digest, order, identity, oracle sample) must hold."""
    from .. import bench

    probe = await bench.run_table_streaming(
        probe_events, max_fill_ms=max_fill_ms, device=device,
        warmup_events=warmup_events)
    max_rate = probe["end_to_end_events_per_second"]
    rows = []
    all_ok = probe["ok"]
    for f in fractions:
        rate = max(1000, int(max_rate * f))
        # ~3 s of paced traffic per rate, bounded for bench wall-clock
        n = min(max(int(rate * 3), 3000), per_rate_cap)
        out = await bench.run_table_streaming(
            n, max_fill_ms=max_fill_ms, arrival_rate=rate, device=device,
            warmup_events=warmup_events)
        all_ok = all_ok and out["ok"]
        rows.append({
            "fraction": f,
            # the 1000 ev/s floor can raise the rate above f*max on slow
            # hosts — report the load actually offered, not the request
            "effective_fraction": rate / max_rate if max_rate else None,
            "target_rate": rate, "events": n,
            "events_per_second": out["end_to_end_events_per_second"],
            "p50_ms": out["lag_p50_ms"],
            "p95_ms": out["lag_p95_ms"],
            "max_ms": out["lag_max_ms"],
            "k1_launches": out["k1_launches"],
            "ok": out["ok"],
        })
    return {
        "mode": "lag_vs_rate", "engine": "cuda", "device": device,
        "max_events_per_second": max_rate,
        "max_fill_ms": max_fill_ms,
        "probe_k1_launches": probe["k1_launches"],
        "rates": rows,
        "ok": bool(all_ok),
    }


# ---------------------------------------------------------------------------
# the workload matrix
# ---------------------------------------------------------------------------


async def run_workload_streaming(profile: str = "update_heavy_default",
                                 seed: int = 7, steps: int | None = None,
                                 engine: str = "cuda",
                                 target_ops: int = 3_000,
                                 verify_timeout_s: float = 240.0,
                                 device: str = "cuda") -> dict:
    """CDC throughput for ONE workload profile (workloads/) through the
    full pipeline, with end-state verification: the destination's
    reconstructed final view must equal the generator's committed source
    truth (the same collapse rules the chaos invariant checker applies).

    The memory destination is deliberate: non-insert profiles need the
    delivered events retained for verification, and every profile pays
    the same row-expansion cost, so per-profile numbers stay comparable.
    `steps` defaults to whatever reaches ~`target_ops` row ops for the
    profile's transaction shape. The `filter_selective_*` profiles run in
    offload mode (the walsender ships every row): their device batches
    take the fused filter kernel K2c."""
    from ..chaos.runner import TracingDestination
    from ..config import BatchConfig, PipelineConfig
    from ..models.table_state import TableStateType
    from ..postgres.fake import FakeSource
    from ..runtime import Pipeline
    from ..store import NotifyingStore
    from ..workloads import WorkloadGenerator, get_profile

    p = get_profile(profile)
    gen = WorkloadGenerator(p, seed=seed)
    db = gen.build_db()
    store = NotifyingStore()
    dest = TracingDestination()
    counts0 = kernel_counts()
    filt0 = _filter_metrics()
    pipeline = Pipeline(
        config=PipelineConfig(
            pipeline_id=1, publication_name="pub",
            batch=BatchConfig(max_fill_ms=30, batch_engine=_engine(engine),
                              device=device)),
        store=store, destination=dest,
        source_factory=lambda: FakeSource(db))

    async def wait_delivered():
        # `delivered()` reconstructs the destination's full final view —
        # O(events × columns) of synchronous work ON the event loop — so
        # run it only when the event stream has QUIESCED (no new events
        # across a poll interval)
        seen = -1
        while True:
            n = len(dest.events)
            if n == seen and gen.delivered(dest):
                return
            seen = n
            if pipeline._apply_task is not None \
                    and pipeline._apply_task.done():
                pipeline._apply_task.result()
                raise RuntimeError("pipeline stopped before delivering")
            await asyncio.sleep(0.1)

    try:
        # start + READY wait inside the try: a copy-path regression that
        # keeps a table from READY must still shut the pipeline down
        await pipeline.start()
        for tid in gen.table_ids:
            await asyncio.wait_for(
                store.notify_on(tid, TableStateType.READY), 120)
        # warmup OFF the clock (descriptors, pinned buffers, the first
        # launches), with the full budget regardless of verify_timeout_s
        warm_target = max(100, target_ops // 5)
        while gen.row_ops < warm_target:
            await gen.run_tx(db)
        await asyncio.wait_for(wait_delivered(), timeout=240)

        ops0 = gen.row_ops
        stages0 = _pipeline_metrics()
        t0 = time.perf_counter()
        steps_run = 0
        while (steps_run < steps if steps is not None
               else gen.row_ops - ops0 < target_ops):
            await gen.run_tx(db)
            steps_run += 1
        t_prod = time.perf_counter()
        try:
            await asyncio.wait_for(wait_delivered(),
                                   timeout=verify_timeout_s)
            verified = True
        except asyncio.TimeoutError:
            # the stream quiesced with a view that never matched the
            # committed truth, or stalled: a delivery failure the caller
            # gates on
            verified = False
        t_done = time.perf_counter()
        stages1 = _pipeline_metrics()
    finally:
        if pipeline._apply_task is not None:
            await pipeline.shutdown_and_wait()
    measured = gen.row_ops - ops0
    counts = counts_delta(counts0)
    filt1 = _filter_metrics()
    stages = {k: stages1[k] - stages0[k] for k in stages1}
    return {
        "profile": profile,
        "seed": seed,
        "engine": engine, "device": device,
        "row_filter": p.row_filter,
        "steps": steps_run,
        "row_ops": measured,
        "warmup_ops": ops0,
        "producer_events_per_second":
            round(measured / max(t_prod - t0, 1e-9)),
        "events_per_second": round(measured / max(t_done - t0, 1e-9)),
        "verified": bool(verified),
        "expected_rows": sum(len(v) for v in gen.expected.values()),
        "decode_rows_filtered": int(filt1["decode_rows_filtered"]
                                    - filt0["decode_rows_filtered"]),
        # the decode pipeline's stages over the measured window
        "decode_pack_seconds": stages["pack_seconds"],
        "decode_fetch_seconds": stages["fetch_seconds"],
        "decode_overlap_seconds": stages["overlap_seconds"],
        **counts,
        "launches_ok": launches_ok_for(counts, device, engine),
    }


async def run_workload_matrix(profiles=None, seed: int = 7,
                              engine: str = "cuda",
                              target_ops: int = 3_000,
                              device: str = "cuda") -> dict:
    """`run_workload_streaming` across the whole profile catalog (or a
    selected subset): the per-workload throughput matrix gated by
    `workload_floors` in BENCH_FLOOR.json."""
    from ..workloads import profile_names

    names = list(profiles) if profiles else profile_names()
    rows = {}
    ok = True
    for name in names:
        out = await run_workload_streaming(name, seed=seed, engine=engine,
                                           target_ops=target_ops,
                                           device=device)
        rows[name] = out
        ok = ok and out["verified"]
    return {
        "mode": "workload_matrix", "engine": engine, "device": device,
        "seed": seed,
        "profiles": rows,
        "events_per_second": {n: r["events_per_second"]
                              for n, r in rows.items()},
        "all_verified": bool(ok),
        "launches_ok": all(r["launches_ok"] for r in rows.values()),
    }


# ---------------------------------------------------------------------------
# multi-pipeline tenancy
# ---------------------------------------------------------------------------


async def run_multi_pipeline(profiles=None, seed: int = 7,
                             engine: str = "cuda",
                             target_ops: int = 1_000,
                             admission_capacity: int = 0,
                             verify_timeout_s: float = 240.0,
                             device: str = "cuda") -> dict:
    """N concurrent replication streams — one full Pipeline per workload
    profile (the tenancy mix) — sharing the process's one card through
    the fair batch-admission scheduler (`ops.pipeline.global_admission`).
    Every stream runs the whole path (fake walsender → apply loop →
    pipelined decode → memory destination) with end-state verification.

    Reports per-stream and AGGREGATE events/s over one shared measured
    window, the scheduler's per-tenant stats captured while the tenants
    were still registered, the admission counter deltas, and whether the
    scheduler drained clean (no tickets or tenants left after
    shutdown)."""
    from ..chaos.runner import TracingDestination
    from ..config import BatchConfig, PipelineConfig
    from ..models.table_state import TableStateType
    from ..ops.pipeline import global_admission, reset_global_admission
    from ..postgres.fake import FakeSource
    from ..runtime import Pipeline
    from ..store import NotifyingStore
    from ..workloads import WorkloadGenerator, get_profile

    # the default mix pairs a small-flush tenant with a
    # 512-row-transaction tenant, whose flushes cross the decoder's
    # device floor, so the run provably takes admission tickets
    names = list(profiles) if profiles \
        else ["insert_heavy", "giant_tx"]
    # fresh process-wide scheduler: THIS run's capacity knob wins
    reset_global_admission()
    counts0 = kernel_counts()

    streams = []
    for i, name in enumerate(names):
        label = name if names.count(name) == 1 else f"{name}-{i}"
        gen = WorkloadGenerator(get_profile(name), seed=seed + i)
        db = gen.build_db()
        pipeline = Pipeline(
            config=PipelineConfig(
                pipeline_id=i + 1, publication_name="pub",
                batch=BatchConfig(max_fill_ms=30,
                                  batch_engine=_engine(engine),
                                  device=device,
                                  admission_capacity=admission_capacity)),
            store=(store := NotifyingStore()),
            destination=(dest := TracingDestination()),
            source_factory=lambda db=db: FakeSource(db))
        streams.append({"label": label, "gen": gen, "db": db,
                        "store": store, "dest": dest, "pipeline": pipeline})

    async def wait_verified(s) -> None:
        seen = -1
        while True:
            n = len(s["dest"].events)
            if n == seen and s["gen"].delivered(s["dest"]):
                return
            seen = n
            task = s["pipeline"]._apply_task
            if task is not None and task.done():
                task.result()
                raise RuntimeError(
                    f"stream {s['label']} stopped before delivering")
            await asyncio.sleep(0.1)

    started = []
    verified: dict[str, bool] = {}
    try:
        for s in streams:
            await s["pipeline"].start()
            started.append(s)
        await asyncio.gather(*(
            asyncio.wait_for(
                s["store"].notify_on(tid, TableStateType.READY), 120)
            for s in streams for tid in s["gen"].table_ids))

        # warmup off the clock, CONCURRENTLY: the warmup traffic itself
        # runs through the shared scheduler
        async def warm(s) -> None:
            warm_target = max(60, target_ops // 5)
            while s["gen"].row_ops < warm_target:
                await s["gen"].run_tx(s["db"])
            await asyncio.wait_for(wait_verified(s), 240)

        await asyncio.gather(*(warm(s) for s in streams))

        adm0 = _admission_metrics()
        ops0 = {s["label"]: s["gen"].row_ops for s in streams}
        t0 = time.perf_counter()

        async def produce(s) -> None:
            base = s["gen"].row_ops
            while s["gen"].row_ops - base < target_ops:
                await s["gen"].run_tx(s["db"])

        await asyncio.gather(*(produce(s) for s in streams))
        t_prod = time.perf_counter()

        async def settle(s) -> None:
            try:
                await asyncio.wait_for(wait_verified(s), verify_timeout_s)
                verified[s["label"]] = True
            except asyncio.TimeoutError:
                verified[s["label"]] = False

        await asyncio.gather(*(settle(s) for s in streams))
        t_done = time.perf_counter()
        # tenant stats BEFORE shutdown deregisters them
        sched = global_admission(admission_capacity or None)
        sched_stats = sched.stats()
        adm1 = _admission_metrics()
    finally:
        for s in started:
            if s["pipeline"]._apply_task is not None:
                await s["pipeline"].shutdown_and_wait()

    adm = {k: adm1[k] - adm0[k] for k in adm1}
    per_stream = {}
    total_ops = 0
    for s in streams:
        measured = s["gen"].row_ops - ops0[s["label"]]
        total_ops += measured
        per_stream[s["label"]] = {
            "profile": s["gen"].profile.name,
            "row_ops": measured,
            "events_per_second": round(measured / max(t_done - t0, 1e-9)),
            "verified": bool(verified.get(s["label"], False)),
        }
    drained = sched.stats()
    counts = counts_delta(counts0)
    return {
        "mode": "multi_pipeline", "engine": engine, "device": device,
        "seed": seed,
        "streams": len(streams),
        "per_stream": per_stream,
        "aggregate_row_ops": total_ops,
        "aggregate_events_per_second":
            round(total_ops / max(t_done - t0, 1e-9)),
        "producer_events_per_second":
            round(total_ops / max(t_prod - t0, 1e-9)),
        "all_verified": all(per_stream[k]["verified"] for k in per_stream),
        "admission_capacity": sched_stats["capacity"],
        "admission_tenants": sched_stats["tenants"],
        "admission_grants": int(adm["admission_grants"]),
        "admission_starvation_grants":
            int(adm["admission_starvation_grants"]),
        "admission_bypass_grants": int(adm["admission_bypass_grants"]),
        "admission_wait_seconds": round(adm["admission_wait_seconds"], 4),
        # mesh activity over the window: zero off the mesh; padded rows
        # against mesh rows is the padding the batch sizes cost
        "mesh_batches": int(adm["mesh_batches"]),
        "mesh_rows": int(adm["mesh_rows"]),
        "mesh_padded_rows": int(adm["mesh_padded_rows"]),
        "scheduler_drained": drained["in_flight"] == 0
                             and not drained["tenants"],
        **counts,
        "launches_ok": launches_ok_for(counts, device, engine),
    }


# ---------------------------------------------------------------------------
# K shard replicators as K processes
# ---------------------------------------------------------------------------


async def run_sharded_processes(shards: int = 2,
                                profile: str = "insert_heavy",
                                seed: int = 7, tables: int = 8,
                                target_ops: int = 2_000,
                                engine: str = "cuda",
                                timeout_s: float = 600.0,
                                device: str = "cuda",
                                device_floor: "int | None" = None) -> dict:
    """K shard replicators as K OS PROCESSES (`benchmarks/shard_worker.py`)
    — separate interpreters, GILs and CUDA contexts on the one card, the
    pod resource model — each replaying the identical publication WAL
    (the workload generator's byte-identical `(profile, seed)` contract)
    and applying only its ShardMap slice. The parent checks that the
    slices cover every table exactly once, that every worker's slice
    verifies, and, per worker, that its kernel launches equal its
    device-routed batches; it reports the aggregate events/s (sum of the
    per-worker rates over their concurrent measured windows).

    `shards=1` spawns ONE unsharded worker over the same workload: the
    single-apply-loop baseline. On the card the kernel library is built
    here, once and before any worker starts (each worker then loads it
    from the build directory), and the workers are fresh interpreters,
    never forked from a process with CUDA initialised. `device_floor`
    pins each worker's decode threshold (`chaos.runner.device_floor`;
    None: the decoder's own)."""
    import json as _json
    import sys as _sys

    from ..sharding import ShardMap
    from ..workloads import get_profile

    get_profile(profile)  # fail fast on a typo'd profile name
    if engine == "cuda" and device.split(":")[0] == "cuda":
        from ..ops import decode_kernel

        # before the workers and before any clock: an nvcc build inside
        # a worker's window would be measured as replication
        await asyncio.to_thread(decode_kernel.load)
    specs = []
    if shards <= 1:
        specs.append({"shard": None, "shard_count": 1})
    else:
        part = ShardMap(shards).partition(range(16384, 16384 + tables))
        if any(not owned for owned in part.values()):
            raise ValueError(
                f"degenerate shard map over {tables} tables: "
                f"{ {s: len(v) for s, v in part.items()} }")
        specs = [{"shard": s, "shard_count": shards}
                 for s in range(shards)]

    async def spawn(spec: dict):
        spec = dict(spec, profile=profile, seed=seed, tables=tables,
                    target_ops=target_ops, engine=engine,
                    device_floor=device_floor)
        proc = await asyncio.create_subprocess_exec(
            _sys.executable, "-m", "etl_tpu_torch.benchmarks.shard_worker",
            "--device", device, _json.dumps(spec),
            stdout=asyncio.subprocess.PIPE,
            stderr=asyncio.subprocess.PIPE)
        try:
            out, err = await asyncio.wait_for(proc.communicate(),
                                              timeout_s)
        except asyncio.TimeoutError:
            proc.kill()
            await proc.wait()
            raise TimeoutError(
                f"shard worker {spec.get('shard')} did not finish in "
                f"{timeout_s:.0f}s")
        lines = out.decode().strip().splitlines()
        if proc.returncode != 0 or not lines:
            raise RuntimeError(
                f"shard worker {spec.get('shard')} failed "
                f"(rc={proc.returncode}): {err.decode()[-400:]}")
        return _json.loads(lines[-1])

    results = await asyncio.gather(*(spawn(s) for s in specs))

    owned_union: list = []
    for r in results:
        owned_union.extend(r["owned_table_ids"])
    expected_ids = list(range(16384, 16384 + tables))
    union_ok = sorted(owned_union) == expected_ids if shards > 1 \
        else results[0]["owned_table_ids"] == expected_ids
    return {
        "mode": "sharded", "engine": engine, "device": device,
        "device_floor": device_floor, "seed": seed,
        "profile": profile, "shards": max(1, shards), "tables": tables,
        "per_shard": {str(r["shard"]): r for r in results},
        "tables_per_shard": {str(r["shard"]): r["tables"]
                             for r in results},
        "aggregate_row_events": sum(r["delivered_row_events"]
                                    for r in results),
        "aggregate_events_per_second": sum(r["events_per_second"]
                                           for r in results),
        "all_verified": all(r["verified"] for r in results),
        "union_covers_all_tables": bool(union_ok),
        "launches_ok": all(r["launches_ok"] for r in results),
    }


# ---------------------------------------------------------------------------
# coldstart: restart-to-first-durable-batch, cold vs warm program cache
# ---------------------------------------------------------------------------


def run_coldstart(n_tables: int = 3, rows_per_tx: int = 800,
                  txs_per_table: int = 2, device: str = "cuda",
                  cache_dir: "str | None" = None) -> dict:
    """Two replicator lifetimes (subprocesses: the loaded libraries are
    process state, so cold and warm MUST be separate processes) against
    one program-cache directory, decoding on `device`: the cold start
    builds, the warm restart loads. Gates:

      - the warm restart builds NOTHING, loads at least one library from
        disk and decodes no row on the oracle;
      - the cold start builds no more times than there are prewarm
        buckets, and the permuted-column tables take one canonical
        layout on each route;
      - each run delivers the rows it wrote, and on the card launched K1
        once per device-routed batch.

    Wall-clock numbers (start / first-durable / total) and the kernels'
    nvcc seconds are recorded, not gated."""
    import json as _json
    import os
    import shutil
    import subprocess
    import sys
    import tempfile

    owned = cache_dir is None
    if owned:
        cache_dir = tempfile.mkdtemp(prefix="etl-coldstart-cache-")
    repo = os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))

    def one_run() -> dict:
        proc = subprocess.run(
            [sys.executable, "-m", "etl_tpu_torch.benchmarks.coldstart_worker",
             "--cache-dir", cache_dir, "--tables", str(n_tables),
             "--rows-per-tx", str(rows_per_tx),
             "--txs-per-table", str(txs_per_table), "--device", device],
            capture_output=True, text=True, timeout=900, cwd=repo)
        if proc.returncode != 0:
            raise RuntimeError(
                f"coldstart worker failed: {proc.stderr[-3000:]}")
        return _json.loads(proc.stdout.strip().splitlines()[-1])

    try:
        cold = one_run()
        warm = one_run()
    finally:
        if owned:
            shutil.rmtree(cache_dir, ignore_errors=True)
    buckets = cold["prewarm_buckets"]
    on_card = device.split(":")[0] == "cuda"
    failures = []
    if warm["programs_compiled"] != 0:
        failures.append(f"warm restart built {warm['programs_compiled']:g} "
                        "libraries (want 0)")
    if warm["cache_hits_disk"] < 1:
        failures.append("warm restart never loaded a library from disk")
    if warm["oracle_rows"] != 0:
        failures.append(f"warm restart decoded {warm['oracle_rows']:g} rows "
                        "on the oracle")
    if cold["programs_compiled"] > buckets:
        failures.append(
            f"cold start built {cold['programs_compiled']:g} libraries — "
            f"more than the {buckets} prewarm buckets")
    for name, r in (("cold", cold), ("warm", warm)):
        layouts = r["layouts_by_route"]
        if not layouts or max(layouts.values()) != 1:
            failures.append(f"{name}: canonical layouts by route {layouts} "
                            f"for {n_tables} same-multiset tables (want 1)")
        if r["rows_delivered"] != r["rows_written"]:
            failures.append(f"{name}: delivered {r['rows_delivered']} of "
                            f"{r['rows_written']} rows")
        if on_card and r["k1_launches"] != r["device_batches"]:
            failures.append(f"{name}: K1 launched {r['k1_launches']} times "
                            f"for {r['device_batches']} device-routed "
                            "batches")
    return {
        "mode": "coldstart", "device": device, "ok": not failures,
        "failures": failures, "cold": cold, "warm": warm,
        "warm_zero_compiles": warm["programs_compiled"] == 0,
        "warm_first_durable_seconds": warm["first_durable_seconds"],
        "cold_first_durable_seconds": cold["first_durable_seconds"],
        "cold_oracle_rows_during_warmup": cold["oracle_rows"],
    }


# ---------------------------------------------------------------------------
# wide row
# ---------------------------------------------------------------------------


def run_wide_row(n_rows: int = 16_384, n_iters: int = 5,
                 device: str = "cuda") -> dict:
    """100 columns of 10 kinds (INT8, INT4, NUMERIC, TEXT, TIMESTAMPTZ,
    DATE, BOOL, FLOAT8, JSONB, UUID; 5 % NULL) through one
    `DeviceDecoder` on `device`, routed to the device at every size. The
    60 dense columns' ok bits spread over several of K1's output words a
    row (`words_per_row`); the object columns (TEXT, JSONB, UUID,
    NUMERIC text) are gathered on the host. Median
    of `n_iters` decodes after one warm-up; the first decode equals the
    oracle route's (`device_min_rows` above the batch) column for
    column."""
    import random

    from .. import bench
    from ..models import (ColumnSchema, Oid, ReplicatedTableSchema,
                          TableName, TableSchema)
    from ..ops.engine import DeviceDecoder
    from ..ops.staging import stage_tuples
    from ..postgres.codec.pgoutput import TUPLE_NULL, TUPLE_TEXT, TupleData

    rng = random.Random(11)
    kinds = [Oid.INT8, Oid.INT4, Oid.NUMERIC, Oid.TEXT, Oid.TIMESTAMPTZ,
             Oid.DATE, Oid.BOOL, Oid.FLOAT8, Oid.JSONB, Oid.UUID]
    oids = [kinds[i % len(kinds)] for i in range(100)]
    cols = tuple(ColumnSchema(f"c{i}", oid) for i, oid in enumerate(oids))
    schema = ReplicatedTableSchema.with_all_columns(TableSchema(
        9, TableName("public", "wide"), cols))

    def text_for(oid):
        if oid == Oid.INT8:
            return str(rng.randrange(-10**12, 10**12))
        if oid == Oid.INT4:
            return str(rng.randrange(-10**9, 10**9))
        if oid == Oid.NUMERIC:
            return f"{rng.randrange(0, 10**8)}.{rng.randrange(0, 100):02d}"
        if oid == Oid.TEXT:
            return "text-" + str(rng.randrange(10**6))
        if oid == Oid.TIMESTAMPTZ:
            return "2024-05-01 12:34:56.789+00"
        if oid == Oid.DATE:
            return "2024-05-01"
        if oid == Oid.BOOL:
            return rng.choice(["t", "f"])
        if oid == Oid.FLOAT8:
            return f"{rng.uniform(-1e6, 1e6):.6f}"
        if oid == Oid.JSONB:
            return '{"k": %d}' % rng.randrange(1000)
        return "a0eebc99-9c0b-4ef8-bb6d-6bb9bd380a11"

    tuples = []
    for _ in range(n_rows):
        vals = []
        for oid in oids:
            if rng.random() < 0.05:
                vals.append(None)
            else:
                vals.append(text_for(oid).encode())
        tuples.append(TupleData(
            [TUPLE_NULL if v is None else TUPLE_TEXT for v in vals], vals))

    staged = stage_tuples(tuples, 100)
    # this mode MEASURES THE DEVICE PATH by definition: pin the routing
    dec = DeviceDecoder(schema, device=device, device_min_rows=1)
    counts0 = kernel_counts()
    first = dec.decode(staged)  # warmup
    times = []
    for _ in range(n_iters):
        t0 = time.perf_counter()
        dec.decode(staged)
        times.append(time.perf_counter() - t0)
    counts = counts_delta(counts0)
    oracle = DeviceDecoder(schema, device="cpu",
                           device_min_rows=n_rows + 1).decode(staged)
    rps = n_rows / _median(times)
    from ..ops.bitpack import layout_for_specs

    from ..ops.program_store import canonical_plan

    layout = layout_for_specs(canonical_plan(
        dec._specs(staged, dec._widths(staged))).specs)
    return {"mode": "wide_row", "rows": n_rows, "columns": 100,
            "engine": "cuda", "device": device,
            "dense_columns": len(dec._dense),
            "object_columns": len(dec._object),
            # K1's packed words a row: each dense column's ok bit and
            # value bits (ops/bitpack.py), 60 ok bits over these words
            "words_per_row": layout.n_words,
            "rows_per_second": round(rps),
            "cells_per_second": round(rps * 100),
            "equals_oracle": bench.batches_equal(first, oracle),
            **counts,
            "launches_ok": launches_ok_for(counts, device, "cuda"),
            "ok": bench.batches_equal(first, oracle)}


# ---------------------------------------------------------------------------
# the windowed destination ack
# ---------------------------------------------------------------------------


async def _ack_latency_run(write_window: int, ack_ms: float,
                           n_events: int, tx_size: int,
                           max_size_bytes: int, max_fill_ms: int,
                           engine: str = "cpu",
                           device: str = "cuda") -> dict:
    """One full-pipeline CDC run against a destination whose every ack
    turns durable `ack_ms` later (destinations/delay.py). The producer
    pre-commits the whole workload, so the run measures BACKLOG DRAIN
    throughput with size-bounded batches: at window=1 each batch's ack
    round trip serializes the next dispatch (the `batch_size / ack_rtt`
    ceiling), at window=K the round trips overlap. The engine defaults to
    the per-tuple CPU path, as in the reference: the bench isolates ACK
    PIPELINING. Every delivered row folds into a BATCH-BOUNDARY-
    INDEPENDENT digest (per-row records concatenate identically however
    flushes were split) — the byte-identity evidence across window
    depths (not engines)."""
    import hashlib

    import numpy as np

    from ..config import BatchConfig, PipelineConfig
    from ..destinations.base import Destination, WriteAck
    from ..destinations import DelayedAckDestination
    from ..models import (ColumnSchema, InsertEvent, Oid, TableName,
                          TableSchema)
    from ..models.event import DecodedBatchEvent
    from ..models.table_state import TableStateType
    from ..postgres.codec.pgoutput import encode_insert
    from ..postgres.fake import FakeDatabase, FakeSource
    from ..runtime import Pipeline
    from ..store import NotifyingStore
    from ..telemetry.metrics import (
        ETL_DESTINATION_ACK_BUSY_SECONDS_TOTAL,
        ETL_DESTINATION_ACK_OVERLAP_SECONDS_TOTAL, registry)

    TID = 16391
    db = FakeDatabase()
    # all-dense columns: the delivery digest covers full content via
    # column byte concatenation, no per-row Python on the measured path
    db.create_table(TableSchema(
        TID, TableName("public", "bench_ack"),
        (ColumnSchema("id", Oid.INT8, nullable=False, primary_key_ordinal=1),
         ColumnSchema("v", Oid.INT4))))
    db.create_publication("pub", [TID])
    store = NotifyingStore()

    def _digest_batch(digest, e) -> int:
        """PER-ROW interleaving (column_stack) keeps the digest
        independent of how flushes were split."""
        batch = e.batch
        fields = [np.asarray(e.change_types),
                  np.asarray(e.commit_lsns),
                  np.asarray(e.tx_ordinals)]
        for c in batch.columns:
            valid = np.asarray(c.validity)
            fields.append(valid)
            fields.append(np.where(valid, np.asarray(c.data), 0))
        digest.update(np.column_stack(
            [f.astype(np.uint64) for f in fields]).tobytes())
        return batch.num_rows

    def _digest_row(digest, e) -> int:
        """CPU engine: per-row events; the same per-row record shape as
        one column_stack row."""
        digest.update(np.asarray(
            [1, int(e.commit_lsn), e.tx_ordinal,
             1, int(e.row.values[0]), 1, int(e.row.values[1])],
            dtype=np.uint64).tobytes())
        return 1

    class DigestingDestination(Destination):
        def __init__(self):
            self.rows_delivered = 0
            self.digest = hashlib.sha256()

        async def startup(self):
            return None

        async def write_table_rows(self, schema, batch):
            return WriteAck.durable()

        async def write_events(self, events):
            for e in events:
                if isinstance(e, DecodedBatchEvent):
                    self.rows_delivered += _digest_batch(self.digest, e)
                elif isinstance(e, InsertEvent):
                    self.rows_delivered += _digest_row(self.digest, e)
            return WriteAck.durable()

        async def drop_table(self, table_id, schema=None):
            return None

        async def truncate_table(self, table_id):
            return None

    inner = DigestingDestination()
    dest = DelayedAckDestination(inner, ack_ms / 1000.0)
    labels = {"path": "apply"}
    busy0 = registry.get_counter(ETL_DESTINATION_ACK_BUSY_SECONDS_TOTAL,
                                 labels)
    overlap0 = registry.get_counter(
        ETL_DESTINATION_ACK_OVERLAP_SECONDS_TOTAL, labels)
    counts0 = kernel_counts()
    pipeline = Pipeline(
        config=PipelineConfig(
            pipeline_id=1, publication_name="pub",
            batch=BatchConfig(max_size_bytes=max_size_bytes,
                              max_fill_ms=max_fill_ms,
                              batch_engine=_engine(engine), device=device,
                              write_window=write_window)),
        store=store, destination=dest,
        source_factory=lambda: FakeSource(db))
    try:
        await pipeline.start()
        await asyncio.wait_for(store.notify_on(TID, TableStateType.READY),
                               60)

        # warmup OFF the clock: one tx through the full path
        n_warm = 8
        tx = db.transaction()
        for i in range(n_warm):
            tx.insert_preencoded(TID, encode_insert(
                TID, [str(10**7 + i).encode(), b"0"]))
        await tx.commit()
        while inner.rows_delivered < n_warm:
            await asyncio.sleep(0.01)
        inner.rows_delivered = 0
        inner.digest = hashlib.sha256()

        payloads = [encode_insert(TID, [str(i).encode(),
                                        str(i % 97).encode()])
                    for i in range(n_events)]
        t0 = time.perf_counter()
        produced = 0
        while produced < n_events:
            tx = db.transaction()
            for _ in range(min(tx_size, n_events - produced)):
                tx.insert_preencoded(TID, payloads[produced])
                produced += 1
            await tx.commit()
        while inner.rows_delivered < n_events:
            if pipeline._apply_task is not None \
                    and pipeline._apply_task.done():
                pipeline._apply_task.result()
                raise RuntimeError("pipeline stopped before delivering")
            await asyncio.sleep(0.002)
        # durability barrier: every delayed ack must resolve (delivery
        # alone would flatter the windowed run, which by design has acks
        # pending)
        while dest.pending > 0:
            await asyncio.sleep(0.002)
        elapsed = time.perf_counter() - t0
    finally:
        if pipeline._apply_task is not None:
            await pipeline.shutdown_and_wait()
        await dest.shutdown()

    busy = registry.get_counter(ETL_DESTINATION_ACK_BUSY_SECONDS_TOTAL,
                                labels) - busy0
    overlap = registry.get_counter(
        ETL_DESTINATION_ACK_OVERLAP_SECONDS_TOTAL, labels) - overlap0
    counts = counts_delta(counts0)
    return {
        "write_window": write_window,
        "engine": engine,
        "events_per_second": round(n_events / elapsed),
        "elapsed_seconds": round(elapsed, 4),
        "acks_issued": dest.acks_issued,
        "max_acks_pending": dest.max_pending,
        "delivery_digest": inner.digest.hexdigest(),
        "ack_busy_seconds": round(busy, 4),
        "ack_overlap_seconds": round(overlap, 4),
        "ack_overlap_ratio": round(overlap / busy, 3) if busy else 0.0,
        **counts,
        "launches_ok": launches_ok_for(counts, device, engine),
    }


async def run_ack_latency(ack_ms: float = 20.0, n_events: int = 2000,
                          tx_size: int = 20, max_size_bytes: int = 2048,
                          max_fill_ms: int = 10,
                          write_window: "int | None" = None,
                          engine: str = "cpu",
                          device: str = "cuda") -> dict:
    """The windowed-ack A/B gate: the SAME deterministic backlog drained
    through the default write window and through a forced window=1 run.
    GATES (caller applies the speedup floor): byte-identical delivery
    (order + content digests equal), window=1 never holds more than one
    ack in flight, the windowed run provably overlaps (max pending ≥ 2,
    overlap seconds > 0). `engine` is "cpu" (the reference's choice, the
    per-tuple path) or "cuda" (K1 on `device`)."""
    from ..config import BatchConfig

    window = write_window or BatchConfig().write_window
    windowed = await _ack_latency_run(window, ack_ms, n_events, tx_size,
                                      max_size_bytes, max_fill_ms,
                                      engine, device)
    serial = await _ack_latency_run(1, ack_ms, n_events, tx_size,
                                    max_size_bytes, max_fill_ms,
                                    engine, device)
    speedup = windowed["events_per_second"] \
        / max(serial["events_per_second"], 1)
    failures = []
    if windowed["delivery_digest"] != serial["delivery_digest"]:
        failures.append("windowed delivery is not byte-identical to the "
                        "window=1 run")
    if serial["max_acks_pending"] > 1:
        failures.append(
            f"window=1 held {serial['max_acks_pending']} acks in flight "
            f"(must be ≤ 1 — the one-in-flight contract)")
    if windowed["max_acks_pending"] < 2:
        failures.append("the windowed run never overlapped two acks")
    if windowed["ack_overlap_seconds"] <= 0:
        failures.append("the windowed run recorded zero overlap seconds")
    if not (windowed["launches_ok"] and serial["launches_ok"]):
        failures.append("a device-routed batch launched no kernel, or a "
                        "kernel launched off the device route")
    return {
        "mode": "ack_latency",
        "engine": engine, "device": device,
        "ack_latency_ms": ack_ms,
        "events": n_events,
        "max_size_bytes": max_size_bytes,
        "windowed": windowed,
        "window1": serial,
        "ack_window_speedup": round(speedup, 3),
        "failures": failures,
        "ok": not failures,
    }


# ---------------------------------------------------------------------------
# poison isolation
# ---------------------------------------------------------------------------


async def _run_poison_pass(profile, seed: int, target_ops: int,
                           poisoned: bool,
                           verify_timeout_s: float = 120.0,
                           device: str = "cuda") -> dict:
    """One streamed-CDC measurement for the poison gate: the same
    (profile, seed) workload through the full pipeline (CUDA engine on
    `device`), either clean (poison_rate=0, plain destination, view ==
    truth) or poisoned (PoisonRejectingDestination + isolation live,
    union verification: delivered ∪ dead-lettered == committed truth)."""
    import json as _json
    from dataclasses import replace as _replace

    from ..chaos.invariants import reconstruct_final_view, view_matches
    from ..chaos.runner import RecordingStore, TracingDestination
    from ..config import BatchConfig, PipelineConfig, PoisonConfig
    from ..destinations import PoisonRejectingDestination
    from ..dlq.codec import decode_cell
    from ..models.table_state import TableStateType
    from ..postgres.fake import FakeSource
    from ..runtime import Pipeline
    from ..runtime import poison as poison_mod
    from ..workloads import WorkloadGenerator

    if not poisoned:
        profile = _replace(profile, poison_rate=0.0)
    gen = WorkloadGenerator(profile, seed=seed)
    db = gen.build_db()
    store = RecordingStore()
    inner = TracingDestination()
    dest = PoisonRejectingDestination(inner) if poisoned else inner
    counts0 = kernel_counts()
    pipeline = Pipeline(
        config=PipelineConfig(
            pipeline_id=1, publication_name="pub",
            batch=BatchConfig(max_fill_ms=30,
                              batch_engine=BatchEngine.CUDA, device=device),
            # budget high enough that quarantine never trips: the gate
            # measures bisection + DLQ cost on a flowing stream
            poison=PoisonConfig(budget_rows=1_000_000)),
        store=store, destination=dest,
        source_factory=lambda: FakeSource(db))

    async def settled() -> bool:
        if not poisoned:
            return view_matches(inner, gen.table_ids, gen.expected)
        entries = await store.list_dead_letters(status=None)
        dlq: dict = {tid: {} for tid in gen.table_ids}
        for e in sorted(entries, key=lambda e: (e.commit_lsn,
                                                e.tx_ordinal)):
            doc = _json.loads(e.payload)
            values = tuple(decode_cell(v) for v in doc["values"])
            dlq.setdefault(e.table_id, {})[values[0]] = values
        view = reconstruct_final_view(inner, gen.table_ids)
        for tid in gen.table_ids:
            for pk, values in gen.expected[tid].items():
                if view[tid].get(pk) != values \
                        and dlq[tid].get(pk) != values:
                    return False
        return True

    async def wait_settled(timeout: float) -> bool:
        deadline = time.perf_counter() + timeout
        seen = -1
        while True:
            n = len(inner.events)
            if n == seen and await settled():
                return True
            seen = n
            if pipeline._apply_task is not None \
                    and pipeline._apply_task.done():
                pipeline._apply_task.result()
                raise RuntimeError("pipeline stopped before delivering")
            if time.perf_counter() >= deadline:
                return False
            await asyncio.sleep(0.1)

    poison_mod.reset_isolation_trace()
    try:
        await pipeline.start()
        for tid in gen.table_ids:
            await asyncio.wait_for(
                store.notify_on(tid, TableStateType.READY), 120)
        warm_target = max(100, target_ops // 5)
        while gen.row_ops < warm_target:
            await gen.run_tx(db)
        if not await wait_settled(240):
            raise RuntimeError("warmup never settled")
        ops0 = gen.row_ops
        t0 = time.perf_counter()
        while gen.row_ops - ops0 < target_ops:
            await gen.run_tx(db)
        verified = await wait_settled(verify_timeout_s)
        t_done = time.perf_counter()
    finally:
        if pipeline._apply_task is not None:
            await pipeline.shutdown_and_wait()
    measured = gen.row_ops - ops0
    traces = list(poison_mod.ISOLATION_TRACE)
    probe_writes = sum(t["probe_writes"] for t in traces)
    probe_bound = sum(
        poison_mod.bisection_bound(t["rows"], t["tables"],
                                   t["poison_rows"]) for t in traces)
    dlq_entries = len(await store.list_dead_letters(status=None)) \
        if poisoned else 0
    counts = counts_delta(counts0)
    return {
        "events_per_second": round(measured / max(t_done - t0, 1e-9)),
        "row_ops": measured,
        "verified": bool(verified),
        "poison_rows_committed": sum(len(v)
                                     for v in gen.poison_pks.values()),
        "dlq_entries": dlq_entries,
        "isolations": len(traces),
        "probe_writes": probe_writes,
        "probe_bound": probe_bound,
        "bound_ok": probe_writes <= probe_bound,
        **counts,
        "launches_ok": launches_ok_for(counts, device, "cuda"),
    }


async def run_poison_streaming(rate: float = 0.001, seed: int = 7,
                               target_ops: int = 3_000,
                               device: str = "cuda") -> dict:
    """The poison-resilience gate (`bench --poison`): the SAME seeded
    insert-CDC workload measured twice — clean, and with `rate` of rows
    poisoned against a rejecting destination with isolation live. GATES
    (caller applies floors): the poisoned rate must hold ≥
    poison_ratio_floor of the clean rate, the isolation probe writes
    must stay within the bisection bound, and BOTH runs must verify
    (clean: view == truth; poisoned: delivered ∪ dead-lettered ==
    truth, every poison row accounted)."""
    from dataclasses import replace as _replace

    from ..workloads import get_profile

    profile = _replace(get_profile("poison_rows"), poison_rate=rate)
    clean = await _run_poison_pass(profile, seed, target_ops,
                                   poisoned=False, device=device)
    poisoned = await _run_poison_pass(profile, seed, target_ops,
                                      poisoned=True, device=device)
    ratio = poisoned["events_per_second"] \
        / max(1, clean["events_per_second"])
    failures = []
    if not clean["verified"]:
        failures.append("clean pass failed end-state verification")
    if not poisoned["verified"]:
        failures.append("poisoned pass failed the union invariant "
                        "(delivered ∪ dead-lettered != committed truth)")
    if not poisoned["bound_ok"]:
        failures.append(
            f"bisection writes {poisoned['probe_writes']} exceeded the "
            f"bound {poisoned['probe_bound']}")
    if poisoned["poison_rows_committed"] == 0:
        failures.append("seed committed no poison rows — the gate "
                        "measured nothing; raise target_ops or rate")
    elif poisoned["dlq_entries"] == 0:
        failures.append("poison rows committed but none dead-lettered")
    if not (clean["launches_ok"] and poisoned["launches_ok"]):
        failures.append("a device-routed batch launched no kernel")
    return {
        "mode": "poison",
        "engine": "cuda", "device": device,
        "seed": seed,
        "poison_rate": rate,
        "clean": clean,
        "poisoned": poisoned,
        "clean_events_per_second": clean["events_per_second"],
        "poisoned_events_per_second": poisoned["events_per_second"],
        "poison_throughput_ratio": round(ratio, 3),
        "failures": failures,
        "ok": not failures,
    }


# ---------------------------------------------------------------------------
# exactly-once commits
# ---------------------------------------------------------------------------


def _exactly_once_table(tid: int):
    from ..models import ColumnSchema, Oid, TableName, TableSchema
    from ..postgres.fake import FakeDatabase

    db = FakeDatabase()
    db.create_table(TableSchema(
        tid, TableName("public", "bench_eo"),
        (ColumnSchema("id", Oid.INT8, nullable=False,
                      primary_key_ordinal=1),
         ColumnSchema("v", Oid.INT4))))
    db.create_publication("pub", [tid])
    return db


def _row_events(dest) -> list:
    """The delivered data rows (the per-tuple engine delivers
    Begin/Commit/Relation envelopes too; the dup/loss arithmetic counts
    data rows only)."""
    return [e for e in dest.events if getattr(e, "row", None) is not None]


async def _exactly_once_drain(transactional: bool, n_events: int,
                              tx_size: int, max_size_bytes: int,
                              max_fill_ms: int, engine: str = "cpu",
                              device: str = "cuda") -> dict:
    """One full-pipeline CDC backlog drain into either the plain memory
    sink or the transactional one (write_event_batches_committed +
    coordinate bookkeeping on every flush) — the A/B legs of the
    exactly-once overhead ratio. The per-tuple engine by default, as in
    the reference: the gate isolates the SEAM's per-flush cost
    (CommitRange derivation, coordinate dedup filter, high-water
    accounting)."""
    from ..config import BatchConfig, PipelineConfig
    from ..destinations import (MemoryDestination,
                                TransactionalMemoryDestination)
    from ..models.table_state import TableStateType
    from ..postgres.codec.pgoutput import encode_insert
    from ..postgres.fake import FakeSource
    from ..runtime import Pipeline
    from ..store import NotifyingStore

    TID = 16401
    db = _exactly_once_table(TID)
    store = NotifyingStore()
    dest = TransactionalMemoryDestination() if transactional \
        else MemoryDestination()
    counts0 = kernel_counts()
    pipeline = Pipeline(
        config=PipelineConfig(
            pipeline_id=1, publication_name="pub",
            batch=BatchConfig(max_size_bytes=max_size_bytes,
                              max_fill_ms=max_fill_ms,
                              batch_engine=_engine(engine), device=device)),
        store=store, destination=dest,
        source_factory=lambda: FakeSource(db))
    try:
        await pipeline.start()
        await asyncio.wait_for(store.notify_on(TID, TableStateType.READY),
                               60)

        n_warm = 8
        tx = db.transaction()
        for i in range(n_warm):
            tx.insert_preencoded(TID, encode_insert(
                TID, [str(10**7 + i).encode(), b"0"]))
        await tx.commit()
        while len(_row_events(dest)) < n_warm:
            await asyncio.sleep(0.01)
        dest.events.clear()  # coordinates (high_water) survive

        payloads = [encode_insert(TID, [str(i).encode(),
                                        str(i % 97).encode()])
                    for i in range(n_events)]
        t0 = time.perf_counter()
        produced = 0
        while produced < n_events:
            tx = db.transaction()
            for _ in range(min(tx_size, n_events - produced)):
                tx.insert_preencoded(TID, payloads[produced])
                produced += 1
            await tx.commit()
        while len(_row_events(dest)) < n_events:
            if pipeline._apply_task is not None \
                    and pipeline._apply_task.done():
                pipeline._apply_task.result()
                raise RuntimeError("pipeline stopped before delivering")
            await asyncio.sleep(0.002)
        elapsed = time.perf_counter() - t0
    finally:
        if pipeline._apply_task is not None:
            await pipeline.shutdown_and_wait()
    counts = counts_delta(counts0)
    out = {
        "transactional": transactional,
        "engine": engine,
        "events_per_second": round(n_events / elapsed),
        "elapsed_seconds": round(elapsed, 4),
        "rows_delivered": len(_row_events(dest)),
        **counts,
        "launches_ok": launches_ok_for(counts, device, engine),
    }
    if transactional:
        out["uncoordinated_writes"] = dest.uncoordinated_writes
        out["high_water"] = list(dest.high_water)
    return out


async def _exactly_once_restart_leg(n_events: int, tx_size: int,
                                    max_size_bytes: int,
                                    max_fill_ms: int, engine: str = "cpu",
                                    device: str = "cuda") -> dict:
    """The recovery-trim leg: hard-kill a pipeline mid-backlog against
    the transactional sink, measure the unacked suffix (sink rows whose
    WAL coordinates lie beyond the store's durable progress at the kill
    instant), restart, and finish. The caller gates: zero duplicates,
    zero loss, and re-streamed-already-applied rows (the sink's
    coordinate-dedup counter) bounded by that suffix."""
    from ..chaos.runner import _hard_kill
    from ..config import BatchConfig, PipelineConfig
    from ..destinations import TransactionalMemoryDestination
    from ..destinations.base import event_coordinate
    from ..models.table_state import TableStateType
    from ..postgres.codec.pgoutput import encode_insert
    from ..postgres.fake import FakeSource
    from ..postgres.slots import apply_slot_name
    from ..runtime import Pipeline
    from ..store import NotifyingStore

    TID = 16402
    db = _exactly_once_table(TID)
    store = NotifyingStore()
    dest = TransactionalMemoryDestination()
    counts0 = kernel_counts()

    def make_pipeline():
        return Pipeline(
            config=PipelineConfig(
                pipeline_id=1, publication_name="pub",
                batch=BatchConfig(max_size_bytes=max_size_bytes,
                                  max_fill_ms=max_fill_ms,
                                  batch_engine=_engine(engine),
                                  device=device)),
            store=store, destination=dest,
            source_factory=lambda: FakeSource(db))

    def distinct_rows() -> int:
        return len({e.row.values[0] for e in _row_events(dest)})

    pipeline = make_pipeline()
    try:
        await pipeline.start()
        await asyncio.wait_for(store.notify_on(TID, TableStateType.READY),
                               60)
        payloads = [encode_insert(TID, [str(i).encode(),
                                        str(i % 97).encode()])
                    for i in range(n_events)]
        produced = 0
        while produced < n_events // 2:
            tx = db.transaction()
            for _ in range(min(tx_size, n_events // 2 - produced)):
                tx.insert_preencoded(TID, payloads[produced])
                produced += 1
            await tx.commit()
        # kill once the drain is verifiably mid-flight: some rows applied,
        # the rest still streaming — the classic write-vs-progress gap
        kill_after = max(1, n_events // 8)
        deadline = time.perf_counter() + 60
        while len(_row_events(dest)) < kill_after:
            if time.perf_counter() >= deadline:
                raise RuntimeError("drain never reached the kill window")
            await asyncio.sleep(0.002)
        await _hard_kill(pipeline)
        durable = int(await store.get_durable_progress(apply_slot_name(1))
                      or 0)
        suffix = sum(1 for e in dest.events
                     if (c := event_coordinate(e)) is not None
                     and c[0] > durable)
        applied_at_kill = len(_row_events(dest))

        pipeline = make_pipeline()
        await pipeline.start()
        while produced < n_events:
            tx = db.transaction()
            for _ in range(min(tx_size, n_events - produced)):
                tx.insert_preencoded(TID, payloads[produced])
                produced += 1
            await tx.commit()
        deadline = time.perf_counter() + 120
        while distinct_rows() < n_events:
            if pipeline._apply_task is not None \
                    and pipeline._apply_task.done():
                pipeline._apply_task.result()
                raise RuntimeError("pipeline stopped before delivering")
            if time.perf_counter() >= deadline:
                raise RuntimeError(
                    f"recovery leg never delivered: {distinct_rows()}"
                    f"/{n_events}")
            await asyncio.sleep(0.005)
        await pipeline.shutdown_and_wait()
    finally:
        # a failed leg must not leave a live pipeline behind (after a
        # clean shutdown this is a no-op)
        await _hard_kill(pipeline)
    counts = counts_delta(counts0)
    return {
        "rows_applied_at_kill": applied_at_kill,
        "durable_lsn_at_kill": durable,
        "unacked_suffix_rows": suffix,
        "restreamed_deduped_rows": dest.dedup_skipped_rows,
        "duplicate_rows": len(_row_events(dest)) - distinct_rows(),
        "rows_delivered": distinct_rows(),
        "recover_calls": dest.recover_calls,
        "uncoordinated_writes": dest.uncoordinated_writes,
        **counts,
        "launches_ok": launches_ok_for(counts, device, engine),
    }


async def run_exactly_once(n_events: int = 3_000, tx_size: int = 40,
                           max_size_bytes: int = 4096,
                           max_fill_ms: int = 10,
                           repeats: int = 3, engine: str = "cpu",
                           device: str = "cuda") -> dict:
    """The exactly-once overhead + recovery-trim gate (`bench
    --exactly-once`): the SAME deterministic CDC backlog drained into the
    plain memory sink and into the transactional one (coordinate range
    recorded atomically with every flush). GATES (caller applies
    exactly_once_ratio_floor): the transactional drain must hold >=
    floor of the plain rate, every CDC write must route through the
    committed seam (zero uncoordinated writes), and the hard-kill restart
    leg must deliver every row exactly once with its re-streamed-already-
    applied rows bounded by the unacked suffix at the kill, the sink's
    `recover_high_water` consulted. Each timed drain is best-of-`repeats`,
    A/B interleaved: one short pass carries the host scheduler's noise,
    far above the coordination overhead under test."""
    plain = txn = None
    for _ in range(max(1, repeats)):
        p = await _exactly_once_drain(False, n_events, tx_size,
                                      max_size_bytes, max_fill_ms,
                                      engine, device)
        t = await _exactly_once_drain(True, n_events, tx_size,
                                      max_size_bytes, max_fill_ms,
                                      engine, device)
        if plain is None or p["events_per_second"] > \
                plain["events_per_second"]:
            plain = p
        if txn is None or t["events_per_second"] > \
                txn["events_per_second"]:
            txn = t
    leg = await _exactly_once_restart_leg(n_events, tx_size,
                                          max_size_bytes, max_fill_ms,
                                          engine, device)
    ratio = txn["events_per_second"] / max(1, plain["events_per_second"])
    failures = []
    if txn["uncoordinated_writes"]:
        failures.append(
            f"{txn['uncoordinated_writes']} CDC write(s) bypassed the "
            f"transactional seam in the drain leg")
    if leg["uncoordinated_writes"]:
        failures.append(
            f"{leg['uncoordinated_writes']} CDC write(s) bypassed the "
            f"transactional seam in the restart leg")
    if leg["duplicate_rows"]:
        failures.append(
            f"exactly-once violated across the hard kill: "
            f"{leg['duplicate_rows']} duplicate row(s) reached the sink")
    if leg["rows_delivered"] < n_events:
        failures.append(
            f"loss across the hard kill: {leg['rows_delivered']}"
            f"/{n_events} rows delivered")
    if leg["restreamed_deduped_rows"] > leg["unacked_suffix_rows"]:
        failures.append(
            f"re-stream exceeded the unacked suffix: "
            f"{leg['restreamed_deduped_rows']} already-applied rows "
            f"re-delivered vs {leg['unacked_suffix_rows']} unacked at "
            f"the kill — recovery did not trim the resume point")
    if leg["recover_calls"] < 1:
        failures.append("the restart never queried the sink high-water "
                        "mark")
    if not (plain["launches_ok"] and txn["launches_ok"]
            and leg["launches_ok"]):
        failures.append("a device-routed batch launched no kernel")
    return {
        "mode": "exactly_once",
        "engine": engine, "device": device,
        "events": n_events,
        "plain": plain,
        "transactional": txn,
        "restart": leg,
        "plain_events_per_second": plain["events_per_second"],
        "transactional_events_per_second": txn["events_per_second"],
        "exactly_once_overhead_ratio": round(ratio, 3),
        "failures": failures,
        "ok": not failures,
    }


# ---------------------------------------------------------------------------
# autoscale reaction time
# ---------------------------------------------------------------------------


def run_autoscale_bench(seed: int = 7, reaction_ticks_max: int = 3) -> dict:
    """Autoscale reaction-time gate: the seeded surge→drain timeline
    through the scaling policy with the applied-K loop closed. GATED:
    (a) the scale-up decision lands within `reaction_ticks_max`
    evaluation ticks of the surge onset; (b) the scale-down must NOT fire
    before the cooldown expires after the scale-up; (c) the topology
    returns to the starting K once the backlog drains; (d) the decision
    trace is bit-identical across two runs of the same seed. Pure policy
    arithmetic: no pipeline, no device. Copy of the reference's
    `bench.py::run_autoscale_bench`."""
    from ..autoscale import (ACTION_DOWN, ACTION_HOLD, ACTION_UP,
                             AutoscalePolicy, AutoscalePolicyConfig,
                             seeded_surge_timeline)
    from ..autoscale.policy import simulate

    surge_at = 10
    config = AutoscalePolicyConfig(
        min_shards=2, max_shards=3, drain_slo_s=2.0,
        up_backlog_bytes=256 * 1024, down_backlog_bytes=64 * 1024,
        up_ticks=2, down_ticks=3, cooldown_ticks=5)
    policy = AutoscalePolicy(config)

    def trace():
        timeline = seeded_surge_timeline(seed, shards=2, ticks=40,
                                         surge_at=surge_at)
        return [d.describe()
                for d in simulate(timeline.frames, policy, 2)]

    first, second = trace(), trace()
    actions = [(d["tick"], d["action"], d["target_k"]) for d in first
               if d["action"] != ACTION_HOLD]
    up_ticks = [t for t, a, _ in actions if a == ACTION_UP]
    down_ticks = [t for t, a, _ in actions if a == ACTION_DOWN]
    failures = []
    if first != second:
        failures.append("decision trace not deterministic across two "
                        "runs of the same seed")
    if not up_ticks:
        failures.append("the surge never produced a scale-up decision")
    elif up_ticks[0] - surge_at > reaction_ticks_max:
        failures.append(
            f"scale-up reacted in {up_ticks[0] - surge_at} ticks, gate "
            f"is {reaction_ticks_max}")
    if not down_ticks:
        failures.append("the drain never produced a scale-down decision")
    elif up_ticks and down_ticks[0] - up_ticks[0] < config.cooldown_ticks:
        failures.append(
            f"scale-down fired {down_ticks[0] - up_ticks[0]} ticks after "
            f"the scale-up, inside the {config.cooldown_ticks}-tick "
            f"cooldown")
    final_k = actions[-1][2] if actions else 2
    if final_k != 2:
        failures.append(f"topology did not return to K=2 after the "
                        f"drain (final K={final_k})")
    return {
        "mode": "autoscale",
        "seed": seed,
        "surge_at_tick": surge_at,
        "scale_up_tick": up_ticks[0] if up_ticks else None,
        "scale_down_tick": down_ticks[0] if down_ticks else None,
        "reaction_ticks": (up_ticks[0] - surge_at) if up_ticks else None,
        "reaction_ticks_max": reaction_ticks_max,
        "cooldown_ticks": config.cooldown_ticks,
        "decisions": [{"tick": t, "action": a, "target_k": k}
                      for t, a, k in actions],
        "deterministic": first == second,
        "failures": failures,
        "ok": not failures,
    }


# ---------------------------------------------------------------------------
# fleet convergence
# ---------------------------------------------------------------------------


def actuation_digest(actuations: list) -> str:
    """sha256 of an actuation log, one canonical JSON document: two runs
    that made the same runtime calls in the same order share it."""
    import hashlib
    import json

    return hashlib.sha256(json.dumps(actuations, sort_keys=True)
                          .encode()).hexdigest()


def run_fleet_bench(seed: int = 7, fleet_size: int = 100,
                    converge_ticks_max: int = 3) -> dict:
    """Fleet converge gate (docs/fleet.md): a `fleet_size`-pipeline
    seeded FleetSpec reconciles onto an empty simulated fleet, then
    through one versioned add/remove/resize edit. GATED: (a) each
    convergence completes within `converge_ticks_max` WORKING ticks;
    (b) zero double-actuations — every runtime call in the actuation
    log is backed 1:1 by an APPLIED record in the per-pipeline journals,
    and nothing stays pending; (c) the observed fleet equals the
    quota-clamped placement exactly (no leaks, no strays); (d) the
    actuation trace is bit-identical across two runs of the same seed.
    Wall clock is RECORDED, not gated: pure host arithmetic, no pipeline
    and no device. Copy of the reference's `bench.py::run_fleet_bench`,
    which also returns the trace itself (`actuation_trace`) and its
    `actuation_digest`."""
    from ..fleet import (FleetReconciler, PipelineSpec,
                         SimulatedFleetRuntime, seeded_fleet_spec)
    from ..fleet.reconciler import place_fleet
    from ..store.memory import MemoryStore

    async def drive() -> dict:
        store = MemoryStore()
        runtime = SimulatedFleetRuntime(seed=seed)
        spec = seeded_fleet_spec(seed, fleet_size)
        await store.update_fleet_spec(spec.to_json())
        reconciler = FleetReconciler(store=store, runtime=runtime)
        t0 = time.perf_counter()
        ticks = await reconciler.converge(
            max_ticks=converge_ticks_max + 1)
        converge_s = time.perf_counter() - t0
        edited = spec.with_edit(
            remove=[1, 2], resize={10: 6, 11: 1},
            add=[PipelineSpec(pipeline_id=fleet_size + 1,
                              tenant_id="tenant-edit", shard_count=2)])
        await store.update_fleet_spec(edited.to_json())
        t0 = time.perf_counter()
        edit_ticks = await reconciler.converge(
            max_ticks=converge_ticks_max + 1)
        edit_s = time.perf_counter() - t0
        journals = await store.get_fleet_journals()
        statuses = [e.get("status") for doc in journals.values()
                    for e in doc.get("entries", [])]
        return {
            "ticks": ticks,
            "edit_ticks": edit_ticks,
            "converge_s": converge_s,
            "edit_s": edit_s,
            "applied": statuses.count("applied"),
            "pending": statuses.count("pending"),
            "actuations": list(runtime.actuation_log),
            "observed": await runtime.list_pipelines(),
            "targets": place_fleet(edited),
            "violations": runtime.violations(),
        }

    first = asyncio.run(drive())
    second = asyncio.run(drive())
    failures = []
    for label, ticks in (("initial", first["ticks"]),
                         ("edit", first["edit_ticks"])):
        if ticks > converge_ticks_max:
            failures.append(f"{label} converge took {ticks} working "
                            f"ticks, gate is {converge_ticks_max}")
    double = len(first["actuations"]) - first["applied"]
    if double != 0:
        failures.append(f"{double} runtime actuations not backed by an "
                        f"applied journal record")
    if first["pending"]:
        failures.append(f"{first['pending']} journal records still "
                        f"pending after convergence")
    if first["observed"] != first["targets"]:
        failures.append("observed fleet != quota-clamped placement")
    if first["violations"]:
        failures.extend(first["violations"][:5])
    if first["actuations"] != second["actuations"]:
        failures.append("actuation trace not deterministic across two "
                        "runs of the same seed")
    return {
        "mode": "fleet",
        "seed": seed,
        "fleet_size": fleet_size,
        "converge_ticks": first["ticks"],
        "edit_converge_ticks": first["edit_ticks"],
        "converge_ticks_max": converge_ticks_max,
        "converge_wall_clock_s": round(first["converge_s"], 4),
        "edit_wall_clock_s": round(first["edit_s"], 4),
        "actuations": len(first["actuations"]),
        "applied_records": first["applied"],
        "double_actuations": double,
        "deterministic": first["actuations"] == second["actuations"],
        "observed_equals_placement": first["observed"] == first["targets"],
        "actuation_trace": first["actuations"],
        "actuation_digest": actuation_digest(first["actuations"]),
        "failures": failures,
        "ok": not failures,
    }
