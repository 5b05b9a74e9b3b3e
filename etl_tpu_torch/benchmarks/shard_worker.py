"""One shard replicator as its own OS process — the bench pod model.

`python -m etl_tpu_torch.benchmarks.shard_worker [--device cpu]
'<spec json>'` runs ONE pipeline (shard-scoped or unsharded) against its
own fake source replica and prints a single JSON result line. The parent
(`bench --sharded K` via `harness.run_sharded_processes`) launches K of
these concurrently: separate interpreters, separate GILs, separate CUDA
contexts on the one card — the resource split of K replicator pods,
which an in-process K-way run (one GIL, one event loop) cannot show.

Faithfulness contract: every worker replays the IDENTICAL publication
WAL — the workload generator's byte-identical `(profile, seed)` replay
contract makes K private FakeDatabase replicas indistinguishable from K
connections to one source. A sharded worker applies only its ShardMap
slice and verifies that slice against the generator's committed truth;
the parent asserts the slices cover every table. The store is a
per-process MemoryStore: this bench measures decode/apply capacity —
shared-store semantics (ownership fences, epoch refusal, rebalancing)
are covered by the chaos scenario and the sharding tests.

Reported `events_per_second` counts ROW EVENTS DELIVERED at this
worker's destination over its measured window (produce start → slice
verified), so the K-shard aggregate and the single-shard baseline count
the same units. The worker also reports its kernel launches and its
device-routed batches, over the whole run and over the window; on the
card `launches_ok` holds when each device-routed batch launched one
kernel.

Copy of the reference's `etl_tpu/benchmarks/shard_worker.py`. The
pipeline decodes with the CUDA engine on the card unless `--device cpu`
is given (or the spec's `engine` is "cpu", the per-tuple path); a worker
asked for the card that finds none fails, and never carries on on the
CPU. The spec's `device_floor` (rows) pins the worker's decode threshold
(`chaos.runner.device_floor`).
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
import sys
import time


def _row_events(dest) -> int:
    from ..models.event import DeleteEvent, InsertEvent, UpdateEvent

    return sum(1 for e in dest.events
               if isinstance(e, (InsertEvent, UpdateEvent, DeleteEvent)))


async def run_worker(spec: dict) -> dict:
    from ..chaos.invariants import view_matches
    from ..chaos.runner import TracingDestination
    from ..config import BatchConfig, BatchEngine, PipelineConfig
    from ..models.table_state import TableStateType
    from ..postgres.fake import FakeSource
    from ..runtime import Pipeline
    from ..sharding import ShardMap
    from ..store import NotifyingStore
    from ..workloads import WorkloadGenerator, get_profile
    from .harness import counts_delta, kernel_counts, launches_ok_for

    shard = spec.get("shard")  # None = unsharded baseline
    shard_count = int(spec.get("shard_count", 1))
    engine = spec.get("engine", "cuda")
    device = spec.get("device", "cuda")
    prof = dataclasses.replace(get_profile(spec.get("profile",
                                                    "insert_heavy")),
                               tables=int(spec.get("tables", 8)))
    gen = WorkloadGenerator(prof, seed=int(spec.get("seed", 7)))
    db = gen.build_db()
    owned = gen.table_ids if shard is None else \
        ShardMap(shard_count).tables_for_shard(gen.table_ids, shard)
    store = NotifyingStore()
    dest = TracingDestination()
    pipeline = Pipeline(
        config=PipelineConfig(
            pipeline_id=1, publication_name="pub",
            batch=BatchConfig(max_fill_ms=30,
                              batch_engine=BatchEngine(engine),
                              device=device),
            lag_sample_interval_s=0,
            shard=shard, shard_count=shard_count),
        store=store, destination=dest,
        source_factory=lambda: FakeSource(db))

    def delivered() -> bool:
        return view_matches(dest, owned,
                            {tid: gen.expected[tid] for tid in owned})

    async def wait_verified() -> None:
        seen = -1
        while True:
            n = len(dest.events)
            if n == seen and delivered():
                return
            seen = n
            if pipeline._apply_task is not None \
                    and pipeline._apply_task.done():
                pipeline._apply_task.result()
                raise RuntimeError("pipeline stopped before delivering")
            await asyncio.sleep(0.1)

    target_ops = int(spec.get("target_ops", 2_000))
    verify_timeout_s = float(spec.get("verify_timeout_s", 240.0))
    counts0 = kernel_counts()
    try:
        await pipeline.start()
        for tid in owned:
            await asyncio.wait_for(
                store.notify_on(tid, TableStateType.READY), 120)
        warm_target = max(100, target_ops // 5)
        while gen.row_ops < warm_target:
            await gen.run_tx(db)
        await asyncio.wait_for(wait_verified(), 240)

        ops0 = gen.row_ops
        ev0 = _row_events(dest)
        window0 = kernel_counts()
        t0 = time.perf_counter()
        while gen.row_ops - ops0 < target_ops:
            await gen.run_tx(db)
        t_prod = time.perf_counter()
        try:
            await asyncio.wait_for(wait_verified(), verify_timeout_s)
            verified = True
        except asyncio.TimeoutError:
            verified = False
        t_done = time.perf_counter()
        ev1 = _row_events(dest)
        window = counts_delta(window0)
    finally:
        if pipeline._apply_task is not None:
            await pipeline.shutdown_and_wait()
    counts = counts_delta(counts0)
    seconds = max(t_done - t0, 1e-9)
    events = ev1 - ev0
    return {
        "shard": shard, "shard_count": shard_count,
        "engine": engine, "device": device,
        "device_floor": spec.get("device_floor"),
        "profile": prof.name, "tables": len(owned),
        "owned_table_ids": list(owned),
        "committed_ops": gen.row_ops - ops0,
        "delivered_row_events": events,
        "produce_seconds": round(t_prod - t0, 4),
        "window_seconds": round(seconds, 4),
        "events_per_second": round(events / seconds),
        "verified": bool(verified),
        **counts,
        "launches_ok": launches_ok_for(counts, device, engine),
        "window_device_batches": window["device_batches"],
        "window_launches": window["launches"],
        "device_batches_per_1000_events":
            1000.0 * window["device_batches"] / events if events else None,
    }


def main(argv: "list[str] | None" = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m etl_tpu_torch.benchmarks.shard_worker")
    ap.add_argument("--device", default=None,
                    help="torch device of the decoders: cuda (the "
                         "default; the card, and no card fails the run) "
                         "or cpu (the kernels' plain versions); "
                         "overrides the spec's 'device'")
    ap.add_argument("spec", help="the worker's spec as one JSON object")
    args = ap.parse_args(argv)
    spec = json.loads(args.spec)
    if args.device is not None:
        spec["device"] = args.device
    device = spec.setdefault("device", "cuda")
    if spec.get("engine", "cuda") == "cuda" \
            and device.split(":")[0] == "cuda":
        import torch

        if not torch.cuda.is_available():
            # no fallback to the CPU: the worker runs on the card or fails
            print(json.dumps({"error": f"--device {device}: no CUDA "
                                       "device is available"}))
            return 1
    from ..chaos.runner import device_floor

    with device_floor(spec.get("device_floor")):
        out = asyncio.run(run_worker(spec))
    print(json.dumps(out))
    return 0 if out.get("verified") and out.get("launches_ok") else 1


if __name__ == "__main__":
    sys.exit(main())
