"""The fleet on live replicators: the reconciler over `LocalOrchestrator`
children that decode on `device`, and the signal bus's admission weights
on live pipelines sharing the process's admission scheduler.

    r = asyncio.run(run_fleet_children(device="cpu"))      # r["ok"]
    r = asyncio.run(run_admission_weights(device="cpu"))   # r["ok"]

`run_fleet_children`, in one process beside its children:

- the source: the port's fake Postgres server in a child process
  (`testing.pg_process`) holding two tables of pgbench_accounts' shape
  for each of pipelines A and B, `copy_rows` rows each, one publication
  a pipeline;
- the destination: the ClickHouse fake in a child process
  (`testing.http_process`), which counts rows and sequence keys outside
  the replicators;
- the coordinator: a `FleetReconciler` over `OrchestratorFleetRuntime(
  LocalOrchestrator)` (with the simulated fleet's crash-window hooks and
  actuation log, `JournaledOrchestratorRuntime`) and a `SqliteStore`
  holding the FleetSpec and the actuation journals. The spec has two
  tenants with quotas: A (K = 1) and B (K = 2); each pipeline's config
  names its own `metrics_port` pair, so shard s of A and shard s of B
  never share a port;
- from empty the fleet converges, every child (`python -m
  etl_tpu_torch.replicator`) turns healthy and streams from its apply
  slot, copies its tables and takes one CDC wave into each pipeline; each child's own `/metrics`
  shows device-routed rows (and, on the card, kernel seconds);
- one versioned edit deletes B and resizes A from 1 to 2. The
  coordinator is killed in both crash windows of the journal, as the
  reference's fleet chaos does: after B's delete landed and before its
  settle (`post_actuate`: the successor's `resume()` settles it with no
  runtime call), then before A's resize ran (`pre_actuate`: the
  successor re-drives the roll). A second `resume()` finds nothing;
- the roll starts shards 0 and 1 of A; once both stream from their new
  apply slots, one more CDC wave into A, and each of A's children shows
  its own device work;
- `/v1/fleet`, served by the API over the fleet store, shows desired =
  observed; every copied row and every sequence key arrives once, table
  by table; every runtime call is backed by an applied journal record;
- a last edit removes A: the orchestrator lists nothing, as placed, and
  no child is left.

The resize calls `scale_pipeline` without a `ShardCoordinator`
rebalance, as the reference's fleet runtime does: A's K = 1 child runs
unsharded, so its K = 2 pods bootstrap a fresh shard assignment and new
per-shard slots, and nothing is written to A between the edit and both
pods streaming from those slots.

Each pipeline's pair of `/metrics` ports is held (`PortPair`) from the
choice until the run ends, so no other socket takes a port before its
child binds it, or between a child's stop and its successor's start.

`run_admission_weights`: two in-process `Pipeline`s on the process's
`global_admission()` scheduler, both decoding on `device`. The bus's
`AdmissionWeightPolicy` runs over frames in which one pipeline lags, so
the lagging tenant's weight is boosted over its quota's base and the
healthy tenant's stays at its base, both set in the live scheduler; then
`n_events` inserts stream into each pipeline, each verified by count and
by digest; the scheduler drains to nothing in flight and no tenant.

On the card the kernel libraries are built once in this process before
any child starts; each child loads them from `_build/`. A child that
cannot build or launch fails its batches, and the run fails with them:
nothing degrades to the host oracle.
"""

from __future__ import annotations

import asyncio
import json
import os
import tempfile
import time

from ..fleet import OrchestratorFleetRuntime
from .control_plane import PortPair, _alive, _metric

TX_SIZE = 500
TENANTS = ("tenant-a", "tenant-b")


class JournaledOrchestratorRuntime(OrchestratorFleetRuntime):
    """`OrchestratorFleetRuntime` with the simulated fleet's actuation
    log (every runtime call, in order) and its crash-window hooks: async
    `pre_actuate` / `post_actuate(verb, pipeline_id)` awaited around the
    orchestrator call."""

    def __init__(self, orchestrator):
        super().__init__(orchestrator)
        self.actuation_log: list = []
        self.pre_actuate = None
        self.post_actuate = None

    async def _actuate(self, verb: str, pipeline_id: int, to_k: int,
                       call) -> None:
        if self.pre_actuate is not None:
            await self.pre_actuate(verb, pipeline_id)
        self.actuation_log.append({"verb": verb, "pipeline_id": pipeline_id,
                                   "to_k": to_k})
        await call()
        if self.post_actuate is not None:
            await self.post_actuate(verb, pipeline_id)

    async def create_pipeline(self, spec) -> None:
        await self._actuate("create", spec.pipeline_id, spec.shard_count,
                            lambda: OrchestratorFleetRuntime.create_pipeline(
                                self, spec))

    async def resize_pipeline(self, spec) -> None:
        await self._actuate("resize", spec.pipeline_id, spec.shard_count,
                            lambda: OrchestratorFleetRuntime.resize_pipeline(
                                self, spec))

    async def delete_pipeline(self, pipeline_id: int) -> None:
        await self._actuate("delete", pipeline_id, 0,
                            lambda: OrchestratorFleetRuntime.delete_pipeline(
                                self, pipeline_id))


async def _journal_tally(store) -> dict:
    journals = await store.get_fleet_journals()
    statuses = [e.get("status") for doc in journals.values()
                for e in doc.get("entries", [])]
    return {s: statuses.count(s) for s in ("applied", "pending", "aborted")}


async def kill_in_window(store, runtime, *, window: str, pipeline_id: int,
                         label: str, scheduler) -> tuple:
    """Kill a coordinator's tick inside one crash window of
    `pipeline_id`'s actuation (the spec in the store already demands it),
    then drive a successor's `resume()` twice. Returns what was seen (the
    pending records at the kill, the records the successor settled, the
    runtime calls its resume made, the second resume's records) and the
    successor."""
    from ..fleet import FleetReconciler

    blocked = asyncio.Event()

    async def hook(verb: str, pid: int) -> None:
        if pid == pipeline_id:
            blocked.set()
            await asyncio.Event().wait()  # park until cancelled

    setattr(runtime, window, hook)
    coordinator = FleetReconciler(store=store, runtime=runtime,
                                  scheduler=scheduler)
    task = asyncio.ensure_future(coordinator.tick())
    try:
        await asyncio.wait_for(blocked.wait(), timeout=60)
        pending_at_kill = (await _journal_tally(store))["pending"]
        task.cancel()
        try:
            await task
        except asyncio.CancelledError:
            pass
    finally:
        setattr(runtime, window, None)
    successor = FleetReconciler(store=store, runtime=runtime,
                                scheduler=scheduler)
    calls0 = len(runtime.actuation_log)
    settled = await successor.resume()
    calls = len(runtime.actuation_log) - calls0
    again = await successor.resume()
    return {"label": label, "window": window, "pipeline_id": pipeline_id,
            "pending_at_kill": pending_at_kill,
            "settled": [r.to_json() for r in settled],
            "mode": "settle" if window == "post_actuate" else "redrive",
            "resume_runtime_calls": calls,
            "second_resume": [r.to_json() for r in again]}, successor


def _log_tail(orch, key, n_bytes: int = 1500) -> str:
    """The end of a `LocalOrchestrator` child's log (its config dir's
    `replicator.log`)."""
    pid, shard = key if isinstance(key, tuple) else (key, None)
    suffix = "" if shard is None else f"-s{shard}"
    path = os.path.join(orch.work_dir, f"pipeline-{pid}{suffix}",
                        "replicator.log")
    try:
        with open(path, "rb") as f:
            f.seek(max(0, os.path.getsize(path) - n_bytes))
            return f.read().decode(errors="replace")
    except OSError as e:
        return f"(no log: {e})"


def _table_ids(start: int, n: int, exclude: set) -> list:
    """`n` table ids from `start` up whose K = 2 ShardMap gives each shard
    one at least (so both pods of a K = 2 pipeline have work)."""
    from ..sharding import ShardMap

    tid = start
    while True:
        ids = [t for t in range(tid, tid + n)]
        part = ShardMap(2).partition(ids)
        if not exclude & set(ids) and all(part[s] for s in (0, 1)):
            return ids
        tid += 1


async def run_fleet_children(copy_rows: int = 2_000, events: int = 2_000, *,
                             device: str = "cuda", seed: int = 7,
                             converge_ticks_max: int = 3,
                             start_timeout_s: float = 300.0,
                             budget_s: "float | None" = None) -> dict:
    """The fleet over `LocalOrchestrator` children (module docstring).
    `events` is each CDC wave's inserts into a pipeline, spread over its
    two tables in 500-row transactions. `budget_s` bounds every wait of
    the run (the children's `/health`, the rows counted at the fake) by
    what is left of it, so a caller's own time box outlasts the run's
    waits and a slow start fails as the run's wait that ran out."""
    from aiohttp import web

    from .. import bench
    from ..api.app import ApiState, build_app
    from ..api.crypto import ConfigCipher, EncryptionKey
    from ..api.db import SqliteApiDb
    from ..api.orchestrator import LocalOrchestrator
    from ..fleet import (FleetReconciler, FleetSpec, PipelineSpec,
                         TenantQuota)
    from ..fleet.reconciler import place_fleet
    from ..ops.pipeline import AdmissionScheduler
    from ..postgres.slots import apply_slot_name
    from ..store import SqliteStore
    from ..testing.http_process import HttpServerProcess
    from ..testing.pg_process import PgServerProcess

    out: dict = {"mode": "fleet_children", "device": device,
                 "copy_rows": copy_rows, "events": events,
                 "converge_ticks_max": converge_ticks_max,
                 "converge_ticks": {}}
    if device.split(":")[0] == "cuda":
        # one nvcc build a source, in this process, before any child
        from ..ops import decode_kernel, egress_kernel

        t0 = time.perf_counter()
        await asyncio.to_thread(decode_kernel.load)  # off the loop
        await asyncio.to_thread(egress_kernel.load)
        out["build_s"] = time.perf_counter() - t0

    tables = {1: _table_ids(bench.PGBENCH_TID, 2, set())}
    tables[2] = _table_ids(max(tables[1]) + 1, 2, set(tables[1]))
    names = {tid: f"pgbench_accounts_{'ab'[pid - 1]}{i}"
             for pid, tids in tables.items() for i, tid in enumerate(tids)}
    per = events // 2  # inserts a table, a wave
    deadline = None if budget_s is None else time.monotonic() + budget_s

    def wait_s(timeout_s: float) -> float:
        """`timeout_s`, cut to what is left of the budget."""
        if deadline is None:
            return timeout_s
        return max(0.0, min(timeout_s, deadline - time.monotonic()))

    tmp = tempfile.TemporaryDirectory()
    server = PgServerProcess(password=bench.WIRE_PASSWORD)
    fake = HttpServerProcess("clickhouse")
    orch = LocalOrchestrator(os.path.join(tmp.name, "work"))
    runtime = JournaledOrchestratorRuntime(orch)
    sched = AdmissionScheduler(1)  # the coordinator's own SLO feed target
    store = SqliteStore(os.path.join(tmp.name, "fleet.db"), 1)
    runner = None
    # each pipeline's pair of /metrics ports, held until the end
    held = [PortPair(), PortPair()]
    ports = {1: held[0].port, 2: held[1].port}
    children: dict = {}  # key → pid, every child the run saw
    waves: dict = {1: 0, 2: 0}

    async def acall(proc, cmd, **kw):
        return await asyncio.to_thread(proc.call, cmd, **kw)

    async def wave(pid: int) -> None:
        """`per` inserts into each of the pipeline's tables."""
        waves[pid] += 1
        for i, tid in enumerate(tables[pid]):
            await acall(server, "prepare", n_events=per,
                        seed=seed + 100 * waves[pid] + 10 * pid + i,
                        first_aid=copy_rows + waves[pid] * per + 1,
                        table_id=tid)
            await acall(server, "produce", tx_size=TX_SIZE)

    async def until_counted(key: str, want: int, timeout_s: float,
                            what: str) -> None:
        async def done():
            return (await acall(fake, "count"))[key] >= want

        await bench._until(done, wait_s(timeout_s), what, interval=0.05)

    async def healthy(port_list: list) -> float:
        t0 = time.perf_counter()

        async def up():
            for key, proc in orch._procs.items():
                children[str(key)] = proc.pid
                if proc.returncode is not None:
                    raise RuntimeError(
                        f"replicator child {key} exited with "
                        f"{proc.returncode}: {_log_tail(orch, key)}")
            for p in port_list:
                try:
                    status, _ = await bench.http_get(p, "/health")
                except OSError:
                    return False
                if status != 200:
                    return False
            return True

        await bench._until(up, wait_s(start_timeout_s),
                           f"/health 200 on {port_list}", interval=0.1)
        return time.perf_counter() - t0

    async def streaming(slots: list) -> float:
        """Wait until each of the pods' apply slots is streaming. `/health`
        answers 200 once a pod's pipeline started, before its apply worker
        created its slot and began to stream; a wave written before then
        lies behind the new slot's start and never reaches the pod."""
        t0 = time.perf_counter()

        async def active():
            for name in slots:
                s = await acall(server, "slot", name=name)
                if s is None or not s["active"]:
                    return False
            return True

        await bench._until(active, wait_s(start_timeout_s),
                           f"the apply slots {slots} streaming",
                           interval=0.05)
        return time.perf_counter() - t0

    async def scrape(port: int) -> dict:
        status, body = await bench.http_get(port, "/metrics")
        text = body.decode()
        return {"port": port, "status": status,
                "device_rows": _metric(
                    text, "etl_decode_routed_device_rows_total"),
                "kernel_s": _metric(text, "etl_decode_kernel_seconds_total")}

    def device_work_ok(m: dict) -> bool:
        if m["status"] != 200 or m["device_rows"] <= 0:
            return False
        return m["kernel_s"] > 0 if device.split(":")[0] == "cuda" \
            else True

    async def fleet_view(http_port: int) -> dict:
        status, body = await bench.http_get(http_port, "/v1/fleet")
        doc = json.loads(body)
        return {"status": status, "spec_version": doc["spec_version"],
                "converged": doc["converged"], "counts": doc["counts"],
                "rows": [{k: p[k] for k in (
                    "pipeline_id", "tenant_id", "desired_shards",
                    "observed_shards", "state")} for p in doc["pipelines"]],
                "desired_equals_observed": all(
                    p["desired_shards"] == p["observed_shards"]
                    for p in doc["pipelines"])}

    try:
        await store.connect()
        for pid, tids in tables.items():
            for i, tid in enumerate(tids):
                await acall(server, "table", n_rows=copy_rows,
                            seed=seed + 10 * pid + i, table_id=tid,
                            name=names[tid])
            await acall(server, "publication", name=f"pub_{'ab'[pid - 1]}",
                        row_filter=None, offload=False, table_ids=tids)

        def config(pid: int) -> dict:
            return {"pipeline_id": pid,
                    "publication_name": f"pub_{'ab'[pid - 1]}",
                    "pg_connection": {"host": "127.0.0.1",
                                      "port": server.port,
                                      "name": "postgres", "username": "etl",
                                      "password": bench.WIRE_PASSWORD},
                    "destination": fake.destination_doc(),
                    "batch": {"batch_engine": "cuda", "device": device,
                              "max_fill_ms": 30},
                    "store": {"type": "postgres"},
                    "metrics_port": ports[pid]}

        spec = FleetSpec(
            spec_version=1,
            pipelines=(PipelineSpec(pipeline_id=1, tenant_id=TENANTS[0],
                                    shard_count=1, destination="clickhouse",
                                    config=config(1)),
                       PipelineSpec(pipeline_id=2, tenant_id=TENANTS[1],
                                    shard_count=2, destination="clickhouse",
                                    config=config(2))),
            quotas={TENANTS[0]: TenantQuota(max_shards=2, slo_weight=2.0),
                    TENANTS[1]: TenantQuota(max_shards=2, slo_weight=0.5)})
        await store.update_fleet_spec(spec.to_json())

        state = ApiState(SqliteApiDb(os.path.join(tmp.name, "api.db")),
                         ConfigCipher(EncryptionKey.generate()), orch,
                         fleet_store=store)
        runner = web.AppRunner(build_app(state))
        await runner.setup()
        api_port = bench.free_port()
        await web.TCPSite(runner, "127.0.0.1", api_port).start()

        # -- from empty: A at K = 1, B at K = 2 -----------------------------
        coordinator = FleetReconciler(store=store, runtime=runtime,
                                      scheduler=sched)
        out["initial_resume"] = len(await coordinator.resume())
        t0 = time.perf_counter()
        out["converge_ticks"]["initial"] = await coordinator.converge(
            max_ticks=converge_ticks_max + 1)
        out["converge_s"] = time.perf_counter() - t0
        out["observed_initial"] = await runtime.list_pipelines()
        out["placed_initial"] = place_fleet(spec)
        out["start_s"] = await healthy([ports[1], ports[2], ports[2] + 1])
        out["streaming_s"] = await streaming(
            [apply_slot_name(1), apply_slot_name(2, 0),
             apply_slot_name(2, 1)])
        out["slo_weights"] = {t: sched._slo_for(t) for t in TENANTS}
        t0 = time.perf_counter()
        await until_counted("copy_rows", 4 * copy_rows, 600, "the copies")
        out["copy_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        await wave(1)
        await wave(2)
        await until_counted("cdc_rows", 4 * per, 600, "the first wave")
        out["wave1_s"] = time.perf_counter() - t0
        out["metrics_initial"] = [await scrape(p) for p in (
            ports[1], ports[2], ports[2] + 1)]
        out["fleet_view_initial"] = await fleet_view(api_port)
        pids_b = {k: v for k, v in children.items() if "(2," in k}

        # -- the edit: delete B, resize A to 2, killing the coordinator ----
        spec2 = spec.with_edit(remove=[2], resize={1: 2})
        await store.update_fleet_spec(spec2.to_json())
        t0 = time.perf_counter()
        kills = []
        for window, pid, label in (
                ("post_actuate", 2, "kill_after_actuation"),
                ("pre_actuate", 1, "kill_before_actuation")):
            seen, successor = await kill_in_window(
                store, runtime, window=window, pipeline_id=pid,
                label=label, scheduler=sched)
            kills.append(seen)
        out["kills"] = kills
        out["converge_ticks"]["edit_after_kills"] = \
            await successor.converge(max_ticks=converge_ticks_max + 1)
        # the two killed ticks count against the edit's budget too
        out["converge_ticks"]["edit"] = \
            len(kills) + out["converge_ticks"]["edit_after_kills"]
        out["edit_s"] = time.perf_counter() - t0
        out["observed_edit"] = await runtime.list_pipelines()
        out["placed_edit"] = place_fleet(spec2)
        out["roll_start_s"] = await healthy([ports[1], ports[1] + 1])
        out["roll_streaming_s"] = await streaming(
            [apply_slot_name(1, 0), apply_slot_name(1, 1)])
        out["b_children_left"] = [k for k, p in pids_b.items()
                                  if _alive(p)]
        t0 = time.perf_counter()
        await wave(1)
        await until_counted("cdc_rows", 6 * per, 600, "A's wave at K = 2")
        out["wave2_s"] = time.perf_counter() - t0
        out["metrics_edit"] = [await scrape(p)
                               for p in (ports[1], ports[1] + 1)]
        out["fleet_view_edit"] = await fleet_view(api_port)
        out["journal"] = await _journal_tally(store)
        out["actuations"] = list(runtime.actuation_log)

        # -- the end: remove A; nothing placed, nothing listed --------------
        spec3 = spec2.with_edit(remove=[1])
        await store.update_fleet_spec(spec3.to_json())
        out["converge_ticks"]["remove"] = await successor.converge(
            max_ticks=converge_ticks_max + 1)
        out["observed_end"] = await runtime.list_pipelines()
        out["placed_end"] = place_fleet(spec3)
        out["journal_end"] = await _journal_tally(store)
        out["actuations_end"] = len(runtime.actuation_log)
        report = await acall(fake, "report")
        per_table: dict = {}
        for name, t in report["tables"].items():
            keys = list(zip(t["lsn"].tolist(), t["ordinal"].tolist()))
            per_table[name] = {"copy_rows": int(t["by_lsn"].get(0, [0, 0])[0]),
                               "cdc_rows": len(keys),
                               "distinct_keys": len(set(keys))}
        out["per_table"] = per_table
        out["children"] = dict(children)
    finally:
        await orch.shutdown()
        await store.close()
        if runner is not None:
            await runner.cleanup()
        for pair in held:
            pair.close()
        fake.close()
        server.close()
        tmp.cleanup()

    out["child_starts"] = len(out["children"])
    out["children_left"] = [k for k, p in out["children"].items()
                            if _alive(p)]
    # the ClickHouse destination's table names: schema_table, with each
    # `_` of the source names doubled
    want_cdc = {"public_" + names[t].replace("_", "__"): per * waves[pid]
                for pid, tids in tables.items() for t in tids}
    ticks = out["converge_ticks"]
    kills = out["kills"]
    checks = {
        "initial_converged": ticks["initial"] <= converge_ticks_max
        and out["observed_initial"] == out["placed_initial"] == {1: 1, 2: 2},
        "slo_weights_fed": out["slo_weights"]
        == {TENANTS[0]: 2.0, TENANTS[1]: 0.5},
        "initial_device_work_each": all(
            device_work_ok(m) for m in out["metrics_initial"]),
        "fleet_view_initial": out["fleet_view_initial"]["status"] == 200
        and out["fleet_view_initial"]["converged"]
        and out["fleet_view_initial"]["desired_equals_observed"],
        "kill_after_settles": kills[0]["pending_at_kill"] == 1
        and [r["status"] for r in kills[0]["settled"]] == ["applied"]
        and kills[0]["resume_runtime_calls"] == 0
        and kills[0]["second_resume"] == [],
        "kill_before_redrives": kills[1]["pending_at_kill"] == 1
        and [r["status"] for r in kills[1]["settled"]] == ["applied"]
        and kills[1]["resume_runtime_calls"] == 1
        and kills[1]["second_resume"] == [],
        "edit_converged": ticks["edit"] <= converge_ticks_max
        and out["observed_edit"] == out["placed_edit"] == {1: 2},
        "b_stopped": out["b_children_left"] == [],
        "edit_device_work_each": all(
            device_work_ok(m) for m in out["metrics_edit"]),
        "fleet_view_edit": out["fleet_view_edit"]["status"] == 200
        and out["fleet_view_edit"]["converged"]
        and out["fleet_view_edit"]["desired_equals_observed"]
        and out["fleet_view_edit"]["spec_version"] == 2,
        "no_double_actuation": out["journal"]["pending"] == 0
        and len(out["actuations"]) == out["journal"]["applied"]
        and out["actuations_end"] == out["journal_end"]["applied"],
        "removed": ticks["remove"] <= converge_ticks_max
        and out["observed_end"] == out["placed_end"] == {},
        "tables": set(per_table) == set(want_cdc),
        "copy_once": all(t["copy_rows"] == copy_rows
                         for t in per_table.values()),
        "keys_once": all(per_table.get(n, {}).get("cdc_rows") == w
                         == per_table[n]["distinct_keys"]
                         for n, w in want_cdc.items()),
        "no_child_left": out["children_left"] == [] and not orch._procs,
    }
    out["double_actuations"] = len(out["actuations"]) \
        - out["journal"]["applied"]
    out["checks"] = checks
    out["ok"] = all(checks.values())
    return out


async def run_admission_weights(n_events: int = 50_000, *,
                                device: str = "cuda", seed: int = 7,
                                warmup_events: int = 1_000) -> dict:
    """Two tenants' pipelines on `global_admission()` under the bus's
    admission weights (module docstring)."""
    import numpy as np

    from .. import bench
    from ..autoscale.signals import ShardSignals, SignalFrame
    from ..config import (BatchConfig, BatchEngine, PipelineConfig,
                          PoisonConfig, SupervisionConfig)
    from ..fleet import (AdmissionWeightPolicy, FleetSignalBus, FleetSpec,
                         PipelineSpec, TenantQuota)
    from ..ops.pipeline import global_admission, reset_global_admission
    from ..postgres.fake import FakeDatabase, FakeSource
    from ..runtime import Pipeline
    from ..store import NotifyingStore
    from .harness import counts_delta, kernel_counts

    # a fresh process-wide scheduler: this run's tenants are all it holds
    reset_global_admission()
    sched = global_admission()
    out: dict = {"mode": "admission_weights", "device": device,
                 "events": n_events, "tx_size": TX_SIZE}
    counts0 = kernel_counts()
    streams = []
    for i in range(2):
        db = FakeDatabase()
        db.create_table(bench.make_schema().table_schema)
        db.create_publication("pub", [bench.PGBENCH_TID])
        dest = bench._counting_destination()
        store = NotifyingStore()
        pipeline = Pipeline(
            config=PipelineConfig(
                pipeline_id=i + 1, publication_name="pub",
                batch=BatchConfig(max_fill_ms=30,
                                  batch_engine=BatchEngine.CUDA,
                                  device=device),
                supervision=SupervisionConfig(enabled=False),
                poison=PoisonConfig(enabled=False)),
            store=store, destination=dest,
            source_factory=lambda db=db: FakeSource(db))
        streams.append({"db": db, "dest": dest, "store": store,
                        "pipeline": pipeline,
                        "t": bench.pgbench_table(n_events, seed + i,
                                                 first_aid=1)})

    async def wait_rows(s, n: int, timeout_s: float) -> None:
        async def go():
            while s["dest"].rows_delivered < n:
                task = s["pipeline"]._apply_task
                if task is not None and task.done():
                    task.result()
                    raise RuntimeError("pipeline stopped before delivering")
                await asyncio.sleep(0.01)

        await asyncio.wait_for(go(), timeout_s)

    async def produce(s, payloads: list) -> None:
        for lo in range(0, len(payloads), TX_SIZE):
            tx = s["db"].transaction()
            for p in payloads[lo:lo + TX_SIZE]:
                tx.insert_preencoded(bench.PGBENCH_TID, p)
            await tx.commit()
            await asyncio.sleep(0)

    started = []
    try:
        for i, s in enumerate(streams):
            before = set(sched.stats()["tenants"])
            await s["pipeline"].start()
            started.append(s)
            await bench._wait_ready(s["store"], bench.PGBENCH_TID, 120)
            # a warm-up wave off the clock: its first CDC batch registers
            # the pipeline's admission tenant (`cdc-<n>`)
            warm = bench.pgbench_table(warmup_events, seed + 10 + i,
                                       first_aid=n_events + 1)
            await produce(s, bench.table_payloads(warm))
            await wait_rows(s, warmup_events, 120)
            new = sorted(n for n in set(sched.stats()["tenants"]) - before
                         if n.startswith("cdc-"))
            if len(new) != 1:
                raise RuntimeError(f"pipeline {i + 1} registered admission "
                                   f"tenants {new}, wanted one cdc tenant")
            s["tenant"] = new[0]
            s["dest"].events.clear()
            s["base"] = s["dest"].rows_delivered

        # the fleet document names the admission tenants; a quota each
        lag_t, ok_t = streams[0]["tenant"], streams[1]["tenant"]
        spec = FleetSpec(
            spec_version=1,
            pipelines=(PipelineSpec(pipeline_id=1, tenant_id=lag_t),
                       PipelineSpec(pipeline_id=2, tenant_id=ok_t)),
            quotas={lag_t: TenantQuota(slo_weight=1.5),
                    ok_t: TenantQuota(slo_weight=0.5)})
        bus = FleetSignalBus()
        bus.bind_spec(spec)
        policy = AdmissionWeightPolicy(bus)  # the global scheduler
        bus.register(policy)
        actions = []
        for tick in range(1, 4):
            bus.publish(1, SignalFrame(tick=tick, at_s=float(tick), shards=(
                ShardSignals(shard=0, lag_bytes=256 * 1024 * 1024),)))
            bus.publish(2, SignalFrame(tick=tick, at_s=float(tick), shards=(
                ShardSignals(shard=0, lag_bytes=1024),)))
            actions.extend(bus.step())
        out["bus_actions"] = actions
        out["applied_weights"] = dict(policy.applied_weights)
        out["scheduler_slo"] = {t: sched._slo_for(t) for t in (lag_t, ok_t)}

        c0 = kernel_counts()
        t0 = time.perf_counter()
        await asyncio.gather(*(produce(s, bench.table_payloads(s["t"]))
                               for s in streams))
        mid = sched.stats()
        await asyncio.gather(*(wait_rows(s, s["base"] + n_events, 600)
                               for s in streams))
        out["window_s"] = time.perf_counter() - t0
        out["events_per_second"] = 2 * n_events / out["window_s"]
        counts = counts_delta(c0)
        stats = sched.stats()
        out["tenant_stats"] = {t: stats["tenants"].get(t)
                               for t in (lag_t, ok_t)}
        out["tenant_stats_mid"] = {t: mid["tenants"].get(t)
                                   for t in (lag_t, ok_t)}
    finally:
        for s in started:
            if s["pipeline"]._apply_task is not None:
                await s["pipeline"].shutdown_and_wait()
    drained = sched.stats()
    whole = counts_delta(counts0)
    verified = {}
    for i, s in enumerate(streams):
        dest, t = s["dest"], s["t"]
        digest = sum(bench.batch_rows_digest(e[0])
                     for e in dest.events) % (1 << 64)
        aids = np.concatenate([e[0].columns[0].data for e in dest.events]) \
            if dest.events else np.zeros(0, np.int64)
        verified[s["tenant"]] = {
            "rows": int(dest.rows_delivered - s["base"]),
            "distinct_aids": int(len(np.unique(aids))),
            "digest_ok": digest == bench.table_digest(t) % (1 << 64)}
    out["verified"] = verified
    out["kernel_counts"] = counts
    out["kernel_counts_whole_run"] = whole
    out["drained"] = {"in_flight": drained["in_flight"],
                      "tenants": drained["tenants"]}
    on_card = device.split(":")[0] == "cuda"
    lag_w, ok_w = out["applied_weights"].get(lag_t), \
        out["applied_weights"].get(ok_t)
    checks = {
        "boosted": lag_w is not None and lag_w > 1.5
        and out["scheduler_slo"][lag_t] == lag_w,
        "healthy_at_base": ok_w == 0.5 and out["scheduler_slo"][ok_t] == 0.5,
        "weights_in_stats": all(
            out["tenant_stats"][t] is not None
            and out["tenant_stats"][t]["weight"] >= round(w, 3)
            and out["tenant_stats"][t]["grants"] > 0
            for t, w in ((lag_t, lag_w or 0), (ok_t, ok_w or 0))),
        "verified": all(v["rows"] == n_events == v["distinct_aids"]
                        and v["digest_ok"] for v in verified.values()),
        "device_route": whole["device_batches"] > 0,
        "launches": (whole["k1_launches"] == whole["device_batches"]
                     and whole["launches"] == whole["k1_launches"])
        if on_card else whole["launches"] == 0,
        "drained": drained["in_flight"] == 0 and not drained["tenants"],
    }
    out["checks"] = checks
    out["ok"] = all(checks.values())
    return out
