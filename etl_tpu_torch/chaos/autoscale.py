"""Autoscale chaos: closed-loop elasticity under traffic, and a
controller hard-kill mid-rebalance.

Two scenarios, both deterministic per seed (same workload bytes, same
decision trace — the controller is ticked at FIXED points in the
scenario script and the policy bands sit orders of magnitude away from
the operating points, so timing jitter cannot flip a decision):

  autoscale_surge_drain — the elasticity arc end-to-end:
      a K=2 fleet idles under light traffic (controller holds), a
      seeded backlog surge drives the policy over its up band and the
      controller actuates a two-phase rebalance to K=3 WHILE traffic
      flows, the backlog drains, the first post-drain tick must HOLD
      (cooldown), and once the cooldown expires the controller scales
      back to K=2. Zero-loss/bounded-dup invariants hold over the
      union of all three destinations across BOTH transitions.

  autoscale_controller_crash — the controller is hard-killed between
      journal persist and the epoch flip (mid-quiesce), leaving a
      pending journal entry and an in-flight rebalancing record. A
      fresh controller's resume() re-drives the SAME transition with
      the persisted fence, the fleet rolls, invariants hold, no slot
      is leaked (exactly K+1 apply slots exist after the flip), and a
      second resume() is a no-op.

`python -m etl_tpu_torch.chaos --autoscale [--seed N]` replays both.

Copy of the reference's `etl_tpu/chaos/autoscale.py`. The pods are the
port's `Pipeline`s, each decoding through its own `DecodePipeline` on
`device` ("cuda", the card, or "cpu"); each run records the K1 launches
and the device-routed batches of its pods (`k1_launches`,
`device_batches`: equal on the card, K1 0 on the CPU, where the plain
version decodes the device route). The decode workers are held by the
invariant check's join, not by an at-once thread count.
"""

from __future__ import annotations

import asyncio
import random
import time
from dataclasses import dataclass, field

from ..autoscale import (ACTION_DOWN, ACTION_HOLD, ACTION_UP,
                         AutoscaleController, AutoscalePolicy,
                         AutoscalePolicyConfig, StoreSignalSource)
from ..models.lsn import Lsn
from ..postgres.fake import FakeSource
from ..postgres.slots import apply_slot_name, parse_slot_name
from ..sharding import ShardCoordinator, ShardMap
from . import failpoints
from .invariants import (InvariantReport, LeakProbe, check_invariants,
                         view_matches)
from .runner import (RecordingStore, RestartRecord, TracingDestination,
                     _hard_kill, _wait_until, _Workload)
from .scenario import Scenario
from .sharded import SHARDED_TABLES, _UnionDest, _shard_pipeline_config, \
    _wait_shard_ready

#: chaos policy: bands far from both operating points (a ~200 KiB burst
#: vs a 16 KiB up band; a drained backlog of ~0 vs a 4 KiB down band),
#: so the SAME decision fires at the SAME scripted tick every seed
_POLICY = AutoscalePolicyConfig(
    min_shards=2, max_shards=3,
    drain_slo_s=1.0,
    up_backlog_bytes=16 * 1024,
    down_backlog_bytes=4 * 1024,
    up_ticks=2, down_ticks=1,
    cooldown_ticks=3,
    window_frames=8)


@dataclass
class AutoscaleChaosRun:
    scenario: str
    seed: int
    report: InvariantReport = field(default_factory=InvariantReport)
    restarts: list = field(default_factory=list)
    decision_trace: list = field(default_factory=list)
    k_track: list = field(default_factory=list)  # applied K after each tick
    journal: dict = field(default_factory=dict)
    union_matches: bool = False
    duration_s: float = 0.0
    device: str = "cuda"
    k1_launches: int = 0
    device_batches: int = 0
    rebalances: list = field(default_factory=list)  # each applied roll

    @property
    def ok(self) -> bool:
        return self.report.ok

    def describe(self) -> dict:
        return {
            "scenario": self.scenario,
            "seed": self.seed,
            "ok": self.ok,
            "decision_trace": list(self.decision_trace),
            "k_track": list(self.k_track),
            "journal": dict(self.journal),
            "restarts": [r.describe() for r in self.restarts],
            "union_matches": self.union_matches,
            "device": self.device,
            "k1_launches": self.k1_launches,
            "device_batches": self.device_batches,
            "rebalances": list(self.rebalances),
            "invariants": self.report.describe(),
            "duration_s": round(self.duration_s, 3),
        }


class _Fleet:
    """K in-process shard Pipelines over one shared store/source — the
    chaos stand-in for an orchestrator roll. `roll(k)` is what
    Orchestrator.scale_pipeline does to real pods: stop the old fleet,
    start one scoped replicator per shard of the new topology."""

    def __init__(self, db, store, dests, run: AutoscaleChaosRun,
                 device: str = "cuda"):
        self.db = db
        self.device = device
        self.store = store
        self.dests = dests
        self.run = run
        self.pipes: dict[int, object] = {}
        self.k = 0

    async def start(self, k: int) -> None:
        from ..runtime import Pipeline

        for shard in range(k):
            p = Pipeline(config=_shard_pipeline_config(shard, k,
                                                       self.device),
                         store=self.store,
                         destination=self.dests[shard],
                         source_factory=lambda: FakeSource(self.db))
            await p.start()
            self.pipes[shard] = p
        self.k = k

    async def stop(self) -> None:
        for shard in sorted(self.pipes):
            p = self.pipes[shard]
            if p._apply_task is not None:
                await p.shutdown_and_wait()
            resume = await self.store.get_durable_progress(
                apply_slot_name(1, shard))
            self.run.restarts.append(RestartRecord(
                kind="clean", resume_lsn=int(resume or Lsn.ZERO),
                at_tx=0))
        self.pipes.clear()

    async def roll(self, k: int) -> None:
        await self.stop()
        await self.start(k)

    async def wait_ready(self, part: dict) -> None:
        await asyncio.gather(*(
            _wait_shard_ready(self.pipes[s].store, part[s], 30.0,
                              f"shard {s}: tables never ready")
            for s in self.pipes))

    async def wait_delivered(self, part: dict, expected: dict,
                             what: str) -> None:
        for s in self.pipes:
            await _wait_until(
                lambda s=s: view_matches(
                    self.dests[s], part[s],
                    {tid: expected[tid] for tid in part[s]}),
                30.0, f"{what}: shard {s} never delivered its slice")

    async def wait_union(self, table_ids, expected: dict,
                         what: str) -> None:
        """Post-rebalance convergence: rows committed BEFORE a fence
        live at the table's OLD owner's destination, so per-shard slice
        checks cannot pass after a move — the union of every
        destination against the committed truth is the oracle (the
        sharding handoff test's stance)."""
        await _wait_until(
            lambda: view_matches(
                _UnionDest([self.dests[s] for s in sorted(self.dests)]),
                table_ids, expected),
            30.0, f"{what}: union never converged")


def _make_controller(store, db, fleet: "_Fleet | None",
                     run: AutoscaleChaosRun) -> AutoscaleController:
    holder = {"k": 2}

    async def on_scale(from_k: int, to_k: int, result) -> None:
        holder["k"] = to_k
        run.rebalances.append({"from_k": from_k, "to_k": to_k,
                               "seconds": result.duration_s,
                               "moved_tables": len(result.moved)})
        if fleet is not None:
            await fleet.roll(to_k)

    coordinator = ShardCoordinator(store, 1, lambda: FakeSource(db),
                                   quiesce_timeout_s=30.0,
                                   poll_interval_s=0.02)
    controller = AutoscaleController(
        store=store, pipeline_id=1,
        collector=StoreSignalSource(
            store, 1, lambda: FakeSource(db),
            shard_count_reader=lambda: holder["k"]),
        coordinator=coordinator,
        policy=AutoscalePolicy(_POLICY),
        scale_listener=on_scale)
    controller._holder = holder  # the chaos script reads applied K
    return controller


async def _tick(controller: AutoscaleController, tick_no: int,
                run: AutoscaleChaosRun):
    decision = await controller.tick(float(tick_no))
    run.decision_trace.append(
        {"tick": decision.tick, "action": decision.action,
         "k": f"{decision.current_k}->{decision.target_k}"})
    run.k_track.append(controller._holder["k"])
    return decision


async def _surge(workload: _Workload, db, txs: int) -> None:
    """Commit a burst without waiting for drain: the backlog the policy
    must react to. Tight loop — the apply loops get only the awaits
    inside commit, so most of the burst is still undrained after."""
    for _ in range(txs):
        await workload.run_tx(db)


async def _drive_through(task: asyncio.Task, workload: _Workload, db,
                         txs: int, what: str) -> None:
    """Keep traffic flowing WHILE an actuation runs: a fixed tx count
    (determinism), then wait the actuation out. The commits push every
    shard's durable progress past the fence — the quiesce completes
    because the system keeps working, not because the world stopped."""
    for _ in range(txs):
        await workload.run_tx(db)
        await asyncio.sleep(0.05)
    try:
        await asyncio.wait_for(task, 30.0)
    except Exception as e:
        raise RuntimeError(f"{what} failed") from e


async def _wait_backlog_drained(controller: AutoscaleController,
                                limit_bytes: int) -> None:
    """Gate the post-drain ticks on the SIGNAL the policy reads (not on
    destination contents): sampled aggregate backlog under the limit.
    Probe frames are NOT recorded into the controller's timeline."""

    async def drained() -> bool:
        frame = await controller.collector.sample(-1.0)
        controller.collector._tick -= 1  # probe, not a timeline tick
        return frame.aggregate_backlog_bytes <= limit_bytes

    deadline = time.monotonic() + 30.0
    while not await drained():
        if time.monotonic() >= deadline:
            raise TimeoutError("backlog never drained under "
                               f"{limit_bytes} bytes")
        await asyncio.sleep(0.05)


def _kernel_counts() -> tuple:
    from ..ops import decode_kernel, engine

    return decode_kernel.launches, engine.routed_device_batches


async def run_autoscale_surge_drain(seed: int = 7, device: str = "cuda"
                                    ) -> AutoscaleChaosRun:
    """The end-to-end elasticity arc (module docstring)."""
    failpoints.disarm_all()
    run = AutoscaleChaosRun(scenario="autoscale_surge_drain", seed=seed,
                            device=device)
    t_start = time.monotonic()
    counts0 = _kernel_counts()
    leak_probe = LeakProbe.capture()
    shape = Scenario(name="autoscale", description="surge/drain",
                     tables=SHARDED_TABLES, rows_per_table=3,
                     txs=64, rows_per_tx=120)
    workload = _Workload(shape, random.Random(seed))
    db = workload.build_db()
    store = RecordingStore()
    dests = {s: TracingDestination() for s in range(3)}
    fleet = _Fleet(db, store, dests, run, device)
    controller = _make_controller(store, db, fleet, run)
    part2 = ShardMap(2).partition(workload.table_ids)
    part3 = ShardMap(3).partition(workload.table_ids)
    try:
        if any(not t for t in part2.values()) \
                or any(not t for t in part3.values()):
            run.report.fail("degenerate shard map: empty shard at K=2 or "
                            "K=3 — grow the table set")
            return run
        await fleet.start(2)
        await fleet.wait_ready(part2)
        tick = 0

        # quiet baseline: two ticks, both must hold at K=2
        for _ in range(2):
            await _surge(workload, db, 1)
            await fleet.wait_delivered(part2, workload.expected,
                                       "baseline")
            d = await _tick(controller, tick, run)
            tick += 1
            if d.action != ACTION_HOLD:
                run.report.fail(f"baseline tick {d.tick} decided "
                                f"{d.action}, expected hold")

        # the surge: a burst far over the up band, committed without
        # waiting for drain; two ticks build the sustained up votes and
        # the second one ACTUATES K=2->3 while traffic keeps flowing
        await _surge(workload, db, 16)
        d = await _tick(controller, tick, run)
        tick += 1
        if d.action != ACTION_HOLD:
            run.report.fail(f"tick {d.tick}: scale-up before the "
                            f"sustained-votes threshold")
        up_task = asyncio.ensure_future(_tick(controller, tick, run))
        tick += 1
        await _drive_through(up_task, workload, db, 6, "scale-up tick")
        d = up_task.result()
        if d.action != ACTION_UP or d.target_k != 3:
            run.report.fail(f"surge tick {d.tick} decided {d.action} "
                            f"(target {d.target_k}), expected 2->3")
        assignment = await store.get_shard_assignment()
        if assignment.shard_count != 3 or assignment.epoch != 1:
            run.report.fail(f"assignment after scale-up: {assignment}")
        await fleet.wait_ready(part3)

        # drain: the fleet catches up completely (backlog samples to
        # ZERO — the fake's WAL position is the last commit end, so a
        # fully-flushed fleet has durable == wal end exactly); the next
        # two ticks land inside the cooldown window and must hold even
        # though the down votes are already there
        await fleet.wait_union(workload.table_ids, workload.expected,
                               "drain")
        await _wait_backlog_drained(controller, 0)
        for _ in range(_POLICY.cooldown_ticks - 1):
            d = await _tick(controller, tick, run)
            tick += 1
            if d.action != ACTION_HOLD or "cooldown" not in d.reason:
                run.report.fail(
                    f"tick {d.tick}: expected a cooldown hold after the "
                    f"scale-up, got {d.action} ({d.reason})")

        # cooldown expires -> sustained quiet under the down band ->
        # scale back to K=2 (the retiring shard is already durable at
        # the fence, so the quiesce completes without extra traffic)
        down = await _tick(controller, tick, run)
        tick += 1
        if down.action != ACTION_DOWN or down.target_k != 2:
            run.report.fail(f"tick {down.tick}: expected scale-down "
                            f"3->2, got {down.action} ({down.reason})")
        else:
            assignment = await store.get_shard_assignment()
            if assignment.shard_count != 2 or assignment.epoch != 2:
                run.report.fail(
                    f"assignment after scale-down: {assignment}")
            await fleet.wait_ready(part2)

        # finish the workload at K=2 and converge
        while workload.tx_index < shape.txs:
            await workload.run_tx(db)
        await fleet.wait_union(workload.table_ids, workload.expected,
                               "final")
        run.journal = (await store.get_autoscale_journal()) or {}
        await fleet.stop()
    except Exception as e:
        run.report.fail(f"scenario crashed: {e!r}")
    finally:
        failpoints.release_stalls()
        from ..ops import engine

        engine.clear_forced_oracle()
        for p in fleet.pipes.values():
            await _hard_kill(p)
        for dst in dests.values():
            await dst.shutdown()
        run.duration_s = time.monotonic() - t_start
        k1, batches = _kernel_counts()
        run.k1_launches = k1 - counts0[0]
        run.device_batches = batches - counts0[1]

    _finish(run, workload, dests, store, leak_probe)
    # the journal must agree with the trace: exactly one up + one down,
    # both applied (a pending entry here would mean a leaked decision)
    entries = run.journal.get("entries", [])
    applied = [(e["action"], e["from_k"], e["to_k"]) for e in entries
               if e.get("status") == "applied"]
    if applied != [("scale_up", 2, 3), ("scale_down", 3, 2)]:
        run.report.fail(f"journal does not record the up/down pair as "
                        f"applied: {entries}")
    # the bit-identity evidence: the tick script is fixed and the policy
    # bands sit orders of magnitude from the operating points, so the
    # decision trace is the same exact sequence every run of a seed
    actions = [d["action"] for d in run.decision_trace]
    want = (["hold"] * 3 + ["scale_up"]
            + ["hold"] * (_POLICY.cooldown_ticks - 1) + ["scale_down"])
    if actions != want:
        run.report.fail(f"decision trace diverged: {actions} != {want}")
    return run


async def run_autoscale_controller_crash(seed: int = 7,
                                         device: str = "cuda"
                                         ) -> AutoscaleChaosRun:
    """Hard-kill the controller mid-actuation; a successor resumes via
    the persisted journal (module docstring)."""
    failpoints.disarm_all()
    run = AutoscaleChaosRun(scenario="autoscale_controller_crash",
                            seed=seed, device=device)
    t_start = time.monotonic()
    counts0 = _kernel_counts()
    leak_probe = LeakProbe.capture()
    shape = Scenario(name="autoscale-crash", description="crash",
                     tables=SHARDED_TABLES, rows_per_table=3,
                     txs=48, rows_per_tx=120)
    workload = _Workload(shape, random.Random(seed))
    db = workload.build_db()
    store = RecordingStore()
    dests = {s: TracingDestination() for s in range(3)}
    fleet = _Fleet(db, store, dests, run, device)
    part2 = ShardMap(2).partition(workload.table_ids)
    part3 = ShardMap(3).partition(workload.table_ids)
    controller = _make_controller(store, db, fleet, run)
    try:
        await fleet.start(2)
        await fleet.wait_ready(part2)
        await _surge(workload, db, 2)
        await fleet.wait_delivered(part2, workload.expected, "baseline")
        d = await _tick(controller, 0, run)
        if d.action != ACTION_HOLD:
            run.report.fail(f"baseline decided {d.action}")

        # surge, build votes, then let the actuating tick start its
        # two-phase rebalance — and hard-kill it mid-quiesce, AFTER the
        # in-flight record persisted (the burst is undrained, so the
        # quiesce cannot have completed)
        await _surge(workload, db, 16)
        await _tick(controller, 1, run)  # first vote (hold)
        kill_task = asyncio.ensure_future(_tick(controller, 2, run))
        deadline = time.monotonic() + 15.0
        while True:
            assignment = await store.get_shard_assignment()
            if assignment is not None and assignment.rebalancing:
                break
            if kill_task.done():
                raise RuntimeError(
                    "actuation finished before the kill window — "
                    "quiesce completed against an undrained burst?")
            if time.monotonic() >= deadline:
                raise TimeoutError("rebalancing record never persisted")
            await asyncio.sleep(0.01)
        kill_task.cancel()  # the controller process dies here
        try:
            await kill_task
        except (asyncio.CancelledError, Exception):
            pass
        run.restarts.append(RestartRecord(
            kind="crash", resume_lsn=0, at_tx=workload.tx_index))

        journal = (await store.get_autoscale_journal()) or {}
        pending = [e for e in journal.get("entries", [])
                   if e.get("status") == "pending"]
        if len(pending) != 1 or pending[0]["to_k"] != 3:
            run.report.fail(f"expected exactly one pending K=2->3 "
                            f"journal entry after the kill: {journal}")

        # a fresh controller (the restarted process) resumes: the SAME
        # transition completes with the persisted fence while traffic
        # flows, and the fleet rolls onto K=3
        successor = _make_controller(store, db, fleet, run)
        resume_task = asyncio.ensure_future(successor.resume())
        await _drive_through(resume_task, workload, db, 6, "resume")
        settled = resume_task.result()
        if settled is None or settled.status != "applied":
            run.report.fail(f"resume() did not settle the pending "
                            f"decision: {settled}")
        assignment = await store.get_shard_assignment()
        if assignment.shard_count != 3 or assignment.epoch != 1 \
                or assignment.rebalancing:
            run.report.fail(f"assignment after resume: {assignment}")
        await fleet.wait_ready(part3)

        # no leaked slots: exactly one apply slot per shard of the new
        # topology — a resume that re-created the fence slot instead of
        # adopting it would show up here
        apply_slots = [n for n in db.slots
                       if (p := parse_slot_name(n)) is not None
                       and p.is_apply]
        if len(apply_slots) != 3:
            run.report.fail(f"expected 3 apply slots after the resumed "
                            f"flip, found {sorted(db.slots)}")

        # resume is idempotent: nothing pending, second call is a no-op
        if await successor.resume() is not None:
            run.report.fail("second resume() re-ran a settled decision")

        while workload.tx_index < shape.txs:
            await workload.run_tx(db)
        await fleet.wait_union(workload.table_ids, workload.expected,
                               "final")
        run.journal = (await store.get_autoscale_journal()) or {}
        await fleet.stop()
    except Exception as e:
        run.report.fail(f"scenario crashed: {e!r}")
    finally:
        failpoints.release_stalls()
        from ..ops import engine

        engine.clear_forced_oracle()
        for p in fleet.pipes.values():
            await _hard_kill(p)
        for dst in dests.values():
            await dst.shutdown()
        run.duration_s = time.monotonic() - t_start
        k1, batches = _kernel_counts()
        run.k1_launches = k1 - counts0[0]
        run.device_batches = batches - counts0[1]

    _finish(run, workload, dests, store, leak_probe)
    return run


def _finish(run: AutoscaleChaosRun, workload: _Workload, dests,
            store, leak_probe: LeakProbe) -> None:
    """Shared epilogue: thread drain, union reconstruction, invariants
    over the union of every destination (tables move between shards
    across epochs, so per-shard slices are epoch-dependent — the union
    vs committed truth is the loss/dup oracle, exactly the sharded
    scenario's cross-shard stance). The leak check joins the pods'
    decode workers."""
    union = _UnionDest([dests[s] for s in sorted(dests)])
    run.union_matches = view_matches(union, workload.table_ids,
                                     workload.expected)
    if not run.union_matches:
        run.report.fail("union of shard destinations does not "
                        "reconstruct the committed source truth")
    check_invariants(
        expected=workload.expected, dest=union, store=store,
        restarts=run.restarts, fault_firings=0, leak_probe=leak_probe,
        report=run.report)
