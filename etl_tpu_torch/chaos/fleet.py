"""Fleet chaos: 100 pipelines, one coordinator, hard kills mid-roll.

`python -m etl_tpu_torch.chaos --fleet` — the reconcile-under-chaos proof the
fleet subsystem ships with (docs/fleet.md). One seeded run drives the
whole story, deterministic per seed:

  1. EMPTY → STEADY: a 100-pipeline FleetSpec (tenancy profiles = the
     workload-mix names, quotas that visibly clamp two tenants) lands
     on an empty simulated fleet; the reconciler must converge within
     `CONVERGE_TICKS_MAX` working ticks and the observed fleet must
     EQUAL the quota-clamped placement.
  2. SPEC EDITS: remove / add / resize in one versioned edit; converge
     again; per-pipeline delivery invariants (zero loss, dup ≤
     1 + rolls) hold through the rolls.
  3. KILL MID-ROLL, twice — the two crash windows the actuation
     journal distinguishes:
       - crash BEFORE actuation: the coordinator dies after persisting
         the pending record, before the runtime verb ran. The
         successor's resume must RE-DRIVE the verb (observed ≠ target)
         and settle it.
       - crash AFTER actuation: the coordinator dies after the runtime
         verb landed, before the settle write. The successor must
         settle from OBSERVATION alone — zero runtime calls.
     After each kill: a second resume() must find nothing (idempotent),
     and the global ledger must balance: every runtime actuation in the
     log maps 1:1 to an APPLIED journal record — `double_actuations ==
     len(actuation_log) − applied_records == 0`.
  4. SIGNAL BUS: the three policy plugins (PID lag-target, adaptive
     ack-depth, admission SLO weights) run over synthetic per-pipeline
     frames on one bus; the scenario asserts the PID recommends scale-up
     for the lagging pipeline, the ack-depth plugin retargets a live
     AckWindow from the measured histogram, and the spec's quota weights
     (boosted for the lagging tenant) reach the AdmissionScheduler.
  5. LEAK CHECKS via the list-pipelines primitive: observed ids ==
     placed ids exactly — nothing the spec dropped survives, nothing
     phantom appears, retired pipelines stay retired.
"""

from __future__ import annotations

import asyncio
from dataclasses import dataclass, field

from ..autoscale.signals import ShardSignals, SignalFrame
from ..fleet import (AckDepthConfig, AdaptiveAckDepthPolicy,
                     AdmissionWeightPolicy, FleetReconciler,
                     FleetSignalBus, PidLagPolicy, SimulatedFleetRuntime,
                     seeded_fleet_spec)
from ..fleet.reconciler import place_fleet
from ..fleet.spec import PipelineSpec
from ..ops.pipeline import AdmissionScheduler
from ..runtime.ack_window import CopyAckWindow
from ..store.memory import MemoryStore

#: working-tick convergence bound — one tick applies every diffed verb,
#: so a healthy reconcile converges in ONE working tick per spec change;
#: 3 leaves room for held pipelines without masking a livelock
CONVERGE_TICKS_MAX = 3

FLEET_SIZE = 100


@dataclass
class FleetChaosRun:
    """Everything `--fleet` prints, ok iff no failure was recorded."""

    seed: int
    fleet_size: int = 0
    converge_ticks: "dict[str, int]" = field(default_factory=dict)
    actuations: int = 0
    applied_records: int = 0
    double_actuations: int = 0
    resume_modes: "list[str]" = field(default_factory=list)
    bus_actions: "dict[str, int]" = field(default_factory=dict)
    failures: "list[str]" = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.failures

    def expect(self, cond: bool, message: str) -> None:
        if not cond:
            self.failures.append(message)

    def describe(self) -> dict:
        return {
            "scenario": "fleet_reconcile_chaos",
            "seed": self.seed,
            "fleet_size": self.fleet_size,
            "converge_ticks": dict(self.converge_ticks),
            "actuations": self.actuations,
            "applied_records": self.applied_records,
            "double_actuations": self.double_actuations,
            "resume_modes": list(self.resume_modes),
            "bus_actions": dict(self.bus_actions),
            "failures": list(self.failures),
            "ok": self.ok,
        }


async def _applied_records(store) -> int:
    journals = await store.get_fleet_journals()
    return sum(1 for doc in journals.values()
               for e in doc.get("entries", [])
               if e.get("status") == "applied")


async def _pending_records(store) -> int:
    journals = await store.get_fleet_journals()
    return sum(1 for doc in journals.values()
               for e in doc.get("entries", [])
               if e.get("status") == "pending")


async def _check_steady(run: FleetChaosRun, label: str, store, runtime,
                        spec) -> None:
    """The post-convergence ledger: observed == placement (the leak
    check, through the list-pipelines primitive), zero pendings, zero
    double-actuations, per-pipeline delivery invariants."""
    observed = await runtime.list_pipelines()
    targets = place_fleet(spec)
    run.expect(observed == targets,
               f"{label}: observed fleet != placement "
               f"({len(observed)} vs {len(targets)} pipelines)")
    leaked = set(observed) - set(targets)
    run.expect(not leaked, f"{label}: leaked pipelines {sorted(leaked)}")
    run.expect(await _pending_records(store) == 0,
               f"{label}: pending journal records after convergence")
    applied = await _applied_records(store)
    run.actuations = len(runtime.actuation_log)
    run.applied_records = applied
    run.double_actuations = len(runtime.actuation_log) - applied
    run.expect(run.double_actuations == 0,
               f"{label}: {run.double_actuations} runtime actuations "
               f"not backed by an applied journal record")
    for violation in runtime.violations():
        run.failures.append(f"{label}: {violation}")


async def _kill_mid_roll(run: FleetChaosRun, *, store, runtime, spec,
                         window: str, pipeline_id: int, to_k: int,
                         label: str) -> None:
    """Hard-kill the coordinator inside one crash window of pipeline
    `pipeline_id`'s resize, then drive a successor through resume +
    converge and assert the ledger balanced."""
    edited = spec.with_edit(resize={pipeline_id: to_k})
    await store.update_fleet_spec(edited.to_json())
    blocked = asyncio.Event()

    async def hook(verb: str, pid: int) -> None:
        if pid == pipeline_id:
            blocked.set()
            await asyncio.Event().wait()  # park until cancelled

    setattr(runtime, window, hook)
    coordinator = FleetReconciler(store=store, runtime=runtime)
    task = asyncio.ensure_future(coordinator.tick())
    await asyncio.wait_for(blocked.wait(), timeout=10)
    # the pending record is already durable — that ordering IS
    # persist-then-actuate; assert it before the kill
    run.expect(await _pending_records(store) == 1,
               f"{label}: expected exactly one pending record at kill")
    task.cancel()
    try:
        await task
    except asyncio.CancelledError:
        pass
    setattr(runtime, window, None)

    successor = FleetReconciler(store=store, runtime=runtime)
    settled = await successor.resume()
    run.expect(len(settled) == 1,
               f"{label}: successor settled {len(settled)} records, "
               f"wanted 1")
    mode = "settle" if window == "post_actuate" else "redrive"
    run.resume_modes.append(f"{label}:{mode}")
    again = await successor.resume()
    run.expect(again == [],
               f"{label}: second resume() settled records — not "
               f"idempotent")
    ticks = await successor.converge()
    run.converge_ticks[label] = ticks
    run.expect(ticks <= CONVERGE_TICKS_MAX,
               f"{label}: converge took {ticks} working ticks "
               f"(max {CONVERGE_TICKS_MAX})")
    observed = await runtime.list_pipelines()
    run.expect(observed.get(pipeline_id) == to_k,
               f"{label}: pipeline {pipeline_id} at "
               f"K={observed.get(pipeline_id)}, wanted {to_k}")
    await _check_steady(run, label, store, runtime, edited)


def _drive_bus(run: FleetChaosRun, spec) -> None:
    """Phase 4: the three control loops as plugins on one bus."""
    scheduler = AdmissionScheduler(capacity=4)
    window = CopyAckWindow(limit=2)
    bus = FleetSignalBus()
    bus.bind_spec(spec)
    pid_policy = PidLagPolicy()
    # a seeded-synthetic ack histogram: 24 acks of 400ms against a 50ms
    # flush cadence wants depth ceil(0.4/0.05)+1 = 9
    depth_policy = AdaptiveAckDepthPolicy(
        window_of=lambda pid: window,
        histogram_read=lambda: (24, 24 * 0.4),
        config=AckDepthConfig())
    weight_policy = AdmissionWeightPolicy(bus, scheduler=scheduler)
    for plugin in (pid_policy, depth_policy, weight_policy):
        bus.register(plugin)

    lagging = spec.pipelines[0]
    healthy = spec.pipelines[1]
    for tick in range(1, 4):
        bus.publish(lagging.pipeline_id, SignalFrame(
            tick=tick, at_s=float(tick), shards=tuple(
                ShardSignals(shard=s, lag_bytes=256 * 1024 * 1024)
                for s in range(lagging.shard_count))))
        bus.publish(healthy.pipeline_id, SignalFrame(
            tick=tick, at_s=float(tick), shards=tuple(
                ShardSignals(shard=s, lag_bytes=1024)
                for s in range(healthy.shard_count))))
        actions = bus.step()
        for a in actions:
            run.bus_actions[a["plugin"]] = \
                run.bus_actions.get(a["plugin"], 0) + 1

    rec = pid_policy.recommendations.get(lagging.pipeline_id)
    run.expect(rec is not None and rec > lagging.shard_count,
               f"bus: PID never recommended scale-up for the lagging "
               f"pipeline (got {rec})")
    run.expect(healthy.pipeline_id not in pid_policy.recommendations,
               "bus: PID recommended a resize for the healthy pipeline")
    run.expect(window.effective_limit() == 9,
               f"bus: ack window depth {window.effective_limit()}, "
               f"wanted 9 from the measured histogram")
    lag_tenant = lagging.tenant_id
    weight = weight_policy.applied_weights.get(lag_tenant)
    base = spec.quotas.get(lag_tenant)
    base_w = base.slo_weight if base else 1.0
    run.expect(weight is not None and weight > base_w,
               f"bus: lagging tenant weight {weight} not boosted over "
               f"base {base_w}")
    # the healthy tenant's weight lands UNboosted at its quota base
    ok_tenant = healthy.tenant_id
    ok_quota = spec.quotas.get(ok_tenant)
    ok_base = ok_quota.slo_weight if ok_quota else 1.0
    got = weight_policy.applied_weights.get(ok_tenant)
    run.expect(got is not None and abs(got - ok_base) < 1e-9,
               f"bus: healthy tenant weight {got}, wanted base {ok_base}")


async def run_fleet_chaos(seed: int = 7,
                          fleet_size: int = FLEET_SIZE) -> FleetChaosRun:
    run = FleetChaosRun(seed=seed, fleet_size=fleet_size)
    store = MemoryStore()
    runtime = SimulatedFleetRuntime(seed=seed)
    spec = seeded_fleet_spec(seed, fleet_size)
    await store.update_fleet_spec(spec.to_json())

    # phase 1: empty → steady
    coordinator = FleetReconciler(store=store, runtime=runtime)
    run.expect(await coordinator.resume() == [],
               "initial resume() settled records on a fresh fleet")
    ticks = await coordinator.converge()
    run.converge_ticks["initial"] = ticks
    run.expect(ticks <= CONVERGE_TICKS_MAX,
               f"initial converge took {ticks} working ticks "
               f"(max {CONVERGE_TICKS_MAX})")
    await _check_steady(run, "initial", store, runtime, spec)

    # phase 2: one versioned edit — remove, add, resize together
    removed = [1, 2, 3]
    added = [PipelineSpec(pipeline_id=fleet_size + 100 + i,
                          tenant_id="tenant-burst", shard_count=2,
                          profile="tiny_txs") for i in range(3)]
    resized = {10: 6, 11: 1}
    spec = spec.with_edit(add=added, remove=removed, resize=resized)
    await store.update_fleet_spec(spec.to_json())
    ticks = await coordinator.converge()
    run.converge_ticks["edit"] = ticks
    run.expect(ticks <= CONVERGE_TICKS_MAX,
               f"edit converge took {ticks} working ticks "
               f"(max {CONVERGE_TICKS_MAX})")
    observed = await runtime.list_pipelines()
    for pid in removed:
        run.expect(pid not in observed,
                   f"edit: removed pipeline {pid} still running")
    for p in added:
        run.expect(observed.get(p.pipeline_id) == p.shard_count,
                   f"edit: added pipeline {p.pipeline_id} not at "
                   f"K={p.shard_count}")
    await _check_steady(run, "edit", store, runtime, spec)

    # phase 3: the two crash windows. Kill targets are pipelines of
    # UNclamped tenants (seeded K is 1..4, targets 5/6 differ for sure):
    # a quota-clamped tenant's resize can be a placement no-op, and a
    # roll that diffs to nothing has no crash window to kill in.
    await _kill_mid_roll(run, store=store, runtime=runtime, spec=spec,
                         window="pre_actuate", pipeline_id=23, to_k=6,
                         label="kill_before_actuation")
    spec = spec.with_edit(resize={23: 6})  # re-anchor to the store's truth
    await _kill_mid_roll(run, store=store, runtime=runtime, spec=spec,
                         window="post_actuate", pipeline_id=24, to_k=5,
                         label="kill_after_actuation")

    # phase 4: the signal bus plugins
    _drive_bus(run, spec.with_edit(resize={24: 5}))
    return run
