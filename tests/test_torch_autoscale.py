"""The port's autoscale controller (`etl_tpu_torch/autoscale/`,
`chaos/autoscale.py`) held to the reference's tests: the classes of
`tests/test_autoscale.py` run on the port's modules — policy properties,
signals, the journal on MemoryStore and SqliteStore, the controller
against stub coordinators, admission SLO weights, the orchestrator scale
seam, the replay CLI, the bench gate (the port's `benchmarks.harness.
run_autoscale_bench`; the root `bench.py` is the reference's) and both
chaos scenarios with the decoders on the CPU — and then the port against
the reference itself on the same seeded inputs: `simulate` traces for
seeds 0-9, seeded timelines, journals, the replay CLI's output and the
bench report, all equal; the controller crash beside busy processes,
time-boxed.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_autoscale.py -q

Tolerance: exact (the policy is integer and float arithmetic on the same
inputs in the same order), apart from wall clock.
"""

from __future__ import annotations

import asyncio
import json
import random

import pytest

from etl_tpu_torch.autoscale import (ACTION_DOWN, ACTION_HOLD, ACTION_UP,
                               AutoscaleController, AutoscaleJournal,
                               AutoscalePolicy, AutoscalePolicyConfig,
                               DecisionRecord, RegistrySignalSource,
                               STATUS_APPLIED, STATUS_PENDING,
                               ShardSignals, SignalFrame, SignalTimeline,
                               seeded_surge_timeline)
from etl_tpu_torch.autoscale.controller import STATUS_ABORTED
from etl_tpu_torch.autoscale.policy import simulate
from etl_tpu_torch.models.errors import ErrorKind, EtlError
from etl_tpu_torch.sharding import ShardAssignment
from etl_tpu_torch.sharding.shardmap import STATUS_REBALANCING, STATUS_STEADY
from etl_tpu_torch.store import MemoryStore


def frame(tick: int, lags, durables=None, *, pressure=False,
          healthy=True, at_s=None) -> SignalFrame:
    durables = durables or [0] * len(lags)
    return SignalFrame(
        tick=tick, at_s=float(tick if at_s is None else at_s),
        shards=tuple(
            ShardSignals(shard=s, lag_bytes=lag, durable_lsn=dur,
                         memory_pressure=pressure, healthy=healthy)
            for s, (lag, dur) in enumerate(zip(lags, durables))))


def steady_history(ticks: int, lag_per_shard: int, shards: int = 2,
                   drain_rate: int = 1000) -> list:
    """`ticks` frames at a constant backlog with a constant observed
    drain rate — fixed capacity evidence for the rate-model tests."""
    return [frame(t, [lag_per_shard] * shards,
                  [t * drain_rate] * shards) for t in range(ticks)]


CFG = AutoscalePolicyConfig(
    min_shards=1, max_shards=8, drain_slo_s=10.0,
    up_backlog_bytes=100_000, down_backlog_bytes=10_000,
    up_ticks=2, down_ticks=2, cooldown_ticks=4,
    capacity_floor_bytes_per_s=1000.0)


class TestPolicyProperties:
    def test_config_validation(self):
        with pytest.raises(EtlError):
            AutoscalePolicyConfig(min_shards=0).validate()
        with pytest.raises(EtlError):
            AutoscalePolicyConfig(max_shards=1, min_shards=2).validate()
        with pytest.raises(EtlError):  # inverted hysteresis bands
            AutoscalePolicyConfig(up_backlog_bytes=10,
                                  down_backlog_bytes=20).validate()
        with pytest.raises(EtlError):
            AutoscalePolicyConfig(drain_slo_s=0).validate()

    def test_monotone_response(self):
        """More backlog never lowers the target: raw_target is monotone
        in backlog at fixed capacity, and the applied decision never
        moves DOWN while a larger backlog would have moved it UP."""
        policy = AutoscalePolicy(CFG)
        targets = []
        decisions = []
        for backlog in range(0, 2_000_000, 50_000):
            targets.append(policy.raw_target(backlog, 1000.0))
            hist = steady_history(4, backlog // 2)
            decisions.append(policy.evaluate(hist, 2, None))
        assert targets == sorted(targets)
        # decision monotonicity: the applied target as a function of
        # backlog is non-decreasing too (hold=2, up=3; never down at
        # high backlog after an up at lower backlog)
        applied = [d.target_k for d in decisions]
        for a, b in zip(applied, applied[1:]):
            assert b >= a or b >= 2, (applied,)

    def test_hysteresis_dead_zone_never_flaps(self):
        """A noisy signal oscillating INSIDE the band gap decides
        nothing, ever — the dead zone is the no-flap guarantee."""
        rng = random.Random(13)
        frames = [frame(t, [rng.randrange(
            CFG.down_backlog_bytes // 2 + 1, CFG.up_backlog_bytes // 2)
            for _ in range(2)]) for t in range(50)]
        decisions = simulate(frames, AutoscalePolicy(CFG), 2)
        assert all(d.action == ACTION_HOLD for d in decisions)

    def test_noisy_band_edge_never_flaps(self):
        """Seeded noise oscillating ACROSS the up band edge every other
        tick never scales up: the sustained-votes threshold (up_ticks=2
        consecutive frames) filters single-frame spikes."""
        policy = AutoscalePolicy(CFG)
        frames = []
        for t in range(60):
            over = t % 2 == 0
            per_shard = (CFG.up_backlog_bytes // 2 + 5_000) if over \
                else (CFG.up_backlog_bytes // 2 - 5_000)
            frames.append(frame(t, [per_shard, per_shard]))
        decisions = simulate(frames, policy, 2)
        assert all(d.action == ACTION_HOLD for d in decisions)

    def test_sustained_surge_scales_up_max_step(self):
        policy = AutoscalePolicy(CFG)
        frames = [frame(t, [500_000, 500_000]) for t in range(4)]
        d = policy.evaluate(frames, 2, None)
        assert d.action == ACTION_UP
        assert d.target_k == 3  # K -> K+1, never a jump
        assert d.raw_target_k > 3  # the rate model wanted more

    def test_cooldown_enforced(self):
        """After an applied decision, no further decision until
        cooldown_ticks evaluations pass — even with the votes there."""
        policy = AutoscalePolicy(CFG)
        frames = [frame(t, [500_000, 500_000]) for t in range(12)]
        history = []
        last = None
        decided_at = []
        k = 2
        for f in frames:
            history.append(f)
            d = policy.evaluate(history, k, last)
            if d.action != ACTION_HOLD:
                decided_at.append(d.tick)
                k = d.target_k
                last = d.tick
        assert decided_at, "surge never decided"
        for a, b in zip(decided_at, decided_at[1:]):
            assert b - a >= CFG.cooldown_ticks
        # and the holds in between say why
        d = policy.evaluate(frames[:decided_at[0] + 2], 3, decided_at[0])
        assert d.action == ACTION_HOLD and "cooldown" in d.reason

    def test_scale_down_needs_quiet_and_rate_model_agreement(self):
        policy = AutoscalePolicy(CFG)
        quiet = [frame(t, [100, 100], [t * 1000] * 2) for t in range(6)]
        d = policy.evaluate(quiet, 3, None)
        assert d.action == ACTION_DOWN and d.target_k == 2

    def test_min_max_clamps(self):
        policy = AutoscalePolicy(CFG)
        quiet = [frame(t, [0, 0]) for t in range(6)]
        assert policy.evaluate(quiet, CFG.min_shards,
                               None).action == ACTION_HOLD
        surge = [frame(t, [10**7] * 8) for t in range(6)]
        assert policy.evaluate(surge, CFG.max_shards,
                               None).action == ACTION_HOLD

    def test_unhealthy_shard_holds(self):
        policy = AutoscalePolicy(CFG)
        surge = [frame(t, [500_000, 500_000], healthy=(t < 5))
                 for t in range(6)]
        d = policy.evaluate(surge, 2, None)
        assert d.action == ACTION_HOLD and "unhealthy" in d.reason

    def test_memory_pressure_vetoes_scale_down(self):
        policy = AutoscalePolicy(CFG)
        quiet = [frame(t, [100, 100], pressure=True) for t in range(6)]
        d = policy.evaluate(quiet, 3, None)
        assert d.action == ACTION_HOLD and "pressure" in d.reason

    def test_capacity_estimate_from_drain_rates(self):
        """Median of the best per-shard durable-advance rates; floored
        when there is no evidence."""
        policy = AutoscalePolicy(CFG)
        hist = [frame(t, [0, 0], [t * 5000, t * 3000]) for t in range(5)]
        cap = policy.estimate_capacity(hist)
        assert cap == 5000.0  # median of {5000, 3000} -> upper-mid
        assert policy.estimate_capacity([hist[0]]) \
            == CFG.capacity_floor_bytes_per_s
        idle = [frame(t, [0, 0], [7, 7]) for t in range(5)]
        assert policy.estimate_capacity(idle) \
            == CFG.capacity_floor_bytes_per_s

    def test_empty_history_is_typed_error(self):
        with pytest.raises(EtlError):
            AutoscalePolicy(CFG).evaluate([], 2, None)


class TestSignals:
    def test_frame_json_round_trip(self):
        f = frame(3, [100, 200], [10, 20], pressure=True)
        back = SignalFrame.from_json(json.loads(json.dumps(f.to_json())))
        assert back == f
        assert back.aggregate_backlog_bytes == 300
        assert back.any_memory_pressure and back.all_healthy

    def test_timeline_round_trip_and_tick_regression(self):
        tl = SignalTimeline(max_frames=8)
        tl.record(frame(0, [1]))
        tl.record(frame(1, [2]))
        back = SignalTimeline.from_json(tl.to_json())
        assert [f.tick for f in back.frames] == [0, 1]
        with pytest.raises(EtlError):
            back.record(frame(1, [3]))

    def test_timeline_bound(self):
        tl = SignalTimeline(max_frames=3)
        for t in range(10):
            tl.record(frame(t, [t]))
        assert [f.tick for f in tl.frames] == [7, 8, 9]

    def test_seeded_timeline_deterministic_and_seed_sensitive(self):
        a = seeded_surge_timeline(7).to_json()
        b = seeded_surge_timeline(7).to_json()
        c = seeded_surge_timeline(8).to_json()
        assert a == b
        assert a != c

    def test_registry_source_reads_published_gauges(self):
        from etl_tpu_torch.telemetry.metrics import (ETL_SHARD_DELIVERED_EVENTS,
                                               ETL_SLOT_LAG_BYTES,
                                               registry)

        registry.gauge_set(ETL_SLOT_LAG_BYTES, 12_345,
                           {"shard": "0"})
        registry.gauge_set(ETL_SLOT_LAG_BYTES, 54_321,
                           {"shard": "1"})
        registry.gauge_set(ETL_SHARD_DELIVERED_EVENTS, 99, {"shard": "0"})
        src = RegistrySignalSource(2)
        f = asyncio.run(src.sample(0.0))
        assert f.shards[0].lag_bytes == 12_345
        assert f.shards[1].lag_bytes == 54_321
        assert f.shards[0].delivered_events == 99
        assert f.aggregate_backlog_bytes == 12_345 + 54_321

    def test_registry_source_tracks_live_shard_count(self):
        """On an autoscaled fleet the collector must follow the CURRENT
        K: a pinned count would keep sampling a retired shard's
        never-cleared lag gauge after a scale-down (inflating backlog
        forever) and miss new shards after a scale-up."""
        from etl_tpu_torch.telemetry.metrics import ETL_SLOT_LAG_BYTES, registry

        for s in range(3):
            registry.gauge_set(ETL_SLOT_LAG_BYTES, 1_000 * (s + 1),
                               {"shard": str(s)})
        holder = {"k": 3}
        src = RegistrySignalSource(lambda: holder["k"])
        assert asyncio.run(src.sample(0.0)).shard_count == 3
        holder["k"] = 2  # scale-down: shard 2's stale gauge must drop out
        f = asyncio.run(src.sample(1.0))
        assert f.shard_count == 2
        assert f.aggregate_backlog_bytes == 1_000 + 2_000


class TestJournal:
    def test_round_trip_and_pending(self):
        j = AutoscaleJournal()
        rec = j.open_decision(
            _decision(ACTION_UP, 2, 3, tick=5), epoch_before=0)
        assert j.pending() == rec and rec.decision_id == 1
        back = AutoscaleJournal.from_json(j.to_json())
        assert back.pending() == rec and back.next_id == 2
        back.settle(rec.decision_id, STATUS_APPLIED)
        assert back.pending() is None
        assert back.last_applied_tick() == 5

    def test_entry_bound(self):
        j = AutoscaleJournal(max_entries=4)
        for i in range(10):
            rec = j.open_decision(
                _decision(ACTION_UP, 2, 3, tick=i), epoch_before=0)
            j.settle(rec.decision_id, STATUS_APPLIED)
        assert len(j.entries) == 4
        assert j.next_id == 11  # ids survive the bound

    async def _store_round_trip(self, store):
        assert await store.get_autoscale_journal() is None
        j = AutoscaleJournal()
        j.open_decision(_decision(ACTION_UP, 2, 3, tick=1), 0)
        await store.update_autoscale_journal(j.to_json())
        back = AutoscaleJournal.from_json(
            await store.get_autoscale_journal())
        assert back.pending() is not None and back.pending().to_k == 3
        # id regression refused (a stale controller must not rewind)
        with pytest.raises(EtlError) as e:
            await store.update_autoscale_journal({"next_id": 0,
                                                  "entries": []})
        assert e.value.kind is ErrorKind.PROGRESS_REGRESSION

    async def test_memory_store_persistence(self):
        await self._store_round_trip(MemoryStore())

    async def test_sqlite_store_persistence(self, tmp_path):
        from etl_tpu_torch.store.sql import SqliteStore

        store = SqliteStore(tmp_path / "as.db", 1)
        await store.connect()
        try:
            await self._store_round_trip(store)
            # restart: a SECOND store over the same file reads through
            other = SqliteStore(tmp_path / "as.db", 1)
            await other.connect()
            try:
                back = AutoscaleJournal.from_json(
                    await other.get_autoscale_journal())
                assert back.pending() is not None
            finally:
                await other.close()
        finally:
            await store.close()

    async def test_shard_scoped_store_refuses_journal_writes(self):
        from etl_tpu_torch.sharding.runtime import ShardIdentity, ShardScopedStore

        store = MemoryStore()
        scoped = ShardScopedStore(store, ShardIdentity(1, 0, 2, 0))
        await store.update_autoscale_journal({"next_id": 2, "entries": []})
        assert (await scoped.get_autoscale_journal())["next_id"] == 2
        with pytest.raises(EtlError) as e:
            await scoped.update_autoscale_journal({"next_id": 3,
                                                   "entries": []})
        assert e.value.kind is ErrorKind.SHARD_NOT_OWNED

    async def test_journal_commit_failpoint(self):
        from etl_tpu_torch.chaos import failpoints
        from etl_tpu_torch.models.errors import ErrorKind as EK

        store = MemoryStore()

        def boom():
            raise EtlError(EK.STATE_STORE_FAILED, "chaos")

        failpoints.arm(failpoints.STORE_AUTOSCALE_COMMIT, boom)
        try:
            with pytest.raises(EtlError):
                await store.update_autoscale_journal({"next_id": 1,
                                                      "entries": []})
            assert await store.get_autoscale_journal() is None
        finally:
            failpoints.disarm_all()


def _decision(action, from_k, to_k, tick=0):
    from etl_tpu_torch.autoscale.policy import Decision

    return Decision(tick=tick, action=action, current_k=from_k,
                    target_k=to_k, raw_target_k=to_k,
                    backlog_bytes=0, capacity_bytes_per_s=1.0,
                    reason="test")


class _StubCollector:
    def __init__(self, frames):
        self.frames = list(frames)
        self.i = 0

    async def sample(self, at_s: float) -> SignalFrame:
        f = self.frames[min(self.i, len(self.frames) - 1)]
        self.i += 1
        return f


class _StubResult:
    def __init__(self, from_k, to_k, epoch):
        self.old_epoch = epoch
        self.new_epoch = epoch + 1
        self.old_shard_count = from_k
        self.new_shard_count = to_k
        self.fence_lsn = 100
        self.moved = {}
        self.duration_s = 0.0


class _StubCoordinator:
    """ShardCoordinator-shaped stub tracking the persisted assignment in
    a MemoryStore like the real one does."""

    def __init__(self, store, k=2, epoch=0):
        self.store = store
        self.calls: list[str] = []
        self._seed = ShardAssignment(epoch=epoch, shard_count=k)

    async def current(self, bootstrap_shard_count: int = 1):
        a = await self.store.get_shard_assignment()
        if a is None:
            a = self._seed
            await self.store.update_shard_assignment(a)
        return a

    async def add_shard(self):
        a = await self.current()
        self.calls.append("add")
        new = ShardAssignment(epoch=a.epoch + 1,
                              shard_count=a.shard_count + 1)
        await self.store.update_shard_assignment(new)
        return _StubResult(a.shard_count, new.shard_count, a.epoch)

    async def remove_shard(self):
        a = await self.current()
        self.calls.append("remove")
        new = ShardAssignment(epoch=a.epoch + 1,
                              shard_count=a.shard_count - 1)
        await self.store.update_shard_assignment(new)
        return _StubResult(a.shard_count, new.shard_count, a.epoch)

    async def abort_rebalance(self):
        a = await self.current()
        self.calls.append("abort")
        await self.store.update_shard_assignment(ShardAssignment(
            epoch=a.epoch, shard_count=a.shard_count,
            status=STATUS_STEADY))


def _controller(store, coordinator, frames, **kw):
    return AutoscaleController(
        store=store, pipeline_id=1, collector=_StubCollector(frames),
        coordinator=coordinator, policy=AutoscalePolicy(CFG), **kw)


class TestController:
    async def test_tick_applies_scale_up_and_journals(self):
        store = MemoryStore()
        coord = _StubCoordinator(store)
        rolls = []

        async def on_scale(from_k, to_k, result):
            rolls.append((from_k, to_k, result.new_epoch))

        surge = [frame(t, [500_000, 500_000]) for t in range(4)]
        c = _controller(store, coord, surge, scale_listener=on_scale)
        holds = [await c.tick(0.0)]  # first vote: hold
        d = await c.tick(1.0)  # second vote: actuates
        assert holds[0].action == ACTION_HOLD
        assert d.action == ACTION_UP and d.target_k == 3
        assert coord.calls == ["add"]
        assert rolls == [(2, 3, 1)]
        j = AutoscaleJournal.from_json(await store.get_autoscale_journal())
        assert j.pending() is None
        assert [ (r.action, r.status) for r in j.entries ] \
            == [(ACTION_UP, STATUS_APPLIED)]

    async def test_overlap_refused_while_pending(self):
        store = MemoryStore()
        coord = _StubCoordinator(store)
        j = AutoscaleJournal()
        j.open_decision(_decision(ACTION_UP, 2, 3), 0)
        await store.update_autoscale_journal(j.to_json())
        surge = [frame(t, [500_000, 500_000]) for t in range(4)]
        c = _controller(store, coord, surge)
        for t in range(2):
            d = await c.tick(float(t))
            assert d.action == ACTION_HOLD
        assert "in_flight" in d.reason
        assert coord.calls == []

    async def test_overlap_refused_while_rebalancing(self):
        store = MemoryStore()
        await store.update_shard_assignment(ShardAssignment(
            epoch=0, shard_count=2, status=STATUS_REBALANCING,
            fence_lsn=5, next_shard_count=3))
        coord = _StubCoordinator(store)
        surge = [frame(t, [500_000, 500_000]) for t in range(4)]
        c = _controller(store, coord, surge)
        await c.tick(0.0)
        d = await c.tick(1.0)
        assert d.action == ACTION_HOLD and "in_flight" in d.reason

    async def test_resume_redrives_pending_transition(self):
        store = MemoryStore()
        coord = _StubCoordinator(store)
        j = AutoscaleJournal()
        j.open_decision(_decision(ACTION_UP, 2, 3), 0)
        await store.update_autoscale_journal(j.to_json())
        c = _controller(store, coord, [frame(0, [0, 0])])
        settled = await c.resume()
        assert settled.status == STATUS_APPLIED
        assert coord.calls == ["add"]
        assert (await coord.current()).shard_count == 3
        # idempotent: nothing pending anymore
        assert await c.resume() is None
        assert coord.calls == ["add"]

    async def test_resume_after_flip_is_noop_beyond_journal(self):
        """Crash between epoch flip and journal mark: re-running the
        persisted decision must NOT re-actuate — it only settles the
        journal (and replays the idempotent fleet roll)."""
        store = MemoryStore()
        await store.update_shard_assignment(
            ShardAssignment(epoch=1, shard_count=3))
        coord = _StubCoordinator(store)
        j = AutoscaleJournal()
        j.open_decision(_decision(ACTION_UP, 2, 3), 0)
        await store.update_autoscale_journal(j.to_json())
        rolls = []

        async def on_scale(from_k, to_k, result):
            rolls.append((from_k, to_k))

        c = _controller(store, coord, [frame(0, [0, 0])],
                        scale_listener=on_scale)
        settled = await c.resume()
        assert settled.status == STATUS_APPLIED
        assert coord.calls == []  # no topology action
        assert rolls == [(2, 3)]  # the roll re-applies idempotently

    async def test_restart_does_not_inherit_foreign_tick_cooldown(self):
        """The journal's decision ticks belong to the process that wrote
        them. A successor whose collector counts from 0 again must NOT
        read a persisted tick-700 decision as a (negative-age) permanent
        cooldown — the cooldown re-anchors at the restart and expires
        normally."""
        store = MemoryStore()
        coord = _StubCoordinator(store)
        j = AutoscaleJournal()
        rec = j.open_decision(_decision(ACTION_UP, 2, 3, tick=700), 0)
        j.settle(rec.decision_id, STATUS_APPLIED)
        await store.update_autoscale_journal(j.to_json())
        surge = [frame(t, [500_000, 500_000]) for t in range(12)]
        c = _controller(store, coord, surge)
        actions = []
        for t in range(CFG.cooldown_ticks + CFG.up_ticks + 1):
            d = await c.tick(float(t))
            actions.append(d.action)
        # held through the re-anchored cooldown, then decided — never
        # stuck until the fresh counter overtakes 700
        assert ACTION_UP in actions, actions
        assert actions.index(ACTION_UP) >= CFG.cooldown_ticks - 1

    async def test_resume_abort_after_flip_settles_applied(self):
        """An epoch flip is not abortable: abort=True on a decision
        whose flip already happened must settle it APPLIED and roll the
        fleet — marking it aborted would strand a flipped assignment
        with an un-rolled fleet (moved tables owned by nobody)."""
        store = MemoryStore()
        await store.update_shard_assignment(
            ShardAssignment(epoch=1, shard_count=3))
        coord = _StubCoordinator(store)
        j = AutoscaleJournal()
        j.open_decision(_decision(ACTION_UP, 2, 3), 0)
        await store.update_autoscale_journal(j.to_json())
        rolls = []

        async def on_scale(from_k, to_k, result):
            rolls.append((from_k, to_k))

        c = _controller(store, coord, [frame(0, [0, 0])],
                        scale_listener=on_scale)
        settled = await c.resume(abort=True)
        assert settled.status == STATUS_APPLIED
        assert coord.calls == []  # neither abort nor re-actuation
        assert rolls == [(2, 3)]

    async def test_resume_abort_rolls_back(self):
        store = MemoryStore()
        await store.update_shard_assignment(ShardAssignment(
            epoch=0, shard_count=2, status=STATUS_REBALANCING,
            fence_lsn=5, next_shard_count=3))
        coord = _StubCoordinator(store)
        j = AutoscaleJournal()
        j.open_decision(_decision(ACTION_UP, 2, 3), 0)
        await store.update_autoscale_journal(j.to_json())
        c = _controller(store, coord, [frame(0, [0, 0])])
        settled = await c.resume(abort=True)
        assert settled.status == STATUS_ABORTED
        assert coord.calls == ["abort"]
        back = AutoscaleJournal.from_json(
            await store.get_autoscale_journal())
        assert back.pending() is None

    async def test_actuation_failure_leaves_pending_entry(self):
        store = MemoryStore()

        class FailingCoordinator(_StubCoordinator):
            async def add_shard(self):
                raise EtlError(ErrorKind.TIMEOUT, "quiesce timed out")

        coord = FailingCoordinator(store)
        surge = [frame(t, [500_000, 500_000]) for t in range(4)]
        c = _controller(store, coord, surge)
        await c.tick(0.0)
        with pytest.raises(EtlError):
            await c.tick(1.0)
        j = AutoscaleJournal.from_json(await store.get_autoscale_journal())
        assert j.pending() is not None  # a successor resumes or aborts

    def test_slo_weights_feed_admission(self):
        from etl_tpu_torch.ops.pipeline import AdmissionScheduler

        sched = AdmissionScheduler(2)
        store = MemoryStore()
        c = AutoscaleController(
            store=store, pipeline_id=1,
            collector=_StubCollector([frame(0, [0, 0])]),
            coordinator=_StubCoordinator(store),
            slo_weights={"cdc": 4.0, "copy": 0.5})
        c.apply_slo_weights(sched)
        t_cdc = sched.register("cdc-0")
        t_copy = sched.register("copy-16384-1")
        t_other = sched.register("other")
        assert sched._weight(t_cdc) == 4.0  # prefix match, no lag reader
        assert sched._weight(t_copy) == 0.5
        assert sched._weight(t_other) == 1.0
        # exact beats prefix; clamped into [1/max, max]
        sched.set_slo_weight("cdc-0", 1000.0)
        assert sched._weight(t_cdc) == sched._max_weight
        for t in (t_cdc, t_copy, t_other):
            t.close()

    def test_slo_weight_composes_with_lag(self):
        from etl_tpu_torch.ops.pipeline import AdmissionScheduler

        sched = AdmissionScheduler(2, lag_scale_bytes=1024,
                                   max_weight=32.0)
        sched.set_slo_weight("gold", 2.0)
        gold = sched.register("gold", lag_bytes=lambda: 1024)
        plain = sched.register("plain", lag_bytes=lambda: 1024)
        assert sched._weight(gold) == pytest.approx(4.0)  # 2.0 x (1+1)
        assert sched._weight(plain) == pytest.approx(2.0)
        gold.close()
        plain.close()


class TestOrchestratorScaleSeam:
    async def test_scale_pipeline_reapplies_spec_with_new_k(self):
        from etl_tpu_torch.api.orchestrator import Orchestrator, ReplicatorSpec

        class Recorder(Orchestrator):
            def __init__(self):
                self.started = []

            async def start_pipeline(self, spec):
                self.started.append(spec)

            async def stop_pipeline(self, pipeline_id):
                pass

            async def status(self, pipeline_id):
                raise NotImplementedError

        orch = Recorder()
        spec = ReplicatorSpec(pipeline_id=1, tenant_id="t",
                              config={"shard": 1, "shard_count": 2,
                                      "publication": "pub"})
        await orch.scale_pipeline(spec, 3)
        (started,) = orch.started
        assert started.shard is None and started.shard_count == 3
        assert started.config["shard_count"] == 3
        assert "shard" not in started.config  # stale pin stripped
        assert started.config["publication"] == "pub"
        with pytest.raises(EtlError):
            await orch.scale_pipeline(spec, 0)


class TestReplayCli:
    def test_synthetic_trace_is_deterministic(self, capsys):
        from etl_tpu_torch.autoscale.__main__ import main

        args = ["--synthetic", "--seed", "7", "--holds",
                "--min-shards", "2", "--max-shards", "3",
                "--drain-slo-s", "2", "--up-backlog-bytes", "262144",
                "--down-backlog-bytes", "65536"]
        assert main(args) == 0
        first = capsys.readouterr().out
        assert main(args) == 0
        second = capsys.readouterr().out
        assert first == second
        lines = [json.loads(line) for line in first.splitlines()]
        summary = lines[-1]
        assert summary["summary"] and summary["frames"] == 40
        actions = [d["action"] for d in summary["decisions"]]
        assert "scale_up" in actions and "scale_down" in actions
        # every evaluation printed with --holds: one line per frame
        assert len(lines) == 40 + 1

    def test_replay_file_round_trip(self, tmp_path, capsys):
        from etl_tpu_torch.autoscale.__main__ import main

        path = tmp_path / "signals.json"
        path.write_text(json.dumps(seeded_surge_timeline(9).to_json()))
        assert main(["--replay", str(path), "--min-shards", "2",
                     "--up-backlog-bytes", "262144",
                     "--down-backlog-bytes", "65536"]) == 0
        out = capsys.readouterr().out
        summary = json.loads(out.splitlines()[-1])
        assert summary["source"] == str(path)
        assert summary["start_k"] == 2

    def test_malformed_input_exits_2(self, tmp_path, capsys):
        from etl_tpu_torch.autoscale.__main__ import main

        bad = tmp_path / "bad.json"
        bad.write_text("{not json")
        assert main(["--replay", str(bad)]) == 2
        capsys.readouterr()


class TestBenchGate:
    def test_reaction_time_gate_green(self):
        from etl_tpu_torch.benchmarks.harness import run_autoscale_bench

        out = run_autoscale_bench(seed=7, reaction_ticks_max=3)
        assert out["ok"], out["failures"]
        assert out["reaction_ticks"] <= 3
        assert out["scale_down_tick"] - out["scale_up_tick"] \
            >= out["cooldown_ticks"]
        assert out["deterministic"]


class TestChaosScenarios:
    async def test_surge_drain_end_to_end(self):
        from etl_tpu_torch.chaos.autoscale import run_autoscale_surge_drain
        from etl_tpu_torch.telemetry.metrics import ETL_SLOT_LAG_BYTES, registry

        run = await run_autoscale_surge_drain(seed=7, device="cpu")
        assert run.ok, run.report.describe()
        assert [d["action"] for d in run.decision_trace] == (
            ["hold"] * 3 + ["scale_up"] + ["hold"] * 2 + ["scale_down"])
        assert run.k_track[-1] == 2 and 3 in run.k_track
        assert run.union_matches
        # satellite: the apply loops published the per-slot lag gauge on
        # their status cadence (the series the collector + operators read)
        assert registry.get_gauge(ETL_SLOT_LAG_BYTES,
                                  {"shard": "0"}) is not None

    async def test_controller_crash_resumes_via_journal(self):
        from etl_tpu_torch.chaos.autoscale import run_autoscale_controller_crash

        run = await run_autoscale_controller_crash(seed=7, device="cpu")
        assert run.ok, run.report.describe()
        entries = run.journal.get("entries", [])
        assert [(e["action"], e["status"]) for e in entries] \
            == [("scale_up", "applied")]
        assert any(r.kind == "crash" for r in run.restarts)


# ---------------------------------------------------------------------------
# the port against the reference on the same seeded inputs
# ---------------------------------------------------------------------------

#: the policies the parity cases run: the default, the bench gate's, the
#: chaos scenarios' and this file's CFG (by keyword, so each package
#: builds its own config from the same numbers)
_PARITY_POLICIES = {
    "default": {},
    "bench": dict(min_shards=2, max_shards=3, drain_slo_s=2.0,
                  up_backlog_bytes=256 * 1024,
                  down_backlog_bytes=64 * 1024,
                  up_ticks=2, down_ticks=3, cooldown_ticks=5),
    "chaos": dict(min_shards=2, max_shards=3, drain_slo_s=1.0,
                  up_backlog_bytes=16 * 1024, down_backlog_bytes=4 * 1024,
                  up_ticks=2, down_ticks=1, cooldown_ticks=3,
                  window_frames=8),
    "cfg": dict(min_shards=1, max_shards=8, drain_slo_s=10.0,
                up_backlog_bytes=100_000, down_backlog_bytes=10_000,
                up_ticks=2, down_ticks=2, cooldown_ticks=4,
                capacity_floor_bytes_per_s=1000.0),
}


def _both_policies(name: str):
    from etl_tpu.autoscale import policy as ref_policy

    from etl_tpu_torch.autoscale import policy as port_policy

    kw = _PARITY_POLICIES[name]
    return (ref_policy, ref_policy.AutoscalePolicy(
                ref_policy.AutoscalePolicyConfig(**kw)),
            port_policy, port_policy.AutoscalePolicy(
                port_policy.AutoscalePolicyConfig(**kw)))


class TestReferenceParity:
    @pytest.mark.parametrize("policy_name", sorted(_PARITY_POLICIES))
    @pytest.mark.parametrize("seed", range(10))
    def test_simulate_trace_equals_reference(self, seed, policy_name):
        from etl_tpu.autoscale import signals as ref_signals

        from etl_tpu_torch.autoscale import signals as port_signals

        ref_tl = ref_signals.seeded_surge_timeline(seed, shards=2 + seed % 2)
        port_tl = port_signals.seeded_surge_timeline(seed,
                                                     shards=2 + seed % 2)
        assert port_tl.to_json() == ref_tl.to_json()
        ref_mod, ref_pol, port_mod, port_pol = _both_policies(policy_name)
        start_k = max(2, ref_pol.config.min_shards)
        ref = [d.describe()
               for d in ref_mod.simulate(ref_tl.frames, ref_pol, start_k)]
        port = [d.describe()
                for d in port_mod.simulate(port_tl.frames, port_pol,
                                           start_k)]
        assert port == ref

    @pytest.mark.parametrize("seed", range(10))
    def test_evaluate_equals_reference_on_noisy_histories(self, seed):
        """Random frames (lags around both bands, health and pressure
        flips, drain rates that stall): every evaluation at every K and
        cooldown anchor equal to the reference's."""
        from etl_tpu.autoscale import signals as ref_signals

        ref_mod, ref_pol, port_mod, port_pol = _both_policies("cfg")
        rng = random.Random(seed)
        ref_hist, port_hist = [], []
        durable = [0, 0, 0]
        for tick in range(30):
            shards = []
            for s in range(3):
                durable[s] += rng.choice((0, 500, 1000, 5000))
                shards.append(dict(
                    shard=s, lag_bytes=rng.choice(
                        (0, 5_000, 50_000, 99_999, 100_001, 400_000)),
                    durable_lsn=durable[s],
                    memory_pressure=rng.random() < 0.1,
                    healthy=rng.random() > 0.05))
            doc = {"tick": tick, "at_s": tick * 0.5, "shards": shards}
            ref_hist.append(ref_signals.SignalFrame.from_json(doc))
            port_hist.append(SignalFrame.from_json(doc))
            for k in (1, 2, 3, 8):
                for last in (None, tick - 1, tick - 5):
                    assert port_pol.evaluate(port_hist, k, last).describe() \
                        == ref_pol.evaluate(ref_hist, k, last).describe()

    def test_journal_document_equals_reference(self):
        from etl_tpu.autoscale import controller as ref_controller
        from etl_tpu.autoscale import policy as ref_policy

        from etl_tpu_torch.autoscale import controller as port_controller
        from etl_tpu_torch.autoscale import policy as port_policy

        docs = []
        for ctl, pol in ((ref_controller, ref_policy),
                         (port_controller, port_policy)):
            j = ctl.AutoscaleJournal(max_entries=3)
            for i, (action, a, b) in enumerate(
                    [(pol.ACTION_UP, 2, 3), (pol.ACTION_DOWN, 3, 2),
                     (pol.ACTION_UP, 2, 3), (pol.ACTION_UP, 3, 4)]):
                rec = j.open_decision(pol.Decision(
                    tick=i, action=action, current_k=a, target_k=b,
                    raw_target_k=b, backlog_bytes=1_000 * i,
                    capacity_bytes_per_s=2_048.0, reason="parity"),
                    epoch_before=i)
                j.settle(rec.decision_id, ctl.STATUS_APPLIED if i % 2
                         else ctl.STATUS_ABORTED)
            j.open_decision(pol.Decision(
                tick=9, action=pol.ACTION_DOWN, current_k=4, target_k=3,
                raw_target_k=3, backlog_bytes=0,
                capacity_bytes_per_s=1.0, reason="pending"), epoch_before=4)
            docs.append(j.to_json())
        assert docs[1] == docs[0]

    @pytest.mark.parametrize("argv", [
        ["--synthetic", "--seed", "7", "--holds", "--min-shards", "2",
         "--max-shards", "3", "--drain-slo-s", "2",
         "--up-backlog-bytes", "262144", "--down-backlog-bytes", "65536"],
        ["--synthetic", "--seed", "3"],
        ["--synthetic", "--seed", "11", "--holds", "--start-k", "3"]],
        ids=["bench_knobs", "defaults", "start_k3"])
    def test_replay_cli_output_equals_reference(self, argv, capsys):
        from etl_tpu.autoscale.__main__ import main as ref_main

        from etl_tpu_torch.autoscale.__main__ import main as port_main

        assert ref_main(argv) == 0
        ref = capsys.readouterr().out
        assert port_main(argv) == 0
        assert capsys.readouterr().out == ref

    def test_replay_file_output_equals_reference(self, tmp_path, capsys):
        from etl_tpu.autoscale.__main__ import main as ref_main

        from etl_tpu_torch.autoscale.__main__ import main as port_main

        path = tmp_path / "signals.json"
        path.write_text(json.dumps(seeded_surge_timeline(5).to_json()))
        argv = ["--replay", str(path), "--holds", "--min-shards", "2"]
        assert ref_main(argv) == 0
        ref = capsys.readouterr().out
        assert port_main(argv) == 0
        assert capsys.readouterr().out == ref

    def test_bench_report_equals_reference(self):
        import importlib.util
        import sys
        from pathlib import Path

        from etl_tpu_torch.benchmarks.harness import run_autoscale_bench

        path = Path(__file__).resolve().parents[1] / "bench.py"
        spec = importlib.util.spec_from_file_location("_bench_ref_as", path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules["_bench_ref_as"] = mod
        spec.loader.exec_module(mod)
        for seed in (7, 8):
            assert run_autoscale_bench(seed=seed, reaction_ticks_max=3) \
                == mod.run_autoscale_bench(seed=seed, reaction_ticks_max=3)

    def test_bench_cli_gate(self):
        """`python -m etl_tpu_torch.bench --autoscale`: one JSON line, rc 0,
        the reaction within autoscale_reaction_ticks_max. Pure arithmetic,
        so it runs without a card and without --device cpu."""
        import subprocess
        import sys
        from pathlib import Path

        root = Path(__file__).resolve().parents[1]
        floors = json.loads((root / "BENCH_FLOOR.json").read_text())
        proc = subprocess.run(
            [sys.executable, "-m", "etl_tpu_torch.bench", "--autoscale"],
            capture_output=True, text=True, timeout=120, cwd=root)
        assert proc.returncode == 0, proc.stderr[-2000:]
        out = json.loads(proc.stdout)
        assert out["ok"] and out["deterministic"]
        assert out["reaction_ticks"] <= floors[
            "autoscale_reaction_ticks_max"]
        assert out["decisions"][-1]["target_k"] == 2


#: busy processes beside the loaded controller crash (as the hard-kill
#: test's: with a parallel run's other workers they over-subscribe the
#: host), and each loaded run's time box, seconds
SPINNERS = 6
RUN_BOX_S = 90.0


def test_controller_crash_beside_busy_processes():
    import subprocess
    import sys

    from etl_tpu_torch.chaos.autoscale import run_autoscale_controller_crash

    spinners = [subprocess.Popen([sys.executable, "-c", "while True: pass"],
                                 stdout=subprocess.DEVNULL,
                                 stderr=subprocess.DEVNULL)
                for _ in range(SPINNERS)]
    try:
        for _ in range(2):
            run = asyncio.run(asyncio.wait_for(
                run_autoscale_controller_crash(seed=7, device="cpu"),
                RUN_BOX_S))
            assert run.ok, run.report.describe()
            assert [(e["action"], e["status"])
                    for e in run.journal.get("entries", [])] \
                == [("scale_up", "applied")]
            assert run.device_batches > 0 and run.k1_launches == 0
    finally:
        for p in spinners:
            p.kill()
        for p in spinners:
            p.wait()
