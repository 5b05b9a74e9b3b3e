"""The port's fleet (`etl_tpu_torch/fleet/`, `chaos/fleet.py`, the
`/v1/fleet` route) held to the reference: the classes of
`tests/test_fleet.py`, `tests/test_fleet_store.py` and
`tests/test_fleet_api.py` run on the port's modules (spec, journal,
placement, diff, reconciler, simulated runtime, signal bus, the store's
fleet surface on every dialect, the orchestrators' list primitive and
the aggregated fleet view); then the reference's and the port's fleet
chaos run and fleet bench on the same seeds; and the reconciler over
`OrchestratorFleetRuntime(LocalOrchestrator)` starting real replicator
children on the CPU (`benchmarks.fleet.run_fleet_children`, chip_smoke.py
phase 18(c) at a small size).

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_fleet.py -q

Tolerance: exact — the same statuses, bodies, journals, placements and
actuation traces.
"""

import asyncio
import importlib.util
import os

import pytest
from aiohttp.test_utils import TestClient, TestServer

from etl_tpu_torch.api.app import OPENAPI_DOC, ApiState, build_app
from etl_tpu_torch.api.crypto import ConfigCipher, EncryptionKey
from etl_tpu_torch.api.orchestrator import (K8sOrchestrator,
                                            LocalOrchestrator, Orchestrator,
                                            ReplicatorStatus)
from etl_tpu_torch.autoscale.signals import ShardSignals, SignalFrame
from etl_tpu_torch.chaos import failpoints as port_failpoints
from etl_tpu_torch.config import PgConnectionConfig
from etl_tpu_torch.fleet import (MAX_SHARDS_PER_PIPELINE, STATUS_ABORTED,
                                 STATUS_APPLIED, STATUS_PENDING, VERB_CREATE,
                                 VERB_DELETE, VERB_RESIZE, ActuationJournal,
                                 AdaptiveAckDepthPolicy,
                                 AdmissionWeightPolicy, FleetReconciler,
                                 FleetSignalBus, FleetSpec, PidLagPolicy,
                                 PipelineSpec, SimulatedFleetRuntime,
                                 TenantQuota, diff_fleet, place_fleet,
                                 seeded_fleet_spec)
from etl_tpu_torch.models.errors import ErrorKind, EtlError
from etl_tpu_torch.ops.pipeline import reset_global_admission
from etl_tpu_torch.store.memory import MemoryStore
from etl_tpu_torch.store.sql import PostgresStore, SqliteStore
from etl_tpu_torch.testing.fake_http import RecordingHttpServer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _port_hygiene():
    """The fleet chaos run and the reconciler without a scheduler write
    SLO weights into the process-wide admission scheduler, and the store
    tests arm failpoints: neither may reach another test on this
    worker."""
    yield
    port_failpoints.disarm_all()
    reset_global_admission()


# -- test_fleet.py ---------------------------------------------------------

def pipe(pid, tenant="acme", k=1, **kw) -> PipelineSpec:
    return PipelineSpec(pipeline_id=pid, tenant_id=tenant,
                        shard_count=k, **kw)


def frame(tick, lag_bytes, k=1) -> SignalFrame:
    return SignalFrame(tick=tick, at_s=float(tick),
                       shards=tuple(ShardSignals(shard=i,
                                                 lag_bytes=lag_bytes // k)
                                    for i in range(k)))


class TestFleetSpec:
    def test_validate_rejects_duplicates_and_bad_counts(self):
        with pytest.raises(EtlError) as e:
            FleetSpec(pipelines=(pipe(1), pipe(1))).validate()
        assert e.value.kind is ErrorKind.CONFIG_INVALID
        with pytest.raises(EtlError):
            pipe(1, k=0).validate()
        with pytest.raises(EtlError):
            pipe(1, k=MAX_SHARDS_PER_PIPELINE + 1).validate()
        with pytest.raises(EtlError):
            FleetSpec(quotas={"t": TenantQuota(max_shards=-1)}).validate()
        with pytest.raises(EtlError):
            FleetSpec(quotas={"t": TenantQuota(slo_weight=0)}).validate()

    def test_with_edit_bumps_version_and_rewrites(self):
        spec = FleetSpec(spec_version=4, pipelines=(pipe(1), pipe(2, k=3)))
        edited = spec.with_edit(remove=[1], add=[pipe(5, k=2)],
                                resize={2: 1})
        assert edited.spec_version == 5
        assert [p.pipeline_id for p in edited.pipelines] == [2, 5]
        assert edited.by_id()[2].shard_count == 1
        # the original document is untouched (frozen value semantics)
        assert spec.by_id()[2].shard_count == 3

    def test_json_round_trip(self):
        spec = FleetSpec(
            spec_version=9,
            pipelines=(pipe(3, tenant="g", k=2, destination="clickhouse",
                            profile="tiny_txs", config={"x": 1}),),
            quotas={"g": TenantQuota(max_shards=5, slo_weight=0.5)})
        assert FleetSpec.from_json(spec.to_json()) == spec
        assert FleetSpec.from_json(None) == FleetSpec()


class TestActuationJournal:
    def test_open_settle_pending_applied(self):
        j = ActuationJournal()
        rec = j.open(verb=VERB_CREATE, from_k=0, to_k=2, spec_version=1)
        assert rec.decision_id == 1 and j.next_id == 2
        assert j.pending() == rec
        j.settle(rec.decision_id, STATUS_APPLIED)
        assert j.pending() is None
        assert [r.decision_id for r in j.applied()] == [1]

    def test_bounded_history_keeps_id_counter(self):
        j = ActuationJournal(max_entries=4)
        for i in range(10):
            rec = j.open(verb=VERB_RESIZE, from_k=1, to_k=2,
                         spec_version=1)
            j.settle(rec.decision_id, STATUS_APPLIED)
        assert len(j.entries) == 4
        assert j.next_id == 11
        back = ActuationJournal.from_json(j.to_json())
        assert back.next_id == 11 and len(back.entries) == 4

    def test_satisfied_by_is_the_observed_target_test(self):
        j = ActuationJournal()
        rec = j.open(verb=VERB_DELETE, from_k=3, to_k=0, spec_version=2)
        assert rec.satisfied_by(0) and not rec.satisfied_by(3)
        assert rec.status == STATUS_PENDING


class TestPlacement:
    def test_unlimited_tenants_get_their_ask(self):
        spec = FleetSpec(pipelines=(pipe(1, k=3), pipe(2, k=2)))
        assert place_fleet(spec) == {1: 3, 2: 2}

    def test_quota_clamps_in_id_order_floor_one_shard(self):
        spec = FleetSpec(
            pipelines=(pipe(1, k=4), pipe(2, k=4), pipe(3, k=4)),
            quotas={"acme": TenantQuota(max_shards=6)})
        # every pipeline keeps 1, surplus (3) dealt id-first
        assert place_fleet(spec) == {1: 4, 2: 1, 3: 1}

    def test_zero_max_shards_means_unlimited(self):
        spec = FleetSpec(pipelines=(pipe(1, k=4),),
                         quotas={"acme": TenantQuota(max_shards=0)})
        assert place_fleet(spec) == {1: 4}

    def test_seeded_spec_quotas_visibly_bite(self):
        spec = seeded_fleet_spec(7, 100)
        targets = place_fleet(spec)
        asked = {p.pipeline_id: p.shard_count for p in spec.pipelines}
        clamped = [pid for pid in targets if targets[pid] < asked[pid]]
        assert clamped, "seeded quotas must clamp someone"
        assert all(k >= 1 for k in targets.values())


class TestDiff:
    def test_verb_order_deletes_creates_resizes(self):
        targets = {2: 3, 4: 1, 5: 2}
        observed = {1: 2, 2: 1, 5: 2}
        actions = diff_fleet(targets, observed)
        assert [(a.verb, a.pipeline_id, a.from_k, a.to_k)
                for a in actions] == [
            (VERB_DELETE, 1, 2, 0),
            (VERB_CREATE, 4, 0, 1),
            (VERB_RESIZE, 2, 1, 3),
        ]

    def test_steady_state_diffs_to_nothing(self):
        assert diff_fleet({1: 2}, {1: 2}) == ()
        assert diff_fleet({}, {}) == ()


class TestSimulatedRuntime:
    async def test_verbs_are_idempotent(self):
        rt = SimulatedFleetRuntime(seed=3)
        await rt.create_pipeline(pipe(1, k=2, profile="tiny_txs"))
        ledger = list(rt.pipelines[1].committed)
        await rt.create_pipeline(pipe(1, k=2, profile="tiny_txs"))
        assert rt.pipelines[1].committed == ledger  # no re-seed
        await rt.resize_pipeline(pipe(1, k=2, profile="tiny_txs"))
        assert rt.pipelines[1].rolls == 0  # same-K resize no-ops
        await rt.delete_pipeline(9)  # absent: state no-op
        assert await rt.list_pipelines() == {1: 2}
        assert rt.violations() == []

    async def test_roll_redelivers_bounded_tail(self):
        rt = SimulatedFleetRuntime(seed=3)
        await rt.create_pipeline(pipe(1, k=1, profile="insert_heavy"))
        await rt.resize_pipeline(pipe(1, k=3, profile="insert_heavy"))
        p = rt.pipelines[1]
        assert p.rolls == 1
        assert max(p.delivered.values()) == 2  # tail dup, within budget
        assert rt.violations() == []
        # a phantom delivery IS a violation the model catches
        p.delivered["phantom:1:0"] = 1
        assert rt.violations()


async def converged_reconciler(seed=7, n=20):
    store = MemoryStore()
    runtime = SimulatedFleetRuntime(seed=seed)
    spec = seeded_fleet_spec(seed, n)
    await store.update_fleet_spec(spec.to_json())
    rec = FleetReconciler(store=store, runtime=runtime,
                          scheduler=_StubScheduler())
    ticks = await rec.converge()
    return store, runtime, spec, rec, ticks


class _StubScheduler:
    def __init__(self):
        self.weights = {}

    def set_slo_weight(self, tenant, weight):
        self.weights[tenant] = weight


class TestReconciler:
    async def test_converges_from_empty_in_one_working_tick(self):
        store, runtime, spec, rec, ticks = await converged_reconciler()
        assert ticks == 1
        assert await runtime.list_pipelines() == place_fleet(spec)
        # every actuation is backed 1:1 by an APPLIED journal record
        journals = [ActuationJournal.from_json(d) for d in
                    (await store.get_fleet_journals()).values()]
        assert sum(len(j.applied()) for j in journals) \
            == len(runtime.actuation_log)
        assert all(j.pending() is None for j in journals)
        assert runtime.violations() == []

    async def test_edit_absorbed_and_slo_weights_fed(self):
        store, runtime, spec, rec, _ = await converged_reconciler()
        edited = spec.with_edit(remove=[1], resize={5: 6},
                                add=[pipe(900, tenant="tenant-burst",
                                          k=2, profile="tiny_txs")])
        await store.update_fleet_spec(edited.to_json())
        assert await rec.converge() == 1
        observed = await runtime.list_pipelines()
        assert observed == place_fleet(edited)
        assert 1 not in observed and observed[900] == 2
        assert 1 in runtime.retired
        # quota SLO weights reached the scheduler via the spec document
        sched = rec._scheduler
        for tenant, quota in edited.quotas.items():
            assert sched.weights[tenant] == quota.slo_weight
        assert runtime.violations() == []

    async def test_pending_journal_holds_the_pipeline(self):
        store, runtime, spec, rec, _ = await converged_reconciler()
        # a crashed coordinator's pending record holds pipeline 5
        # mid-roll (5's tenant is unclamped, so the resize survives
        # placement and actually diffs)
        j = ActuationJournal.from_json(await store.get_fleet_journal(5))
        j.open(verb=VERB_RESIZE, from_k=1, to_k=9,
               spec_version=spec.spec_version)
        await store.update_fleet_journal(5, j.to_json())
        await store.update_fleet_spec(
            spec.with_edit(resize={5: 9}).to_json())
        before = len(runtime.actuation_log)
        result = await rec.tick()
        assert result.held == [5] and result.applied == []
        assert not result.converged
        assert len(runtime.actuation_log) == before  # held = no verbs

    async def test_resume_settles_crash_after_actuation(self):
        """Fleet already shows the target: journal-only settle, ZERO
        runtime calls — the no-double-actuation half."""
        store, runtime, spec, rec, _ = await converged_reconciler()
        target = spec.pipelines[0].pipeline_id
        observed_k = (await runtime.list_pipelines())[target]
        j = ActuationJournal.from_json(await store.get_fleet_journal(target))
        pend = j.open(verb=VERB_RESIZE, from_k=1, to_k=observed_k,
                      spec_version=spec.spec_version)
        await store.update_fleet_journal(target, j.to_json())
        before = len(runtime.actuation_log)
        settled = await rec.resume()
        assert [(r.decision_id, r.status) for r in settled] \
            == [(pend.decision_id, STATUS_APPLIED)]
        assert len(runtime.actuation_log) == before
        assert await rec.resume() == []  # idempotent

    async def test_resume_redrives_crash_before_actuation(self):
        store, runtime, spec, rec, _ = await converged_reconciler()
        target = spec.pipelines[0].pipeline_id
        want = (await runtime.list_pipelines())[target] + 3
        j = ActuationJournal.from_json(await store.get_fleet_journal(target))
        j.open(verb=VERB_RESIZE, from_k=1, to_k=want,
               spec_version=spec.spec_version)
        await store.update_fleet_journal(target, j.to_json())
        await store.update_fleet_spec(
            spec.with_edit(resize={target: want}).to_json())
        before = len(runtime.actuation_log)
        settled = await rec.resume()
        assert [r.status for r in settled] == [STATUS_APPLIED]
        assert len(runtime.actuation_log) == before + 1  # exactly one
        assert (await runtime.list_pipelines())[target] == want
        assert await rec.resume() == []

    async def test_resume_aborts_when_spec_moved_on(self):
        store, runtime, spec, rec, _ = await converged_reconciler()
        target = spec.pipelines[0].pipeline_id
        j = ActuationJournal.from_json(await store.get_fleet_journal(target))
        j.open(verb=VERB_RESIZE, from_k=1, to_k=40,
               spec_version=spec.spec_version)
        await store.update_fleet_journal(target, j.to_json())
        await store.update_fleet_spec(
            spec.with_edit(remove=[target]).to_json())
        before = len(runtime.actuation_log)
        settled = await rec.resume()
        assert [r.status for r in settled] == [STATUS_ABORTED]
        assert len(runtime.actuation_log) == before
        # the next converge deletes the stray against the new truth
        await rec.converge()
        assert target not in await runtime.list_pipelines()
        assert runtime.violations() == []


class TestSignalBus:
    def test_pid_recommends_scale_up_for_lagging_pipeline_only(self):
        bus = FleetSignalBus()
        pid_policy = PidLagPolicy()
        bus.register(pid_policy)
        for t in range(3):
            bus.publish(1, frame(t, 256 * 1024 * 1024, k=2))  # lagging
            bus.publish(2, frame(t, 1024, k=2))  # healthy
            bus.step()
        assert pid_policy.recommendations[1] > 2
        assert 2 not in pid_policy.recommendations

    def test_pid_integral_is_wind_up_clamped(self):
        bus = FleetSignalBus()
        pid_policy = PidLagPolicy()
        bus.register(pid_policy)
        cap = pid_policy.config.max_shards
        for t in range(50):  # a LONG sustained surge
            bus.publish(1, frame(t, 1 << 40, k=2))
            bus.step()
        assert pid_policy.recommendations[1] <= cap

    def test_ack_depth_tracks_measured_latency(self):
        class _Window:
            limit = None

            def set_limit(self, v):
                self.limit = v

        window = _Window()
        reads = [(24, 24 * 0.4)]  # mean 0.4s over 0.05s flushes -> 9
        bus = FleetSignalBus()
        policy = AdaptiveAckDepthPolicy(
            window_of=lambda pid: window,
            histogram_read=lambda: reads[-1])
        bus.register(policy)
        bus.publish(1, frame(0, 0))
        assert len(bus.step()) == 1
        # the epsilon fencepost: 0.4/0.05 is 8.000…02 in binary — depth
        # must be ceil(8)+1 = 9, not 10
        assert window.limit == 9
        # unchanged histogram: held (state IS the applied depth)
        bus.publish(1, frame(1, 0))
        assert bus.step() == []
        # latency falls -> depth follows
        reads.append((100, 100 * 0.05))
        bus.publish(1, frame(2, 0))
        bus.step()
        assert window.limit == 2

    def test_ack_depth_cold_histogram_is_held(self):
        bus = FleetSignalBus()
        policy = AdaptiveAckDepthPolicy(
            window_of=lambda pid: None,
            histogram_read=lambda: (3, 0.9))  # < min_samples
        bus.register(policy)
        bus.publish(1, frame(0, 0))
        assert bus.step() == []

    def test_admission_weight_base_and_lag_boost(self):
        sched = _StubScheduler()
        bus = FleetSignalBus()
        spec = FleetSpec(
            spec_version=1,
            pipelines=(pipe(1, tenant="hot", k=1),
                       pipe(2, tenant="cold", k=1)),
            quotas={"hot": TenantQuota(slo_weight=1.5),
                    "cold": TenantQuota(slo_weight=0.5)})
        bus.bind_spec(spec)
        policy = AdmissionWeightPolicy(bus, scheduler=sched)
        bus.register(policy)
        bus.publish(1, frame(0, 256 * 1024 * 1024))  # over the boost bar
        bus.publish(2, frame(0, 1024))
        bus.step()
        assert sched.weights["hot"] == pytest.approx(3.0)  # 1.5 * 2
        assert sched.weights["cold"] == pytest.approx(0.5)
        # unchanged signals: weights are held, not re-applied
        bus.publish(1, frame(1, 256 * 1024 * 1024))
        bus.publish(2, frame(1, 1024))
        assert bus.step() == []

    def test_drop_forgets_history_and_state(self):
        bus = FleetSignalBus()
        pid_policy = PidLagPolicy()
        bus.register(pid_policy)
        bus.publish(1, frame(0, 1 << 30))
        bus.step()
        bus.drop(1)
        assert bus.step() == []
        assert ("pid_lag", 1) not in bus._state


# -- test_fleet_store.py ---------------------------------------------------

def sample_spec(version: int = 1) -> FleetSpec:
    return FleetSpec(
        spec_version=version,
        pipelines=(PipelineSpec(pipeline_id=1, tenant_id="acme",
                                shard_count=2, profile="insert_heavy"),
                   PipelineSpec(pipeline_id=2, tenant_id="globex",
                                shard_count=4, profile="tiny_txs",
                                destination="clickhouse",
                                config={"flush_ms": 50})),
        quotas={"acme": TenantQuota(max_shards=3, slo_weight=2.0)})


def sample_journal() -> dict:
    j = ActuationJournal()
    j.open(spec_version=1, verb=VERB_CREATE, from_k=0, to_k=2)
    return j.to_json()


class FleetStoreEnv:
    """One dialect's stores over shared backing storage: a second
    `make()` models a coordinator-process restart."""

    def __init__(self, dialect: str, tmp_path):
        self.dialect = dialect
        self.tmp_path = tmp_path
        self._server = None
        self._stores = []

    async def make(self, pipeline_id: int = 1):
        if self.dialect == "memory":
            # memory has no cross-process story; restarts reuse it
            if self._stores:
                return self._stores[0]
            s = MemoryStore()
        elif self.dialect == "sqlite":
            s = SqliteStore(self.tmp_path / "fleet.db", pipeline_id)
            await s.connect()
        else:
            if self._server is None:
                from etl_tpu_torch.postgres.fake import FakeDatabase
                from etl_tpu_torch.testing.fake_pg_server import FakePgServer

                self._server = FakePgServer(FakeDatabase())
                await self._server.start()
            s = PostgresStore(
                PgConnectionConfig(host="127.0.0.1",
                                   port=self._server.port,
                                   name="postgres", username="etl"),
                pipeline_id)
            await s.connect()
        self._stores.append(s)
        return s

    async def cleanup(self):
        for s in self._stores:
            try:
                await s.close()
            except Exception:
                pass
        if self._server is not None:
            await self._server.stop()


DIALECTS = ["memory", "sqlite", "postgres"]


@pytest.mark.parametrize("dialect", DIALECTS)
class TestFleetStoreDialects:
    async def test_spec_round_trips_across_restart(self, dialect, tmp_path):
        env = FleetStoreEnv(dialect, tmp_path)
        try:
            s1 = await env.make()
            assert await s1.get_fleet_spec() is None
            assert FleetSpec.from_json(await s1.get_fleet_spec()) \
                == FleetSpec()
            spec = sample_spec()
            await s1.update_fleet_spec(spec.to_json())

            s2 = await env.make()
            back = FleetSpec.from_json(await s2.get_fleet_spec())
            assert back == spec
            assert back.quotas["acme"].slo_weight == 2.0
            assert back.by_id()[2].config == {"flush_ms": 50}
        finally:
            await env.cleanup()

    async def test_spec_version_regression_refused(self, dialect, tmp_path):
        env = FleetStoreEnv(dialect, tmp_path)
        try:
            s = await env.make()
            await s.update_fleet_spec(sample_spec(version=3).to_json())
            with pytest.raises(EtlError) as e:
                await s.update_fleet_spec(sample_spec(version=2).to_json())
            assert e.value.kind is ErrorKind.PROGRESS_REGRESSION
            # the stored document is untouched by the refused write
            kept = FleetSpec.from_json(await s.get_fleet_spec())
            assert kept.spec_version == 3
            # same-version rewrite is an idempotent retry, not a
            # regression — a coordinator may repeat a write it cannot
            # prove landed
            await s.update_fleet_spec(sample_spec(version=3).to_json())
        finally:
            await env.cleanup()

    async def test_journal_round_trip_and_id_regression(self, dialect,
                                                        tmp_path):
        env = FleetStoreEnv(dialect, tmp_path)
        try:
            s1 = await env.make()
            assert await s1.get_fleet_journal(7) is None
            assert await s1.get_fleet_journals() == {}
            await s1.update_fleet_journal(7, sample_journal())
            await s1.update_fleet_journal(9, sample_journal())

            s2 = await env.make()
            back = ActuationJournal.from_json(await s2.get_fleet_journal(7))
            assert back.pending() is not None
            assert back.pending().verb == VERB_CREATE
            assert set((await s2.get_fleet_journals()).keys()) == {7, 9}
            # next_id moving backwards = a stale coordinator's write
            with pytest.raises(EtlError) as e:
                await s2.update_fleet_journal(7, {"next_id": 1,
                                                  "entries": []})
            assert e.value.kind is ErrorKind.PROGRESS_REGRESSION
        finally:
            await env.cleanup()


class TestFleetCommitFailpoint:
    async def test_refused_spec_write_mutates_nothing(self):
        from etl_tpu_torch.chaos import failpoints

        store = MemoryStore()

        def boom():
            raise EtlError(ErrorKind.STATE_STORE_FAILED, "chaos")

        failpoints.arm(failpoints.STORE_FLEET_COMMIT, boom)
        try:
            with pytest.raises(EtlError):
                await store.update_fleet_spec(sample_spec().to_json())
            assert await store.get_fleet_spec() is None
        finally:
            failpoints.disarm_all()

    async def test_refused_journal_write_mutates_nothing(self):
        from etl_tpu_torch.chaos import failpoints

        store = MemoryStore()
        await store.update_fleet_journal(3, sample_journal())

        def boom():
            raise EtlError(ErrorKind.STATE_STORE_FAILED, "chaos")

        failpoints.arm(failpoints.STORE_FLEET_COMMIT, boom)
        try:
            with pytest.raises(EtlError):
                await store.update_fleet_journal(3, {"next_id": 5,
                                                     "entries": []})
        finally:
            failpoints.disarm_all()
        # the journal the coordinator reads back is the pre-crash one
        kept = ActuationJournal.from_json(await store.get_fleet_journal(3))
        assert kept.next_id == sample_journal()["next_id"]

    async def test_site_is_registered_for_chaos_runs(self):
        from etl_tpu_torch.chaos import failpoints

        assert failpoints.STORE_FLEET_COMMIT in failpoints.CHAOS_SITES
        assert failpoints.STORE_FLEET_COMMIT in failpoints.ASYNC_STALL_SITES


class TestShardScopedFleetSurface:
    async def test_reads_forward_and_writes_refuse(self):
        from etl_tpu_torch.sharding.runtime import ShardIdentity, ShardScopedStore

        store = MemoryStore()
        scoped = ShardScopedStore(store, ShardIdentity(1, 0, 2, 0))
        await store.update_fleet_spec(sample_spec().to_json())
        await store.update_fleet_journal(1, sample_journal())

        # a pod may inspect the fleet's desired state...
        spec = FleetSpec.from_json(await scoped.get_fleet_spec())
        assert spec.spec_version == 1
        assert (await scoped.get_fleet_journal(1))["next_id"] == 2
        assert set((await scoped.get_fleet_journals()).keys()) == {1}

        # ...but only the coordinator, on the RAW store, may move it
        with pytest.raises(EtlError) as e:
            await scoped.update_fleet_spec(sample_spec(version=2).to_json())
        assert e.value.kind is ErrorKind.SHARD_NOT_OWNED
        with pytest.raises(EtlError) as e:
            await scoped.update_fleet_journal(1, sample_journal())
        assert e.value.kind is ErrorKind.SHARD_NOT_OWNED


# -- test_fleet_api.py -----------------------------------------------------

class _MinimalOrchestrator(Orchestrator):
    async def start_pipeline(self, spec):
        pass

    async def stop_pipeline(self, pipeline_id):
        pass

    async def status(self, pipeline_id):
        return ReplicatorStatus(pipeline_id, "stopped")


class _Proc:
    def __init__(self, returncode=None):
        self.returncode = returncode


class TestListPipelines:
    async def test_base_orchestrator_refuses_with_typed_error(self):
        with pytest.raises(EtlError) as e:
            await _MinimalOrchestrator().list_pipelines()
        assert e.value.kind is ErrorKind.CONFIG_INVALID
        assert "list-capable" in str(e.value)

    async def test_local_counts_shard_keys_including_exited(self, tmp_path):
        orch = LocalOrchestrator(str(tmp_path))
        orch._procs = {1: _Proc(),
                       (2, 0): _Proc(), (2, 1): _Proc(),
                       # a crashed shard still COUNTS: presence is
                       # registration — the reconciler must not
                       # re-create over a crash-restart window
                       (2, 2): _Proc(returncode=1)}
        assert await orch.list_pipelines() == {1: 1, 2: 3}
        assert await LocalOrchestrator(str(tmp_path)).list_pipelines() == {}

    async def test_k8s_inventory_groups_shards_by_pipeline_label(self):
        server = RecordingHttpServer()
        await server.start()
        try:
            def responder(req):
                if req.path.endswith("/statefulsets"):
                    assert req.query.get("labelSelector") \
                        == "app=etl-replicator"
                    mk = lambda name, pid: {  # noqa: E731
                        "metadata": {"name": name,
                                     "labels": {"pipeline_id": str(pid)}}}
                    return 200, {"items": [
                        mk("etl-replicator-3", 3),
                        mk("etl-replicator-4-s0", 4),
                        mk("etl-replicator-4-s1", 4),
                        # stale unsharded set caught mid-roll: the
                        # per-shard sets win
                        mk("etl-replicator-4", 4),
                        # unparseable label: skipped, not fatal
                        {"metadata": {"name": "etl-replicator-x",
                                      "labels": {"pipeline_id": "nope"}}},
                    ]}
                return None

            server.responders.append(responder)
            orch = K8sOrchestrator(api_url=server.url(), namespace="etl")
            assert await orch.list_pipelines() == {3: 1, 4: 2}
            await orch.shutdown()
        finally:
            await server.stop()

    async def test_k8s_list_error_is_typed_not_empty(self):
        """An API-server failure must raise, never read as 'fleet is
        empty' — an empty observation would make the reconciler
        re-create every pipeline."""
        server = RecordingHttpServer()
        await server.start()
        try:
            server.responders.append(lambda req: (500, {"message": "boom"}))
            orch = K8sOrchestrator(api_url=server.url(), namespace="etl")
            with pytest.raises(EtlError) as e:
                await orch.list_pipelines()
            assert e.value.kind is ErrorKind.DESTINATION_FAILED
            await orch.shutdown()
        finally:
            await server.stop()


def _k8s_health_responder(health_status=200, health_body=None):
    """statefulset ready + one Running pod + scripted /health body."""

    def responder(req):
        if "/proxy/health" in req.path:
            return health_status, health_body
        if "/pods" in req.path:
            return 200, {"items": [{
                "metadata": {"name": "etl-replicator-9-0"},
                "status": {"phase": "Running",
                           "containerStatuses": [{"ready": True,
                                                  "state": {}}]},
            }]}
        if req.path.endswith("/statefulsets/etl-replicator-9"):
            return 200, {"status": {"readyReplicas": 1}}
        if req.path.endswith("/statefulsets"):
            return 200, {"items": []}  # unsharded (no -sN sets)
        return None

    return responder


class TestPodHealthProbes:
    async def test_degraded_health_surfaces_reasons(self):
        server = RecordingHttpServer()
        await server.start()
        try:
            server.responders.append(_k8s_health_responder(
                200, {"status": "degraded",
                      "reasons": {"apply_loop": "stalled 12s",
                                  "slot_lag": "384MiB"}}))
            orch = K8sOrchestrator(api_url=server.url(), namespace="etl")
            st = await orch.status(9)
            assert st.state == "running"
            assert st.reasons == ("apply_loop: stalled 12s",
                                  "slot_lag: 384MiB")
            assert st.detail.startswith("degraded: ")
            await orch.shutdown()
        finally:
            await server.stop()

    async def test_faulted_health_fails_a_ready_pod(self):
        """A pod can be k8s-Ready while its apply loop is faulted — the
        probe sees what readiness cannot. 503 is a meaningful answer."""
        server = RecordingHttpServer()
        await server.start()
        try:
            server.responders.append(_k8s_health_responder(
                503, {"status": "faulted", "fatal": "slot dropped"}))
            orch = K8sOrchestrator(api_url=server.url(), namespace="etl")
            st = await orch.status(9)
            assert st.state == "failed"
            assert "slot dropped" in st.detail
            await orch.shutdown()
        finally:
            await server.stop()

    async def test_healthy_probe_and_probe_misses_stay_running(self):
        server = RecordingHttpServer()
        await server.start()
        try:
            responders = [_k8s_health_responder(200, {"status": "ok"})]
            server.responders.append(lambda req: responders[-1](req))
            orch = K8sOrchestrator(api_url=server.url(), namespace="etl")
            assert (await orch.status(9)).state == "running"
            # transport-level miss (proxy 404, no body): no evidence,
            # k8s readiness stands
            responders.append(_k8s_health_responder(404, None))
            assert (await orch.status(9)).state == "running"
            # unparseable body: same
            responders.append(_k8s_health_responder(200, {"raw": "huh"}))
            assert (await orch.status(9)).state == "running"
            await orch.shutdown()
        finally:
            await server.stop()


class _FleetStubOrchestrator(Orchestrator):
    def __init__(self, observed, statuses):
        self.observed = observed
        self.statuses = statuses

    async def start_pipeline(self, spec):
        pass

    async def stop_pipeline(self, pipeline_id):
        pass

    async def list_pipelines(self):
        return dict(self.observed)

    async def status(self, pipeline_id):
        return self.statuses.get(
            pipeline_id, ReplicatorStatus(pipeline_id, "stopped"))


async def _fleet_client(tmp_path, fleet_store, orchestrator,
                        fleet_lag_of=None):
    state = ApiState(str(tmp_path / "api.db"),
                     ConfigCipher(EncryptionKey.generate()),
                     orchestrator, fleet_store=fleet_store,
                     fleet_lag_of=fleet_lag_of)
    client = TestClient(TestServer(build_app(state)))
    await client.start_server()
    return client


class TestFleetEndpoint:
    async def test_aggregated_fleet_view(self, tmp_path):
        store = MemoryStore()
        spec = FleetSpec(
            spec_version=5,
            pipelines=(
                PipelineSpec(pipeline_id=1, tenant_id="acme",
                             shard_count=2, profile="insert_heavy"),
                PipelineSpec(pipeline_id=2, tenant_id="globex",
                             shard_count=1, profile="tiny_txs"),
                PipelineSpec(pipeline_id=3, tenant_id="acme",
                             shard_count=1, profile="giant_tx"),
            ),
            quotas={"acme": TenantQuota(max_shards=3, slo_weight=2.0)})
        await store.update_fleet_spec(spec.to_json())
        orch = _FleetStubOrchestrator(
            observed={1: 2, 2: 1, 7: 1},  # 3 missing, 7 is a stray
            statuses={
                1: ReplicatorStatus(1, "running"),
                2: ReplicatorStatus(2, "running",
                                    "degraded: slot_lag: 1GiB",
                                    reasons=("slot_lag: 1GiB",)),
                7: ReplicatorStatus(7, "running"),
            })
        lags = {1: 512, 2: 1 << 30, 3: None, 7: 0}

        async def lag_of(pid):
            return lags.get(pid)

        client = await _fleet_client(tmp_path, store, orch, lag_of)
        try:
            doc = await (await client.get("/v1/fleet")).json()
            assert doc["spec_version"] == 5
            assert doc["converged"] is False  # 3 missing, 7 stray
            assert doc["counts"] == {
                "desired": 3, "observed": 3,
                "by_state": {"running": 3, "stopped": 1}}
            assert doc["degraded_reasons"] == {"slot_lag: 1GiB": 1}
            assert doc["quotas"]["acme"]["max_shards"] == 3
            rows = {p["pipeline_id"]: p for p in doc["pipelines"]}
            assert set(rows) == {1, 2, 3, 7}
            assert rows[1]["desired_shards"] == 2
            assert rows[1]["observed_shards"] == 2
            assert rows[1]["lag_bytes"] == 512
            assert rows[2]["degraded_reasons"] == ["slot_lag: 1GiB"]
            assert rows[3]["state"] == "stopped"
            assert rows[3]["observed_shards"] == 0
            assert rows[3]["tenant_id"] == "acme"
            # the stray has no spec row: tenant/profile are null
            assert rows[7]["tenant_id"] is None
            assert rows[7]["desired_shards"] == 0
        finally:
            await client.close()

    async def test_converged_fleet_and_no_store(self, tmp_path):
        store = MemoryStore()
        spec = FleetSpec(
            spec_version=1,
            pipelines=(PipelineSpec(pipeline_id=1, tenant_id="a"),))
        await store.update_fleet_spec(spec.to_json())
        orch = _FleetStubOrchestrator(
            observed={1: 1},
            statuses={1: ReplicatorStatus(1, "running")})
        client = await _fleet_client(tmp_path, store, orch)
        try:
            doc = await (await client.get("/v1/fleet")).json()
            assert doc["converged"] is True
            assert doc["pipelines"][0]["lag_bytes"] is None  # no reader
        finally:
            await client.close()
        # no fleet store wired: the endpoint answers (empty spec), it
        # does not 500 — the console works on non-fleet deployments too
        client = await _fleet_client(tmp_path, None, orch)
        try:
            doc = await (await client.get("/v1/fleet")).json()
            assert doc["spec_version"] == 0
            assert doc["converged"] is False  # stray pipeline 1
        finally:
            await client.close()

    async def test_list_incapable_orchestrator_degrades_gracefully(
            self, tmp_path):
        client = await _fleet_client(tmp_path, MemoryStore(),
                                     _MinimalOrchestrator())
        try:
            resp = await client.get("/v1/fleet")
            assert resp.status == 200
            doc = await resp.json()
            assert doc["counts"]["observed"] == 0
        finally:
            await client.close()

    def test_openapi_documents_the_route(self):
        assert "/v1/fleet" in OPENAPI_DOC["paths"]


# -- the reference's fleet runs on the same seeds ------------------------------

SEEDS = [7, 11, 23]


def _load(name: str, path: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def reference_admission():
    """The reference's fleet runs write SLO weights into the reference's
    process-wide scheduler: dropped after each test."""
    yield
    from etl_tpu.ops.pipeline import reset_global_admission as ref_reset

    ref_reset()


@pytest.mark.parametrize("seed", SEEDS)
def test_fleet_chaos_equals_reference(seed, reference_admission):
    """`run_fleet_chaos` (100 pipelines, one versioned edit, the kills in
    both crash windows, the bus's three plugins): every field of the
    port's `FleetChaosRun` equals the reference's."""
    import dataclasses

    from etl_tpu.chaos.fleet import run_fleet_chaos as ref_run
    from etl_tpu_torch.chaos.fleet import run_fleet_chaos

    port = asyncio.run(run_fleet_chaos(seed=seed))
    ref = asyncio.run(ref_run(seed=seed))
    assert ref.ok, ref.failures
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.describe() == ref.describe()


def _reference_fleet_trace(seed: int, fleet_size: int = 100,
                           converge_ticks_max: int = 3) -> dict:
    """The reference's `bench.py::run_fleet_bench` drive on the
    reference's modules, keeping what its report leaves out: the
    actuation trace itself."""
    from etl_tpu.fleet import (FleetReconciler, PipelineSpec,
                               SimulatedFleetRuntime, seeded_fleet_spec)
    from etl_tpu.store.memory import MemoryStore as RefMemoryStore

    async def drive():
        store = RefMemoryStore()
        runtime = SimulatedFleetRuntime(seed=seed)
        spec = seeded_fleet_spec(seed, fleet_size)
        await store.update_fleet_spec(spec.to_json())
        reconciler = FleetReconciler(store=store, runtime=runtime)
        ticks = await reconciler.converge(max_ticks=converge_ticks_max + 1)
        edited = spec.with_edit(
            remove=[1, 2], resize={10: 6, 11: 1},
            add=[PipelineSpec(pipeline_id=fleet_size + 1,
                              tenant_id="tenant-edit", shard_count=2)])
        await store.update_fleet_spec(edited.to_json())
        edit_ticks = await reconciler.converge(
            max_ticks=converge_ticks_max + 1)
        return {"ticks": ticks, "edit_ticks": edit_ticks,
                "actuations": list(runtime.actuation_log)}

    return asyncio.run(drive())


@pytest.mark.parametrize("seed", SEEDS)
def test_fleet_bench_equals_reference(seed, reference_admission):
    """The port's `run_fleet_bench` and the reference's root
    `bench.run_fleet_bench`: the same report (but the wall clock), and
    the same actuation trace bit for bit (its sha256 digest too)."""
    from etl_tpu_torch.benchmarks.harness import (actuation_digest,
                                                  run_fleet_bench)

    ref_bench = _load("_bench_ref_fleet", os.path.join(ROOT, "bench.py"))
    port = run_fleet_bench(seed=seed)
    ref = ref_bench.run_fleet_bench(seed=seed)
    assert ref["ok"], ref["failures"]
    for key in ref:
        if not key.endswith("wall_clock_s"):
            assert port[key] == ref[key], key
    trace = _reference_fleet_trace(seed)
    assert (port["converge_ticks"], port["edit_converge_ticks"]) \
        == (trace["ticks"], trace["edit_ticks"])
    assert port["actuation_trace"] == trace["actuations"]
    assert port["actuation_digest"] == actuation_digest(trace["actuations"])


def _chip_smoke():
    return _load("_chip_smoke_fleet", os.path.join(ROOT, "chip_smoke.py"))


def test_chip_smoke_pins_the_reference_runs(reference_admission):
    """chip_smoke.py phase 18(b) holds the card's runs to constants: they
    are the reference's seed-7 chaos run and bench trace."""
    from etl_tpu.chaos.fleet import run_fleet_chaos as ref_run

    cs = _chip_smoke()
    ref = asyncio.run(ref_run(seed=7)).describe()
    assert {k: ref[k] for k in cs.FLEET_CHAOS_SEED7} == cs.FLEET_CHAOS_SEED7
    ref_bench = _load("_bench_ref_fleet", os.path.join(ROOT, "bench.py"))
    gate = ref_bench.run_fleet_bench(seed=7)
    from etl_tpu_torch.benchmarks.harness import actuation_digest

    want = {k: v for k, v in cs.FLEET_BENCH_SEED7.items()
            if k not in ("actuation_digest", "observed_equals_placement")}
    assert {k: gate[k] for k in want} == want
    assert cs.FLEET_BENCH_SEED7["actuation_digest"] == actuation_digest(
        _reference_fleet_trace(7)["actuations"])


@pytest.mark.parametrize("argv,pinned", [
    (["-m", "etl_tpu_torch.chaos", "--fleet", "--seed", "7"],
     "FLEET_CHAOS_SEED7"),
    (["-m", "etl_tpu_torch.bench", "--fleet"], "FLEET_BENCH_SEED7")],
    ids=["chaos_fleet", "bench_fleet"])
def test_fleet_clis_run_without_a_card(argv, pinned):
    """Both fleet entry points are arithmetic: they run with no card and
    no `--device cpu`, exit 0 and print what phase 18(b) pins."""
    import json
    import subprocess
    import sys

    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, *argv], capture_output=True,
                          text=True, timeout=240, cwd=ROOT, env=env)
    assert proc.returncode == 0, proc.stderr[-2000:]
    doc = json.loads(proc.stdout.strip().splitlines()[-1])
    want = getattr(_chip_smoke(), pinned)
    assert {k: doc[k] for k in want} == want


# -- the reconciler over real replicator children ------------------------------


class TestOrchestratorFleetRuntime:
    async def test_create_resize_delete_over_local_children(self):
        """`run_fleet_children` on the CPU at a small size (chip_smoke.py
        18(c)): A (K = 1) and B (K = 2) created from empty, B deleted and
        A resized to 2 with the coordinator killed in both crash windows,
        A removed; `list_pipelines` equals the placement after each
        convergence, every key once, no double actuation, no child
        left. Time-boxed."""
        from etl_tpu_torch.benchmarks.fleet import run_fleet_children

        r = await asyncio.wait_for(
            run_fleet_children(500, 1_000, device="cpu"), 240)
        assert r["ok"], r["checks"]
        assert r["observed_initial"] == r["placed_initial"] == {1: 1, 2: 2}
        assert r["observed_edit"] == r["placed_edit"] == {1: 2}
        assert r["observed_end"] == r["placed_end"] == {}
        assert [k["mode"] for k in r["kills"]] == ["settle", "redrive"]
        assert r["double_actuations"] == 0
        assert [a["verb"] for a in r["actuations"]] \
            == ["create", "create", "delete", "resize"]

    async def test_admission_weights_on_live_pipelines(self):
        """`run_admission_weights` on the CPU (chip_smoke.py 18(d)): the
        bus's boosted and base weights reach the process's scheduler, both
        streams verified, the scheduler drained."""
        from etl_tpu_torch.benchmarks.fleet import run_admission_weights

        r = await asyncio.wait_for(
            run_admission_weights(2_000, device="cpu"), 120)
        assert r["ok"], r["checks"]
        weights = sorted(r["applied_weights"].values())
        assert weights == [0.5, 3.0]
