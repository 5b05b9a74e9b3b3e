"""The port's lake maintenance (`etl_tpu_torch/maintenance.py`) and its
coordination (`etl_tpu_torch/maintenance_coordination.py`), with the
error webhook, held to the reference's on the CPU.

1. The classes of `tests/test_maintenance_notify.py` on the port's
   modules: `run_maintenance` (compact, vacuum, the control plane's
   pause and resume with the bearer key, the pause poll's abort, the
   operation policy and its history), the error webhook, and the
   coordination protocol (request, pause lease, execute, history,
   cooldowns, lease expiry, two controllers, the agent's tick on a
   worker thread).
2. Parity: the same seeded lake written by each package, then each
   package's `run_maintenance` with vacuum, and a coordinated pass (the
   agent's request, the controller's lease and run) on each: equal
   reports, maintenance history (timestamps masked), coordination state
   (timestamps and run ids masked) and current views.
3. The CLI in process: `--history`, the one-pass maintenance, and the
   typed refusal where pyarrow cannot be imported (exit 2 before any
   pause, CONFIG_INVALID naming pyarrow).

Every test is async (boxed by the conftest's 120 s); the agent's ticks
run on the loop's default executor, which `asyncio.run` joins when the
test's loop ends, so no thread outlives its test. No child process, no
spinner.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_maintenance.py -q

Tolerance: exact.
"""

import asyncio
import contextlib
import io
import json
import logging
import random

import pytest

from etl_tpu_torch.destinations.lake import LakeConfig, LakeDestination
from etl_tpu_torch.maintenance import run_maintenance
from etl_tpu_torch.telemetry.notify import WebhookErrorNotifier
from etl_tpu_torch.telemetry.tracing import set_error_hook
from etl_tpu_torch.testing.fake_http import RecordingHttpServer
from tests.test_torch_lake import TID, _m, batch, ins, make_schema

REF, PORT = "etl_tpu", "etl_tpu_torch"
SEED = 20261018


# -- 1. the reference's cases on the port --------------------------------------


class TestMaintenance:
    async def test_compact_and_vacuum(self, tmp_path):
        d = LakeDestination(LakeConfig(str(tmp_path), compact_min_files=99))
        await d.startup()
        await d.write_table_rows(make_schema(), batch([[1, "a", None]]))
        for i in range(3):
            await d.write_events([ins(0, [10 + i, "x", None],
                                      lsn=0x100 + 16 * i)])
        # truncate bumps the generation, leaving old-generation files
        from etl_tpu_torch.models import Lsn, TruncateEvent

        await d.write_events([TruncateEvent(Lsn(1), Lsn(1), 0, 0,
                                            (make_schema(),))])
        await d.write_events([ins(0, [50, "post", None], lsn=0x500)])
        await d.shutdown()

        out = await run_maintenance(str(tmp_path), vacuum=True,
                                    api_url=None, pipeline_id=None,
                                    tenant_id=None)
        assert out["tables"] == 1
        assert out["vacuumed_files"] >= 4  # old generation cleaned
        reader = LakeDestination(LakeConfig(str(tmp_path)))
        await reader.startup()
        assert [r["id"] for r in reader.read_current(TID).to_pylist()] == [50]
        await reader.shutdown()

    async def test_pause_resume_via_api(self, tmp_path):
        server = RecordingHttpServer()
        await server.start()
        # maintenance polls /status until the pipeline is fully stopped
        # before touching the lake (pause-coordination race fix)
        server.responders.append(
            lambda r: (200, {"state": "stopped"})
            if r.path.endswith("/status") else None)
        try:
            d = LakeDestination(LakeConfig(str(tmp_path)))
            await d.startup()
            await d.write_table_rows(make_schema(), batch([[1, "a", None]]))
            await d.shutdown()
            await run_maintenance(str(tmp_path), vacuum=False,
                                  api_url=server.url(), pipeline_id=7,
                                  tenant_id="acme")
            paths = server.paths()
            assert paths[0] == "POST /v1/pipelines/7/stop"
            assert paths[-1] == "POST /v1/pipelines/7/start"
        finally:
            await server.stop()

    async def test_api_key_sent_as_bearer(self, tmp_path):
        """A secured control plane rejects unauthenticated /v1 calls with
        401; coordination must carry the bearer token on every call."""
        server = RecordingHttpServer()
        await server.start()
        server.responders.append(
            lambda r: (200, {"state": "stopped"})
            if r.path.endswith("/status") else None)
        try:
            d = LakeDestination(LakeConfig(str(tmp_path)))
            await d.startup()
            await d.write_table_rows(make_schema(), batch([[1, "a", None]]))
            await d.shutdown()
            await run_maintenance(str(tmp_path), vacuum=False,
                                  api_url=server.url(), pipeline_id=7,
                                  tenant_id="acme", api_key="sekrit")
            assert server.requests
            for req in server.requests:
                assert req.headers.get("Authorization") == "Bearer sekrit"
        finally:
            await server.stop()


class TestWebhookNotifier:
    async def test_error_posts_webhook(self):
        server = RecordingHttpServer()
        await server.start()
        try:
            n = WebhookErrorNotifier(server.url() + "/hook", pipeline_id=3,
                                     min_interval_s=0)
            n.install()
            logging.getLogger("etl_tpu_torch.test").error("boom %s", "now")
            for _ in range(100):
                if server.requests:
                    break
                await asyncio.sleep(0.02)
            assert server.requests, "webhook never fired"
            doc = server.requests[0].json
            assert doc["pipeline_id"] == 3
            assert doc["message"] == "boom now"
            await n.close()
        finally:
            set_error_hook(lambda r: None)
            await server.stop()

    async def test_rate_limited(self):
        server = RecordingHttpServer()
        await server.start()
        try:
            n = WebhookErrorNotifier(server.url(), min_interval_s=60)
            n.install()
            for _ in range(5):
                logging.getLogger("etl_tpu_torch.test").error("burst")
            await asyncio.sleep(0.2)
            assert len(server.requests) == 1  # only the first within window
            await n.close()
        finally:
            set_error_hook(lambda r: None)
            await server.stop()


class TestMaintenancePausePoll:
    async def test_aborts_if_never_stopped(self, tmp_path):
        """If the pipeline never reaches 'stopped', maintenance must abort
        rather than compact under a live writer."""
        server = RecordingHttpServer()
        await server.start()
        server.responders.append(
            lambda r: (200, {"state": "stopping"})
            if r.path.endswith("/status") else None)
        try:
            with pytest.raises(RuntimeError, match="did not reach 'stopped'"):
                await run_maintenance(str(tmp_path), vacuum=False,
                                      api_url=server.url(), pipeline_id=7,
                                      tenant_id="acme", stop_timeout_s=0.3)
            # the abort must still resume the (successfully paused)
            # pipeline — otherwise replication stays down on timeout
            assert server.paths()[-1] == "POST /v1/pipelines/7/start"
        finally:
            await server.stop()


class TestMaintenancePolicyAndHistory:
    async def test_policy_skips_small_tables_and_records_history(
            self, tmp_path):
        d = LakeDestination(LakeConfig(str(tmp_path), compact_min_files=100))
        await d.startup()
        # one table with 3 CDC files, one with 1
        await d.write_events([ins(0, [1, "a", None])])
        await d.write_events([ins(1, [2, "b", None])])
        await d.write_events([ins(2, [3, "c", None])])
        await d.shutdown()
        out = await run_maintenance(str(tmp_path), vacuum=True,
                                    api_url=None, pipeline_id=None,
                                    tenant_id=None, min_cdc_files=2)
        assert out["compacted_files"] >= 3
        assert out["skipped_by_policy"] == 0
        hist = out["history"]
        assert hist and hist[0]["operation"] in ("vacuum", "compact")
        assert all(h["outcome"] in ("ok", "skipped") for h in hist)
        # run again: now a single base file → policy skips compaction
        out2 = await run_maintenance(str(tmp_path), vacuum=False,
                                     api_url=None, pipeline_id=None,
                                     tenant_id=None, min_cdc_files=2)
        assert out2["compacted_files"] == 0
        assert out2["skipped_by_policy"] == 1


class TestMaintenanceCoordination:
    """External-maintenance coordination through the catalog store
    (reference etl-maintenance coordination.rs: operation requests,
    pause lease with max-pause, per-operation cooldowns, history)."""

    def make_parts(self, tmp_path, **policy_kw):
        from etl_tpu_torch.maintenance_coordination import (
            CatalogMaintenanceStore, MaintenanceController,
            MaintenancePolicy, ReplicatorMaintenanceAgent)

        lake = LakeDestination(LakeConfig(str(tmp_path),
                                          compact_min_files=99))
        policy = MaintenancePolicy(**policy_kw)
        store = CatalogMaintenanceStore(str(tmp_path), 1)
        pauses = []
        agent = ReplicatorMaintenanceAgent(
            store, policy,
            pause=lambda: pauses.append("pause"),
            resume=lambda: pauses.append("resume"))
        ctrl = MaintenanceController(store, lake, policy)
        return lake, store, agent, ctrl, pauses

    async def seed(self, lake, n_cdc=3):
        await lake.startup()
        await lake.write_table_rows(make_schema(),
                                    batch([[1, "a", None]]))
        for i in range(n_cdc):
            await lake.write_events([ins(0, [10 + i, "x", None],
                                         lsn=0x100 + 16 * i)])

    async def test_request_pause_execute_history_cycle(self, tmp_path):
        lake, store, agent, ctrl, pauses = self.make_parts(
            tmp_path, merge_min_cdc_files=2, request_cooldown_seconds=0.0)
        await self.seed(lake)
        # replicator samples → posts a merge request
        state = agent.tick()
        assert state.request_operations.merge_adjacent_files
        assert not state.request_operations.inline_flush
        # controller takes the lease and runs; a background agent tick
        # honors the pause so the controller sees replicator_paused
        async def keep_ticking():
            for _ in range(100):
                agent.tick()
                await asyncio.sleep(0.01)

        tick_task = asyncio.ensure_future(keep_ticking())
        report = await ctrl.run_once(wait_for_pause_s=2.0)
        tick_task.cancel()
        assert report["replicator_paused"] is True
        assert report["operations"]["merge_adjacent_files"] >= 2
        assert pauses[0] == "pause"
        # lease cleared → next tick resumes the replicator
        agent.tick()
        assert pauses[-1] == "resume"
        st = store.load()
        assert st.pause_run_id is None
        assert st.last_completed_at is not None
        assert "merge_adjacent_files" in st.last_successful
        # request consumed
        assert not st.request_operations.merge_adjacent_files
        store.close()
        await lake.shutdown()

    async def test_operation_cooldown_skips_repeat_runs(self, tmp_path):
        lake, store, agent, ctrl, _ = self.make_parts(
            tmp_path, merge_min_cdc_files=2,
            request_cooldown_seconds=3600.0)
        await self.seed(lake)
        agent.tick()
        report = await ctrl.run_once(wait_for_pause_s=0.0)
        assert "merge_adjacent_files" in report["operations"]
        # more CDC files arrive; the request re-posts but the operation
        # is cooling down → the controller skips it
        await lake.write_events([ins(0, [90, "y", None], lsn=0x900)])
        await lake.write_events([ins(0, [91, "z", None], lsn=0x910)])
        # force a fresh request despite the request cooldown window
        def reset_request(st):
            st.request_at = None
            st.request_operations.merge_adjacent_files = True

        store.mutate(reset_request)
        report2 = await ctrl.run_once(wait_for_pause_s=0.0)
        assert report2.get("skipped", "").startswith("no operations")
        store.close()
        await lake.shutdown()

    async def test_pause_lease_expiry_self_resumes(self, tmp_path):
        """If the controller dies mid-run the replicator must resume on
        lease expiry (max_pause), not stay paused forever."""
        import time as _t

        lake, store, agent, ctrl, pauses = self.make_parts(
            tmp_path, max_pause_seconds=1000.0)
        await self.seed(lake, n_cdc=0)
        now = _t.time()

        def dead_controller(st):
            st.pause_run_id = "dead"
            st.pause_requested_at = now - 2000.0  # lease long expired
            st.pause_max_pause_s = 1000.0

        store.mutate(dead_controller)
        agent.tick()
        assert agent.paused is False
        assert pauses == []  # expired lease never pauses
        # a LIVE lease pauses...
        def live_controller(st):
            st.pause_run_id = "live"
            st.pause_requested_at = _t.time()

        store.mutate(live_controller)
        agent.tick()
        assert agent.paused is True
        store.close()
        await lake.shutdown()

    async def test_inline_flush_requested_by_bytes_threshold(self, tmp_path):
        from etl_tpu_torch.maintenance_coordination import (
            CatalogMaintenanceStore, MaintenanceController,
            MaintenancePolicy, ReplicatorMaintenanceAgent)

        lake = LakeDestination(LakeConfig(
            str(tmp_path), compact_min_files=99, inline_max_bytes=1 << 20,
            inline_flush_bytes=1 << 30))
        await lake.startup()
        await lake.write_table_rows(make_schema(), batch([[1, "a", None]]))
        for i in range(3):
            await lake.write_events([ins(0, [20 + i, "inline", None],
                                         lsn=0x200 + 16 * i)])
        assert lake.pending_inline_bytes(TID) > 0
        policy = MaintenancePolicy(inline_flush_min_inlined_bytes=1,
                                   request_cooldown_seconds=0.0)
        store = CatalogMaintenanceStore(str(tmp_path), 1)
        agent = ReplicatorMaintenanceAgent(store, policy)
        ctrl = MaintenanceController(store, lake, policy)
        st = agent.tick()
        assert st.request_operations.inline_flush
        report = await ctrl.run_once(wait_for_pause_s=0.0)
        assert report["operations"]["inline_flush"] == 3
        assert lake.pending_inline_bytes(TID) == 0
        store.close()
        await lake.shutdown()

    async def test_monitor_external_pause_composes_with_memory(self):
        from etl_tpu_torch.config.pipeline import MemoryBackpressureConfig
        from etl_tpu_torch.runtime.backpressure import MemoryMonitor

        rss = {"v": 0}
        mon = MemoryMonitor(MemoryBackpressureConfig(),
                            limit_bytes=100, rss_reader=lambda: rss["v"])
        mon.set_external_pause(True)
        assert mon.pressure is True
        # memory pressure rises while externally paused
        rss["v"] = 100
        mon.sample_once()
        assert mon.pressure is True
        # external pause lifts but memory still high → stays paused
        mon.set_external_pause(False)
        assert mon.pressure is True
        rss["v"] = 0
        mon.sample_once()
        assert mon.pressure is False

    async def test_two_controllers_cannot_both_take_the_lease(self, tmp_path):
        lake, store, agent, ctrl, _ = self.make_parts(
            tmp_path, merge_min_cdc_files=2, request_cooldown_seconds=0.0)
        await self.seed(lake)
        agent.tick()
        from etl_tpu_torch.maintenance_coordination import MaintenanceController

        ctrl2 = MaintenanceController(store, lake, ctrl.policy)
        r1, r2 = await asyncio.gather(
            ctrl.run_once(wait_for_pause_s=0.0),
            ctrl2.run_once(wait_for_pause_s=0.0))
        ran = [r for r in (r1, r2) if "operations" in r]
        skipped = [r for r in (r1, r2) if "skipped" in r]
        assert len(ran) == 1 and len(skipped) == 1
        assert skipped[0]["skipped"].startswith("run already active") or \
            skipped[0]["skipped"].startswith("no operations")
        store.close()
        await lake.shutdown()

    async def test_operator_vacuum_runs_without_request(self, tmp_path):
        """--vacuum maps to cleanup_old_files_enabled: operator-driven,
        selected even though no replicator ever requests it."""
        from etl_tpu_torch.models import Lsn, TruncateEvent

        lake, store, _, _, _ = self.make_parts(tmp_path)
        await self.seed(lake)
        # truncate supersedes the old generation → vacuumable files
        await lake.write_events([TruncateEvent(Lsn(0x800), Lsn(0x800), 0,
                                               0, (make_schema(),))])
        from etl_tpu_torch.maintenance_coordination import (MaintenanceController,
                                                      MaintenancePolicy)

        ctrl = MaintenanceController(
            store, lake,
            MaintenancePolicy(cleanup_old_files_enabled=True))
        report = await ctrl.run_once(wait_for_pause_s=0.0)
        assert report["operations"]["cleanup_old_files"] >= 1
        st = store.load()
        assert "cleanup_old_files" in st.last_successful
        store.close()
        await lake.shutdown()

    async def test_stale_request_cleared_when_need_vanished(self, tmp_path):
        """A posted merge request whose CDC files were since compacted
        away must be consumed without pausing the pipeline."""
        lake, store, agent, ctrl, _ = self.make_parts(
            tmp_path, merge_min_cdc_files=2, request_cooldown_seconds=0.0)
        await self.seed(lake)
        agent.tick()  # posts merge request
        await lake.compact(TID)  # need vanishes out-of-band
        report = await ctrl.run_once(wait_for_pause_s=0.0)
        assert report["skipped"].startswith("no operations")
        st = store.load()
        assert not st.request_operations.merge_adjacent_files
        assert st.pause_run_id is None  # never paused
        store.close()
        await lake.shutdown()

    async def test_agent_tick_runs_on_worker_thread(self, tmp_path):
        """The production agent ticks via asyncio.to_thread while the
        pipeline's lake connection lives on the loop thread — sampling
        must ride the store's own thread-safe connection (a sqlite
        ProgrammingError would leave coordination silently dead)."""
        lake, store, agent, _, _ = self.make_parts(
            tmp_path, merge_min_cdc_files=2, request_cooldown_seconds=0.0)
        await self.seed(lake)
        state = await asyncio.to_thread(agent.tick)
        assert state.request_operations.merge_adjacent_files
        store.close()
        await lake.shutdown()


# -- 2. parity with the reference ----------------------------------------------


async def _seed_lake(pkg: str, root) -> None:
    """A lake of both tables of `tests/test_torch_lake.py`'s parity
    scenario, written by `pkg`: the pgbench-shaped events in chunks of
    5 (one CDC file each), a truncate of the first table and a write
    after it (old-generation files for vacuum)."""
    from tests.test_torch_destination_parity import _events
    from tests.test_torch_lake import _pg_events

    lake = _m(pkg, "destinations.lake")
    M = _m(pkg, "models")
    d = lake.LakeDestination(lake.LakeConfig(str(root),
                                             compact_min_files=99))
    await d.startup()
    ev = _events(pkg, None)
    await d.write_table_batch(ev["schema"], ev["copy"])
    await d.write_event_batches(ev["cdc"])
    await d.write_events([ev["truncate"]])
    await d.write_events([M.InsertEvent(M.Lsn(0xB000), M.Lsn(0xB000), 0,
                                        ev["schema"], M.TableRow(
                                            [5, 1, None, True, "after"]))])
    pg = _pg_events(pkg, SEED)
    for lo in range(0, len(pg), 5):
        await d.write_events(pg[lo:lo + 5])
    await d.shutdown()


def _masked_history(history: list) -> list:
    return [{k: v for k, v in h.items()
             if k not in ("started_at", "finished_at")} for h in history]


async def _views(pkg: str, root) -> dict:
    lake = _m(pkg, "destinations.lake")
    d = lake.LakeDestination(lake.LakeConfig(str(root)))
    await d.startup()
    out = {}
    for tid in d.table_ids():
        t = d.read_current(tid)
        key = t.column_names[0]
        out[tid] = (t.schema.to_string(),
                    sorted(t.to_pylist(), key=lambda r: r[key]))
    await d.shutdown()
    return out


async def _maintenance_run(pkg: str, root) -> dict:
    await _seed_lake(pkg, root)
    out = await _m(pkg, "maintenance").run_maintenance(
        str(root), vacuum=True, api_url=None, pipeline_id=None,
        tenant_id=None, min_cdc_files=3)
    out["history"] = _masked_history(out["history"])
    out["views"] = await _views(pkg, root)
    return out


async def _coordinated_run(pkg: str, root) -> dict:
    """The agent posts its request, the controller takes the lease and
    runs the merge with an operator vacuum, the agent honours and then
    releases the pause."""
    await _seed_lake(pkg, root)
    mc = _m(pkg, "maintenance_coordination")
    lake = _m(pkg, "destinations.lake")
    d = lake.LakeDestination(lake.LakeConfig(str(root)))
    await d.startup()
    policy = mc.MaintenancePolicy(merge_min_cdc_files=3,
                                  request_cooldown_seconds=0.0,
                                  cleanup_old_files_enabled=True,
                                  poll_seconds=0.01)
    store = mc.CatalogMaintenanceStore(str(root), 1)
    pauses: list = []
    agent = mc.ReplicatorMaintenanceAgent(
        store, policy, pause=lambda: pauses.append("pause"),
        resume=lambda: pauses.append("resume"))
    kw = {"rng": random.Random(SEED)} if pkg == PORT else {}
    ctrl = mc.MaintenanceController(store, d, policy, **kw)
    out: dict = {}
    try:
        requested = await asyncio.to_thread(agent.tick, 1000.0)
        out["requested"] = requested.request_operations.__dict__

        async def honour():
            # the replicator's side while the controller waits for it
            for _ in range(200):
                st = store.load()
                if st.pause_run_id is not None:
                    break
                await asyncio.sleep(0.01)
            return await asyncio.to_thread(agent.tick, 1001.0)

        report, paused = await asyncio.gather(
            ctrl.run_once(wait_for_pause_s=20.0, now=1001.0), honour())
        out["report"] = {k: v for k, v in report.items() if k != "run_id"}
        out["paused_state"] = paused.replicator_paused
        released = await asyncio.to_thread(agent.tick, 1002.0)
        state = {k: v for k, v in json.loads(released.to_json()).items()
                 if k not in ("last_successful", "last_completed_at",
                              "replicator_reported_at")}
        state["last_successful"] = sorted(
            json.loads(released.to_json())["last_successful"])
        out["state"] = state
        out["pauses"] = pauses
        out["again"] = await ctrl.run_once(wait_for_pause_s=0.0,
                                           now=1003.0)
        out["history"] = _masked_history(d.maintenance_history(limit=50))
    finally:
        store.close()
        await d.shutdown()
    out["views"] = await _views(pkg, root)
    return out


class TestMaintenanceEqualsReference:
    async def test_run_maintenance_equals_reference(self, tmp_path):
        want = await _maintenance_run(REF, tmp_path / "ref")
        got = await _maintenance_run(PORT, tmp_path / "port")
        assert got == want
        assert want["compacted_files"] > 0 and want["vacuumed_files"] > 0
        assert want["skipped_by_policy"] == 1

    async def test_coordinated_pass_equals_reference(self, tmp_path):
        want = await _coordinated_run(REF, tmp_path / "ref")
        got = await _coordinated_run(PORT, tmp_path / "port")
        assert got == want
        assert want["report"]["replicator_paused"] is True
        assert want["pauses"] == ["pause", "resume"]
        assert want["report"]["operations"]["merge_adjacent_files"] > 0


# -- 3. the CLI in process -----------------------------------------------------


def _cli(argv: list) -> tuple:
    from etl_tpu_torch.maintenance import main

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


class TestMaintenanceCli:
    async def test_one_pass_then_history(self, tmp_path):
        await _seed_lake(PORT, tmp_path)
        rc, out, err = await asyncio.to_thread(
            _cli, ["--warehouse", str(tmp_path), "--vacuum",
                   "--min-cdc-files", "3"])
        assert rc == 0, err
        doc = json.loads(out)
        assert doc["tables"] == 2 and doc["compacted_files"] > 0
        rc, out, err = await asyncio.to_thread(
            _cli, ["--warehouse", str(tmp_path), "--history"])
        assert rc == 0, err
        ops = {(h["operation"], h["outcome"])
               for h in json.loads(out)["history"]}
        assert ("compact", "ok") in ops and ("vacuum", "ok") in ops

    async def test_refused_typed_without_pyarrow(self, tmp_path,
                                                 monkeypatch):
        """Where pyarrow cannot be imported, the command exits 2 with the
        typed CONFIG_INVALID naming pyarrow, before it calls the control
        plane; `run_maintenance` raises it."""
        import sys

        from etl_tpu_torch.models.errors import ErrorKind, EtlError

        server = RecordingHttpServer()
        await server.start()
        try:
            monkeypatch.setitem(sys.modules, "pyarrow", None)
            monkeypatch.setitem(sys.modules, "pyarrow.parquet", None)
            rc, out, err = _cli(["--warehouse", str(tmp_path),
                                 "--api-url", server.url(),
                                 "--pipeline-id", "7"])
            assert rc == 2 and out == ""
            doc = json.loads(err)
            assert doc["kind"] == "CONFIG_INVALID"
            assert "pyarrow" in doc["error"]
            with pytest.raises(EtlError) as ei:
                await run_maintenance(str(tmp_path), vacuum=False,
                                      api_url=server.url(), pipeline_id=7,
                                      tenant_id="acme")
            assert ei.value.kind is ErrorKind.CONFIG_INVALID
            assert "pyarrow" in str(ei.value)
            assert server.requests == []  # nothing paused
        finally:
            await server.stop()
