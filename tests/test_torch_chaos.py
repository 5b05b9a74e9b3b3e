"""The port's chaos harness, held to the reference's tests/test_chaos.py:
the corpus by name (every scenario of the reference's corpus and its
workload matrix), each scenario the port runs green on the CPU at the
reference's size (`device="cpu"`: the kernels' plain versions) with the
same per-seed determinism (two runs of one seed describe the same run,
timings aside), the two program-cache scenarios green on the port's
program store with its counters checked, the seeded workloads equal to the reference's
(the same committed truth and the same WAL bytes for one seed), the
failpoint restart matrix, the CLI's replay and its typed refusals, the
multi-pipeline scenario over the port's `global_admission`, and the
invariant checker's falsifiability. Tolerance: none — equal traces,
equal truth, equal bytes.
"""

from __future__ import annotations

import json
import os
import random
import subprocess
import sys
import threading

import pytest

from etl_tpu.chaos import corpus as ref_corpus
from etl_tpu_torch.chaos import failpoints
from etl_tpu_torch.chaos.corpus import SCENARIOS, WORKLOAD_MATRIX, get_scenario
from etl_tpu_torch.chaos.invariants import (InvariantReport, LeakProbe,
                                            _pipeline_thread_count,
                                            check_invariants)
from etl_tpu_torch.chaos.runner import (RecordingStore, TracingDestination,
                                        run_scenario)
from etl_tpu_torch.chaos.scenario import FaultKind, FaultSpec, Scenario
from etl_tpu_torch.models.errors import ErrorKind
from etl_tpu_torch.ops import engine
from etl_tpu_torch.ops.pipeline import reset_global_admission

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 7
RUNNABLE = [s for s in SCENARIOS + WORKLOAD_MATRIX if not s.program_cache]


@pytest.fixture(autouse=True)
def _port_hygiene():
    yield
    engine.clear_forced_oracle()
    failpoints.disarm_all()
    reset_global_admission()


def _stable(d: dict) -> dict:
    """A run's description less what depends on the host's timing: the
    durations, the supervision events and what they fund (a watchdog
    restart lands where the scheduler puts it), and the delivered and
    duplicated counts a re-streamed window's size sets."""
    d = json.loads(json.dumps(d))
    for key in ("duration_s", "health_track", "supervision_restarts",
                "redelivery_firings"):
        d.pop(key, None)
    d["trace"] = {site: fires for site, fires in d["trace"].items()
                  if not site.startswith("supervision.")}
    for r in d["restarts"]:
        r.pop("recovery_s")
    stats = d["invariants"]["stats"]
    for key in ("delivered_events", "max_duplication",
                "duplication_budget"):
        stats.pop(key, None)
    return d


class TestCorpus:
    def test_corpus_names_equal_the_reference(self):
        assert [s.name for s in SCENARIOS] == \
            [s.name for s in ref_corpus.SCENARIOS]
        assert [s.name for s in WORKLOAD_MATRIX] == \
            [s.name for s in ref_corpus.WORKLOAD_MATRIX]
        # the same fault schedules and workload shapes
        for port, ref in zip(SCENARIOS + WORKLOAD_MATRIX,
                             ref_corpus.SCENARIOS
                             + ref_corpus.WORKLOAD_MATRIX):
            pd, rd = port.describe(), ref.describe()
            for d in (pd, rd):
                d.pop("description")
                d.pop("engine")
            assert pd == rd, port.name

    def test_corpus_covers_every_layer(self):
        sites = {f.site for s in SCENARIOS for f in s.faults}
        for site in (failpoints.PIPELINE_PACK, failpoints.PIPELINE_DISPATCH,
                     failpoints.PIPELINE_FETCH, failpoints.ENGINE_DEVICE_OOM,
                     failpoints.DURING_COPY, failpoints.COPY_PARTITION_START,
                     failpoints.ON_PROGRESS_STORE,
                     failpoints.STORE_STATE_COMMIT, "write_events"):
            assert site in sites
        crash_sites = {f.site for s in SCENARIOS for f in s.faults
                       if f.kind is FaultKind.CRASH}
        assert {failpoints.ON_PROGRESS_STORE,
                failpoints.DURING_COPY} <= crash_sites
        assert any(s.expect_restarts >= 2 for s in SCENARIOS)
        # the port's engines: the kernels, and the per-tuple engine once
        assert {s.engine for s in SCENARIOS} == {"cuda", "cpu"}

    @pytest.mark.parametrize("scenario", RUNNABLE, ids=lambda s: s.name)
    async def test_scenario_invariants_green_and_deterministic(
            self, scenario):
        a = await run_scenario(scenario, SEED, device="cpu")
        assert a.ok, a.describe()
        crashes = sum(1 for r in a.restarts if r.kind == "crash")
        assert crashes == sum(f.times for f in scenario.faults
                              if f.kind is FaultKind.CRASH), a.describe()
        b = await run_scenario(scenario, SEED, device="cpu")
        assert b.ok, b.describe()
        assert _stable(a.describe()) == _stable(b.describe())

    @pytest.mark.parametrize("scenario", RUNNABLE, ids=lambda s: s.name)
    async def test_scenario_green_with_every_batch_on_the_device_route(
            self, scenario):
        """`chip_smoke.py` phase 14's configuration: the decoder's floor
        at one row, so every batch of the CUDA engine goes through the
        kernels (here their plain versions), whatever its size."""
        from etl_tpu_torch.chaos.runner import device_floor

        b0 = engine.routed_device_batches
        with device_floor(1):
            run = await run_scenario(scenario, SEED, device="cpu")
        assert run.ok, run.describe()
        if scenario.engine == "cuda":
            assert engine.routed_device_batches > b0
        assert engine.DeviceDecoder.DEVICE_MIN_ROWS == 64  # restored

    @pytest.mark.parametrize("name", ["crash_restart_warm_programs",
                                      "crash_restart_corrupt_program_cache"])
    async def test_program_cache_scenarios_green(self, name):
        """The two scenarios on the port's program store, every batch on
        the device route (phase 14's configuration): the warm restart
        builds nothing and loads from disk; the corrupt one counts an
        invalid miss and rebuilds (the framer, with the C compiler)."""
        from etl_tpu_torch.chaos.runner import device_floor
        from etl_tpu_torch.ops import program_store

        b0 = engine.routed_device_batches
        with device_floor(1):
            run = await run_scenario(get_scenario(name), SEED, device="cpu")
        assert run.ok, run.describe()
        assert engine.routed_device_batches > b0
        pc = run.describe()["program_cache"]
        if name == "crash_restart_warm_programs":
            assert pc["compiled"] == 0 and pc["disk_hits"] >= 2
            assert pc["invalid"] == 0
        else:
            assert pc["invalid"] >= 1 and pc["compiled"] >= 1
        assert program_store.active_dir() is None  # the private dir goes

    async def test_device_oom_fails_its_batches_without_an_oracle_route(
            self):
        """The port has no per-batch OOM fallback: both firings fail their
        batches, which are re-streamed (no loss, duplicates within the
        budget they fund), and no batch is counted as degraded."""
        from etl_tpu_torch.telemetry.metrics import (
            ETL_DECODE_DEVICE_OOM_FALLBACKS_TOTAL, registry)

        before = registry.get_counter(ETL_DECODE_DEVICE_OOM_FALLBACKS_TOTAL)
        run = await run_scenario(get_scenario("device_oom_fallback"), SEED,
                                 device="cpu")
        assert run.ok, run.describe()
        fires = run.trace[failpoints.ENGINE_DEVICE_OOM]
        assert [f["action"] for f in fires] == ["error", "error"]
        assert run.redelivery_firings == 2
        assert registry.get_counter(
            ETL_DECODE_DEVICE_OOM_FALLBACKS_TOTAL) == before

    async def test_chaos_metrics_populated(self):
        from etl_tpu_torch.telemetry.metrics import (
            ETL_CHAOS_INJECTED_FAULTS_TOTAL,
            ETL_CHAOS_RECOVERY_DURATION_SECONDS,
            ETL_CHAOS_SCENARIOS_TOTAL, registry)

        before = registry.get_counter(ETL_CHAOS_SCENARIOS_TOTAL,
                                      {"result": "pass"})
        run = await run_scenario(get_scenario("crash_mid_apply"), SEED,
                                 device="cpu")
        assert run.ok
        assert registry.get_counter(ETL_CHAOS_SCENARIOS_TOTAL,
                                    {"result": "pass"}) == before + 1
        assert registry.get_counter(
            ETL_CHAOS_INJECTED_FAULTS_TOTAL,
            {"site": failpoints.ON_PROGRESS_STORE}) >= 1
        count, _total = registry.get_histogram(
            ETL_CHAOS_RECOVERY_DURATION_SECONDS)
        assert count >= 1


# -- the seeded workloads, against the reference's -------------------------------


async def _drive_workload(pkg: str, profile: "str | None", txs: int):
    import importlib

    runner = importlib.import_module(f"{pkg}.chaos.runner")
    scenario = importlib.import_module(f"{pkg}.chaos.scenario")
    shape = scenario.Scenario(name="w", description="w", tables=2,
                              rows_per_table=5, txs=txs, rows_per_tx=6,
                              workload=profile)
    wl = runner._make_workload(shape, random.Random(SEED))
    db = wl.build_db()
    # the default workload leaves the commit clock on the wall clock (the
    # profiles pin it): pin it so BEGIN's timestamps compare too
    db.clock_us = 1_700_000_000_000_000
    while wl.tx_index < txs:
        await wl.run_tx(db)
    expected = {tid: {pk: tuple(repr(v) for v in vals)
                      for pk, vals in rows.items()}
                for tid, rows in wl.expected.items()}
    return expected, [bytes(payload) for (_, payload, _, _) in db.wal]


@pytest.mark.parametrize("profile", [None] + sorted(
    {s.workload for s in WORKLOAD_MATRIX}), ids=lambda p: p or "default")
async def test_workload_equals_reference(profile):
    """One seed drives the same committed truth and the same WAL bytes
    through the port's workload and the reference's."""
    port = await _drive_workload("etl_tpu_torch", profile, 8)
    ref = await _drive_workload("etl_tpu", profile, 8)
    assert port[0] == ref[0]
    assert port[1] == ref[1]


# -- the restart matrix -----------------------------------------------------------


MUST_FIRE = {failpoints.BEFORE_SLOT_CREATION, failpoints.DURING_COPY,
             failpoints.AFTER_FINISHED_COPY, failpoints.BEFORE_STREAMING,
             failpoints.ON_PROGRESS_STORE}


@pytest.mark.parametrize("site", failpoints.REFERENCE_SITES)
async def test_error_then_restart(site):
    scenario = Scenario(
        name=f"matrix_{site.replace('.', '_')}",
        description=f"restart matrix: error at {site}, then a clean "
                    f"restart",
        faults=(FaultSpec(site, error_kind=ErrorKind.SOURCE_IO),),
        txs=4, clean_restart=True,
        tx_during_copy=(site != failpoints.DURING_COPY))
    run = await run_scenario(scenario, SEED, device="cpu")
    assert run.ok, run.describe()
    if site in MUST_FIRE:
        assert site in run.trace, run.describe()
    assert any(r.kind == "clean" for r in run.restarts)


# -- the CLI ------------------------------------------------------------------------


def _cli(*argv, timeout=240):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    return subprocess.run([sys.executable, "-m", "etl_tpu_torch.chaos",
                           *argv], capture_output=True, text=True,
                          timeout=timeout, cwd=ROOT, env=env)


class TestCli:
    def test_replays_deterministically(self):
        outs = []
        for _ in range(2):
            proc = _cli("--device", "cpu", "--seed", "3", "--scenario",
                        "dest_fail_after_apply")
            assert proc.returncode == 0, proc.stderr[-2000:]
            d = json.loads(proc.stdout.strip().splitlines()[-1])
            assert d["ok"] is True
            outs.append(_stable(d))
        assert outs[0] == outs[1]

    @pytest.mark.parametrize("argv", [
        ["--scenario", "crash_restart_corrupt_program_cache"],
        ["--scenario", "crash_restart_warm_programs"]])
    def test_program_cache_scenarios_run(self, argv):
        """Asked for by name, each program-cache scenario runs green and
        prints the store's counters."""
        proc = _cli("--device", "cpu", *argv, timeout=120)
        assert proc.returncode == 0, proc.stderr[-2000:]
        d = json.loads(proc.stdout.strip().splitlines()[-1])
        assert d["ok"] is True and d["scenario"] == argv[1]
        assert set(d["program_cache"]) == {"compiled", "disk_hits",
                                           "invalid"}

    @pytest.mark.parametrize("argv", [
        ["--exactly-once"], ["--ack-window"],
        ["--exactly-once", "--device-floor", "1"],
        ["--ack-window", "--device-floor", "1"]],
        ids=["exactly_once", "ack_window", "exactly_once_floor1",
             "ack_window_floor1"])
    def test_exactly_once_and_ack_window_run(self, argv):
        """The two families the port now has: each runs on the CPU and
        prints its run green (they were refused before their modules)."""
        proc = _cli("--device", "cpu", "--seed", "11", *argv)
        assert proc.returncode == 0, proc.stderr[-2000:]
        d = json.loads(proc.stdout.strip().splitlines()[-1])
        assert d["ok"] is True
        assert d["scenario"] == ("exactly_once_kill_matrix"
                                 if argv[0] == "--exactly-once"
                                 else "ack_window_crash_k_inflight")

    def test_autoscale_runs(self):
        """`--autoscale` runs since its modules are ported: the surge-drain
        arc and the controller crash, each printed green."""
        proc = _cli("--device", "cpu", "--autoscale", timeout=240)
        assert proc.returncode == 0, proc.stderr[-2000:]
        runs = [json.loads(line) for line in proc.stdout.splitlines()]
        assert [r["scenario"] for r in runs] == [
            "autoscale_surge_drain", "autoscale_controller_crash"]
        assert all(r["ok"] for r in runs), runs
        assert all(r["device"] == "cpu" and r["k1_launches"] == 0
                   and r["device_batches"] > 0 for r in runs)

    def test_exactly_once_combined_is_a_usage_error(self):
        proc = _cli("--device", "cpu", "--exactly-once", "--dlq",
                    timeout=120)
        assert proc.returncode == 2 and proc.stdout == ""
        assert "cannot be combined" in proc.stderr

    def test_no_card_no_fallback(self):
        """The CLI runs on the card by default: with no card it fails and
        runs nothing on the CPU."""
        import torch

        if torch.cuda.is_available():
            pytest.skip("a card is present: the default runs on it")
        proc = _cli("--scenario", "crash_mid_apply", timeout=120)
        assert proc.returncode == 1
        assert "DEVICE_UNAVAILABLE" in proc.stderr and proc.stdout == ""


# -- multi-pipeline over the port's admission scheduler -----------------------------


@pytest.mark.parametrize("floor", [None, 1], ids=["floor64", "floor1"])
async def test_sharded_multi_and_dlq_on_the_device_route(floor):
    """The pod kill, the multi-pipeline crash and the DLQ scenarios, at
    the decoder's floor and with every batch on the device route (phase
    14's configuration)."""
    from etl_tpu_torch.chaos.dlq import run_dlq_scenarios
    from etl_tpu_torch.chaos.multi import run_multi_pipeline_scenario
    from etl_tpu_torch.chaos.runner import device_floor
    from etl_tpu_torch.chaos.sharded import run_sharded_scenario

    with device_floor(floor):
        runs = [await run_sharded_scenario(seed=SEED, device="cpu"),
                await run_multi_pipeline_scenario(seed=SEED, device="cpu"),
                *await run_dlq_scenarios(seed=SEED, device="cpu")]
    for run in runs:
        assert run.ok, run.describe()


async def test_multi_pipeline_crash_one_stream():
    from etl_tpu_torch.chaos.multi import run_multi_pipeline_scenario

    run = await run_multi_pipeline_scenario(seed=SEED, device="cpu")
    assert run.ok, run.describe()
    assert run.scheduler_drained
    assert run.survivor_txs_during_outage > 0
    assert len(run.restarts) == 1


# -- the checker can fail -------------------------------------------------------------


class TestInvariantCheckerCanFail:
    async def test_detects_loss_and_regression(self):
        dest = TracingDestination()
        store = RecordingStore()
        store.progress_log["slot"] = [2, 1]  # a fabricated regression
        report = check_invariants(
            expected={16384: {1: (1, "x")}},  # a row never delivered
            dest=dest, store=store, restarts=[], fault_firings=0,
            leak_probe=LeakProbe.capture(), report=InvariantReport())
        assert not report.ok
        kinds = {v.split(":")[0] for v in report.violations}
        assert {"zero-loss", "monotonic-lsn", "store-consistency"} <= kinds

    async def test_detects_unbudgeted_duplicates(self):
        from etl_tpu_torch.models import (ColumnSchema, InsertEvent, Lsn,
                                          Oid, TableName, TableSchema)
        from etl_tpu_torch.models.schema import ReplicatedTableSchema
        from etl_tpu_torch.models.table_row import TableRow
        from etl_tpu_torch.models.table_state import TableState
        from etl_tpu_torch.store.base import DestinationTableMetadata

        schema = ReplicatedTableSchema.with_all_columns(TableSchema(
            16384, TableName("public", "t"),
            (ColumnSchema("id", Oid.INT8, nullable=False,
                          primary_key_ordinal=1),)))
        dest = TracingDestination()
        ev = InsertEvent(Lsn(1), Lsn(2), 0, schema, TableRow([1]))
        dest.events.extend([ev, ev])  # one key twice, with no budget
        store = RecordingStore()
        store._states[16384] = TableState.ready()
        await store.store_table_schema(schema, 0)
        await store.update_destination_metadata(
            DestinationTableMetadata(16384, "t"))
        report = check_invariants(
            expected={16384: {1: (1,)}}, dest=dest, store=store,
            restarts=[], fault_firings=0,
            leak_probe=LeakProbe.capture(), report=InvariantReport())
        assert not report.ok
        assert [v.split(":")[0] for v in report.violations] == \
            ["bounded-dup"]

    async def test_leak_probe_counts_the_ports_workers_only(self):
        """A thread named as the reference names its decode workers is
        not the port's: the probe counts `ops.pipeline` workers by type."""
        from etl_tpu_torch.ops.pipeline import DecodePipeline

        base = _pipeline_thread_count()
        probe = LeakProbe.capture()
        stop = threading.Event()
        ref_like = threading.Thread(target=stop.wait,
                                    name="etl-cdc-pipeline", daemon=True)
        ref_like.start()
        try:
            assert _pipeline_thread_count() == base
            assert probe.leaked_workers(0.1) == []
            pipe = DecodePipeline(window=1, name="probe")
            assert _pipeline_thread_count() == base + 1
            # a pipeline never closed is a leak, after the join's bound
            (leaked,) = probe.leaked_workers(0.1)
            assert leaked.startswith("etl-probe-pipeline")
            pipe.close()
            # closed: the check joins the worker, however late it exits
            assert probe.leaked_workers(5.0) == []
            assert _pipeline_thread_count() == base
        finally:
            stop.set()
            ref_like.join()
