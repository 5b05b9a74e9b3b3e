"""The port's benchmark harness (`etl_tpu_torch/benchmarks`) and its bench
flags, on the CPU (the kernels' plain versions), held to the reference's
tests/test_workloads.py `TestBenchWiring` and its workload-streaming
cases (:480, :510) and tests/test_property_and_lag.py
`TestBenchHarnessSmoke`: each mode delivers and verifies at a small size.
Also: the multi-pipeline, poison and wide-row modes; the shard worker's
round trip at K = 1 and K = 2 (K processes; the slices cover every table
once and verify); a worker or a bench asked for the card without one
fails; `bench --smoke --device cpu` runs every ported gate of
BENCH_FLOOR.json (the two lint gates included) with its correctness
checks green — the mesh gate among them — and lists nothing under
`not_ported` (the Parquet floor where pyarrow is missing); `bench
--mesh-check --device cpu` holds an 8-shard CPU mesh to one device;
`bench --coldstart --device cpu` runs its two
lifetimes green (the reference's `run_coldstart` gates);
`benchmarks/compare.py` diffs reports as the reference's does. Wall-clock floors are asserted nowhere here: the
reference's tests assert none for these modes either. Tolerance: none.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from etl_tpu_torch.chaos import failpoints
from etl_tpu_torch.ops import engine
from etl_tpu_torch.ops.pipeline import reset_global_admission

ROOT = Path(__file__).resolve().parent.parent
SEED = 7

#: what `bench --smoke` may not run yet, by BENCH_FLOOR.json key (the
#: Parquet floor is read where pyarrow imports, as here): nothing
NOT_PORTED: set = set()
GATES = {"decode_identity", "heartbeat", "table_streaming", "egress",
         "workload", "selectivity", "ack_window", "poison", "exactly_once",
         "multi_pipeline", "sharded", "autoscale", "fleet", "coldstart",
         "static_analysis", "ir_analysis", "mesh"}


@pytest.fixture(autouse=True)
def _port_hygiene():
    yield
    engine.clear_forced_oracle()
    failpoints.disarm_all()
    reset_global_admission()


def _no_card_env() -> dict:
    return {**os.environ, "CUDA_VISIBLE_DEVICES": ""}


class TestBenchWiring:
    def test_workload_floors_published_and_gated(self):
        """Every port profile has a floor in BENCH_FLOOR.json and the
        smoke slice names profiles covering update + truncate traffic
        and the fused filter."""
        from etl_tpu_torch.benchmarks.smoke import load_floors
        from etl_tpu_torch.workloads import profile_names

        floors = load_floors()
        wfloors = floors["workload_floors"]
        assert set(wfloors) == set(profile_names())
        smoke = floors["workload_smoke_profiles"]
        assert {"update_heavy_default", "truncate_storm"} <= set(smoke)
        assert all(p in wfloors for p in smoke)

    def test_not_ported_names_every_unrun_key(self):
        from etl_tpu_torch.benchmarks.smoke import load_floors, not_ported

        out = not_ported(load_floors())
        assert set(out) == NOT_PORTED
        assert all("queue 1 entry" in why for why in out.values())


class TestWorkloadStreaming:
    async def test_workload_streaming_verifies_end_state(self):
        from etl_tpu_torch.benchmarks import harness

        out = await harness.run_workload_streaming(
            "delete_heavy_default", seed=SEED, target_ops=120,
            device="cpu")
        assert out["verified"] is True
        assert out["row_ops"] >= 120
        assert out["events_per_second"] > 0
        assert out["launches_ok"] and out["launches"] == 0

    async def test_workload_streaming_reports_verification_failure(
            self, monkeypatch):
        """A view that never matches the committed truth comes back as
        verified=False (and the pipeline shuts down), not a hang."""
        from etl_tpu_torch import workloads
        from etl_tpu_torch.benchmarks import harness

        real = workloads.WorkloadGenerator.delivered
        state = {"warmed": False}

        def delivered(self, dest):
            if state["warmed"]:
                return False
            if real(self, dest):
                state["warmed"] = True
                return True
            return False

        monkeypatch.setattr(workloads.WorkloadGenerator, "delivered",
                            delivered)
        out = await harness.run_workload_streaming(
            "insert_heavy", seed=SEED, target_ops=60, verify_timeout_s=3,
            device="cpu")
        assert out["verified"] is False

    @pytest.mark.parametrize("profile", ["filter_selective_10",
                                         "filter_selective_50",
                                         "filter_selective_90"])
    async def test_filter_profiles_on_the_device_route(self, profile):
        """Offload mode with every batch on the device route: the fused
        filter drops rows in the decoder, and the end state is the
        filtered truth."""
        from etl_tpu_torch.benchmarks import harness
        from etl_tpu_torch.chaos.runner import device_floor

        with device_floor(1):
            out = await harness.run_workload_streaming(
                profile, seed=SEED, target_ops=200, device="cpu")
        assert out["verified"] is True
        assert out["device_batches"] > 0
        assert out["decode_rows_filtered"] > 0

    async def test_workload_matrix_reports_each_profile(self):
        from etl_tpu_torch.benchmarks import harness
        from etl_tpu_torch.benchmarks.smoke import gate_workload, load_floors

        out = await harness.run_workload_matrix(
            ["update_heavy_default", "truncate_storm"], seed=SEED,
            target_ops=100, device="cpu")
        assert out["all_verified"] and out["launches_ok"]
        gated = gate_workload(out, load_floors())
        assert set(gated["floors"]) == {"update_heavy_default",
                                        "truncate_storm"}
        assert not [f for f in gated["failures"]
                    if "under floor" not in f]


class TestBenchHarnessSmoke:
    async def test_table_streaming_smoke(self):
        from etl_tpu_torch import bench

        out = await bench.run_table_streaming(2000, device="cpu",
                                              warmup_events=500)
        assert out["mode"] == "table_streaming"
        assert out["delivered_rows"] == 2000  # no loss
        assert out["ok"]
        assert out["end_to_end_events_per_second"] > 0
        assert out["lag_p50_ms"] is not None
        assert out["lag_p95_ms"] >= out["lag_p50_ms"]

    async def test_lag_vs_rate_smoke(self):
        from etl_tpu_torch.benchmarks import harness

        out = await harness.run_lag_vs_rate(
            fractions=(0.5,), probe_events=2000, per_rate_cap=4000,
            device="cpu", warmup_events=500)
        assert out["mode"] == "lag_vs_rate"
        assert out["ok"]
        assert out["max_events_per_second"] > 0
        (row,) = out["rates"]
        assert row["fraction"] == 0.5
        assert row["events"] >= 3000 and row["p50_ms"] is not None
        assert row["p95_ms"] >= row["p50_ms"]


class TestModes:
    async def test_multi_pipeline_verifies_and_drains(self):
        from etl_tpu_torch.benchmarks import harness

        out = await harness.run_multi_pipeline(seed=SEED, target_ops=200,
                                               device="cpu")
        assert out["streams"] == 2
        assert out["all_verified"] is True
        assert out["scheduler_drained"] is True
        assert out["admission_grants"] > 0
        assert out["launches_ok"]

    async def test_poison_streaming_union_and_probe_bound(self):
        from etl_tpu_torch.benchmarks import harness

        out = await harness.run_poison_streaming(rate=0.01, seed=SEED,
                                                 target_ops=1500,
                                                 device="cpu")
        assert out["failures"] == [], out["failures"]
        assert out["clean"]["verified"] and out["poisoned"]["verified"]
        p = out["poisoned"]
        assert p["poison_rows_committed"] > 0
        assert p["dlq_entries"] >= p["poison_rows_committed"]
        assert p["probe_writes"] <= p["probe_bound"]

    def test_wide_row_equals_oracle(self):
        from etl_tpu_torch.benchmarks import harness

        out = harness.run_wide_row(n_rows=256, n_iters=1, device="cpu")
        assert out["ok"] and out["equals_oracle"]
        assert out["columns"] == 100
        assert out["dense_columns"] + out["object_columns"] == 100
        assert out["dense_columns"] == 60 and out["words_per_row"] > 2
        assert out["device_batches"] == 2 and out["launches"] == 0


class TestShardWorker:
    @pytest.mark.parametrize("shards", [1, 2])
    async def test_round_trip_covers_every_table_once(self, shards):
        """K worker processes on the CPU: each verifies its slice, the
        slices cover the 8 tables once, nothing launches."""
        from etl_tpu_torch.benchmarks import harness

        out = await harness.run_sharded_processes(
            shards=shards, seed=SEED, target_ops=300, device="cpu",
            timeout_s=240)
        assert out["shards"] == shards
        assert out["all_verified"] is True
        assert out["union_covers_all_tables"] is True
        assert out["launches_ok"] is True
        owned = [t for r in out["per_shard"].values()
                 for t in r["owned_table_ids"]]
        assert sorted(owned) == list(range(16384, 16392))
        assert all(r["device"] == "cpu" and r["launches"] == 0
                   for r in out["per_shard"].values())
        assert out["aggregate_row_events"] >= 300

    def test_worker_without_a_card_fails(self):
        proc = subprocess.run(
            [sys.executable, "-m", "etl_tpu_torch.benchmarks.shard_worker",
             "--device", "cuda", json.dumps({"target_ops": 10})],
            capture_output=True, text=True, timeout=120, cwd=ROOT,
            env=_no_card_env())
        assert proc.returncode == 1
        assert "no CUDA device" in json.loads(
            proc.stdout.strip().splitlines()[-1])["error"]


class TestSmokeFlag:
    def test_bench_without_a_card_measures_nothing(self):
        proc = subprocess.run(
            [sys.executable, "-m", "etl_tpu_torch.bench", "--smoke"],
            capture_output=True, text=True, timeout=120, cwd=ROOT,
            env=_no_card_env())
        assert proc.returncode == 1
        assert proc.stdout == ""

    def test_smoke_on_the_cpu(self):
        """Every ported gate at the smoke sizes: the correctness half of
        each holds; the wall-clock floors are the card's to meet."""
        proc = subprocess.run(
            [sys.executable, "-m", "etl_tpu_torch.bench", "--smoke",
             "--device", "cpu"],
            capture_output=True, text=True, timeout=600, cwd=ROOT)
        out = json.loads(proc.stdout.strip().splitlines()[-1])
        assert out["mode"] == "smoke" and out["device"] == "cpu"
        assert set(out["gates"]) == GATES
        assert out["correctness"] == {g: True for g in GATES
                                      if g != "heartbeat"}, out
        assert set(out["not_ported"]) == NOT_PORTED
        assert out["exactly_once_duplicate_rows"] == 0
        assert out["table_rows_constructed"] == 0
        # the two lint gates, as tests/test_decode_pipeline.py holds the
        # reference's: the whole-program pass over the port clean past
        # its baseline and inside its budget, `--check-baseline` clean,
        # and the IR tier (`--programs --device cpu`) exiting 0 inside
        # its own budget, listing what the CPU cannot check
        assert out["static_analysis_under_budget"] is True, out
        assert out["static_analysis_seconds"] < \
            out["static_analysis_budget_s"]
        assert out["static_analysis_violations"] == 0
        assert out["static_analysis_findings"] > 0
        assert out["static_analysis_baseline_clean"] is True, out
        assert out["ir_analysis_clean"] is True, out
        assert out["ir_analysis_under_budget"] is True, out
        assert out["ir_analysis_seconds"] < out["ir_analysis_budget_s"]
        assert any("ir-host-callback not_checked: cpu" in line
                   for line in out["ir_analysis_report"]), out
        assert any("mesh variants on 8 shards" in line
                   for line in out["ir_analysis_report"]), out
        # the reference's mesh gate: 8 CPU shards at mesh_smoke_rows
        assert out["mesh_shards"] == 8
        assert out["mesh_sharded_equals_single"] is True
        assert out["mesh_check"]["rows"] == 8192
        assert proc.returncode == (0 if out["ok"] else 1)

    def test_mesh_check_on_the_cpu(self):
        """`bench --mesh-check --device cpu`: an 8-shard mesh over the
        CPU decodes pgbench like one device, unfiltered and under
        `abalance < 0` (`source_rows` included); the plain versions
        launch no kernel; the seconds are reported, not gated."""
        proc = subprocess.run(
            [sys.executable, "-m", "etl_tpu_torch.bench", "--mesh-check",
             "--mesh-rows", "4096", "--device", "cpu"],
            capture_output=True, text=True, timeout=600, cwd=ROOT)
        assert proc.returncode == 0, proc.stderr[-2000:]
        out = json.loads(proc.stdout.strip().splitlines()[-1])
        assert out["mode"] == "mesh_check" and out["ok"] is True
        assert out["mesh_shards"] == 8 and out["devices"] == 1
        assert out["mesh_devices"] == ["cpu"] * 8
        assert out["rows"] == 4096 and out["row_filter"] == "abalance < 0"
        assert out["sharded_equals_single"] is True
        assert out["filtered_sharded_equals_single"] is True
        assert 0 < out["filtered_survivors"] < 4096
        assert out["k1_launches_per_batch"] == 0 \
            == out["filtered_launches_per_batch"]
        for key in ("single_decode_s", "sharded_decode_s",
                    "filtered_single_decode_s", "filtered_sharded_decode_s"):
            assert out[key] > 0


class TestColdstart:
    """The reference's `run_coldstart` gates on the CPU: the warm restart
    builds nothing, loads the packers' library from disk and decodes no
    row on the oracle; the cold start builds once (the framer, with the
    C compiler); the three rotated tables take one canonical layout."""

    def test_smoke_sizes_in_process(self, tmp_path):
        from etl_tpu_torch.benchmarks import harness, smoke

        floors = smoke.load_floors()
        out = harness.run_coldstart(
            n_tables=floors["coldstart_smoke_tables"],
            rows_per_tx=floors["coldstart_smoke_rows_per_tx"],
            txs_per_table=floors["coldstart_smoke_txs_per_table"],
            device="cpu", cache_dir=str(tmp_path))
        assert out["ok"], out["failures"]
        cold, warm = out["cold"], out["warm"]
        assert cold["programs_compiled"] == 1
        assert warm["programs_compiled"] == 0
        assert warm["cache_hits_disk"] >= 1
        assert warm["oracle_rows"] == cold["oracle_rows"] == 0
        assert cold["layouts_by_route"] == warm["layouts_by_route"] \
            == {"device": 1}
        assert warm["rows_delivered"] == warm["rows_written"] == 3 * 400
        assert warm["prewarm"]["observed"] >= 1  # the cold run's layouts

    def test_bench_coldstart_flag(self):
        proc = subprocess.run(
            [sys.executable, "-m", "etl_tpu_torch.bench", "--coldstart",
             "--device", "cpu"], capture_output=True, text=True,
            timeout=600, cwd=ROOT)
        out = json.loads(proc.stdout.strip().splitlines()[-1])
        assert proc.returncode == 0 and out["ok"], out.get("failures")
        assert out["mode"] == "coldstart" and out["warm_zero_compiles"]
        assert out["warm"]["rows_delivered"] == 3 * 800 * 2


class TestCompare:
    def test_compare_equals_the_reference(self, tmp_path):
        from etl_tpu.benchmarks import compare as ref_compare
        from etl_tpu_torch.benchmarks import compare

        old = {"events_per_second": 100.0, "lag_p50_ms": 10.0,
               "rows": 5, "ok": True, "name": "x"}
        new = {"events_per_second": 80.0, "lag_p50_ms": 5.0,
               "rows": 5, "ok": False, "name": "y"}
        lines, worst = compare.compare(old, new)
        assert (lines, worst) == ref_compare.compare(old, new)
        assert "events_per_second: 100 -> 80 (-20.0%, worse)" in lines
        assert "lag_p50_ms: 10 -> 5 (-50.0%, better)" in lines
        assert worst == 20.0
        a, b = tmp_path / "a.json", tmp_path / "b.json"
        a.write_text(json.dumps(old))
        b.write_text(json.dumps(new))
        assert compare.main([str(a), str(b), "--fail-pct", "10"]) == 1
        assert compare.main([str(a), str(b), "--fail-pct", "30"]) == 0
