"""The port's benchmark harness (`etl_tpu_torch/benchmarks`) and its bench
flags, on the CPU (the kernels' plain versions), held to the reference's
tests/test_workloads.py `TestBenchWiring` and its workload-streaming
cases (:480, :510) and tests/test_property_and_lag.py
`TestBenchHarnessSmoke`: each mode delivers and verifies at a small size.
Also: the multi-pipeline, poison and wide-row modes; the shard worker's
round trip at K = 1 and K = 2 (K processes; the slices cover every table
once and verify); a worker or a bench asked for the card without one
fails; `bench --smoke --device cpu` runs every ported gate of
BENCH_FLOOR.json with its correctness checks green and lists the rest
under `not_ported`; `benchmarks/compare.py` diffs reports as the
reference's does. Wall-clock floors are asserted nowhere here: the
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
#: Parquet floor is read where pyarrow imports, as here)
NOT_PORTED = {
    "coldstart_tables", "coldstart_rows_per_tx", "coldstart_txs_per_table",
    "coldstart_smoke_tables", "coldstart_smoke_rows_per_tx",
    "coldstart_smoke_txs_per_table",
    "ir_analysis_budget_s", "static_analysis_budget_s", "mesh_smoke_rows"}
GATES = {"decode_identity", "heartbeat", "table_streaming", "egress",
         "workload", "selectivity", "ack_window", "poison", "exactly_once",
         "multi_pipeline", "sharded", "autoscale", "fleet"}


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
        assert proc.returncode == (0 if out["ok"] else 1)


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
