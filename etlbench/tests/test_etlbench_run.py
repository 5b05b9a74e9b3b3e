"""Whole runs of every cell on the CPU (the port's plain versions, small
sizes): a sound run is correct and prints the contract's line; the
control and a timed path broken underneath come out not correct; a run
without a card, or without the program, fails and prints nothing; and
nothing of JAX or the JAX package is loaded."""

import asyncio
import json
import shutil
import subprocess
import sys

import numpy as np
import pytest

from etlbench import run, spec, traffic

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]
#: small enough for a test run; every cell still runs whole syncs and a
#: stream of several transactions through every layer
SCALE = {"pgbench-s10": 0.01, "tpcc-w4": 0.005}
SEED = 2 ** 33 + 17


def _run(name, control=False, seconds=1.0):
    cell = spec.cell(name)
    return asyncio.run(run.run_cell(
        cell, SEED, seconds, trace=False, control=control, device="cpu",
        scale=SCALE[cell.config["name"]]))


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct_and_prints_the_line(name):
    out = _run(name)
    assert out["correct"], out["numbers"]
    assert not out["forbidden"]
    line = json.loads(json.dumps(run.result_line(out)))
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert set(line["metrics"]) == {m["name"]
                                    for m in spec.cell(name).end_to_end}
    assert all(m["value"] > 0 for m in line["metrics"].values())
    assert line["attempted"] > 0 and line["failed"] == 0
    assert all(c["value"] <= c["limit"] for c in line["checks"].values())


def test_a_traced_run_reads_its_layer_metrics():
    out = asyncio.run(run.run_cell(
        spec.cell("tpcc-copy"), SEED, 1.0, trace=True, device="cpu",
        scale=SCALE["tpcc-w4"]))
    assert out["correct"]
    got = set(out["metrics"])
    # no card: the kernel and device metrics find nothing and are left out
    assert got == {"pipeline.pack_ms_per_mrow.copy",
                   "pipeline.fetch_ms_per_mrow.copy",
                   "engine.device_row_pct.copy",
                   "engine.rows_per_device_batch.copy"}
    assert {"device_ops", "idle_gaps"} == set(out["breakdown"])


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(name):
    assert not _run(name, control=True)["correct"]


def _stale(result):
    """A decode that hands back its previous output again."""
    last = {}

    def wrapper(self):
        got = result(self)
        key = got.schema.id if hasattr(got.schema, "id") else None
        out = last.get(key, got)
        last[key] = got
        return out
    return wrapper


def _half(result):
    """Half of each batch left out."""
    def wrapper(self):
        got = result(self)
        return got.take(np.arange(got.num_rows // 2))
    return wrapper


def _altered(result):
    """One value changed where the decode produces it."""
    def wrapper(self):
        got = result(self)
        for col in got.columns:
            if isinstance(col.data, np.ndarray) and len(col.data):
                col.data = col.data.copy()
                col.data[-1] += 1
                break
        return got
    return wrapper


def _fails(name):
    """The run comes out not correct, or its warm-up never finishes and
    it fails before any result."""
    try:
        return not _run(name)["correct"]
    except TimeoutError:
        return True


@pytest.mark.parametrize("fault", [_stale, _half, _altered],
                         ids=["state-unchanged", "half-the-batch",
                              "value-altered"])
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_timed_path_is_not_correct(name, fault, monkeypatch):
    from etl_tpu_torch.ops import engine

    monkeypatch.setattr(traffic, "DRAIN_S", 1.0)
    monkeypatch.setattr(traffic, "WARMUP_S", 5.0)
    monkeypatch.setattr(engine._PendingDecode, "result",
                        fault(engine._PendingDecode.result))
    assert _fails(name)


@pytest.mark.parametrize("name", CELLS)
def test_a_warm_up_that_does_not_finish_fails_the_run(name, monkeypatch):
    monkeypatch.setattr(traffic, "WARMUP_S", 0.0)
    with pytest.raises(TimeoutError):
        _run(name)


def test_a_paced_stream_is_correct_and_keeps_its_pace():
    cell = spec.cell("pgbench-cdc")
    cell.traffic = dict(cell.traffic, arrival_rows_per_s=200_000)
    scale = SCALE[cell.config["name"]]
    out = asyncio.run(run.run_cell(cell, SEED, 2.0, trace=False,
                                   device="cpu", scale=scale))
    assert out["correct"], out["numbers"]
    rate = out["metrics"]["cdc_events_per_s"]["value"]
    # 2,000 rows a second: four transactions of 500
    assert 0.5 * 2000 <= rate <= 1.5 * 2000


def _cli(cwd, *args):
    return subprocess.run(
        [sys.executable, "-m", "etlbench.run", "--workload", "pgbench-cdc",
         "--seed", "3", "--seconds", "1", "--trace", "0", *args],
        capture_output=True, text=True, cwd=cwd, timeout=300)


def test_a_run_without_a_card_fails_and_prints_nothing():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    got = _cli(spec.ROOT)
    assert got.returncode != 0 and got.stdout == ""
    assert "CUDA" in got.stderr


def test_a_run_without_the_program_fails(tmp_path):
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.ROOT / "etlbench", tmp_path / "etlbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    got = _cli(tmp_path)
    assert got.returncode != 0 and got.stdout == ""


@pytest.mark.parametrize("name", CELLS)
def test_a_run_loads_nothing_of_jax(name):
    scale = SCALE[spec.cell(name).config["name"]]
    code = (
        "import asyncio, json, sys\n"
        "from etlbench import run, spec\n"
        f"out = asyncio.run(run.run_cell(spec.cell({name!r}), 5, 0.5, "
        f"False, device='cpu', scale={scale}))\n"
        "names = {m.split('.')[0] for m in sys.modules}\n"
        "print(json.dumps([out['correct'], sorted(names)]))\n")
    got = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=spec.ROOT, timeout=300, check=True)
    correct, names = json.loads(got.stdout.strip().splitlines()[-1])
    assert correct and "etl_tpu_torch" in names
    assert not set(names) & {"jax", "jaxlib", "flax", "etl_tpu"}


@pytest.mark.gpu
def test_a_cell_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the benchmark measures the card")
    got = _cli(spec.ROOT)
    assert got.returncode == 0, got.stderr[-2000:]
    line = json.loads(got.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
