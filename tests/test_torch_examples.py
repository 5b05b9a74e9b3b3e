"""The port's examples (`etl_tpu_torch/examples/`) on the CPU: the lake and
Iceberg pipelines print the same read-back as the reference's examples
(`examples/*.py`, run as scripts) with the temporary paths and the random
snapshot id masked; the example config loads through the port's loader as
the CUDA engine while the reference's (`batch_engine: tpu`) is refused;
the control plane answers `/openapi.json`; the replicator runs on the
example config."""

import asyncio
import os
import re
import subprocess
import sys

import pytest

from etl_tpu_torch import bench
from etl_tpu_torch.config import BatchEngine
from etl_tpu_torch.examples import (CONFIG_DIR, iceberg_pipeline,
                                    lake_pipeline, load_example_config)
from etl_tpu_torch.models.errors import ErrorKind, EtlError

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _masked(lines, warehouse: str | None = None) -> list:
    """The lines with a warehouse path and a snapshot id masked."""
    out = []
    for line in lines:
        if warehouse is not None:
            line = line.replace(warehouse, "<warehouse>")
        line = re.sub(r"→ /\S*etl-(lake|iceberg)-\S+", "→ <warehouse>",
                      line)
        line = re.sub(r"head = -?\d+", "head = <id>", line)
        out.append(line)
    return out


def _reference_lines(script: str, tmp) -> list:
    """The reference example's printed lines; its warehouse (a
    `tempfile.mkdtemp`) goes under `tmp`."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    env["TMPDIR"] = str(tmp)
    proc = subprocess.run([sys.executable, os.path.join(ROOT, script)],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout.strip().splitlines()


class TestPipelines:
    def test_lake_example_reads_back_as_the_reference(self, tmp_path,
                                                      capsys):
        warehouse = str(tmp_path / "lake")
        out = lake_pipeline.main(["--device", "cpu", "--warehouse",
                                  warehouse])
        printed = capsys.readouterr().out.strip().splitlines()
        assert printed == out["lines"]
        assert [r["id"] for r in out["current"]] == [1] + list(range(3, 102))
        ref = _reference_lines("examples/lake_pipeline.py", tmp_path)
        assert _masked(out["lines"], warehouse) == _masked(ref)

    def test_iceberg_example_reads_back_as_the_reference(self, tmp_path,
                                                         capsys):
        warehouse = str(tmp_path / "iceberg")
        out = iceberg_pipeline.main(["--device", "cpu", "--warehouse",
                                     warehouse])
        printed = capsys.readouterr().out.strip().splitlines()
        assert printed == out["lines"]
        assert out["snapshots"] == 2 and out["lines"][-1] == "ok"
        assert sorted(out["live"]) == [1] + list(range(3, 52))
        ref = _reference_lines("examples/iceberg_pipeline.py", tmp_path)
        assert _masked(out["lines"], warehouse) == _masked(ref)

    def test_lake_example_as_a_module(self, tmp_path):
        """`python -m etl_tpu_torch.examples.lake_pipeline --device cpu`
        prints the read-back and exits 0."""
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        env["PYTHONPATH"] = ROOT
        proc = subprocess.run(
            [sys.executable, "-m", "etl_tpu_torch.examples.lake_pipeline",
             "--device", "cpu", "--warehouse", str(tmp_path)], cwd=ROOT,
            env=env, capture_output=True, text=True, timeout=240)
        assert proc.returncode == 0, proc.stderr[-3000:]
        assert _masked(proc.stdout.strip().splitlines(), str(tmp_path))[1:] \
            == ["lake current rows: 100 (copied 100, +1 insert, -1 delete)",
                "updated row 1 balance: 1000.00"]

    def test_no_card_refuses_without_cpu(self, tmp_path):
        """Asked for the card (the default) where there is none, the
        example fails at the pipeline's start: nothing decodes on the
        CPU in its place."""
        import torch

        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        with pytest.raises(Exception):
            lake_pipeline.main(["--warehouse", str(tmp_path)])


class TestConfig:
    def test_example_config_loads_as_cuda(self):
        config, rest = load_example_config(environ={})
        assert config.batch.batch_engine is BatchEngine.CUDA
        assert config.batch.device == "cuda"
        assert config.publication_name == "my_publication"
        assert rest["destination"]["type"] == "lake"
        assert rest["store"]["type"] == "sqlite"

    def test_reference_config_tpu_refused(self):
        with pytest.raises(EtlError) as e:
            load_example_config(os.path.join(ROOT, "examples", "config"),
                                environ={})
        assert e.value.kind is ErrorKind.CONFIG_INVALID
        assert "cuda" in str(e.value) and "'tpu'" in str(e.value)

    def test_example_config_differs_only_in_the_engine(self):
        """The port's example config is the reference's but for the
        engine (and the device it names)."""
        import yaml

        with open(os.path.join(ROOT, "examples", "config", "base.yaml")) \
                as f:
            ref = yaml.safe_load(f)
        with open(CONFIG_DIR / "base.yaml") as f:
            mine = yaml.safe_load(f)
        assert ref["batch"].pop("batch_engine") == "tpu"
        assert mine["batch"].pop("batch_engine") == "cuda"
        assert mine["batch"].pop("device") == "cuda"
        assert mine == ref

    def test_replicator_runs_on_the_example_config(self):
        """`python -m etl_tpu_torch.replicator --config-dir` on the example
        config, rewritten to a fake server and a temporary lake: /health
        200, the stream delivered to the lake, SIGTERM exit 0."""
        r = asyncio.run(bench.run_example_replicator(
            2000, 2000, device="cpu"))
        assert r["batch_engine"] == "cuda"
        assert r["health"] == [200, {"status": "healthy"}]
        assert r["lake_rows"] == 4000 and r["rows_ok"]
        assert r["exit_code"] == 0 and r["stopped_cleanly"], \
            r.get("stderr_tail")
        assert r["ok"]


class TestControlPlane:
    def test_openapi_and_bearer(self):
        r = asyncio.run(bench.run_example_control_plane())
        assert r["openapi"][0] == 200 and r["openapi"][1] == "3.0.3"
        assert r["tenants_with_key"] == 200
        assert r["tenants_without_key"] == 401
        assert r["exit_code"] == 0
        assert r["lines"][-1] == "control plane stopped"
        assert r["ok"]
