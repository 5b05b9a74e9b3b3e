"""Finding a cell's parts by name.

`BENCHMARK.json` (at the root of the checkout) lists the cells; each
names a configuration (`etlbench/configs/<config>.json`) and a traffic
mix (`etlbench/traffic/<traffic>.json`). A mix is data: its `kind` names
the module that drives it (`etlbench/kinds/<kind>.py`, giving `Driver`
and `SUFFIX`, the suffix of the per-layer metrics it reports), and its
`destination` the module that makes the pipeline's destination
(`etlbench/destinations/<destination>.py`, giving `make(span)`). Each
per-layer metric has a reader of its own, `etlbench/metrics/<metric
name>.py`, whose `read(w)` takes the window's readings and returns a
number, or None where it finds nothing to read. Adding a cell, a mix, a
kind of traffic, a destination or a metric adds files and entries; no
code here names one.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list  # BENCHMARK.json metric entries this cell reports
    per_layer: list


def benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_json(kind: str, name: str) -> dict:
    path = HERE / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    with open(path) as f:
        return json.load(f)


def cell(name: str, root: Path = ROOT) -> Cell:
    """The cell `name` of BENCHMARK.json with its configuration, mix and
    metric entries."""
    bench = benchmark(root)
    for w in bench["workloads"]:
        if w["name"] == name:
            break
    else:
        raise KeyError(f"no workload named {name!r} in BENCHMARK.json")
    return Cell(
        name, int(w["chips"]), load_json("configs", w["config"]),
        load_json("traffic", w["traffic"]),
        [m for m in bench["end_to_end"] if _reports(m, name)],
        [m for m in bench["per_layer"] if _reports(m, name)])


def reader(metric: str):
    """The `read` function of the metric's reader file."""
    path = HERE / "metrics" / f"{metric}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no reader for metric {metric!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        f"etlbench_metric_{metric.replace('.', '_').replace('-', '_')}",
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _module(package: str, name: str):
    if not name.isidentifier():
        raise ValueError(f"{name!r} is no module name")
    path = HERE / package / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {package[:-1]} named {name!r} ({path})")
    return importlib.import_module(f"etlbench.{package}.{name}")


def kind(name: str):
    """The module of the traffic kind `name` (`Driver`, `SUFFIX`)."""
    return _module("kinds", name)


def destination(name: str):
    """The module of the destination `name` (`make(span)`)."""
    return _module("destinations", name)
