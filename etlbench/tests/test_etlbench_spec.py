"""BENCHMARK.json and the files it names: every cell, configuration,
mix and metric is found by name, and the file keeps the contract's
shape."""

import json
import re

import pytest

from etlbench import spec

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
E2E_KEYS = {"name", "unit", "better", "bound", "source", "workloads"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves",
              "workloads"}


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_every_cell_finds_its_parts(w):
    cell = spec.cell(w["name"])
    assert cell.chips == w["chips"] == 1
    assert cell.config["name"] == w["config"]
    assert cell.traffic["kind"]
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer
    moved = {m["moves"] for m in cell.per_layer}
    assert moved <= names, "a layer metric moves a metric the cell lacks"


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_every_layer_metric_has_a_reader(m):
    assert callable(spec.reader(m["name"]))


def test_names_units_and_keys_keep_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"]:
        assert set(m) <= E2E_KEYS and NAME.match(m["name"])
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) <= LAYER_KEYS and NAME.match(m["name"])
        assert UNIT.match(m["unit"]) and m["moves"] in e2e
        assert "\n" not in m["layer"] and len(m["layer"]) <= 200
        if "roofline" in m["name"]:
            assert m["name"].split(".")[0].endswith("_roofline")
            assert m["unit"] == "%"
    for w in BENCH["workloads"]:
        assert NAME.match(w["name"]) and 1 <= len(w["why"]) <= 200
    for c in BENCH["configs"]:
        assert NAME.match(c["name"]) and 1 <= len(c["why"]) <= 200
        assert c["file"].startswith("etlbench/configs/")
        with open(spec.ROOT / c["file"]) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_every_mix_finds_its_kind_and_destination(w):
    mix = spec.cell(w["name"]).traffic
    kind = spec.kind(mix["kind"])
    assert callable(kind.Driver) and kind.SUFFIX
    assert callable(spec.destination(mix["destination"]).make)


def test_a_missing_name_is_refused():
    with pytest.raises(KeyError):
        spec.cell("no-such-cell")
    with pytest.raises(FileNotFoundError):
        spec.reader("no.such.metric")
    with pytest.raises(FileNotFoundError):
        spec.kind("no_such_kind")
    with pytest.raises(ValueError):
        spec.destination("../counting")
