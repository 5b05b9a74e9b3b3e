"""The plain reference decodes the encoder's text back to the generator's
typed values, for every type the configurations use, NULLs included; and
the comparison rejects a decode one step below the stated precision."""

import ast
import datetime as dt
import json
import subprocess
import sys
from decimal import Decimal
from pathlib import Path

import numpy as np
import pytest

from etlbench import check, datagen, spec, textenc
from etlbench.reference import decode as ref

EPOCH = dt.datetime(1970, 1, 1)


def _us(text):
    return (dt.datetime.fromisoformat(text) - EPOCH) // dt.timedelta(
        microseconds=1)


def _text_col(name, type_, values, length=0):
    enc = [b"" if v is None else v.encode() for v in values]
    return datagen.Col(name, type_, np.array([v is not None for v in values]),
                       lens=np.array([len(b) for b in enc], dtype=np.int64),
                       flat=np.frombuffer(b"".join(enc), dtype=np.uint8),
                       length=length)


def _num_col(name, type_, values, scale=0):
    return datagen.Col(name, type_, np.array([v is not None for v in values]),
                       values=np.array([0 if v is None else v
                                        for v in values], dtype=np.int64),
                       scale=scale)


def every_type():
    """Columns of every type, with edge values and a NULL in each."""
    cols = [
        _num_col("i2", "int2", [0, -32768, 32767, None, 7]),
        _num_col("i4", "int4", [1, -2147483648, 2147483647, 10, None]),
        _num_col("i8", "int8", [-9223372036854775808, 9223372036854775807,
                                0, None, -1]),
        _num_col("n2", "numeric", [0, -1, 123456, None, -99999999], 2),
        _num_col("n4", "numeric", [1234, 0, None, -5000, 10000], 4),
        _num_col("n0", "numeric", [0, None, 99999999, -3, 12], 0),
        _num_col("d", "date", [0, -1, 11016, None, 2932896]),
        _num_col("ts", "timestamp", [
            _us("2025-01-01 00:00:00"), _us("1969-12-31 23:59:59.999999"),
            None, _us("2024-02-29 12:34:56.5"), _us("2000-06-15 01:02:03.00012")]),
        _text_col("c", "bpchar", ["ab  ", "    ", None, "abcd", "a   "], 4),
        _text_col("v", "varchar", ["", "x", "hello world", None, "0.5"], 16),
        _text_col("t", "text", [None, "tab-free", "Z", "", "with space"]),
    ]
    specs = [{"name": c.name, "type": c.type, "scale": c.scale,
              "length": c.length} for c in cols]
    return cols, specs


def _assert_equal(cols, got):
    for c, r in zip(cols, got):
        assert np.array_equal(c.valid, r.valid), c.name
        if c.values is not None:
            assert np.array_equal(c.values[c.valid], r.values[r.valid]), c.name
        else:
            assert np.array_equal(c.lens[c.valid], r.lens[r.valid]), c.name
            assert bytes(c.flat) == bytes(r.flat), c.name


@pytest.mark.parametrize("wire", ["copy", "pgoutput"])
def test_reference_decodes_every_type(wire):
    cols, specs = every_type()
    if wire == "copy":
        fields = ref.split_copy(textenc.copy_text(cols), len(cols))
    else:
        buf, offs = textenc.insert_payloads(cols, 16384)
        fields = ref.split_inserts(buf, offs, len(cols))
    _assert_equal(cols, ref.decode(specs, fields))


def test_postgres_text_forms():
    cols, _ = every_type()
    text = textenc.copy_text(cols).decode().split("\n")
    assert text[0] == ("0\t1\t-9223372036854775808\t0.00\t0.1234\t0\t"
                       "1970-01-01\t2025-01-01 00:00:00\tab  \t\t\\N")
    assert text[3].split("\t")[7] == "2024-02-29 12:34:56.5"
    assert text[4].split("\t")[7] == "2000-06-15 01:02:03.00012"
    assert text[1].split("\t")[3:7] == ["-0.01", "0.0000", "\\N",
                                        "1969-12-31"]


@pytest.mark.parametrize("config", ["pgbench-s10", "tpcc-w4"])
def test_reference_decodes_the_generated_tables(config):
    cfg = spec.load_json("configs", config)
    tables = datagen.make_tables(cfg, 2 ** 31 + 12345, scale=0.01)
    for t, tspec in zip(tables, cfg["tables"]):
        got = ref.decode(tspec["columns"], ref.split_copy(
            textenc.copy_text(t.cols), len(t.cols)))
        for c, r in zip(t.cols, got):
            assert np.array_equal(c.valid, r.valid)
            if c.values is not None:
                assert np.array_equal(c.values[c.valid], r.values[r.valid])
            else:
                keep = np.flatnonzero(c.valid)
                lens, flat = check.ragged_take(c.lens, c.flat, keep)
                assert np.array_equal(lens, r.lens[keep])
                assert bytes(flat) == bytes(r.flat)


def test_pgbench_rows_are_those_pgbench_i_writes():
    cfg = spec.load_json("configs", "pgbench-s10")
    (t,) = datagen.make_tables(cfg, 2 ** 40 + 3, scale=0.25)
    aid, bid = t.col("aid").values, t.col("bid").values
    assert np.array_equal(aid, np.arange(1, 250_001))
    assert np.array_equal(bid, (aid - 1) // 100_000 + 1)
    assert not t.col("abalance").values.any()
    filler = t.col("filler")
    assert set(filler.lens.tolist()) == {84}
    assert bytes(filler.flat) == b" " * (84 * 250_000)


def test_same_seed_same_tables_and_sizes_fixed():
    cfg = spec.load_json("configs", "tpcc-w4")
    a = datagen.make_tables(cfg, -7, scale=0.01)
    b = datagen.make_tables(cfg, -7, scale=0.01)
    c = datagen.make_tables(cfg, 8, scale=0.01)
    for x, y, z in zip(a, b, c):
        assert textenc.copy_text(x.cols) == textenc.copy_text(y.cols)
        assert x.n_rows == z.n_rows  # sizes do not follow the seed


def test_malformed_text_is_refused():
    flat = np.frombuffer(b"12a-3.4.5", dtype=np.uint8)
    with pytest.raises(ValueError):
        ref.parse_int(flat, np.array([0]), np.array([3]), "int4")
    with pytest.raises(ValueError):
        ref.parse_numeric(flat, np.array([4]), np.array([5]), 2)
    with pytest.raises(ValueError):  # more fraction digits than the scale
        ref.parse_numeric(np.frombuffer(b"1.234", np.uint8), np.array([0]),
                          np.array([5]), 2)
    with pytest.raises(ValueError):
        ref.parse_int(np.frombuffer(b"2147483648", np.uint8), np.array([0]),
                      np.array([10]), "int4")
    with pytest.raises(ValueError):
        ref.parse_date(np.frombuffer(b"2023-02-29", np.uint8), np.array([0]),
                       np.array([10]))


def test_filter_keep_set():
    cols, _ = every_type()
    assert ref.keep_mask("i4 <= 10", cols).tolist() == [True, True, False,
                                                         True, False]
    with pytest.raises(ValueError):
        ref.keep_mask("i4 <= 10 and i2 > 0", cols)


class _Exact:
    """The reference's own columns in the program's place."""

    def __init__(self, want):
        self._want = want
        self.cols = [{"valid": c.valid, "values": c.values}
                     if c.values is not None else
                     {"valid": c.valid, "lens": c.lens, "flat": c.flat}
                     for c in want]

    def materialise(self, c, i):
        return self._want[c].decimal(i)


def test_lower_precision_is_rejected():
    cols, specs = every_type()
    want = ref.decode(specs, ref.split_copy(textenc.copy_text(cols),
                                            len(cols)))
    rows = np.arange(len(want[0].valid))
    rng = np.random.default_rng(1)
    exact = _Exact(want)
    assert sum(check.cells_bad(want, exact, rows).values()) == 0
    assert check.numeric_bad(want, exact, rows, rng) == 0
    low = check.Control(want, spec.load_json("configs", "tpcc-w4")["control"])
    bad = check.cells_bad(want, low, rows)
    assert bad["ts"] > 0  # cut to the millisecond
    assert bad["i4"] > 0 and bad["i8"] > 0  # through float32 / float64
    # NUMERIC through float64 rounds back to the same scaled integer, but
    # materialised it is the float's value, not the declared scale's
    assert bad["n2"] == 0
    assert check.numeric_bad(want, low, rows, rng) > 0
    assert low.materialise(3, 2) != Decimal("1234.56")
    assert bad["c"] == 0  # CHAR keeps its padding under this control
    # CHAR(4) with its padding trimmed: "ab  ", "    " and "a   " differ
    low = check.Control(want, spec.load_json("configs",
                                             "pgbench-s10")["control"])
    bad = check.cells_bad(want, low, rows)
    assert bad["c"] == 3 and bad["v"] == 0 and bad["t"] == 0
    assert low.cols[8]["lens"].tolist() == [2, 0, 0, 4, 1]


def test_an_unknown_lowering_is_refused():
    cols, specs = every_type()
    want = ref.decode(specs, ref.split_copy(textenc.copy_text(cols),
                                            len(cols)))
    with pytest.raises(ValueError):
        ref.lower_precision(want, {"int4": "float16"})


def test_reference_imports_nothing_of_the_program():
    pkg = Path(ref.__file__).resolve().parent
    for path in pkg.glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = [a.name for a in node.names] \
                if isinstance(node, ast.Import) else \
                [node.module or ""] if isinstance(node, ast.ImportFrom) \
                else []
            for n in names:
                assert n.split(".")[0] not in ("etl_tpu_torch", "etl_tpu",
                                               "jax", "torch"), path
    code = ("import sys; import etlbench.reference.decode; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=spec.ROOT).stdout
    loaded = set(json.loads(out.replace("'", '"')))
    assert not loaded & {"etl_tpu_torch", "etl_tpu", "jax", "torch"}
