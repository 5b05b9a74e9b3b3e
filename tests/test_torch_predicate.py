"""The port's publication row-filter IR (`etl_tpu_torch/ops/predicate.py`)
against the reference's (`etl_tpu/ops/predicate.py`): the parser, the
JSON form and the fingerprint, the per-row Kleene evaluators, schema
plumbing, and the lowering to the kernel's postfix program."""

import random

import numpy as np
import pytest

from etl_tpu.models import ColumnSchema as RColumnSchema
from etl_tpu.models import Oid
from etl_tpu.models import ReplicatedTableSchema as RSchema
from etl_tpu.models import TableName as RTableName
from etl_tpu.models import TableSchema as RTableSchema
from etl_tpu.ops import predicate as ref
from etl_tpu_torch import convert
from etl_tpu_torch.models import (ColumnSchema, ReplicatedTableSchema,
                                  TableName, TableSchema)
from etl_tpu_torch.ops import predicate as port
from etl_tpu_torch.ops.predicate import (MAX_PROGRAM_DEPTH, P_AND, P_CMP,
                                         P_NOT, P_NULLTEST, P_OR,
                                         RowFilterError, compile_row_filter,
                                         parse_row_filter, program_depth)

SQLS = [
    "(v < 10 AND note IS NOT NULL) OR NOT flag = TRUE",
    "a = 1 OR b = 2 AND c = 3",
    "(a = 1 OR b = 2) AND c = 3",
    "\"odd col\" = 'it''s'",
    "x IS NULL", "x IS NOT NULL", "NOT x IS NULL",
    "(v < 42)", "v <> -0", "v != 2.5e3", "d >= '2024-06-15' AND t < FALSE",
    "NOT NOT (a <= -9223372036854775808 OR b > 18446744073709551616)",
]


@pytest.mark.parametrize("sql", SQLS)
def test_parser_json_and_fingerprint_match_reference(sql):
    mine, theirs = parse_row_filter(sql), ref.parse_row_filter(sql)
    assert mine.to_json() == theirs.to_json()
    assert mine.fingerprint() == theirs.fingerprint()
    assert mine.referenced_columns() == theirs.referenced_columns()
    assert mine.sql == theirs.sql
    back = port.RowFilter.from_json(theirs.to_json())
    assert back == mine and hash(back) == hash(mine)
    # the generated SQL of the IR re-parses to the same tree
    again = parse_row_filter(port.RowFilter(mine.root).sql)
    assert again.fingerprint() == mine.fingerprint()


def test_precedence_and_forms():
    rf = parse_row_filter("a = 1 OR b = 2 AND c = 3")
    assert isinstance(rf.root, port.Or)
    assert isinstance(rf.root.items[1], port.And)
    assert parse_row_filter("\"odd col\" = 'it''s'").root \
        == port.Cmp("eq", "odd col", "it's")
    assert parse_row_filter("NOT x IS NULL").root \
        == port.Not(port.NullTest("x", False))


@pytest.mark.parametrize("sql", ["v + 1 < 2", "lower(note) = 'x'",
                                 "v IN (1,2)", "v BETWEEN 1 AND 2", "v < ",
                                 "((v < 1)", "v < 1)", "TRUE", "v IS 5",
                                 "v = 1 ~"])
def test_unsupported_sql_raises_like_reference(sql):
    with pytest.raises(ref.RowFilterError):
        ref.parse_row_filter(sql)
    with pytest.raises(RowFilterError):
        parse_row_filter(sql)


def _tables(oids):
    cols = [(f"c{i}", oid) for i, oid in enumerate(oids)]
    r = RTableSchema(1, RTableName("p", "t"),
                     tuple(RColumnSchema(n, o) for n, o in cols))
    p = TableSchema(1, TableName("p", "t"),
                    tuple(ColumnSchema(n, o) for n, o in cols))
    return r, p


KLEENE_OIDS = [Oid.INT4, Oid.INT8, Oid.DATE, Oid.TIMESTAMPTZ, Oid.TEXT,
               Oid.FLOAT8, Oid.NUMERIC, Oid.BOOL]
KLEENE_SQLS = [
    "c0 < 10 OR c1 < 10", "NOT c0 = 1", "c0 IS NULL", "c1 IS NOT NULL",
    "(c0 >= 0 AND c1 < 500000) OR c2 > '2024-06-01' OR c0 IS NULL",
    "c3 <= '2024-06-15 00:00:00+00' AND NOT c4 = 'beta'",
    "c5 > 0.5 OR c6 < 100 OR c7 = TRUE",
    "NOT (c0 < 5 AND (c1 > 7 OR c4 <> 'alpha'))",
]


def _rows(n, seed):
    rng = random.Random(seed)

    def maybe(v):
        return None if rng.random() < 0.15 else v

    return [[maybe(str(rng.randrange(-20, 20))),
             maybe(str(rng.randrange(-10**6, 10**6))),
             maybe(f"2024-{rng.randrange(1, 13):02d}-"
                   f"{rng.randrange(1, 29):02d}"),
             maybe(f"2024-06-{rng.randrange(14, 17)} "
                   f"{rng.randrange(24):02d}:00:00"
                   + rng.choice(["+00", "-05", "+09:30"])),
             maybe(rng.choice(["alpha", "beta", "gamma"])),
             maybe(f"{rng.uniform(-2, 2):.3f}"),
             maybe(f"{rng.randrange(0, 200)}.{rng.randrange(100):02d}"),
             maybe(rng.choice(["t", "f"]))] for _ in range(n)]


@pytest.mark.parametrize("sql", KLEENE_SQLS)
def test_kleene_text_evaluator_matches_reference(sql):
    rt, pt = _tables(KLEENE_OIDS)
    mine = parse_row_filter(sql).compile_texts(pt)
    theirs = ref.parse_row_filter(sql).compile_texts(rt)
    rows = _rows(400, seed=len(sql))
    got = [mine(r) for r in rows]
    assert got == [theirs(r) for r in rows]
    assert any(got) and not all(got)


def test_kleene_semantics():
    _, pt = _tables([Oid.INT4, Oid.INT4])
    allows = parse_row_filter("c0 < 10 OR c1 < 10").compile_texts(pt)
    assert allows(["5", None]) and allows([None, "5"])
    assert not allows([None, None])
    assert not allows([None, "50"])  # F OR U = U -> not published
    neg = parse_row_filter("NOT c0 = 1").compile_texts(pt)
    assert not neg([None, None])  # NOT U = U
    is_null = parse_row_filter("c0 IS NULL").compile_texts(pt)
    assert is_null([None, "1"]) and not is_null(["1", None])


def test_value_evaluator():
    from etl_tpu_torch.postgres.codec.text import parse_cell_text

    _, pt = _tables(KLEENE_OIDS)
    sql = KLEENE_SQLS[4]
    texts = parse_row_filter(sql).compile_texts(pt)
    values = parse_row_filter(sql).compile_values(pt)
    for r in _rows(200, seed=3):
        decoded = [None if v is None else parse_cell_text(v, c.type_oid)
                   for v, c in zip(r, pt.columns)]
        assert values(decoded) == texts(r)


def test_unknown_column_and_bad_literal_fail_at_compile():
    schema = convert.schema_from_plain(
        1, "public", "t", [("c0", Oid.INT8, -1, True, None),
                           ("c1", Oid.INT4, -1, True, None),
                           ("c2", Oid.TIMESTAMP, -1, True, None)],
        [True] * 3, [True] * 3)
    for sql in ("missing < 1", "c1 > 0.5", "c2 > '2024-01-01T00:00:00'"):
        with pytest.raises(RowFilterError):
            compile_row_filter(sql, schema)


def test_schema_json_round_trip_with_filter():
    rschema = RSchema.with_all_columns(RTableSchema(
        1, RTableName("public", "t"),
        (RColumnSchema("c0", Oid.INT8), RColumnSchema("c1", Oid.INT4)))) \
        .with_row_predicate(ref.parse_row_filter("c1 < 7"))
    back = ReplicatedTableSchema.from_json(rschema.to_json())
    assert back.to_json() == rschema.to_json()
    assert back.row_predicate == parse_row_filter("c1 < 7")
    assert back == back.with_row_predicate(None)  # not part of equality
    rf = parse_row_filter("c0 = 1")
    with_rf = back.with_row_predicate(rf)
    assert with_rf.with_row_predicate(rf) is with_rf


def test_device_eligibility_matches_reference():
    oids = [Oid.INT4, Oid.FLOAT8, Oid.TEXT, Oid.NUMERIC, Oid.TIMESTAMPTZ]
    rschema = RSchema.with_all_columns(RTableSchema(
        1, RTableName("p", "t"),
        tuple(RColumnSchema(f"c{i}", o) for i, o in enumerate(oids))))
    pschema = convert.schema_from_plain(
        1, "p", "t", [(f"c{i}", o, -1, True, None)
                      for i, o in enumerate(oids)], [True] * 5, [True] * 5)
    for sql in ("c0 < 1", "c1 > 0.5", "c2 = 'x'", "c3 < 5", "c4 IS NULL",
                "c0 < 1 OR c2 = 'x'"):
        mine = compile_row_filter(sql, pschema)
        theirs = ref.compile_row_filter(sql, rschema)
        assert mine.device_supported == theirs.device_supported, sql
        assert mine.referenced_indices == theirs.referenced_indices
        assert mine.kernel_supported == mine.device_supported


def _pgbench_schema():
    return convert.schema_from_plain(
        16384, "public", "pgbench_accounts",
        [("aid", Oid.INT4, -1, False, 1), ("bid", Oid.INT4, -1, True, None),
         ("abalance", Oid.INT4, -1, True, None),
         ("filler", Oid.BPCHAR, 88, True, None)],
        [True] * 4, [True, False, False, False])


def test_program_lowering():
    """Postfix order, folded literals and stack depth of the kernel's
    program (`pred.program`, columns as replicated indices)."""
    schema = _pgbench_schema()
    prog = compile_row_filter("bid <= 5", schema).program
    # le → NOT of gt
    assert prog == ((P_CMP, 1, port.CMP_GT, 1, 5, 0, 0, 0),)
    pred = compile_row_filter(
        "(aid < 3 OR bid IS NULL) AND NOT abalance >= 10000000000", schema)
    assert pred.program == (
        (P_CMP, 0, port.CMP_LT, 0, 3, 0, 0, 0),
        (P_NULLTEST, 1, 0, 0, 0, 0, 0, 0),
        (P_OR, 0, 0, 0, 2, 0, 0, 0),
        # ge → NOT of lt; out of int32 range → constant TRUE
        (P_CMP, 2, port.CMP_CONST, 1, 1, 0, 0, 0),
        (P_NOT, 0, 0, 0, 0, 0, 0, 0),
        (P_AND, 0, 0, 0, 2, 0, 0, 0))
    assert pred.program_depth == 2 and pred.kernel_supported


@pytest.mark.parametrize("kind_oid,sql,leaf", [
    # U32: the literal takes the sign-flip bias
    (Oid.OID, "c0 < 3000000000",
     (port.CMP_LT, 0, 3000000000 ^ 0x80000000, 0, 0, 0)),
    # out of the U32 range: v > -1 is TRUE for every present value
    (Oid.OID, "c0 > -1", (port.CMP_CONST, 0, 1, 0, 0, 0)),
    # I64: three base-10^9 limbs, low first, then the literal's sign
    (Oid.INT8, "c0 = -1234567890123456789",
     (port.CMP_EQ, 0, 123456789, 234567890, 1, 1)),
    # TIME: (ms, µs); ne → NOT of eq
    (Oid.TIME, "c0 <> '12:00:00.5'", (port.CMP_EQ, 1, 43_200_500, 0, 0, 0)),
    # TIMESTAMPTZ: (days, ms, µs); ge → NOT of lt
    (Oid.TIMESTAMPTZ, "c0 >= '2024-06-15 00:00:01+00'",
     (port.CMP_LT, 1, 19889, 1000, 0, 0)),
    (Oid.TIMESTAMP, "c0 < 'infinity'", (port.CMP_CONST, 0, 1, 0, 0, 0)),
    (Oid.INT4, "c0 = 99999999999", (port.CMP_CONST, 0, 0, 0, 0, 0)),
])
def test_literal_folding(kind_oid, sql, leaf):
    schema = convert.schema_from_plain(
        1, "p", "t", [("c0", kind_oid, -1, True, None)], [True], [True])
    (ins,) = compile_row_filter(sql, schema).program
    assert ins[:2] == (P_CMP, 0)
    assert ins[2:] == leaf


def test_deep_program_is_outside_the_kernel():
    """A filter whose postfix program needs more than MAX_PROGRAM_DEPTH
    stack entries is device-comparable but not kernel-supported: the
    engine applies it host-side."""
    schema = _pgbench_schema()
    wide = " OR ".join(f"bid = {i}" for i in range(MAX_PROGRAM_DEPTH + 1))
    pred = compile_row_filter(wide, schema)
    assert pred.device_supported and not pred.kernel_supported
    assert program_depth(pred.program) == MAX_PROGRAM_DEPTH + 1
    fits = " OR ".join(f"bid = {i}" for i in range(MAX_PROGRAM_DEPTH))
    assert compile_row_filter(fits, schema).kernel_supported
    # a group nested on the right deepens the program, one on the left
    # does not
    right = "bid = 0"
    for i in range(1, 40):
        right = f"(bid = {i} AND ({right}))"
    assert compile_row_filter(right, schema).program_depth == 40
    left = "bid = 0"
    for i in range(1, 40):
        left = f"(({left}) OR bid = {i})"
    assert compile_row_filter(left, schema).program_depth == 2


def test_host_keep_over_decoded_values():
    """host_keep on a batch built from values equals the text
    evaluator, NULLs and TOAST included (TOAST keeps the row)."""
    from etl_tpu_torch.models import TOAST_UNCHANGED, ColumnarBatch
    from etl_tpu_torch.postgres.codec.text import parse_cell_text

    schema = convert.schema_from_plain(
        1, "p", "t", [(f"c{i}", o, -1, True, None)
                      for i, o in enumerate(KLEENE_OIDS)],
        [True] * len(KLEENE_OIDS), [True] * len(KLEENE_OIDS))
    for sql in KLEENE_SQLS:
        pred = compile_row_filter(sql, schema)
        allows = pred.filter.compile_texts(schema.table_schema)
        rows = _rows(150, seed=len(sql) + 1)
        cells = [[None if r[j] is None else
                  parse_cell_text(r[j], KLEENE_OIDS[j]) for r in rows]
                 for j in range(len(KLEENE_OIDS))]
        batch = ColumnarBatch.from_cells(schema, cells, len(rows))
        np.testing.assert_array_equal(pred.host_keep(batch),
                                      [allows(r) for r in rows])
        cells[0][3] = TOAST_UNCHANGED
        toasted = ColumnarBatch.from_cells(schema, cells, len(rows))
        if 0 in pred.referenced_indices:
            assert pred.host_keep(toasted)[3]
