"""The port's plain fused row filter (`parse_and_pack_plain` with `pred=`
and `row_flags=`, the plain version of K2 and the compaction epilogue)
against the reference's `bitpack.parse_and_pack(pred=…, row_flags=…)`
(XLA on the CPU) and its Pallas kernel `build_pallas_program(…, pred=…,
interpret=True)`: `(words_compacted, keep_mask, counts)` must be equal bit
for bit — 0 differing words.

Inputs come from `etl_tpu_torch.testing.filter_case` (seeded field text
with adversarial rows, NULL fields, edge values of every comparable kind,
dead and force-kept rows) plus hand-written rows for the survivor edges.
The reference's XLA function runs op by op (`jax.disable_jit`) for the
kind × operator matrix: the same XLA operations as the jitted program,
without a compile per filter.
"""

import numpy as np
import pytest
import torch

import jax

from etl_tpu.models import (ColumnSchema, Oid, ReplicatedTableSchema,
                            TableName, TableSchema)
from etl_tpu.models.pgtypes import CellKind as RK
from etl_tpu.ops import bitpack as ref_bitpack
from etl_tpu.ops.pallas_kernel import build_pallas_program
from etl_tpu.ops.predicate import compile_row_filter as ref_compile
from etl_tpu_torch import convert
from etl_tpu_torch.models.pgtypes import CellKind as K
from etl_tpu_torch.ops.bitpack import parse_and_pack_plain, unpack_keep_mask
from etl_tpu_torch.ops.predicate import DEVICE_CMP_KINDS, compile_row_filter
from etl_tpu_torch.testing import filter_case, text_matrix
from test_torch_words_int import bit_width

# comparable kind → (oid, gather width, a literal that splits its values)
KINDS = {
    K.BOOL: (Oid.BOOL, 4, "TRUE"),
    K.I16: (Oid.INT2, 8, "100"),
    K.I32: (Oid.INT4, 12, "-5000000"),
    K.U32: (Oid.OID, 12, "3000000000"),
    K.I64: (Oid.INT8, 20, "-999999999"),
    K.DATE: (Oid.DATE, 16, "'2000-01-01'"),
    K.TIME: (Oid.TIME, 16, "'12:00:00'"),
    K.TIMESTAMP: (Oid.TIMESTAMP, 32, "'2000-01-01 00:00:00'"),
    K.TIMESTAMPTZ: (Oid.TIMESTAMPTZ, 32, "'2024-06-15 00:00:00+00'"),
}
OPS = ["=", "<>", "<", "<=", ">", ">="]
NIBBLE_KINDS = [k for k in KINDS if k is not K.BOOL]


def schemas(kinds, sql):
    """(reference schema, port schema, reference filter, port filter) for
    columns c0, c1, … of `kinds` under the row filter `sql`."""
    ref = ReplicatedTableSchema.with_all_columns(TableSchema(
        1, TableName("public", "t"),
        tuple(ColumnSchema(f"c{i}", KINDS[k][0])
              for i, k in enumerate(kinds))))
    port = convert.schema_from_plain(
        1, "public", "t",
        [(c.name, c.type_oid, c.modifier, c.nullable, c.primary_key_ordinal)
         for c in ref.table_schema.columns],
        list(ref.replication_mask), list(ref.identity_mask), row_filter=sql)
    return ref, port, ref_compile(sql, ref), \
        compile_row_filter(port.row_predicate, port)


def specs_of(kinds):
    return tuple((i, k, KINDS[k][1], bit_width(k, KINDS[k][1]))
                 for i, k in enumerate(kinds))


def reference(bm, ln, fl, specs, nibble, rpred, jit=False):
    rspecs = tuple((c, RK[k.name], w, bw) for c, k, w, bw in specs)

    def fn(b, lens, flags):
        return ref_bitpack.parse_and_pack(b, lens.astype(np.int32), rspecs,
                                          nibble, pred=rpred,
                                          row_flags=flags)

    if jit:
        out = jax.jit(fn)(bm, ln, fl)
    else:
        with jax.disable_jit():
            out = fn(bm, ln, fl)
    return [np.asarray(o) for o in out]


def port(bm, ln, fl, specs, nibble, pred):
    out = parse_and_pack_plain(torch.from_numpy(bm), torch.from_numpy(ln),
                               specs, nibble, pred=pred,
                               row_flags=torch.from_numpy(fl))
    return [o.numpy() for o in out]


def assert_identical(got, want):
    names = ("words_compacted", "keep_mask", "counts")
    for name, g, w in zip(names, got, want):
        assert g.shape == w.shape, name
        assert g.view(np.uint32).tobytes() == w.view(np.uint32).tobytes(), \
            (name, np.flatnonzero((g != w).reshape(-1))[:8])


def check(kinds, sql, nibble=False, rows=600, seed=0, jit=False):
    _, _, rpred, pred = schemas(kinds, sql)
    specs = specs_of(kinds)
    bm, ln, fl = filter_case(specs, rows, np.random.default_rng(seed),
                             nibble)
    want = reference(bm, ln, fl, specs, nibble, rpred, jit)
    got = port(bm, ln, fl, specs, nibble, pred)
    assert_identical(got, want)
    return got


MATRIX = [(k, op) for k in KINDS for op in OPS]


@pytest.mark.parametrize("kind,op", MATRIX,
                         ids=[f"{k.name}-{op}" for k, op in MATRIX])
def test_kind_op_matches_xla(kind, op):
    """Every comparable kind × every operator, against a literal that
    splits the column's values, beside an I64 column."""
    got = check([K.I64, kind], f"c1 {op} {KINDS[kind][2]}",
                seed=kind.value * 10 + OPS.index(op))
    assert 0 < int(got[2][0]) < 600


@pytest.mark.parametrize("kind", NIBBLE_KINDS, ids=lambda k: k.name)
def test_nibble_kinds_match_xla(kind):
    check([kind, K.I32], f"c0 >= {KINDS[kind][2]} OR c1 IS NULL",
          nibble=True, seed=kind.value)


CONST_FOLDS = [
    (K.U32, "c0 < -1"), (K.U32, "c0 >= 4294967296"),
    (K.U32, "c0 = 4294967296"), (K.U32, "c0 <> -5"),
    (K.I32, "c0 < 10000000000000"), (K.I32, "c0 > -10000000000000"),
    (K.I16, "c0 <= 99999999999"), (K.I16, "c0 = 70000"),
    (K.I32, "c0 <> 99999999999"),
    (K.I64, "c0 < 10000000000000000000000000000"),
    (K.I64, "c0 >= -100000000000000000000000000000"),
    (K.TIMESTAMP, "c0 < 'infinity'"), (K.TIMESTAMPTZ, "c0 > '-infinity'"),
    (K.TIMESTAMPTZ, "c0 = 'infinity'"),
]


@pytest.mark.parametrize("kind,sql", CONST_FOLDS,
                         ids=[f"{k.name}:{s}" for k, s in CONST_FOLDS])
def test_constant_folded_literals(kind, sql):
    """Literals no in-range value reaches fold to constant masks; NULLs
    stay unknown."""
    check([kind], sql, seed=len(sql))


COMPOUNDS = [
    "(c1 < 100 AND c2 >= -5000000) OR NOT (c3 > 3000000000 OR c4 IS NULL)",
    "NOT (c0 = TRUE) AND (c5 < '2000-01-01' OR c6 >= '12:00:00')",
    "c7 IS NOT NULL AND (c8 > '2024-06-15 00:00:00+00' OR c4 = -0)",
    "NOT NOT (c1 IS NULL OR c2 IS NULL OR c3 IS NULL) OR c4 < 0",
    "(c0 = FALSE OR c0 IS NULL) AND (c7 <= '2000-01-01 00:00:00' "
    "OR (c6 < '12:00:00' AND c5 > '2000-01-01' AND c2 <> 0))",
]


@pytest.mark.parametrize("i", range(len(COMPOUNDS)))
def test_compound_kleene_filters_match_xla(i):
    """AND/OR/NOT/IS NULL over every comparable kind at once, with NULL
    fields: Kleene three-valued logic, jitted as the engine runs it."""
    check(list(KINDS), COMPOUNDS[i], rows=1000, seed=100 + i, jit=True)


def test_compound_nibble_matches_xla():
    kinds = NIBBLE_KINDS
    check(kinds, "(c0 < 100 OR c3 > -999999999) AND NOT c7 IS NULL "
          "OR c5 = '12:00:00'", nibble=True, rows=1000, seed=7, jit=True)


def _edge_inputs(texts, flags):
    specs = specs_of([K.I32])
    bm, ln = text_matrix(specs, [texts])
    return specs, bm, ln, np.asarray(flags, dtype=np.uint8)


@pytest.mark.parametrize("sql,flags,survivors", [
    ("c0 < -5000", [1] * 40, []),                     # zero survivors
    ("c0 >= -1000 OR c0 IS NULL", [1] * 40, list(range(40))),  # all
    ("c0 = 17", [1] * 40, [17]),                      # a single one
    ("c0 = 17", [2] * 40, list(range(40))),           # all force-kept
    ("c0 >= 0", [0] * 40, []),                        # all dead
    ("c0 < 20", [0, 1, 2, 0] * 10,
     [i for i in range(40) if i % 4 in (1, 2) and (i < 20 or i % 4 == 2)]),
])
def test_survivor_edges(sql, flags, survivors):
    _, _, rpred, pred = schemas([K.I32], sql)
    specs, bm, ln, fl = _edge_inputs([str(i) for i in range(40)], flags)
    want = reference(bm, ln, fl, specs, False, rpred)
    got = port(bm, ln, fl, specs, False, pred)
    assert_identical(got, want)
    assert list(unpack_keep_mask(got[1], 40)) == survivors
    assert int(got[2][0]) == len(survivors)
    assert not got[0][:, len(survivors):].any()  # zeros behind


def test_unparseable_referenced_fields_are_kept():
    """A present field that fails its device parse is unevaluable: kept
    whatever the predicate says (the host re-judges it)."""
    _, _, rpred, pred = schemas([K.I32], "c0 > 5")
    specs, bm, ln, fl = _edge_inputs(["1", "x", "99999999999", "", "7"],
                                     [1] * 5)
    want = reference(bm, ln, fl, specs, False, rpred)
    got = port(bm, ln, fl, specs, False, pred)
    assert_identical(got, want)
    # "" has length 0: NULL on the device, so unknown and dropped
    assert list(unpack_keep_mask(got[1], 5)) == [1, 2, 4]


def test_covers_every_device_comparable_kind():
    assert set(KINDS) == set(DEVICE_CMP_KINDS)


# -- against the Pallas kernel (interpret mode) ------------------------------

PALLAS_SETS = {
    "int-nibble": ([K.I32, K.I64], True, "c0 < 100 OR c1 <> -0"),
    "temporal-raw": ([K.DATE, K.TIMESTAMPTZ], False,
                     "c0 >= '2000-01-01' AND NOT c1 < "
                     "'2024-06-15 00:00:00+00' OR c0 IS NULL"),
    "bool-u32-raw": ([K.BOOL, K.U32], False,
                     "c0 = TRUE AND c1 > 2147483648 OR c1 < -1"),
    "time-i16-nibble": ([K.TIME, K.I16], True,
                        "c0 > '12:00:00' OR c1 <= 100"),
}


@pytest.mark.parametrize("name", list(PALLAS_SETS))
def test_filtered_plain_matches_pallas_interpret(name):
    """The reference's fused Pallas kernel in interpret mode, 512 rows.
    Its TIMESTAMPTZ offset reads past the field width pack other values
    than the XLA program (see test_torch_pallas.py), and on a field longer
    than its width the two engines can even disagree on the ok bit, so on
    keep. The engine force-keeps every row with a referenced field longer
    than its gather width (`DeviceDecoder._row_flags`); this test does the
    same. Then the keep mask and the count agree exactly, and the words
    agree with the Pallas words wherever the two reference engines
    agree."""
    kinds, nibble, sql = PALLAS_SETS[name]
    _, _, rpred, pred = schemas(kinds, sql)
    specs = specs_of(kinds)
    bm, ln, fl = filter_case(specs, 512, np.random.default_rng(len(name)),
                             nibble)
    oversized = (ln > np.array([w for _, _, w, _ in specs])).any(axis=1)
    fl[oversized & (fl > 0)] = 2
    rspecs = tuple((c, RK[k.name], w, bw) for c, k, w, bw in specs)
    fn = build_pallas_program(rspecs, nibble, interpret=True, pred=rpred)
    pallas = [np.asarray(o) for o in fn(bm, ln.astype(np.int32), fl)]
    xla = reference(bm, ln, fl, specs, nibble, rpred, jit=True)
    got = port(bm, ln, fl, specs, nibble, pred)
    assert_identical(got, xla)
    assert_identical([got[0][:, :0]] + got[1:], [pallas[0][:, :0]]
                     + pallas[1:])
    split = (pallas[0] != xla[0]).any(axis=0)
    if K.TIMESTAMPTZ not in kinds:
        assert not split.any()
    np.testing.assert_array_equal(got[0][:, ~split], pallas[0][:, ~split])
