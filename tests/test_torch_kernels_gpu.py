"""The CUDA decode kernel against its plain version, on the card.

Needs a CUDA device and nvcc; skipped without them. Imports neither jax
nor etl_tpu, so it runs on a machine that has only the port:

    python -m pytest tests/test_torch_kernels_gpu.py -m gpu --noconftest
"""

import numpy as np
import pytest
import torch

from etl_tpu_torch.models.pgtypes import CellKind as K
from etl_tpu_torch.ops import decode_kernel
from etl_tpu_torch.ops.bitpack import parse_and_pack_plain, saturation_width
from etl_tpu_torch.testing import field_matrix

pytestmark = pytest.mark.gpu

WIDTHS = {K.BOOL: 4, K.I16: 8, K.I32: 12, K.U32: 12, K.I64: 20, K.F32: 16,
          K.F64: 24, K.DATE: 16, K.TIME: 16, K.TIMESTAMP: 32,
          K.TIMESTAMPTZ: 32}
NIBBLE = (K.I16, K.I32, K.U32, K.I64, K.DATE, K.TIME, K.TIMESTAMP,
          K.TIMESTAMPTZ)
CASES = [(k, False) for k in WIDTHS] + [(k, True) for k in NIBBLE]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    decode_kernel.load()
    return torch.device("cuda")


def _both(specs, nibble, rows, seed, lengths_dtype=np.uint8):
    bm, ln = field_matrix(specs, rows, np.random.default_rng(seed), nibble,
                          lengths_dtype)
    bm_d, ln_d = torch.from_numpy(bm).cuda(), torch.from_numpy(ln).cuda()
    got = decode_kernel.decode_pack(bm_d, ln_d, specs, nibble)
    want = parse_and_pack_plain(bm_d, ln_d, specs, nibble)
    torch.cuda.synchronize()
    return got.view(torch.int32).cpu(), want.view(torch.int32).cpu()


@pytest.mark.parametrize("kind,nibble", CASES,
                         ids=[f"{k.name}-{'nibble' if n else 'raw'}"
                              for k, n in CASES])
def test_kernel_matches_plain(cuda, kind, nibble):
    for extra in (0, 8):
        w = WIDTHS[kind] + extra
        bw = (min(w, saturation_width(kind)) + 1) & ~1
        got, want = _both(((0, kind, w, bw),), nibble, 3000,
                          seed=100 * kind.value + w + int(nibble))
        assert torch.equal(got, want), (kind, nibble, w)


def test_int32_lengths_raw(cuda):
    specs = tuple((i, k, w, (min(w, saturation_width(k)) + 1) & ~1)
                  for i, (k, w) in enumerate(WIDTHS.items()))
    got, want = _both(specs, False, 2000, seed=11, lengths_dtype=np.int32)
    assert torch.equal(got, want)


def test_wide_layout_many_words(cuda):
    specs = tuple((i, K.I64, 20, 18) for i in range(40))
    got, want = _both(specs, True, 1000, seed=12)
    assert got.shape[0] > 40 and torch.equal(got, want)


def test_launch_counter_and_cpu_route(cuda):
    specs = ((0, K.I32, 12, 10),)
    bm, ln = field_matrix(specs, 64, np.random.default_rng(0), False)
    before = decode_kernel.launches
    decode_kernel.decode_pack(torch.from_numpy(bm), torch.from_numpy(ln),
                              specs, False)
    assert decode_kernel.launches == before  # CPU tensors: plain version
    decode_kernel.decode_pack(torch.from_numpy(bm).cuda(),
                              torch.from_numpy(ln).cuda(), specs, False)
    assert decode_kernel.launches == before + 1


def test_decoder_cuda_matches_cpu(cuda):
    from etl_tpu_torch import bench
    from etl_tpu_torch.ops.engine import DeviceDecoder
    from etl_tpu_torch.ops.wal import concat_payloads, stage_wal_batch

    payloads = bench.build_workload(5000)
    schema = bench.make_schema()
    staged = stage_wal_batch(*concat_payloads(payloads), 4).staged
    gpu = DeviceDecoder(schema, device="cuda").decode(staged)
    cpu = DeviceDecoder(schema, device="cpu").decode(staged)
    assert bench.batches_equal(gpu, cpu)
    assert bench.oracle_sample_ok(gpu, payloads, schema, 200, seed=1)


# -- the fused row filter (K2) and its compaction epilogue -------------------

def _kind_schema(kinds):
    from etl_tpu_torch.models import (ColumnSchema, Oid,
                                      ReplicatedTableSchema, TableName,
                                      TableSchema)

    oid = {K.BOOL: Oid.BOOL, K.I16: Oid.INT2, K.I32: Oid.INT4,
           K.U32: Oid.OID, K.I64: Oid.INT8, K.DATE: Oid.DATE,
           K.TIME: Oid.TIME, K.TIMESTAMP: Oid.TIMESTAMP,
           K.TIMESTAMPTZ: Oid.TIMESTAMPTZ}
    return ReplicatedTableSchema.with_all_columns(TableSchema(
        1, TableName("public", "kinds"),
        tuple(ColumnSchema(f"c{i}", oid[k]) for i, k in enumerate(kinds))))


FILTER_CASES = {
    # name: (kinds, nibble, filter)
    "raw-compound": (
        [K.BOOL, K.I16, K.I32, K.U32, K.I64, K.DATE, K.TIME, K.TIMESTAMP,
         K.TIMESTAMPTZ], False,
        "((c0 = TRUE OR c1 < 100) AND (c2 >= -5000000 OR c3 > 3000000000) "
        "AND NOT (c4 = -0 OR c5 IS NULL)) OR (c6 < '12:00:00' AND "
        "c7 > '2000-01-01 00:00:00') OR c8 <= '2024-06-15 00:00:00+00' "
        "OR c3 < -1 OR (c2 > 10000000000000 AND c4 <> 1)"),
    "nibble-int-temporal": (
        [K.I16, K.I32, K.U32, K.I64, K.DATE, K.TIME, K.TIMESTAMP,
         K.TIMESTAMPTZ], True,
        "((c0 >= 100 AND c1 <> -2147483648) OR c2 <= 2147483648 OR "
        "c3 IS NULL) AND NOT (c4 > '2000-01-01' AND c5 >= '12:00:00') AND "
        "(c6 < '2000-01-01 00:00:00' OR c7 = '2024-06-15 00:00:00+00' OR "
        "c3 > -1 OR c1 < 99999999999)"),
    "i64-tstz-edges": (
        [K.I64, K.TIMESTAMPTZ], False,
        "c0 < -999999999 OR c1 >= '2024-06-15 00:00:00+00'"),
}


def _filtered_both(name, rows, seed):
    from etl_tpu_torch.ops.bitpack import filter_pack_plain
    from etl_tpu_torch.ops.predicate import compile_row_filter
    from etl_tpu_torch.testing import filter_case

    kinds, nibble, sql = FILTER_CASES[name]
    specs = tuple((i, k, WIDTHS[k], (min(WIDTHS[k], saturation_width(k))
                                     + 1) & ~1) for i, k in enumerate(kinds))
    pred = compile_row_filter(sql, _kind_schema(kinds))
    bm, ln, fl = filter_case(specs, rows, np.random.default_rng(seed), nibble)
    args = (torch.from_numpy(bm).cuda(), torch.from_numpy(ln).cuda(),
            torch.from_numpy(fl).cuda(), specs, nibble, pred)
    got = decode_kernel.decode_pack_filtered(*args)
    want = parse_and_pack_plain(args[0], args[1], specs, nibble, pred=pred,
                                row_flags=args[2])
    k2 = decode_kernel.filter_pack(*args)
    k2_want = filter_pack_plain(*args, decode_kernel.FILTER_BLOCK)
    torch.cuda.synchronize()

    def host(ts):
        return [t.view(torch.int32).cpu() for t in ts]

    return host(got), host(want), host(k2), host(k2_want)


@pytest.mark.parametrize("name", list(FILTER_CASES))
@pytest.mark.parametrize("rows", [4099, 20000])
def test_filtered_kernels_match_plain(cuda, name, rows):
    got, want, k2, k2_want = _filtered_both(name, rows, seed=rows + len(name))
    for a, b in zip(got, want):
        assert torch.equal(a, b), name
    for a, b in zip(k2, k2_want):
        assert torch.equal(a, b), name
    assert 0 < int(want[2][0]) < rows


def test_filtered_launch_counters(cuda):
    before = (decode_kernel.filter_launches, decode_kernel.compact_launches)
    _filtered_both("i64-tstz-edges", 300, seed=3)
    # decode_pack_filtered launches both kernels, filter_pack one more K2
    assert (decode_kernel.filter_launches, decode_kernel.compact_launches) \
        == (before[0] + 2, before[1] + 1)


def test_filtered_decoder_cuda_matches_cpu(cuda):
    from etl_tpu_torch import bench
    from etl_tpu_torch.ops.engine import DeviceDecoder
    from etl_tpu_torch.ops.predicate import parse_row_filter
    from etl_tpu_torch.ops.wal import concat_payloads, stage_wal_batch

    payloads = bench.build_workload(5000)
    schema = bench.make_schema().with_row_predicate(
        parse_row_filter("bid <= 5"))
    staged = stage_wal_batch(*concat_payloads(payloads), 4).staged
    p = DeviceDecoder(schema, device="cuda").decode_async(staged)
    gpu = p.result()
    cpu = DeviceDecoder(schema, device="cpu").decode(staged)
    assert bench.filtered_batches_identical(gpu, cpu)
    truth = [i for i, (_, bid, _) in enumerate(bench.pgbench_rows(5000))
             if bid <= 5]
    assert list(gpu.source_rows) == truth
    assert {"d2h_words_ms", "fetched_bytes"} <= set(p.timings)
    assert bench.oracle_sample_ok(gpu, payloads, schema, 200, seed=1)


def test_filter_column_position_per_table(cuda):
    """`bid <= 5` on (aid, bid, abalance) and on (bid, aid, abalance), the
    same dense specs: each table's kernel keeps its own rows."""
    from etl_tpu_torch import convert
    from etl_tpu_torch.ops.predicate import compile_row_filter
    from etl_tpu_torch.testing import filter_case

    bw = (min(12, saturation_width(K.I32)) + 1) & ~1
    specs = tuple((i, K.I32, 12, bw) for i in range(3))
    bm, ln, fl = filter_case(specs, 5000, np.random.default_rng(11), True)
    args = (torch.from_numpy(bm).cuda(), torch.from_numpy(ln).cuda(),
            torch.from_numpy(fl).cuda())
    keeps = []
    for names in (("aid", "bid", "abalance"), ("bid", "aid", "abalance")):
        pred = compile_row_filter("bid <= 5", convert.schema_from_plain(
            1, "public", "t", [(n, 23, -1, False, None) for n in names],
            [True] * 3, [False] * 3))
        got = decode_kernel.decode_pack_filtered(*args, specs, True, pred)
        want = parse_and_pack_plain(args[0], args[1], specs, True,
                                    pred=pred, row_flags=args[2])
        for a, b in zip(got, want):
            assert torch.equal(a.view(torch.int32).cpu(),
                               b.view(torch.int32).cpu()), names
        keeps.append(want[1].cpu())
    assert not torch.equal(keeps[0], keeps[1])


# -- the block walks: 256-row tiles, sub-tiles, direct -----------------------

WALKS = [256, 128, 64, 32, 0]  # tile rows; 0 = direct, from global memory


def _bw(kind, w):
    return (min(w, saturation_width(kind)) + 1) & ~1


ALL_RAW = tuple((i, k, w, _bw(k, w))
                for i, (k, w) in enumerate(WIDTHS.items()))
NIB_SPECS = tuple((i, k, WIDTHS[k], _bw(k, WIDTHS[k]))
                  for i, k in enumerate(NIBBLE))
PGBENCH = tuple((i, K.I32, 8, 8) for i in range(3))


def _pool(make, rows, pool=4096):
    parts = make(min(rows, pool))
    reps = -(-rows // pool)
    return tuple(np.ascontiguousarray(np.tile(a, (reps,) + (1,) * (a.ndim - 1))
                                      [:rows]) for a in parts)


def _k1(specs, nibble, rows, seed, lengths_dtype=np.uint8, walk=None,
        view=lambda t: t):
    """K1 (in `walk`, or the planner's) against the plain version, on the
    card; returns the path the launch took."""
    rng = np.random.default_rng(seed)
    bm, ln = _pool(lambda n: field_matrix(specs, n, rng, nibble,
                                          lengths_dtype), rows)
    bm_d, ln_d = (view(torch.from_numpy(a).cuda()) for a in (bm, ln))
    before = dict(decode_kernel.path_launches)
    got = decode_kernel.decode_pack(bm_d, ln_d, specs, nibble, walk=walk)
    want = parse_and_pack_plain(bm_d, ln_d, specs, nibble)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32).cpu(),
                       want.view(torch.int32).cpu()), (specs, nibble, walk)
    return [k for k, v in decode_kernel.path_launches.items()
            if v != before[k]]


@pytest.mark.parametrize("walk", WALKS)
@pytest.mark.parametrize("layout", ["raw-int32-lengths", "nibble-u8",
                                    "nibble-ints-2-rows"])
def test_kernel_walks_match_plain(cuda, walk, layout):
    if layout == "nibble-u8":
        path = _k1(NIB_SPECS, True, 3001, seed=21, walk=walk)
    elif layout == "nibble-ints-2-rows":  # two rows a thread from 64 rows
        specs = NIB_SPECS[:3] + ((3, K.I64, 16, 18), (4, K.I32, 4, 4))
        path = _k1(specs, True, 3001, seed=23, walk=walk)
    else:
        path = _k1(ALL_RAW, False, 3001, seed=22, lengths_dtype=np.int32,
                   walk=walk)
    assert path == [decode_kernel.path_of(walk)]


ROW_BYTES_CASES = {
    11: (((0, K.I32, 11, 10),), False),
    12: (PGBENCH, True),
    6: (((0, K.I32, 12, 10),), True),
    40: (((0, K.I64, 20, 18), (1, K.I64, 20, 18)), False),
    228: (ALL_RAW + ((11, K.TIMESTAMPTZ, 36, 2),), False),
}


@pytest.mark.parametrize("row_bytes", list(ROW_BYTES_CASES))
def test_row_bytes_not_multiple_of_16(cuda, row_bytes):
    specs, nibble = ROW_BYTES_CASES[row_bytes]
    assert _k1(specs, nibble, 4097, seed=row_bytes) == ["tile"]


@pytest.mark.parametrize("rows", [1, 31, 257, 65_499])
def test_row_counts(cuda, rows):
    _k1(PGBENCH, True, rows, seed=rows)
    got, want, k2, k2_want = _filtered(
        [K.I32, K.I32, K.I32], True, "c1 <= 5 OR c2 IS NULL", rows,
        seed=rows)
    for a, b in zip(got + k2, want + k2_want):
        assert torch.equal(a, b), rows


@pytest.mark.parametrize("name,specs,nibble,path", [
    ("11-raw-kinds", ALL_RAW, False, "tile"),  # a tile above 48 KB
    ("100-i32-nibble", tuple((i, K.I32, 12, 10) for i in range(100)), True,
     "subtile"),
    ("260-i32-nibble", tuple((i, K.I32, 12, 10) for i in range(260)), True,
     "subtile"),
])
def test_wide_rows_take_the_planned_walk(cuda, name, specs, nibble, path):
    assert _k1(specs, nibble, 2000, seed=31) == [path], name


def test_misaligned_base_reads_direct(cuda):
    """A view that starts one row in is off 16-byte alignment (12-byte
    rows): the launch reads global memory directly, with the same words;
    so does K2."""
    assert _k1(PGBENCH, True, 5001, seed=5, view=lambda t: t[1:]) \
        == ["direct"]
    got, want, k2, k2_want = _filtered(
        [K.I32, K.I32, K.I32], True, "c1 <= 5", 5001, seed=5,
        view=lambda t: t[1:])
    for a, b in zip(got + k2, want + k2_want):
        assert torch.equal(a, b)


def _filtered(kinds, nibble, sql, rows, seed, walk=None, view=lambda t: t):
    from etl_tpu_torch.ops.bitpack import filter_pack_plain
    from etl_tpu_torch.ops.predicate import compile_row_filter
    from etl_tpu_torch.testing import filter_case

    specs = tuple((i, k, WIDTHS[k], _bw(k, WIDTHS[k]))
                  for i, k in enumerate(kinds))
    pred = compile_row_filter(sql, _kind_schema(kinds))
    rng = np.random.default_rng(seed)
    bm, ln, fl = _pool(lambda n: filter_case(specs, n, rng, nibble), rows)
    args = (*(view(torch.from_numpy(a).cuda()) for a in (bm, ln, fl)),
            specs, nibble, pred)
    before = dict(decode_kernel.path_launches)
    k2 = decode_kernel.filter_pack(*args, walk=walk)
    if walk is not None:
        assert decode_kernel.path_launches[decode_kernel.path_of(walk)] \
            == before[decode_kernel.path_of(walk)] + 1
    k2_want = filter_pack_plain(*args, decode_kernel.FILTER_BLOCK)
    got = decode_kernel.compact_packed(*k2)
    got = (got[0], k2[1], got[1])
    want = parse_and_pack_plain(args[0], args[1], specs, nibble, pred=pred,
                                row_flags=args[2])
    torch.cuda.synchronize()

    def host(ts):
        return [t.view(torch.int32).cpu() for t in ts]

    return host(got), host(want), host(k2), host(k2_want)


@pytest.mark.parametrize("walk", WALKS)
def test_filter_walks_match_plain(cuda, walk):
    kinds, nibble, sql = FILTER_CASES["raw-compound"]
    got, want, k2, k2_want = _filtered(kinds, nibble, sql, 4099, seed=walk,
                                       walk=walk)
    for a, b in zip(got + k2, want + k2_want):
        assert torch.equal(a, b), walk


FKINDS = [K.BOOL, K.I16, K.I32, K.U32, K.I64, K.DATE, K.TIME, K.TIMESTAMP,
          K.TIMESTAMPTZ]
MANY_LEAVES = {
    "30-leaves": " OR ".join(
        [f"c2 = {v}" for v in range(-5, 5)]
        + [f"c1 < {-100 + 7 * i}" for i in range(10)]
        + [f"c4 > {10 ** i}" for i in range(5)]
        + ["c6 < '01:00:00'", "c7 > '2020-01-01 00:00:00'",
           "c5 <> '2000-01-01'", "c3 >= 4000000000", "c0 = FALSE"]),
    "past-the-leaf-bits": " AND ".join(
        f"(c2 > {-1000 * i} OR c1 <> {i} OR c8 < '2024-06-15 00:00:0{i % 10}"
        f"+00')" for i in range(18)),
}


@pytest.mark.parametrize("name", list(MANY_LEAVES))
def test_filter_many_leaves(cuda, name):
    got, want, k2, k2_want = _filtered(FKINDS, False, MANY_LEAVES[name],
                                       6000, seed=7)
    for a, b in zip(got + k2, want + k2_want):
        assert torch.equal(a, b), name
    assert 0 < int(want[2][0]) < 6000


# -- K2c: the fused filter with the compaction folded in ----------------------

def _fused_inputs(kinds, nibble, sql, rows, seed, flags=None):
    from etl_tpu_torch.ops.predicate import compile_row_filter
    from etl_tpu_torch.testing import filter_case

    specs = tuple((i, k, WIDTHS[k], _bw(k, WIDTHS[k]))
                  for i, k in enumerate(kinds))
    pred = compile_row_filter(sql, _kind_schema(kinds))
    rng = np.random.default_rng(seed)
    bm, ln, fl = _pool(lambda n: filter_case(specs, n, rng, nibble), rows)
    if flags is not None:
        fl = np.full_like(fl, flags)
    return (*(torch.from_numpy(a).cuda() for a in (bm, ln, fl)), specs,
            nibble, pred)


def _fused_equal(got, args) -> int:
    """K2c's words[:, :count], mask and count against the plain version
    on the same inputs; returns the count."""
    want = parse_and_pack_plain(args[0], args[1], args[3], args[4],
                                pred=args[5], row_flags=args[2])
    torch.cuda.synchronize()
    n = int(want[2][0])
    assert torch.equal(got[2].cpu(), want[2].cpu())
    assert torch.equal(got[1].view(torch.int32).cpu(),
                       want[1].view(torch.int32).cpu())
    assert torch.equal(got[0].view(torch.int32)[:, :n].cpu(),
                       want[0].view(torch.int32)[:, :n].cpu())
    return n


@pytest.mark.parametrize("name", list(FILTER_CASES))
@pytest.mark.parametrize("rows", [4099, 20000])
def test_fused_matches_plain(cuda, name, rows):
    args = _fused_inputs(*FILTER_CASES[name], rows, seed=rows + len(name))
    n = _fused_equal(decode_kernel.filter_pack_compact(*args), args)
    assert 0 < n < rows


@pytest.mark.parametrize("walk", WALKS)
def test_fused_walks_match_plain(cuda, walk):
    args = _fused_inputs(*FILTER_CASES["raw-compound"], 4099, seed=walk)
    before = dict(decode_kernel.path_launches)
    _fused_equal(decode_kernel.filter_pack_compact(*args, walk=walk), args)
    path = decode_kernel.path_of(walk)
    assert decode_kernel.path_launches[path] == before[path] + 1


@pytest.mark.parametrize("flags,rows", [(0, 65_499), (2, 65_499), (1, 1),
                                        (1, 31), (1, 257)])
def test_fused_keep_none_all_and_ragged(cuda, flags, rows):
    args = _fused_inputs([K.I32, K.I32, K.I32], True, "c1 <= 5", rows,
                         seed=rows + flags, flags=flags)
    n = _fused_equal(decode_kernel.filter_pack_compact(*args), args)
    assert n == {0: 0, 2: rows}.get(flags, n)


def test_fused_many_blocks(cuda):
    """2^22 rows: 16,384 blocks, far more than the card holds at once, so
    most look-backs meet predecessors that are only aggregates."""
    args = _fused_inputs([K.I32, K.I32, K.I32], True, "c1 <= 5", 1 << 22,
                         seed=22)
    n = _fused_equal(decode_kernel.filter_pack_compact(*args), args)
    assert 0 < n < 1 << 22


def test_fused_back_to_back_on_one_status_buffer(cuda):
    """50 launches on one stream without a synchronisation between them:
    grids that grow and shrink, flags that keep none, all or some rows;
    every launch's epoch keeps the statuses of the one before from being
    read as its own."""
    kinds = [K.I32, K.I32, K.I32]
    inputs = [_fused_inputs(kinds, True, "c1 <= 5", rows, seed=k,
                            flags=flags)
              for k, (rows, flags) in enumerate(
                  [(40_000, None), (300, None), (65_536, 2), (1, None),
                   (33_333, 0)])]
    got = [decode_kernel.filter_pack_compact(*inputs[k % len(inputs)])
           for k in range(50)]
    for k, g in enumerate(got):
        _fused_equal(g, inputs[k % len(inputs)])


def test_fused_two_streams_at_once(cuda):
    """Two streams launch K2c at once, each with its own status buffer."""
    kinds = [K.I32, K.I32, K.I32]
    a = _fused_inputs(kinds, True, "c1 <= 5", 1 << 21, seed=1)
    b = _fused_inputs(kinds, True, "c1 <= 3", 1 << 21, seed=2)
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    got = [[], []]
    for _ in range(4):
        for s, args, out in zip(streams, (a, b), got):
            with torch.cuda.stream(s):
                out.append(decode_kernel.filter_pack_compact(*args))
    torch.cuda.synchronize()
    for args, outs in zip((a, b), got):
        for g in outs:
            _fused_equal(g, args)


def test_fused_counters_and_routes(cuda):
    """K2c counts its launches; the engine's route takes K2c where the
    word tile fits and K2 + the epilogue for a layout whose word tile
    does not fit beside a 32-row sub-tile."""
    args = _fused_inputs([K.I32, K.I32, K.I32], True, "c1 <= 5", 5000,
                         seed=4)
    before = (decode_kernel.fused_launches, decode_kernel.filter_launches,
              decode_kernel.compact_launches)
    _fused_equal(decode_kernel.prepare_filtered(*args)(), args)
    wide = _fused_inputs([K.I32] * 260, True, "c1 <= 5", 600, seed=5)
    assert decode_kernel.fused_walk(
        *wide[:3], 260, decode_kernel._device_pred(
            wide[5], wide[3], wide[0].device).numel(),
        decode_kernel.layout_for_specs(wide[3]).n_words) is None
    got = decode_kernel.prepare_filtered(*wide)()
    want = parse_and_pack_plain(wide[0], wide[1], wide[3], True,
                                pred=wide[5], row_flags=wide[2])
    for x, y in zip(got, want):  # the full contract: zeros behind
        assert torch.equal(x.view(torch.int32).cpu(),
                           y.view(torch.int32).cpu())
    assert (decode_kernel.fused_launches, decode_kernel.filter_launches,
            decode_kernel.compact_launches) \
        == (before[0] + 1, before[1] + 1, before[2] + 1)
    with pytest.raises(ValueError, match="word tile"):
        decode_kernel.filter_pack_compact(*wide)


def test_fused_decoder_cuda_matches_cpu(cuda):
    """`DeviceDecoder(fschema, device="cuda")` with K2c on its path (one
    launch a batch, no K2 or epilogue) equals the CPU decoder."""
    from etl_tpu_torch import bench
    from etl_tpu_torch.ops.engine import DeviceDecoder
    from etl_tpu_torch.ops.predicate import parse_row_filter
    from etl_tpu_torch.ops.wal import concat_payloads, stage_wal_batch

    payloads = bench.build_workload(20_000)
    schema = bench.make_schema().with_row_predicate(
        parse_row_filter("bid <= 5"))
    staged = stage_wal_batch(*concat_payloads(payloads), 4).staged
    dec = DeviceDecoder(schema, device="cuda")
    before = (decode_kernel.fused_launches, decode_kernel.filter_launches,
              decode_kernel.compact_launches)
    pending = [dec.decode_async(staged) for _ in range(3)]
    cpu = DeviceDecoder(schema, device="cpu").decode(staged)
    for p in pending:
        assert bench.filtered_batches_identical(p.result(), cpu)
        assert {"launch_ms", "kernel_ms", "d2h_words_ms"} <= set(p.timings)
    assert (decode_kernel.fused_launches, decode_kernel.filter_launches,
            decode_kernel.compact_launches) \
        == (before[0] + 3, before[1], before[2])


def _pgbench_staged(n_rows, seed):
    from etl_tpu_torch import bench
    from etl_tpu_torch.ops.wal import concat_payloads, stage_wal_batch

    t = bench.pgbench_table(n_rows, seed)
    return stage_wal_batch(*concat_payloads(bench.table_payloads(t)),
                           4).staged


def test_two_pipelines_on_two_threads(cuda):
    """Two DecodePipelines, fed from two threads at once, one with
    unfiltered and one with filtered pgbench batches: every result equals
    serial decode() byte for byte, each worker dispatched on a stream of
    its own (not the default stream), and the filtered pipeline's K2c
    launches used that stream's own status buffer."""
    import threading

    from etl_tpu_torch import bench
    from etl_tpu_torch.ops.engine import DeviceDecoder
    from etl_tpu_torch.ops.pipeline import DecodePipeline
    from etl_tpu_torch.ops.predicate import parse_row_filter

    plain = DeviceDecoder(bench.make_schema(), device="cuda")
    filt = DeviceDecoder(bench.make_schema().with_row_predicate(
        parse_row_filter("bid <= 5")), device="cuda")
    jobs = {"plain": (plain, [_pgbench_staged(40_000, s) for s in range(4)]),
            "filt": (filt, [_pgbench_staged(40_000, 10 + s)
                            for s in range(4)])}
    pipes = {k: DecodePipeline(window=2, name=k) for k in jobs}
    results: dict = {}
    errors: list = []
    start = threading.Barrier(2)

    def feed(k):
        try:
            dec, staged = jobs[k]
            start.wait()
            handles = [pipes[k].submit(dec, s) for s in staged]
            results[k] = [(h.result(), h._future.result()[0].stream)
                          for h in handles]
        except BaseException as e:  # reported below
            errors.append(e)

    threads = [threading.Thread(target=feed, args=(k,)) for k in jobs]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    for p in pipes.values():
        p.close()
    assert not errors, errors
    for k, (dec, staged) in jobs.items():
        cpu = DeviceDecoder(dec.schema, device="cpu")
        for s, (got, _) in zip(staged, results[k]):
            want = dec.decode(s)
            assert bench.filtered_batches_identical(got, want) \
                if k == "filt" else bench.batches_equal(got, want)
            assert bench.batch_digest(got) == bench.batch_digest(
                cpu.decode(s))
    streams = {k: {st for _, st in results[k]} for k in results}
    dev = torch.device("cuda", torch.cuda.current_device())
    for k, sts in streams.items():
        assert len(sts) == 1
        (st,) = sts
        assert st == pipes[k].streams[dev]
        assert st.cuda_stream != torch.cuda.default_stream(dev).cuda_stream
    assert streams["plain"] != streams["filt"]
    (fst,) = streams["filt"]
    assert (dev, fst.cuda_stream) in decode_kernel._scan_states


def test_filtered_second_fetch_from_another_thread(cuda):
    """A filtered decode dispatched on one thread's stream and completed
    on another thread: the count-sized second fetch runs on the dispatch
    stream, after the kernel, and returns the right words (the batch
    equals the serial decode and the CPU decoder)."""
    import threading

    from etl_tpu_torch import bench
    from etl_tpu_torch.ops.engine import DeviceDecoder
    from etl_tpu_torch.ops.predicate import parse_row_filter

    schema = bench.make_schema().with_row_predicate(
        parse_row_filter("bid <= 5"))
    dec = DeviceDecoder(schema, device="cuda")
    staged = [_pgbench_staged(65_536, 20 + s) for s in range(3)]
    side = torch.cuda.Stream()
    pending = []

    def dispatch():
        with torch.cuda.stream(side):
            for s in staged:
                pending.append(dec.decode_async(s))

    t = threading.Thread(target=dispatch)
    t.start()
    t.join(60)
    assert len(pending) == 3
    # this thread's current stream is the default stream, not `side`
    assert torch.cuda.current_stream().cuda_stream != side.cuda_stream
    cpu = DeviceDecoder(schema, device="cpu")
    for p, s in zip(reversed(pending), reversed(staged)):
        assert p.stream == side
        got = p.result()
        assert "d2h_words_ms" in p.timings
        assert bench.filtered_batches_identical(got, cpu.decode(s))
        assert bench.filtered_batches_identical(got, dec.decode(s))


# -- the egress render kernel (csrc/egress_render.cu) --------------------------

EGRESS_WIDTHS = {K.BOOL: 4, K.I16: 8, K.I32: 12, K.U32: 12, K.I64: 20,
                 K.DATE: 16, K.TIMESTAMP: 32, K.TIMESTAMPTZ: 32}
PGBENCH_SPECS = ((0, K.I32, 8, 6), (1, K.I32, 4, 2), (2, K.I32, 12, 10))


@pytest.fixture
def egress_cuda(cuda):
    from etl_tpu_torch.ops import egress_kernel

    egress_kernel.load()
    return cuda


def _egress_specs():
    kinds = list(EGRESS_WIDTHS.items()) * 2
    return tuple((i, k, w, (min(w, saturation_width(k)) + 1) & ~1)
                 for i, (k, w) in enumerate(kinds))


def _render_both(specs, encoder, rows, seed, nibble=False, pool=4096):
    from etl_tpu_torch.ops import egress, egress_kernel
    from etl_tpu_torch.testing import egress_words

    words = egress_words(specs, min(rows, pool),
                         np.random.default_rng(seed), nibble)
    words = words.view(torch.int32).repeat(1, -(-rows // pool))[:, :rows]
    words_d = words.contiguous().cuda()
    plan = egress.plan_for_specs(specs, encoder)
    got = egress_kernel.render(words_d, specs, plan)
    want = egress.render_plain(words_d, specs, plan)
    torch.cuda.synchronize()
    return [g.cpu() for g in got], [w.cpu() for w in want]


@pytest.mark.parametrize("encoder", ["tsv", "json"])
@pytest.mark.parametrize("rows", [1, 31, 257, 65_499])
def test_egress_render_matches_plain(egress_cuda, encoder, rows):
    """Every kind the encoder renders, raw, on seeded adversarial words,
    at ragged row counts: both outputs bit for bit on every row."""
    got, want = _render_both(_egress_specs(), encoder, rows,
                             seed=rows + len(encoder))
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_egress_render_2_22_rows(egress_cuda):
    """The main path's layout (three INT4 columns, nibble) at 2^22 rows."""
    got, want = _render_both(PGBENCH_SPECS, "tsv", 1 << 22, seed=3,
                             nibble=True, pool=16_384)
    assert got[0].shape == (1 << 22, 33)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_egress_render_two_streams_at_once(egress_cuda):
    """Renders on two streams at once, each of its own words, are each
    their plain version's."""
    from etl_tpu_torch.ops import egress, egress_kernel
    from etl_tpu_torch.testing import egress_words

    specs = _egress_specs()
    plan = egress.plan_for_specs(specs, "tsv")
    words = [egress_words(specs, 4096, np.random.default_rng(s))
             .view(torch.int32).repeat(1, 64).cuda() for s in (1, 2)]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    got = [[], []]
    for _ in range(3):
        for st, w, out in zip(streams, words, got):
            with torch.cuda.stream(st):
                out.append(egress_kernel.render(w, specs, plan))
    torch.cuda.synchronize()
    for w, outs in zip(words, got):
        want = egress.render_plain(w, specs, plan)
        for g in outs:
            assert all(torch.equal(a, b) for a, b in zip(g, want))


def test_egress_launch_counter_and_cpu_route(egress_cuda):
    from etl_tpu_torch.ops import egress, egress_kernel
    from etl_tpu_torch.testing import egress_words

    plan = egress.plan_for_specs(PGBENCH_SPECS, "tsv")
    words = egress_words(PGBENCH_SPECS, 64, np.random.default_rng(0), True)
    before = egress_kernel.launches
    egress_kernel.render(words, PGBENCH_SPECS, plan)
    assert egress_kernel.launches == before  # CPU tensor: plain version
    egress_kernel.render(words.cuda(), PGBENCH_SPECS, plan)
    assert egress_kernel.launches == before + 1


def test_egress_decoder_cuda_matches_cpu(egress_cuda):
    """`DeviceDecoder(..., device="cuda", egress="tsv")` launches the
    render once a batch after K1; the attached text equals the CPU
    decoder's, and the timings hold the render and its fetch."""
    from etl_tpu_torch import bench
    from etl_tpu_torch.ops import egress_kernel
    from etl_tpu_torch.ops.engine import DeviceDecoder
    from etl_tpu_torch.ops.wal import concat_payloads, stage_wal_batch

    staged = stage_wal_batch(*concat_payloads(bench.build_workload(20_000)),
                             4).staged
    dec = DeviceDecoder(bench.make_schema(), device="cuda", egress="tsv")
    before = (decode_kernel.launches, egress_kernel.launches)
    pending = [dec.decode_async(staged) for _ in range(3)]
    cpu = DeviceDecoder(bench.make_schema(), device="cpu",
                        egress="tsv").decode(staged)
    for p in pending:
        b = p.result()
        assert bench.batches_equal(b, cpu)
        assert set(b.device_egress.fields) == set(cpu.device_egress.fields)
        for j, (buf, lens) in cpu.device_egress.fields.items():
            gb, gl = b.device_egress.fields[j]
            assert np.array_equal(gb, buf) and np.array_equal(gl, lens)
        assert {"egress_ms", "d2h_egress_ms", "kernel_ms"} <= set(p.timings)
    assert (decode_kernel.launches, egress_kernel.launches) \
        == (before[0] + 3, before[1] + 3)


def test_egress_launch_failure_fails_the_batch(egress_cuda, monkeypatch):
    """No fallback: a render launch the card refuses fails its batch; it
    does not ship without device text."""
    from etl_tpu_torch import bench
    from etl_tpu_torch.ops import egress_kernel
    from etl_tpu_torch.ops.engine import DeviceDecoder
    from etl_tpu_torch.ops.wal import concat_payloads, stage_wal_batch

    class Refusing:
        def __init__(self, lib):
            self._lib = lib

        def etl_egress_render(self, *args):
            return 1  # cudaErrorInvalidValue

        def __getattr__(self, name):
            return getattr(self._lib, name)

    staged = stage_wal_batch(*concat_payloads(bench.build_workload(1000)),
                             4).staged
    dec = DeviceDecoder(bench.make_schema(), device="cuda", egress="tsv")
    monkeypatch.setattr(egress_kernel, "_lib",
                        Refusing(egress_kernel.load()))
    with pytest.raises(RuntimeError, match="egress render launch failed"):
        dec.decode(staged)


def test_egress_clickhouse_write_over_http(egress_cuda):
    """A batch the card rendered, written through `ClickHouseDestination`
    into `RecordingHttpServer`: one INSERT whose TSV body equals the host
    encoder's on the same batch and the body of the CPU decoder's batch,
    the write counted as device-rendered, the render launched once."""
    import asyncio

    from etl_tpu_torch import bench
    from etl_tpu_torch.destinations.clickhouse import (
        ClickHouseConfig, ClickHouseDestination, render_batch_tsv_columnar)
    from etl_tpu_torch.models import DecodedBatchEvent, Lsn
    from etl_tpu_torch.ops import egress_kernel
    from etl_tpu_torch.ops.engine import DeviceDecoder
    from etl_tpu_torch.ops.wal import concat_payloads, stage_wal_batch
    from etl_tpu_torch.telemetry.metrics import (ETL_EGRESS_WRITES_TOTAL,
                                                 registry)
    from etl_tpu_torch.testing.fake_http import RecordingHttpServer

    schema = bench.make_schema()
    staged = stage_wal_batch(*concat_payloads(bench.build_workload(5000)),
                             4).staged
    before = egress_kernel.launches
    batch = DeviceDecoder(schema, device="cuda", egress="tsv").decode(staged)
    assert egress_kernel.launches == before + 1
    assert batch.device_egress is not None
    cpu = DeviceDecoder(schema, device="cpu", egress="tsv").decode(staged)

    def event(b):
        n = b.num_rows
        return DecodedBatchEvent(
            Lsn(0x10), Lsn(0x10 + n), schema,
            change_types=np.zeros(n, dtype=np.int8),
            commit_lsns=np.full(n, 0x4000, dtype=np.uint64),
            tx_ordinals=np.arange(n, dtype=np.uint64), batch=b)

    async def write(b) -> bytes:
        server = RecordingHttpServer()
        await server.start()
        try:
            d = ClickHouseDestination(ClickHouseConfig(url=server.url(),
                                                       database="etl"))
            await d.startup()
            await d.write_event_batches([event(b)])
            await d.shutdown()
            bodies = [r.body for r in server.requests
                      if r.query.get("query", "").startswith("INSERT INTO")]
            assert len(bodies) == 1
            return bodies[0]
        finally:
            await server.stop()

    device_writes = registry.get_counter(ETL_EGRESS_WRITES_TOTAL,
                                         {"path": "device"})
    got = asyncio.run(write(batch))
    assert registry.get_counter(ETL_EGRESS_WRITES_TOTAL,
                                {"path": "device"}) == device_writes + 1
    n = batch.num_rows
    seqs = [f"{0x4000:016x}/{i:016x}/{0:016x}" for i in range(n)]
    assert got == render_batch_tsv_columnar(schema, batch, "UPSERT", seqs)
    assert got == asyncio.run(write(cpu))


@pytest.mark.parametrize("n_cols", [100, 260])
def test_very_wide_tables(cuda, n_cols):
    """100 and 260 dense columns through the kernel wrapper: the walk and
    descriptor sizes a wide table takes, bit for bit."""
    kinds = [K.I32, K.I64, K.DATE, K.TIMESTAMPTZ, K.BOOL]
    specs = tuple((i, kinds[i % 5], WIDTHS[kinds[i % 5]],
                   (min(WIDTHS[kinds[i % 5]],
                        saturation_width(kinds[i % 5])) + 1) & ~1)
                  for i in range(n_cols))
    got, want = _both(specs, False, 700, seed=n_cols)
    assert torch.equal(got, want)


@pytest.mark.parametrize("route", ["k2c", "k2+epilogue"])
def test_copy_escapes_fix_up_at_compacted_indices(cuda, route, monkeypatch):
    """COPY rows with escapes are force-kept by the fused filter and fixed
    up at their compacted positions, on K2c and on the two-launch route:
    the card's batch and source_rows equal the CPU decoder's."""
    from etl_tpu_torch import convert
    from etl_tpu_torch.ops.engine import DeviceDecoder
    from etl_tpu_torch.ops.predicate import parse_row_filter
    from etl_tpu_torch.ops.staging import stage_copy_chunk

    rng = np.random.default_rng(9)
    vals = rng.integers(-1000, 1000, size=3000)
    lines = [f"{i}\t{v}\t" + (f"a\\tb{i}" if i % 7 == 0 else f"plain{i}")
             for i, v in enumerate(vals)]
    chunk = ("\n".join(lines) + "\n").encode()
    schema = convert.schema_from_plain(
        1, "public", "t", [("c0", 20, -1, False, 1), ("c1", 23, -1, True,
                                                      None),
                           ("c2", 25, -1, True, None)],
        [True] * 3, [True, False, False]).with_row_predicate(
            parse_row_filter("c1 < 0"))
    if route != "k2c":
        monkeypatch.setattr(decode_kernel, "fused_walk",
                            lambda *a, **k: None)
    before = (decode_kernel.fused_launches, decode_kernel.filter_launches)
    got = DeviceDecoder(schema, device="cuda",
                        device_min_rows=0).decode(stage_copy_chunk(chunk, 3))
    want = DeviceDecoder(schema, device="cpu",
                         device_min_rows=0).decode(stage_copy_chunk(chunk, 3))
    after = (decode_kernel.fused_launches, decode_kernel.filter_launches)
    assert after[0 if route == "k2c" else 1] \
        == before[0 if route == "k2c" else 1] + 1
    assert list(got.source_rows) == list(np.flatnonzero(vals < 0))
    assert list(want.source_rows) == list(got.source_rows)
    for pos, src in enumerate(got.source_rows):
        assert got.columns[2].value(pos) == (
            f"a\tb{src}" if src % 7 == 0 else f"plain{src}")
        assert [c.value(pos) for c in got.columns] \
            == [c.value(pos) for c in want.columns]
