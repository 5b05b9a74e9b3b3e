"""The CUDA kernel's own parse-and-pack code, compiled as host C++, against
the plain PyTorch version, bit for bit.

`csrc/decode_pack.cu` builds without nvcc as C++ (its device qualifiers
vanish off `__CUDACC__`) and exports `etl_decode_pack_host`,
`etl_filter_pack_host` and `etl_filter_pack_compact_host`, which walk
each block's rows as the card does: stage the block's byte range into a
tile laid out as in shared memory (256 rows, or sub-tiles of 128 or 64
rows, or none: direct) and run the kernel's row body on it. The fused
kernel (K2c) runs in the card's phases with the blocks' progress
interleaved in a seeded order, so its look-back meets predecessors that
are only aggregates and status words of an earlier launch. This checks
the kernels' logic on every kind and every walk here on the CPU;
tests/test_torch_kernels_gpu.py checks the compiled kernels on the card.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_kernel_host.py -q
"""

import ctypes
import os
import subprocess

import numpy as np
import pytest
import torch

from etl_tpu_torch.models.pgtypes import CellKind as K
from etl_tpu_torch.ops import decode_kernel
from etl_tpu_torch.ops.bitpack import (layout_for_specs, parse_and_pack_plain,
                                       saturation_width)
from etl_tpu_torch.testing import field_matrix

WIDTHS = {K.BOOL: 4, K.I16: 8, K.I32: 12, K.U32: 12, K.I64: 20, K.F32: 16,
          K.F64: 24, K.DATE: 16, K.TIME: 16, K.TIMESTAMP: 32,
          K.TIMESTAMPTZ: 32}
NIBBLE = (K.I16, K.I32, K.U32, K.I64, K.DATE, K.TIME, K.TIMESTAMP,
          K.TIMESTAMPTZ)
CASES = [(k, False) for k in WIDTHS] + [(k, True) for k in NIBBLE]


def _build_decode_lib(src, out_dir):
    so = out_dir / "decode_pack_host.so"
    subprocess.run([os.environ.get("CXX", "c++"), "-O2", "-std=c++17",
                    "-shared", "-fPIC", "-x", "c++", str(src), "-o", str(so)],
                   check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(so))
    fn = lib.etl_decode_pack_host
    fn.restype = None
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int]

    def run(bmat, lengths, specs, nibble, tile_rows=256, rpt=None):
        """K1 in tiles of `tile_rows` rows (0: direct), `rpt` rows a
        thread (the wrapper's choice when None)."""
        desc = np.array(decode_kernel.descriptor(specs, nibble), np.int32)
        n_words = layout_for_specs(specs).n_words
        out = np.full((n_words, bmat.shape[0]), 0xDEADBEEF, dtype=np.uint32)
        if rpt is None:
            rpt = decode_kernel.rows_per_thread(specs, nibble, tile_rows)
        fn(bmat.ctypes.data, bmat.shape[1], lengths.ctypes.data,
           int(lengths.dtype == np.uint8), len(specs), desc.ctypes.data,
           int(nibble), out.ctypes.data, bmat.shape[0], n_words, tile_rows,
           rpt)
        return out

    run.lib = lib
    return run


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    return _build_decode_lib(decode_kernel.SOURCE,
                             tmp_path_factory.mktemp("decode_pack"))


def _rows(make, rows, pool=4096):
    """`make(n)`'s arrays for min(rows, pool) rows, tiled to `rows` (large
    row counts stay cheap to generate)."""
    parts = make(min(rows, pool))
    reps = -(-rows // pool)
    return tuple(np.ascontiguousarray(np.tile(a, (reps,) + (1,) * (a.ndim - 1))
                                      [:rows]) for a in parts)


def _check(run, specs, nibble, rows, seed, lengths_dtype=np.uint8,
           tile_rows=256, rpt=None):
    rng = np.random.default_rng(seed)
    bm, ln = _rows(lambda n: field_matrix(specs, n, rng, nibble,
                                          lengths_dtype), rows)
    want = parse_and_pack_plain(torch.from_numpy(bm), torch.from_numpy(ln),
                                specs, nibble).numpy()
    got = run(bm, ln, specs, nibble, tile_rows, rpt)
    bad = np.flatnonzero((got != want).any(axis=0))
    assert bad.size == 0, (specs, nibble, bad[:5],
                           [bytes(bm[i]) for i in bad[:3]])


def _bw(kind, w):
    return (min(w, saturation_width(kind)) + 1) & ~1


@pytest.mark.parametrize("kind,nibble", CASES, ids=[
    f"{k.name}-{'nibble' if n else 'raw'}" for k, n in CASES])
def test_host_kernel_matches_plain(host_kernel, kind, nibble):
    for extra in (0, 8):
        w = WIDTHS[kind] + extra
        _check(host_kernel, ((0, kind, w, _bw(kind, w)),), nibble, 1500,
               seed=100 * kind.value + w + int(nibble))


def test_host_kernel_int32_lengths_all_kinds(host_kernel):
    specs = tuple((i, k, w, _bw(k, w)) for i, (k, w) in enumerate(WIDTHS.items()))
    _check(host_kernel, specs, False, 1500, seed=11, lengths_dtype=np.int32)


def test_host_kernel_many_words(host_kernel):
    specs = tuple((i, K.I64 if i % 2 else K.TIMESTAMPTZ, 20 if i % 2 else 32,
                   18 if i % 2 else 2) for i in range(30))
    _check(host_kernel, specs, True, 500, seed=12)


# -- the fused row filter (K2) and the compaction epilogue --------------------

def _build_filter_lib(src, out_dir):
    so = out_dir / "decode_pack_filter_host.so"
    subprocess.run([os.environ.get("CXX", "c++"), "-O2", "-std=c++17",
                    "-shared", "-fPIC", "-x", "c++", str(src), "-o", str(so)],
                   check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(so))
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.etl_filter_pack_host.restype = None
    lib.etl_filter_pack_host.argtypes = [vp, i64, vp, i32, i32, vp, i32, vp,
                                         vp, i32, vp, vp, vp, i64, i32, i32]
    lib.etl_compact_packed_host.restype = None
    lib.etl_compact_packed_host.argtypes = [vp, vp, vp, vp, vp, i64, i32]

    def run(bmat, lengths, flags, specs, nibble, pred, tile_rows=256):
        """K2 then the epilogue → (K2's words, mask, block counts,
        compacted words, counts)."""
        desc = np.array(decode_kernel.descriptor(specs, nibble), np.int32)
        pdesc = np.array(decode_kernel.pred_descriptor(pred, specs),
                         np.int32)
        R = bmat.shape[0]
        n_words = layout_for_specs(specs).n_words
        words = np.full((n_words, R), 0xDEADBEEF, dtype=np.uint32)
        mask = np.full(-(-R // 32), 0xA5A5A5A5, dtype=np.uint32)
        blocks = np.full(-(-R // decode_kernel.FILTER_BLOCK), -7, np.int32)
        lib.etl_filter_pack_host(
            bmat.ctypes.data, bmat.shape[1], lengths.ctypes.data,
            int(lengths.dtype == np.uint8), len(specs), desc.ctypes.data,
            int(nibble), flags.ctypes.data, pdesc.ctypes.data, pdesc.size,
            words.ctypes.data, mask.ctypes.data, blocks.ctypes.data, R,
            n_words, tile_rows)
        out = np.full((n_words, R), 0xDEADBEEF, dtype=np.uint32)
        counts = np.full(1, -7, dtype=np.int32)
        lib.etl_compact_packed_host(words.ctypes.data, mask.ctypes.data,
                                    blocks.ctypes.data, out.ctypes.data,
                                    counts.ctypes.data, R, n_words)
        return words, mask, blocks, out, counts

    return run


@pytest.fixture(scope="module")
def host_filter(tmp_path_factory):
    return _build_filter_lib(decode_kernel.SOURCE,
                             tmp_path_factory.mktemp("filter"))


FKINDS = [K.BOOL, K.I16, K.I32, K.U32, K.I64, K.DATE, K.TIME, K.TIMESTAMP,
          K.TIMESTAMPTZ]
FOIDS = {K.BOOL: 16, K.I16: 21, K.I32: 23, K.U32: 26, K.I64: 20,
         K.DATE: 1082, K.TIME: 1083, K.TIMESTAMP: 1114, K.TIMESTAMPTZ: 1184}
LITERAL = {K.BOOL: "TRUE", K.I16: "100", K.I32: "-5000000",
           K.U32: "3000000000", K.I64: "-999999999", K.DATE: "'2000-01-01'",
           K.TIME: "'12:00:00'", K.TIMESTAMP: "'2000-01-01 00:00:00'",
           K.TIMESTAMPTZ: "'2024-06-15 00:00:00+00'"}
FILTERS = [f"c{i} {op} {LITERAL[k]}" for i, k in enumerate(FKINDS)
           for op in ("=", "<>", "<", "<=", ">", ">=")] + [
    "((c0 = TRUE OR c1 < 100) AND (c2 >= -5000000 OR c3 > 3000000000) "
    "AND NOT (c4 = -0 OR c5 IS NULL)) OR (c6 < '12:00:00' AND "
    "c7 > '2000-01-01 00:00:00') OR c8 <= '2024-06-15 00:00:00+00'",
    "c3 < -1 OR c2 > 10000000000000 OR c4 < 10000000000000000000000000000 "
    "AND c7 < 'infinity'",
    "NOT (c8 IS NULL OR c4 IS NOT NULL) OR NOT NOT c1 <> 99999",
]


def _filter_check(run, sql, nibble, rows, seed, tile_rows=256):
    from etl_tpu_torch import convert
    from etl_tpu_torch.ops.bitpack import filter_pack_plain
    from etl_tpu_torch.ops.predicate import compile_row_filter
    from etl_tpu_torch.testing import filter_case

    kinds = FKINDS[1:] if nibble else FKINDS
    offset = 1 if nibble else 0
    schema = convert.schema_from_plain(
        1, "public", "t",
        [(f"c{i + offset}", FOIDS[k], -1, True, None)
         for i, k in enumerate(kinds)], [True] * len(kinds),
        [True] * len(kinds))
    pred = compile_row_filter(sql, schema)
    specs = tuple((i, k, WIDTHS[k], _bw(k, WIDTHS[k]))
                  for i, k in enumerate(kinds))
    rng = np.random.default_rng(seed)
    bm, ln, fl = _rows(lambda n: filter_case(specs, n, rng, nibble), rows)
    t = (torch.from_numpy(bm), torch.from_numpy(ln), torch.from_numpy(fl))
    want = parse_and_pack_plain(t[0], t[1], specs, nibble, pred=pred,
                                row_flags=t[2])
    k2_want = filter_pack_plain(*t, specs, nibble, pred,
                                decode_kernel.FILTER_BLOCK)
    words, mask, blocks, out, counts = run(bm, ln, fl, specs, nibble, pred,
                                           tile_rows)
    return ((words, mask, blocks), [w.numpy().view(np.uint32)
                                    for w in k2_want[:2]]
            + [k2_want[2].numpy()], (out, mask, counts),
            [w.numpy().view(np.uint32) for w in want[:2]]
            + [want[2].numpy()])


def _assert_same(got, want):
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert np.array_equal(g, w), np.flatnonzero((g != w).reshape(-1))[:8]


@pytest.mark.parametrize("i", range(len(FILTERS)))
def test_host_filter_kernels_match_plain(host_filter, i):
    """K2 (filter, words × keep, ballot mask, block counts) and the
    epilogue, compiled as host C++, against the plain versions, raw."""
    k2, k2_want, full, full_want = _filter_check(
        host_filter, FILTERS[i], False, 1000 + 37 * i, seed=i)
    _assert_same(k2, k2_want)
    _assert_same(full, full_want)


@pytest.mark.parametrize("rows", [1, 31, 256, 257, 3001])
def test_host_filter_kernels_nibble_and_ragged(host_filter, rows):
    sql = ("(c1 >= 100 AND c2 <> -2147483648) OR c3 <= 2147483648 OR "
           "c4 IS NULL OR c8 > '2024-06-15 00:00:00+00'")
    k2, k2_want, full, full_want = _filter_check(host_filter, sql, True,
                                                 rows, seed=rows)
    _assert_same(k2, k2_want)
    _assert_same(full, full_want)


@pytest.mark.parametrize("mutation", [
    # an operator flipped in the comparison of a leaf
    ("return cmp == CMP_EQ ? v == lit : (cmp == CMP_LT ? v < lit : v > lit);",
     "return cmp == CMP_EQ ? v == lit : (cmp == CMP_LT ? v <= lit : v > lit);"),
    # an off-by-one in the prefix of block counts (one block short, so
    # every write stays inside the output)
    ("if (i < b) p += c;", "if (i + 1 < b) p += c;"),
], ids=["flipped-op", "prefix-off-by-one"])
def test_host_filter_mutation_is_caught(tmp_path, mutation):
    """The comparison above fails on a deliberately broken copy of the
    source: the host test reaches the evaluator and the epilogue."""
    old, new = mutation
    src = decode_kernel.SOURCE.read_text()
    assert src.count(old) == 1
    broken = tmp_path / "decode_pack_broken.cu"
    broken.write_text(src.replace(old, new))
    run = _build_filter_lib(broken, tmp_path)
    k2, k2_want, full, full_want = _filter_check(
        run, "c2 < -5000000 OR c1 < 100", False, 1000, seed=5)
    assert not all(np.array_equal(g, w) for g, w in
                   zip(k2 + full, k2_want + full_want))


# -- the block walks: 256-row tiles, sub-tiles, direct -----------------------

WALKS = [256, 128, 64, 32, 0]  # tile rows; 0 = direct, from global memory
ALL_RAW = tuple((i, k, w, _bw(k, w))
                for i, (k, w) in enumerate(WIDTHS.items()))
NIB_SPECS = tuple((i, k, WIDTHS[k], _bw(k, WIDTHS[k]))
                  for i, k in enumerate(NIBBLE))


@pytest.mark.parametrize("walk", WALKS)
@pytest.mark.parametrize("layout", ["raw-int32-lengths", "nibble-u8",
                                    "nibble-ints-2-rows"])
def test_host_walks_match_plain(host_kernel, walk, layout):
    """K1 walked in tiles of every size and direct, one row a thread and
    (integer layouts) two: 700 rows, so the last block is ragged and a
    sub-tile walk stops early."""
    if layout == "nibble-u8":
        _check(host_kernel, NIB_SPECS, True, 700, seed=21, tile_rows=walk)
    elif layout == "nibble-ints-2-rows":
        specs = NIB_SPECS[:3] + ((3, K.I64, 16, 18), (4, K.I32, 4, 4))
        assert decode_kernel.rows_per_thread(specs, True, 256) == 2
        _check(host_kernel, specs, True, 700, seed=23,
               tile_rows=walk if walk != 32 else 64, rpt=2)
    else:
        _check(host_kernel, ALL_RAW, False, 700, seed=22,
               lengths_dtype=np.int32, tile_rows=walk)


ROW_BYTES_CASES = {
    # row bytes: (specs, nibble)
    11: (((0, K.I32, 11, 10),), False),
    12: (tuple((i, K.I32, 8, 8) for i in range(3)), True),  # pgbench
    6: (((0, K.I32, 12, 10),), True),
    40: (((0, K.I64, 20, 18), (1, K.I64, 20, 18)), False),  # padded stride
    228: (ALL_RAW + ((11, K.TIMESTAMPTZ, 36, 2),), False),
}


@pytest.mark.parametrize("walk", [256, 32])
@pytest.mark.parametrize("row_bytes", list(ROW_BYTES_CASES))
def test_host_row_bytes_not_multiple_of_16(host_kernel, row_bytes, walk):
    specs, nibble = ROW_BYTES_CASES[row_bytes]
    assert sum(w for _, _, w, _ in specs) // (2 if nibble else 1) \
        == row_bytes
    _check(host_kernel, specs, nibble, 777, seed=row_bytes + walk,
           tile_rows=walk, rpt=1)


@pytest.mark.parametrize("rows", [1, 31, 257, 65_499])
def test_host_row_counts(host_kernel, host_filter, rows):
    """K1 and K2 at the pgbench shape, at row counts that end inside a
    warp, right after a block, and inside a late block."""
    _check(host_kernel, ROW_BYTES_CASES[12][0], True, rows, seed=rows)
    k2, k2_want, full, full_want = _filter_check(
        host_filter, "c1 <= 5 OR c3 IS NULL", True, rows, seed=rows)
    _assert_same(k2, k2_want)
    _assert_same(full, full_want)


def _aligned(a):
    return torch.from_numpy(a).clone()  # a fresh, 64-byte aligned tensor


WIDE_CASES = {
    # name: (specs, nibble, the planner's tile rows)
    "11-raw-kinds": (ALL_RAW, False, 256),  # a tile above 48 KB
    "100-i32-nibble": (tuple((i, K.I32, 12, 10) for i in range(100)), True,
                       128),
    "260-i32-nibble": (tuple((i, K.I32, 12, 10) for i in range(260)), True,
                       32),
    # not even one warp's 32 rows fit: direct
    "260-i32-int32-lengths": (tuple((i, K.I32, 20, 10) for i in range(260)),
                              True, 0),
}


@pytest.mark.parametrize("name", list(WIDE_CASES))
def test_host_wide_rows_take_the_planned_walk(host_kernel, name):
    """Rows too wide for a 256-row tile in the default 48 KB: the
    wrapper's planner picks the walk, and that walk is bit for bit the
    plain version."""
    specs, nibble, want_rows = WIDE_CASES[name]
    lengths_dtype = np.int32 if "int32" in name else np.uint8
    bm, ln = field_matrix(specs, 300, np.random.default_rng(31), nibble,
                          lengths_dtype)
    rows = decode_kernel.tile_rows(_aligned(bm), _aligned(ln), None,
                                   len(specs), 0)
    assert rows == want_rows
    assert decode_kernel.tile_bytes(256, bm.shape[1], len(specs),
                                    lengths_dtype == np.uint8, 0,
                                    False) > 48 * 1024
    _check(host_kernel, specs, nibble, 300, seed=31,
           lengths_dtype=lengths_dtype, tile_rows=rows)


def test_planner_choices():
    specs = ROW_BYTES_CASES[12][0]
    bm, ln = field_matrix(specs, 64, np.random.default_rng(1), True)
    bm_t, ln_t = _aligned(bm), _aligned(ln)
    assert decode_kernel.tile_rows(bm_t, ln_t, None, 3, 0) == 256
    fl = torch.ones(65, dtype=torch.uint8)
    assert decode_kernel.tile_rows(bm_t, ln_t, fl[:64], 3, 40) == 256
    # a base pointer off 16-byte alignment reads from global memory
    assert decode_kernel.tile_rows(bm_t, ln_t, fl[1:], 3, 40) == 0
    assert decode_kernel.tile_rows(_aligned(np.zeros((65, 12), np.uint8))[1:],
                                   ln_t, None, 3, 0) == 0
    # a row too wide for even one warp's tile
    huge = torch.zeros((32, 8000), dtype=torch.uint8)
    assert decode_kernel.tile_rows(huge, torch.zeros((32, 300),
                                                     dtype=torch.int32),
                                   None, 300, 0) == 0
    assert [decode_kernel.path_of(r) for r in (256, 64, 0)] \
        == ["tile", "subtile", "direct"]


@pytest.mark.parametrize("filtered", [False, True])
def test_tile_bytes_matches_the_source(host_kernel, filtered):
    """K1's and K2's tiles, and with `filtered` also K2c's (the word tile
    of 2 or 90 words a row beside them, or alone: direct)."""
    fn = host_kernel.lib.etl_tile_bytes
    fn.restype = ctypes.c_int64
    fn.argtypes = [ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int]
    for row_bytes in (1, 6, 11, 12, 16, 40, 228, 1560):
        for n_cols, u8, pred_ints, rows in ((1, 1, 29, 256), (3, 0, 40, 64),
                                            (260, 1, 300, 128),
                                            (3, 1, 41, 0)):
            for words in (0, 2, 90) if filtered else (0,):
                assert fn(row_bytes, n_cols, u8, int(filtered), pred_ints,
                          rows, words) == decode_kernel.tile_bytes(
                    rows, row_bytes, n_cols, bool(u8), pred_ints, filtered,
                    words)


@pytest.mark.parametrize("walk", WALKS)
def test_host_filter_walks(host_filter, walk):
    """K2 in every walk, raw, under a compound filter, at a row count that
    leaves the last block ragged."""
    k2, k2_want, full, full_want = _filter_check(
        host_filter, FILTERS[len(FILTERS) - 3], False, 1111, seed=walk,
        tile_rows=walk)
    _assert_same(k2, k2_want)
    _assert_same(full, full_want)


# 30 comparison leaves; and 18 groups of 4 instructions (3 leaves + OR) plus
# one AND: 73 instructions, past the 64 leaf bits, 21 deep
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


@pytest.mark.parametrize("walk", [256, 0])
@pytest.mark.parametrize("name", list(MANY_LEAVES))
def test_host_filter_many_leaves(host_filter, name, walk):
    from etl_tpu_torch import convert
    from etl_tpu_torch.ops.predicate import compile_row_filter

    sql = MANY_LEAVES[name]
    pred = compile_row_filter(sql, convert.schema_from_plain(
        1, "public", "t", [(f"c{i}", FOIDS[k], -1, True, None)
                           for i, k in enumerate(FKINDS)],
        [True] * len(FKINDS), [True] * len(FKINDS)))
    assert pred.kernel_supported
    n_leaves = sum(ins[0] == 0 for ins in pred.program)
    if name == "30-leaves":
        assert n_leaves == 30
    else:
        assert len(pred.program) > 64
    k2, k2_want, full, full_want = _filter_check(host_filter, sql, False,
                                                 1500, seed=7, tile_rows=walk)
    _assert_same(k2, k2_want)
    _assert_same(full, full_want)
    assert 0 < int(full_want[2][0]) < 1500


@pytest.mark.parametrize("mutation", [
    # the tile row a thread parses, one row off
    ("return {smem + lr * tile_stride(a.row_bytes),",
     "return {smem + (lr + 1) * tile_stride(a.row_bytes),"),
    # the padded tile stride applied on the reading side only
    ("if (tile_stride(a.row_bytes) != a.row_bytes)",
     "if (tile_stride(a.row_bytes) != a.row_bytes + 4)"),
    # a leaf's true bit read from the next instruction's place
    ("t = (lt >> i) & 1u;", "t = (lt >> (i + 1)) & 1u;"),
], ids=["tile-row-off-by-one", "stride-mismatch", "leaf-bit-shifted"])
def test_host_walk_mutation_is_caught(tmp_path, mutation):
    """The walk and single-parse checks above fail on a deliberately broken
    copy of the source."""
    old, new = mutation
    src = decode_kernel.SOURCE.read_text()
    assert src.count(old) == 1
    broken = tmp_path / "decode_pack_broken.cu"
    broken.write_text(src.replace(old, new))
    k1 = _build_decode_lib(broken, tmp_path)
    k2 = _build_filter_lib(broken, tmp_path)
    specs, nibble = ROW_BYTES_CASES[40]
    rng = np.random.default_rng(3)
    bm, ln = field_matrix(specs, 600, rng, nibble)
    want = parse_and_pack_plain(torch.from_numpy(bm), torch.from_numpy(ln),
                                specs, nibble).numpy()
    k1_same = np.array_equal(k1(bm, ln, specs, nibble, 256, 1), want)
    got = _filter_check(k2, "c2 < -5000000 OR c1 < 100", False, 1000,
                        seed=5)
    k2_same = all(np.array_equal(g, w) for g, w in
                  zip(got[0] + got[2], got[1] + got[3]))
    assert not (k1_same and k2_same)


@pytest.mark.parametrize("width", [2, 4, 6, 8, 10, 12, 14, 16])
def test_host_nibble_ints_register_parse(host_kernel, width):
    """Nibble integers of W <= 16 symbols take the loop-free parse in a
    tile and the symbol loop direct: both equal the plain version for
    every width, for fields at every byte alignment in the row and for
    lengths past the width (all three I64 limbs kept)."""
    specs = tuple((i, K.I64 if i % 2 else K.I32, width, 18)
                  for i in range(3))
    for walk in (256, 0):
        _check(host_kernel, specs, True, 900, seed=width + walk,
               tile_rows=walk)


# -- K2c: the fused filter with the compaction folded in ----------------------

SENTINEL = 0xC0FFEE11


class HostScan:
    """A K2c look-back buffer kept across launches, as the wrapper keeps
    one per stream: the ticket counter then one status word per block,
    with the tickets the launches took and the last launch's epoch."""

    def __init__(self, blocks):
        self.buf = np.zeros(1 + blocks, dtype=np.uint64)
        self.tickets = 0
        self.epoch = 0


def _build_fused_lib(src, out_dir):
    so = out_dir / "decode_pack_fused_host.so"
    subprocess.run([os.environ.get("CXX", "c++"), "-O2", "-std=c++17",
                    "-shared", "-fPIC", "-x", "c++", str(src), "-o", str(so)],
                   check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(so))
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    fn = lib.etl_filter_pack_compact_host
    fn.restype = None
    fn.argtypes = [vp, i64, vp, i32, i32, vp, i32, vp, vp, i32, vp, vp, vp,
                   vp, vp, ctypes.c_uint64, ctypes.c_uint32, i64, i32, i32,
                   i32, ctypes.c_uint64]

    def run(bmat, lengths, flags, specs, nibble, pred, tile_rows=256,
            scan=None, seed=0, rpt=None):
        """K2c with tiles of `tile_rows` rows and `rpt` rows a thread (the
        wrapper's choice when None) → (words [n_words, R], mask, counts,
        the words' buffer whole: out-of-range writes land in its slack,
        past n_words * R)."""
        if rpt is None:
            rpt = decode_kernel.compact_rows_per_thread(specs, nibble,
                                                        tile_rows)
        desc = np.array(decode_kernel.descriptor(specs, nibble), np.int32)
        pdesc = np.array(decode_kernel.pred_descriptor(pred, specs),
                         np.int32)
        R = bmat.shape[0]
        blocks = -(-R // decode_kernel.FILTER_BLOCK)
        if scan is None or scan.buf.size < 1 + blocks:
            scan = HostScan(blocks)
        n_words = layout_for_specs(specs).n_words
        buf = np.full(n_words * R + R + 512, SENTINEL, dtype=np.uint32)
        mask = np.full(-(-R // 32), 0xA5A5A5A5, dtype=np.uint32)
        counts = np.full(1, -7, dtype=np.int32)
        scan.epoch += 1
        ptr = scan.buf.ctypes.data
        fn(bmat.ctypes.data, bmat.shape[1], lengths.ctypes.data,
           int(lengths.dtype == np.uint8), len(specs), desc.ctypes.data,
           int(nibble), flags.ctypes.data, pdesc.ctypes.data, pdesc.size,
           buf.ctypes.data, mask.ctypes.data, counts.ctypes.data, ptr + 8,
           ptr, scan.tickets, scan.epoch, R, n_words, tile_rows, rpt, seed)
        scan.tickets += blocks
        assert int(scan.buf[0]) == scan.tickets  # one ticket a block
        return buf[:n_words * R].reshape(n_words, R), mask, counts, buf

    return run


@pytest.fixture(scope="module")
def host_fused(tmp_path_factory):
    return _build_fused_lib(decode_kernel.SOURCE,
                            tmp_path_factory.mktemp("fused"))


def _fused_inputs(sql, nibble, rows, seed, flags=None):
    """(bm, ln, fl, specs, pred, the plain version's (words, mask,
    counts)) for FKINDS (nibble: without BOOL) under `sql`; `flags` "dead"
    or "force" sets every row's flag to 0 (keep none) or 2 (keep all)."""
    from etl_tpu_torch import convert
    from etl_tpu_torch.ops.predicate import compile_row_filter
    from etl_tpu_torch.testing import filter_case

    kinds = FKINDS[1:] if nibble else FKINDS
    offset = 1 if nibble else 0
    pred = compile_row_filter(sql, convert.schema_from_plain(
        1, "public", "t",
        [(f"c{i + offset}", FOIDS[k], -1, True, None)
         for i, k in enumerate(kinds)], [True] * len(kinds),
        [True] * len(kinds)))
    specs = tuple((i, k, WIDTHS[k], _bw(k, WIDTHS[k]))
                  for i, k in enumerate(kinds))
    rng = np.random.default_rng(seed)
    bm, ln, fl = _rows(lambda n: filter_case(specs, n, rng, nibble), rows)
    if flags is not None:
        fl = np.full_like(fl, {"dead": 0, "force": 2}[flags])
    want = parse_and_pack_plain(torch.from_numpy(bm), torch.from_numpy(ln),
                                specs, nibble, pred=pred,
                                row_flags=torch.from_numpy(fl))
    want = (want[0].numpy().view(np.uint32), want[1].numpy().view(np.uint32),
            want[2].numpy())
    return bm, ln, fl, specs, pred, want


def _fused_same(got, want) -> bool:
    """K2c's [:, :count], mask and count equal the plain version's; the
    columns past the count and the slack hold the sentinel."""
    words, mask, counts, buf = got
    n = int(want[2][0])
    return (np.array_equal(counts, want[2]) and np.array_equal(mask, want[1])
            and np.array_equal(words[:, :n], want[0][:, :n])
            and bool((words[:, n:] == SENTINEL).all())
            and bool((buf[words.size:] == SENTINEL).all()))


def _fused_check(run, sql, nibble, rows, seed, tile_rows=256, flags=None,
                 rpt=None):
    """K2c against the plain version, launched on a status buffer that an
    earlier launch over the same rows with every row force-kept left
    (so the look-back meets status words of an earlier launch, whose
    prefixes differ)."""
    bm, ln, fl, specs, pred, want = _fused_inputs(sql, nibble, rows, seed,
                                                  flags)
    scan = HostScan(-(-rows // decode_kernel.FILTER_BLOCK))
    run(bm, ln, np.full_like(fl, 2), specs, nibble, pred, tile_rows, scan,
        seed=seed + 1, rpt=rpt)
    got = run(bm, ln, fl, specs, nibble, pred, tile_rows, scan, seed=seed,
              rpt=rpt)
    assert _fused_same(got, want), (sql, rows, tile_rows, seed)
    return want


@pytest.mark.parametrize("i", range(len(FILTERS)))
def test_host_fused_matches_plain(host_fused, i):
    """K2c, compiled as host C++, under every filter case, raw."""
    _fused_check(host_fused, FILTERS[i], False, 600 + 37 * i, seed=i)


@pytest.mark.parametrize("walk,rpt", [(256, 2), (256, 1), (128, 1),
                                      (64, 1), (32, 1), (0, 1)])
def test_host_fused_walks(host_fused, walk, rpt):
    """K2c in every walk (the word tile across sub-tile steps), 256-row
    tiles with one or two rows a thread, nibble, at a row count that
    leaves the last block ragged."""
    sql = ("(c1 >= 100 AND c2 <> -2147483648) OR c3 <= 2147483648 OR "
           "c4 IS NULL OR c8 > '2024-06-15 00:00:00+00'")
    _fused_check(host_fused, sql, True, 1111, seed=walk + rpt,
                 tile_rows=walk, rpt=rpt)


@pytest.mark.parametrize("walk", [256, 32])
@pytest.mark.parametrize("rows", [1, 31, 255, 256, 257, 16_411])
def test_host_fused_row_counts(host_fused, rows, walk):
    """Row counts that end inside a warp, at a block's end, right after
    it, and inside the 65th block, in 256-row tiles (two rows a thread)
    and 32-row sub-tiles."""
    want = _fused_check(host_fused, "c1 <= 5 OR c3 IS NULL", True, rows,
                        seed=rows, tile_rows=walk)
    if rows > 255:
        assert 0 < int(want[2][0]) < rows


def test_host_fused_two_windows(host_fused):
    """33,111 rows: 130 blocks, so the last blocks look back over
    several windows of predecessors (LOOKBACK)."""
    want = _fused_check(host_fused, "c1 <= 5 OR c3 IS NULL", True, 33_111,
                        seed=8)
    assert 0 < int(want[2][0]) < 33_111


@pytest.mark.parametrize("flags", ["dead", "force"])
def test_host_fused_keep_none_and_all(host_fused, flags):
    want = _fused_check(host_fused, FILTERS[3], False, 3001, seed=9,
                        flags=flags)
    assert int(want[2][0]) == (0 if flags == "dead" else 3001)


def test_host_fused_back_to_back(host_fused):
    """Ten launches on one status buffer, growing and shrinking grids
    (up to 36 blocks), each block order seeded differently."""
    scan = HostScan(36)
    for k, rows in enumerate((4_000, 300, 9_000, 2_048, 1, 700, 3_333,
                              4_096, 2_000, 8_999)):
        bm, ln, fl, specs, pred, want = _fused_inputs(
            "c2 < -5000000 OR c1 < 100", False, rows, seed=k)
        got = host_fused(bm, ln, fl, specs, False, pred, 32, scan, seed=k)
        assert _fused_same(got, want), (k, rows)
    assert scan.epoch == 10


@pytest.mark.parametrize("mutation", [
    # a look-back window one block short: the nearest inclusive prefix
    # is not summed
    ("return (incl & ((1u << lane) - 1u)) == 0;",
     "return (incl & ((2u << lane) - 1u)) == 0;"),
    # the epoch check dropped: any published flag counts as current
    ("return (uint32_t)(s >> EPOCH_SHIFT) == epoch;",
     "return ((s >> 32) & 3u) != 0;"),
    # a row's rank within its warp one off
    ("int rank = POPC(ballots[i >> 5] & ((1u << (i & 31)) - 1u));",
     "int rank = POPC(ballots[i >> 5] & ((2u << (i & 31)) - 1u));"),
], ids=["window-one-short", "epoch-check-dropped", "rank-off-by-one"])
def test_host_fused_mutation_is_caught(tmp_path, mutation):
    """The K2c checks above fail on a deliberately broken copy of the
    source (the harness's slack keeps stray writes inside its buffer)."""
    old, new = mutation
    src = decode_kernel.SOURCE.read_text()
    assert src.count(old) == 1
    broken = tmp_path / "decode_pack_broken.cu"
    broken.write_text(src.replace(old, new))
    run = _build_fused_lib(broken, tmp_path)
    with pytest.raises(AssertionError):
        _fused_check(run, "c1 <= 5 OR c3 IS NULL", True, 16_411, seed=3,
                     tile_rows=32)
