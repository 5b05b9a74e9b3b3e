"""The CUDA kernel's own parse-and-pack code, compiled as host C++, against
the plain PyTorch version, bit for bit.

`csrc/decode_pack.cu` builds without nvcc as C++ (its device qualifiers
vanish off `__CUDACC__`) and exports `etl_decode_pack_host`, which runs
the kernel's per-row body over every row. This checks the kernel's logic
on every kind here on the CPU; tests/test_torch_kernels_gpu.py checks the
compiled kernel on the card.
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


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    so = tmp_path_factory.mktemp("decode_pack") / "decode_pack_host.so"
    subprocess.run([os.environ.get("CXX", "c++"), "-O2", "-std=c++17",
                    "-shared", "-fPIC", "-x", "c++",
                    str(decode_kernel.SOURCE), "-o", str(so)],
                   check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(so))
    fn = lib.etl_decode_pack_host
    fn.restype = None
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_int64, ctypes.c_int]

    def run(bmat, lengths, specs, nibble):
        desc = np.array(decode_kernel.descriptor(specs, nibble), np.int32)
        n_words = layout_for_specs(specs).n_words
        out = np.full((n_words, bmat.shape[0]), 0xDEADBEEF, dtype=np.uint32)
        fn(bmat.ctypes.data, bmat.shape[1], lengths.ctypes.data,
           int(lengths.dtype == np.uint8), len(specs), desc.ctypes.data,
           int(nibble), out.ctypes.data, bmat.shape[0], n_words)
        return out

    return run


def _check(run, specs, nibble, rows, seed, lengths_dtype=np.uint8):
    bm, ln = field_matrix(specs, rows, np.random.default_rng(seed), nibble,
                          lengths_dtype)
    want = parse_and_pack_plain(torch.from_numpy(bm), torch.from_numpy(ln),
                                specs, nibble).numpy()
    got = run(bm, ln, specs, nibble)
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
                                         vp, vp, vp, vp, i64, i32]
    lib.etl_compact_packed_host.restype = None
    lib.etl_compact_packed_host.argtypes = [vp, vp, vp, vp, vp, i64, i32]

    def run(bmat, lengths, flags, specs, nibble, pred):
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
            int(nibble), flags.ctypes.data, pdesc.ctypes.data,
            words.ctypes.data, mask.ctypes.data, blocks.ctypes.data, R,
            n_words)
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


def _filter_check(run, sql, nibble, rows, seed):
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
    bm, ln, fl = filter_case(specs, rows, np.random.default_rng(seed), nibble)
    t = (torch.from_numpy(bm), torch.from_numpy(ln), torch.from_numpy(fl))
    want = parse_and_pack_plain(t[0], t[1], specs, nibble, pred=pred,
                                row_flags=t[2])
    k2_want = filter_pack_plain(*t, specs, nibble, pred,
                                decode_kernel.FILTER_BLOCK)
    words, mask, blocks, out, counts = run(bm, ln, fl, specs, nibble, pred)
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
