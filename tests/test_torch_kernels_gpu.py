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
