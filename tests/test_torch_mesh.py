"""The port's row-sharded decode mesh (`etl_tpu_torch/parallel/mesh.py`,
X1-mesh and X2-mesh through `DeviceDecoder(mesh=…)`) on the CPU, held
against the reference's mesh under the 8 forced XLA host devices of
tests/conftest.py, on the same seeded inputs.

The port's mesh here is 8 (or 6, or 3) shards over the CPU — one process
drives every shard, as one card holds 8 shards on the H100 — and the
kernels' plain versions run on each shard's row block. The cases are the
port's counterparts of tests/test_parallel.py (construction, the mixed
differential, fallback rows, per-shard outputs, the threshold, the three
cache-key cases) and of tests/test_filter_fusion.py
`TestMeshShardedIdentity`, plus: X1-mesh and `compact_packed(…,
n_shards)` plain against the reference's functions, a bucket the shard
count does not divide and a 6-shard mesh (rows a shard not a multiple of
32: the keep masks join bit by bit), the mesh's egress text against the
single-device text and the reference's TSV, the mesh telemetry against
the reference's after the same decodes, the routed-batch accounting, the
pipeline, and a failing shard that fails its batch.

Tolerance: none — integer words, masks and counts bit for bit, batches
by `assert_same_batch` / `filtered_batches_identical`.
"""

import random

import jax
import numpy as np
import pytest
import torch

from etl_tpu.models import Oid
from etl_tpu.models.pgtypes import CellKind as RK
from etl_tpu.ops import DeviceDecoder as RefDecoder
from etl_tpu.ops import bitpack as ref_bitpack
from etl_tpu.parallel.mesh import decode_mesh as ref_decode_mesh
from etl_tpu.parallel.mesh import make_mesh as ref_make_mesh
from etl_tpu.parallel.mesh import mesh_cache_key as ref_mesh_cache_key
from etl_tpu.telemetry import metrics as ref_metrics
from etl_tpu_torch import bench
from etl_tpu_torch.models.pgtypes import CellKind as K
from etl_tpu_torch.ops import decode_kernel, engine, program_store
from etl_tpu_torch.ops.bitpack import (compact_packed_plain, join_keep_masks,
                                       layout_for_specs, parse_and_pack_plain,
                                       shard_fallback_counts,
                                       unpack_keep_mask)
from etl_tpu_torch.ops.engine import DeviceDecoder
from etl_tpu_torch.ops.staging import pad_to_multiple
from etl_tpu_torch.parallel.mesh import (DecodeMesh, decode_mesh,
                                         default_decode_mesh, make_mesh,
                                         mesh_cache_key, shard_mesh)
from etl_tpu_torch.telemetry import metrics as port_metrics
from etl_tpu_torch.testing import field_matrix, filter_case
from test_torch_decoder import assert_same_batch
from test_torch_decoder_filter import (filtered_batches_identical, make_rts,
                                       port_schema, port_staged, stage_texts)
from test_torch_filter_words import schemas, specs_of

CPU = torch.device("cpu")


def port_mesh(n: int = 8) -> DecodeMesh:
    return decode_mesh([CPU] * n)


def ref_mesh(n: int = 8):
    return ref_decode_mesh(jax.devices()[:n])


def decoders(rts, n_shards: int = 8, **kw):
    """(reference mesh decoder, port mesh decoder, port single-device
    decoder) of one reference schema."""
    ref = RefDecoder(rts, device_min_rows=0, mesh=ref_mesh(n_shards),
                     mesh_min_rows=0, **kw)
    ps = port_schema(rts)
    port = DeviceDecoder(ps, device="cpu", device_min_rows=0,
                         mesh=port_mesh(n_shards), mesh_min_rows=0, **kw)
    single = DeviceDecoder(ps, device="cpu", device_min_rows=0, mesh=None,
                           **kw)
    return ref, port, single


def decode_three(rts, staged, n_shards: int = 8, **kw):
    ref, port, single = decoders(rts, n_shards, **kw)
    assert port._use_mesh(staged.row_capacity)
    return (ref.decode(staged), port.decode(port_staged(staged)),
            single.decode(port_staged(staged)))


def mixed_rows(n: int = 512, seed: int = 9) -> list:
    """tests/test_parallel.py's differential rows."""
    rng = random.Random(seed)
    rows = []
    for i in range(n):
        rows.append([
            str(i + 1),
            str(rng.randrange(-2**62, 2**62)),
            f"{rng.uniform(-1e5, 1e5):.6f}",
            f"2024-0{1 + i % 9}-1{i % 9} 0{i % 9}:1{i % 9}:2{i % 9}",
            None if i % 7 == 0 else f"name-{i}",
        ])
    return rows


MIXED = [Oid.INT4, Oid.INT8, Oid.FLOAT8, Oid.TIMESTAMP, Oid.TEXT]


def fallback_rows(n: int = 256) -> list:
    """FLOAT8 texts, 17-digit ones (which the device parse flags) spread
    unevenly over the rows, so the shards' counts differ."""
    return [["0.12345678901234567"] if i % 7 == 0 or 40 <= i < 60
            else ["NaN"] if i % 11 == 0 else [f"{i}.25"] for i in range(n)]


# ---------------------------------------------------------------------------
# construction
# ---------------------------------------------------------------------------

class TestMeshConstruction:
    def test_eight_shards_like_the_forced_devices(self):
        assert len(jax.devices()) == 8  # conftest forces the virtual mesh
        ref, port = ref_decode_mesh(), port_mesh()
        assert port.shape == dict(ref.shape) == {"sp": 8}
        assert port.axis_names == tuple(ref.axis_names) == ("sp",)
        assert port.size == ref.size == 8
        assert port.flat == [CPU] * 8

    def test_one_device_is_no_mesh(self):
        assert decode_mesh([CPU]) is None
        assert ref_decode_mesh(jax.devices()[:1]) is None
        # the devices that exist: no card here, so no mesh; "auto" is
        # that on a CUDA decoder and None on the CPU
        assert decode_mesh() is None and default_decode_mesh() is None
        schema = port_schema(make_rts([Oid.INT4]))
        assert DeviceDecoder(schema, device="cpu").mesh is None

    @pytest.mark.parametrize("n", range(1, 9))
    def test_make_mesh_matches_the_reference_split(self, n):
        assert make_mesh([CPU] * n).shape \
            == dict(ref_make_mesh(jax.devices()[:n]).shape)

    def test_make_mesh_2d(self):
        mesh = make_mesh([CPU] * 8)
        assert mesh.shape["dp"] * mesh.shape["sp"] == 8
        assert make_mesh([CPU] * 8, dp=4).shape == {"dp": 4, "sp": 2} \
            == dict(ref_make_mesh(dp=4).shape)
        assert len(mesh.devices) == mesh.shape["dp"]

    def test_mesh_over_devices_that_are_not_here_raises(self):
        cards = [torch.device("cuda", 0)] * 8
        with pytest.raises(RuntimeError):
            decode_mesh(cards)
        with pytest.raises(RuntimeError):
            shard_mesh(8, "cuda")
        schema = port_schema(make_rts([Oid.INT4]))
        with pytest.raises(RuntimeError):
            DeviceDecoder(schema, device="cpu",
                          mesh=DecodeMesh(cards, ("sp",)))
        with pytest.raises(ValueError):
            DeviceDecoder(schema, device="cpu", mesh="everywhere")

    def test_shard_mesh_repeats_the_cpu(self):
        mesh = shard_mesh(6, "cpu")
        assert mesh.size == 6 and set(mesh.flat) == {CPU}
        with pytest.raises(ValueError):
            shard_mesh(1, "cpu")


# ---------------------------------------------------------------------------
# the decoder on the mesh against the reference's
# ---------------------------------------------------------------------------

class TestMeshDecode:
    def test_differential_mixed_types(self):
        ref, port, single = decode_three(
            make_rts(MIXED), stage_texts(mixed_rows(), len(MIXED)))
        assert_same_batch(ref, port)
        assert_same_batch(ref, single)

    def test_fallback_rows_on_mesh(self):
        rows = [["1.5"], ["0.12345678901234567"], ["2.25"], ["NaN"]] * 16
        ref, port, _ = decode_three(make_rts([Oid.FLOAT8]),
                                    stage_texts(rows, 1))
        assert_same_batch(ref, port)

    def test_outputs_per_shard(self):
        """The mesh dispatch's per-shard fallback-candidate counts — one
        a shard — equal the reference's device-reduced `shard_bad`."""
        rts = make_rts([Oid.FLOAT8])
        staged = stage_texts(fallback_rows(), 1)
        rdec, pdec, _ = decoders(rts)
        rspecs = rdec._specs(staged, rdec._widths(staged))
        (_, ref_bad), _ = rdec._device_call(staged, rspecs)
        pst = port_staged(staged)
        specs = pdec._specs(pst, pdec._widths(pst))
        pending = pdec._dispatch_stage(pst, specs,
                                       pdec._pack_stage(pst, specs))
        got = pending._shards.shard_bad
        assert got.shape == (8,) and got.dtype == torch.int32
        assert np.array_equal(got.numpy(), np.asarray(ref_bad))
        assert len(set(got.tolist())) > 1  # the shards differ
        assert_same_batch(rdec.decode(staged), pending.result())

    def test_mesh_threshold_routes_small_batches_single_device(self):
        schema = port_schema(make_rts([Oid.INT4]))
        dec = DeviceDecoder(schema, device="cpu", device_min_rows=0,
                            mesh=port_mesh())
        assert dec.mesh_min_rows == DeviceDecoder.MESH_MIN_ROWS == \
            RefDecoder.MESH_MIN_ROWS == 65_536
        staged = port_staged(stage_texts([["1"]], 1))
        assert not dec._use_mesh(staged.row_capacity)
        before = engine.routed_device_batches
        assert dec.decode(staged).columns[0].data[0] == 1
        assert engine.routed_device_batches - before == 1
        assert dec._use_mesh(65_536) and not dec._use_mesh(65_535)

    def test_a_mesh_batch_counts_once_a_shard(self):
        """Each shard's block is a batch to the kernels, so launches =
        device-routed batches holds on the mesh: 8 a batch here."""
        schema = port_schema(make_rts([Oid.INT4]))
        dec = DeviceDecoder(schema, device="cpu", device_min_rows=0,
                            mesh=port_mesh(), mesh_min_rows=0)
        b0, r0 = engine.routed_device_batches, engine.routed_batches
        dec.decode(port_staged(stage_texts([[str(i)] for i in range(40)],
                                           1)))
        assert engine.routed_device_batches - b0 == 8
        assert engine.routed_batches - r0 == 8


class TestMeshShardedIdentity:
    def test_filtered_mesh_equals_single_device(self):
        """tests/test_filter_fusion.py:390 on the port: 3,000 rows under
        `c1 < 0 OR c1 IS NULL`, the port's mesh against its single device
        and the reference's mesh, `source_rows` included."""
        rng = random.Random(390)
        rows = [[str(i),
                 None if rng.random() < 0.1
                 else str(rng.randrange(-10**6, 10**6))]
                for i in range(3000)]
        rts = make_rts([Oid.INT8, Oid.INT4], "c1 < 0 OR c1 IS NULL")
        ref, port, single = decode_three(rts, stage_texts(rows, 2))
        assert filtered_batches_identical(single, port)
        assert filtered_batches_identical(ref, port)
        expected = [i for i, r in enumerate(rows)
                    if r[1] is None or int(r[1]) < 0]
        assert list(port.source_rows) == expected
        assert 0 < single.num_rows < 3000

    @pytest.mark.parametrize("n_shards", [3, 6, 8])
    def test_undivided_bucket(self, n_shards):
        """3,000 rows stage into a 4,096-row bucket, which 3 and 6 shards
        do not divide: the pack pads it (4,098 rows, 1,366 or 683 a shard
        — not a multiple of 32), unfiltered and filtered, as the
        reference's mesh does. The reference's filtered mesh program
        shards its keep mask by whole words, which 6 shards cannot do
        with 129 words: that case is held against the reference's
        single-device decode."""
        rows = mixed_rows(3000, seed=n_shards)
        staged = stage_texts(rows, len(MIXED))
        assert staged.row_capacity == 4096
        ref, port, single = decode_three(make_rts(MIXED), staged, n_shards)
        assert_same_batch(ref, port)
        assert_same_batch(ref, single)
        rts = make_rts(MIXED, "c1 < 0")
        _, port, single = decoders(rts, n_shards)
        words = -(-pad_to_multiple(4096, n_shards) // 32)
        ref = RefDecoder(rts, device_min_rows=0,
                         mesh=ref_mesh(n_shards) if words % n_shards == 0
                         else None, mesh_min_rows=0)
        ref = ref.decode(staged)
        port = port.decode(port_staged(staged))
        single = single.decode(port_staged(staged))
        assert filtered_batches_identical(ref, port)
        assert filtered_batches_identical(single, port)
        assert list(port.source_rows) == [i for i, r in enumerate(rows)
                                          if int(r[1]) < 0]

    def test_padding_rows_are_dead_and_null(self):
        rts = make_rts([Oid.INT4], "c0 >= 0")
        dec = DeviceDecoder(port_schema(rts), device="cpu",
                            device_min_rows=0, mesh=port_mesh(6),
                            mesh_min_rows=0)
        staged = port_staged(stage_texts([[str(i)] for i in range(300)], 1))
        specs = dec._specs(staged, dec._widths(staged))
        packed = dec._pack_stage(staged, specs)
        cap = staged.row_capacity
        assert packed.shards == 6
        assert packed.bmat.shape[0] == pad_to_multiple(cap, 6) == 1026
        assert not packed.bmat[cap:].any() and not packed.lengths[cap:].any()
        assert not packed.row_flags[cap:].any()


# ---------------------------------------------------------------------------
# X1-mesh and the shard-local compaction, plain, against the reference's
# ---------------------------------------------------------------------------

RAW = [K.BOOL, K.I16, K.I32, K.U32, K.I64, K.DATE, K.TIME, K.TIMESTAMP,
       K.TIMESTAMPTZ]
NIBBLE = [k for k in RAW if k is not K.BOOL]


def _ref_specs(specs):
    return tuple((c, RK[k.name], w, bw) for c, k, w, bw in specs)


@pytest.mark.parametrize("n_shards,rows", [(8, 512), (6, 300), (3, 96)])
@pytest.mark.parametrize("nibble", [False, True], ids=["raw", "nibble"])
def test_x1_mesh_plain_matches_the_reference(n_shards, rows, nibble):
    """`parse_and_pack_plain(…, n_shards=)` against the reference's
    `parse_and_pack(…, n_shards=)`: the words and the per-shard
    fallback-candidate counts, bit for bit, on adversarial field rows."""
    kinds = NIBBLE if nibble else RAW
    specs = specs_of(kinds)
    bm, ln = field_matrix(specs, rows, np.random.default_rng(rows + nibble),
                          nibble)
    with jax.disable_jit():
        rwords, rbad = ref_bitpack.parse_and_pack(
            bm, ln.astype(np.int32), _ref_specs(specs), nibble,
            n_shards=n_shards)
    words, bad = parse_and_pack_plain(torch.from_numpy(bm),
                                      torch.from_numpy(ln), specs, nibble,
                                      n_shards=n_shards)
    assert words.view(torch.int32).numpy().tobytes() \
        == np.asarray(rwords).view(np.int32).tobytes()
    assert np.array_equal(bad.numpy(), np.asarray(rbad))
    assert bad.shape == (n_shards,) and int(bad.sum()) > 0
    # the torch-op reduction from the packed ok bits and the lengths
    assert torch.equal(shard_fallback_counts(
        words, torch.from_numpy(ln), layout_for_specs(specs), n_shards), bad)


@pytest.mark.parametrize("n_shards,rows", [(8, 512), (6, 300)])
def test_x1_mesh_filtered_plain_matches_the_reference(n_shards, rows):
    """Under a filter: the shard-local compaction (each block's
    survivors at the front of the block, zeros behind), the keep mask,
    one count a shard and `shard_bad` over every row, as the reference's
    `parse_and_pack(…, n_shards=, pred=)`."""
    kinds = [K.I32, K.I64, K.DATE]
    _, _, rpred, pred = schemas(kinds, "c0 < 0 OR c2 IS NULL")
    specs = specs_of(kinds)
    bm, ln, fl = filter_case(specs, rows, np.random.default_rng(rows), False)
    with jax.disable_jit():
        want = ref_bitpack.parse_and_pack(
            bm, ln.astype(np.int32), _ref_specs(specs), False,
            n_shards=n_shards, pred=rpred, row_flags=fl)
    got = parse_and_pack_plain(torch.from_numpy(bm), torch.from_numpy(ln),
                               specs, False, pred=pred,
                               row_flags=torch.from_numpy(fl),
                               n_shards=n_shards)
    for name, g, w in zip(("words", "mask", "counts", "shard_bad"), got,
                          want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape, name
        assert g.numpy().view(np.uint32).tobytes() \
            == w.view(np.uint32).tobytes(), name
    assert got[2].shape == (n_shards,) and 0 < int(got[2].sum()) < rows


@pytest.mark.parametrize("n_shards,rows", [(8, 1024), (6, 1026), (3, 999),
                                           (1, 700)])
def test_compact_packed_plain_matches_the_reference(n_shards, rows):
    """`compact_packed_plain(words, keep, n_shards)` against the
    reference's `compact_packed`: random words and keep bits."""
    rng = np.random.default_rng(rows)
    words = rng.integers(0, 2**32, size=(3, rows), dtype=np.uint64) \
        .astype(np.uint32)
    keep = rng.random(rows) < 0.4
    with jax.disable_jit():
        want = ref_bitpack.compact_packed(words, keep, n_shards)
    got = compact_packed_plain(torch.from_numpy(words.view(np.int32))
                               .view(torch.uint32),
                               torch.from_numpy(keep), n_shards)
    for g, w in zip(got, want):
        assert g.numpy().view(np.uint32).tobytes() \
            == np.asarray(w).view(np.uint32).tobytes()


@pytest.mark.parametrize("n_shards,rps", [(6, 171), (8, 128), (3, 333)])
def test_shard_masks_join_bit_by_bit(n_shards, rps):
    """Per-shard keep masks over blocks whose row count is not a
    multiple of 32 join into the batch's mask bit by bit: equal to the
    reference's mask over the whole batch."""
    rng = np.random.default_rng(rps)
    keep = rng.random(n_shards * rps) < 0.5
    with jax.disable_jit():
        _, want, _ = ref_bitpack.compact_packed(
            np.zeros((1, len(keep)), np.uint32), keep, n_shards)
    masks = [compact_packed_plain(torch.zeros((1, rps), dtype=torch.int32)
                                  .view(torch.uint32),
                                  torch.from_numpy(keep[s * rps:
                                                        (s + 1) * rps]))[1]
             for s in range(n_shards)]
    joined = join_keep_masks(masks, rps)
    assert joined.numpy().view(np.uint32).tobytes() \
        == np.asarray(want).tobytes()
    assert np.array_equal(unpack_keep_mask(joined.numpy(), len(keep)),
                          np.flatnonzero(keep))


def test_row_blocks_and_shard_launches():
    """The shard helpers: contiguous row blocks, one launch a shard, each
    reading its own block; a count that does not divide raises."""
    t = torch.arange(24, dtype=torch.int32).view(12, 2)
    blocks = decode_kernel.row_blocks(t, 3)
    assert [b.tolist() for b in blocks] == [t[:4].tolist(), t[4:8].tolist(),
                                            t[8:].tolist()]
    assert all(b.is_contiguous() for b in blocks)
    with pytest.raises(ValueError):
        decode_kernel.row_blocks(t, 5)
    specs = specs_of([K.I32])
    bm, ln = field_matrix(specs, 64, np.random.default_rng(1), False)
    bms = decode_kernel.row_blocks(torch.from_numpy(bm), 4)
    lns = decode_kernel.row_blocks(torch.from_numpy(ln), 4)
    launches = decode_kernel.prepare_decode_pack_shards(bms, lns, specs,
                                                        False)
    assert len(launches) == 4
    assert [launch.inputs[0].data_ptr() for launch in launches] \
        == [b.data_ptr() for b in bms]
    joined = torch.cat([launch().view(torch.int32) for launch in launches],
                       dim=1)
    assert torch.equal(joined, parse_and_pack_plain(
        torch.from_numpy(bm), torch.from_numpy(ln), specs, False)
        .view(torch.int32))


# ---------------------------------------------------------------------------
# X2-mesh: the render on each shard's words
# ---------------------------------------------------------------------------

class TestMeshEgress:
    @pytest.mark.parametrize("encoder,n_shards", [("tsv", 8), ("json", 6)])
    def test_mesh_text_equals_the_single_device_text(self, encoder,
                                                     n_shards):
        rts = make_rts([Oid.INT4, Oid.INT8, Oid.DATE, Oid.TEXT])
        rows = [[str(i - 150), str((i * 7919) % 100003 - 5000),
                 f"20{i % 30:02d}-0{1 + i % 9}-1{i % 10}",
                 None if i % 5 == 0 else f"t{i}"] for i in range(300)]
        staged = stage_texts(rows, 4)
        _, port, single = decoders(rts, n_shards, egress=encoder)
        a = single.decode(port_staged(staged))
        b = port.decode(port_staged(staged))
        assert_same_batch(a, b)
        ea, eb = a.device_egress, b.device_egress
        assert ea is not None and eb is not None
        assert (eb.encoder, eb.n_rows) == (ea.encoder, ea.n_rows) \
            == (encoder, 300)
        assert set(eb.fields) == set(ea.fields) and {0, 1} <= set(ea.fields)
        for col in ea.fields:
            assert np.array_equal(eb.fields[col][0], ea.fields[col][0])
            assert np.array_equal(eb.fields[col][1], ea.fields[col][1])
        assert np.array_equal(eb.untrusted, ea.untrusted)

    def test_mesh_tsv_body_equals_the_reference(self):
        from etl_tpu.destinations.clickhouse import \
            render_batch_tsv_columnar as ref_tsv
        from etl_tpu_torch.destinations.clickhouse import \
            render_batch_tsv_fast
        from etl_tpu_torch.destinations.util import (sequence_number_batch,
                                                     sequence_number_buffer)

        rts = make_rts([Oid.INT4, Oid.INT8, Oid.BOOL, Oid.DATE])
        rows = [[str(i), str(-i * 1000003), "t" if i % 3 else "f",
                 f"2024-0{1 + i % 9}-0{1 + i % 9}"] for i in range(200)]
        staged = stage_texts(rows, 4)
        ref, port, _ = decoders(rts, egress="tsv")
        rb, pb = ref.decode(staged), port.decode(port_staged(staged))
        n = pb.num_rows
        lsns = np.arange(n, dtype=np.uint64) + 0x2000
        zeros = np.zeros(n, dtype=np.uint64)
        ords = np.arange(n, dtype=np.uint64)
        seqs = sequence_number_buffer(lsns, zeros, ords)
        body, used = render_batch_tsv_fast(port_schema(rts), pb, "UPSERT",
                                           seqs, egress=pb.device_egress)
        assert used is True
        seq_strs = [s.decode() for s in sequence_number_batch(lsns, zeros,
                                                              ords)]
        assert body == ref_tsv(rts, rb, "UPSERT", seq_strs)


# ---------------------------------------------------------------------------
# telemetry, the program store's signatures, failure, the pipeline
# ---------------------------------------------------------------------------

_COUNTERS = ("ETL_DECODE_MESH_BATCHES_TOTAL", "ETL_DECODE_MESH_ROWS_TOTAL",
             "ETL_DECODE_MESH_PADDED_ROWS_TOTAL",
             "ETL_DECODE_MESH_FALLBACK_CANDIDATE_ROWS_TOTAL")


def _mesh_counters(m) -> dict:
    return {name: m.registry.get_counter(getattr(m, name))
            for name in _COUNTERS}


class TestMeshTelemetry:
    def test_counters_match_the_reference_after_the_same_decodes(self):
        """Two unfiltered mesh decodes with fallback candidates on a
        6-shard mesh (padding rows included): the mesh counters' deltas
        and the shard gauges equal the reference's."""
        rts = make_rts([Oid.FLOAT8])
        ref, port, _ = decoders(rts, 6)
        r0, p0 = _mesh_counters(ref_metrics), _mesh_counters(port_metrics)
        for n in (256, 300):
            staged = stage_texts(fallback_rows(n), 1)
            assert_same_batch(ref.decode(staged),
                              port.decode(port_staged(staged)))
        rd = {k: v - r0[k] for k, v in _mesh_counters(ref_metrics).items()}
        pd = {k: v - p0[k] for k, v in _mesh_counters(port_metrics).items()}
        assert pd == rd
        assert pd["ETL_DECODE_MESH_BATCHES_TOTAL"] == 2
        assert pd["ETL_DECODE_MESH_PADDED_ROWS_TOTAL"] == 2 * 2  # 258, 516
        assert pd["ETL_DECODE_MESH_FALLBACK_CANDIDATE_ROWS_TOTAL"] > 0
        for m in (ref_metrics, port_metrics):
            assert m.registry.get_gauge(m.ETL_DECODE_MESH_SHARDS) == 6
        for s in range(6):
            labels = {"shard": str(s)}
            assert port_metrics.registry.get_gauge(
                port_metrics.ETL_DECODE_MESH_SHARD_FALLBACK_CANDIDATES,
                labels) == ref_metrics.registry.get_gauge(
                ref_metrics.ETL_DECODE_MESH_SHARD_FALLBACK_CANDIDATES,
                labels)
        p = port_metrics
        assert p.registry.get_gauge(p.ETL_DECODE_MESH_PAD_WASTE_RATIO) == \
            p.registry.get_counter(p.ETL_DECODE_MESH_PADDED_ROWS_TOTAL) \
            / p.registry.get_counter(p.ETL_DECODE_MESH_ROWS_TOTAL)

    def test_filtered_mesh_batch_counts_no_candidates(self):
        """Under a filter the port counts no fallback candidates: the
        fused filter stops parsing a dropped row, so no count over every
        row (the reference's) exists, and one over the survivors would
        give the counter a second meaning. Batches, rows and padding
        count as the reference's."""
        rts = make_rts([Oid.FLOAT8, Oid.INT4], "c1 < 100")
        # no NaN here: the filtered comparison holds values by equality
        rows = [["-1.5" if r[0] == "NaN" else r[0], str(i)]
                for i, r in enumerate(fallback_rows(300))]
        staged = stage_texts(rows, 2)
        ref, port, _ = decoders(rts, 3)  # 1,026 rows: a 33-word mask
        r0, p0 = _mesh_counters(ref_metrics), _mesh_counters(port_metrics)
        rb, pb = ref.decode(staged), port.decode(port_staged(staged))
        assert filtered_batches_identical(rb, pb)
        rd = {k: v - r0[k] for k, v in _mesh_counters(ref_metrics).items()}
        pd = {k: v - p0[k] for k, v in _mesh_counters(port_metrics).items()}
        cand = "ETL_DECODE_MESH_FALLBACK_CANDIDATE_ROWS_TOTAL"
        assert {k: v for k, v in pd.items() if k != cand} \
            == {k: v for k, v in rd.items() if k != cand}
        assert pd[cand] == 0
        assert rd[cand] == sum(1 for r in rows if len(r[0]) == 19) > 0

    def test_no_candidates_without_telemetry(self):
        """A decoder with telemetry off reduces no fallback candidates:
        nothing would read them."""
        rts = make_rts([Oid.FLOAT8])
        ps = port_schema(rts)
        dec = DeviceDecoder(ps, device="cpu", device_min_rows=0,
                            mesh=port_mesh(), mesh_min_rows=0,
                            telemetry=False)
        staged = port_staged(stage_texts(fallback_rows(), 1))
        specs = dec._specs(staged, dec._widths(staged))
        pending = dec._dispatch_stage(staged, specs,
                                      dec._pack_stage(staged, specs))
        assert pending._shards.shard_bad is None
        single = DeviceDecoder(ps, device="cpu", device_min_rows=0,
                               mesh=None)
        assert_same_batch(single.decode(staged), pending.result())


class TestSignatures:
    """tests/test_parallel.py `TestSharedFnCacheKeying` on the port: the
    program store's observed signature carries the mesh fingerprint in
    the reference's slot."""

    @staticmethod
    def _staged():
        return port_staged(stage_texts([[str(i)] for i in range(256)], 1))

    def test_mesh_and_single_device_signatures_never_collide(
            self, tmp_path, monkeypatch):
        monkeypatch.setattr(program_store, "_CONFIGURED", [str(tmp_path)])
        program_store.reset_for_tests()
        try:
            schema = port_schema(make_rts([Oid.INT4]))
            meshed = DeviceDecoder(schema, device="cpu", device_min_rows=0,
                                   mesh=port_mesh(), mesh_min_rows=0)
            plain = DeviceDecoder(schema, device="cpu", device_min_rows=0,
                                  mesh=None)
            assert_same_batch(meshed.decode(self._staged()),
                              plain.decode(self._staged()))
            keys = program_store.load_observed()
            key_m = next(k for k in keys if k[3] is not None)
            key_p = next(k for k in keys if k[3] is None)
            assert key_m[:3] == key_p[:3] and key_m[4:] == key_p[4:]
            assert key_m[3] == mesh_cache_key(meshed.mesh)
            assert key_m != key_p
            # one layout however many meshes dispatch it
            assert program_store.observed_layouts() == {"device": 1}
        finally:
            program_store.reset_for_tests()

    def test_recreated_equal_mesh_shares_the_signature(self, tmp_path,
                                                       monkeypatch):
        m1, m2 = port_mesh(), port_mesh()
        assert m1 is not m2
        assert mesh_cache_key(m1) == mesh_cache_key(m2)
        r1, r2 = ref_decode_mesh(), ref_decode_mesh()
        assert ref_mesh_cache_key(r1) == ref_mesh_cache_key(r2)
        monkeypatch.setattr(program_store, "_CONFIGURED", [str(tmp_path)])
        program_store.reset_for_tests()
        try:
            schema = port_schema(make_rts([Oid.INT4]))
            for m in (m1, m2):
                DeviceDecoder(schema, device="cpu", device_min_rows=0,
                              mesh=m, mesh_min_rows=0).decode(self._staged())
            assert len(program_store.load_observed()) == 1
        finally:
            program_store.reset_for_tests()

    def test_different_device_sets_fingerprint_differently(self):
        assert mesh_cache_key(port_mesh(4)) != mesh_cache_key(port_mesh())
        cards = DecodeMesh([torch.device("cuda", i % 2) for i in range(8)],
                           ("sp",))
        one_card = DecodeMesh([torch.device("cuda", 0)] * 8, ("sp",))
        assert len({mesh_cache_key(port_mesh()), mesh_cache_key(cards),
                    mesh_cache_key(one_card)}) == 3
        assert mesh_cache_key(None) is None is ref_mesh_cache_key(None)
        assert ref_mesh_cache_key(ref_mesh(4)) \
            != ref_mesh_cache_key(ref_decode_mesh())


def test_a_failing_shard_fails_the_batch(monkeypatch):
    """No fallback hides a shard: a shard whose launch raises fails the
    whole batch — it is not decoded again on one device or the oracle."""
    real = decode_kernel.prepare_decode_pack
    calls = []

    def failing(bmat, lengths, specs, nibble, *a, **kw):
        launch = real(bmat, lengths, specs, nibble, *a, **kw)
        calls.append(launch)
        if len(calls) != 4:
            return launch

        def boom():
            raise RuntimeError("decode kernel launch failed: shard 3")

        boom.inputs = launch.inputs
        return boom

    monkeypatch.setattr(decode_kernel, "prepare_decode_pack", failing)
    schema = port_schema(make_rts([Oid.INT4]))
    dec = DeviceDecoder(schema, device="cpu", device_min_rows=0,
                        mesh=port_mesh(), mesh_min_rows=0)
    oracle0 = engine.routed_oracle_batches
    with pytest.raises(RuntimeError, match="shard 3"):
        dec.decode(port_staged(stage_texts([[str(i)] for i in range(64)],
                                           1)))
    # shards 0-3 prepared once each, the fourth failed, none decoded again
    assert len(calls) == 4
    assert engine.routed_oracle_batches == oracle0


def test_pipelined_mesh_decode_equals_serial():
    """The decode pipeline (pack into a staging arena on its worker
    thread, then the mesh dispatch) gives the serial decode's batches."""
    from etl_tpu_torch.ops.pipeline import DecodePipeline

    rts = make_rts(MIXED)
    staged = stage_texts(mixed_rows(700, seed=3), len(MIXED))
    dec = DeviceDecoder(port_schema(rts), device="cpu", device_min_rows=0,
                        mesh=port_mesh(6), mesh_min_rows=0)
    serial = dec.decode(port_staged(staged))
    pipe = DecodePipeline(window=2)
    try:
        handles = [pipe.submit(dec, port_staged(staged)) for _ in range(3)]
        batches = [h.result() for h in handles]
    finally:
        pipe.close()
        pipe.join(10.0)
    assert all(bench.batches_equal(serial, b) for b in batches)
