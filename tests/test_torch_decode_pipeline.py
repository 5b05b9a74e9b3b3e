"""The port's three-stage decode pipeline (etl_tpu_torch/ops/pipeline.py)
on the CPU, where its decoders run the kernels' plain versions: the cases
of tests/test_decode_pipeline.py (pipelined output identical to serial
`decode()`, filtered and unfiltered, results in submit order, the
in-flight window, the staging arenas) plus the admission scheduler shared
by two pipelines, the worker's exit, and the two pools under two
threads."""

import os
import sys
import threading
import time
import types

import numpy as np
import pytest
import torch

from etl_tpu.models import Oid as RefOid
from etl_tpu.ops import DecodePipeline as RefDecodePipeline
from etl_tpu.ops import DeviceDecoder as RefDecoder
from etl_tpu.ops import stage_tuples as ref_stage_tuples
from etl_tpu_torch import bench
from etl_tpu_torch.chaos import failpoints
from etl_tpu_torch.models import (ColumnSchema, Oid, ReplicatedTableSchema,
                                  TableName, TableSchema)
from etl_tpu_torch.models.errors import EtlError
from etl_tpu_torch.ops import engine as engine_mod
from etl_tpu_torch.ops.engine import DeviceDecoder
from etl_tpu_torch.ops.pipeline import (AdmissionScheduler, DecodePipeline,
                                        reset_global_admission)
from etl_tpu_torch.ops.predicate import parse_row_filter
from etl_tpu_torch.ops.staging import StagingArenaPool, stage_tuples
from etl_tpu_torch.ops.wal import concat_payloads, stage_wal_batch
from etl_tpu_torch.postgres.codec.pgoutput import (TUPLE_NULL, TUPLE_TEXT,
                                                   TupleData)
from etl_tpu_torch.runtime.backpressure import InFlightWindow
from tests.test_torch_decoder import (assert_same_batch, port_schema,
                                      port_staged)
from tests.test_torch_decoder import make_schema as ref_make_schema
from tests.test_torch_decoder import staged_from_texts as ref_staged

OIDS = [Oid.INT8, Oid.INT4, Oid.FLOAT8, Oid.DATE, Oid.TEXT]


@pytest.fixture(autouse=True)
def _port_hygiene():
    """The port's own failpoints and process-wide admission scheduler
    are reset after every test (the conftest fixture covers the
    reference's only)."""
    yield
    failpoints.disarm_all()
    reset_global_admission()


def make_schema(oids):
    return ReplicatedTableSchema.with_all_columns(TableSchema(
        1, TableName("public", "t"),
        tuple(ColumnSchema(f"c{i}", oid) for i, oid in enumerate(oids))))


def _tuples(rows):
    return [TupleData([TUPLE_NULL if v is None else TUPLE_TEXT for v in r],
                      [None if v is None else v.encode() for v in r])
            for r in rows]


def _stage(rows):
    return stage_tuples(_tuples(rows), len(rows[0]))


def _rows(n, start=0):
    return [[str((i * 7919) % 2**62 - 2**61), str(i % 97), f"{i}.25",
             "2024-05-01", f"note-{i}"] for i in range(start, start + n)]


def _cpu(schema, **kw):
    return DeviceDecoder(schema, device="cpu", device_min_rows=0, **kw)


def _pgbench_staged(n_rows, seed):
    """A pgbench insert batch of `n_rows` rows with seeded balances."""
    from etl_tpu_torch.postgres.codec import pgoutput

    rng = np.random.default_rng(seed)
    payloads = [pgoutput.encode_insert(16384, [
        str(i + 1).encode(), str(int(rng.integers(1, 11))).encode(),
        str(int(rng.integers(-10**9, 10**9))).encode(), b" " * 84])
        for i in range(n_rows)]
    return stage_wal_batch(*concat_payloads(payloads), 4).staged


def _filtered_schema():
    return bench.make_schema().with_row_predicate(
        parse_row_filter("bid <= 5"))


class TestPipelinedVsSerial:
    def test_byte_identical_output(self):
        dec = _cpu(make_schema(OIDS))
        batches = [_rows(200, k * 1000) for k in range(4)]
        serial = [dec.decode(_stage(r)) for r in batches]
        pipe = DecodePipeline(window=3)
        try:
            handles = [pipe.submit(dec, _stage(r)) for r in batches]
            for h, s in zip(handles, serial):
                assert_same_batch(s, h.result())
        finally:
            pipe.close()

    def test_filtered_byte_identical_output(self):
        """Fused filter: the compacted batches and their source_rows from
        the pipeline equal serial decode()'s and the oracle route's."""
        schema = _filtered_schema()
        dec = _cpu(schema)
        oracle = DeviceDecoder(schema, device="cpu", device_min_rows=10**9)
        pipe = DecodePipeline(window=2)
        try:
            handles = [pipe.submit(dec, _pgbench_staged(300, k))
                       for k in range(4)]
            for k, h in enumerate(handles):
                got = h.result()
                assert got.source_rows is not None
                assert 0 < got.num_rows < 300
                assert bench.filtered_batches_identical(
                    got, dec.decode(_pgbench_staged(300, k)))
                assert bench.filtered_batches_identical(
                    got, oracle.decode(_pgbench_staged(300, k)))
        finally:
            pipe.close()

    def test_matches_reference_pipeline(self):
        """The port's pipelined decode against the reference's pipelined
        decode (JAX on the CPU) of the same staged batches."""
        ref_oids = [RefOid.INT8, RefOid.INT4, RefOid.FLOAT8, RefOid.DATE,
                    RefOid.TEXT]
        rschema = ref_make_schema(ref_oids)
        rdec = RefDecoder(rschema, mesh=None, device_min_rows=0)
        dec = _cpu(port_schema(rschema))
        batches = [_rows(150, k * 300) for k in range(3)]
        rpipe = RefDecodePipeline(window=2)
        pipe = DecodePipeline(window=2)
        try:
            rh = [rpipe.submit(rdec, ref_staged(r, len(OIDS)))
                  for r in batches]
            ph = [pipe.submit(dec, port_staged(ref_staged(r, len(OIDS))))
                  for r in batches]
            for a, b in zip(rh, ph):
                assert_same_batch(a.result(), b.result())
        finally:
            rpipe.close()
            pipe.close()

    def test_result_is_idempotent(self):
        dec = _cpu(make_schema([Oid.INT4]))
        pipe = DecodePipeline(window=2)
        try:
            h = pipe.submit(dec, _stage([["7"]] * 100))
            assert h.result() is h.result()
        finally:
            pipe.close()

    def test_oracle_route_through_pipeline(self):
        # a batch under device_min_rows routes to the per-row oracle: no
        # window slot, no stage work, same output as serial decode
        dec = DeviceDecoder(make_schema(OIDS), device="cpu")
        rows = _rows(dec.device_min_rows - 1)
        pipe = DecodePipeline(window=2)
        try:
            batch = pipe.submit(dec, _stage(rows)).result()
            assert_same_batch(dec.decode(_stage(rows)), batch)
            assert pipe.in_flight == 0
        finally:
            pipe.close()

    def test_submit_after_close_raises(self):
        pipe = DecodePipeline(window=1)
        pipe.close()
        with pytest.raises(RuntimeError):
            pipe.submit(_cpu(make_schema([Oid.INT4])), _stage([["1"]]))

    def test_cpu_decoder_dispatches_on_no_stream(self):
        """A CPU decoder's batches take no CUDA stream: the pipeline
        creates none, and each pending decode records none."""
        dec = _cpu(make_schema([Oid.INT4]))
        pipe = DecodePipeline(window=2)
        try:
            h = pipe.submit(dec, _stage([["1"]] * 80))
            h.result()
            assert h._future.result()[0].stream is None
            assert pipe.streams == {}
        finally:
            pipe.close()


class TestMultipleInFlight:
    def test_results_in_submit_order(self):
        """Drained in submit order, every handle holds its own batch."""
        dec = _cpu(make_schema([Oid.INT4, Oid.TEXT]))
        pipe = DecodePipeline(window=2)
        try:
            handles = [pipe.submit(dec, _stage(
                [[str(k * 1000 + i), f"k{k}"] for i in range(100)]))
                for k in range(6)]
            for k, h in enumerate(handles):
                b = h.result()
                assert b.columns[0].data[0] == k * 1000
                assert b.columns[1].value(99) == f"k{k}"
            assert pipe.stats()["completed"] == 6
        finally:
            pipe.close()

    def test_out_of_order_results(self):
        dec = _cpu(make_schema(OIDS))
        batches = [_rows(150, k * 500) for k in range(3)]
        expected = [dec.decode(_stage(r)) for r in batches]
        pipe = DecodePipeline(window=3)
        try:
            handles = [pipe.submit(dec, _stage(r)) for r in batches]
            for h, e in zip(reversed(handles), reversed(expected)):
                assert_same_batch(e, h.result())
        finally:
            pipe.close()

    def test_out_of_order_with_window_one_no_deadlock(self):
        """window=1 and the consumer demands the SECOND batch first — the
        worker must overshoot the window instead of deadlocking."""
        dec = _cpu(make_schema([Oid.INT4]))
        pipe = DecodePipeline(window=1)
        try:
            h1 = pipe.submit(dec, _stage([[str(i)] for i in range(100)]))
            h2 = pipe.submit(dec, _stage([[str(i + 500)]
                                          for i in range(100)]))
            assert h2.result().columns[0].data[3] == 503
            assert h1.result().columns[0].data[3] == 3
        finally:
            pipe.close()

    def test_serial_decode_async_out_of_order(self):
        dec = _cpu(make_schema([Oid.INT4, Oid.TEXT]))
        p1 = dec.decode_async(_stage([[str(i), f"a{i}"] for i in range(64)]))
        p2 = dec.decode_async(_stage([[str(i + 90), f"b{i}"]
                                      for i in range(64)]))
        b2 = p2.result()
        b1 = p1.result()
        assert b1.columns[0].data[5] == 5
        assert b2.columns[0].data[5] == 95
        assert b2.columns[1].value(5) == "b5"

    def test_fallback_fixup_with_second_batch_in_flight(self):
        """Batch 1 carries CPU-fallback rows (BC date, 17-digit float);
        batch 2 dispatches before batch 1 resolves. The oracle fixup of
        batch 1 patches exactly its own rows."""
        oids = [Oid.FLOAT8, Oid.DATE]
        rows1 = [[f"{i}.5", "2024-01-02"] for i in range(120)]
        rows1[7] = ["0.12345678901234567", "0044-03-15 BC"]
        rows2 = [[f"{i}.25", "2023-06-15"] for i in range(120)]
        dec = _cpu(make_schema(oids))
        oracle = DeviceDecoder(make_schema(oids), device="cpu",
                               device_min_rows=10**9)
        pipe = DecodePipeline(window=2)
        try:
            h1 = pipe.submit(dec, _stage(rows1))
            h2 = pipe.submit(dec, _stage(rows2))
            assert_same_batch(oracle.decode(_stage(rows2)), h2.result())
            assert_same_batch(oracle.decode(_stage(rows1)), h1.result())
        finally:
            pipe.close()

    def test_overlap_recorded(self):
        """Pack of batch N+1 concurrent with batch N in flight shows up in
        the pipeline's overlap accounting. The consumer starts draining
        once the window is full (on the CPU the plain versions run inside
        the dispatch, so a consumer draining at once could finish each
        batch before the worker packs the next)."""
        dec = _cpu(make_schema(OIDS))
        pipe = DecodePipeline(window=3)
        try:
            handles = [pipe.submit(dec, _stage(_rows(400, k * 400)))
                       for k in range(6)]
            deadline = time.monotonic() + 30
            while pipe.in_flight < 3 and time.monotonic() < deadline:
                time.sleep(0.01)
            for h in handles:
                h.result()
            stats = pipe.stats()
            assert stats["completed"] == 6
            assert stats["pack_seconds_total"] > 0
            assert stats["overlap_seconds_total"] > 0
            assert set(stats) >= {"submitted", "completed", "in_flight",
                                  "window", "overlap_ratio", "arena"}
        finally:
            pipe.close()

    def test_failed_fetch_is_permanent(self):
        dec = _cpu(make_schema([Oid.INT4]))
        pipe = DecodePipeline(window=2)
        try:
            # out-of-range INT4: the device flags the row, the oracle
            # fixup raises a typed error at completion (the fetch stage)
            h = pipe.submit(dec, _stage([["99999999999"], ["5"]] * 50))
            with pytest.raises(EtlError) as first:
                h.result()
            with pytest.raises(EtlError) as second:
                h.result()
            assert second.value is first.value
        finally:
            pipe.close()

    def test_close_with_abandoned_handles_does_not_leak_worker(self):
        dec = _cpu(make_schema(OIDS))
        pipe = DecodePipeline(window=1)
        handles = [pipe.submit(dec, _stage(_rows(120, k * 200)))
                   for k in range(5)]
        pipe.close()  # nobody ever calls result()
        pipe.join(timeout=30)
        assert not pipe.worker_alive
        outcomes = []
        for h in handles:
            try:
                outcomes.append(h.result() is not None)
            except RuntimeError:
                outcomes.append("closed")
        assert all(o is True or o == "closed" for o in outcomes)

    def test_error_delivered_at_result(self):
        dec = _cpu(make_schema([Oid.INT4]))
        pipe = DecodePipeline(window=2)
        try:
            h = pipe.submit(dec, _stage([["1", "x"]]))  # 2 cols vs 1
            with pytest.raises(ValueError):
                h.result()
            ok = pipe.submit(dec, _stage([["5"]] * 80)).result()
            assert ok.columns[0].data[0] == 5
        finally:
            pipe.close()

    def test_dispatch_failure_fails_the_batch(self):
        """A batch whose dispatch fails raises at its result(); the
        pipeline does not decode it on the oracle instead."""
        dec = _cpu(make_schema([Oid.INT4]))
        pipe = DecodePipeline(window=2)
        failpoints.arm_error(failpoints.PIPELINE_DISPATCH)
        try:
            h = pipe.submit(dec, _stage([["5"]] * 80))
            with pytest.raises(EtlError):
                h.result()
            assert pipe.in_flight == 0
        finally:
            failpoints.disarm_all()
            pipe.close()

    @pytest.mark.filterwarnings(
        "ignore::pytest.PytestUnhandledThreadExceptionWarning")
    def test_dead_worker_fails_pending_results(self):
        """A worker that dies outside its per-batch handler fails the
        results still pending on it instead of hanging their consumer."""
        dec = _cpu(make_schema([Oid.INT4]))
        pipe = DecodePipeline(window=2)
        pipe._jobs.put(("not a job",))  # unpacking it kills the worker
        pipe.join(timeout=10)
        assert not pipe.worker_alive
        h = pipe.submit(dec, _stage([["5"]] * 80))
        with pytest.raises(RuntimeError, match="worker"):
            h.result()
        pipe.close()

    def test_two_pipelines_share_one_admission_seat(self):
        """Two pipelines on one AdmissionScheduler(1): both complete, each
        output identical to serial decode; after close() no worker is
        left, nothing is in flight and the tenants are gone."""
        sched = AdmissionScheduler(1)
        dec = _cpu(make_schema(OIDS))
        fdec = _cpu(_filtered_schema())
        pipes = [DecodePipeline(window=2, name=f"t{k}",
                                admission=sched.register(f"t{k}"))
                 for k in range(2)]
        try:
            ha = [pipes[0].submit(dec, _stage(_rows(130, k * 130)))
                  for k in range(3)]
            hb = [pipes[1].submit(fdec, _pgbench_staged(200, k))
                  for k in range(3)]
            for k, h in enumerate(ha):
                assert_same_batch(dec.decode(_stage(_rows(130, k * 130))),
                                  h.result())
            for k, h in enumerate(hb):
                assert bench.filtered_batches_identical(
                    h.result(), fdec.decode(_pgbench_staged(200, k)))
            assert all(t["grants"] == 3
                       for t in sched.stats()["tenants"].values())
        finally:
            for p in pipes:
                p.close()
        for p in pipes:
            p.join(timeout=10)
            assert not p.worker_alive
            assert p.in_flight == 0
        assert sched.in_flight == 0
        assert sched.stats()["tenants"] == {}


class TestStagingArenas:
    def test_reuse_round_trip(self):
        pool = StagingArenaPool(max_per_bucket=2)
        lease = pool.lease()
        a = lease.take((64, 32), torch.uint8)
        lease.release()
        lease2 = pool.lease()
        b = lease2.take((64, 32), torch.uint8)
        assert b is a  # the same buffer came back
        c = lease2.take((64, 32), torch.uint8)
        assert c is not a
        lease2.release()
        assert pool.stats()["free_arrays"] == 2
        assert pool.stats()["outstanding"] == 0

    def test_pool_bound(self):
        pool = StagingArenaPool(max_per_bucket=1)
        leases = [pool.lease() for _ in range(3)]
        for lease in leases:
            lease.take((8, 8), torch.uint8)
        for lease in leases:
            lease.release()
        assert pool.stats()["free_arrays"] == 1  # excess dropped

    def test_pipeline_reuses_arenas(self):
        from etl_tpu_torch.telemetry.metrics import (
            ETL_STAGING_ARENA_REQUESTS_TOTAL, registry)

        pool = StagingArenaPool()
        dec = _cpu(make_schema([Oid.INT4]))
        pipe = DecodePipeline(window=1, arena_pool=pool)
        hits0 = registry.get_counter(ETL_STAGING_ARENA_REQUESTS_TOTAL,
                                     {"result": "hit"})
        try:
            for k in range(3):
                pipe.submit(dec, _stage([[str(i + k)] for i in
                                         range(100)])).result()
        finally:
            pipe.close()
        hits1 = registry.get_counter(ETL_STAGING_ARENA_REQUESTS_TOTAL,
                                     {"result": "hit"})
        assert hits1 > hits0
        assert pool.stats()["outstanding"] == 0

    def test_dirty_arena_cannot_leak_between_batches(self):
        dec = _cpu(make_schema([Oid.INT8]))
        pool = StagingArenaPool()
        pipe = DecodePipeline(window=1, arena_pool=pool)
        try:
            wide = [[str(10**17 + i)] for i in range(100)]  # 18 digits
            short = [[str(i)] for i in range(100)]
            assert_same_batch(dec.decode(_stage(wide)),
                              pipe.submit(dec, _stage(wide)).result())
            assert_same_batch(dec.decode(_stage(short)),
                              pipe.submit(dec, _stage(short)).result())
        finally:
            pipe.close()

    def test_arena_pool_two_threads(self):
        """Threads (two per core and more, the interpreter switching
        every microsecond) lease, hold and release buffers of one shape
        at once: no buffer is ever held by two, and every buffer
        returns."""
        pool = StagingArenaPool(max_per_bucket=2)
        held: dict[int, str] = {}
        guard = threading.Lock()
        errors: list[str] = []

        def run(name):
            for _ in range(300):
                with pool.lease() as lease:
                    ts = [lease.take((16, 8), torch.uint8)
                          for _ in range(2)]
                    with guard:
                        for t in ts:
                            if id(t) in held:
                                errors.append(f"{name} got a held buffer")
                            held[id(t)] = name
                    time.sleep(0)
                    with guard:
                        for t in ts:
                            held.pop(id(t), None)

        threads = [threading.Thread(target=run, args=(str(n),))
                   for n in range(2 * (os.cpu_count() or 1) + 2)]
        interval = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            for t in threads:
                t.start()
            for t in threads:
                t.join(60)
        finally:
            sys.setswitchinterval(interval)
        assert not any(t.is_alive() for t in threads)
        assert errors == []
        assert pool.stats()["outstanding"] == 0
        assert pool.stats()["free_arrays"] <= 2  # the pool's bound

    def test_pinned_pool_two_threads(self):
        """The decoder's pinned pool, taken on one thread and given back
        on another (the pipeline's worker and its consumer): no buffer is
        handed out twice and none is lost. Pre-seeded with host tensors,
        so no take needs a pinned allocation here."""
        pool = engine_mod._PinnedPool(max_per_key=16)
        seed = [torch.empty(4, dtype=torch.int32) for _ in range(16)]
        pool.give_back(seed)
        handoff: list = []
        cond = threading.Condition()
        seen: set = set()
        errors: list[str] = []
        n = 400

        def taker():
            for _ in range(n):
                with cond:
                    cond.wait_for(lambda: len(handoff) < 8)
                t = pool.take((4,), torch.int32)
                with cond:
                    if id(t) in seen:
                        errors.append("a buffer handed out twice")
                    seen.add(id(t))
                    handoff.append(t)
                    cond.notify_all()

        def giver():
            for _ in range(n):
                with cond:
                    cond.wait_for(lambda: handoff)
                    t = handoff.pop(0)
                    seen.discard(id(t))
                    cond.notify_all()
                pool.give_back([t])

        threads = [threading.Thread(target=taker),
                   threading.Thread(target=giver)]
        interval = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            for t in threads:
                t.start()
            for t in threads:
                t.join(60)
        finally:
            sys.setswitchinterval(interval)
        assert not any(t.is_alive() for t in threads)
        assert errors == []
        assert sorted(map(id, pool._free[((4,), torch.int32)])) \
            == sorted(map(id, seed))


class TestInFlightWindow:
    def test_limit_enforced_and_released(self):
        w = InFlightWindow(2)
        w.acquire()
        w.acquire()
        assert len(w) == 2
        acquired = threading.Event()

        def third():
            w.acquire()
            acquired.set()

        t = threading.Thread(target=third, daemon=True)
        t.start()
        time.sleep(0.05)
        assert not acquired.is_set()  # blocked at the limit
        w.release()
        assert acquired.wait(2.0)
        t.join(2.0)

    def test_pressure_shrinks_to_one(self):
        monitor = types.SimpleNamespace(pressure=True)
        w = InFlightWindow(4, monitor)
        assert w.effective_limit == 1
        monitor.pressure = False
        assert w.effective_limit == 4

    def test_bypass_overrides_limit(self):
        w = InFlightWindow(1)
        w.acquire()
        w.acquire(bypass=lambda: True)  # liveness valve: overshoot
        assert len(w) == 2

    def test_rejects_zero_limit(self):
        with pytest.raises(ValueError):
            InFlightWindow(0)

    def test_pipeline_window_bounds_in_flight(self):
        """A consumer that drains nothing leaves at most `window` batches
        dispatched; the rest wait undispatched on the worker."""
        dec = _cpu(make_schema([Oid.INT4]))
        pipe = DecodePipeline(window=2)
        try:
            handles = [pipe.submit(dec, _stage([[str(i)] for i in
                                                range(80)]))
                       for _ in range(5)]
            deadline = time.monotonic() + 10
            while pipe.in_flight < 2 and time.monotonic() < deadline:
                time.sleep(0.01)
            time.sleep(0.1)
            assert pipe.in_flight == 2
            for h in handles:
                h.result()
            assert pipe.in_flight == 0
        finally:
            pipe.close()


def test_reference_stage_helper_agrees():
    """The staging this file uses is the reference's, value for value."""
    rows = _rows(70)
    a = _stage(rows)
    b = port_staged(ref_stage_tuples(
        _tuples_ref(rows), len(rows[0])))
    for f in ("offsets", "lengths", "nulls", "toast"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert a.data.tobytes() == b.data.tobytes()


def _tuples_ref(rows):
    from etl_tpu.postgres.codec.pgoutput import TupleData as RefTupleData

    return [RefTupleData([TUPLE_NULL if v is None else TUPLE_TEXT
                          for v in r],
                         [None if v is None else v.encode() for v in r])
            for r in rows]
