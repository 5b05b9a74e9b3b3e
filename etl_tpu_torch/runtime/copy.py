"""Parallel table copy: CTID-range partitioning + shared work queue.

Reference parity: crates/etl/src/replication/table_sync/copy.rs —
plan `max(partitions_per_connection × connections, rows / rows_per_partition)`
clamped to `max_partitions` (copy.rs:54-58,132-161); largest-range-first
scheduling (copy.rs:541); N child connections sharing the exported snapshot
(copy.rs:346-363) drain a shared queue (copy.rs:572-607); per-partition
batched stream → `write_table_rows` (copy.rs:641-694).

Each partition's COPY chunks go through the vectorized staging scan +
device decode (`batch_engine=cuda`: one `DecodePipeline` per partition, a
worker thread with a CUDA stream of its own) or the CPU oracle, producing
ColumnarBatches for the destination.

Copy of the reference's `etl_tpu/runtime/copy.py`. Under supervision each
partition's decode pipeline beats a `decode:copy:<table>:p<page>`
heartbeat from its worker thread, and the owning table-sync worker's
heartbeat follows the bytes and rows copied.
"""

from __future__ import annotations

import asyncio
from dataclasses import dataclass

from ..analysis.annotations import flush_path
from ..config.pipeline import BatchEngine, PipelineConfig
from ..models.errors import ErrorKind, EtlError
from ..models.schema import ReplicatedTableSchema, TableId
from ..models.table_row import ColumnarBatch
from ..ops.engine import DeviceDecoder
from ..ops.pipeline import WORKER_JOIN_S, DecodePipeline
from ..ops.staging import stage_copy_chunk
from ..postgres.codec.copy_text import parse_copy_chunk_columns
from ..postgres.source import ReplicationSource
from ..destinations.base import Destination, egress_encoder
from .ack_window import CopyAckWindow
from ..telemetry.egress import record_egress
from ..telemetry.metrics import (ETL_TABLE_COPY_BYTES_TOTAL,
                                 ETL_TABLE_COPY_DURATION_SECONDS,
                                 ETL_TABLE_COPY_ROWS_TOTAL, registry)
from . import failpoints
from .shutdown import ShutdownRequested, ShutdownSignal, or_shutdown


@dataclass(frozen=True)
class CopyPartition:
    """A CTID page range [start_page, end_page); end None = to table end.
    `relation_id` is the physical relation to COPY (a leaf partition when
    the published table is partitioned; None = the table itself)."""

    start_page: int
    end_page: int | None
    estimated_rows: int
    relation_id: "TableId | None" = None


@dataclass
class CopyProgress:
    total_rows: int = 0
    partitions_done: int = 0
    bytes_written: int = 0  # monotonic COPY text total across ALL partitions


def plan_copy_partitions(estimated_rows: int, heap_pages: int,
                         config: PipelineConfig) -> list[CopyPartition]:
    """Reference planning math (copy.rs:54-58,457-547)."""
    c = config.table_sync_copy
    if estimated_rows <= 0 or heap_pages <= 0:
        return [CopyPartition(0, None, max(0, estimated_rows))]
    want = max(c.partitions_per_connection * c.max_connections,
               estimated_rows // max(1, c.rows_per_partition_target))
    n = int(min(max(1, want), c.max_partitions, heap_pages))
    pages_per = heap_pages // n
    extra = heap_pages % n
    parts: list[CopyPartition] = []
    page = 0
    for i in range(n):
        span = pages_per + (1 if i < extra else 0)
        end = page + span
        parts.append(CopyPartition(
            page, None if i == n - 1 else end,
            estimated_rows * span // heap_pages))
        page = end
    # largest-first so stragglers start early (copy.rs:541)
    parts.sort(key=lambda p: -p.estimated_rows)
    return parts


@flush_path
async def _copy_partition(source: ReplicationSource,
                          schema: ReplicatedTableSchema, snapshot_id: str,
                          publication: str, part: CopyPartition,
                          decoder: DeviceDecoder | None,
                          destination: Destination,
                          progress: CopyProgress,
                          max_batch_bytes: int, monitor=None,
                          lease=None, pipeline_id: int = 0,
                          decode_window: int = 3, heartbeat=None,
                          supervisor=None,
                          admission_capacity: int = 0,
                          write_window: int = 4) -> None:
    failpoints.fail_point(failpoints.COPY_PARTITION_START)
    # chaos stall mode: a copy partition that wedges before reading any
    # data — recovered by the watchdog restarting the table-sync worker
    await failpoints.stall_point(failpoints.COPY_PARTITION_START)
    rng = None if part.end_page is None and part.start_page == 0 \
        else (part.start_page, part.end_page if part.end_page is not None
              else 1 << 30)
    if part.relation_id is not None and part.relation_id != schema.id:
        stream = await source.copy_table_stream(
            part.relation_id, publication, snapshot_id, ctid_range=rng,
            publication_table_id=schema.id)
    else:
        stream = await source.copy_table_stream(
            schema.id, publication, snapshot_id, ctid_range=rng)
    oids = [c.type_oid for c in schema.replicated_columns]
    # chunk list + running length, joined once per flush: `pending += raw`
    # re-copies the accumulated buffer per 43 KB stream chunk — O(n²)
    # toward an 8 MB threshold, measured 0.7s/85MB on the copy bench
    pending: list[bytes] = []
    pending_len = 0
    # bounded ack window (runtime/ack_window.py): the old `acks` list
    # accumulated EVERY batch's unresolved ack until end-of-copy — a
    # huge table held unbounded pending acks and surfaced a failed ack
    # only at the partition barrier. The window caps outstanding acks
    # (shrinking to 1 under memory pressure) and awaits the OLDEST
    # first, so per-partition ordering is preserved and errors surface
    # within `write_window` batches.
    acks = CopyAckWindow(
        write_window,
        pressure=(lambda: monitor.pressure) if monitor is not None
        else None)
    # three-stage decode pipeline (ops/pipeline.py): chunk N+1 packs on
    # the pipeline's worker thread into a pooled arena while chunk N
    # computes on the device and N-1 streams back — this partition keeps
    # reading COPY data the whole time. One pipeline PER partition: each
    # partition drains only its own handles in order, so a shared window
    # could never be exhausted by another partition's undispatched work
    # (the cross-partition deadlock the per-partition worker rules out).
    in_flight: list = []
    # name carries the partition identity so concurrent partitions get
    # distinct gauge series instead of last-writer-winning one label
    pipe_hb = None
    if supervisor is not None and decoder is not None:
        from ..supervision import DECODE_PREFIX

        pipe_hb = supervisor.register(
            f"{DECODE_PREFIX}copy:{schema.id}:p{part.start_page}")
    pipe = None
    if decoder is not None:
        # every copy partition is one tenant on the process-wide
        # admission scheduler: backfill batches contend fairly with the
        # CDC streams' (lag-weighted — lag 0 here, so a lagging CDC
        # tenant outranks bulk backfill) and the shared capacity caps
        # how many partition batches sit on the device at once
        from ..ops.pipeline import global_admission

        admission = global_admission(admission_capacity or None).register(
            f"copy:{schema.id}:p{part.start_page}", monitor=monitor)
        pipe = DecodePipeline(window=decode_window, monitor=monitor,
                              name=f"copy-p{part.start_page}",
                              heartbeat=pipe_hb, admission=admission)

    async def drain_one() -> None:
        handle = in_flight.pop(0)
        # fetch on a thread: the event loop keeps serving the OTHER copy
        # partitions while this one waits out its device round trip
        batch = await asyncio.to_thread(handle.result)
        # columnar write seam: the decoded batch goes to the destination
        # AS a batch (Arrow/proto/TSV encoders consume it column-wise);
        # row-oriented destinations fall back via the base-class shim
        await acks.add(await destination.write_table_batch(schema, batch))
        progress.total_rows += batch.num_rows
        if heartbeat is not None:
            heartbeat.beat(progress=("copy_rows", progress.total_rows),
                           busy=True)
        registry.counter_inc(ETL_TABLE_COPY_ROWS_TOTAL, batch.num_rows)

    # per-PARTITION byte counter: progress.bytes_written is shared across
    # concurrently copying partitions, so attributing egress from it would
    # let whichever partition finishes first claim everyone's bytes —
    # the shared counter stays a monotonic total
    partition_bytes = 0

    async def write_chunk(chunk: bytes) -> None:
        nonlocal partition_bytes
        if not chunk:
            return
        failpoints.fail_point(failpoints.DURING_COPY)
        progress.bytes_written += len(chunk)
        partition_bytes += len(chunk)
        if heartbeat is not None:
            # the owning table-sync worker's liveness: bytes copied IS
            # the progress token; a frozen counter mid-copy is a stall
            heartbeat.beat(progress=("copy_bytes", progress.bytes_written),
                           busy=True)
        registry.counter_inc(ETL_TABLE_COPY_BYTES_TOTAL, len(chunk))
        if decoder is not None:
            staged = stage_copy_chunk(chunk, len(oids))
            in_flight.append(pipe.submit(decoder, staged))
            # drain ahead of the window so the destination write overlaps
            # the pipeline instead of bunching at end-of-stream; the
            # effective window shrinks to 1 under memory pressure, which
            # drains eagerly and degrades the pipeline to serial decode
            while len(in_flight) > pipe.effective_window:
                await drain_one()
            return
        # CPU oracle path: parse the chunk straight into columns — no
        # TableRow objects, no from_rows re-transpose (the old row
        # round-trip masked the real parse cost in profiles)
        cells, n_rows = parse_copy_chunk_columns(chunk, oids)
        batch = ColumnarBatch.from_cells(schema, cells, n_rows)
        await acks.add(await destination.write_table_batch(schema, batch))
        progress.total_rows += batch.num_rows
        registry.counter_inc(ETL_TABLE_COPY_ROWS_TOTAL, batch.num_rows)

    try:
        async for raw in stream:
            if monitor is not None and monitor.pressure:
                # stop pulling COPY data under memory pressure; the
                # server-side cursor waits (reference
                # TryBatchBackpressureStream pause)
                await monitor.wait_until_resumed()
            pending.append(raw)
            pending_len += len(raw)
            # budget-aware chunking: the per-stream share shrinks when many
            # partitions copy concurrently (batch_budget.rs:72-96)
            threshold = max_batch_bytes if lease is None \
                else min(max_batch_bytes, lease.ideal_batch_bytes())
            if pending_len >= threshold:
                buf = b"".join(pending)
                cut = buf.rfind(b"\n") + 1
                await write_chunk(buf[:cut])
                pending = [buf[cut:]] if cut < len(buf) else []
                pending_len = len(buf) - cut
        await write_chunk(b"".join(pending))
        while in_flight:
            await drain_one()
        if heartbeat is not None:
            # the chunk beats carry busy=True; without this the LAST
            # chunk's frozen byte count reads as a stall while the
            # worker legitimately sits in the durability barrier / park
            heartbeat.beat(busy=False)
    finally:
        if pipe is not None:
            pipe.close()
            # a bounded wait for the worker, off the event loop: the
            # partition ends with no decode thread left behind
            await asyncio.to_thread(pipe.join, WORKER_JOIN_S)
    # durability barrier for this partition (mod.rs:360-378): the window
    # owns the waits (etl-lint rule 17) — drain what is still pending
    await acks.drain()
    # chaos site: the window between a partition's durability barrier and
    # its progress accounting — a crash here must recopy consistently
    failpoints.fail_point(failpoints.COPY_PARTITION_END)
    if partition_bytes:
        record_egress(pipeline_id=pipeline_id,
                      destination=getattr(destination, "telemetry_name",
                                          type(destination).__name__),
                      bytes_processed=partition_bytes,
                      kind="table_copy")
    progress.partitions_done += 1


async def parallel_table_copy(*, source_factory, primary_source,
                              schema: ReplicatedTableSchema,
                              snapshot_id: str, config: PipelineConfig,
                              destination: Destination,
                              shutdown: ShutdownSignal, monitor=None,
                              budget=None, heartbeat=None,
                              supervisor=None) -> CopyProgress:
    """Copy one table through N snapshot-sharing connections."""
    leaves = await primary_source.get_partition_leaves(schema.id)
    if leaves:
        # partitioned root: plan per leaf, weighted by each leaf's stats
        # (reference copy.rs:457-547); CTID ranges are per physical
        # relation, so page math never spans leaves
        parts = []
        for leaf_id, est_rows, heap_pages in leaves:
            for p in plan_copy_partitions(est_rows, heap_pages, config):
                parts.append(CopyPartition(p.start_page, p.end_page,
                                           p.estimated_rows, leaf_id))
        parts.sort(key=lambda p: -p.estimated_rows)
    else:
        est_rows, heap_pages = \
            await primary_source.estimate_table_stats(schema.id)
        parts = plan_copy_partitions(est_rows, heap_pages, config)
    n_conns = min(config.table_sync_copy.max_connections, len(parts))
    # one decoder for every partition of the table: its pinned pool and
    # the kernel's caches are shared across the partitions' worker
    # threads under their locks
    decoder = DeviceDecoder(schema, device=config.batch.device,
                            egress=egress_encoder(config, destination)) \
        if config.batch.batch_engine is BatchEngine.CUDA else None
    progress = CopyProgress()
    queue: asyncio.Queue[CopyPartition] = asyncio.Queue()
    for p in parts:
        queue.put_nowait(p)

    async def worker(use_primary: bool) -> None:
        src = primary_source if use_primary else source_factory()
        if not use_primary:
            await src.connect()
        lease = budget.register_stream() if budget is not None else None
        try:
            while True:
                try:
                    part = queue.get_nowait()
                except asyncio.QueueEmpty:
                    return
                await or_shutdown(shutdown, _copy_partition(
                    src, schema, snapshot_id, config.publication_name, part,
                    decoder, destination, progress,
                    config.batch.max_size_bytes, monitor=monitor,
                    lease=lease, pipeline_id=config.pipeline_id,
                    decode_window=config.batch.decode_window,
                    heartbeat=heartbeat, supervisor=supervisor,
                    admission_capacity=config.batch.admission_capacity,
                    write_window=config.batch.write_window))
        finally:
            if lease is not None:
                lease.release()
            if not use_primary:
                await src.close()

    import time as _time

    _t0 = _time.perf_counter()
    tasks = [asyncio.ensure_future(worker(i == 0)) for i in range(n_conns)]
    results = await asyncio.gather(*tasks, return_exceptions=True)
    errors = [r for r in results if isinstance(r, BaseException)]
    if errors:
        for r in errors:
            if isinstance(r, ShutdownRequested):
                raise r
        first = errors[0]
        raise first if isinstance(first, EtlError) else EtlError(
            ErrorKind.SOURCE_IO, f"copy failed: {first!r}")
    # completed copies only: failed/aborted attempts would skew the
    # duration distribution low
    registry.histogram_observe(ETL_TABLE_COPY_DURATION_SECONDS,
                               _time.perf_counter() - _t0)
    return progress
