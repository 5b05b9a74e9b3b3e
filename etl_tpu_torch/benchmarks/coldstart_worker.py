"""Coldstart measurement worker: one replicator lifetime as a subprocess.

    python -m etl_tpu_torch.benchmarks.coldstart_worker --cache-dir DIR
        [--tables 3] [--rows-per-tx 800] [--txs-per-table 2]
        [--device cuda|cpu]

`python -m etl_tpu_torch.bench --coldstart` (harness.run_coldstart) runs
this module twice against one program-cache directory: the first run is
the COLD start (the libraries are built: nvcc for the kernels, the C
compiler for the packers), the second the WARM restart (Pipeline.start's
prewarm loads them from the directory). Port of the reference's
`etl_tpu/benchmarks/coldstart_worker.py`; the pipeline decodes with
`BatchEngine.CUDA` on `device` ("cuda", the card, unless the caller asks
for "cpu", where the kernels' plain versions run). Each run prints one
JSON line:

  start_seconds            Pipeline.start wall clock (prewarm and any
                           build included)
  first_durable_seconds    start() begin → first rows durable at the
                           destination (restart-to-first-durable-batch)
  total_seconds            start() begin → full workload delivered
  programs_compiled        etl_programs_compiled_total: compiler runs
                           (the gate: a warm restart must report 0)
  nvcc_seconds             the kernel libraries' build seconds
  cache_hits_disk/memory, cache_misses_absent/invalid
  oracle_rows/host_rows/device_rows   decode routing during the run
  device_batches, k1_launches         device-routed batches and K1's
                           launches (equal on the card)
  layouts_by_route         per route, the distinct canonical layouts the
                           tables' batches took (N tables → 1)

The tables share one canonical layout under rotated column orders.
Schemas are stored in the state store before start — the store state a
real restart inherits.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import time

#: covers every row bucket a paced flush can stage into; the emitted
#: `prewarm_buckets` count bounds the cold run's builds
PREWARM_BUCKETS = (256, 1024, 4096)
#: the reference's kind mix, rotated per table
KIND_NAMES = ("INT8", "INT4", "FLOAT8", "INT4", "TIMESTAMP", "INT8",
              "NUMERIC", "INT4")
BASE_TID = 17000


def row_values(t: int, i: int) -> list:
    """Row `i` of table `t`'s payload: the id, then the reference's values
    rotated with the table's kinds."""
    row = [str(i).encode(), b"7", b"1.5", b"9", b"2026-01-01 00:00:00",
           b"42", b"3.14", b"11"]
    r = t % len(row)
    return [str(i).encode()] + row[r:] + row[:r]


async def run(cache_dir: str, n_tables: int, rows_per_tx: int,
              txs_per_table: int, device: str = "cuda") -> dict:
    from ..config import BatchConfig, BatchEngine, PipelineConfig
    from ..destinations.base import Destination, WriteAck
    from ..models import (ColumnSchema, Oid, ReplicatedTableSchema,
                          TableName, TableSchema)
    from ..models.event import DecodedBatchEvent
    from ..models.table_state import TableStateType
    from ..ops import decode_kernel, engine, program_store
    from ..postgres.codec.pgoutput import encode_insert
    from ..postgres.fake import FakeDatabase, FakeSource
    from ..runtime import Pipeline
    from ..store import NotifyingStore
    from ..telemetry.metrics import (
        ETL_COMPILE_CACHE_HITS_TOTAL, ETL_COMPILE_CACHE_MISSES_TOTAL,
        ETL_DECODE_CANONICAL_LAYOUTS, ETL_DECODE_ROUTED_DEVICE_ROWS_TOTAL,
        ETL_DECODE_ROUTED_HOST_ROWS_TOTAL,
        ETL_DECODE_ROUTED_ORACLE_ROWS_TOTAL, ETL_PROGRAMS_COMPILED_TOTAL,
        registry)

    kinds = [getattr(Oid, k) for k in KIND_NAMES]
    db = FakeDatabase()
    tids = []
    for t in range(n_tables):
        tid = BASE_TID + t
        rot = kinds[t % len(kinds):] + kinds[: t % len(kinds)]
        cols = [ColumnSchema("id", Oid.INT8, nullable=False,
                             primary_key_ordinal=1)]
        cols += [ColumnSchema(f"c{i}", o) for i, o in enumerate(rot)]
        db.create_table(TableSchema(tid, TableName("public", f"cold_{t}"),
                                    tuple(cols)))
        tids.append(tid)
    db.create_publication("pub", tids)

    store = NotifyingStore()
    # the restart contract: schemas already live in the SchemaStore (a
    # real store survives the process), so prewarm has layouts to warm
    for tid in tids:
        await store.store_table_schema(
            ReplicatedTableSchema.with_all_columns(db.tables[tid].schema), 0)

    delivered = [0]
    first_durable = [None]
    t0 = time.perf_counter()

    class CountingDestination(Destination):
        async def startup(self):
            return None

        async def write_table_rows(self, schema, batch):
            return WriteAck.durable()

        async def write_events(self, events):
            for e in events:
                if isinstance(e, DecodedBatchEvent):
                    delivered[0] += e.batch.num_rows
            if delivered[0] and first_durable[0] is None:
                first_durable[0] = time.perf_counter() - t0
            return WriteAck.durable()

        async def drop_table(self, table_id, schema=None):
            return None

        async def truncate_table(self, table_id):
            return None

    def counters() -> dict:
        c = registry.get_counter
        return {
            "programs_compiled": c(ETL_PROGRAMS_COMPILED_TOTAL),
            "cache_hits_disk": c(ETL_COMPILE_CACHE_HITS_TOTAL,
                                 {"layer": "disk"}),
            "cache_hits_memory": c(ETL_COMPILE_CACHE_HITS_TOTAL,
                                   {"layer": "memory"}),
            "cache_misses_absent": c(ETL_COMPILE_CACHE_MISSES_TOTAL,
                                     {"reason": "absent"}),
            "cache_misses_invalid": c(ETL_COMPILE_CACHE_MISSES_TOTAL,
                                      {"reason": "invalid"}),
            "oracle_rows": c(ETL_DECODE_ROUTED_ORACLE_ROWS_TOTAL),
            "host_rows": c(ETL_DECODE_ROUTED_HOST_ROWS_TOTAL),
            "device_rows": c(ETL_DECODE_ROUTED_DEVICE_ROWS_TOTAL),
            "device_batches": engine.routed_device_batches,
            "host_batches": engine.routed_host_batches,
            "oracle_batches": engine.routed_oracle_batches,
            "k1_launches": decode_kernel.launches,
        }

    pipeline = Pipeline(
        config=PipelineConfig(
            pipeline_id=1, publication_name="pub",
            batch=BatchConfig(max_fill_ms=30,
                              batch_engine=BatchEngine.CUDA, device=device,
                              program_cache_dir=cache_dir,
                              prewarm_row_buckets=PREWARM_BUCKETS)),
        store=store, destination=CountingDestination(),
        source_factory=lambda: FakeSource(db))
    await pipeline.start()
    start_seconds = time.perf_counter() - t0
    for tid in tids:
        await asyncio.wait_for(
            store.notify_on(tid, TableStateType.READY), 60)

    total = 0
    for _ in range(txs_per_table):
        for t, tid in enumerate(tids):
            tx = db.transaction()
            for i in range(rows_per_tx):
                tx.insert_preencoded(tid, encode_insert(
                    tid, row_values(t, total + i)))
            await tx.commit()
            total += rows_per_tx
            # paced: await delivery each tx so flush sizes stay inside
            # the prewarmed buckets and the run measures steady decode
            deadline = time.monotonic() + 60
            while delivered[0] < total:
                if time.monotonic() > deadline:
                    raise TimeoutError(f"delivery stalled at "
                                       f"{delivered[0]}/{total}")
                await asyncio.sleep(0.01)
    total_seconds = time.perf_counter() - t0
    await pipeline.shutdown_and_wait()

    out = counters()
    out.update({
        "device": device,
        "nvcc_seconds": decode_kernel.build_seconds or 0.0,
        "start_seconds": start_seconds,
        "first_durable_seconds": first_durable[0],
        "total_seconds": total_seconds,
        "rows_written": total,
        "rows_delivered": delivered[0],
        # per route, the canonical layouts the tables' batches took (the
        # gate: 1); the gauge also counts the prewarm's and the
        # autotune probe's layouts
        "layouts_by_route": program_store.observed_layouts(),
        "canonical_layouts_seen":
            registry.get_gauge(ETL_DECODE_CANONICAL_LAYOUTS),
        "tables": n_tables,
        "prewarm_buckets": len(PREWARM_BUCKETS),
        "prewarm": pipeline.prewarm_stats,
    })
    return out


def main() -> None:
    p = argparse.ArgumentParser(
        prog="python -m etl_tpu_torch.benchmarks.coldstart_worker")
    p.add_argument("--cache-dir", required=True)
    p.add_argument("--tables", type=int, default=3)
    p.add_argument("--rows-per-tx", type=int, default=800)
    p.add_argument("--txs-per-table", type=int, default=2)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args()
    out = asyncio.run(run(args.cache_dir, args.tables, args.rows_per_tx,
                          args.txs_per_table, args.device))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
