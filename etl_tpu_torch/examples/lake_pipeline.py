"""Example: full pipeline into a local Parquet lake, no Postgres required.

Runs the in-process fake walsender, copies a table, streams CDC, then
prints the lake's collapsed current rows, read back through a fresh
handle onto the warehouse as a consumer would. The decoder runs on the
card unless `--device cpu`:

    python -m etl_tpu_torch.examples.lake_pipeline [--device cpu|cuda]
        [--warehouse DIR]
"""

from __future__ import annotations

import argparse
import asyncio
import tempfile

from ..config import BatchConfig, BatchEngine, PipelineConfig
from ..destinations.lake import LakeConfig, LakeDestination
from ..models import ColumnSchema, Oid, TableName, TableSchema
from ..postgres.fake import FakeDatabase, FakeSource
from ..runtime import Pipeline, TableStateType
from ..store import NotifyingStore

ACCOUNTS = 16384


async def run(device: str = "cuda", warehouse: str | None = None) -> dict:
    """The example's run: its printed lines (`lines`), the warehouse and
    the lake's current rows (`current`, sorted by id)."""
    lines: list[str] = []

    def say(text: str) -> None:
        print(text, flush=True)
        lines.append(text)

    db = FakeDatabase()
    db.create_table(TableSchema(
        ACCOUNTS, TableName("public", "accounts"),
        (ColumnSchema("id", Oid.INT8, nullable=False, primary_key_ordinal=1),
         ColumnSchema("email", Oid.TEXT),
         ColumnSchema("balance", Oid.NUMERIC),
         ColumnSchema("created", Oid.TIMESTAMPTZ))),
        rows=[[str(i), f"user{i}@example.com", f"{i}.50",
               "2024-01-01 00:00:00+00"] for i in range(1, 101)])
    db.create_publication("pub", [ACCOUNTS])

    warehouse = warehouse or tempfile.mkdtemp(prefix="etl-lake-")
    dest = LakeDestination(LakeConfig(warehouse))
    store = NotifyingStore()
    pipeline = Pipeline(
        config=PipelineConfig(
            pipeline_id=1, publication_name="pub",
            batch=BatchConfig(max_fill_ms=50, batch_engine=BatchEngine.CUDA,
                              device=device)),
        store=store, destination=dest,
        source_factory=lambda: FakeSource(db))

    await pipeline.start()
    try:
        await asyncio.wait_for(
            store.notify_on(ACCOUNTS, TableStateType.READY), 30)
        say(f"initial copy done → {warehouse}")

        async with db.transaction() as tx:
            tx.insert(ACCOUNTS, ["101", "new@example.com", "9.99",
                                 "2024-06-01 12:00:00+00"])
            tx.update(ACCOUNTS, ["1", None, None, None],
                      ["1", "user1@example.com", "1000.00",
                       "2024-01-01 00:00:00+00"])
            tx.delete(ACCOUNTS, ["2", None, None, None])
        await asyncio.sleep(0.5)
    finally:
        await pipeline.shutdown_and_wait()

    # read back as a consumer would: a fresh handle onto the warehouse
    reader = LakeDestination(LakeConfig(warehouse))
    await reader.startup()
    try:
        current = reader.read_current(ACCOUNTS).sort_by("id")
    finally:
        await reader.shutdown()
    say(f"lake current rows: {current.num_rows} "
        f"(copied 100, +1 insert, -1 delete)")
    rows = current.to_pylist()
    row1 = [r for r in rows if r["id"] == 1][0]
    say(f"updated row 1 balance: {row1['balance']}")
    return {"lines": lines, "warehouse": warehouse, "current": rows}


def main(argv: list[str] | None = None) -> dict:
    p = argparse.ArgumentParser(prog="etl_tpu_torch.examples.lake_pipeline")
    p.add_argument("--device", default="cuda",
                   help="where the decoder runs: cuda (the card) or cpu")
    p.add_argument("--warehouse", default=None,
                   help="the lake's directory (a new temporary one by "
                        "default)")
    args = p.parse_args(argv)
    return asyncio.run(run(args.device, args.warehouse))


if __name__ == "__main__":
    main()
