"""Example: full pipeline into an Iceberg table, no Postgres required.

Runs the in-process fake walsender against the protocol-enforcing fake
REST catalog, copies a table, streams CDC, then independently walks the
committed snapshot chain: Avro manifest list → manifest → Parquet data
files → CDC collapse — the same read path any Iceberg engine takes. The
decoder runs on the card unless `--device cpu`:

    python -m etl_tpu_torch.examples.iceberg_pipeline [--device cpu|cuda]
        [--warehouse DIR]

Point `IcebergConfig.catalog_url` at a real REST catalog (Lakekeeper,
Polaris, Nessie…) to commit against it instead.
"""

from __future__ import annotations

import argparse
import asyncio
import tempfile

from ..config import BatchConfig, BatchEngine, PipelineConfig
from ..destinations.iceberg import IcebergConfig, IcebergDestination
from ..models import ColumnSchema, Oid, TableName, TableSchema
from ..postgres.fake import FakeDatabase, FakeSource
from ..runtime import Pipeline, TableStateType
from ..store import NotifyingStore
from ..testing.avro_reader import read_avro_ocf
from ..testing.fake_iceberg import FakeIcebergCatalog

ORDERS = 16384


async def run(device: str = "cuda", warehouse: str | None = None) -> dict:
    """The example's run: its printed lines (`lines`), the snapshot count
    (`snapshots`) and the live rows after the CDC collapse (`live`, by
    id)."""
    lines: list[str] = []

    def say(text: str) -> None:
        print(text, flush=True)
        lines.append(text)

    db = FakeDatabase()
    db.create_table(TableSchema(
        ORDERS, TableName("public", "orders"),
        (ColumnSchema("id", Oid.INT8, nullable=False, primary_key_ordinal=1),
         ColumnSchema("sku", Oid.TEXT),
         ColumnSchema("qty", Oid.INT4))),
        rows=[[str(i), f"sku-{i % 7}", str(1 + i % 5)]
              for i in range(1, 51)])
    db.create_publication("pub", [ORDERS])

    catalog = FakeIcebergCatalog()
    await catalog.start()
    try:
        warehouse = warehouse or tempfile.mkdtemp(prefix="etl-iceberg-")
        dest = IcebergDestination(IcebergConfig(
            catalog_url=catalog.url(), warehouse_path=warehouse))
        store = NotifyingStore()
        pipeline = Pipeline(
            config=PipelineConfig(
                pipeline_id=1, publication_name="pub",
                batch=BatchConfig(max_fill_ms=50,
                                  batch_engine=BatchEngine.CUDA,
                                  device=device)),
            store=store, destination=dest,
            source_factory=lambda: FakeSource(db))

        await pipeline.start()
        try:
            await asyncio.wait_for(
                store.notify_on(ORDERS, TableStateType.READY), 30)
            say(f"initial copy committed as an Iceberg snapshot → "
                f"{warehouse}")

            async with db.transaction() as tx:
                tx.insert(ORDERS, ["51", "sku-new", "3"])
                tx.update(ORDERS, ["1", None, None], ["1", "sku-0", "99"])
                tx.delete(ORDERS, ["2", None, None])
            await asyncio.sleep(0.5)
        finally:
            await pipeline.shutdown_and_wait()
    finally:
        await catalog.stop()

    # read back the way an Iceberg engine would: snapshot chain →
    # manifest lists → manifests → data files → CDC collapse
    import pyarrow.parquet as pq

    table = catalog.table("etl", "public_orders")
    say(f"snapshots: {len(table.snapshots)}, "
        f"head = {table.refs['main']}")
    state: dict = {}
    for snap in table.snapshots:
        _, manifests, _ = read_avro_ocf(snap["manifest-list"])
        for m in manifests:
            _, entries, _ = read_avro_ocf(m["manifest_path"])
            for e in entries:
                for row in pq.read_table(
                        e["data_file"]["file_path"]).to_pylist():
                    seq = row.get("_CHANGE_SEQUENCE_NUMBER") or ""
                    cur = state.get(row["id"])
                    if cur is None or seq >= cur[0]:
                        state[row["id"]] = (seq, row)
    live = {k: v[1] for k, v in sorted(state.items())
            if v[1]["_CHANGE_TYPE"] != "DELETE"}
    say(f"live rows after CDC collapse: {len(live)}")
    say(f"id=1 → {({k: live[1][k] for k in ('sku', 'qty')})}")
    assert len(live) == 50 and live[1]["qty"] == 99 and 2 not in live
    say("ok")
    return {"lines": lines, "warehouse": warehouse,
            "snapshots": len(table.snapshots), "head": table.refs["main"],
            "live": live}


def main(argv: list[str] | None = None) -> dict:
    p = argparse.ArgumentParser(
        prog="etl_tpu_torch.examples.iceberg_pipeline")
    p.add_argument("--device", default="cuda",
                   help="where the decoder runs: cuda (the card) or cpu")
    p.add_argument("--warehouse", default=None,
                   help="where the Parquet data files go (a new temporary "
                        "directory by default)")
    args = p.parse_args(argv)
    return asyncio.run(run(args.device, args.warehouse))


if __name__ == "__main__":
    main()
