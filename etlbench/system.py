"""The system under test, as the benchmark builds it: the port's
`Pipeline` with the CUDA batch engine, the in-process walsender
(`FakeSource`) over a `FakeDatabase` that holds the benchmark's inputs,
and a destination of `destinations/`. Also the snapshot of the
port's own counters that the per-layer metrics read. Nothing here runs
a layer of the program by itself."""

from __future__ import annotations

import numpy as np

#: Postgres type name → (port Oid name, typmod); CHAR, VARCHAR and NUMERIC
#: carry their declared length or precision and scale in the typmod
_OIDS = {"int2": "INT2", "int4": "INT4", "int8": "INT8",
         "numeric": "NUMERIC", "date": "DATE", "timestamp": "TIMESTAMP",
         "bpchar": "BPCHAR", "varchar": "VARCHAR", "text": "TEXT"}


def _typmod(c: dict) -> int:
    if c["type"] in ("bpchar", "varchar") and c.get("length"):
        return c["length"] + 4
    if c["type"] == "numeric" and "precision" in c:
        return ((c["precision"] << 16) | c.get("scale", 0)) + 4
    return -1


def table_schema(tspec: dict):
    """The port's TableSchema of a configuration table."""
    from etl_tpu_torch.models import (ColumnSchema, Oid, TableName,
                                      TableSchema)

    cols = tuple(ColumnSchema(
        c["name"], getattr(Oid, _OIDS[c["type"]]),
        modifier=_typmod(c), nullable=c.get("nullable", True),
        primary_key_ordinal=c.get("pk") or None)
        for c in tspec["columns"])
    return TableSchema(tspec["relid"], TableName("public", tspec["name"]),
                       cols)


def fake_database(tables: list, tspecs: list, texts: list | None,
                  row_filter: "tuple[int, str] | None" = None):
    """A FakeDatabase holding each table, published as "pub". With
    `texts` (each table's COPY text) the tables hold those rows: the
    per-field text lists Postgres would hold and the COPY lines the
    walsender sends; without, they start empty (a CDC cell). A
    `row_filter` (table id, SQL) is published for the client to apply
    (the walsender ships every row)."""
    from etl_tpu_torch.postgres.fake import FakeDatabase, FakeTable

    db = FakeDatabase()
    for k, (t, tspec) in enumerate(zip(tables, tspecs)):
        schema = table_schema(tspec)
        if texts is None:
            db.create_table(schema)
            continue
        lines = texts[k].split(b"\n")
        lines.pop()  # the text ends in a newline
        rows = [line.split("\t") for line in texts[k].decode().split("\n")]
        rows.pop()
        for c, col in enumerate(t.cols):
            for r in np.flatnonzero(~col.valid).tolist():
                rows[r][c] = None
        db.tables[schema.id] = FakeTable(schema=schema, rows=rows,
                                         encoded=lines)
    filters = None
    if row_filter is not None:
        filters = {row_filter[0]: (row_filter[1], lambda r: True)}
        db.server_row_filtering = False
    db.create_publication("pub", [tspec["relid"] for tspec in tspecs],
                          row_filters=filters)
    return db


def pipeline(db, dest, settings: dict, pipeline_id: int, device: str):
    """The port's Pipeline over `db` into `dest`: PipelineConfig's
    defaults (supervision and poison isolation on), the CUDA batch
    engine on `device`, and the configuration's `pipeline` settings
    (BatchConfig fields). Returns (pipeline, store)."""
    from etl_tpu_torch.config import BatchConfig, BatchEngine, PipelineConfig
    from etl_tpu_torch.postgres.fake import FakeSource
    from etl_tpu_torch.runtime import Pipeline
    from etl_tpu_torch.store import NotifyingStore

    store = NotifyingStore()
    config = PipelineConfig(
        pipeline_id=pipeline_id, publication_name="pub",
        batch=BatchConfig(batch_engine=BatchEngine.CUDA, device=device,
                          **settings))
    return Pipeline(config=config, store=store, destination=dest,
                    source_factory=lambda: FakeSource(db)), store


def counters() -> dict:
    """The port's counters and stage sums that the metric readers use."""
    from etl_tpu_torch.ops import decode_kernel, engine
    from etl_tpu_torch.telemetry import metrics as m

    r = m.registry
    out = {"device_batches": engine.routed_device_batches,
           "k1_launches": decode_kernel.launches,
           "k2c_launches": decode_kernel.fused_launches}
    for key, name in (
            ("device_rows", m.ETL_DECODE_ROUTED_DEVICE_ROWS_TOTAL),
            ("host_rows", m.ETL_DECODE_ROUTED_HOST_ROWS_TOTAL),
            ("oracle_rows", m.ETL_DECODE_ROUTED_ORACLE_ROWS_TOTAL),
            ("device_s", m.ETL_DECODE_DEVICE_SECONDS_TOTAL),
            ("kernel_s", m.ETL_DECODE_KERNEL_SECONDS_TOTAL)):
        out[key] = r.get_counter(name)
    for key, name in (("pack", m.ETL_DECODE_PACK_SECONDS),
                      ("fetch", m.ETL_DECODE_FETCH_SECONDS),
                      ("run_rows", m.ETL_ASSEMBLER_RUN_ROWS)):
        out[f"{key}_n"], out[f"{key}_sum"] = r.sum_histogram(name)
    return out


def delta(a: dict, b: dict) -> dict:
    return {k: b[k] - a[k] for k in a}
