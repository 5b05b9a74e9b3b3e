"""The port's Iceberg destination (`etl_tpu_torch/destinations/
iceberg.py`), its metadata writer (`iceberg_meta.py`), the fake REST
catalog (`testing/fake_iceberg.py`) and the Avro reader (`testing/
avro_reader.py`), held to the reference's on the CPU.

1. The reference's `TestIceberg` (`tests/test_destinations.py`) on the
   port's modules, against the port's protocol-enforcing fake catalog;
   `TestIcebergRbParity` (`tests/test_columnar_egress.py`) on a batch of
   the port's decoder (`device="cpu"`).
2. Parity: the same seeded writes (a copy batch and two decoded CDC
   batches of each package's decoder committed with their WAL range, a
   replay of that range, pgbench-shaped row events with a key-changing
   update, a schema change adding a column and a row under it, a
   truncate) through the reference's `IcebergDestination` and the
   port's, each against both packages' fake catalogs. Every pairing is
   accepted without a rejection, and equal: the recovered high-water,
   the catalog's schemas, the snapshot chain (ids and timestamps
   masked to their order), each manifest list and manifest decoded by
   the independent reader (paths and ids masked), and each data file's
   rows and Arrow schema with its field ids.
3. The OCF pair across the packages: the port's writer read by the
   reference's reader and the reverse, on `fuzz.draw_avro_ocf` cases;
   the bytes agree but for the 16-byte sync marker; the port's writer
   repeats its bytes on one seed.

Every test is async (boxed by the conftest's 120 s) or a short loop;
none starts a child process or spins.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_iceberg.py -q

Tolerance: exact.
"""

import random
from pathlib import Path

import numpy as np
import pytest

from etl_tpu_torch.destinations.iceberg import (IcebergConfig,
                                                IcebergDestination)
from etl_tpu_torch.destinations.util import DestinationRetryPolicy
from etl_tpu_torch.models import (ColumnSchema, DeleteEvent, InsertEvent,
                                  Lsn, Oid, ReplicatedTableSchema,
                                  TableName, TableRow, TableSchema,
                                  TruncateEvent, UpdateEvent)
from etl_tpu_torch.ops import engine
from etl_tpu_torch.ops.pipeline import reset_global_admission
from tests.test_torch_lake import TID, _m, batch, ins, make_schema

REF, PORT = "etl_tpu", "etl_tpu_torch"
SEED = 20261018
RETRY_FAST = DestinationRetryPolicy(max_attempts=3, initial_delay_s=0.01,
                                    max_delay_s=0.05)


@pytest.fixture(autouse=True)
def _port_hygiene():
    yield
    engine.clear_forced_oracle()
    reset_global_admission()


# -- 1. the reference's Iceberg cases on the port ------------------------------


class TestIceberg:
    """Against the protocol-enforcing fake REST catalog
    (testing/fake_iceberg.py): commits must carry a parseable Avro
    manifest chain, correct statistics, CAS requirements, and
    spec-shaped schema evolution — the catalog rejects anything less
    (reference: iceberg/{catalog,client,core}.rs)."""

    async def start(self, tmp_path):
        from etl_tpu_torch.testing.fake_iceberg import FakeIcebergCatalog

        cat = FakeIcebergCatalog()
        await cat.start()
        d = IcebergDestination(IcebergConfig(
            catalog_url=cat.url(), warehouse_path=str(tmp_path)),
            RETRY_FAST)
        await d.startup()
        return cat, d

    async def test_snapshot_chain_and_manifest_stats(self, tmp_path):
        cat, d = await self.start(tmp_path)
        try:
            await d.write_table_rows(make_schema(),
                                     batch([[1, "a", None], [2, "b", None]]))
            await d.write_events([ins(0, [3, "c", None], lsn=0x600)])
            t = cat.table("etl", "public_user__events")
            assert len(t.snapshots) == 2
            s1, s2 = t.snapshots
            # chain: second snapshot parents the first; ref follows head
            assert s2["parent-snapshot-id"] == s1["snapshot-id"]
            assert t.refs["main"] == s2["snapshot-id"]
            assert s1["sequence-number"] == 1
            assert s2["sequence-number"] == 2
            assert s1["summary"]["operation"] == "append"
            assert s1["summary"]["added-records"] == "2"
            assert s2["summary"]["total-records"] == "3"
            assert not cat.rejections
            # manifest chain: parse with the independent reader and
            # check the statistics the destination recorded
            from etl_tpu_torch.testing.avro_reader import read_avro_ocf

            _, manifests, _ = read_avro_ocf(s1["manifest-list"])
            assert len(manifests) == 1
            _, entries, mmeta = read_avro_ocf(manifests[0]["manifest_path"])
            assert mmeta["format-version"] == "2"
            df = entries[0]["data_file"]
            assert df["record_count"] == 2
            assert df["content"] == 0
            # per-column stats present for every field (3 cols + 2 CDC)
            assert len(df["column_sizes"]) == 5
            assert len(df["value_counts"]) == 5
            # id column (field 1): bounds are little-endian longs 1..2
            lows = {e["key"]: e["value"] for e in df["lower_bounds"]}
            highs = {e["key"]: e["value"] for e in df["upper_bounds"]}
            import struct

            # id is INT4 -> iceberg "int": bounds are 4-byte LE per the
            # single-value serialization spec (Appendix D)
            assert struct.unpack("<i", lows[1])[0] == 1
            assert struct.unpack("<i", highs[1])[0] == 2
            await d.shutdown()
        finally:
            await cat.stop()

    async def test_cdc_collapse_via_pyarrow_reread(self, tmp_path):
        """Independent verification: read back every data file the
        snapshots reference with pyarrow, apply the CDC collapse by
        (change_type, change_sequence), and check the final table
        state — no destination code in the read path."""
        import pyarrow.parquet as pq

        from etl_tpu_torch.testing.avro_reader import read_avro_ocf

        cat, d = await self.start(tmp_path)
        try:
            await d.write_table_rows(make_schema(),
                                     batch([[1, "a", None], [2, "b", None]]))
            await d.write_events([
                ins(0, [3, "c", None], lsn=0x600),
                UpdateEvent(Lsn(0x601), Lsn(0x601), 1, make_schema(),
                            TableRow([1, "a2", None])),
                DeleteEvent(Lsn(0x602), Lsn(0x602), 2, make_schema(),
                            TableRow([2, None, None])),
            ])
            t = cat.table("etl", "public_user__events")
            rows = []
            for snap in t.snapshots:
                _, manifests, _ = read_avro_ocf(snap["manifest-list"])
                for m in manifests:
                    _, entries, _ = read_avro_ocf(m["manifest_path"])
                    for e in entries:
                        tbl = pq.read_table(e["data_file"]["file_path"])
                        rows.extend(tbl.to_pylist())
            # CDC collapse: last change per id wins, DELETE removes
            state = {}
            for r in sorted(rows, key=lambda r: r["_CHANGE_SEQUENCE_NUMBER"]):
                if r["_CHANGE_TYPE"] == "DELETE":
                    state.pop(r["id"], None)
                else:
                    state[r["id"]] = r["note"]
            assert state == {1: "a2", 3: "c"}, state
            await d.shutdown()
        finally:
            await cat.stop()

    async def test_schema_evolution_commits_new_schema(self, tmp_path):
        from etl_tpu_torch.models.event import SchemaChangeEvent

        cat, d = await self.start(tmp_path)
        try:
            await d.write_events([ins(0, [1, "a", None])])
            wider = ReplicatedTableSchema.with_all_columns(TableSchema(
                TID, TableName("public", "user_events"),
                (ColumnSchema("id", Oid.INT4, nullable=False,
                              primary_key_ordinal=1),
                 ColumnSchema("note", Oid.TEXT),
                 ColumnSchema("amount", Oid.NUMERIC),
                 ColumnSchema("added", Oid.TEXT))))
            await d.write_events([SchemaChangeEvent(
                Lsn(0x700), Lsn(0x700), TID, wider)])
            t = cat.table("etl", "public_user__events")
            assert len(t.schemas) == 2
            assert t.current_schema_id == 1
            names = [f["name"] for f in t.schemas[1]["fields"]]
            assert "added" in names
            # identifier-field-ids carry the PK through evolution
            assert t.schemas[1]["identifier-field-ids"] == [1]
            # field ids are STABLE across evolution: existing columns
            # (and the CDC columns) keep their ids, the new column gets
            # a fresh id past every id ever assigned (spec: ids are
            # never reused; manifests key statistics by id)
            ids0 = {f["name"]: f["id"] for f in t.schemas[0]["fields"]}
            ids1 = {f["name"]: f["id"] for f in t.schemas[1]["fields"]}
            for name, fid in ids0.items():
                assert ids1[name] == fid, (name, fid, ids1[name])
            assert ids1["added"] == max(ids0.values()) + 1
            # data files written AFTER evolution carry the new column's
            # fresh field id in the parquet schema
            await d.write_events([InsertEvent(
                Lsn(0x780), Lsn(0x780), TID, wider,
                TableRow([2, "b", None, "x"]))])
            import pyarrow.parquet as pq

            from etl_tpu_torch.testing.avro_reader import read_avro_ocf

            _, manifests, _ = read_avro_ocf(
                t.snapshots[-1]["manifest-list"])
            _, entries, _ = read_avro_ocf(manifests[0]["manifest_path"])
            arrow = pq.read_schema(entries[0]["data_file"]["file_path"])
            got = {f.name: int((f.metadata or {})[b"PARQUET:field_id"])
                   for f in arrow}
            assert got == ids1, (got, ids1)
            # in-process REDELIVERY of the same schema change (apply
            # worker timed retry) must not register a duplicate schema
            await d.write_events([SchemaChangeEvent(
                Lsn(0x700), Lsn(0x700), TID, wider)])
            assert len(t.schemas) == 2
            assert not cat.rejections
            await d.shutdown()
        finally:
            await cat.stop()

    async def test_cas_conflict_readopts_and_commits_on_new_head(
            self, tmp_path):
        """Losing the assert-ref-snapshot-id race (another writer
        advanced the main branch) must NOT wedge the destination in a
        blind retry of the stale requirement: it re-adopts the
        catalog's current state and rebuilds the commit on the new
        head — correct parent chain, sequence number, and totals."""
        cat, d = await self.start(tmp_path)
        try:
            await d.write_table_rows(make_schema(),
                                     batch([[1, "a", None]]))
            t = cat.table("etl", "public_user__events")
            # out-of-band writer: a SECOND destination instance commits,
            # advancing the branch past d's cached head
            d2 = IcebergDestination(IcebergConfig(
                catalog_url=cat.url(), warehouse_path=str(tmp_path)),
                RETRY_FAST)
            await d2.startup()
            await d2.write_events([ins(0, [5, "other", None], lsn=0x50)])
            await d2.shutdown()
            # d's next commit starts from a STALE snapshot id
            ack = await d.write_events([ins(0, [2, "b", None],
                                            lsn=0x60)])
            await ack.wait_durable()
            assert len(t.snapshots) == 3
            s = t.snapshots[-1]
            assert s["parent-snapshot-id"] == \
                t.snapshots[-2]["snapshot-id"]
            assert s["sequence-number"] == 3
            assert s["summary"]["total-records"] == "3"
            assert not cat.rejections
            await d.shutdown()
        finally:
            await cat.stop()

    async def test_schema_change_survives_cas_conflict(self, tmp_path):
        """A SchemaChangeEvent whose assert-ref requirement loses to a
        concurrent data commit must re-adopt and register the schema on
        the new head, not wedge retrying the stale requirement."""
        from etl_tpu_torch.models.event import SchemaChangeEvent

        cat, d = await self.start(tmp_path)
        try:
            await d.write_events([ins(0, [1, "a", None])])
            # concurrent writer advances the branch
            d2 = IcebergDestination(IcebergConfig(
                catalog_url=cat.url(), warehouse_path=str(tmp_path)),
                RETRY_FAST)
            await d2.startup()
            await d2.write_events([ins(0, [7, "x", None], lsn=0x55)])
            await d2.shutdown()
            wider = ReplicatedTableSchema.with_all_columns(TableSchema(
                TID, TableName("public", "user_events"),
                (ColumnSchema("id", Oid.INT4, nullable=False,
                              primary_key_ordinal=1),
                 ColumnSchema("note", Oid.TEXT),
                 ColumnSchema("amount", Oid.NUMERIC),
                 ColumnSchema("added", Oid.TEXT))))
            await d.write_events([SchemaChangeEvent(
                Lsn(0x700), Lsn(0x700), TID, wider)])
            t = cat.table("etl", "public_user__events")
            assert len(t.schemas) == 2 and t.current_schema_id == 1
            assert "added" in [f["name"] for f in t.schemas[1]["fields"]]
            # and data flows on the evolved schema afterwards
            await d.write_events([InsertEvent(
                Lsn(0x780), Lsn(0x780), TID, wider,
                TableRow([9, "b", None, "y"]))])
            assert not cat.rejections
            await d.shutdown()
        finally:
            await cat.stop()

    async def test_catalog_rejects_field_id_reuse(self, tmp_path):
        """The fake enforces the id rules the destination must obey:
        reassigning an existing column's id or recycling a used id for
        a new column is rejected, and a rejected multi-update commit
        leaves NO staged schema behind (transactional application)."""
        import aiohttp

        cat, d = await self.start(tmp_path)
        try:
            await d.write_events([ins(0, [1, "a", None])])
            t = cat.table("etl", "public_user__events")
            head = t.refs["main"]
            base = [dict(f) for f in t.schemas[0]["fields"]]
            url = f"{cat.url()}/v1/namespaces/etl/tables/" \
                  "public_user__events"
            async with aiohttp.ClientSession() as s:
                # existing column id reassigned (ordinal-style shuffle)
                bad = [dict(f) for f in base]
                bad[1]["id"], bad[2]["id"] = bad[2]["id"], bad[1]["id"]
                async with s.post(url, json={
                    "requirements": [{"type": "assert-ref-snapshot-id",
                                      "ref": "main",
                                      "snapshot-id": head}],
                    "updates": [
                        {"action": "add-schema", "schema": {
                            "type": "struct", "schema-id": 1,
                            "fields": bad}},
                        {"action": "set-current-schema",
                         "schema-id": 1}],
                }) as resp:
                    assert resp.status == 400
                # new column recycling an existing id
                bad2 = base + [{"id": base[0]["id"], "name": "fresh",
                                "required": False, "type": "string"}]
                async with s.post(url, json={
                    "requirements": [{"type": "assert-ref-snapshot-id",
                                      "ref": "main",
                                      "snapshot-id": head}],
                    "updates": [
                        {"action": "add-schema", "schema": {
                            "type": "struct", "schema-id": 1,
                            "fields": bad2}},
                        {"action": "set-current-schema",
                         "schema-id": 1}],
                }) as resp:
                    assert resp.status == 400
                # atomicity: a VALID add-schema followed by a rejected
                # update must not leave the schema registered
                good = base + [{"id": max(f["id"] for f in base) + 1,
                                "name": "fresh", "required": False,
                                "type": "string"}]
                async with s.post(url, json={
                    "requirements": [{"type": "assert-ref-snapshot-id",
                                      "ref": "main",
                                      "snapshot-id": head}],
                    "updates": [
                        {"action": "add-schema", "schema": {
                            "type": "struct", "schema-id": 1,
                            "fields": good}},
                        {"action": "set-current-schema",
                         "schema-id": 99}],
                }) as resp:
                    assert resp.status == 400
            assert len(t.schemas) == 1, \
                "rejected commit must stage nothing"
            assert t.current_schema_id == 0
            # and the identical commit retried with the VALID tail is
            # accepted — the fake didn't wedge on its own half-state
            async with aiohttp.ClientSession() as s:
                async with s.post(url, json={
                    "requirements": [{"type": "assert-ref-snapshot-id",
                                      "ref": "main",
                                      "snapshot-id": head}],
                    "updates": [
                        {"action": "add-schema", "schema": {
                            "type": "struct", "schema-id": 1,
                            "fields": good}},
                        {"action": "set-current-schema",
                         "schema-id": 1}],
                }) as resp:
                    assert resp.status == 200
            assert len(t.schemas) == 2
            await d.shutdown()
        finally:
            await cat.stop()

    async def test_truncate_is_delete_snapshot(self, tmp_path):
        from etl_tpu_torch.testing.avro_reader import read_avro_ocf

        cat, d = await self.start(tmp_path)
        try:
            await d.write_events([ins(0, [1, "a", None])])
            await d.write_events([TruncateEvent(
                Lsn(0x800), Lsn(0x800), 0, 0, (make_schema(),))])
            t = cat.table("etl", "public_user__events")
            assert len(t.snapshots) == 2
            snap = t.snapshots[-1]
            assert snap["summary"]["operation"] == "delete"
            assert snap["summary"]["total-records"] == "0"
            _, manifests, _ = read_avro_ocf(snap["manifest-list"])
            assert manifests == []  # no live data files after truncate
            await d.shutdown()
        finally:
            await cat.stop()

    async def test_catalog_rejects_stale_cas_and_legacy_shapes(
            self, tmp_path):
        import aiohttp

        cat, d = await self.start(tmp_path)
        try:
            await d.write_events([ins(0, [1, "a", None])])
            t = cat.table("etl", "public_user__events")
            head = t.refs["main"]
            async with aiohttp.ClientSession() as s:
                url = f"{cat.url()}/v1/namespaces/etl/tables/" \
                      "public_user__events"
                # stale CAS: asserts None head while a snapshot exists
                async with s.post(url, json={
                    "requirements": [{"type": "assert-ref-snapshot-id",
                                      "ref": "main", "snapshot-id": None}],
                    "updates": [],
                }) as resp:
                    assert resp.status == 409
                # a legacy minimal shape: REJECTED
                async with s.post(url, json={
                    "updates": [{"action": "append", "data-files": []}],
                }) as resp:
                    assert resp.status == 400
                # snapshot referencing a nonexistent manifest list
                async with s.post(url, json={
                    "requirements": [{"type": "assert-ref-snapshot-id",
                                      "ref": "main", "snapshot-id": head}],
                    "updates": [{"action": "add-snapshot", "snapshot": {
                        "snapshot-id": 99, "sequence-number": 2,
                        "timestamp-ms": 1, "parent-snapshot-id": head,
                        "manifest-list": "/nope.avro",
                        "summary": {"operation": "append"}}}],
                }) as resp:
                    assert resp.status == 400
            assert t.refs["main"] == head  # nothing moved
            await d.shutdown()
        finally:
            await cat.stop()

    async def test_truncate_first_after_restart(self, tmp_path):
        """A TruncateEvent as the FIRST event after a restart must not
        be dropped: the destination recovers table state and commits the
        delete snapshot."""
        cat, d = await self.start(tmp_path)
        try:
            await d.write_events([ins(0, [1, "a", None])])
            await d.shutdown()
            d2 = IcebergDestination(IcebergConfig(
                catalog_url=cat.url(), warehouse_path=str(tmp_path)),
                RETRY_FAST)
            await d2.startup()
            await d2.write_events([TruncateEvent(
                Lsn(0x900), Lsn(0x900), 0, 0, (make_schema(),))])
            t = cat.table("etl", "public_user__events")
            assert t.snapshots[-1]["summary"]["operation"] == "delete"
            assert t.snapshots[-1]["summary"]["total-records"] == "0"
            await d2.shutdown()
        finally:
            await cat.stop()

    async def test_schema_change_first_after_restart(self, tmp_path):
        """A SchemaChangeEvent as the first event after restart must
        still register the evolved schema (the catalog holds the OLD
        schema; adopting the target schema in memory must not suppress
        the add-schema commit)."""
        from etl_tpu_torch.models.event import SchemaChangeEvent

        cat, d = await self.start(tmp_path)
        try:
            await d.write_events([ins(0, [1, "a", None])])
            await d.shutdown()
            wider = ReplicatedTableSchema.with_all_columns(TableSchema(
                TID, TableName("public", "user_events"),
                (ColumnSchema("id", Oid.INT4, nullable=False,
                              primary_key_ordinal=1),
                 ColumnSchema("note", Oid.TEXT),
                 ColumnSchema("amount", Oid.NUMERIC),
                 ColumnSchema("added", Oid.TEXT))))
            d2 = IcebergDestination(IcebergConfig(
                catalog_url=cat.url(), warehouse_path=str(tmp_path)),
                RETRY_FAST)
            await d2.startup()
            await d2.write_events([SchemaChangeEvent(
                Lsn(0xA00), Lsn(0xA00), TID, wider)])
            t = cat.table("etl", "public_user__events")
            assert len(t.schemas) == 2
            assert t.current_schema_id == 1
            assert "added" in [f["name"] for f in t.schemas[1]["fields"]]
            # and a REPEAT of the same schema change (redelivery) is a
            # no-op, not a third schema
            d3 = IcebergDestination(IcebergConfig(
                catalog_url=cat.url(), warehouse_path=str(tmp_path)),
                RETRY_FAST)
            await d3.startup()
            await d3.write_events([SchemaChangeEvent(
                Lsn(0xA00), Lsn(0xA00), TID, wider)])
            assert len(t.schemas) == 2
            await d2.shutdown()
            await d3.shutdown()
        finally:
            await cat.stop()

    async def test_restart_adopts_catalog_state(self, tmp_path):
        """A fresh destination instance (restart) must load the table,
        adopt the branch head as its CAS token, and continue the chain."""
        cat, d = await self.start(tmp_path)
        try:
            await d.write_events([ins(0, [1, "a", None])])
            await d.shutdown()
            d2 = IcebergDestination(IcebergConfig(
                catalog_url=cat.url(), warehouse_path=str(tmp_path)),
                RETRY_FAST)
            await d2.startup()
            await d2.write_events([ins(0, [2, "b", None], lsn=0x610)])
            t = cat.table("etl", "public_user__events")
            assert len(t.snapshots) == 2
            assert t.snapshots[1]["parent-snapshot-id"] == \
                t.snapshots[0]["snapshot-id"]
            assert t.snapshots[1]["sequence-number"] == 2
            assert t.snapshots[1]["summary"]["total-records"] == "2"
            await d2.shutdown()
        finally:
            await cat.stop()


class TestIcebergRbParity:
    def test_record_batch_identical(self):
        """The columnar CDC record batch equals the row path's, on a batch
        of the port's decoder."""
        import pyarrow as pa

        from etl_tpu_torch.destinations.base import (CoalescedBatch,
                                                     expand_batch_events)
        from etl_tpu_torch.destinations.util import (CHANGE_SEQUENCE_COLUMN,
                                                     CHANGE_TYPE_COLUMN,
                                                     change_type_arrow,
                                                     sequence_number_arrow)
        from etl_tpu_torch.models import ColumnarBatch
        from tests.test_torch_lake import _engine_batch_event

        schema, ev = _engine_batch_event(24, tid=41026)
        cb = CoalescedBatch([ev])
        n = cb.num_rows
        rb_col = cb.batch.to_arrow()
        rb_col = rb_col.append_column(CHANGE_TYPE_COLUMN,
                                      change_type_arrow(cb.change_types))
        rb_col = rb_col.append_column(
            CHANGE_SEQUENCE_COLUMN,
            sequence_number_arrow(cb.commit_lsns, cb.tx_ordinals,
                                  np.arange(n, dtype=np.uint64)))
        evs = expand_batch_events([ev])
        rows = [e.row for e in evs]
        seqs = [e.sequence_key.with_ordinal(i) for i, e in enumerate(evs)]
        rb_row = ColumnarBatch.from_rows(schema, rows).to_arrow()
        rb_row = rb_row.append_column(CHANGE_TYPE_COLUMN,
                                      pa.array(["UPSERT"] * n, pa.string()))
        rb_row = rb_row.append_column(CHANGE_SEQUENCE_COLUMN,
                                      pa.array(seqs, pa.string()))
        assert rb_col.equals(rb_row)


# -- 2. parity with the reference ----------------------------------------------


def _pg_rows_events(pkg: str) -> list:
    """The lake's pgbench-shaped events without the TOAST-unchanged
    updates (the Iceberg writer takes full rows only)."""
    from tests.test_torch_lake import _pg_events

    cell = _m(pkg, "models.cell")
    return [e for e in _pg_events(pkg, SEED)
            if not any(v is cell.TOAST_UNCHANGED for v in getattr(
                getattr(e, "row", None), "values", ()))]


async def _iceberg_run(pkg: str, cat_pkg: str, root: Path) -> dict:
    """The parity scenario (module docstring) on `pkg`'s destination
    against `cat_pkg`'s fake catalog; returns what is compared."""
    from tests.test_torch_destination_parity import _events

    ice = _m(pkg, "destinations.iceberg")
    base = _m(pkg, "destinations.base")
    M = _m(pkg, "models")
    cat = _m(cat_pkg, "testing.fake_iceberg").FakeIcebergCatalog()
    await cat.start()
    kw = {"rng": random.Random(SEED)} if pkg == PORT else {}
    retry = _m(pkg, "destinations.util").DestinationRetryPolicy(
        max_attempts=3, initial_delay_s=0.01, max_delay_s=0.05)
    d = ice.IcebergDestination(ice.IcebergConfig(
        catalog_url=cat.url(), warehouse_path=str(root)), retry, **kw)
    out: dict = {}
    try:
        ev = _events(pkg, None)
        await d.startup()
        await d.write_table_batch(ev["schema"], ev["copy"])
        await d.write_event_batches_committed(ev["cdc"], ev["commit"])
        replay = base.CommitRange(high=ev["commit"].high, replay=True)
        await d.write_event_batches_committed(ev["cdc"][:1], replay)
        await d.write_event_batches_committed(ev["cdc"][:1], replay)
        high = await d.recover_high_water()
        out["high"] = (high.high, high.commit_end_lsn)
        pg = _pg_rows_events(pkg)
        for lo in range(0, len(pg), 12):
            await d.write_events(pg[lo:lo + 12])
        old = ev["schema"]
        wider = M.ReplicatedTableSchema.with_all_columns(M.TableSchema(
            old.id, old.name, tuple(old.replicated_columns)
            + (M.ColumnSchema("added", M.Oid.TEXT),)))
        await d.write_events([M.SchemaChangeEvent(
            M.Lsn(0xA800), M.Lsn(0xA800), old.id, wider)])
        await d.write_events([M.InsertEvent(
            M.Lsn(0xA900), M.Lsn(0xA900), 0, wider,
            M.TableRow([9001, 2, None, False, "wide", "x"]))])
        await d.write_events([ev["truncate"]])
        assert not cat.rejections, cat.rejections
        out["tables"] = {name: _chain(t, cat_pkg)
                         for (ns, name), t in sorted(cat.tables.items())}
    finally:
        await d.shutdown()
        await cat.stop()
    return out


def _chain(t, cat_pkg: str) -> dict:
    """One catalog table: its schemas, its snapshot chain with ids and
    timestamps masked to their order, each manifest list and manifest
    decoded by the reader of `cat_pkg`, and each data file's rows and
    Arrow schema."""
    import pyarrow.parquet as pq

    read = _m(cat_pkg, "testing.avro_reader").read_avro_ocf
    ids = {s["snapshot-id"]: i for i, s in enumerate(t.snapshots)}
    snaps, manifests, files = [], [], []
    for s in t.snapshots:
        snap = {k: v for k, v in s.items()
                if k not in ("snapshot-id", "parent-snapshot-id",
                             "timestamp-ms", "manifest-list")}
        snap["id"] = ids[s["snapshot-id"]]
        snap["parent"] = ids.get(s.get("parent-snapshot-id"))
        snaps.append(snap)
        _, mlist, lmeta = read(s["manifest-list"])
        lmeta = {k: v for k, v in lmeta.items()
                 if k not in ("avro.schema", "snapshot-id")}
        for m in mlist:
            _, entries, mmeta = read(m["manifest_path"])
            rec = {k: v for k, v in m.items()
                   if k not in ("manifest_path", "added_snapshot_id",
                                "manifest_length")}
            ents = []
            for e in entries:
                df = dict(e["data_file"])
                path = df.pop("file_path")
                tbl = pq.read_table(path)
                files.append((tbl.schema.to_string(show_schema_metadata=False),
                              [f.metadata for f in tbl.schema],
                              tbl.to_pylist()))
                ents.append({"status": e["status"],
                             "sequence_number": e["sequence_number"],
                             "file_sequence_number":
                                 e["file_sequence_number"],
                             "data_file": df})
            manifests.append((rec, {k: v for k, v in mmeta.items()
                                    if k != "avro.schema"}, ents))
        snaps[-1]["manifest_list_meta"] = lmeta
    return {"schemas": t.schemas, "current_schema_id": t.current_schema_id,
            "refs": {k: ids[v] for k, v in t.refs.items()},
            "last_sequence_number": t.last_sequence_number,
            "snapshots": snaps, "manifests": manifests, "files": files}


class TestIcebergEqualsReference:
    @pytest.mark.parametrize("cat_pkg", [REF, PORT],
                             ids=["reference_catalog", "port_catalog"])
    async def test_same_writes_same_snapshots(self, tmp_path, cat_pkg):
        """Both destinations against `cat_pkg`'s catalog: accepted, and
        equal snapshot chains, decoded manifests and data files."""
        want = await _iceberg_run(REF, cat_pkg, tmp_path / "ref")
        got = await _iceberg_run(PORT, cat_pkg, tmp_path / "port")
        assert got == want
        tables = want["tables"]
        assert set(tables) == {"public_w41070", "public_pgbench__accounts"}
        chain = tables["public_w41070"]["snapshots"]
        assert [s["summary"]["operation"] for s in chain][-1] == "delete"
        assert any("etl-replay-token" in s["summary"] for s in chain)
        assert len(tables["public_w41070"]["schemas"]) == 2

    async def test_seeded_snapshot_ids_repeat(self, tmp_path):
        """The port draws data-file names, manifest names, OCF sync
        markers and snapshot ids from its rng: two runs on one seed write
        the same names and the same manifest-list bytes."""
        from etl_tpu_torch.testing.fake_iceberg import FakeIcebergCatalog

        runs = []
        for sub in ("a", "b"):
            cat = FakeIcebergCatalog()
            await cat.start()
            try:
                d = IcebergDestination(IcebergConfig(
                    catalog_url=cat.url(),
                    warehouse_path=str(tmp_path / sub)), RETRY_FAST,
                    rng=random.Random(SEED))
                await d.startup()
                await d.write_table_rows(make_schema(),
                                         batch([[1, "a", None]]))
                await d.write_events([ins(0, [2, "b", None], lsn=0x600)])
                t = cat.table("etl", "public_user__events")
                root = tmp_path / sub
                runs.append((
                    [s["snapshot-id"] for s in t.snapshots],
                    sorted(str(p.relative_to(root))
                           for p in root.rglob("*") if p.is_file()),
                    # the bytes name the manifests under this run's root
                    [Path(s["manifest-list"]).read_bytes().replace(
                        str(root).encode(), b"<root>")
                     for s in t.snapshots]))
                await d.shutdown()
            finally:
                await cat.stop()
        assert runs[0] == runs[1]


# -- 3. the OCF pair across the packages ---------------------------------------


OCF_CASES = 300


def test_ocf_files_cross_read(tmp_path):
    """On `fuzz.draw_avro_ocf` cases (seeds SEED + i): the port's writer's
    file read by the reference's reader, the reference's writer's file
    read by the port's reader, both equal to the records; the two files
    agree byte for byte but for the sync marker (16 bytes after the
    header, and the file's last 16); a flipped bit is rejected or
    decoded alike by both readers."""
    from etl_tpu.destinations.iceberg_meta import write_avro_ocf as ref_write
    from etl_tpu.testing.avro_reader import read_avro_ocf as ref_read
    from etl_tpu_torch.testing import fuzz
    from etl_tpu_torch.testing.avro_reader import read_avro_ocf

    def outcome(read, path):
        try:
            return ("ok", repr(read(path)[1]))
        except (ValueError, KeyError, TypeError, RecursionError) as e:
            return ("rejected", type(e).__name__)

    for i in range(OCF_CASES):
        inputs = fuzz.draw_avro_ocf(random.Random(SEED + i))
        records = inputs["records"]
        port_path, ref_path = tmp_path / "port.avro", tmp_path / "ref.avro"
        port_raw = fuzz.avro_ocf_file(inputs, port_path)
        ref_write(ref_path, fuzz.AVRO_SCHEMA, records)
        ref_raw = ref_path.read_bytes()
        assert ref_read(port_path)[1] == records, i
        assert read_avro_ocf(ref_path)[1] == records, i
        assert len(port_raw) == len(ref_raw)
        sync = port_raw[-16:]
        at = port_raw.index(sync)
        assert ref_raw[:at] == port_raw[:at]
        assert ref_raw[at + 16:-16] == port_raw[at + 16:-16]
        flipped = tmp_path / "flipped.avro"
        flipped.write_bytes(fuzz.flip_bit(port_raw, inputs["flip"]))
        assert outcome(read_avro_ocf, flipped) \
            == outcome(ref_read, flipped), i


def test_ocf_writer_repeats_on_one_seed(tmp_path):
    from etl_tpu_torch.testing import fuzz

    inputs = fuzz.draw_avro_ocf(random.Random(SEED))
    a = fuzz.avro_ocf_file(inputs, tmp_path / "a.avro")
    b = fuzz.avro_ocf_file(inputs, tmp_path / "b.avro")
    assert a == b


# -- 5. bench's Iceberg run (chip_smoke.py phase 19(e)) ------------------------


class TestBenchIceberg:
    async def test_live_rows_collapse_updates_and_deletes(self, tmp_path):
        """`bench.iceberg_live_rows` reads the snapshot chain as the
        row-by-row collapse above does: the last change per key wins, a
        DELETE removes it."""
        from etl_tpu_torch import bench
        from etl_tpu_torch.testing.fake_iceberg import FakeIcebergCatalog

        cat = FakeIcebergCatalog()
        await cat.start()
        try:
            d = IcebergDestination(IcebergConfig(
                catalog_url=cat.url(), warehouse_path=str(tmp_path)),
                RETRY_FAST)
            await d.startup()
            await d.write_table_rows(make_schema(),
                                     batch([[1, "a", None], [2, "b", None]]))
            await d.write_events([
                ins(0, [3, "c", None], lsn=0x600),
                UpdateEvent(Lsn(0x601), Lsn(0x601), 1, make_schema(),
                            TableRow([1, "a2", None])),
                DeleteEvent(Lsn(0x602), Lsn(0x602), 2, make_schema(),
                            TableRow([2, None, None])),
            ])
            await d.shutdown()
            live, files = bench.iceberg_live_rows(
                cat.table("etl", "public_user__events"), "id")
        finally:
            await cat.stop()
        assert files == 2
        assert live.column("id").to_pylist() == [1, 3]
        assert live.column("note").to_pylist() == ["a2", "c"]

    async def test_concurrent_writers_of_one_destination_never_race(
            self, tmp_path):
        """64 concurrent copy writes through one destination (a copy's
        partitions on a fast card) each commit: the destination commits
        one at a time per table, so none loses its own CAS race (the
        reference's lose it 4 times in a row and fail the copy)."""
        import asyncio

        from etl_tpu_torch.testing.fake_iceberg import FakeIcebergCatalog

        cat = FakeIcebergCatalog()
        await cat.start()
        try:
            d = IcebergDestination(IcebergConfig(
                catalog_url=cat.url(), warehouse_path=str(tmp_path)),
                RETRY_FAST)
            await d.startup()
            await d.write_table_rows(make_schema(), batch([[0, "x", None]]))
            res = await asyncio.gather(*[
                d.write_table_rows(make_schema(), batch(
                    [[1 + k * 10 + i, "x", None] for i in range(10)]))
                for k in range(64)], return_exceptions=True)
            await d.shutdown()
            t = cat.table("etl", "public_user__events")
        finally:
            await cat.stop()
        assert [r for r in res if isinstance(r, BaseException)] == []
        assert len(t.snapshots) == 65 and not cat.rejections
        assert t.snapshots[-1]["summary"]["total-records"] == "641"

    def test_run_iceberg_cdc_on_the_cpu(self):
        """pgbench copied and streamed through the port's Pipeline into
        Iceberg at a small size, the kernels' plain versions on the CPU:
        the live rows read back equal the written rows (count, digest,
        columns), the catalog rejected nothing, no launch on the CPU."""
        import asyncio

        from etl_tpu_torch import bench

        r = asyncio.run(bench.run_iceberg_cdc(3000, 4000, device="cpu"))
        assert r["live_rows"] == 7000
        assert r["digest_ok"] and r["rows_ok"] and r["rejections"] == []
        assert r["snapshots"] >= 2 and r["data_files"] == r["snapshots"]
        assert r["device_batches"] > 0 and r["k1_launches"] == 0
        assert r["ok"]
