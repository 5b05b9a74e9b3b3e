"""The port's lake destination (`etl_tpu_torch/destinations/lake.py`)
held to the reference's on the CPU, where pyarrow is installed.

1. The reference's lake cases on the port's modules: `TestLake`, the lake
   cases of `TestIndependentWireVerifiers`, `TestWalOrderBarriers`,
   `TestToastUnchanged` and `TestKeyChangingUpdate`, `TestLakeReplayEpochs`
   and `TestLakeInlining` (`tests/test_destinations.py`); `TestLakeParity`
   and the lake half of the zero-TableRow check
   (`tests/test_columnar_egress.py`) on batches of the port's decoder
   (`device="cpu"`: the kernels' plain versions); the lake cases of
   `tests/test_pipeline_e2e.py` on the port's `Pipeline`.
2. Parity: the same seeded writes go through the reference's
   `LakeDestination` and the port's, each in a warehouse of its own: a
   copy batch and two decoded CDC batches of each package's decoder (the
   second with updates and deletes) committed with their WAL range, a
   DLQ-style replay of that range twice and a streaming redelivery;
   pgbench-shaped row events (inserts, full updates, TOAST-unchanged
   updates, a key-changing update, deletes) in chunks, some inlined in
   the catalog; a table of every column kind; compaction, a truncate
   and a write after it, vacuum. Equal: the recovered high-water, each
   current view (sorted by key) and its Arrow schema, every catalog
   entry's rows and Arrow schema in catalog order, the catalog rows with
   paths and replay-epoch uuids masked, and the maintenance history with
   its timestamps masked.
3. The typed refusal where pyarrow cannot be imported (a subprocess with
   `sys.modules["pyarrow"] = None`), and chip_smoke.py's phase 19 there.

Every test but the two subprocess ones is async and boxed by the
conftest (120 s); those two start one interpreter each with a timeout.
No other child process, no spinner.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_lake.py -q

Tolerance: exact.
"""

import asyncio
import datetime as dt
import importlib
import json
import os
import random
import subprocess
import sys
import uuid

import numpy as np
import pytest

from etl_tpu_torch.destinations.lake import LakeConfig, LakeDestination
from etl_tpu_torch.models import (ColumnSchema, DeleteEvent, InsertEvent,
                                  Lsn, Oid, PgNumeric, ReplicatedTableSchema,
                                  TableName, TableRow, TableSchema,
                                  TruncateEvent, UpdateEvent)
from etl_tpu_torch.ops import engine
from etl_tpu_torch.ops.pipeline import reset_global_admission

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF, PORT = "etl_tpu", "etl_tpu_torch"
TID = 700
SEED = 20261018


@pytest.fixture(autouse=True)
def _port_hygiene():
    yield
    engine.clear_forced_oracle()
    reset_global_admission()


def make_schema():
    return ReplicatedTableSchema.with_all_columns(TableSchema(
        TID, TableName("public", "user_events"),
        (ColumnSchema("id", Oid.INT4, nullable=False, primary_key_ordinal=1),
         ColumnSchema("note", Oid.TEXT),
         ColumnSchema("amount", Oid.NUMERIC))))


def batch(rows):
    from etl_tpu_torch.models import ColumnarBatch

    return ColumnarBatch.from_rows(make_schema(), [TableRow(r) for r in rows])


def ins(i, row, lsn=0x100):
    return InsertEvent(Lsn(lsn), Lsn(lsn), i, make_schema(), TableRow(row))


# -- 1. the reference's lake cases on the port ---------------------------------


class TestLake:
    async def test_copy_cdc_current_view(self, tmp_path):
        d = LakeDestination(LakeConfig(str(tmp_path)))
        await d.startup()
        await d.write_table_rows(make_schema(),
                                 batch([[1, "a", PgNumeric("1")],
                                        [2, "b", None]]))
        await d.write_events([
            ins(0, [3, "c", None], lsn=0x200),
            UpdateEvent(Lsn(0x201), Lsn(0x201), 1, make_schema(),
                        TableRow([1, "a2", None])),
            DeleteEvent(Lsn(0x202), Lsn(0x202), 2, make_schema(),
                        TableRow([2, None, None])),
        ])
        current = d.read_current(TID)
        rows = {r["id"]: r for r in current.to_pylist()}
        assert set(rows) == {1, 3}
        assert rows[1]["note"] == "a2"  # update applied
        await d.shutdown()

    async def test_replay_dedup(self, tmp_path):
        d = LakeDestination(LakeConfig(str(tmp_path)))
        await d.startup()
        evs = [ins(0, [1, "x", None], lsn=0x300)]
        await d.write_events(evs)
        await d.write_events(evs)  # re-delivery of the same batch
        assert d.read_current(TID).num_rows == 1
        await d.shutdown()

    async def test_truncate_generation(self, tmp_path):
        d = LakeDestination(LakeConfig(str(tmp_path)))
        await d.startup()
        await d.write_table_rows(make_schema(), batch([[1, "a", None]]))
        await d.write_events([TruncateEvent(Lsn(1), Lsn(1), 0, 0,
                                            (make_schema(),))])
        assert d.read_current(TID).num_rows == 0
        await d.write_events([ins(0, [9, "post", None], lsn=0x400)])
        assert d.read_current(TID).to_pylist()[0]["id"] == 9
        await d.shutdown()

    async def test_compaction(self, tmp_path):
        d = LakeDestination(LakeConfig(str(tmp_path), compact_min_files=3))
        await d.startup()
        for i in range(4):
            await d.write_events([ins(0, [i, f"n{i}", None],
                                      lsn=0x500 + i * 16)])
        # compaction triggered: files collapsed, data preserved
        files = d._catalog().execute(
            "SELECT COUNT(*) FROM lake_files WHERE table_id = ?",
            (TID,)).fetchone()[0]
        assert files <= 2
        assert d.read_current(TID).num_rows == 4
        await d.shutdown()


class TestIndependentWireVerifiers:
    """The lake's Parquet files read back by a reader that shares no code
    with the writer: a raw pyarrow re-read and the CDC collapse
    re-applied by hand."""

    async def test_lake_parquet_raw_reread_cdc_collapse(self, tmp_path):
        """Read the lake's parquet files straight off disk with pyarrow
        (no LakeDestination read path) and re-apply the CDC collapse."""
        import pyarrow.parquet as pq

        d = LakeDestination(LakeConfig(str(tmp_path)))
        await d.startup()
        await d.write_table_rows(make_schema(),
                                 batch([[1, "a", None], [2, "b", None]]))
        await d.write_events([
            ins(0, [3, "c", None], lsn=0x200),
            UpdateEvent(Lsn(0x201), Lsn(0x201), 1, make_schema(),
                        TableRow([1, "a2", None])),
            DeleteEvent(Lsn(0x202), Lsn(0x202), 2, make_schema(),
                        TableRow([2, None, None])),
        ])
        await d.shutdown()
        rows = []
        for p in sorted(tmp_path.rglob("*.parquet")):
            rows.extend(pq.read_table(p).to_pylist())
        state = {}
        for r in sorted(rows,
                        key=lambda r: r.get("_CHANGE_SEQUENCE_NUMBER")
                        or ""):
            if r.get("_CHANGE_TYPE") == "DELETE":
                state.pop(r["id"], None)
            else:
                state[r["id"]] = r["note"]
        assert state == {1: "a2", 3: "c"}, state


class TestWalOrderBarriers:
    """Rows preceding a truncate inside ONE write_events batch must land
    before the truncate executes (no barrier reordering)."""

    def mixed_batch(self):
        return [
            ins(0, [1, "pre", None], lsn=0x9000),
            TruncateEvent(Lsn(0x9010), Lsn(0x9010), 1, 0, (make_schema(),)),
            ins(2, [2, "post", None], lsn=0x9020),
        ]

    async def test_lake_order(self, tmp_path):
        d = LakeDestination(LakeConfig(str(tmp_path)))
        await d.startup()
        await d.write_events(self.mixed_batch())
        current = d.read_current(TID).to_pylist()
        # row 1 was truncated away; only the post-truncate row survives
        assert [r["id"] for r in current] == [2]
        await d.shutdown()


class TestToastUnchanged:
    """Unchanged-TOAST columns must never be flattened to NULL at a
    destination (reference ducklake Partial updates)."""

    def _toast_update(self, i=0, lsn=0x200):
        from etl_tpu_torch.models.cell import TOAST_UNCHANGED

        # id=1 updated, note TOASTed-unchanged (no old image)
        return UpdateEvent(Lsn(lsn), Lsn(lsn), i, make_schema(),
                           TableRow([1, TOAST_UNCHANGED, PgNumeric("5")]))

    async def test_lake_patch_preserves_stored_value(self, tmp_path):
        dest = LakeDestination(LakeConfig(warehouse_path=str(tmp_path)))
        await dest.startup()
        await dest.write_events([ins(0, [1, "big-toasted-note", PgNumeric("1")])])
        await dest.write_events([self._toast_update()])
        t = dest.read_current(TID)
        recs = t.to_pylist()
        assert len(recs) == 1
        assert recs[0]["note"] == "big-toasted-note"  # NOT nulled
        assert recs[0]["amount"] == "5"
        await dest.shutdown()

    async def test_lake_patch_survives_compaction(self, tmp_path):
        dest = LakeDestination(LakeConfig(warehouse_path=str(tmp_path),
                                          compact_min_files=100))
        await dest.startup()
        await dest.write_events([ins(0, [1, "keep-me", PgNumeric("1")])])
        await dest.write_events([self._toast_update()])
        merged = await dest.compact(TID)
        assert merged >= 2
        recs = dest.read_current(TID).to_pylist()
        assert recs[0]["note"] == "keep-me"
        await dest.shutdown()


class TestKeyChangingUpdate:
    """An update that changes the replica identity must delete the
    old-identity row: no stale duplicates in _current views (reference
    ducklake Full -> Delete{origin:update} + Upsert)."""

    async def test_lake_no_stale_row(self, tmp_path):
        from etl_tpu_torch.models.table_row import PartialTableRow

        dest = LakeDestination(LakeConfig(warehouse_path=str(tmp_path)))
        await dest.startup()
        await dest.write_events([ins(0, [1, "a", PgNumeric("1")]),
                                 ins(1, [2, "b", PgNumeric("2")])])
        # PK 1 -> 9 with a key-only old image
        upd = UpdateEvent(Lsn(0x300), Lsn(0x300), 0, make_schema(),
                          TableRow([9, "a2", PgNumeric("1")]),
                          PartialTableRow([1, None, None],
                                          [True, False, False]))
        await dest.write_events([upd])
        recs = {r["id"]: r for r in dest.read_current(TID).to_pylist()}
        assert set(recs) == {9, 2}, "old-identity row 1 must be deleted"
        assert recs[9]["note"] == "a2"
        await dest.shutdown()


class TestLakeReplayEpochs:
    """Replay-epoch markers (reference ducklake/replay_epoch.rs): resets
    rotate an opaque per-table epoch under a two-phase transition so the
    sequence watermark can never dedup re-replayed data, and a crash
    mid-reset completes at the next startup."""

    async def test_truncate_rotates_epoch_and_replays_old_sequences(
            self, tmp_path):
        from etl_tpu_torch.destinations.lake import LEGACY_REPLAY_EPOCH

        d = LakeDestination(LakeConfig(str(tmp_path)))
        await d.startup()
        await d.write_events([ins(0, [1, "pre", None], lsn=0x500)])
        assert d.current_replay_epoch(TID) == LEGACY_REPLAY_EPOCH
        await d.write_events([TruncateEvent(Lsn(1), Lsn(1), 0, 0,
                                            (make_schema(),))])
        epoch1 = d.current_replay_epoch(TID)
        assert epoch1 != LEGACY_REPLAY_EPOCH
        # re-replayed batch with the SAME pre-reset sequence key must land
        await d.write_events([ins(0, [1, "replayed", None], lsn=0x500)])
        recs = d.read_current(TID).to_pylist()
        assert [r["note"] for r in recs] == ["replayed"]
        # another reset rotates again
        await d.write_events([TruncateEvent(Lsn(2), Lsn(2), 0, 0,
                                            (make_schema(),))])
        assert d.current_replay_epoch(TID) not in (LEGACY_REPLAY_EPOCH,
                                                   epoch1)
        await d.shutdown()

    async def test_crashed_transition_completes_at_startup(self, tmp_path):
        """begin recorded, crash before the reset: the next startup
        re-runs the reset and promotes the pending epoch."""
        d = LakeDestination(LakeConfig(str(tmp_path)))
        await d.startup()
        await d.write_events([ins(0, [1, "old", None], lsn=0x500)])
        pending = d._begin_replay_reset(TID)
        await d.shutdown()  # "crash" between begin and complete

        d2 = LakeDestination(LakeConfig(str(tmp_path)))
        await d2.startup()  # resumes the transition
        assert d2.current_replay_epoch(TID) == pending
        assert d2.read_current(TID).num_rows == 0  # reset happened
        # watermark cleared: the old sequence key re-applies
        await d2.write_events([ins(0, [1, "new", None], lsn=0x500)])
        assert d2.read_current(TID).to_pylist()[0]["note"] == "new"
        await d2.shutdown()

    async def test_begin_is_idempotent(self, tmp_path):
        d = LakeDestination(LakeConfig(str(tmp_path)))
        await d.startup()
        await d.write_events([ins(0, [1, "x", None])])
        p1 = d._begin_replay_reset(TID)
        p2 = d._begin_replay_reset(TID)  # resume keeps the SAME pending
        assert p1 == p2
        await d.shutdown()


class TestLakeInlining:
    """Data inlining (reference ducklake/inline_size.rs): small CDC
    batches live in the catalog until the flush threshold merges them
    into one Parquet file."""

    def config(self, tmp_path, flush=10**9):
        return LakeConfig(str(tmp_path), compact_min_files=10**9,
                          inline_max_bytes=64 * 1024,
                          inline_flush_bytes=flush)

    def _parquet_files(self, tmp_path):
        from pathlib import Path

        return [p for p in Path(str(tmp_path)).rglob("data-*.parquet")]

    async def test_small_batches_stay_inline(self, tmp_path):
        d = LakeDestination(self.config(tmp_path))
        await d.startup()
        for i in range(5):
            await d.write_events([ins(0, [i, f"n{i}", None],
                                      lsn=0x600 + i)])
        assert self._parquet_files(tmp_path) == []  # no tiny files
        recs = {r["id"] for r in d.read_current(TID).to_pylist()}
        assert recs == {0, 1, 2, 3, 4}
        await d.shutdown()

    async def test_flush_threshold_merges_to_one_parquet(self, tmp_path):
        d = LakeDestination(self.config(tmp_path, flush=2_000))
        await d.startup()
        for i in range(30):
            await d.write_events([ins(0, [i, "n" * 40, None],
                                      lsn=0x700 + i)])
        files = self._parquet_files(tmp_path)
        assert files, "flush threshold never produced a parquet file"
        # each flush merges several batches: fewer files than batches,
        # nothing lost
        assert len(files) < 15
        assert d.read_current(TID).num_rows == 30
        await d.shutdown()

    async def test_flush_survives_interleaved_deletes(self, tmp_path):
        """Sequence-aware collapse: flushing non-contiguous inlined
        entries must not resurrect rows deleted by interleaved non-inlined
        files."""
        d = LakeDestination(self.config(tmp_path))
        await d.startup()
        await d.write_events([ins(0, [1, "keep", None], lsn=0x800)])
        # big batch → goes to parquet, deletes id=1
        big = [DeleteEvent(Lsn(0x801), Lsn(0x801), 0, make_schema(),
                           TableRow([1, None, None]))]
        big += [ins(i, [100 + i, "pad" * 600, None], lsn=0x802)
                for i in range(60)]
        await d.write_events(big)
        # later small inline batch
        await d.write_events([ins(0, [2, "after", None], lsn=0x900)])
        await d.flush_inlined(TID)  # merge the non-contiguous inlined rows
        recs = {r["id"] for r in d.read_current(TID).to_pylist()}
        assert 1 not in recs, "flush reordering resurrected a deleted row"
        assert 2 in recs and 100 in recs
        await d.shutdown()

    async def test_restart_preserves_inlined_data(self, tmp_path):
        d = LakeDestination(self.config(tmp_path))
        await d.startup()
        await d.write_events([ins(0, [7, "inline-me", None], lsn=0xa00)])
        await d.shutdown()
        d2 = LakeDestination(self.config(tmp_path))
        await d2.startup()
        assert d2.read_current(TID).to_pylist()[0]["note"] == "inline-me"
        await d2.shutdown()

    async def test_compaction_includes_inlined_entries(self, tmp_path):
        d = LakeDestination(LakeConfig(str(tmp_path), compact_min_files=4,
                                       inline_max_bytes=64 * 1024,
                                       inline_flush_bytes=10**9))
        await d.startup()
        for i in range(4):
            await d.write_events([ins(0, [i, f"c{i}", None],
                                      lsn=0xb00 + i)])
        # inlined entries do NOT fire the compaction trigger (they are
        # the cheap tier) — an explicit compact still consumes them
        assert d.current_cdc_file_count(TID) == 0
        assert await d.compact(TID) > 0
        assert d.read_current(TID).num_rows == 4
        db = d._catalog()
        (inlined,) = db.execute(
            "SELECT COUNT(*) FROM lake_files WHERE inline_payload IS NOT "
            "NULL AND table_id = ?", (TID,)).fetchone()
        assert inlined == 0, "compaction left inlined entries behind"
        await d.shutdown()


# -- 1b. columnar egress cases on the port's decoded batches -------------------


def _engine_batch_event(n=64, tid=41002, start=0):
    """An engine-shaped DecodedBatchEvent (dense ints + Arrow-layout text)
    through the port's staging and decoder on the CPU — what the apply
    loop hands the destination."""
    from etl_tpu_torch.models import DecodedBatchEvent
    from etl_tpu_torch.ops.engine import DeviceDecoder
    from etl_tpu_torch.ops.wal import concat_payloads, stage_wal_batch
    from etl_tpu_torch.postgres.codec.pgoutput import encode_insert

    schema = ReplicatedTableSchema.with_all_columns(TableSchema(
        tid, TableName("public", f"t{tid}"),
        (ColumnSchema("id", Oid.INT8, nullable=False, primary_key_ordinal=1),
         ColumnSchema("v", Oid.INT4), ColumnSchema("note", Oid.TEXT))))
    payloads = [encode_insert(tid, [str(start + i).encode(),
                                    str(i % 97).encode(),
                                    b"note-%d" % (start + i)])
                for i in range(n)]
    wal = stage_wal_batch(*concat_payloads(payloads), 3)
    b = DeviceDecoder(schema, device="cpu", device_min_rows=1).decode(
        wal.staged)
    ev = DecodedBatchEvent(
        Lsn(start + 1), Lsn(start + n), schema,
        change_types=np.zeros(n, dtype=np.int8),
        commit_lsns=np.arange(start, start + n, dtype=np.uint64) + 0x1000,
        tx_ordinals=np.arange(n, dtype=np.uint64), batch=b)
    return schema, ev


class TestLakeParity:
    async def test_cdc_content_identical(self, tmp_path):
        """The columnar CDC path writes the same Parquet file and the same
        current view as the row path, on the port's decoded batches."""
        import pyarrow.parquet as pq

        schema, ev1 = _engine_batch_event(32, tid=41024)
        _, ev2 = _engine_batch_event(16, tid=41024, start=32)
        ev2.schema = schema
        ev2.change_types = np.array([2] * 8 + [0] * 8, dtype=np.int8)
        events = [ev1, ev2]

        async def run(method, sub):
            d = LakeDestination(LakeConfig(str(tmp_path / sub)))
            await d.startup()
            await getattr(d, method)(events)
            db = d._catalog()
            tables = []
            for (path,) in db.execute(
                    "SELECT path FROM lake_files WHERE kind='cdc'"):
                tables.append(pq.read_table(path))
            current = d.read_current(schema.id)
            await d.shutdown()
            return tables, current

        legacy_files, legacy_current = await run("write_events", "legacy")
        col_files, col_current = await run("write_event_batches", "col")
        assert len(legacy_files) == len(col_files) == 1
        assert legacy_files[0].equals(col_files[0])
        assert legacy_current.sort_by("id").equals(col_current.sort_by("id"))

    async def test_replay_dedup_carries_over(self, tmp_path):
        schema, ev = _engine_batch_event(8, tid=41025)
        d = LakeDestination(LakeConfig(str(tmp_path / "dedup")))
        await d.startup()
        await d.write_event_batches([ev])
        n1 = d.current_cdc_file_count(schema.id)
        await d.write_event_batches([ev])  # redelivery: max_seq ≤ watermark
        assert d.current_cdc_file_count(schema.id) == n1
        await d.shutdown()

    async def test_zero_row_materialization_on_the_columnar_path(
            self, tmp_path):
        """The lake's CDC hot loop builds no TableRow."""
        from etl_tpu_torch.analysis.annotations import HOT_LOOP_ATTR
        from etl_tpu_torch.models.table_row import rows_constructed

        assert getattr(LakeDestination._write_cdc_batch, HOT_LOOP_ATTR,
                       False)
        _, ev = _engine_batch_event(64, tid=41034)
        lake = LakeDestination(LakeConfig(str(tmp_path / "zero")))
        await lake.startup()
        before = rows_constructed()
        await lake.write_event_batches([ev])
        assert rows_constructed() == before, \
            "columnar egress constructed TableRows on the hot path"
        assert lake.read_current(41034).num_rows == 64
        await lake.shutdown()


# -- 1c. the lake through the port's Pipeline ----------------------------------


class TestLakeThroughPipeline:
    async def test_multi_table_filters_to_lake(self, tmp_path):
        """Multi-table parallel sync with PG15 row/column publication
        filters into the lake destination."""
        from tests.test_torch_pipeline_e2e import (ACCOUNTS, ORDERS,
                                                   _wait_for, make_db,
                                                   make_pipeline, wait_ready)

        db = make_db()
        db.create_publication(
            "pub", [ACCOUNTS, ORDERS],
            column_filters={ACCOUNTS: ["id", "balance"]},
            # PG15 row filter: only non-negative balances replicate
            row_filters={ACCOUNTS: lambda r: r[2] is not None
                         and not r[2].startswith("-")})
        dest = LakeDestination(LakeConfig(str(tmp_path)))
        pipeline, store, _ = make_pipeline(db, destination=dest,
                                           max_table_sync_workers=2)
        await pipeline.start()
        await wait_ready(store, ACCOUNTS)
        await wait_ready(store, ORDERS)
        async with db.transaction() as tx:
            tx.insert(ACCOUNTS, ["9", "filtered-name", "77"])
            tx.insert(ACCOUNTS, ["10", "negative", "-5"])  # row-filtered out
            tx.insert(ORDERS, ["11", "1.25"])
        await _wait_for(lambda: _lake_has(dest, ACCOUNTS, 9)
                        and _lake_has(dest, ORDERS, 11, key="oid"))
        acc = dest.read_current(ACCOUNTS)
        # column filter applied end to end: only id + balance columns
        assert set(acc.column_names) == {"id", "balance"}
        # row filter: copy drops id=2 (balance -5) and CDC drops id=10
        assert {r["id"] for r in acc.to_pylist()} == {1, 3, 9}
        orders = dest.read_current(ORDERS).to_pylist()
        assert {r["oid"] for r in orders} == {10, 11}
        # numeric survives exactly as text through the lake
        assert [r["amount"] for r in orders if r["oid"] == 11] == ["1.25"]
        await pipeline.shutdown_and_wait()

    async def test_unchanged_toast_preserved_in_lake(self, tmp_path):
        """An UPDATE whose TOASTed column is unchanged (no old image,
        default replica identity) does not null the stored value at the
        lake: the column-wise PATCH path end to end."""
        from etl_tpu_torch.postgres.fake import TOAST_UNCHANGED_VALUE
        from tests.test_torch_pipeline_e2e import (ACCOUNTS, make_db,
                                                   make_pipeline, wait_ready)

        db = make_db()
        db.create_publication("pub", [ACCOUNTS])
        dest = LakeDestination(LakeConfig(warehouse_path=str(tmp_path)))
        pipeline, store, _ = make_pipeline(db, destination=dest)
        await pipeline.start()
        await wait_ready(store, ACCOUNTS)
        big = "toasted-" + "x" * 500
        async with db.transaction() as tx:
            tx.insert(ACCOUNTS, ["70", big, "5"])
        async with db.transaction() as tx:
            # balance changes; the big TOASTed name is unchanged → 'u' kind
            tx.update(ACCOUNTS, ["70", None, None],
                      ["70", TOAST_UNCHANGED_VALUE, "6"])
        recs = {}
        for _ in range(300):
            recs = {r["id"]: r
                    for r in dest.read_current(ACCOUNTS).to_pylist()}
            if recs.get(70, {}).get("balance") == 6:
                break
            await asyncio.sleep(0.02)
        assert recs.get(70, {}).get("balance") == 6, "update never landed"
        assert recs[70]["name"] == big, "unchanged TOAST column was lost"
        await pipeline.shutdown_and_wait()

    async def test_identity_changing_toast_errors_typed_at_lake(
            self, tmp_path):
        """An identity-CHANGING update with an unchanged-TOAST column is
        unreconstructable even for the patching lake: the worker surfaces
        the typed replica-identity error, never a nulled value."""
        from etl_tpu_torch.models.errors import ErrorKind, EtlError
        from etl_tpu_torch.postgres.fake import TOAST_UNCHANGED_VALUE
        from tests.test_torch_pipeline_e2e import (ACCOUNTS, make_db,
                                                   make_pipeline, wait_ready)

        db = make_db()
        db.create_publication("pub", [ACCOUNTS])
        dest = LakeDestination(LakeConfig(warehouse_path=str(tmp_path)))
        pipeline, store, _ = make_pipeline(db, destination=dest)
        await pipeline.start()
        await wait_ready(store, ACCOUNTS)
        async with db.transaction() as tx:
            # PK 1 → 90 with an unchanged TOASTed name: 'K' old tuple,
            # no old image for the name → cannot be patched
            tx.update(ACCOUNTS, ["1", None, None],
                      ["90", TOAST_UNCHANGED_VALUE, "7"])
        try:
            with pytest.raises(EtlError) as ei:
                await asyncio.wait_for(pipeline.wait(), timeout=20)
            assert ErrorKind.SOURCE_REPLICA_IDENTITY in ei.value.kinds()
        finally:
            await pipeline.shutdown()

    async def test_restart_during_split_transaction_no_dupes_in_lake(
            self, tmp_path):
        """Shutdown lands between mid-transaction flushes of a large
        transaction; the restart re-streams from the last durable commit,
        and the identity + sequence collapse keeps the current view free
        of duplicates."""
        from etl_tpu_torch.config import BatchConfig, BatchEngine
        from etl_tpu_torch.store import NotifyingStore
        from tests.test_torch_pipeline_e2e import (ACCOUNTS, make_db,
                                                   make_pipeline, wait_ready)

        db = make_db()
        db.create_publication("pub", [ACCOUNTS])
        dest = LakeDestination(LakeConfig(warehouse_path=str(tmp_path)))
        store = NotifyingStore()
        small = BatchConfig(max_size_bytes=4 * 1024, max_fill_ms=20,
                            batch_engine=BatchEngine.CUDA, device="cpu")
        p1, _, _ = make_pipeline(db, store=store, destination=dest,
                                 batch=small)
        await p1.start()
        await wait_ready(store, ACCOUNTS)
        n = 1200
        async with db.transaction() as tx:
            for i in range(n):
                tx.insert(ACCOUNTS, [str(7000 + i), "r" * 30, str(i)])
        await asyncio.sleep(0.05)  # likely mid-delivery of the transaction
        await p1.shutdown_and_wait()
        p2, _, _ = make_pipeline(db, store=store, destination=dest,
                                 batch=small)
        await p2.start()
        want = {7000 + i for i in range(n)}
        recs = []
        for _ in range(600):
            recs = dest.read_current(ACCOUNTS).to_pylist()
            if {r["id"] for r in recs} >= want:
                break
            await asyncio.sleep(0.05)
        assert {r["id"] for r in recs} >= want, "rows missing after restart"
        ids = [r["id"] for r in recs]
        assert len(ids) == len(set(ids)), "duplicate identities"
        await p2.shutdown_and_wait()


def _lake_has(dest, tid, key_value, key="id"):
    try:
        return any(r[key] == key_value
                   for r in dest.read_current(tid).to_pylist())
    except Exception:
        return False


# -- 2. parity with the reference ----------------------------------------------


def _m(pkg: str, sub: str):
    return importlib.import_module(f"{pkg}.{sub}")


PG_TID = 41090
KINDS_TID = 41091


def _pg_schema(pkg: str):
    """pgbench_accounts' shape (aid INT4 key, bid, abalance INT4, filler
    bpchar(84))."""
    M = _m(pkg, "models")
    return M.ReplicatedTableSchema.with_all_columns(M.TableSchema(
        PG_TID, M.TableName("public", "pgbench_accounts"),
        (M.ColumnSchema("aid", M.Oid.INT4, nullable=False,
                        primary_key_ordinal=1),
         M.ColumnSchema("bid", M.Oid.INT4),
         M.ColumnSchema("abalance", M.Oid.INT4),
         M.ColumnSchema("filler", M.Oid.BPCHAR))))


def _pg_events(pkg: str, seed: int) -> list:
    """pgbench-shaped row events made with numpy from `seed`: 40 inserts,
    8 full updates, 4 TOAST-unchanged updates of the filler, one
    key-changing update (a key-only old image), 3 deletes; one
    transaction each, WAL-ordered."""
    M = _m(pkg, "models")
    cell = _m(pkg, "models.cell")
    schema = _pg_schema(pkg)
    rng = np.random.default_rng(seed)
    n = 40
    bid = rng.integers(1, 10, n)
    bal = rng.integers(-5000, 5000, n)
    fill = ["x" * int(k) for k in rng.integers(0, 85, n)]
    evs = []

    def lsn():
        return M.Lsn(0x20000 + 0x10 * len(evs))

    for i in range(n):
        evs.append(M.InsertEvent(lsn(), lsn(), 0, schema, M.TableRow(
            [i + 1, int(bid[i]), int(bal[i]), fill[i]])))
    for i in rng.choice(n, 8, replace=False):
        evs.append(M.UpdateEvent(lsn(), lsn(), 0, schema, M.TableRow(
            [int(i) + 1, int(bid[i]), int(rng.integers(-9, 9)), fill[i]])))
    for i in rng.choice(n, 4, replace=False):
        evs.append(M.UpdateEvent(lsn(), lsn(), 0, schema, M.TableRow(
            [int(i) + 1, int(bid[i]), 777, cell.TOAST_UNCHANGED])))
    evs.append(M.UpdateEvent(
        lsn(), lsn(), 0, schema, M.TableRow([1000, 1, 5, "moved"]),
        _m(pkg, "models.table_row").PartialTableRow(
            [5, None, None, None], [True, False, False, False])))
    for i in (7, 8, 9):
        evs.append(M.DeleteEvent(lsn(), lsn(), 0, schema, M.TableRow(
            [i, None, None, None])))
    return evs


def _kinds_schema(pkg: str):
    M = _m(pkg, "models")
    O = M.Oid
    cols = [("pk", O.INT8), ("b", O.BOOL), ("i2", O.INT2), ("i4", O.INT4),
            ("f4", O.FLOAT4), ("f8", O.FLOAT8), ("num", O.NUMERIC),
            ("d", O.DATE), ("t", O.TIME), ("ts", O.TIMESTAMP),
            ("tstz", O.TIMESTAMPTZ), ("u", O.UUID), ("js", O.JSONB),
            ("by", O.BYTEA), ("s", O.TEXT)]
    return M.ReplicatedTableSchema.with_all_columns(M.TableSchema(
        KINDS_TID, M.TableName("public", "kinds"),
        tuple(M.ColumnSchema(name, oid, nullable=name != "pk",
                             primary_key_ordinal=1 if name == "pk" else None)
              for name, oid in cols)))


def _kinds_rows(pkg: str, start: int, n: int) -> list:
    """`tests/test_columnar_egress.py`'s every-kind rows."""
    M = _m(pkg, "models")
    cell = _m(pkg, "models.cell")
    rows = []
    for i in range(start, start + n):
        rows.append(M.TableRow([
            i, bool(i % 2) if i % 5 else None,
            (i - 3) * 7 if i % 4 else None, -i * 1000 if i % 3 else None,
            i * 0.5, i * 1.25e10,
            cell.PgNumeric("123456789012345678901234567890.%09d" % i),
            dt.date(2024, 5, (i % 28) + 1), dt.time(12, 34, 56, i),
            dt.datetime(2024, 5, 1, 1, 2, 3, 100000 + i),
            dt.datetime(2031, 12, 31, 23, 59, 59, 999990 + (i % 10),
                        tzinfo=dt.timezone.utc),
            uuid.UUID(int=i + 7), {"k": i} if i % 2 else cell.JSON_NULL,
            b"\x00\xffbytes-%d" % i,
            "str-%d\twith\ttabs" % i if i % 2 else None]))
    return rows


def _view(d, tid: int, key: str) -> dict:
    t = d.read_current(tid)
    return {"schema": t.schema.to_string(),
            "rows": sorted(t.to_pylist(), key=lambda r: r[key])}


def _catalog(d) -> dict:
    """The catalog's rows, with data paths and replay-epoch uuids
    masked (both random by design)."""
    db = d._catalog()

    def epoch(e):
        return e if e == "__legacy__" else "<uuid>"

    files = [(t, g, kind, rows, seq, epoch(ep), payload is not None,
              bool(path))
             for t, g, kind, rows, seq, ep, payload, path in db.execute(
                 "SELECT table_id, generation, kind, row_count, max_seq, "
                 "replay_epoch, inline_payload, path FROM lake_files "
                 "ORDER BY id")]
    tables = db.execute("SELECT table_id, name, schema_json, generation, "
                        "max_seq FROM lake_tables ORDER BY table_id"
                        ).fetchall()
    epochs = [(t, epoch(e), p) for t, e, p in db.execute(
        "SELECT table_id, replay_epoch, pending_replay_epoch FROM "
        "lake_replay_epochs ORDER BY table_id")]
    log = db.execute("SELECT commit_lsn, tx_ordinal, commit_end_lsn FROM "
                     "lake_commit_log").fetchall()
    tokens = db.execute("SELECT token FROM lake_replay_tokens ORDER BY "
                        "token").fetchall()
    entries = []
    for path, payload in db.execute(
            "SELECT path, inline_payload FROM lake_files ORDER BY id"):
        t = d._read_entry(path, payload)
        entries.append((t.schema.to_string(), t.to_pylist()))
    return {"files": files, "tables": tables, "epochs": epochs, "log": log,
            "tokens": tokens, "entries": entries}


def _history(d) -> list:
    return [{k: v for k, v in h.items()
             if k not in ("started_at", "finished_at")}
            | {"finished": h["finished_at"] is not None}
            for h in d.maintenance_history(limit=100)]


async def _lake_run(pkg: str, root) -> dict:
    """The parity scenario (module docstring) on `pkg`'s lake."""
    from tests.test_torch_destination_parity import _events

    lake = _m(pkg, "destinations.lake")
    base = _m(pkg, "destinations.base")
    M = _m(pkg, "models")
    ev = _events(pkg, None)
    kw = {"rng": random.Random(SEED)} if pkg == PORT else {}
    d = lake.LakeDestination(lake.LakeConfig(
        str(root), compact_min_files=6, inline_max_bytes=2048,
        inline_flush_bytes=6000), **kw)
    out: dict = {}
    await d.startup()
    await d.write_table_batch(ev["schema"], ev["copy"])
    await d.write_event_batches_committed(ev["cdc"], ev["commit"])
    high = await d.recover_high_water()
    out["high"] = (high.high, high.commit_end_lsn)
    replay = base.CommitRange(high=ev["commit"].high, replay=True)
    await d.write_event_batches_committed(ev["cdc"], replay)
    await d.write_event_batches_committed(ev["cdc"], replay)
    await d.write_event_batches(ev["cdc"])  # redelivery: watermark dedup
    pg = _pg_events(pkg, SEED)
    for lo in range(0, len(pg), 9):
        await d.write_events(pg[lo:lo + 9])
    ks = _kinds_schema(pkg)
    await d.write_table_rows(ks, M.ColumnarBatch.from_rows(
        ks, _kinds_rows(pkg, 0, 8)))
    await d.write_events([M.InsertEvent(M.Lsn(0x30000 + i),
                                        M.Lsn(0x30000 + i), 0, ks, row)
                          for i, row in enumerate(_kinds_rows(pkg, 8, 6))])
    tid = ev["schema"].id
    out["views"] = {"w": _view(d, tid, "id"),
                    "pg": _view(d, PG_TID, "aid"),
                    "kinds": _view(d, KINDS_TID, "pk")}
    out["catalog"] = _catalog(d)
    out["compact"] = [await d.compact(PG_TID), await d.compact(KINDS_TID),
                      await d.flush_inlined(tid)]
    out["views_compacted"] = {"pg": _view(d, PG_TID, "aid"),
                              "kinds": _view(d, KINDS_TID, "pk")}
    await d.write_events([ev["truncate"]])
    await d.write_events([M.InsertEvent(M.Lsn(0xB000), M.Lsn(0xB000), 0,
                                        ev["schema"], M.TableRow(
                                            [5, 1, None, True, "after"]))])
    out["vacuum"] = [await d.vacuum(t) for t in d.table_ids()]
    d.record_maintenance_skip(PG_TID, "compact")
    out["views_truncated"] = _view(d, tid, "id")
    out["catalog_end"] = _catalog(d)
    out["history"] = _history(d)
    out["counts"] = {t: (d.current_cdc_file_count(t),
                         d.pending_inline_bytes(t)) for t in d.table_ids()}
    await d.shutdown()
    return out


class TestLakeEqualsReference:
    async def test_same_writes_same_lake(self, tmp_path):
        """The parity scenario through both packages' lakes: equal high
        water, current views and Arrow schemas, catalog entries, masked
        catalog rows and maintenance history."""
        want = await _lake_run(REF, tmp_path / "ref")
        got = await _lake_run(PORT, tmp_path / "port")
        assert set(got) == set(want)
        for key in want:
            assert got[key] == want[key], key
        # the scenario exercised what it claims to
        assert len(want["views"]["pg"]["rows"]) == 40 - 3
        assert any(h["operation"] == "compact" and h["outcome"] == "ok"
                   for h in want["history"])
        assert any(f[6] for f in want["catalog"]["files"])  # inlined

    async def test_seeded_file_names_repeat(self, tmp_path):
        """The port draws its file names and replay epochs from the rng
        it is given: two runs on one seed name every file alike."""
        names = []
        for sub in ("a", "b"):
            d = LakeDestination(LakeConfig(str(tmp_path / sub)),
                                rng=random.Random(SEED))
            await d.startup()
            await d.write_table_rows(make_schema(),
                                     batch([[1, "a", None]]))
            await d.write_events([TruncateEvent(Lsn(1), Lsn(1), 0, 0,
                                                (make_schema(),))])
            await d.write_events([ins(0, [2, "b", None], lsn=0x300)])
            names.append((
                [os.path.basename(p) for (p,) in d._catalog().execute(
                    "SELECT path FROM lake_files ORDER BY id")],
                d.current_replay_epoch(TID)))
            await d.shutdown()
        assert names[0] == names[1]
        assert len(set(names[0][0])) == 2


# -- 3. the typed refusal without pyarrow --------------------------------------


NO_PYARROW = """
import json, sys
sys.modules["pyarrow"] = None
import etl_tpu_torch.destinations.lake as lake
import etl_tpu_torch.destinations.iceberg as iceberg
from etl_tpu_torch.models.errors import EtlError
out = {}
for name, make in (
        ("lake", lambda: lake.LakeDestination(lake.LakeConfig("/nowhere"))),
        ("iceberg", lambda: iceberg.IcebergDestination(
            iceberg.IcebergConfig("http://127.0.0.1:9", "/nowhere")))):
    try:
        make()
        out[name] = None
    except EtlError as e:
        out[name] = [e.kind.name, str(e)]
print(json.dumps(out))
"""


def test_refused_typed_without_pyarrow():
    """Where pyarrow cannot be imported, the modules import, and each
    destination refuses with CONFIG_INVALID naming pyarrow (through the
    registry: tests/test_torch_destinations.py)."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    proc = subprocess.run([sys.executable, "-c", NO_PYARROW],
                          capture_output=True, text=True, timeout=120,
                          cwd=ROOT, env=env)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert set(out) == {"lake", "iceberg"}
    for name, got in out.items():
        assert got is not None, name
        kind, msg = got
        assert kind == "CONFIG_INVALID" and "pyarrow" in msg, (name, msg)


CHIP_SMOKE_PHASE_19 = """
import argparse, json, sys
sys.modules["pyarrow"] = None
import chip_smoke
r = chip_smoke.lake_phase(argparse.Namespace(copy_rows=1000,
                                             cdc_events=1000, seed=7),
                          device="cpu")["19_lake"]
print(json.dumps({k: r[k] for k in ("pyarrow", "avro_ocf_cases",
                                    "refusals", "k1_launches")}))
"""


def test_chip_smoke_phase_19_without_pyarrow():
    """chip_smoke.py's phase 19 as on a host without pyarrow,
    on the CPU: the OCF cases run, and the lake, Iceberg, the
    maintenance command and a replicator with `destination: lake` each
    refuse with CONFIG_INVALID naming pyarrow."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    proc = subprocess.run([sys.executable, "-c", CHIP_SMOKE_PHASE_19],
                          capture_output=True, text=True, timeout=180,
                          cwd=ROOT, env=env)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "19(a) pyarrow imports: no" in proc.stdout
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["pyarrow"] is False and out["avro_ocf_cases"] == 300
    assert set(out["refusals"]) == {"lake", "iceberg", "maintenance",
                                    "replicator"}
    assert all("pyarrow" in m for m in out["refusals"].values())
    assert out["k1_launches"] == 0


def test_chip_smoke_phase_19_with_pyarrow(capsys):
    """chip_smoke.py's phase 19 as on the card's host, on the CPU at a
    small depth: (d) the lake, (e) Iceberg read back equal to the written
    rows, (f) the maintenance commands after (e), the view unchanged."""
    import argparse

    import chip_smoke

    r = chip_smoke.lake_phase(argparse.Namespace(copy_rows=3000,
                                                 cdc_events=2000, seed=7),
                              device="cpu")
    out = capsys.readouterr().out
    assert "19(a) pyarrow imports: yes" in out
    lake, ice = r["19_lake"], r["19e_iceberg"]
    assert lake["rows_ok"] and lake["lake_rows"] == 5000
    assert ice["ok"] and ice["live_rows"] == 5000
    assert lake["maintenance"]["view_equal"]
    assert lake["maintenance"]["cdc_files_after"] == 0
    assert lake["k1_launches"] == ice["k1_launches"] == 0
