"""FakeSource: an in-memory walsender with Postgres replication semantics.

Implements ReplicationSource faithfully enough to exercise every runtime
path the reference tests against a real Postgres (SURVEY §4.2): slots with
consistent points, MVCC row snapshots taken at slot creation, publication
row membership, pgoutput-encoded WAL with Begin/Commit/Relation framing,
confirmed_flush advancement from standby status updates, keepalives, slot
invalidation injection, and concurrent streams.

Tests drive it through `FakeDatabase`: create tables, add them to a
publication, and run transactions (`async with db.transaction() as tx`)
whose DML is encoded into real pgoutput bytes — so the entire decode stack
runs in end-to-end tests exactly as in production.

Copy of the reference's `etl_tpu/postgres/fake.py`.
"""

from __future__ import annotations

import asyncio
import copy
import time
from dataclasses import dataclass, field
from typing import AsyncIterator

from ..models.errors import ErrorKind, EtlError
from ..models.lsn import Lsn
from ..models.schema import (ColumnMask, ReplicatedTableSchema, TableId,
                             TableSchema)
from .codec import pgoutput
from .codec.copy_text import encode_copy_row
from .source import (CopyStream, CreatedSlot, ReplicationSource,
                     ReplicationStream, SlotInfo)


def _now_us() -> int:
    return int(time.time() * 1_000_000)


class _ToastUnchanged:
    """Sentinel for an UNCHANGED TOASTED column in FakeTransaction.update:
    the walsender omits such values ('u' tuple kind) when the old image
    isn't being sent — the storage keeps the real value."""

    def __repr__(self) -> str:
        return "FAKE_TOAST_UNCHANGED_VALUE"


TOAST_UNCHANGED_VALUE = _ToastUnchanged()


@dataclass
class FakeTable:
    schema: TableSchema
    rows: list[list[str | None]] = field(default_factory=list)  # text-format
    replica_identity: int = ord("d")
    partition_parent: "TableId | None" = None  # leaf → its partitioned root
    partition_leaves: "list[TableId]" = field(default_factory=list)
    # COPY-text lines cached 1:1 with `rows` (a real walsender renders COPY
    # text server-side — keeping the Python encode off the pipeline's core
    # mirrors that). Maintained on append, dropped on in-place mutation.
    encoded: "list[bytes] | None" = None

    def append_row(self, values: list) -> None:
        self.rows.append(list(values))
        if self.encoded is not None:
            self.encoded.append(encode_copy_row(values))

    def invalidate_encoded(self) -> None:
        self.encoded = None


@dataclass
class _FakeSlot:
    name: str
    consistent_point: Lsn
    confirmed_flush: Lsn
    snapshot_id: str
    invalidated: bool = False
    active: bool = False


class FakeDatabase:
    """Shared source-database state; FakeSource connections attach to it."""

    def __init__(self) -> None:
        self.tables: dict[TableId, FakeTable] = {}
        self.publications: dict[str, list[TableId]] = {}
        # publication column filters: (publication, table) -> column names
        self.column_filters: dict[tuple[str, TableId], list[str]] = {}
        # PG15 row filters: (publication, table) -> predicate over the
        # row's text values (the walsender-side WHERE clause analogue);
        # row_filter_sql carries the textual predicate surfaced through
        # pg_publication_tables.rowfilter for the wire client's COPY
        self.row_filters: dict[tuple[str, TableId], "callable"] = {}
        self.row_filter_sql: dict[tuple[str, TableId], str] = {}
        # True (faithful PG15): the walsender/COPY evaluate row filters at
        # send time. False models the FILTER-OFFLOAD deployment (or a PG14
        # walsender): the server ships every row and the catalog still
        # surfaces the filter SQL, so the client's fused decode filter
        # (ops/predicate.py) is the only thing between excluded rows and
        # the destination — end-state verification then proves the
        # device-side filter, not the fake's
        self.server_row_filtering = True
        # (start_lsn, payload, table_id|None, row_texts|None) — the row
        # metadata lets streams evaluate publication row filters the way
        # the walsender evaluates WHERE clauses at send time
        self.wal: list[tuple[Lsn, bytes, TableId | None,
                             list[str | None] | None]] = []
        self._lsn = 0x1000
        # snapshot id → {table id → (rows, COPY-line cache | None)}
        self.snapshots: dict[
            str, dict[TableId,
                      tuple[list[list[str | None]], list[bytes] | None]]] = {}
        self.slots: dict[str, _FakeSlot] = {}
        self._wal_cond = asyncio.Condition()
        self.active_streams: list["_FakeReplicationStream"] = []
        self._snapshot_seq = 0
        self._relation_sent: set[tuple[int, int]] = set()  # (stream id, table)
        self.is_standby = False  # read replica: pg_is_in_recovery() = true
        self.applied_migrations: list[str] = []
        self.ddl_trigger_installed = False
        self.standbys: list["FakeStandby"] = []  # physical replicas
        # deterministic commit clock: when set, commit timestamps advance
        # from this value instead of reading the wall clock — one
        # (workload, seed) pair then replays a byte-identical WAL stream
        # (workloads/generator.py determinism contract)
        self.clock_us: int | None = None

    def commit_clock_us(self) -> int:
        if self.clock_us is not None:
            self.clock_us += 1_000
            return self.clock_us
        return _now_us()

    # -- test-facing setup ----------------------------------------------------

    def create_table(self, schema: TableSchema,
                     rows: list[list[str | None]] | None = None) -> FakeTable:
        t = FakeTable(schema=schema, rows=list(rows or []),
                      encoded=[encode_copy_row(r) for r in rows or []])
        self.tables[schema.id] = t
        return t

    def create_partitioned_table(
            self, parent: TableSchema,
            leaves: "dict[TableId, tuple[str, list[list[str | None]]]]"
    ) -> FakeTable:
        """Partitioned root + its leaf partitions. `leaves` maps
        leaf_id → (leaf_name, rows); leaves share the parent's columns.
        Publications list the ROOT (publish_via_partition_root): the
        walsender maps leaf row changes to the root relid."""
        p = FakeTable(schema=parent, rows=[], encoded=[])
        p.partition_leaves = list(leaves)
        self.tables[parent.id] = p
        for leaf_id, (leaf_name, rows) in leaves.items():
            leaf = FakeTable(schema=TableSchema(
                leaf_id, type(parent.name)(parent.name.schema, leaf_name),
                parent.columns), rows=list(rows),
                encoded=[encode_copy_row(r) for r in rows])
            leaf.partition_parent = parent.id
            self.tables[leaf_id] = leaf
        return p

    def wal_relid(self, table_id: TableId) -> TableId:
        """publish_via_partition_root mapping: a leaf's WAL changes are
        attributed to the published root."""
        t = self.tables.get(table_id)
        if t is not None and t.partition_parent is not None:
            parent = t.partition_parent
            if any(parent in tids for tids in self.publications.values()):
                return parent
        return table_id

    def set_replica_identity(self, table_id: TableId, identity: str) -> None:
        """'d' (default: PK) or 'f' (full) — ALTER TABLE ... REPLICA IDENTITY."""
        assert identity in ("d", "f"), identity
        self.tables[table_id].replica_identity = ord(identity)

    def create_publication(self, name: str, table_ids: list[TableId],
                           column_filters: dict[TableId, list[str]] | None = None,
                           row_filters: "dict[TableId, callable] | None" = None
                           ) -> None:
        self.publications[name] = list(table_ids)
        for tid, cols in (column_filters or {}).items():
            self.column_filters[(name, tid)] = cols
        for tid, pred in (row_filters or {}).items():
            if isinstance(pred, tuple):
                sql_text, fn = pred
                self.row_filter_sql[(name, tid)] = sql_text
                self.row_filters[(name, tid)] = fn
            else:
                self.row_filters[(name, tid)] = pred

    def next_lsn(self, advance: int = 8) -> Lsn:
        self._lsn += advance
        return Lsn(self._lsn)

    @property
    def current_lsn(self) -> Lsn:
        return Lsn(self._lsn)

    async def append_wal(self, payload: bytes, advance: int = 8,
                         table_id: TableId | None = None,
                         row: "list[str | None] | None" = None) -> Lsn:
        lsn = self.next_lsn(advance)
        self.wal.append((lsn, payload, table_id, row))
        async with self._wal_cond:
            self._wal_cond.notify_all()
        await self._replicate()
        return lsn

    async def append_wal_many(
            self, entries: "list[tuple[bytes, TableId | None, list | None]]"
    ) -> Lsn:
        """Append a transaction's entries with ONE reader wakeup — the
        per-entry condition-variable round trip otherwise dominates
        high-rate producers (each entry still advances the LSN by 8,
        identical to sequential append_wal calls)."""
        wal = self.wal
        lsn = self._lsn
        for payload, tid, row in entries:
            lsn += 8
            # plain int, not Lsn: the hot consumers (drain_spans, the
            # wire server loop) want ints anyway; Lsn construction per
            # entry measurably drags high-rate producers. Readers that
            # build frames wrap at the boundary (_next_buffered).
            wal.append((lsn, payload, tid, row))
        self._lsn = lsn
        async with self._wal_cond:
            self._wal_cond.notify_all()
        await self._replicate()
        return Lsn(lsn)

    def row_filter_allows(self, publication: str, table_id: TableId | None,
                          row: "list[str | None] | None") -> bool:
        if not self.server_row_filtering:
            return True  # filter-offload mode: the client's decode filters
        if table_id is None or row is None:
            return True
        pred = self.row_filters.get((publication, table_id))
        return True if pred is None else bool(pred(row))

    def transaction(self, xid: int | None = None) -> "FakeTransaction":
        return FakeTransaction(self, xid or (len(self.wal) + 100))

    # -- physical replication (reference pipeline_read_replica.rs) -------------

    def make_replica(self, snapshot_gate: bool = False) -> "FakeStandby":
        """Attach a physical read replica. `snapshot_gate=True` models
        PG16 logical-slot creation on a standby blocking until the
        primary logs a standby snapshot record."""
        sb = FakeStandby(self, snapshot_gate=snapshot_gate)
        self.standbys.append(sb)
        return sb

    async def _replicate(self) -> None:
        for sb in self.standbys:
            if sb.auto_replay:
                await sb.replay()

    async def log_standby_snapshot(self) -> None:
        """pg_log_standby_snapshot(): emits the running-xacts record that
        lets logical slot creation on a standby reach a consistent point
        (reference wait_with_standby_snapshots)."""
        for sb in self.standbys:
            sb._snapshot_logged.set()
            async with sb._wal_cond:
                sb._wal_cond.notify_all()

    async def wait_slot_creation_allowed(self) -> None:
        return None  # primaries never gate slot creation

    def invalidate_slot(self, name: str) -> None:
        self.slots[name].invalidated = True

    async def sever_streams(self) -> None:
        """Chaos helper: cut every live replication stream (the
        NetworkChaos partition analogue)."""
        for s in list(self.active_streams):
            await s.close()
        self.active_streams.clear()

    # -- walsender internals ---------------------------------------------------

    def take_snapshot(self) -> str:
        self._snapshot_seq += 1
        sid = f"fake-snap-{self._snapshot_seq}"
        # shallow list copies: row objects are immutable by convention
        # (updates REPLACE the row list, _apply_update) — deepcopy here
        # measured 4.7s/100k rows of pure machinery on the copy bench,
        # and even per-row copies cost 0.2s/snapshot
        self.snapshots[sid] = {
            tid: (list(t.rows),
                  list(t.encoded) if t.encoded is not None else None)
            for tid, t in self.tables.items()}
        return sid


class FakeTransaction:
    """Builds one transaction's pgoutput WAL entries, applying row changes
    to table state on commit (so later snapshots see them)."""

    def __init__(self, db: FakeDatabase, xid: int):
        self.db = db
        self.xid = xid
        self._ops: list[tuple] = []

    async def __aenter__(self) -> "FakeTransaction":
        return self

    async def __aexit__(self, et, ev, tb) -> None:
        if et is None:
            await self.commit()

    def insert(self, table_id: TableId, values: list[str | None]) -> None:
        self._ops.append(("I", table_id, values, None))

    def insert_preencoded(self, table_id: TableId, payload: bytes,
                          values: "list[str | None] | None" = None) -> None:
        """Insert whose pgoutput payload the caller already encoded (bench
        producers encode off the clock so the measured window holds only
        walsender framing + the pipeline). `values` feeds row filters and
        table state; None skips both (fine when neither is in play)."""
        self._ops.append(("P", table_id, payload, values))

    def update(self, table_id: TableId, key: list[str | None],
               new_values: list[str | None]) -> None:
        self._ops.append(("U", table_id, new_values, key))

    def delete(self, table_id: TableId, key: list[str | None]) -> None:
        self._ops.append(("D", table_id, None, key))

    def truncate(self, table_ids: list[TableId], options: int = 0) -> None:
        self._ops.append(("T", tuple(table_ids), options, None))

    def logical_message(self, prefix: str, content: bytes) -> None:
        self._ops.append(("M", prefix, content, None))

    def alter_table(self, table_id: TableId, new_schema: TableSchema) -> None:
        """ALTER TABLE: applies the new schema; if the source migrations
        installed the DDL event trigger AND the table is published, the
        trigger emits a supabase_etl_ddl logical message transactionally
        (reference migrations/source/...schema_change_messages.up.sql)."""
        self._ops.append(("A", table_id, new_schema, None))

    async def commit(self) -> Lsn:
        db = self.db
        ts = db.commit_clock_us()
        begin_at = db.current_lsn + 8

        # Relation messages are emitted lazily before a table's first row
        # op, with the schema CURRENT AT THAT POINT — an ALTER earlier in
        # the transaction must be reflected, exactly like the walsender's
        # per-connection relation cache invalidation. (PG sends per-
        # connection; putting them in the WAL makes replays self-
        # describing, which the apply loop tolerates — repeated RELATION
        # is idempotent.)
        relation_sent: set[TableId] = set()
        body_entries: list[bytes] = []

        def emit_relation(tid: TableId) -> None:
            t = db.tables[tid]
            cols = [((1 if c.is_primary_key else 0), c.name, c.type_oid,
                     c.modifier) for c in t.schema.columns]
            body_entries.append((pgoutput.encode_relation(
                tid, t.schema.name.schema, t.schema.name.name, cols,
                replica_identity=t.replica_identity), None, None))
            relation_sent.add(tid)

        if all(op[0] == "P" and op[3] is None for op in self._ops):
            # fast path for pre-encoded row bursts (bench producers):
            # same WAL as the general loop below — relation messages per
            # distinct target, then the payloads verbatim — without the
            # per-op dispatch, which otherwise gates how fast a producer
            # can feed the pipeline on a single core
            targets = {tid: db.wal_relid(tid)
                       for tid in {op[1] for op in self._ops}}
            for target in targets.values():
                if target not in relation_sent:
                    emit_relation(target)
            # the walsender knows every change's relation — carrying it on
            # the WAL entry spares readers a payload re-parse
            body_entries.extend((op[2], targets[op[1]], None)
                                for op in self._ops)
            self._ops = []
        for op in self._ops:
            kind = op[0]
            if kind in ("I", "U", "D", "P"):
                # publish_via_partition_root: leaf changes carry the root's
                # relid (and the root's RELATION message) in the WAL
                target = db.wal_relid(op[1])
                if target not in relation_sent:
                    emit_relation(target)
            if kind == "P":
                _, tid, payload, values = op
                body_entries.append(
                    (payload, target if values is not None else None, values))
                if values is not None:
                    db.tables[tid].append_row(values)
            elif kind == "I":
                _, tid, values, _ = op
                target = db.wal_relid(tid)
                body_entries.append((pgoutput.encode_insert(
                    target,
                    [None if v is None else v.encode() for v in values]),
                    target, list(values)))
                db.tables[tid].append_row(values)
            elif kind == "U":
                _, tid, values, key = op
                t = db.tables[tid]
                kcols = self._key_columns(t)
                old_row = self._find_row(t, key)

                def enc(vs):
                    return [None if v is None
                            or isinstance(v, _ToastUnchanged)
                            else v.encode() for v in vs]

                def kinds_of(vs):
                    return [pgoutput.TUPLE_UNCHANGED_TOAST
                            if isinstance(v, _ToastUnchanged)
                            else pgoutput.TUPLE_NULL if v is None
                            else pgoutput.TUPLE_TEXT for v in vs]
                # PG semantics: identity-full sends the full old row ('O');
                # default identity sends a key-only tuple ('K') ONLY when
                # an identity column changed; otherwise no old tuple
                old_values = key_values = None
                if t.replica_identity == ord("f") and old_row is not None:
                    old_values = enc(old_row)
                elif old_row is not None and any(
                        old_row[i] != values[i] for i in kcols):
                    key_values = enc([old_row[i] if i in kcols else None
                                      for i in range(len(old_row))])
                target = db.wal_relid(tid)
                # row filters evaluate against REAL tuple values (the
                # walsender resolves TOAST from storage before filtering)
                resolved = [
                    (old_row[i] if old_row is not None else None)
                    if isinstance(v, _ToastUnchanged) else v
                    for i, v in enumerate(values)]
                body_entries.append((pgoutput.encode_update(
                    target, enc(values), old_values=old_values,
                    key_values=key_values,
                    new_kinds=kinds_of(values)), target, resolved))
                self._apply_update(t, key, values)
            elif kind == "D":
                _, tid, _, key = op
                t = db.tables[tid]
                kcols = self._key_columns(t)
                old_row = self._find_row(t, key)
                if t.replica_identity == ord("f") and old_row is not None:
                    tup = old_row
                    full = True
                else:
                    src = old_row if old_row is not None else key
                    tup = [src[i] if i in kcols else None
                           for i in range(len(src))]
                    full = False
                target = db.wal_relid(tid)
                body_entries.append((pgoutput.encode_delete(
                    target, [None if v is None else v.encode() for v in tup],
                    full_old=full), target, list(key)))
                self._apply_delete(t, key)
            elif kind == "T":
                _, tids, options, _ = op
                body_entries.append((pgoutput.encode_truncate(
                    list(tids), options), None, None))
                for tid in tids:
                    db.tables[tid].rows.clear()
                    if db.tables[tid].encoded is not None:
                        db.tables[tid].encoded.clear()
            elif kind == "A":
                _, tid, new_schema, _ = op
                t = db.tables[tid]
                old_names = [c.name for c in t.schema.columns]
                new_names = [c.name for c in new_schema.columns]
                if new_names != old_names:
                    # ALTER with column changes rewrites storage: existing
                    # rows are projected onto the new column list by name
                    # (added columns NULL, dropped columns gone) — without
                    # this, a later update/delete's old image would carry
                    # the pre-ALTER column count against the post-ALTER
                    # RELATION message, which a real walsender can never
                    # produce
                    idx = {n: i for i, n in enumerate(old_names)}
                    t.rows[:] = [
                        [row[idx[n]] if n in idx else None
                         for n in new_names] for row in t.rows]
                    t.invalidate_encoded()
                t.schema = new_schema
                relation_sent.discard(tid)
                published = any(tid in tids
                                for tids in db.publications.values())
                if db.ddl_trigger_installed and published:
                    from .codec.event import (DDL_MESSAGE_PREFIX,
                                              encode_schema_change)

                    body_entries.append((pgoutput.encode_logical_message(
                        DDL_MESSAGE_PREFIX,
                        encode_schema_change(tid, new_schema),
                        lsn=int(db.current_lsn)), None, None))
            elif kind == "M":
                _, prefix, content, _ = op
                body_entries.append((pgoutput.encode_logical_message(
                    prefix, content, lsn=int(db.current_lsn)), None, None))

        n_entries = len(body_entries) + 2  # + begin + commit
        commit_lsn = Lsn(int(begin_at) + 8 * (n_entries - 1))
        entries = [(pgoutput.encode_begin(int(commit_lsn), ts, self.xid),
                    None, None)]
        entries.extend(body_entries)
        entries.append((pgoutput.encode_commit(int(commit_lsn),
                                               int(commit_lsn) + 8, ts),
                        None, None))
        await db.append_wal_many(entries)
        return commit_lsn

    def _key_columns(self, t: FakeTable) -> list[int]:
        pk = [i for i, c in enumerate(t.schema.columns) if c.is_primary_key]
        return pk or list(range(len(t.schema.columns)))

    def _find_row(self, t: FakeTable, key) -> list | None:
        kcols = self._key_columns(t)
        for row in t.rows:
            if all(row[i] == key[i] for i in kcols):
                return list(row)
        return None

    def _apply_update(self, t: FakeTable, key, values) -> None:
        t.invalidate_encoded()
        kcols = self._key_columns(t)
        for idx, row in enumerate(t.rows):
            if all(row[i] == key[i] for i in kcols):
                # REPLACE the row object (never mutate in place): snapshots
                # hold shallow references to row lists, so in-place writes
                # would leak post-snapshot state into exported snapshots.
                # unchanged-TOAST cells keep their stored value, exactly
                # like Postgres storage
                t.rows[idx] = [row[i] if isinstance(v, _ToastUnchanged)
                               else v for i, v in enumerate(values)]
                return

    def _apply_delete(self, t: FakeTable, key) -> None:
        t.invalidate_encoded()
        kcols = self._key_columns(t)
        t.rows[:] = [r for r in t.rows
                     if not all(r[i] == key[i] for i in kcols)]


class FakeStandby(FakeDatabase):
    """Physical read replica of a FakeDatabase (reference
    pipeline_read_replica.rs semantics on the fake):

    - shares cluster-wide logical state (tables, publications, filters)
      with the primary BY REFERENCE — physical replication replays the
      whole cluster;
    - maintains its OWN WAL view bounded by `replay()` — streams on the
      replica only see WAL the standby has replayed;
    - owns its OWN slot map: ETL's logical slots live on the replica, the
      primary keeps none (pipeline_read_replica.rs:294-297);
    - optionally gates slot creation until the primary logs a standby
      snapshot (PG16 logical decoding on standby,
      wait_with_standby_snapshots);
    - rejects writes (pg_is_in_recovery).

    Approximation: COPY snapshots read the shared table store, so they see
    the primary's latest rows — the reference tests likewise wait for full
    catch-up before starting copies."""

    def __init__(self, primary: FakeDatabase, *,
                 snapshot_gate: bool = False):
        super().__init__()
        self.primary = primary
        self.is_standby = True
        self.tables = primary.tables
        self.publications = primary.publications
        self.column_filters = primary.column_filters
        self.row_filters = primary.row_filters
        self.row_filter_sql = primary.row_filter_sql
        self.ddl_trigger_installed = primary.ddl_trigger_installed
        self.auto_replay = True
        self.snapshot_gate = snapshot_gate
        self._snapshot_logged = asyncio.Event()
        self._replay_index = 0
        self._lsn = primary._lsn

    async def replay(self, upto: Lsn | None = None) -> None:
        """Replay primary WAL up to `upto` (default: full catch-up) and
        wake streams waiting on the replica."""
        target = int(upto) if upto is not None else self.primary._lsn
        src = self.primary.wal
        while (self._replay_index < len(src)
               and int(src[self._replay_index][0]) <= target):
            self.wal.append(src[self._replay_index])
            self._lsn = int(src[self._replay_index][0])
            self._replay_index += 1
        # fully-replayed standbys track the primary's position even when
        # the trailing WAL carries no logical records (keepalive LSNs)
        self._lsn = max(self._lsn, min(target, self.primary._lsn))
        async with self._wal_cond:
            self._wal_cond.notify_all()

    def transaction(self, xid: int | None = None) -> "FakeTransaction":
        if self.is_standby:
            raise AssertionError(
                "cannot write to a standby (pg_is_in_recovery) — write "
                "to the primary and replay()")
        return super().transaction(xid)

    async def promote(self) -> None:
        """pg_promote(): final catch-up replay, detach from the primary,
        leave recovery. The node keeps its replayed WAL and its logical
        slots (slots survive promotion on PG16+) and accepts writes
        from here on; the old primary gets no further reads."""
        await self.replay()
        self.is_standby = False
        if self in self.primary.standbys:
            self.primary.standbys.remove(self)
        # private DEEP copies: post-promotion writes/DDL on the old
        # primary must not leak in by reference (FakeTable.rows and
        # .schema are mutated in place), and writes on the promoted
        # node must not mutate the old primary's storage
        self.tables = copy.deepcopy(self.tables)
        self.publications = {k: list(v)
                             for k, v in self.publications.items()}
        self.column_filters = copy.deepcopy(self.column_filters)
        self.row_filters = copy.deepcopy(self.row_filters)
        self.row_filter_sql = dict(self.row_filter_sql)

    async def wait_slot_creation_allowed(self) -> None:
        if self.snapshot_gate:
            await self._snapshot_logged.wait()


def _sent_lsn(db: "FakeDatabase", wal_index: int, pos_lsn) -> Lsn:
    """A walsender's sent position over `db.wal` read up to `wal_index`:
    the next unread entry's LSN (a restart there re-sends it), or the
    server's end once every entry is read."""
    if wal_index < len(db.wal):
        return Lsn(max(int(db.wal[wal_index][0]), int(pos_lsn)))
    return db.current_lsn


class _FakeReplicationStream(ReplicationStream):
    _ids = 0

    def __init__(self, db: FakeDatabase, slot: _FakeSlot, publication: str,
                 start_lsn: Lsn, keepalive_interval_s: float):
        self.db = db
        self.slot = slot
        self.publication = publication
        self.pos_lsn = start_lsn
        self._closed = False
        self._keepalive_interval = keepalive_interval_s
        self.status_updates: list[tuple[Lsn, Lsn, Lsn]] = []
        _FakeReplicationStream._ids += 1
        self.id = _FakeReplicationStream._ids
        self._wal_index = 0
        self._pub_tables = None
        db.active_streams.append(self)

    def __aiter__(self) -> AsyncIterator[pgoutput.ReplicationFrame]:
        return self._frames()

    def _next_buffered(self, clock_us: int | None = None
                       ) -> "pgoutput.XLogData | None":
        """Next already-written WAL frame, or None when caught up."""
        db = self.db
        if self._pub_tables is None:
            self._pub_tables = set(db.publications.get(self.publication, []))
        while self._wal_index < len(db.wal):
            lsn, payload, tid, row = db.wal[self._wal_index]
            self._wal_index += 1
            # START_REPLICATION is INCLUSIVE of the requested LSN: the
            # next tx's BEGIN sits exactly at the prior commit's end
            if lsn < self.pos_lsn:
                continue
            if not self._publication_allows(payload, self._pub_tables):
                continue
            if not db.row_filter_allows(self.publication, tid, row):
                continue
            return pgoutput.XLogData(
                start_lsn=Lsn(lsn), end_lsn=db.current_lsn,
                clock_us=clock_us if clock_us is not None else _now_us(),
                payload=payload)
        return None

    def drain_buffered(self, max_n: int) -> list:
        """Bulk-read already-buffered frames without event-loop round
        trips (the apply loop's per-frame asyncio overhead otherwise caps
        CDC throughput). One clock read serves the whole window."""
        out = []
        if self._closed or self.slot.invalidated:
            return out
        clock = _now_us()
        while len(out) < max_n:
            f = self._next_buffered(clock)
            if f is None:
                break
            out.append(f)
        return out

    def drain_spans(self, max_n: int) -> list:
        """Span-drain straight off the WAL: row runs become FrameSpans
        with int LSNs and the payload bytes already in hand — no XLogData
        / Lsn object per event (the walsender-side half of the CDC hot
        path; wal entries carry (lsn, payload, relid, row) so neither the
        relid nor the filters need a payload re-parse)."""
        from .source import SPAN_MAX_ROWS, FrameSpan

        out: list = []
        if self._closed or self.slot.invalidated:
            return out
        db = self.db
        if self._pub_tables is None:
            self._pub_tables = set(db.publications.get(self.publication, []))
        pub_tables = self._pub_tables
        wal = db.wal
        wal_len = len(wal)
        end = int(db._lsn)
        clock = None
        span_relid = -1  # sentinel: no open span
        span_payloads: list | None = None
        span_lsns: list | None = None
        span_room = 0
        count = 0
        idx = self._wal_index
        pos = self.pos_lsn
        pub = self.publication
        filters = db.row_filters
        # 73/85/68 = I/U/D — integer compare beats a bytes-slice + tuple
        # membership test on this per-event loop
        while idx < wal_len and count < max_n:
            lsn, payload, tid, row = wal[idx]
            idx += 1
            # START_REPLICATION is INCLUSIVE of the requested LSN (see
            # _next_buffered)
            if lsn < pos:
                continue
            tag = payload[0]
            if tag == 73 or tag == 85 or tag == 68:
                # pre-encoded WAL entries (bench producers) don't carry a
                # table_id column — fall back to the payload's relid
                rid = tid if tid is not None \
                    else int.from_bytes(payload[1:5], "big")
                if rid not in pub_tables:
                    continue
                if filters and not db.row_filter_allows(pub, tid, row):
                    continue
                count += 1
                if rid == span_relid and span_room > 0:
                    span_payloads.append(payload)
                    span_lsns.append(int(lsn))
                    span_room -= 1
                else:
                    span_payloads = [payload]
                    span_lsns = [int(lsn)]
                    span_relid = rid
                    span_room = SPAN_MAX_ROWS - 1
                    out.append(FrameSpan(rid, span_payloads, span_lsns,
                                         end))
                continue
            if not self._publication_allows(payload, pub_tables):
                continue
            if not db.row_filter_allows(pub, tid, row):
                continue
            count += 1
            span_relid = -1
            if clock is None:
                clock = _now_us()
            out.append(pgoutput.XLogData(
                start_lsn=Lsn(lsn), end_lsn=db.current_lsn,
                clock_us=clock, payload=payload))
        self._wal_index = idx
        return out

    async def _frames(self):
        db = self.db
        while not self._closed:
            if self.slot.invalidated:
                raise EtlError(ErrorKind.SLOT_INVALIDATED,
                               f"slot {self.slot.name} invalidated")
            frame = self._next_buffered()
            if frame is not None:
                yield frame
                continue
            # wait for more WAL or emit keepalive on timeout
            try:
                async with db._wal_cond:
                    await asyncio.wait_for(db._wal_cond.wait(),
                                           timeout=self._keepalive_interval)
            except asyncio.TimeoutError:
                yield pgoutput.PrimaryKeepalive(
                    end_lsn=self.sent_lsn(), clock_us=_now_us(),
                    reply_requested=True)

    def sent_lsn(self) -> Lsn:
        """The walsender's sent position, which a keepalive carries: all
        WAL before the next entry this stream has not read yet, or the
        server's end once it is caught up. The timeout that yields a
        keepalive can fire after a commit appended WAL but before the
        stream read it; the server's end would then report unsent WAL as
        received, an idle client would confirm it, and a restart would
        resume past rows it never got."""
        return _sent_lsn(self.db, self._wal_index, self.pos_lsn)

    def _publication_allows(self, payload: bytes,
                            pub_tables: set[TableId]) -> bool:
        tag = payload[0:1]
        if tag in (b"I", b"U", b"D", b"R"):
            rid = int.from_bytes(payload[1:5], "big")
            return rid in pub_tables
        if tag == b"T":
            # truncate lists relations; deliver if any is published
            n = int.from_bytes(payload[1:5], "big")
            rids = [int.from_bytes(payload[6 + 4 * i : 10 + 4 * i], "big")
                    for i in range(n)]
            return any(r in pub_tables for r in rids)
        return True  # begin/commit/message flow through

    async def send_status_update(self, written: Lsn, flushed: Lsn,
                                 applied: Lsn,
                                 reply_requested: bool = False) -> None:
        if self._closed:
            return  # a closed connection carries no feedback to the slot
        self.status_updates.append((written, flushed, applied))
        if flushed > self.slot.confirmed_flush:
            self.slot.confirmed_flush = flushed

    async def close(self) -> None:
        self._closed = True
        self.slot.active = False
        if self in self.db.active_streams:
            self.db.active_streams.remove(self)


class _FakeCopyStream(CopyStream):
    def __init__(self, rows: list[list[str | None]], chunk_rows: int = 512,
                 encoded: "list[bytes] | None" = None):
        self._rows = rows
        self._chunk_rows = chunk_rows
        self._encoded = encoded  # pre-rendered COPY lines, 1:1 with rows

    def __aiter__(self):
        return self._chunks()

    async def _chunks(self):
        enc = self._encoded
        for i in range(0, len(self._rows), self._chunk_rows):
            lines = enc[i : i + self._chunk_rows] if enc is not None else \
                [encode_copy_row(r) for r in self._rows[i : i + self._chunk_rows]]
            chunk = b"\n".join(lines)
            yield chunk + b"\n" if chunk else b""
            await asyncio.sleep(0)  # yield to the loop like real IO


class FakeSource(ReplicationSource):
    """One connection to a FakeDatabase."""

    def __init__(self, db: FakeDatabase,
                 keepalive_interval_s: float = 0.05):
        self.db = db
        self.connected = False
        self._keepalive_interval = keepalive_interval_s
        self.streams: list[_FakeReplicationStream] = []

    async def connect(self) -> None:
        self.connected = True

    async def close(self) -> None:
        self.connected = False
        for s in self.streams:
            await s.close()

    async def publication_exists(self, publication: str) -> bool:
        return publication in self.db.publications

    async def get_publication_table_ids(self, publication: str) -> list[TableId]:
        if publication not in self.db.publications:
            raise EtlError(ErrorKind.PUBLICATION_NOT_FOUND, publication)
        return list(self.db.publications[publication])

    async def get_table_schema(self, table_id: TableId, publication: str,
                               snapshot_id: str | None = None
                               ) -> ReplicatedTableSchema:
        t = self.db.tables.get(table_id)
        if t is None:
            raise EtlError(ErrorKind.PUBLICATION_TABLE_MISSING,
                           f"table {table_id}")
        schema = t.schema
        n = len(schema.columns)
        filt = self.db.column_filters.get((publication, table_id))
        repl_mask = (ColumnMask.from_column_names(schema, filt) if filt
                     else ColumnMask.all_set(n))
        identity = ColumnMask(c.is_primary_key for c in schema.columns)
        if identity.count() == 0:
            identity = ColumnMask.all_set(n) \
                if t.replica_identity == ord("f") else ColumnMask([False] * n)
        out = ReplicatedTableSchema(schema, repl_mask, identity)
        # leaf partitions inherit the published ROOT's row filter, same as
        # the column filters above (pg_publication_tables lists the root)
        sql = self.db.row_filter_sql.get(
            (publication, self.db.wal_relid(table_id)))
        if sql:
            from ..ops.predicate import RowFilterError, parse_row_filter

            try:
                out = out.with_row_predicate(parse_row_filter(sql))
            except RowFilterError:
                pass  # outside the client envelope; server-side only
        return out

    async def get_row_filters(self, publication: str) -> "dict[TableId, str]":
        return {tid: sql
                for (pub, tid), sql in self.db.row_filter_sql.items()
                if pub == publication}

    async def get_current_wal_lsn(self) -> Lsn:
        return self.db.current_lsn

    async def is_in_recovery(self) -> bool:
        return self.db.is_standby

    async def get_partition_leaves(
            self, table_id: TableId) -> list[tuple[TableId, int, int]]:
        t = self.db.tables.get(table_id)
        if t is None or not t.partition_leaves:
            return []
        out = []
        for leaf_id in t.partition_leaves:
            leaf = self.db.tables[leaf_id]
            n = len(leaf.rows)
            out.append((leaf_id, n, max(1, n // 64)))
        return out

    async def applied_source_migrations(self) -> list[str]:
        return list(self.db.applied_migrations)

    async def apply_source_migration(self, name: str, sql: str) -> None:
        # the fake models the migration's EFFECT: the DDL event trigger is
        # installed, so ALTER TABLE through FakeTransaction emits the
        # supabase_etl_ddl logical message (the installed path)
        self.db.ddl_trigger_installed = True
        self.db.applied_migrations.append(name)

    async def get_slot(self, name: str) -> SlotInfo | None:
        s = self.db.slots.get(name)
        if s is None:
            return None
        return SlotInfo(name=s.name, confirmed_flush_lsn=s.confirmed_flush,
                        active=s.active, invalidated=s.invalidated)

    async def create_slot(self, name: str) -> CreatedSlot:
        if name in self.db.slots:
            raise EtlError(ErrorKind.SLOT_ALREADY_EXISTS, name)
        # on a standby, logical slot creation blocks until the primary
        # logs a standby snapshot (PG16; FakeStandby.snapshot_gate)
        await self.db.wait_slot_creation_allowed()
        point = self.db.current_lsn
        sid = self.db.take_snapshot()
        self.db.slots[name] = _FakeSlot(
            name=name, consistent_point=point, confirmed_flush=point,
            snapshot_id=sid)
        return CreatedSlot(name=name, consistent_point=point, snapshot_id=sid)

    async def delete_slot(self, name: str) -> None:
        self.db.slots.pop(name, None)

    async def copy_table_stream(self, table_id: TableId, publication: str,
                                snapshot_id: str,
                                ctid_range: "tuple[int, int] | None" = None,
                                publication_table_id: "TableId | None" = None
                                ) -> CopyStream:
        snap = self.db.snapshots.get(snapshot_id)
        if snap is None:
            raise EtlError(ErrorKind.SNAPSHOT_EXPORT_FAILED, snapshot_id)
        rows, encoded = snap.get(table_id, ([], None))
        # a leaf partition inherits the published root's row/column filters
        pub_tid = self.db.wal_relid(table_id)
        pred = self.db.row_filters.get((publication, pub_tid)) \
            if self.db.server_row_filtering else None
        if pred is not None:
            rows = [r for r in rows if pred(r)]
            encoded = None  # filtered subset no longer aligns with the cache
        if ctid_range is not None:
            # fake pages: 64 rows per heap page
            lo, hi = ctid_range
            rows = rows[lo * 64 : hi * 64]
            if encoded is not None:
                encoded = encoded[lo * 64 : hi * 64]
        filt = self.db.column_filters.get((publication, pub_tid))
        if filt:
            schema = self.db.tables[table_id].schema
            idx = [schema.column_index(c) for c in filt]
            rows = [[r[i] for i in idx] for r in rows]
            encoded = None
        return _FakeCopyStream(rows, encoded=encoded)

    async def estimate_table_stats(self, table_id: TableId) -> tuple[int, int]:
        n = len(self.db.tables[table_id].rows)
        return n, max(1, n // 64)

    async def start_replication(self, slot_name: str, publication: str,
                                start_lsn: Lsn) -> ReplicationStream:
        slot = self.db.slots.get(slot_name)
        if slot is None:
            raise EtlError(ErrorKind.SLOT_NOT_FOUND, slot_name)
        if slot.invalidated:
            raise EtlError(ErrorKind.SLOT_INVALIDATED, slot_name)
        slot.active = True
        start = max(start_lsn, slot.confirmed_flush)
        stream = _FakeReplicationStream(self.db, slot, publication, start,
                                        self._keepalive_interval)
        self.streams.append(stream)
        return stream
