"""Deterministic workload generation over the fake walsender.

`WorkloadGenerator(profile, seed=N)` owns every source of randomness for
one run: it seeds `random.Random`, pins the FakeDatabase commit clock,
and draws all row values, op choices, and table choices from that one
stream — so one `(profile, seed)` pair replays a byte-identical WAL
payload sequence (asserted in tests/test_workloads.py).

The generator tracks the committed source truth as it goes (`expected`:
{table_id: {pk: tuple(decoded values)}}, mirroring the fake's storage but
in decoded-cell form), which is exactly what the chaos invariant checker
consumes — so the same object drives `bench.py --workload`, the chaos
corpus × profile matrix, and `devtools serve-source --workload`.
"""

from __future__ import annotations

import random
import uuid as uuid_mod

from ..models.pgtypes import Oid
from ..models.schema import TableName, TableSchema
from ..postgres.codec.text import parse_cell_text
from ..postgres.fake import TOAST_UNCHANGED_VALUE, FakeDatabase
from .profiles import WorkloadProfile, get_profile

BASE_TABLE_ID = 16384
#: leaf partition OIDs live in their own range so a matrix run never
#: collides them with root ids
LEAF_TABLE_BASE = 18000

#: epoch for the pinned commit clock (any fixed value works; this one
#: keeps timestamps in a plausible 2023 range for humans reading traces)
FIXED_CLOCK_US = 1_700_000_000_000_000


def wal_payloads(db: FakeDatabase) -> list[bytes]:
    """The raw pgoutput payload sequence of a fake database's WAL — the
    unit of the byte-identical determinism contract."""
    return [payload for (_, payload, _, _) in db.wal]


class WorkloadGenerator:
    """Incremental workload generator with the chaos runner's shape:
    `build_db()`, `run_tx(db)`, `table_ids`, `expected`, `tx_index`,
    `delivered(dest)` — the same interface the chaos runner's default
    workload exposes."""

    def __init__(self, profile: WorkloadProfile | str, seed: int | None = None,
                 rng: random.Random | None = None):
        if isinstance(profile, str):
            profile = get_profile(profile)
        self.profile = profile
        if rng is None:
            rng = random.Random(f"workload:{profile.name}:{seed}")
        self.rng = rng
        self.table_ids = [BASE_TABLE_ID + i for i in range(profile.tables)]
        # publication row filter (filter_selective_* profiles): the
        # committed-truth filter below and the fake walsender's catalog
        # SQL both derive from ONE parsed IR, so the generator's
        # `expected`, the server's (disabled) WHERE evaluation, and the
        # decoder's fused device filter can never disagree on a verdict
        self.row_filter = None
        self._row_pred = None
        if profile.row_filter:
            from ..ops.predicate import parse_row_filter

            if profile.update_weight or profile.delete_weight \
                    or profile.ddl_every or profile.truncate_every:
                # the client-filter envelope is insert-only (UPDATE/DELETE
                # row-filter transforms are walsender semantics): a
                # filtered profile with mutating traffic would deliver
                # unfiltered U/D batches and silently diverge from
                # `expected` — refuse at construction, not mid-run
                raise ValueError(
                    f"profile {profile.name!r}: row_filter requires an "
                    f"insert-only op mix (docs/workloads.md)")
            self.row_filter = parse_row_filter(profile.row_filter)
        # committed source truth, decoded-cell form (invariant checker's
        # `expected` input)
        self.expected: dict[int, dict[int, tuple]] = \
            {tid: {} for tid in self.table_ids}
        # the same rows in wire-text form (update/backfill ops re-send
        # unchanged columns as text)
        self._text: dict[int, dict[int, list[str | None]]] = \
            {tid: {} for tid in self.table_ids}
        self._schemas: dict[int, TableSchema] = {}
        self._leaves: dict[int, list[int]] = {}  # root -> leaf tids
        self._leaf_of: dict[int, dict[int, int]] = \
            {tid: {} for tid in self.table_ids}  # root -> pk -> leaf
        self._next_pk: dict[int, int] = {tid: 1 for tid in self.table_ids}
        self._ddl_step: dict[int, int] = {tid: 0 for tid in self.table_ids}
        # poison-pill seeding (docs/dead-letter.md): CDC inserts into the
        # first `poison_tables` tables carry a POISON marker at
        # `poison_rate`; seed/copy rows never do (the isolation boundary
        # is streaming CDC). The extra RNG draw happens ONLY for
        # poisoned profiles, so every other profile's byte-identical
        # replay contract is untouched.
        self._poison_tids = set(
            self.table_ids[:profile.poison_tables]) \
            if profile.poison_rate > 0 else set()
        self._seeding = False
        self.poison_pks: dict[int, set[int]] = \
            {tid: set() for tid in self.table_ids}
        self.tx_index = 0  # generator steps completed
        self.row_ops = 0  # Insert/Update/Delete ops committed (bench rate)

    # -- setup ----------------------------------------------------------------

    def build_db(self) -> FakeDatabase:
        p = self.profile
        self._seeding = True  # seed/copy rows are never poisoned
        db = FakeDatabase()
        db.clock_us = FIXED_CLOCK_US
        if p.ddl_every:
            # the DDL event trigger is part of this profile's contract;
            # installing it here (rather than waiting for the pipeline's
            # source migrations) keeps generator-only runs byte-identical
            # to in-pipeline runs
            db.ddl_trigger_installed = True
        for i, tid in enumerate(self.table_ids):
            schema = TableSchema(
                tid, TableName("public", f"wl_{p.name}_{i}"), p.columns())
            self._schemas[tid] = schema
            if self.row_filter is not None and self._row_pred is None:
                # every table shares the profile's column mix, so one
                # compiled text evaluator serves them all
                self._row_pred = self.row_filter.compile_texts(schema)
            seed_rows = []
            for _ in range(p.rows_per_table):
                pk, texts = self._new_row(tid, schema)
                seed_rows.append(texts)
                self._record_row(tid, schema, pk, texts)
            if p.partitioned:
                leaf_ids = [LEAF_TABLE_BASE + 2 * i, LEAF_TABLE_BASE + 2 * i + 1]
                self._leaves[tid] = leaf_ids
                leaves = {}
                for j, leaf in enumerate(leaf_ids):
                    rows = [r for r in seed_rows if int(r[0]) % 2 == j]
                    leaves[leaf] = (f"wl_{p.name}_{i}_p{j}", rows)
                db.create_partitioned_table(schema, leaves)
                for r in seed_rows:
                    pk = int(r[0])
                    self._leaf_of[tid][pk] = leaf_ids[pk % 2]
            else:
                db.create_table(schema, rows=seed_rows)
            if p.replica_identity == "f":
                db.set_replica_identity(tid, "f")
                if p.partitioned:
                    for leaf in self._leaves[tid]:
                        db.set_replica_identity(leaf, "f")
        if self.row_filter is None:
            db.create_publication("pub", list(self.table_ids))
        else:
            # filter-offload deployment: the catalog surfaces the WHERE
            # clause (so the pipeline compiles it into the fused decode
            # program) but the walsender ships EVERY row — delivery can
            # only match `expected` if the client-side filter works
            db.create_publication(
                "pub", list(self.table_ids),
                row_filters={
                    tid: (self.row_filter.sql,
                          self.row_filter.compile_texts(self._schemas[tid]))
                    for tid in self.table_ids})
            db.server_row_filtering = False
        self._seeding = False
        return db

    # -- value generation ------------------------------------------------------

    def _text_for(self, oid: int) -> str:
        rng = self.rng
        if oid in (Oid.INT8, Oid.INT4):
            return str(rng.randrange(-10**6, 10**6))
        if oid == Oid.FLOAT8:
            # dyadic fractions only: every correct parser (host codec,
            # device decode) lands on the identical float64, so the
            # invariant checker's value comparison is exact
            return f"{rng.randrange(-10**6, 10**6)}.{rng.choice(('0', '25', '5', '75'))}"
        if oid == Oid.BOOL:
            return rng.choice(("t", "f"))
        if oid == Oid.NUMERIC:
            return f"{rng.randrange(0, 10**9)}.{rng.randrange(0, 100):02d}"
        if oid == Oid.DATE:
            return f"2024-{rng.randrange(1, 13):02d}-{rng.randrange(1, 29):02d}"
        if oid == Oid.TIMESTAMP:
            return (f"2024-05-{rng.randrange(1, 29):02d} "
                    f"{rng.randrange(0, 24):02d}:{rng.randrange(0, 60):02d}"
                    f":{rng.randrange(0, 60):02d}.{rng.randrange(0, 10**6):06d}")
        if oid == Oid.TIMESTAMPTZ:
            return (f"2024-06-{rng.randrange(1, 29):02d} "
                    f"{rng.randrange(0, 24):02d}:{rng.randrange(0, 60):02d}"
                    f":{rng.randrange(0, 60):02d}.{rng.randrange(0, 10**6):06d}+00")
        if oid == Oid.UUID:
            return str(uuid_mod.UUID(int=rng.getrandbits(128)))
        return f"t-{rng.randrange(10**9)}"  # TEXT and friends

    def _new_row(self, tid: int, schema: TableSchema) -> tuple[int, list]:
        pk = self._next_pk[tid]
        self._next_pk[tid] += 1
        texts: list[str | None] = []
        for c in schema.columns:
            if c.is_primary_key:
                texts.append(str(pk))
            elif c.nullable and self.rng.random() < 0.05:
                texts.append(None)
            else:
                texts.append(self._text_for(c.type_oid))
        if self._poison_tids and not self._seeding \
                and tid in self._poison_tids \
                and self.rng.random() < self.profile.poison_rate:
            for i in range(len(schema.columns) - 1, -1, -1):
                c = schema.columns[i]
                if c.type_oid == Oid.TEXT and not c.is_primary_key:
                    texts[i] = f"POISON-{self.rng.randrange(10**6)}"
                    self.poison_pks[tid].add(pk)
                    break
        return pk, texts

    def _record_row(self, tid: int, schema: TableSchema, pk: int,
                    texts: list) -> None:
        self._text[tid][pk] = list(texts)
        if self._row_pred is not None and not self._row_pred(texts):
            # the publication's row filter excludes this row: the SOURCE
            # stores it (self._text keeps tracking it for update/delete
            # targeting) but it must never be DELIVERED
            self.expected[tid].pop(pk, None)
            return
        self.expected[tid][pk] = tuple(
            parse_cell_text(t, c.type_oid)
            for t, c in zip(texts, schema.columns))

    def _drop_row(self, tid: int, pk: int) -> None:
        del self._text[tid][pk]
        self.expected[tid].pop(pk, None)
        self._leaf_of[tid].pop(pk, None)

    # -- op targets ------------------------------------------------------------

    def _op_table(self, tid: int, pk: int | None) -> int:
        """The physical relation an op targets: the leaf holding `pk` for
        partitioned roots (new pks route by pk % leaves), else the root."""
        leaves = self._leaves.get(tid)
        if not leaves:
            return tid
        if pk is None:
            return tid
        leaf = self._leaf_of[tid].get(pk)
        if leaf is None:
            leaf = leaves[pk % len(leaves)]
            self._leaf_of[tid][pk] = leaf
        return leaf

    def _key_for(self, schema: TableSchema, pk: int) -> list:
        return [str(pk) if c.is_primary_key else None
                for c in schema.columns]

    # -- one step --------------------------------------------------------------

    async def run_tx(self, db: FakeDatabase) -> None:
        """One generator step: `txs_per_step` committed transactions of
        profile-shaped traffic (plus the step's structural stressor —
        truncate storm or DDL churn — when due)."""
        p = self.profile
        step = self.tx_index
        for n in range(p.txs_per_step):
            tid = self.table_ids[self.rng.randrange(len(self.table_ids))]
            schema = self._schemas[tid]
            async with db.transaction() as tx:
                # the structural stressors are PER STEP, not per
                # transaction — only the step's first transaction carries
                # them (a txs_per_step>1 profile would otherwise truncate
                # or ALTER once per transaction)
                if n == 0 and p.truncate_every and step > 0 \
                        and step % p.truncate_every == 0:
                    # truncate THEN insert inside one transaction: the
                    # destination must order the barrier between the
                    # preceding and following coalesced batches
                    tx.truncate(list(self.table_ids))
                    for t2 in self.table_ids:
                        self._text[t2].clear()
                        self.expected[t2].clear()
                        self._leaf_of[t2].clear()
                if n == 0 and p.ddl_every and step > 0 \
                        and step % p.ddl_every == 0:
                    schema = self._run_ddl(tx, tid, schema)
                for _ in range(p.rows_per_tx):
                    self._one_op(tx, tid, schema)
        self.tx_index += 1

    def _run_ddl(self, tx, tid: int, schema: TableSchema) -> TableSchema:
        """ALTER TABLE (add a TEXT column, or drop the last added one,
        alternating) + a same-transaction backfill UPDATE of every live
        row — the add-column-and-backfill migration shape. The backfill
        keeps every row's delivered image at the post-ALTER width, so the
        committed truth stays comparable whether or not a chaos recopy
        lands after the DDL."""
        n = self._ddl_step[tid]
        self._ddl_step[tid] += 1
        base = tuple(schema.columns)
        if n % 2 == 0:
            from ..models.schema import ColumnSchema

            new_schema = TableSchema(
                schema.id, schema.name,
                base + (ColumnSchema(f"x{n // 2}", Oid.TEXT),))
        else:
            # drop the column the previous DDL step added
            new_schema = TableSchema(schema.id, schema.name, base[:-1])
        tx.alter_table(tid, new_schema)
        self._schemas[tid] = new_schema
        old_names = [c.name for c in schema.columns]
        new_cols = new_schema.columns
        for pk in sorted(self._text[tid]):
            old_texts = self._text[tid][pk]
            by_name = dict(zip(old_names, old_texts))
            texts = []
            for c in new_cols:
                if c.name in by_name:
                    texts.append(by_name[c.name])
                else:
                    texts.append(self._text_for(c.type_oid))
            tx.update(self._op_table(tid, pk),
                      self._key_for(new_schema, pk), texts)
            self._record_row(tid, new_schema, pk, texts)
            self.row_ops += 1
        return new_schema

    def _one_op(self, tx, tid: int, schema: TableSchema) -> None:
        p = self.profile
        rng = self.rng
        exp = self._text[tid]
        live = sorted(exp)
        total = p.insert_weight + p.update_weight + p.delete_weight
        roll = rng.random() * total
        if roll < p.delete_weight and len(live) > p.min_rows:
            pk = live[rng.randrange(len(live))]
            tx.delete(self._op_table(tid, pk), self._key_for(schema, pk))
            self._drop_row(tid, pk)
        elif roll < p.delete_weight + p.update_weight and live:
            self._one_update(tx, tid, schema, live)
        else:
            pk, texts = self._new_row(tid, schema)
            tx.insert(self._op_table(tid, pk), texts)
            self._record_row(tid, schema, pk, texts)
        self.row_ops += 1

    def _one_update(self, tx, tid: int, schema: TableSchema,
                    live: list[int]) -> None:
        p = self.profile
        rng = self.rng
        pk = live[rng.randrange(len(live))]
        old_texts = self._text[tid][pk]
        new_pk = pk
        if p.rekey_rate and rng.random() < p.rekey_rate:
            new_pk = self._next_pk[tid]
            self._next_pk[tid] += 1
        toast_cols: set[int] = set()
        if p.toast_unchanged_rate and rng.random() < p.toast_unchanged_rate:
            # leave the TOAST candidate column (the fat TEXT one, index 1
            # in the toast mix) unchanged — the walsender sends 'u'
            toast_cols.add(1)
        values: list = []
        expected_texts: list[str | None] = []
        for i, c in enumerate(schema.columns):
            if c.is_primary_key:
                values.append(str(new_pk))
                expected_texts.append(str(new_pk))
            elif i in toast_cols:
                values.append(TOAST_UNCHANGED_VALUE)
                expected_texts.append(old_texts[i])  # storage keeps it
            else:
                t = self._text_for(c.type_oid)
                values.append(t)
                expected_texts.append(t)
        tx.update(self._op_table(tid, pk), self._key_for(schema, pk),
                  values)
        if new_pk != pk:
            leaf = self._leaf_of[tid].get(pk)
            self._drop_row(tid, pk)
            if leaf is not None:
                # the row object stays in its original leaf (the fake
                # updates rows in place); track the new pk there
                self._leaf_of[tid][new_pk] = leaf
        self._record_row(tid, schema, new_pk, expected_texts)

    # -- verification ----------------------------------------------------------

    def delivered(self, dest) -> bool:
        """True when the destination's reconstructed final view equals the
        committed source truth (same collapse rules as the chaos
        invariant checker)."""
        from ..chaos.invariants import view_matches

        return view_matches(dest, self.table_ids, self.expected)

    def describe(self) -> dict:
        p = self.profile
        return {
            "profile": p.name,
            "column_mix": p.column_mix,
            "tables": p.tables,
            "replica_identity": p.replica_identity,
            "partitioned": p.partitioned,
            "tx_index": self.tx_index,
            "row_ops": self.row_ops,
        }


def make_chaos_workload(profile_name: str,
                        rng: random.Random) -> WorkloadGenerator:
    """The chaos runner's entry point: a generator drawing from the
    scenario's own seeded RNG, so one (scenario, profile, seed) triple
    replays the identical workload and injection interleaving."""
    return WorkloadGenerator(get_profile(profile_name), rng=rng)
