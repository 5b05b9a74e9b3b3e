"""The workload profile catalog.

A `WorkloadProfile` is a small frozen data object describing one traffic
shape: the column mix of its tables, the seed-row count, the op mix per
transaction (insert/update/delete weights, pk-rekey and TOAST-unchanged
rates), the transaction granularity (many tiny vs one giant), and the
structural stressors (truncate storms, ALTER TABLE churn, partitioned
roots). `generator.WorkloadGenerator` turns a profile + a seed into a
deterministic stream of FakeTransaction commits.

Adding a profile: add an entry to `PROFILES` (and, if it needs a new
column mix, a function in `COLUMN_MIXES`). Every registered profile is
automatically covered by the determinism and decode round-trip tests in
the reference's tests/test_workloads.py. Copy of the reference's
`etl_tpu/workloads/profiles.py`; in the port, `python -m
etl_tpu_torch.chaos --workload <name>` drives a profile.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..models.pgtypes import Oid
from ..models.schema import ColumnSchema


def _basic_mix() -> tuple[ColumnSchema, ...]:
    """The pgbench-CDC shape every legacy bench/chaos run used."""
    return (ColumnSchema("id", Oid.INT8, nullable=False,
                         primary_key_ordinal=1),
            ColumnSchema("v", Oid.INT4),
            ColumnSchema("note", Oid.TEXT))


def _wide_mix() -> tuple[ColumnSchema, ...]:
    """120 columns of cycling types (the BASELINE wide-row shape, but
    driven through the full pipeline rather than decode isolation)."""
    kinds = (Oid.INT4, Oid.INT8, Oid.FLOAT8, Oid.TEXT, Oid.BOOL,
             Oid.NUMERIC, Oid.DATE, Oid.TIMESTAMP, Oid.TIMESTAMPTZ,
             Oid.UUID)
    cols = [ColumnSchema("id", Oid.INT8, nullable=False,
                         primary_key_ordinal=1)]
    cols += [ColumnSchema(f"c{i:03d}", kinds[i % len(kinds)])
             for i in range(119)]
    return tuple(cols)


def _numeric_ts_mix() -> tuple[ColumnSchema, ...]:
    """NUMERIC / timestamp dense: the column kinds whose decode is
    heaviest on the host-combine path."""
    cols = [ColumnSchema("id", Oid.INT8, nullable=False,
                         primary_key_ordinal=1)]
    for i in range(6):
        cols.append(ColumnSchema(f"amount{i}", Oid.NUMERIC))
    for i in range(3):
        cols.append(ColumnSchema(f"at{i}", Oid.TIMESTAMPTZ))
    cols.append(ColumnSchema("day", Oid.DATE))
    cols.append(ColumnSchema("ts", Oid.TIMESTAMP))
    return tuple(cols)


def _toast_mix() -> tuple[ColumnSchema, ...]:
    """A fat TEXT column (the TOAST candidate) plus narrow companions."""
    return (ColumnSchema("id", Oid.INT8, nullable=False,
                         primary_key_ordinal=1),
            ColumnSchema("payload", Oid.TEXT),  # the TOASTed column
            ColumnSchema("v", Oid.INT4),
            ColumnSchema("tag", Oid.TEXT))


COLUMN_MIXES = {
    "basic": _basic_mix,
    "wide": _wide_mix,
    "numeric_ts": _numeric_ts_mix,
    "toast": _toast_mix,
}


@dataclass(frozen=True)
class WorkloadProfile:
    """One named traffic shape. All randomness is drawn by the generator
    from its seeded RNG; the profile itself is pure configuration."""

    name: str
    description: str
    column_mix: str = "basic"
    tables: int = 1
    rows_per_table: int = 4  # seed rows copied before CDC starts
    rows_per_tx: int = 4  # row ops per transaction
    txs_per_step: int = 1  # transactions committed per generator step
    # op mix (normalized weights; delete/update apply only while enough
    # rows exist)
    insert_weight: float = 1.0
    update_weight: float = 0.0
    delete_weight: float = 0.0
    # 'd' (default: PK) or 'f' (full) — ALTER TABLE ... REPLICA IDENTITY
    replica_identity: str = "d"
    # fraction of updates that change the PRIMARY KEY (forces the 'K'
    # old-key tuple under default identity and the delete+upsert split
    # at key-aware destinations)
    rekey_rate: float = 0.0
    # fraction of updates that leave the TOAST candidate column unchanged
    # (the walsender then sends the 'u' unchanged-TOAST marker)
    toast_unchanged_rate: float = 0.0
    # every Nth step begins with TRUNCATE of every table, inside the same
    # transaction as the step's inserts (the storm interleaving)
    truncate_every: int | None = None
    # every Nth step runs ALTER TABLE (add/drop a column, alternating)
    # followed by a same-transaction backfill UPDATE of every live row
    ddl_every: int | None = None
    # partitioned root: each table becomes a 2-leaf partitioned table
    # published via the root (publish_via_partition_root)
    partitioned: bool = False
    # deletes never shrink a table below this many rows
    min_rows: int = 2
    # seeded poison-pill rate (docs/dead-letter.md): this fraction of
    # CDC-inserted rows (never seed/copy rows — isolation is a streaming
    # boundary) carry a `POISON-…` marker value in their last TEXT
    # column; the PoisonRejectingDestination refuses any write containing
    # one with DESTINATION_REJECTED, driving the bisection + DLQ path.
    # Only the first `poison_tables` tables are poisoned so survivor
    # tables prove delivery isolation during quarantine.
    poison_rate: float = 0.0
    poison_tables: int = 1
    # publication row filter SQL (PG15 WHERE clause, ops/predicate.py
    # subset) — evaluated CLIENT-SIDE: the generator sets the fake's
    # server_row_filtering=False (the filter-offload deployment), so the
    # walsender ships every row and only the fused decode filter stands
    # between excluded rows and the destination. End-state verification
    # then proves the device-side filter. Filtered profiles must stay
    # insert-only: UPDATE/DELETE row-filter transforms are walsender
    # semantics the client does not re-implement.
    row_filter: str | None = None

    def columns(self):
        return COLUMN_MIXES[self.column_mix]()


PROFILES: dict[str, WorkloadProfile] = {p.name: p for p in (
    WorkloadProfile(
        name="insert_heavy",
        description="pgbench-style insert CDC — the legacy baseline shape",
        insert_weight=1.0, rows_per_tx=8),
    WorkloadProfile(
        name="update_heavy_default",
        description="70% updates under REPLICA IDENTITY DEFAULT; 10% of "
                    "updates re-key the PK (the 'K' old-tuple path)",
        insert_weight=0.2, update_weight=0.7, delete_weight=0.1,
        rekey_rate=0.1, rows_per_table=8, rows_per_tx=6),
    WorkloadProfile(
        name="update_heavy_full",
        description="70% updates under REPLICA IDENTITY FULL (every "
                    "update ships the 'O' full old image)",
        insert_weight=0.2, update_weight=0.7, delete_weight=0.1,
        replica_identity="f", rekey_rate=0.1, rows_per_table=8,
        rows_per_tx=6),
    WorkloadProfile(
        name="delete_heavy_default",
        description="45% deletes under REPLICA IDENTITY DEFAULT (key-only "
                    "'K' delete tuples)",
        insert_weight=0.45, update_weight=0.1, delete_weight=0.45,
        rows_per_table=10, rows_per_tx=6),
    WorkloadProfile(
        name="delete_heavy_full",
        description="45% deletes under REPLICA IDENTITY FULL ('O' full "
                    "old rows on delete)",
        insert_weight=0.45, update_weight=0.1, delete_weight=0.45,
        replica_identity="f", rows_per_table=10, rows_per_tx=6),
    WorkloadProfile(
        name="wide_rows",
        description="120-column mixed-type rows through the full pipeline",
        column_mix="wide", insert_weight=0.6, update_weight=0.35,
        delete_weight=0.05, rows_per_table=4, rows_per_tx=4),
    WorkloadProfile(
        name="toast_heavy_full",
        description="update-heavy with 60% unchanged-TOAST markers under "
                    "REPLICA IDENTITY FULL (old image back-fills)",
        column_mix="toast", insert_weight=0.25, update_weight=0.7,
        delete_weight=0.05, replica_identity="f",
        toast_unchanged_rate=0.6, rows_per_table=6, rows_per_tx=5),
    WorkloadProfile(
        name="toast_heavy_default",
        description="unchanged-TOAST under REPLICA IDENTITY DEFAULT — no "
                    "old image, the column-wise PATCH path",
        column_mix="toast", insert_weight=0.25, update_weight=0.7,
        delete_weight=0.05, toast_unchanged_rate=0.6, rows_per_table=6,
        rows_per_tx=5),
    WorkloadProfile(
        name="numeric_timestamp_dense",
        description="NUMERIC/timestamp-dense columns (host-combine-heavy "
                    "decode mix)",
        column_mix="numeric_ts", insert_weight=0.5, update_weight=0.45,
        delete_weight=0.05, rows_per_table=6, rows_per_tx=5),
    WorkloadProfile(
        name="tiny_txs",
        description="many single-row transactions per step (commit-"
                    "boundary pressure: durable progress per row)",
        insert_weight=0.5, update_weight=0.4, delete_weight=0.1,
        rows_per_table=6, rows_per_tx=1, txs_per_step=8),
    WorkloadProfile(
        name="giant_tx",
        description="one giant transaction per step (run sealing + "
                    "mid-transaction flush splitting)",
        insert_weight=0.6, update_weight=0.3, delete_weight=0.1,
        rows_per_table=8, rows_per_tx=512),
    WorkloadProfile(
        name="truncate_storm",
        description="TRUNCATE interleaved with inserts in the same "
                    "transaction every 3rd step (the barrier ordering "
                    "stress across coalesced columnar batches)",
        insert_weight=0.8, update_weight=0.2, rows_per_table=5,
        rows_per_tx=6, truncate_every=3),
    WorkloadProfile(
        name="ddl_churn",
        description="ALTER TABLE add/drop column every 4th step with a "
                    "same-transaction backfill (mid-stream schema change)",
        insert_weight=0.55, update_weight=0.4, delete_weight=0.05,
        rows_per_table=5, rows_per_tx=4, ddl_every=4),
    # filter-selective family (ROADMAP item 4): the publication predicate
    # drops 90/50/10% of rows ("v" is uniform in [-10^6, 10^6)); the name
    # carries the KEEP percentage. Insert-only by the row_filter contract
    # above; byte-identical (profile, seed) replay holds like every other
    # profile — the filter changes what is DELIVERED, not what is
    # generated.
    WorkloadProfile(
        name="filter_selective_10",
        description="publication row filter keeps ~10% of rows (drops "
                    "90%) — the fused decode filter's best case",
        insert_weight=1.0, rows_per_tx=8, row_filter="v < -800000"),
    WorkloadProfile(
        name="filter_selective_50",
        description="publication row filter keeps ~50% of rows",
        insert_weight=1.0, rows_per_tx=8, row_filter="v < 0"),
    WorkloadProfile(
        name="filter_selective_90",
        description="publication row filter keeps ~90% of rows (drops "
                    "10%) — near-passthrough selectivity",
        insert_weight=1.0, rows_per_tx=8, row_filter="v < 800000"),
    WorkloadProfile(
        name="poison_rows",
        description="insert CDC where a seeded ~0.1% of rows carry a "
                    "POISON marker value the destination rejects "
                    "(DESTINATION_REJECTED) — drives batch bisection, "
                    "the dead-letter store, and per-table quarantine; "
                    "tables beyond the first stay clean as the "
                    "delivery-isolation control group",
        insert_weight=1.0, rows_per_tx=8, tables=3, rows_per_table=4,
        poison_rate=0.001, poison_tables=1),
    WorkloadProfile(
        name="partitioned_root",
        description="2-leaf partitioned tables published via the root "
                    "(publish_via_partition_root leaf→root mapping)",
        insert_weight=0.6, update_weight=0.3, delete_weight=0.1,
        rows_per_table=6, rows_per_tx=5, partitioned=True),
)}


def get_profile(name: str) -> WorkloadProfile:
    try:
        return PROFILES[name]
    except KeyError:
        raise KeyError(f"unknown workload profile {name!r}; known: "
                       f"{', '.join(sorted(PROFILES))}") from None


def profile_names() -> list[str]:
    return sorted(PROFILES)
