"""Replication-lag queries.

Reference parity: crates/etl-postgres/src/lag.rs:14-82 —
`pg_replication_slots` ⟕ `pg_stat_replication` join producing
`SlotLagMetrics{wal_status, restart/confirmed_flush lag bytes,
safe_wal_size, write/flush/replay lag ms}` for the API's
replication-status surface.

Copy of the reference's `etl_tpu/postgres/lag.py`.
"""

from __future__ import annotations

from dataclasses import dataclass

from .wire import PgWireConnection


@dataclass(frozen=True)
class SlotLagMetrics:
    slot_name: str
    active: bool
    wal_status: str  # reserved | extended | unreserved | lost
    restart_lsn_lag_bytes: int
    confirmed_flush_lag_bytes: int
    safe_wal_size_bytes: int | None
    write_lag_ms: float | None
    flush_lag_ms: float | None
    replay_lag_ms: float | None


LAG_QUERY = """
SELECT s.slot_name,
       s.active,
       COALESCE(s.wal_status, 'reserved'),
       pg_current_wal_lsn() - s.restart_lsn,
       pg_current_wal_lsn() - s.confirmed_flush_lsn,
       s.safe_wal_size,
       EXTRACT(EPOCH FROM r.write_lag) * 1000,
       EXTRACT(EPOCH FROM r.flush_lag) * 1000,
       EXTRACT(EPOCH FROM r.replay_lag) * 1000
FROM pg_replication_slots s
LEFT JOIN pg_stat_replication r ON r.pid = s.active_pid
WHERE s.slot_name LIKE 'supabase_etl_%'
""".strip()


def _opt_float(v: str | None) -> float | None:
    return float(v) if v not in (None, "") else None


async def query_slot_lag(conn: PgWireConnection) -> list[SlotLagMetrics]:
    result = await conn.query(LAG_QUERY)
    out = []
    for row in result.rows:
        out.append(SlotLagMetrics(
            slot_name=row[0],
            active=row[1] == "t",
            wal_status=row[2] or "reserved",
            restart_lsn_lag_bytes=int(row[3] or 0),
            confirmed_flush_lag_bytes=int(row[4] or 0),
            safe_wal_size_bytes=int(row[5]) if row[5] not in (None, "")
            else None,
            write_lag_ms=_opt_float(row[6]),
            flush_lag_ms=_opt_float(row[7]),
            replay_lag_ms=_opt_float(row[8])))
    return out
