"""Replication slot naming.

Reference parity: crates/etl-postgres/src/slots.rs:16-18,49-120 —
`supabase_etl_apply_{pipeline}` and
`supabase_etl_table_sync_{pipeline}_{table}`, bounded by Postgres' 63-byte
identifier limit, with parsing helpers for cleanup sweeps.

Sharded extension (docs/sharding.md): when a publication is split across
K replicator pods, every slot carries an `_s{shard}` suffix —
`supabase_etl_apply_{pipeline}_s{shard}` and
`supabase_etl_table_sync_{pipeline}_{table}_s{shard}` — so each shard
owns its own replication stream and durable-progress keys, and a cleanup
sweep can enumerate one shard's slots without touching its siblings'.

Parsing is anchored from the RIGHT: the trailing `_s{shard}` (if any) is
stripped first, then the fixed-count integer fields; a name whose
trailing segments carry extra underscores is rejected instead of being
split ambiguously.

Copy of the reference's `etl_tpu/postgres/slots.py`.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..models.errors import ErrorKind, EtlError
from ..models.schema import TableId

SLOT_PREFIX = "supabase_etl"
MAX_SLOT_LEN = 63


def _shard_suffix(shard: int | None) -> str:
    if shard is None:
        return ""
    if shard < 0:
        raise EtlError(ErrorKind.CONFIG_INVALID,
                       f"shard index must be >= 0, got {shard}")
    return f"_s{shard}"


def apply_slot_name(pipeline_id: int, shard: int | None = None) -> str:
    name = f"{SLOT_PREFIX}_apply_{pipeline_id}{_shard_suffix(shard)}"
    _check(name)
    return name


def table_sync_slot_name(pipeline_id: int, table_id: TableId,
                         shard: int | None = None) -> str:
    name = (f"{SLOT_PREFIX}_table_sync_{pipeline_id}_{table_id}"
            f"{_shard_suffix(shard)}")
    _check(name)
    return name


def _check(name: str) -> None:
    if len(name.encode()) > MAX_SLOT_LEN:
        raise EtlError(ErrorKind.SLOT_NAME_TOO_LONG, name)


@dataclass(frozen=True)
class ParsedSlot:
    pipeline_id: int
    table_id: TableId | None  # None = apply slot
    shard: int | None = None  # None = unsharded deployment

    @property
    def is_apply(self) -> bool:
        return self.table_id is None


def _parse_int(token: str) -> int | None:
    """Strict non-negative decimal: int() would also accept '+1', '_',
    and surrounding whitespace, all of which a real slot sweep should
    treat as foreign names, not ours."""
    return int(token) if token.isdigit() else None


def _split_shard(rest: str) -> tuple[str, int | None] | None:
    """Strip a trailing `_s{int}` shard suffix (parsed from the right).
    Returns (remainder, shard) or None when a malformed `_s` suffix is
    present (e.g. `_s` with no digits)."""
    head, sep, tail = rest.rpartition("_")
    if sep and tail.startswith("s"):
        shard = _parse_int(tail[1:])
        if shard is None:
            return None  # `_sXY`: claims the shard shape but isn't one
        return head, shard
    return rest, None


def parse_slot_name(name: str) -> ParsedSlot | None:
    """Parse a framework slot name; None if it isn't ours.

    Round-trip contract (property-tested): for every name produced by
    `apply_slot_name` / `table_sync_slot_name`, parsing returns exactly
    the ids that built it. Fields are consumed from the RIGHT — shard
    suffix, then table id, then pipeline id — so any leftover or extra
    `_`-separated material rejects the name instead of aliasing one
    field into another."""
    if name.startswith(f"{SLOT_PREFIX}_apply_"):
        rest = name[len(f"{SLOT_PREFIX}_apply_"):]
        split = _split_shard(rest)
        if split is None:
            return None
        rest, shard = split
        pid = _parse_int(rest)
        if pid is None:
            return None
        return ParsedSlot(pid, None, shard)
    if name.startswith(f"{SLOT_PREFIX}_table_sync_"):
        rest = name[len(f"{SLOT_PREFIX}_table_sync_"):]
        split = _split_shard(rest)
        if split is None:
            return None
        rest, shard = split
        head, sep, tail = rest.rpartition("_")
        if not sep:
            return None
        pid, tid = _parse_int(head), _parse_int(tail)
        if pid is None or tid is None:
            return None
        return ParsedSlot(pid, tid, shard)
    return None


def slots_for_pipeline(names: list[str], pipeline_id: int,
                       shard: int | None = None) -> list[str]:
    """Cleanup helper: all of a pipeline's slots among `names`. With
    `shard` given, only that shard's slots (an unsharded deployment's
    slots never match a shard filter and vice versa)."""
    out = []
    for n in names:
        p = parse_slot_name(n)
        if p is not None and p.pipeline_id == pipeline_id \
                and (shard is None or p.shard == shard):
            out.append(n)
    return out
