"""Destination dispatch from configuration.

Reference parity: the replicator's destination config enum → instance
dispatch (crates/etl-replicator/src/core/destinations.rs, 417 LoC).

Copy of the reference's `etl_tpu/destinations/registry.py`. Only `memory`
builds: the port has the ClickHouse and Snowflake encoders but none of the
network destinations yet, so each of the reference's other types is
refused with a typed CONFIG_INVALID that names it (ROADMAP.md, queue 1).
"""

from __future__ import annotations

from typing import Any

from ..models.errors import ErrorKind, EtlError
from .base import Destination
from .memory import MemoryDestination

#: the reference's other destination types, not ported yet
NOT_PORTED = ("clickhouse", "bigquery", "lake", "iceberg", "snowflake")


def build_destination(doc: dict[str, Any]) -> Destination:
    """{"type": "...", ...params} → Destination instance."""
    kind = doc.get("type")
    if kind == "memory":
        return MemoryDestination()
    if kind in NOT_PORTED:
        raise EtlError(ErrorKind.CONFIG_INVALID,
                       f"destination {kind!r} is not ported to etl_tpu_torch "
                       "yet (ROADMAP.md, queue 1); this package builds "
                       "'memory'")
    raise EtlError(ErrorKind.CONFIG_INVALID,
                   f"unknown destination type {kind!r}")
