"""Destination dispatch from configuration.

Reference parity: the replicator's destination config enum → instance
dispatch (crates/etl-replicator/src/core/destinations.rs, 417 LoC).

Copy of the reference's `etl_tpu/destinations/registry.py`: `memory`,
`clickhouse`, `bigquery` and `snowflake` build as there. `lake` and
`iceberg` are refused with a typed CONFIG_INVALID: they write Parquet
through pyarrow, which the port does not require (ROADMAP.md, queue 1).
"""

from __future__ import annotations

from typing import Any

from ..models.errors import ErrorKind, EtlError
from .base import Destination
from .memory import MemoryDestination

#: the reference's Parquet destinations, not ported yet
NOT_PORTED = ("lake", "iceberg")


def build_destination(doc: dict[str, Any]) -> Destination:
    """{"type": "...", ...params} → Destination instance."""
    kind = doc.get("type")
    params = {k: v for k, v in doc.items() if k != "type"}
    if kind in NOT_PORTED:
        raise EtlError(ErrorKind.CONFIG_INVALID,
                       f"destination {kind!r} is not ported to etl_tpu_torch "
                       "yet: it needs pyarrow's Parquet writer, and the port "
                       "runs where pyarrow is not installed (ROADMAP.md, "
                       "queue 1); this package builds 'memory', "
                       "'clickhouse', 'bigquery' and 'snowflake'")
    try:
        if kind == "memory":
            return MemoryDestination()
        if kind == "clickhouse":
            from .clickhouse import (ClickHouseConfig, ClickHouseDestination,
                                     ClickHouseEngine)

            if "engine" in params:
                params["engine"] = ClickHouseEngine(params["engine"])
            return ClickHouseDestination(ClickHouseConfig(**params))
        if kind == "bigquery":
            from .bigquery import BigQueryConfig, BigQueryDestination

            return BigQueryDestination(BigQueryConfig(**params))
        if kind == "snowflake":
            from .snowflake import SnowflakeConfig, SnowflakeDestination

            return SnowflakeDestination(SnowflakeConfig(**params))
    except (TypeError, ValueError) as e:
        raise EtlError(ErrorKind.CONFIG_INVALID,
                       f"destination {kind!r}: {e}")
    raise EtlError(ErrorKind.CONFIG_INVALID,
                   f"unknown destination type {kind!r}")
