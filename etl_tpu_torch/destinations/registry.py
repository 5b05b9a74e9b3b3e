"""Destination dispatch from configuration.

Reference parity: the replicator's destination config enum → instance
dispatch (crates/etl-replicator/src/core/destinations.rs, 417 LoC).

Copy of the reference's `etl_tpu/destinations/registry.py`: `memory`,
`clickhouse`, `bigquery`, `lake`, `iceberg` and `snowflake` build as
there. `lake` and `iceberg` write Parquet through pyarrow: where it
cannot be imported (the card's machine), building either raises a typed
CONFIG_INVALID naming pyarrow.
"""

from __future__ import annotations

from typing import Any

from ..models.errors import ErrorKind, EtlError
from .base import Destination
from .memory import MemoryDestination


def build_destination(doc: dict[str, Any]) -> Destination:
    """{"type": "...", ...params} → Destination instance."""
    kind = doc.get("type")
    params = {k: v for k, v in doc.items() if k != "type"}
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
        if kind == "lake":
            from .lake import LakeConfig, LakeDestination

            return LakeDestination(LakeConfig(**params))
        if kind == "iceberg":
            from .iceberg import IcebergConfig, IcebergDestination

            return IcebergDestination(IcebergConfig(**params))
        if kind == "snowflake":
            from .snowflake import SnowflakeConfig, SnowflakeDestination

            return SnowflakeDestination(SnowflakeConfig(**params))
    except (TypeError, ValueError) as e:
        raise EtlError(ErrorKind.CONFIG_INVALID,
                       f"destination {kind!r}: {e}")
    raise EtlError(ErrorKind.CONFIG_INVALID,
                   f"unknown destination type {kind!r}")
