"""Config validation for sources and destinations.

Reference parity: crates/etl-api/src/validation/ (trait-based validator
framework, mod.rs:1-170, validators/{source,destination,bigquery,
clickhouse,snowflake,iceberg,ducklake}.rs) behind the
`POST /v1/sources:validate` and `POST /v1/destinations:validate` routes
(routes/destinations.rs:468-516, routes/common.rs:67-79).

Two layers, matching the reference split:
  - STATIC shape checks (required fields, types) — run by the CRUD create/
    update routes as reject-before-store, no network;
  - LIVE probes (connect to the source, ping the destination service) —
    run only by the :validate routes, returning `validation_failures`
    with critical/warning severity rather than erroring, so operators
    can inspect everything wrong at once.
"""

from __future__ import annotations

import asyncio
from dataclasses import dataclass

import aiohttp


@dataclass(frozen=True)
class ValidationFailure:
    name: str
    reason: str
    failure_type: str = "critical"  # "critical" | "warning"

    def to_json(self) -> dict:
        return {"name": self.name, "reason": self.reason,
                "failure_type": self.failure_type}


def critical(name: str, reason: str) -> ValidationFailure:
    return ValidationFailure(name, reason, "critical")


def warning(name: str, reason: str) -> ValidationFailure:
    return ValidationFailure(name, reason, "warning")


# -- static shape (reject-before-store) --------------------------------------

_SOURCE_REQUIRED = ("host", "port", "name", "username")

_DESTINATION_REQUIRED: dict[str, tuple[str, ...]] = {
    "bigquery": ("project_id", "dataset_id", "base_url"),
    "clickhouse": ("url", "database"),
    "snowflake": ("base_url", "account", "user", "database"),
    "iceberg": ("catalog_url", "warehouse_path"),
    "lake": ("warehouse_path",),
    "memory": (),
}


def validate_source_shape(config: dict) -> list[ValidationFailure]:
    out = []
    for field in _SOURCE_REQUIRED:
        if not config.get(field):
            out.append(critical(
                f"Missing {field}",
                f"source config requires a non-empty `{field}`"))
    port = config.get("port")
    if port is not None and not (isinstance(port, int)
                                 and 0 < port < 65536):
        out.append(critical("Invalid port",
                            f"`port` must be 1-65535, got {port!r}"))
    return out


def validate_destination_shape(config: dict) -> list[ValidationFailure]:
    dtype = config.get("type")
    if dtype not in _DESTINATION_REQUIRED:
        return [critical(
            "Unknown destination type",
            f"`type` must be one of {sorted(_DESTINATION_REQUIRED)}, "
            f"got {dtype!r}")]
    out = []
    for field in _DESTINATION_REQUIRED[dtype]:
        if not config.get(field):
            out.append(critical(
                f"Missing {field}",
                f"{dtype} destination requires a non-empty `{field}`"))
    return out


# -- live probes (the :validate routes) --------------------------------------


async def validate_source(config: dict,
                          publication: str | None = None,
                          timeout_s: float = 10.0
                          ) -> list[ValidationFailure]:
    """Static shape + a real replication-capable connection: auth, server
    version support (14-18, version.rs), and — when a pipeline config
    names one — publication existence (validators/source.rs stance: best
    effort, no invasive probes)."""
    out = validate_source_shape(config)
    if out:
        return out
    from ..config.pipeline import PgConnectionConfig, TlsConfig
    from ..postgres.client import PgReplicationClient
    from ..postgres.version import POSTGRES_14, POSTGRES_18

    tls = config.get("tls") or {}
    conn_config = PgConnectionConfig(
        host=config["host"], port=int(config["port"]),
        name=config["name"], username=config["username"],
        password=config.get("password"),
        tls=TlsConfig(enabled=bool(tls.get("enabled")),
                      trusted_root_certs=tls.get("trusted_root_certs", "")))
    client = PgReplicationClient(conn_config)
    try:
        await asyncio.wait_for(client.connect(), timeout_s)
    except asyncio.TimeoutError:
        return out + [critical(
            "Source unreachable",
            f"connection to {config['host']}:{config['port']} timed out "
            f"after {timeout_s:.0f}s")]
    except Exception as e:
        return out + [critical("Source connection failed", str(e)[:300])]
    try:
        ver = client.server_version
        if ver < POSTGRES_14:
            out.append(critical(
                "Unsupported Postgres version",
                f"server reports {ver}; ETL supports Postgres 14-18"))
        elif ver >= POSTGRES_18 + 10000:
            out.append(warning(
                "Untested Postgres version",
                f"server reports {ver}, newer than the tested range"))
        if publication is not None:
            if not await client.publication_exists(publication):
                out.append(critical(
                    "Publication missing",
                    f"publication `{publication}` does not exist on the "
                    "source database"))
    except Exception as e:
        out.append(critical("Source probe failed", str(e)[:300]))
    finally:
        await client.close()
    return out


async def _http_probe(url: str, headers: dict | None = None,
                      timeout_s: float = 10.0
                      ) -> "tuple[int, str] | ValidationFailure":
    try:
        timeout = aiohttp.ClientTimeout(total=timeout_s)
        async with aiohttp.ClientSession(timeout=timeout) as session:
            async with session.get(url, headers=headers or {}) as resp:
                return resp.status, (await resp.text())[:200]
    except asyncio.TimeoutError:
        return critical("Destination unreachable",
                        f"request to {url} timed out after {timeout_s:.0f}s")
    except aiohttp.ClientError as e:
        return critical("Destination unreachable", f"{url}: {e}")


async def validate_destination(config: dict,
                               pipeline_config: dict | None = None,
                               timeout_s: float = 10.0
                               ) -> list[ValidationFailure]:
    """Static shape + a cheap authenticated reachability probe per
    destination type (validators/{bigquery,clickhouse,...}.rs: each
    validator authenticates and touches the service before accepting the
    config)."""
    out = validate_destination_shape(config)
    if out:
        return out
    dtype = config["type"]
    if dtype == "bigquery":
        headers = {}
        if config.get("auth_token"):
            headers["Authorization"] = f"Bearer {config['auth_token']}"
        res = await _http_probe(
            f"{config['base_url']}/projects/{config['project_id']}"
            f"/datasets/{config['dataset_id']}", headers, timeout_s)
        if isinstance(res, ValidationFailure):
            out.append(res)
        elif res[0] in (401, 403):
            out.append(critical(
                "BigQuery authentication failed",
                "the service rejected the provided credentials"))
        elif res[0] == 404:
            out.append(warning(
                "BigQuery dataset missing",
                f"dataset `{config['dataset_id']}` does not exist yet; "
                "it will be created at pipeline startup"))
        elif res[0] >= 400:
            out.append(critical("BigQuery probe failed",
                                f"HTTP {res[0]}: {res[1]}"))
    elif dtype == "clickhouse":
        headers = {}
        if config.get("username"):
            headers["X-ClickHouse-User"] = config["username"]
        if config.get("password"):
            headers["X-ClickHouse-Key"] = config["password"]
        res = await _http_probe(
            f"{config['url']}/?query=SELECT%201", headers, timeout_s)
        if isinstance(res, ValidationFailure):
            out.append(res)
        elif res[0] in (401, 403):
            out.append(critical(
                "ClickHouse authentication failed",
                "the server rejected the provided credentials"))
        elif res[0] >= 400:
            out.append(critical("ClickHouse probe failed",
                                f"HTTP {res[0]}: {res[1]}"))
    elif dtype == "snowflake":
        if config.get("private_key_pem"):
            try:
                from ..destinations.snowflake import (SnowflakeConfig,
                                                      make_jwt)

                make_jwt(SnowflakeConfig(
                    base_url=config["base_url"], account=config["account"],
                    user=config["user"], database=config["database"],
                    private_key_pem=config["private_key_pem"]))
            except Exception as e:
                out.append(critical(
                    "Snowflake key invalid",
                    f"could not sign a keypair JWT: {str(e)[:200]}"))
        res = await _http_probe(f"{config['base_url']}/api/v2/statements",
                                timeout_s=timeout_s)
        if isinstance(res, ValidationFailure):
            out.append(res)
    elif dtype == "iceberg":
        res = await _http_probe(f"{config['catalog_url']}/v1/config",
                                timeout_s=timeout_s)
        if isinstance(res, ValidationFailure):
            out.append(res)
        elif res[0] >= 500:
            out.append(critical("Iceberg catalog probe failed",
                                f"HTTP {res[0]}: {res[1]}"))
    elif dtype == "lake":
        import os

        path = config["warehouse_path"]
        parent = path if os.path.isdir(path) else os.path.dirname(path) or "."
        if not os.access(parent, os.W_OK):
            out.append(critical(
                "Lake warehouse not writable",
                f"cannot write to `{path}`"))
    if pipeline_config is not None and not pipeline_config.get(
            "publication_name"):
        out.append(critical(
            "Missing publication_name",
            "pipeline_config requires `publication_name`"))
    return out
