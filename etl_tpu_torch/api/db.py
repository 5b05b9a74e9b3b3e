"""Control-plane storage seam: the API's own tables on sqlite OR
Postgres.

Reference parity: crates/etl-api owns a Postgres database with sqlx
migrations (crates/etl-api/migrations/) — the control plane's tenants/
sources/destinations/images/pipelines live in their own database, not
the data plane's `etl` store schema. Here the same statement set runs
on either backend (mirroring store/sql.py's one-statement-set stance):

  - `SqliteApiDb`: file-backed sqlite3, `?` placeholders;
  - `PostgresApiDb`: the SAME statements over the from-scratch wire
    client pool (extended protocol, server-side binding) against the
    connection's default schema — point it at the PostgresStore's
    database or a dedicated control-plane database.

Inserts use `RETURNING id` so both backends report new row ids without
driver-specific lastrowid. Uniqueness violations raise
ApiIntegrityError on both backends so routes can 409 uniformly.
"""

from __future__ import annotations

import abc
import asyncio
import sqlite3
from pathlib import Path

from ..models.errors import EtlError

API_TABLE_NAMES = ("api_tenants", "api_sources", "api_destinations",
                   "api_images", "api_pipelines")

API_MIGRATIONS: list[tuple[str, str]] = [
    ("20250901000000_api_base", """
CREATE TABLE IF NOT EXISTS api_tenants (
    id TEXT PRIMARY KEY, name TEXT NOT NULL);
CREATE TABLE IF NOT EXISTS api_sources (
    id {bigserial} PRIMARY KEY, tenant_id TEXT NOT NULL,
    name TEXT NOT NULL, config_enc TEXT NOT NULL);
CREATE TABLE IF NOT EXISTS api_destinations (
    id {bigserial} PRIMARY KEY, tenant_id TEXT NOT NULL,
    name TEXT NOT NULL, config_enc TEXT NOT NULL);
CREATE TABLE IF NOT EXISTS api_images (
    id {bigserial} PRIMARY KEY, tenant_id TEXT NOT NULL,
    name TEXT NOT NULL, is_default INTEGER NOT NULL DEFAULT 0,
    UNIQUE (tenant_id, name));
CREATE TABLE IF NOT EXISTS api_pipelines (
    id {bigserial} PRIMARY KEY, tenant_id TEXT NOT NULL,
    source_id BIGINT NOT NULL, destination_id BIGINT NOT NULL,
    publication_name TEXT NOT NULL,
    config_json TEXT NOT NULL DEFAULT '{{}}',
    store_path TEXT NOT NULL DEFAULT '');
"""),
    ("20260729000000_pipeline_image", """
ALTER TABLE api_pipelines ADD COLUMN image_name TEXT NOT NULL DEFAULT ''
"""),
]


class ApiIntegrityError(Exception):
    """Uniqueness/constraint violation, backend-uniform."""


class ApiDbUnavailable(Exception):
    """The storage backend is closed/unreachable — surfaces as a 5xx,
    NEVER as a 409 (a 'tenant exists' answer to a downed database would
    mislead the client)."""


def _is_integrity_message(msg: str) -> bool:
    m = msg.lower()
    return ("unique constraint" in m or "duplicate key" in m
            or "integrityerror" in m)


class ApiDb(abc.ABC):
    """One `run()` seam; statements use `?` placeholders."""

    @abc.abstractmethod
    async def connect(self) -> None: ...

    @abc.abstractmethod
    async def close(self) -> None: ...

    @abc.abstractmethod
    async def run(self, sql: str, params: tuple = ()) -> list[tuple]: ...

    async def _migrate(self) -> None:
        for _name, ddl in API_MIGRATIONS:
            for stmt in ddl.format(bigserial=self.bigserial).split(";"):
                if stmt.strip():
                    try:
                        await self.run(stmt)
                    except Exception as e:
                        # idempotent ALTER: the column already existing
                        # is the only acceptable failure. sqlite says
                        # 'duplicate column name'; Postgres says
                        # 'column ... already exists'
                        m = str(e).lower()
                        if "duplicate column" not in m \
                                and "already exists" not in m:
                            raise


#: sqlite grew RETURNING in 3.35; older runtimes (debian bullseye ships
#: 3.34) get the clause stripped and the id synthesized from lastrowid
_SQLITE_HAS_RETURNING = sqlite3.sqlite_version_info >= (3, 35, 0)
_RETURNING_ID = " returning id"


class SqliteApiDb(ApiDb):
    bigserial = "INTEGER"

    def __init__(self, path: str | Path):
        self.path = str(path)
        self._db: sqlite3.Connection | None = None

    async def connect(self) -> None:
        self._db = sqlite3.connect(self.path)
        await self._migrate()

    async def close(self) -> None:
        if self._db is not None:
            self._db.close()
            self._db = None

    async def run(self, sql: str, params: tuple = ()) -> list[tuple]:
        assert self._db is not None, "api db not connected"
        emulate_returning = (not _SQLITE_HAS_RETURNING
                             and sql.rstrip().lower()
                                 .endswith(_RETURNING_ID))
        if emulate_returning:
            sql = sql.rstrip()[:-len(_RETURNING_ID)]
        try:
            cur = self._db.execute(sql, params)
            if emulate_returning:
                rows = [(cur.lastrowid,)]
            else:
                rows = cur.fetchall() if cur.description is not None \
                    else []
            self._db.commit()
        except sqlite3.IntegrityError as e:
            self._db.rollback()
            raise ApiIntegrityError(str(e)) from e
        return rows


class PostgresApiDb(ApiDb):
    """The same statements over the wire-client pool (reference: the
    API's sqlx PgPool). Tables live flat in the connection's default
    schema — the control plane owns its database the way the reference
    API owns its own Postgres."""

    bigserial = "BIGINT GENERATED BY DEFAULT AS IDENTITY"

    def __init__(self, connection_config, pool_size: int = 2):
        self._config = connection_config
        self.pool_size = max(1, pool_size)
        self._free: "asyncio.Queue | None" = None
        self._connected = False

    def _new_conn(self):
        from ..postgres.client import wire_connection_from_config

        return wire_connection_from_config(self._config,
                                           application_name="etl_tpu_api")

    async def connect(self) -> None:
        first = self._new_conn()
        await first.connect()
        self._free = asyncio.Queue()
        self._free.put_nowait(first)
        for _ in range(self.pool_size - 1):
            self._free.put_nowait(None)  # lazy connect on first acquire
        self._connected = True
        await self._migrate()

    async def close(self) -> None:
        self._connected = False
        if self._free is None:
            return
        while not self._free.empty():
            conn = self._free.get_nowait()
            if conn is not None:
                try:
                    await conn.close()
                except Exception:
                    pass
        # keep the queue so in-flight run()s can hand their connection
        # back (they see _connected False and close it, not re-pool it)

    async def run(self, sql: str, params: tuple = ()) -> list[tuple]:
        from ..store.sql import to_dollar_params

        if not self._connected or self._free is None:
            raise ApiDbUnavailable("api db not connected")
        conn = await self._free.get()
        if conn is None:
            try:
                conn = self._new_conn()
                await conn.connect()
            except BaseException:
                self._free.put_nowait(None)  # slot stays reconnectable
                raise
        broken = False
        try:
            if params:
                texts = [None if v is None else str(v) for v in params]
                result = await conn.query_params(
                    to_dollar_params(sql, len(params)), texts)
            else:
                result = await conn.query(sql)
            return [tuple(r) for r in result.rows]
        except EtlError as e:
            # PG error responses leave the connection at ReadyForQuery
            # (reusable); anything else poisons the wire framing
            if _is_integrity_message(str(e)):
                raise ApiIntegrityError(str(e)) from e
            raise
        except BaseException:
            # includes CancelledError: a query abandoned mid-response
            # leaves unread frames — the NEXT query would read the stale
            # ReadyForQuery and take the old query's rows
            broken = True
            raise
        finally:
            if broken or not self._connected:
                if conn is not None:
                    try:
                        await conn.close()
                    except BaseException:  # etl-lint: ignore[cancellation-swallow]
                        # a cancelled task raises at the next await —
                        # the socket still gets GC'd; the slot MUST go
                        # back regardless
                        pass
                conn = None
            if self._free is not None:
                self._free.put_nowait(conn)
