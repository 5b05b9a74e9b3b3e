"""Control-plane REST API.

Reference parity: crates/etl-api (19k LoC) — tenants / sources /
destinations / pipelines CRUD with per-tenant isolation via the `tenant_id`
header (routes/mod.rs:40-73), encrypted source/destination configs,
pipeline lifecycle routes `start/stop/restart/status/replication-status/
rollback-tables` (routes/pipelines.rs:662-1618), orchestration through the
fakeable deploy seam (k8s/base.rs:197), OpenAPI document, /metrics.

Storage: the ApiDb seam (api/db.py) — sqlite file OR Postgres over the
wire-client pool, mirroring the reference API owning its own Postgres
database with sqlx migrations (crates/etl-api/migrations/).

Copy of the reference's `etl_tpu/api/app.py`: the same routes, statements
and response bodies, `/v1/fleet` included: the fleet console reads the
port's own fleet reconciler (`fleet/`) and the fleet store wired into
`ApiState`.
"""

from __future__ import annotations

import json
from pathlib import Path

from aiohttp import web

from ..store.sql import SqliteStore
from ..telemetry.metrics import registry
from .crypto import ConfigCipher
from .db import ApiDb, ApiIntegrityError, SqliteApiDb
from .orchestrator import Orchestrator, ReplicatorSpec

TENANT_HEADER = "tenant_id"
MAX_TENANT_ID_LEN = 64


def _require_tenant(request: web.Request) -> str:
    tenant = request.headers.get(TENANT_HEADER, "")
    if not tenant or len(tenant) > MAX_TENANT_ID_LEN \
            or not tenant.replace("-", "").replace("_", "").isalnum():
        raise web.HTTPUnauthorized(
            text=json.dumps({"error": "missing or invalid tenant_id header"}),
            content_type="application/json")
    return tenant


def _path_id(request: web.Request) -> int:
    raw = request.match_info["id"]
    if not raw.isdigit():
        raise _json_error(404, "not found")
    return int(raw)


async def _json_body(request: web.Request) -> dict:
    try:
        doc = await request.json()
    except Exception:
        raise _json_error(400, "request body must be JSON")
    if not isinstance(doc, dict):
        raise _json_error(400, "request body must be a JSON object")
    return doc


def _json_error(status: int, message: str) -> web.HTTPException:
    cls = {400: web.HTTPBadRequest, 404: web.HTTPNotFound,
           409: web.HTTPConflict}.get(status, web.HTTPInternalServerError)
    return cls(text=json.dumps({"error": message}),
               content_type="application/json")


def _int(v) -> int:
    """DB-value → int: the Postgres wire path returns text cells."""
    return int(v)


def _bool(v) -> bool:
    return bool(int(v))


class ApiState:
    def __init__(self, db: "str | ApiDb", cipher: ConfigCipher,
                 orchestrator: Orchestrator, api_key: str | None = None,
                 fleet_store=None, fleet_lag_of=None):
        self.cipher = cipher
        self.orchestrator = orchestrator
        # fleet control plane (docs/fleet.md): the StateStore holding the
        # FleetSpec + actuation journals the /v1/fleet endpoint reports
        # on (None = this deployment runs no fleet), and an optional
        # async pipeline_id -> lag-bytes reader (None = lag unreported)
        self.fleet_store = fleet_store
        self.fleet_lag_of = fleet_lag_of
        # deployment API key (reference etl-api authentication module):
        # when set, every /v1 route requires `Authorization: Bearer <key>`
        # BEFORE tenant routing — the tenant header alone is an assertion,
        # not an authentication
        self.api_key = api_key
        self.db: ApiDb = SqliteApiDb(db) if isinstance(db, str) else db
        self._connected = False

    async def connect(self) -> None:
        if not self._connected:
            await self.db.connect()
            self._connected = True

    async def close(self) -> None:
        if self._connected:
            await self.db.close()
            self._connected = False

    # -- row helpers ------------------------------------------------------------

    async def fetch_owned(self, table: str, row_id: int, tenant: str):
        rows = await self.db.run(
            f"SELECT * FROM {table} WHERE id = ? AND tenant_id = ?",
            (row_id, tenant))
        return rows[0] if rows else None

    async def default_image(self, tenant: str) -> "str | None":
        rows = await self.db.run(
            "SELECT name FROM api_images WHERE tenant_id = ? AND "
            "is_default = 1", (tenant,))
        return rows[0][0] if rows else None

    async def pipeline_image(self, row) -> "str | None":
        """The image a pipeline runs: its pinned version if set (the
        /version route), else the tenant default."""
        pinned = row[7] if len(row) > 7 else ""
        return pinned or await self.default_image(row[1])

    async def pipeline_config(self, row) -> dict:
        """Assemble the full replicator config for a pipeline row."""
        tenant, source_id, dest_id = row[1], _int(row[2]), _int(row[3])
        publication, config_json, store_path = row[4], row[5], row[6]
        src = await self.fetch_owned("api_sources", source_id, tenant)
        dst = await self.fetch_owned("api_destinations", dest_id, tenant)
        if src is None or dst is None:
            raise _json_error(404, "source or destination missing")
        extra = json.loads(config_json)
        doc = {
            "pipeline_id": _int(row[0]),
            "publication_name": publication,
            "pg_connection": self.cipher.decrypt(src[3]),
            "destination": self.cipher.decrypt(dst[3]),
            **extra,
        }
        if store_path:
            doc["store"] = {"type": "sqlite", "path": store_path}
        return doc


_SECRET_KEY_HINTS = ("password", "secret", "token", "key", "credential")


MASKED = "********"


def redact_config(doc):
    """Decrypted configs never leave the API verbatim: ANY value under a
    secret-looking key is masked, whatever its type: a GET never echoes
    decrypted source/destination credentials."""
    if isinstance(doc, dict):
        return {k: (MASKED if any(h in k.lower()
                                  for h in _SECRET_KEY_HINTS)
                    else redact_config(v))
                for k, v in doc.items()}
    if isinstance(doc, list):
        return [redact_config(v) for v in doc]
    return doc


def unmask_config(new, stored):
    """Read-modify-write support: a client that PUTs back a GET response
    carries the mask sentinel — restore the stored value there instead of
    encrypting the literal '********' as the credential."""
    if new == MASKED:
        return stored
    if isinstance(new, dict) and isinstance(stored, dict):
        return {k: unmask_config(v, stored.get(k)) for k, v in new.items()}
    if isinstance(new, list) and isinstance(stored, list):
        return [unmask_config(v, s) for v, s in zip(new, stored)] \
            + new[len(stored):]
    return new


def build_app(state: ApiState) -> web.Application:
    @web.middleware
    async def auth_middleware(request: web.Request, handler):
        if state.api_key is not None \
                and request.path.startswith("/v1"):
            import hmac as _hmac

            header = request.headers.get("Authorization", "")
            if not _hmac.compare_digest(header,
                                        f"Bearer {state.api_key}"):
                return web.json_response({"error": "unauthorized"},
                                         status=401)
        return await handler(request)

    app = web.Application(middlewares=[auth_middleware])

    async def _startup(_app):
        await state.connect()

    async def _cleanup(_app):
        await state.close()

    app.on_startup.append(_startup)
    app.on_cleanup.append(_cleanup)
    r = app.router

    # -- health / metrics / openapi --------------------------------------------

    async def health(_req):
        return web.json_response({"status": "ok"})

    async def metrics(_req):
        return web.Response(text=registry.render_prometheus(),
                            content_type="text/plain")

    async def openapi(_req):
        return web.json_response(OPENAPI_DOC)

    async def docs(_req):
        # the reference serves Swagger UI (utoipa-swagger-ui); this env
        # has zero egress, so /docs is a SELF-CONTAINED renderer of the
        # same /openapi.json — no CDN assets
        return web.Response(text=_DOCS_HTML, content_type="text/html")

    r.add_get("/health", health)
    r.add_get("/metrics", metrics)
    r.add_get("/docs", docs)
    r.add_get("/openapi.json", openapi)

    # -- tenants ----------------------------------------------------------------

    async def create_tenant(req: web.Request):
        doc = await _json_body(req)
        tid, name = doc.get("id"), doc.get("name")
        if not tid or not name:
            raise _json_error(400, "id and name required")
        try:
            await state.db.run(
                "INSERT INTO api_tenants (id, name) VALUES (?, ?)",
                (tid, name))
        except ApiIntegrityError:
            raise _json_error(409, f"tenant {tid} exists")
        return web.json_response({"id": tid, "name": name}, status=201)

    async def list_tenants(_req):
        rows = await state.db.run("SELECT id, name FROM api_tenants")
        return web.json_response([{"id": i, "name": n} for i, n in rows])

    r.add_post("/v1/tenants", create_tenant)
    r.add_get("/v1/tenants", list_tenants)

    # -- sources / destinations (same shape) ------------------------------------

    def make_config_routes(table: str, path: str):
        from .validation import (validate_destination_shape,
                                 validate_source_shape)

        shape_check = validate_source_shape if table == "api_sources" \
            else validate_destination_shape

        def _reject_invalid(config: dict) -> None:
            """Reject-before-store (reference routes validate configs at
            deserialization): static shape failures → 400 with the same
            failure list the :validate routes return."""
            failures = shape_check(config)
            if failures:
                raise web.HTTPBadRequest(
                    text=json.dumps({
                        "error": "invalid config",
                        "validation_failures": [f.to_json()
                                                for f in failures]}),
                    content_type="application/json")

        async def create(req: web.Request):
            tenant = _require_tenant(req)
            doc = await _json_body(req)
            name, config = doc.get("name"), doc.get("config")
            if not name or not isinstance(config, dict):
                raise _json_error(400, "name and config required")
            _reject_invalid(config)
            rows = await state.db.run(
                f"INSERT INTO {table} (tenant_id, name, config_enc) "
                "VALUES (?, ?, ?) RETURNING id",
                (tenant, name, state.cipher.encrypt(config)))
            return web.json_response({"id": _int(rows[0][0]),
                                      "name": name}, status=201)

        async def list_(req: web.Request):
            tenant = _require_tenant(req)
            rows = await state.db.run(
                f"SELECT id, name FROM {table} WHERE tenant_id = ?",
                (tenant,))
            return web.json_response([{"id": _int(i), "name": n}
                                      for i, n in rows])

        async def get(req: web.Request):
            tenant = _require_tenant(req)
            row = await state.fetch_owned(table, _path_id(req), tenant)
            if row is None:
                raise _json_error(404, "not found")
            return web.json_response({
                "id": _int(row[0]), "name": row[2],
                "config": redact_config(state.cipher.decrypt(row[3]))})

        async def update(req: web.Request):
            tenant = _require_tenant(req)
            row = await state.fetch_owned(table, _path_id(req), tenant)
            if row is None:
                raise _json_error(404, "not found")
            doc = await _json_body(req)
            config = doc.get("config")
            name = doc.get("name", row[2])
            if config is not None:
                config = unmask_config(config,
                                       state.cipher.decrypt(row[3]))
                _reject_invalid(config)
            enc = state.cipher.encrypt(config) if config is not None else row[3]
            await state.db.run(
                f"UPDATE {table} SET name = ?, config_enc = ? WHERE id = ?",
                (name, enc, row[0]))
            return web.json_response({"id": _int(row[0]), "name": name})

        async def delete(req: web.Request):
            tenant = _require_tenant(req)
            row_id = _path_id(req)
            ref_col = "source_id" if table == "api_sources" \
                else "destination_id"
            used = await state.db.run(
                f"SELECT id FROM api_pipelines WHERE {ref_col} = ? AND "
                "tenant_id = ?", (row_id, tenant))
            if used:
                raise _json_error(
                    409,
                    f"in use by pipelines {[_int(r[0]) for r in used]}")
            await state.db.run(
                f"DELETE FROM {table} WHERE id = ? AND tenant_id = ?",
                (row_id, tenant))
            return web.json_response({}, status=204)

        r.add_post(path, create)
        r.add_get(path, list_)
        r.add_get(path + "/{id}", get)
        r.add_put(path + "/{id}", update)
        r.add_delete(path + "/{id}", delete)

    make_config_routes("api_sources", "/v1/sources")
    make_config_routes("api_destinations", "/v1/destinations")

    # -- validation routes (reference routes/destinations.rs:468-516,
    # routes/common.rs:67-79): static shape + LIVE probes, returning
    # `validation_failures` with severity instead of erroring ------------------

    async def validate_source_route(req: web.Request):
        from .validation import validate_source

        _require_tenant(req)
        doc = await _json_body(req)
        config = doc.get("config")
        if not isinstance(config, dict):
            raise _json_error(400, "config required")
        pipeline_config = doc.get("pipeline_config") or {}
        failures = await validate_source(
            config, publication=pipeline_config.get("publication_name"))
        return web.json_response(
            {"validation_failures": [f.to_json() for f in failures]})

    async def validate_destination_route(req: web.Request):
        from .validation import validate_destination

        tenant = _require_tenant(req)
        doc = await _json_body(req)
        config = doc.get("config")
        if not isinstance(config, dict):
            raise _json_error(400, "config required")
        pipeline_config = doc.get("pipeline_config")
        source_id = doc.get("source_id")
        # source_id + pipeline_config travel together (destinations.rs:500)
        if (source_id is None) != (pipeline_config is None):
            raise _json_error(
                400, "source_id and pipeline_config must be provided "
                     "together")
        if source_id is not None:
            try:
                source_id = int(source_id)
            except (TypeError, ValueError):
                raise _json_error(400, "source_id must be an integer")
            if await state.fetch_owned("api_sources", source_id,
                                       tenant) is None:
                raise _json_error(404, "source not found")
        failures = await validate_destination(config, pipeline_config)
        return web.json_response(
            {"validation_failures": [f.to_json() for f in failures]})

    r.add_post("/v1/sources:validate", validate_source_route)
    r.add_post("/v1/destinations:validate", validate_destination_route)

    # -- images (replicator container images; reference etl-api images CRUD)

    async def create_image(req: web.Request):
        tenant = _require_tenant(req)
        doc = await _json_body(req)
        name = doc.get("name")
        if not name:
            raise _json_error(400, "name required")
        try:
            rows = await state.db.run(
                "INSERT INTO api_images (tenant_id, name, is_default) "
                "VALUES (?, ?, ?) RETURNING id",
                (tenant, name, 1 if doc.get("default") else 0))
        except ApiIntegrityError:
            raise _json_error(409, f"image {name} exists")
        iid = _int(rows[0][0])
        if doc.get("default"):
            await state.db.run(
                "UPDATE api_images SET is_default = 0 "
                "WHERE tenant_id = ? AND id <> ?", (tenant, iid))
        return web.json_response(
            {"id": iid, "name": name,
             "default": bool(doc.get("default"))}, status=201)

    async def list_images(req: web.Request):
        tenant = _require_tenant(req)
        rows = await state.db.run(
            "SELECT id, name, is_default FROM api_images WHERE "
            "tenant_id = ?", (tenant,))
        return web.json_response([
            {"id": _int(i), "name": n, "default": _bool(d)}
            for i, n, d in rows])

    async def set_default_image(req: web.Request):
        tenant = _require_tenant(req)
        iid = _path_id(req)
        rows = await state.db.run(
            "SELECT id FROM api_images WHERE id = ? AND tenant_id = ?",
            (iid, tenant))
        if not rows:
            raise _json_error(404, "image not found")
        await state.db.run("UPDATE api_images SET is_default = 0 WHERE "
                           "tenant_id = ?", (tenant,))
        await state.db.run("UPDATE api_images SET is_default = 1 "
                           "WHERE id = ?", (iid,))
        return web.json_response({"id": iid, "default": True})

    async def delete_image(req: web.Request):
        tenant = _require_tenant(req)
        iid = _path_id(req)
        row = await state.fetch_owned("api_images", iid, tenant)
        if row is not None:
            # a pipeline pinned to this image (the /version route) would
            # silently deploy an unregistered name after the delete
            pinned = await state.db.run(
                "SELECT id FROM api_pipelines WHERE tenant_id = ? AND "
                "image_name = ?", (tenant, row[2]))
            if pinned:
                raise _json_error(
                    409, f"image pinned by pipelines "
                         f"{sorted(_int(r[0]) for r in pinned)}")
        await state.db.run(
            "DELETE FROM api_images WHERE id = ? AND tenant_id = ?",
            (iid, tenant))
        return web.json_response({}, status=204)

    r.add_post("/v1/images", create_image)
    r.add_get("/v1/images", list_images)
    r.add_post("/v1/images/{id}/set-default", set_default_image)
    r.add_delete("/v1/images/{id}", delete_image)

    # -- pipelines ----------------------------------------------------------------

    async def create_pipeline(req: web.Request):
        tenant = _require_tenant(req)
        doc = await _json_body(req)
        try:
            source_id = int(doc["source_id"])
            dest_id = int(doc["destination_id"])
            publication = doc["publication_name"]
        except (KeyError, TypeError, ValueError):
            raise _json_error(
                400, "source_id, destination_id, publication_name required")
        if await state.fetch_owned("api_sources", source_id,
                                   tenant) is None:
            raise _json_error(404, f"source {source_id} not found")
        if await state.fetch_owned("api_destinations", dest_id,
                                   tenant) is None:
            raise _json_error(404, f"destination {dest_id} not found")
        rows = await state.db.run(
            "INSERT INTO api_pipelines (tenant_id, source_id, destination_id,"
            " publication_name, config_json, store_path) VALUES "
            "(?, ?, ?, ?, ?, ?) RETURNING id",
            (tenant, source_id, dest_id, publication,
             json.dumps(doc.get("config", {})), doc.get("store_path", "")))
        return web.json_response({"id": _int(rows[0][0])}, status=201)

    async def list_pipelines(req: web.Request):
        tenant = _require_tenant(req)
        rows = await state.db.run(
            "SELECT id, source_id, destination_id, publication_name FROM "
            "api_pipelines WHERE tenant_id = ?", (tenant,))
        return web.json_response([
            {"id": _int(i), "source_id": _int(s),
             "destination_id": _int(d), "publication_name": p}
            for i, s, d, p in rows])

    async def _pipeline_row(req: web.Request, tenant: str):
        row = await state.fetch_owned("api_pipelines",
                                      _path_id(req), tenant)
        if row is None:
            raise _json_error(404, "pipeline not found")
        return row

    async def get_pipeline(req: web.Request):
        tenant = _require_tenant(req)
        row = await _pipeline_row(req, tenant)
        doc = {
            "id": _int(row[0]), "source_id": _int(row[2]),
            "destination_id": _int(row[3]),
            "publication_name": row[4], "config": json.loads(row[5])}
        if len(row) > 7 and row[7]:
            doc["image"] = row[7]
        return web.json_response(doc)

    async def delete_pipeline(req: web.Request):
        tenant = _require_tenant(req)
        row = await _pipeline_row(req, tenant)
        # delete, not stop: permanent teardown may also drop
        # pipeline-owned storage (the k8s warehouse PVC)
        await state.orchestrator.delete_pipeline(_int(row[0]))
        await state.db.run("DELETE FROM api_pipelines WHERE id = ?",
                           (row[0],))
        return web.json_response({}, status=204)

    async def start_pipeline(req: web.Request):
        tenant = _require_tenant(req)
        row = await _pipeline_row(req, tenant)
        config = await state.pipeline_config(row)
        await state.orchestrator.start_pipeline(ReplicatorSpec(
            pipeline_id=_int(row[0]), tenant_id=tenant, config=config,
            image=await state.pipeline_image(row)))
        return web.json_response({"status": "starting"}, status=202)

    async def stop_pipeline(req: web.Request):
        tenant = _require_tenant(req)
        row = await _pipeline_row(req, tenant)
        await state.orchestrator.stop_pipeline(_int(row[0]))
        return web.json_response({"status": "stopping"}, status=202)

    async def restart_pipeline(req: web.Request):
        tenant = _require_tenant(req)
        row = await _pipeline_row(req, tenant)
        config = await state.pipeline_config(row)
        await state.orchestrator.restart_pipeline(ReplicatorSpec(
            pipeline_id=_int(row[0]), tenant_id=tenant, config=config,
            image=await state.pipeline_image(row)))
        return web.json_response({"status": "restarting"}, status=202)

    async def update_pipeline_version(req: web.Request):
        """Pin/roll the replicator image a pipeline runs (reference
        routes/pipelines.rs:662-735 update_pipeline_version): body
        names an image by id, or omits it to track the tenant default.
        A RUNNING pipeline is re-applied so the StatefulSet rolls to
        the new image; a stopped one picks it up at next start."""
        tenant = _require_tenant(req)
        row = await _pipeline_row(req, tenant)
        doc = await _json_body(req)
        image_id = doc.get("image_id")
        if image_id is not None:
            try:
                image_id = int(image_id)
            except (TypeError, ValueError):
                raise _json_error(400, "image_id must be an integer")
            img = await state.fetch_owned("api_images", image_id, tenant)
            if img is None:
                raise _json_error(404, "image not found")
            image_name = img[2]
        else:
            image_name = ""  # back to tracking the tenant default
        await state.db.run(
            "UPDATE api_pipelines SET image_name = ? WHERE id = ?",
            (image_name, row[0]))
        effective = image_name or await state.default_image(tenant)
        st = await state.orchestrator.status(_int(row[0]))
        rolled = False
        if st.state not in ("stopped", "unknown"):
            config = await state.pipeline_config(row)
            await state.orchestrator.start_pipeline(ReplicatorSpec(
                pipeline_id=_int(row[0]), tenant_id=tenant,
                config=config, image=effective))
            rolled = True
        return web.json_response({
            "id": _int(row[0]), "image": effective,
            "pinned": bool(image_name), "rolled_out": rolled})

    async def pipeline_status(req: web.Request):
        tenant = _require_tenant(req)
        row = await _pipeline_row(req, tenant)
        st = await state.orchestrator.status(_int(row[0]))
        return web.json_response({"pipeline_id": st.pipeline_id,
                                  "state": st.state, "detail": st.detail})

    async def replication_status(req: web.Request):
        """Table states from the pipeline's durable store
        (reference routes/pipelines.rs replication-status)."""
        tenant = _require_tenant(req)
        row = await _pipeline_row(req, tenant)
        store_path = row[6]
        if not store_path or not Path(store_path).exists():
            raise _json_error(404, "pipeline has no durable store")
        store = SqliteStore(store_path, _int(row[0]))
        await store.connect()
        try:
            states = await store.get_table_states()
            out = []
            for tid, st in sorted(states.items()):
                doc = {"table_id": tid, "state": st.type.value}
                if st.lsn is not None:
                    doc["lsn"] = str(st.lsn)
                if st.is_errored:
                    doc.update(reason=st.reason,
                               retry_policy=st.retry_policy.value,
                               retry_attempts=st.retry_attempts)
                out.append(doc)
            slot_lag = await _try_slot_lag(row, tenant)
            return web.json_response({"tables": out, "slot_lag": slot_lag})
        finally:
            await store.close()

    _slot_lag_cache: dict[int, tuple[float, object]] = {}
    _SLOT_LAG_TTL_S = 5.0

    async def _try_slot_lag(pipeline_row, tenant: str):
        """Source-side slot lag for the replication-status surface
        (reference etl-postgres/src/lag.rs via routes/pipelines.rs).
        Best-effort: an unreachable source yields null, not a 5xx.
        Briefly cached per pipeline so a polling dashboard doesn't pay a
        fresh connect+auth against the customer's database per request."""
        import time as _time

        from ..postgres.lag import query_slot_lag
        from ..postgres.wire import PgWireConnection

        pid = _int(pipeline_row[0])
        cached = _slot_lag_cache.get(pid)
        if cached is not None and _time.monotonic() - cached[0] \
                < _SLOT_LAG_TTL_S:
            return cached[1]
        src = await state.fetch_owned("api_sources",
                                      _int(pipeline_row[2]), tenant)
        if src is None:
            return None
        try:
            cfg = state.cipher.decrypt(src[3])  # → dict
            conn = PgWireConnection(
                host=cfg.get("host", "localhost"),
                port=int(cfg.get("port", 5432)),
                # canonical source-config keys (name/username), with the
                # legacy aliases as fallback
                database=cfg.get("name", cfg.get("database", "postgres")),
                user=cfg.get("username", cfg.get("user", "postgres")),
                password=cfg.get("password"),
                application_name="etl_tpu_api", connect_timeout_s=3.0)
            await conn.connect()
            try:
                metrics = await query_slot_lag(conn)
            finally:
                await conn.close()
            result = [{
                "slot_name": m.slot_name, "active": m.active,
                "wal_status": m.wal_status,
                "restart_lsn_lag_bytes": m.restart_lsn_lag_bytes,
                "confirmed_flush_lag_bytes": m.confirmed_flush_lag_bytes,
                "safe_wal_size_bytes": m.safe_wal_size_bytes,
                "write_lag_ms": m.write_lag_ms,
                "flush_lag_ms": m.flush_lag_ms,
                "replay_lag_ms": m.replay_lag_ms,
            } for m in metrics]
        except Exception:
            result = None
        _slot_lag_cache[pid] = (_time.monotonic(), result)
        return result

    async def rollback_tables(req: web.Request):
        """Repair op: reset errored tables to Init so they resync
        (reference routes/pipelines.rs:1372 rollback-tables)."""
        tenant = _require_tenant(req)
        row = await _pipeline_row(req, tenant)
        store_path = row[6]
        if not store_path or not Path(store_path).exists():
            raise _json_error(404, "pipeline has no durable store")
        doc = await _json_body(req)
        table_ids = doc.get("table_ids")
        from ..postgres.slots import table_sync_slot_name

        store = SqliteStore(store_path, _int(row[0]))
        await store.connect()
        try:
            states = await store.get_table_states()
            targets = [tid for tid in states
                       if table_ids is None or tid in table_ids]
            rolled = []
            for tid in targets:
                if table_ids is not None or states[tid].is_errored:
                    prior = states[tid]
                    await store.reset_table(tid)
                    # a stale sync-slot progress row would fence the fresh
                    # copy's catchup below its real position
                    await store.delete_durable_progress(
                        table_sync_slot_name(_int(row[0]), tid))
                    rolled.append({
                        "table_id": tid,
                        "previous_state": prior.type.value,
                        "previous_reason": prior.reason
                        if prior.is_errored else None,
                    })
            unknown = [] if table_ids is None else \
                [t for t in table_ids if t not in states]
            return web.json_response({
                "rolled_back": sorted(r["table_id"] for r in rolled),
                "tables": sorted(rolled, key=lambda r: r["table_id"]),
                "unknown_table_ids": sorted(unknown)})
        finally:
            await store.close()

    r.add_post("/v1/pipelines", create_pipeline)
    r.add_get("/v1/pipelines", list_pipelines)
    r.add_get("/v1/pipelines/{id}", get_pipeline)
    r.add_delete("/v1/pipelines/{id}", delete_pipeline)
    r.add_post("/v1/pipelines/{id}/start", start_pipeline)
    r.add_post("/v1/pipelines/{id}/stop", stop_pipeline)
    r.add_post("/v1/pipelines/{id}/restart", restart_pipeline)
    r.add_get("/v1/pipelines/{id}/status", pipeline_status)
    r.add_get("/v1/pipelines/{id}/replication-status", replication_status)
    r.add_post("/v1/pipelines/{id}/version", update_pipeline_version)
    r.add_post("/v1/pipelines/{id}/rollback-tables", rollback_tables)

    # -- fleet (docs/fleet.md) --------------------------------------------------

    async def fleet_status(_req: web.Request):
        """ONE aggregated view of every pipeline the fleet runs:
        desired vs observed shard counts, orchestrator health with the
        pod /health degraded reasons, per-pipeline lag when a reader is
        wired, and the fleet-wide degraded-reason tally. Deliberately
        tenant-headerless: this is the operator's fleet console, behind
        the same bearer auth as every /v1 route."""
        from ..fleet.reconciler import place_fleet
        from ..fleet.spec import FleetSpec
        from ..models.errors import EtlError

        spec_doc = None
        if state.fleet_store is not None:
            spec_doc = await state.fleet_store.get_fleet_spec()
        spec = FleetSpec.from_json(spec_doc)
        targets = place_fleet(spec)
        by_id = spec.by_id()
        try:
            observed = await state.orchestrator.list_pipelines()
        except EtlError:
            observed = {}
        pipelines = []
        reason_tally: dict[str, int] = {}
        states_tally: dict[str, int] = {}
        for pid in sorted(set(targets) | set(observed)):
            st = await state.orchestrator.status(pid)
            lag = None
            if state.fleet_lag_of is not None:
                lag = await state.fleet_lag_of(pid)
            for reason in st.reasons:
                reason_tally[reason] = reason_tally.get(reason, 0) + 1
            states_tally[st.state] = states_tally.get(st.state, 0) + 1
            p = by_id.get(pid)
            pipelines.append({
                "pipeline_id": pid,
                "tenant_id": p.tenant_id if p else None,
                "profile": p.profile if p else None,
                "desired_shards": targets.get(pid, 0),
                "observed_shards": observed.get(pid, 0),
                "state": st.state,
                "detail": st.detail,
                "degraded_reasons": list(st.reasons),
                "lag_bytes": lag,
            })
        return web.json_response({
            "spec_version": spec.spec_version,
            "pipelines": pipelines,
            "counts": {
                "desired": len(targets),
                "observed": len(observed),
                "by_state": states_tally,
            },
            "converged": dict(observed) == targets,
            "degraded_reasons": reason_tally,
            "quotas": {t: q.to_json()
                       for t, q in sorted(spec.quotas.items())},
        })

    r.add_get("/v1/fleet", fleet_status)
    return app


OPENAPI_DOC = {
    "openapi": "3.0.3",
    "info": {
        "title": "etl_tpu control plane",
        "version": "0.2.0",
        "description": (
            "Multi-tenant control plane for replication pipelines: "
            "sources/destinations with encrypted configs, pipeline "
            "lifecycle via the orchestrator seam, replicator images, "
            "and repair operations."),
    },
    "components": {
        "securitySchemes": {
            "bearer": {"type": "http", "scheme": "bearer"},
            "tenant": {"type": "apiKey", "in": "header",
                       "name": "tenant_id"},
        },
        "schemas": {
            "Error": {"type": "object",
                      "properties": {"error": {"type": "string"}}},
            "Tenant": {"type": "object",
                       "properties": {"id": {"type": "string"},
                                      "name": {"type": "string"}},
                       "required": ["id", "name"]},
            "ConfigResource": {
                "type": "object",
                "properties": {"id": {"type": "integer"},
                               "name": {"type": "string"},
                               "config": {"type": "object"}},
                "description": "GET responses mask secret-looking config "
                               "values."},
            "Image": {"type": "object",
                      "properties": {"id": {"type": "integer"},
                                     "name": {"type": "string"},
                                     "default": {"type": "boolean"}}},
            "Pipeline": {
                "type": "object",
                "properties": {"id": {"type": "integer"},
                               "source_id": {"type": "integer"},
                               "destination_id": {"type": "integer"},
                               "publication_name": {"type": "string"},
                               "config": {"type": "object"},
                               "store_path": {"type": "string"}},
                "required": ["source_id", "destination_id",
                             "publication_name"]},
            "PipelineStatus": {
                "type": "object",
                "properties": {"pipeline_id": {"type": "integer"},
                               "state": {"type": "string",
                                         "enum": ["stopped", "starting",
                                                  "running", "failed"]},
                               "detail": {"type": "string"}}},
            "ReplicationStatus": {
                "type": "object",
                "properties": {
                    "tables": {"type": "array", "items": {
                        "type": "object",
                        "properties": {
                            "table_id": {"type": "integer"},
                            "state": {"type": "string"},
                            "lsn": {"type": "string"},
                            "reason": {"type": "string"},
                            "retry_policy": {"type": "string"},
                            "retry_attempts": {"type": "integer"}}}},
                    "slot_lag": {"type": "array", "nullable": True,
                                 "items": {"type": "object"}}}},
            "RollbackRequest": {
                "type": "object",
                "properties": {"table_ids": {
                    "type": "array", "items": {"type": "integer"},
                    "description": "omit to roll back every errored "
                                   "table"}}},
            "RollbackResponse": {
                "type": "object",
                "properties": {
                    "rolled_back": {"type": "array",
                                    "items": {"type": "integer"}},
                    "tables": {"type": "array", "items": {"type": "object"}},
                    "unknown_table_ids": {"type": "array",
                                          "items": {"type": "integer"}}}},
        },
    },
    "security": [{"bearer": [], "tenant": []}],
}


def _op(summary, *, body=None, resp=None, params=None):
    doc = {"summary": summary, "responses": {
        "default": {"description": "response", "content": {
            "application/json": {"schema": resp or {"type": "object"}}}}}}
    if body is not None:
        doc["requestBody"] = {"content": {"application/json": {
            "schema": body}}}
    if params:
        doc["parameters"] = params
    return doc


_ID_PARAM = [{"name": "id", "in": "path", "required": True,
              "schema": {"type": "integer"}}]


def _ref(name):
    return {"$ref": f"#/components/schemas/{name}"}


OPENAPI_DOC["paths"] = {
    "/health": {"get": _op("liveness probe")},
    "/metrics": {"get": _op("Prometheus metrics (text exposition)")},
    "/docs": {"get": _op("this spec rendered as HTML (self-contained)")},
    "/v1/tenants": {
        "post": _op("create tenant", body=_ref("Tenant"),
                    resp=_ref("Tenant")),
        "get": _op("list tenants")},
    "/v1/sources": {
        "post": _op("create source (config encrypted at rest)",
                    body=_ref("ConfigResource")),
        "get": _op("list this tenant's sources")},
    "/v1/sources/{id}": {
        "get": _op("get source (secrets masked)", params=_ID_PARAM,
                   resp=_ref("ConfigResource")),
        "put": _op("update source", params=_ID_PARAM),
        "delete": _op("delete source (409 while referenced)",
                      params=_ID_PARAM)},
    "/v1/destinations": {
        "post": _op("create destination (config encrypted at rest)",
                    body=_ref("ConfigResource")),
        "get": _op("list this tenant's destinations")},
    "/v1/destinations/{id}": {
        "get": _op("get destination (secrets masked)", params=_ID_PARAM,
                   resp=_ref("ConfigResource")),
        "put": _op("update destination", params=_ID_PARAM),
        "delete": _op("delete destination (409 while referenced)",
                      params=_ID_PARAM)},
    "/v1/images": {
        "post": _op("register replicator image", body=_ref("Image"),
                    resp=_ref("Image")),
        "get": _op("list replicator images")},
    "/v1/images/{id}": {
        "delete": _op("delete image", params=_ID_PARAM)},
    "/v1/images/{id}/set-default": {
        "post": _op("make this the image new pipelines deploy with",
                    params=_ID_PARAM)},
    "/v1/pipelines": {
        "post": _op("create pipeline", body=_ref("Pipeline")),
        "get": _op("list this tenant's pipelines")},
    "/v1/pipelines/{id}": {
        "get": _op("get pipeline", params=_ID_PARAM, resp=_ref("Pipeline")),
        "delete": _op("stop and delete pipeline", params=_ID_PARAM)},
    "/v1/pipelines/{id}/start": {
        "post": _op("deploy the replicator (202: starting)",
                    params=_ID_PARAM)},
    "/v1/pipelines/{id}/stop": {
        "post": _op("tear down the replicator (202: stopping)",
                    params=_ID_PARAM)},
    "/v1/pipelines/{id}/restart": {
        "post": _op("stop then start", params=_ID_PARAM)},
    "/v1/pipelines/{id}/status": {
        "get": _op("orchestrator state", params=_ID_PARAM,
                   resp=_ref("PipelineStatus"))},
    "/v1/pipelines/{id}/replication-status": {
        "get": _op("table states from the durable store + source slot lag",
                   params=_ID_PARAM, resp=_ref("ReplicationStatus"))},
    "/v1/pipelines/{id}/version": {
        "post": _op("pin the replicator image (or track the tenant "
                    "default when image_id is omitted); rolls out a "
                    "running pipeline", params=_ID_PARAM)},
    "/v1/pipelines/{id}/rollback-tables": {
        "post": _op("reset errored (or listed) tables for resync",
                    params=_ID_PARAM, body=_ref("RollbackRequest"),
                    resp=_ref("RollbackResponse"))},
    "/v1/fleet": {
        "get": _op("aggregated fleet view: desired vs observed shards, "
                   "health + pod degraded reasons, lag per pipeline, "
                   "tenant quotas (docs/fleet.md)")},
}


# self-contained /docs page (reference: utoipa-swagger-ui serving): renders
# /openapi.json client-side with zero external assets
_DOCS_HTML = """<!doctype html>
<html><head><meta charset="utf-8"><title>etl_tpu API</title><style>
body{font-family:system-ui,sans-serif;margin:2rem auto;max-width:60rem;
     line-height:1.45;color:#1a1a2e}
h1{font-size:1.4rem} .path{margin:.8rem 0;padding:.6rem .8rem;
border:1px solid #d8d8e4;border-radius:6px}
.m{display:inline-block;min-width:4.2rem;font-weight:700;
   text-transform:uppercase;font-size:.8rem}
.m.get{color:#0a7} .m.post{color:#06c} .m.put{color:#a60}
.m.delete{color:#c33} .m.patch{color:#849}
code{background:#f1f1f7;padding:.1rem .3rem;border-radius:3px}
.desc{color:#555;margin-left:4.6rem;font-size:.92rem}
</style></head><body>
<h1>etl_tpu control-plane API</h1>
<p>Spec: <a href="/openapi.json">/openapi.json</a>. Authenticated routes
need <code>Authorization: Bearer &lt;key&gt;</code> and a
<code>tenant_id</code> header.</p>
<div id="paths">loading…</div>
<script>
fetch('/openapi.json').then(r=>r.json()).then(doc=>{
  const el=document.getElementById('paths');el.innerHTML='';
  for(const [p,ops] of Object.entries(doc.paths||{})){
    const d=document.createElement('div');d.className='path';
    for(const [m,op] of Object.entries(ops)){
      const row=document.createElement('div');
      const mm=document.createElement('span');mm.className='m '+m;
      mm.textContent=m;row.appendChild(mm);
      const pc=document.createElement('code');pc.textContent=p;
      row.appendChild(pc);d.appendChild(row);
      const ds=document.createElement('div');ds.className='desc';
      ds.textContent=op.summary||op.description||'';d.appendChild(ds);
    }
    el.appendChild(d);
  }
}).catch(e=>{document.getElementById('paths').textContent=
  'failed to load /openapi.json: '+e});
</script></body></html>"""
