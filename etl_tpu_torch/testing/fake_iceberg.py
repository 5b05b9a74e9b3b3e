"""Protocol-enforcing fake Iceberg REST catalog.

Unlike a recording stub, this catalog VALIDATES commits the way a
conformant implementation would (reference test stance: the Rust suite
runs against a real REST catalog container, SURVEY §4.6):

- optimistic concurrency: `assert-ref-snapshot-id` requirements are
  checked against the main branch head; stale commits get 409;
- `add-snapshot` walks the whole metadata chain: the manifest LIST file
  must exist and parse (via the independent Avro reader — no code shared
  with the writer), every manifest it names must exist, parse, and agree
  on snapshot id / sequence number, every data file an entry names must
  exist, and the Parquet footer's row count must equal the entry's
  `record_count`; summary row totals must add up;
- schema evolution must arrive as add-schema + set-current-schema with
  the next schema-id;
- the legacy minimal shapes of an early destination
  ("action": "append"/"set-schema"/"truncate" on a /commit route) are
  REJECTED with 400 — this catalog would not have accepted them.

Copy of the reference's `etl_tpu/testing/fake_iceberg.py`, reading the
manifest chain through the port's `testing/avro_reader.py`. Parquet
footers are read through pyarrow, imported where a snapshot is checked.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field

from aiohttp import web

from .avro_reader import read_avro_ocf


@dataclass
class _Table:
    name: str
    schemas: list[dict] = field(default_factory=list)
    current_schema_id: int = 0
    snapshots: list[dict] = field(default_factory=list)
    refs: dict[str, int] = field(default_factory=dict)
    last_sequence_number: int = 0


class FakeIcebergCatalog:
    """aiohttp server speaking the Iceberg REST catalog subset the
    destination uses, with full metadata validation."""

    def __init__(self) -> None:
        self.namespaces: set[str] = set()
        self.tables: dict[tuple[str, str], _Table] = {}
        self.commit_log: list[dict] = []  # every accepted commit body
        self.rejections: list[str] = []  # validation failures (messages)
        self._runner: web.AppRunner | None = None
        self.port = 0

    def url(self) -> str:
        return f"http://127.0.0.1:{self.port}"

    async def start(self) -> None:
        app = web.Application()
        app.router.add_post("/v1/namespaces", self._create_namespace)
        app.router.add_post("/v1/namespaces/{ns}/tables",
                            self._create_table)
        app.router.add_get("/v1/namespaces/{ns}/tables",
                           self._list_tables)
        app.router.add_get("/v1/namespaces/{ns}/tables/{t}",
                           self._load_table)
        app.router.add_post("/v1/namespaces/{ns}/tables/{t}",
                            self._commit_table)
        app.router.add_delete("/v1/namespaces/{ns}/tables/{t}",
                              self._drop_table)
        app.router.add_route("*", "/{tail:.*}", self._not_found)
        self._runner = web.AppRunner(app)
        await self._runner.setup()
        site = web.TCPSite(self._runner, "127.0.0.1", 0)
        await site.start()
        self.port = site._server.sockets[0].getsockname()[1]

    async def stop(self) -> None:
        if self._runner is not None:
            await self._runner.cleanup()
            self._runner = None

    # -- helpers ---------------------------------------------------------------

    def _reject(self, msg: str) -> web.Response:
        self.rejections.append(msg)
        return web.json_response({"error": {"message": msg}}, status=400)

    def table(self, ns: str, name: str) -> _Table:
        """Test accessor."""
        return self.tables[(ns, name)]

    # -- routes ----------------------------------------------------------------

    async def _not_found(self, request: web.Request) -> web.Response:
        return web.json_response(
            {"error": {"message": f"no route {request.path}"}}, status=404)

    async def _create_namespace(self, request: web.Request) -> web.Response:
        doc = await request.json()
        ns = ".".join(doc.get("namespace", []))
        if not ns:
            return self._reject("namespace must be a non-empty list")
        if ns in self.namespaces:
            return web.json_response(
                {"error": {"message": "namespace exists"}}, status=409)
        self.namespaces.add(ns)
        return web.json_response({"namespace": [ns]})

    async def _create_table(self, request: web.Request) -> web.Response:
        ns = request.match_info["ns"]
        if ns not in self.namespaces:
            return web.json_response(
                {"error": {"message": f"namespace {ns} missing"}},
                status=404)
        doc = await request.json()
        name = doc.get("name")
        schema = doc.get("schema")
        if not name:
            return self._reject("table name required")
        if not isinstance(schema, dict) or schema.get("type") != "struct":
            return self._reject("schema must be a struct")
        for f in schema.get("fields", []):
            if "id" not in f or "name" not in f or "type" not in f:
                return self._reject(f"field missing id/name/type: {f}")
        if (ns, name) in self.tables:
            return web.json_response(
                {"error": {"message": "table exists"}}, status=409)
        schema = dict(schema)
        schema.setdefault("schema-id", 0)
        self.tables[(ns, name)] = _Table(name=name, schemas=[schema])
        return web.json_response({"metadata": self._metadata(
            self.tables[(ns, name)])})

    def _metadata(self, t: _Table) -> dict:
        return {
            "format-version": 2,
            "current-schema-id": t.current_schema_id,
            "schemas": t.schemas,
            "snapshots": t.snapshots,
            "current-snapshot-id": t.refs.get("main"),
            "last-sequence-number": t.last_sequence_number,
            "refs": {k: {"snapshot-id": v, "type": "branch"}
                     for k, v in t.refs.items()},
        }

    async def _list_tables(self, request: web.Request) -> web.Response:
        ns = request.match_info["ns"]
        return web.json_response({"identifiers": [
            {"namespace": [n], "name": t.name}
            for (n, _), t in sorted(self.tables.items()) if n == ns]})

    async def _load_table(self, request: web.Request) -> web.Response:
        key = (request.match_info["ns"], request.match_info["t"])
        t = self.tables.get(key)
        if t is None:
            return web.json_response(
                {"error": {"message": "table missing"}}, status=404)
        return web.json_response({"metadata": self._metadata(t)})

    async def _drop_table(self, request: web.Request) -> web.Response:
        key = (request.match_info["ns"], request.match_info["t"])
        if self.tables.pop(key, None) is None:
            return web.json_response(
                {"error": {"message": "table missing"}}, status=404)
        return web.json_response({})

    async def _commit_table(self, request: web.Request) -> web.Response:
        key = (request.match_info["ns"], request.match_info["t"])
        t = self.tables.get(key)
        if t is None:
            return web.json_response(
                {"error": {"message": "table missing"}}, status=404)
        body = await request.json()
        if "updates" not in body or "requirements" not in body:
            return self._reject(
                "commit must carry requirements + updates (the legacy "
                "minimal /commit shape is not Iceberg REST)")
        # requirements: optimistic CAS
        for req in body["requirements"]:
            if req.get("type") == "assert-ref-snapshot-id":
                expect = req.get("snapshot-id")
                actual = t.refs.get(req.get("ref", "main"))
                if expect != actual:
                    return web.json_response(
                        {"error": {"message":
                                   f"CAS failure: ref at {actual}, "
                                   f"commit asserts {expect}"}},
                        status=409)
            elif req.get("type") == "assert-create":
                if t.snapshots:
                    return web.json_response(
                        {"error": {"message": "table not empty"}},
                        status=409)
            else:
                return self._reject(
                    f"unknown requirement {req.get('type')!r}")
        # all updates are STAGED and applied only after every one
        # validates — a real catalog applies the commit transactionally,
        # so a rejected multi-update body must leave no trace (a
        # half-applied add-schema would wedge the client's retry)
        staged_schemas = list(t.schemas)
        staged_current = t.current_schema_id
        staged_snapshot = None
        staged_ref: tuple[str, int] | None = None
        for up in body["updates"]:
            action = up.get("action")
            if action == "add-snapshot":
                snap = up.get("snapshot", {})
                err = self._validate_snapshot(t, snap,
                                              staged_schemas)
                if err:
                    return self._reject(err)
                staged_snapshot = snap
            elif action == "set-snapshot-ref":
                if staged_snapshot is None or \
                        up.get("snapshot-id") != \
                        staged_snapshot.get("snapshot-id"):
                    return self._reject(
                        "set-snapshot-ref must follow add-snapshot and "
                        "reference the snapshot it added")
                staged_ref = (up.get("ref-name", "main"),
                              up["snapshot-id"])
            elif action == "add-schema":
                schema = up.get("schema", {})
                want = len(staged_schemas)
                if schema.get("schema-id") != want:
                    return self._reject(
                        f"add-schema must carry schema-id {want}, got "
                        f"{schema.get('schema-id')}")
                err = self._validate_schema_ids(staged_schemas,
                                                staged_current, schema)
                if err:
                    return self._reject(err)
                staged_schemas = staged_schemas + [schema]
            elif action == "set-current-schema":
                sid = up.get("schema-id")
                if not any(s.get("schema-id") == sid
                           for s in staged_schemas):
                    return self._reject(f"unknown schema-id {sid}")
                staged_current = sid
            else:
                return self._reject(
                    f"unknown update action {action!r} (legacy minimal "
                    "shapes are rejected)")
        t.schemas = staged_schemas
        t.current_schema_id = staged_current
        if staged_ref is not None:
            t.snapshots.append(staged_snapshot)
            t.refs[staged_ref[0]] = staged_ref[1]
            t.last_sequence_number = staged_snapshot["sequence-number"]
        self.commit_log.append(body)
        return web.json_response({"metadata": self._metadata(t)})

    @staticmethod
    def _validate_schema_ids(schemas: list[dict], current_id: int,
                             new: dict) -> str | None:
        """Spec: field ids are assigned once and never reused — an
        existing column must keep its id across evolution, and a NEW
        column must not take an id any schema ever used."""
        cur = next((s for s in schemas
                    if s.get("schema-id") == current_id), None)
        prev_ids = {f["name"]: f["id"]
                    for f in (cur or {}).get("fields", [])}
        ever_used = {f["id"] for s in schemas
                     for f in s.get("fields", [])}
        seen: set[int] = set()
        for f in new.get("fields", []):
            if f["id"] in seen:
                return f"duplicate field id {f['id']} in schema"
            seen.add(f["id"])
            if f["name"] in prev_ids:
                if f["id"] != prev_ids[f["name"]]:
                    return (f"field {f['name']!r} changed id "
                            f"{prev_ids[f['name']]} → {f['id']} — ids "
                            "must be stable across evolution")
            elif f["id"] in ever_used:
                return (f"new field {f['name']!r} reuses id {f['id']} — "
                        "ids are never reused")
        return None

    # -- metadata-chain validation --------------------------------------------

    def _validate_snapshot(self, t: _Table, snap: dict,
                           schemas: list[dict] | None = None
                           ) -> str | None:
        import pyarrow.parquet as pq

        schemas = schemas if schemas is not None else t.schemas
        # the schema this snapshot was written under (field-id check)
        snap_schema = next(
            (s for s in schemas
             if s.get("schema-id") == snap.get("schema-id")), None)

        for req_field in ("snapshot-id", "sequence-number", "timestamp-ms",
                          "manifest-list", "summary"):
            if req_field not in snap:
                return f"snapshot missing {req_field}"
        if snap["sequence-number"] != t.last_sequence_number + 1:
            return (f"sequence-number must advance by 1 (have "
                    f"{t.last_sequence_number}, got "
                    f"{snap['sequence-number']})")
        parent = snap.get("parent-snapshot-id")
        if parent != t.refs.get("main"):
            return (f"parent-snapshot-id {parent} does not match branch "
                    f"head {t.refs.get('main')}")
        summary = snap["summary"]
        if summary.get("operation") not in ("append", "delete",
                                            "overwrite", "replace"):
            return f"bad summary.operation {summary.get('operation')!r}"
        # walk the manifest chain with the INDEPENDENT avro reader
        try:
            _, manifests, ml_meta = read_avro_ocf(snap["manifest-list"])
        except Exception as e:
            return f"manifest list unreadable: {e}"
        if ml_meta.get("snapshot-id") not in (None,
                                              str(snap["snapshot-id"])):
            return "manifest list metadata names a different snapshot"
        total_added = 0
        for m in manifests:
            try:
                _, entries, _ = read_avro_ocf(m["manifest_path"])
            except Exception as e:
                return f"manifest {m['manifest_path']} unreadable: {e}"
            if m["added_snapshot_id"] != snap["snapshot-id"]:
                return "manifest added_snapshot_id mismatch"
            if len([e for e in entries if e["status"] == 1]) \
                    != m["added_files_count"]:
                return "manifest added_files_count disagrees with entries"
            rows_in_manifest = 0
            for entry in entries:
                if entry["snapshot_id"] != snap["snapshot-id"]:
                    return "manifest entry snapshot_id mismatch"
                if entry["sequence_number"] != snap["sequence-number"]:
                    return "manifest entry sequence_number mismatch"
                df = entry["data_file"]
                try:
                    actual = pq.ParquetFile(df["file_path"]).metadata
                except Exception as e:
                    return f"data file {df['file_path']} unreadable: {e}"
                if actual.num_rows != df["record_count"]:
                    return (f"record_count {df['record_count']} != parquet "
                            f"rows {actual.num_rows}")
                if df["file_format"] != "PARQUET":
                    return f"bad file_format {df['file_format']!r}"
                # spec: data-file columns must resolve by FIELD ID —
                # every parquet column must carry a field_id matching
                # the snapshot's schema (name-based projection is not
                # conformant without a name mapping)
                if snap_schema is not None:
                    want = {f["name"]: f["id"]
                            for f in snap_schema.get("fields", [])}
                    arrow = pq.read_schema(df["file_path"])
                    for fld in arrow:
                        fid = (fld.metadata or {}).get(
                            b"PARQUET:field_id")
                        if fid is None:
                            return (f"data file column {fld.name!r} "
                                    "carries no parquet field_id")
                        if want.get(fld.name) != int(fid):
                            return (f"data file column {fld.name!r} "
                                    f"field_id {int(fid)} != schema id "
                                    f"{want.get(fld.name)}")
                rows_in_manifest += df["record_count"]
            if rows_in_manifest != m["added_rows_count"]:
                return "manifest added_rows_count disagrees with entries"
            total_added += rows_in_manifest
        if int(summary.get("added-records", "0")) != total_added:
            return (f"summary added-records {summary.get('added-records')} "
                    f"!= manifest total {total_added}")
        return None
