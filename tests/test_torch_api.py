"""The port's control plane (`etl_tpu_torch/api/`) held to the
reference's API tests: the classes of `tests/test_api.py`, run on the
port's modules (the app, crypto, db, orchestrator and validation, the
port's fake Postgres server and HTTP fake) on both storage backends.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_api*.py -q

Tolerance: exact — the same statuses and bodies as the reference's
tests assert.
"""

import asyncio
import json

import pytest
from aiohttp.test_utils import TestClient, TestServer

from etl_tpu_torch.api.app import ApiState, build_app
from etl_tpu_torch.api.crypto import ConfigCipher, EncryptionKey
from etl_tpu_torch.api.orchestrator import (K8sOrchestrator, Orchestrator,
                                      ReplicatorSpec, ReplicatorStatus)
from etl_tpu_torch.testing.fake_http import RecordingHttpServer


class StubOrchestrator(Orchestrator):
    def __init__(self):
        self.calls = []
        self.specs = []
        self.running = set()

    async def start_pipeline(self, spec):
        self.calls.append(("start", spec.pipeline_id, spec.config))
        self.specs.append(spec)
        self.running.add(spec.pipeline_id)

    async def stop_pipeline(self, pipeline_id):
        self.calls.append(("stop", pipeline_id))
        self.running.discard(pipeline_id)

    async def status(self, pipeline_id):
        state = "running" if pipeline_id in self.running else "stopped"
        return ReplicatorStatus(pipeline_id, state)


_BACKEND = "sqlite"


@pytest.fixture(autouse=True, params=["sqlite", "postgres"])
def api_backend(request):
    """Every API test runs against BOTH storage backends (the API owns
    a Postgres database; the suite must prove the same statement set
    works over the wire-client pool)."""
    global _BACKEND
    _BACKEND = request.param
    yield request.param
    _BACKEND = "sqlite"


async def _make_db(tmp_path):
    """(db-or-path, extra-cleanup) for the active backend."""
    if _BACKEND == "postgres":
        from etl_tpu_torch.api.db import PostgresApiDb
        from etl_tpu_torch.config import PgConnectionConfig
        from etl_tpu_torch.postgres.fake import FakeDatabase
        from etl_tpu_torch.testing.fake_pg_server import FakePgServer

        server = FakePgServer(FakeDatabase())
        await server.start()
        db = PostgresApiDb(PgConnectionConfig(
            host="127.0.0.1", port=server.port,
            name="postgres", username="etl"))
        return db, server.stop
    return str(tmp_path / "api.db"), None


async def make_client(tmp_path, orchestrator=None, api_key=None):
    db, cleanup = await _make_db(tmp_path)
    state = ApiState(db, ConfigCipher(EncryptionKey.generate()),
                     orchestrator or StubOrchestrator(), api_key=api_key)
    app = build_app(state)
    if cleanup is not None:
        async def _stop(_app):
            await cleanup()

        app.on_cleanup.append(_stop)
    client = TestClient(TestServer(app))
    await client.start_server()
    return client, state


H = {"tenant_id": "acme"}


async def setup_pipeline(client):
    await client.post("/v1/tenants", json={"id": "acme", "name": "Acme"})
    src = await (await client.post(
        "/v1/sources", headers=H,
        json={"name": "prod-db",
              "config": {"host": "db", "port": 5432, "name": "app",
                         "username": "etl", "password": "s3cret-password-42"}})).json()
    dst = await (await client.post(
        "/v1/destinations", headers=H,
        json={"name": "lake", "config": {"type": "lake",
                                         "warehouse_path": "/tmp/wh"}})).json()
    resp = await client.post(
        "/v1/pipelines", headers=H,
        json={"source_id": src["id"], "destination_id": dst["id"],
              "publication_name": "pub"})
    return (await resp.json())["id"]


class TestCrudAndTenancy:
    async def test_full_crud(self, tmp_path):
        client, state = await make_client(tmp_path)
        try:
            pid = await setup_pipeline(client)
            resp = await client.get(f"/v1/pipelines/{pid}", headers=H)
            doc = await resp.json()
            assert doc["publication_name"] == "pub"
            resp = await client.get("/v1/sources/1", headers=H)
            src = await resp.json()
            # secrets are MASKED on read (never echo decrypted
            # credentials); non-secret fields stay readable
            assert src["config"]["password"] == "********"
            assert src["config"]["host"] == "db"
            # raw row on disk is encrypted
            raw = (await state.db.run(
                "SELECT config_enc FROM api_sources"))[0][0]
            assert "s3cret-password-42" not in raw
            env = json.loads(raw)
            assert set(env) == {"key_id", "nonce", "ciphertext"}
        finally:
            await client.close()

    async def test_tenant_isolation(self, tmp_path):
        client, _ = await make_client(tmp_path)
        try:
            pid = await setup_pipeline(client)
            other = {"tenant_id": "rival"}
            assert (await client.get(f"/v1/pipelines/{pid}",
                                     headers=other)).status == 404
            assert (await client.get("/v1/sources/1",
                                     headers=other)).status == 404
            listing = await (await client.get("/v1/pipelines",
                                              headers=other)).json()
            assert listing == []
        finally:
            await client.close()

    async def test_missing_tenant_header(self, tmp_path):
        client, _ = await make_client(tmp_path)
        try:
            assert (await client.get("/v1/sources")).status == 401
            assert (await client.get(
                "/v1/sources", headers={"tenant_id": "x; DROP"})).status == 401
        finally:
            await client.close()

    async def test_validation_errors(self, tmp_path):
        client, _ = await make_client(tmp_path)
        try:
            await client.post("/v1/tenants", json={"id": "acme", "name": "A"})
            assert (await client.post(
                "/v1/tenants", json={"id": "acme", "name": "B"})).status == 409
            assert (await client.post(
                "/v1/pipelines", headers=H, json={})).status == 400
            assert (await client.post(
                "/v1/pipelines", headers=H,
                json={"source_id": 99, "destination_id": 99,
                      "publication_name": "p"})).status == 404
        finally:
            await client.close()


class TestLifecycle:
    async def test_start_stop_status(self, tmp_path):
        orch = StubOrchestrator()
        client, _ = await make_client(tmp_path, orch)
        try:
            pid = await setup_pipeline(client)
            resp = await client.post(f"/v1/pipelines/{pid}/start", headers=H)
            assert resp.status == 202
            # the orchestrator received the assembled, DECRYPTED config
            op, opid, config = orch.calls[0]
            assert (op, opid) == ("start", pid)
            assert config["pg_connection"]["password"] == "s3cret-password-42"
            assert config["destination"]["type"] == "lake"
            assert config["publication_name"] == "pub"
            st = await (await client.get(f"/v1/pipelines/{pid}/status",
                                         headers=H)).json()
            assert st["state"] == "running"
            await client.post(f"/v1/pipelines/{pid}/stop", headers=H)
            st = await (await client.get(f"/v1/pipelines/{pid}/status",
                                         headers=H)).json()
            assert st["state"] == "stopped"
        finally:
            await client.close()

    async def test_replication_status_and_rollback(self, tmp_path):
        from etl_tpu_torch.models.errors import RetryKind
        from etl_tpu_torch.runtime.state import TableState, TableStateType
        from etl_tpu_torch.store.sql import SqliteStore

        store_path = str(tmp_path / "pipe.db")
        client, _ = await make_client(tmp_path)
        try:
            await client.post("/v1/tenants", json={"id": "acme", "name": "A"})
            src = await (await client.post(
                "/v1/sources", headers=H,
                json={"name": "s", "config": {
                    "host": "db", "port": 5432, "name": "app",
                    "username": "etl"}})).json()
            dst = await (await client.post(
                "/v1/destinations", headers=H,
                json={"name": "d", "config": {"type": "memory"}})).json()
            resp = await client.post(
                "/v1/pipelines", headers=H,
                json={"source_id": src["id"], "destination_id": dst["id"],
                      "publication_name": "pub", "store_path": store_path})
            pid = (await resp.json())["id"]
            # seed the pipeline's durable store
            store = SqliteStore(store_path, pid)
            await store.connect()
            await store.update_table_state(101, TableState.ready())
            await store.update_table_state(102, TableState.errored(
                "boom", retry_policy=RetryKind.MANUAL, retry_attempts=5))
            await store.close()

            doc = await (await client.get(
                f"/v1/pipelines/{pid}/replication-status",
                headers=H)).json()
            by_id = {t["table_id"]: t for t in doc["tables"]}
            assert by_id[101]["state"] == "ready"
            assert by_id[102]["state"] == "errored"
            assert by_id[102]["retry_policy"] == "manual"

            doc = await (await client.post(
                f"/v1/pipelines/{pid}/rollback-tables", headers=H,
                json={})).json()
            assert doc["rolled_back"] == [102]  # only errored tables
            store = SqliteStore(store_path, pid)
            await store.connect()
            st = await store.get_table_state(102)
            assert st.type is TableStateType.INIT
            await store.close()
        finally:
            await client.close()


class TestK8sOrchestrator:
    async def test_resource_creation(self):
        server = RecordingHttpServer()
        await server.start()
        try:
            orch = K8sOrchestrator(api_url=server.url(), namespace="etl")
            spec = ReplicatorSpec(pipeline_id=7, tenant_id="acme",
                                  config={"pipeline_id": 7,
                                          "publication_name": "pub",
                                          "pg_connection": {
                                              "host": "db",
                                              "password": "hunter2"}})
            await orch.start_pipeline(spec)
            paths = server.paths()
            assert "POST /api/v1/namespaces/etl/secrets" in paths
            assert "POST /api/v1/namespaces/etl/configmaps" in paths
            assert "POST /apis/apps/v1/namespaces/etl/statefulsets" in paths
            sts = [r for r in server.requests
                   if r.path.endswith("/statefulsets")][0].json
            assert sts["metadata"]["name"] == "etl-replicator-7"
            assert sts["metadata"]["labels"]["tenant_id"] == "acme"
            # credentials live in the Secret as APP_ env names; the
            # ConfigMap's config document carries NO secret values
            secret = [r for r in server.requests
                      if r.path.endswith("/secrets")][0].json
            assert secret["stringData"] == {
                "APP_PG_CONNECTION__PASSWORD": "hunter2"}
            cm = [r for r in server.requests
                  if r.path.endswith("/configmaps")][0].json
            # key must be base.yaml — the name the config loader reads
            assert "publication_name: pub" in cm["data"]["base.yaml"]
            assert "hunter2" not in cm["data"]["base.yaml"]
            container = sts["spec"]["template"]["spec"]["containers"][0]
            assert container["envFrom"] == [
                {"secretRef": {"name": "etl-replicator-7-secrets"}}]
            await orch.stop_pipeline(7)
            deletes = [p for p in server.paths() if p.startswith("DELETE")]
            # stop is a PAUSE: workload resources go (sts, secret,
            # configmap); the warehouse PVC and the maintenance CronJob
            # stay — deleting the CronJob from the pause gate's own
            # /stop call would cascade-GC the running maintenance Job
            assert len(deletes) == 3
            assert not any("persistentvolumeclaims" in p for p in deletes)
            assert not any("cronjobs" in p for p in deletes)
            # ...but it is SUSPENDED so a scheduled run can't auto-start
            # the deliberately paused pipeline
            suspends = [r for r in server.requests
                        if r.method == "PATCH" and "cronjobs" in r.path]
            assert suspends and suspends[-1].json == {
                "spec": {"suspend": True}}
            # permanent teardown drops the CronJob and PVC too
            await orch.delete_pipeline(7)
            deletes = [p for p in server.paths() if p.startswith("DELETE")]
            assert sum(1 for p in deletes
                       if "persistentvolumeclaims" in p) == 1
            assert sum(1 for p in deletes if "cronjobs" in p) == 1
            await orch.shutdown()
        finally:
            await server.stop()

    async def test_lake_destination_gets_maintenance_cronjob(self):
        server = RecordingHttpServer()
        await server.start()
        try:
            orch = K8sOrchestrator(api_url=server.url(), namespace="etl")
            await orch.start_pipeline(ReplicatorSpec(
                3, "t", {"destination": {"type": "lake",
                                         "warehouse_path": "/wh"},
                         "maintenance": {"schedule": "0 2 * * *"}}))
            cron = [r for r in server.requests
                    if r.path.endswith("/cronjobs")][0].json
            assert cron["metadata"]["name"] == "etl-replicator-3-maintenance"
            assert cron["spec"]["schedule"] == "0 2 * * *"
            assert cron["spec"]["concurrencyPolicy"] == "Forbid"
            job_spec = cron["spec"]["jobTemplate"]["spec"]["template"][
                "spec"]
            args = job_spec["containers"][0]["args"]
            assert "--warehouse" in args and "/wh" in args
            # the pause gate (maintenance.py run_maintenance) requires
            # BOTH --api-url and --pipeline-id; without the id the job
            # compacts while the replicator is live
            assert "--pipeline-id" in args
            assert args[args.index("--pipeline-id") + 1] == "3"
            assert "--coordinate" not in args  # not opted in here
            # no control-plane URL configured -> no pause-gate API args
            # (the replicator pod serves only /metrics + /health, so
            # pointing --api-url at it would fail every run)
            assert "--api-url" not in args
            # replicator + maintenance share ONE warehouse PVC mounted at
            # the warehouse path — separate pod-local filesystems would
            # make compaction a silent no-op
            assert job_spec["volumes"] == [{
                "name": "warehouse", "persistentVolumeClaim": {
                    "claimName": "etl-replicator-3-warehouse"}}]
            assert job_spec["containers"][0]["volumeMounts"] == [
                {"name": "warehouse", "mountPath": "/wh"}]
            pvc = [r for r in server.requests
                   if r.path.endswith("/persistentvolumeclaims")]
            assert len(pvc) == 1
            assert pvc[0].json["metadata"]["name"] == \
                "etl-replicator-3-warehouse"
            sts = [r for r in server.requests
                   if r.path.endswith("/statefulsets")][0].json
            sts_spec = sts["spec"]["template"]["spec"]
            assert {"name": "warehouse", "persistentVolumeClaim": {
                "claimName": "etl-replicator-3-warehouse"}} \
                in sts_spec["volumes"]
            assert {"name": "warehouse", "mountPath": "/wh"} \
                in sts_spec["containers"][0]["volumeMounts"]
            await orch.shutdown()
        finally:
            await server.stop()

    async def test_coordinated_maintenance_cronjob_opt_in(self):
        server = RecordingHttpServer()
        await server.start()
        try:
            orch = K8sOrchestrator(api_url=server.url(), namespace="etl")
            await orch.start_pipeline(ReplicatorSpec(
                4, "t", {"destination": {"type": "lake",
                                         "warehouse_path": "/wh"},
                         "maintenance": {"coordination": True}}))
            cron = [r for r in server.requests
                    if r.path.endswith("/cronjobs")][0].json
            job_spec = cron["spec"]["jobTemplate"]["spec"]["template"][
                "spec"]
            args = job_spec["containers"][0]["args"]
            assert "--coordinate" in args
            # coordination rides the shared warehouse catalog: no API args
            assert "--api-url" not in args
            # RWO PVC: the job must be co-scheduled with the replicator
            aff = job_spec["affinity"]["podAffinity"][
                "requiredDuringSchedulingIgnoredDuringExecution"][0]
            assert aff["labelSelector"]["matchLabels"] == {
                "app": "etl-replicator-4"}
            assert aff["topologyKey"] == "kubernetes.io/hostname"
            await orch.shutdown()
        finally:
            await server.stop()

    async def test_uncoordinated_cronjob_uses_control_plane_gate(self):
        server = RecordingHttpServer()
        await server.start()
        try:
            orch = K8sOrchestrator(api_url=server.url(), namespace="etl",
                                   control_api_url="http://etl-api:8000",
                                   control_api_key_secret="etl-api-key")
            await orch.start_pipeline(ReplicatorSpec(
                5, "acme", {"destination": {"type": "lake",
                                            "warehouse_path": "/wh",
                                            "warehouse_size": "50Gi"}}))
            cron = [r for r in server.requests
                    if r.path.endswith("/cronjobs")][0].json
            args = cron["spec"]["jobTemplate"]["spec"]["template"]["spec"][
                "containers"][0]["args"]
            # pause gate aimed at the CONTROL-PLANE API with the
            # pipeline's tenant identity
            assert args[args.index("--api-url") + 1] == \
                "http://etl-api:8000"
            assert args[args.index("--tenant-id") + 1] == "acme"
            assert "--coordinate" not in args
            env = cron["spec"]["jobTemplate"]["spec"]["template"]["spec"][
                "containers"][0]["env"]
            # secured control plane: bearer token reaches the job as
            # ETL_API_KEY (maintenance.py:194) via a deployer Secret
            assert env == [{"name": "ETL_API_KEY", "valueFrom": {
                "secretKeyRef": {"name": "etl-api-key",
                                 "key": "api-key"}}}]
            pvc = [r for r in server.requests
                   if r.path.endswith("/persistentvolumeclaims")][0].json
            assert pvc["spec"]["resources"]["requests"]["storage"] == "50Gi"
            await orch.shutdown()
        finally:
            await server.stop()

    async def test_pod_status_derivation(self):
        from etl_tpu_torch.api.orchestrator import derive_pod_status

        assert derive_pod_status(None) == "stopped"
        assert derive_pod_status(
            {"metadata": {"deletionTimestamp": "t"}}) == "stopping"
        assert derive_pod_status(
            {"metadata": {}, "status": {"phase": "Pending"}}) == "starting"
        assert derive_pod_status({"metadata": {}, "status": {
            "phase": "Running",
            "containerStatuses": [{"ready": True, "state": {}}],
        }}) == "started"
        assert derive_pod_status({"metadata": {}, "status": {
            "phase": "Running",
            "containerStatuses": [{"ready": False, "state": {
                "waiting": {"reason": "CrashLoopBackOff"}}}],
        }}) == "failed"
        assert derive_pod_status({"metadata": {}, "status": {
            "phase": "Running",
            "containerStatuses": [{"ready": False, "state": {
                "terminated": {"exitCode": 1}}}],
        }}) == "failed"
        assert derive_pod_status(
            {"metadata": {}, "status": {"phase": "Succeeded"}}) == "stopped"
        assert derive_pod_status(
            {"metadata": {}, "status": {"phase": "Failed"}}) == "failed"

    async def test_status_reports_crashloop_as_failed(self):
        server = RecordingHttpServer()
        await server.start()
        try:
            def responder(req):
                if "/pods" in req.path:
                    return 200, {"items": [{"metadata": {}, "status": {
                        "phase": "Running",
                        "containerStatuses": [{"ready": False, "state": {
                            "waiting": {"reason": "CrashLoopBackOff"}}}],
                    }}]}
                if req.path.endswith("/statefulsets/etl-replicator-9"):
                    return 200, {"status": {"readyReplicas": 0}}
                return None

            server.responders.append(responder)
            orch = K8sOrchestrator(api_url=server.url(), namespace="etl")
            st = await orch.status(9)
            assert st.state == "failed"
            await orch.shutdown()
        finally:
            await server.stop()

    async def test_conflict_replaces(self):
        server = RecordingHttpServer()
        await server.start()
        try:
            server.fail_next = [409]  # first resource (Secret) exists
            orch = K8sOrchestrator(api_url=server.url())
            await orch.start_pipeline(ReplicatorSpec(1, "t", {}))
            # an existing Secret is REPLACED via PUT (atomic, no
            # delete-to-create window) so rotated-away credential keys
            # cannot survive a merge and a concurrently starting pod
            # never sees the Secret missing
            paths = server.paths()
            puts = [p for p in paths
                    if p.startswith("PUT ") and "secrets" in p]
            assert len(puts) == 1
            assert not any(p.startswith("DELETE ") for p in paths)
            await orch.shutdown()
        finally:
            await server.stop()

    async def test_conflict_patches_statefulset(self):
        server = RecordingHttpServer()
        await server.start()
        try:
            server.responders.append(
                lambda req: (409, {}) if req.method == "POST"
                and req.path.endswith("/statefulsets") else None)
            orch = K8sOrchestrator(api_url=server.url())
            await orch.start_pipeline(ReplicatorSpec(1, "t", {}))
            # workloads roll via strategic-merge PATCH, not recreate
            assert any(p.startswith("PATCH ") and "statefulsets" in p
                       for p in server.paths())
            await orch.shutdown()
        finally:
            await server.stop()


class TestReviewRegressions:
    async def test_non_numeric_id_is_404(self, tmp_path):
        client, _ = await make_client(tmp_path)
        try:
            await client.post("/v1/tenants", json={"id": "acme", "name": "A"})
            for path in ("/v1/sources/abc", "/v1/pipelines/abc",
                         "/v1/destinations/%20"):
                assert (await client.get(path, headers=H)).status == 404
            assert (await client.post("/v1/pipelines/xyz/start",
                                      headers=H)).status == 404
        finally:
            await client.close()

    async def test_malformed_body_is_400(self, tmp_path):
        client, _ = await make_client(tmp_path)
        try:
            await client.post("/v1/tenants", json={"id": "acme", "name": "A"})
            resp = await client.post("/v1/sources", headers=H,
                                     data=b"not json")
            assert resp.status == 400
        finally:
            await client.close()

    async def test_delete_referenced_source_conflicts(self, tmp_path):
        client, _ = await make_client(tmp_path)
        try:
            pid = await setup_pipeline(client)
            resp = await client.delete("/v1/sources/1", headers=H)
            assert resp.status == 409
            assert "in use" in (await resp.json())["error"]
            # deleting the pipeline first frees the source
            await client.delete(f"/v1/pipelines/{pid}", headers=H)
            assert (await client.delete("/v1/sources/1",
                                        headers=H)).status == 204
        finally:
            await client.close()


class TestSlotLagSurface:
    async def test_replication_status_includes_slot_lag(self, tmp_path):
        """replication-status surfaces source-side slot lag when the
        source is reachable (reference lag.rs via routes/pipelines.rs) and
        degrades to null when it isn't."""
        from etl_tpu_torch.runtime.state import TableState
        from etl_tpu_torch.store.sql import SqliteStore
        from etl_tpu_torch.testing.fake_pg_server import FakePgServer
        from etl_tpu_torch.postgres.fake import FakeDatabase
        from etl_tpu_torch.models import ColumnSchema, Oid, TableName, TableSchema

        db = FakeDatabase()
        db.create_table(TableSchema(
            16384, TableName("public", "t"),
            (ColumnSchema("id", Oid.INT4, nullable=False,
                          primary_key_ordinal=1),)))
        db.create_publication("pub", [16384])
        from etl_tpu_torch.postgres.fake import FakeSource
        await FakeSource(db).create_slot("supabase_etl_apply_7")
        server = FakePgServer(db)
        await server.start()

        store_path = str(tmp_path / "pipe.db")
        client, _ = await make_client(tmp_path)
        try:
            await client.post("/v1/tenants", json={"id": "acme", "name": "A"})
            src = await (await client.post(
                "/v1/sources", headers=H,
                json={"name": "s", "config": {
                    "host": "127.0.0.1", "port": server.port,
                    "name": "postgres", "username": "etl"}})).json()
            dst = await (await client.post(
                "/v1/destinations", headers=H,
                json={"name": "d", "config": {"type": "memory"}})).json()
            resp = await client.post(
                "/v1/pipelines", headers=H,
                json={"source_id": src["id"], "destination_id": dst["id"],
                      "publication_name": "pub", "store_path": store_path})
            pid = (await resp.json())["id"]
            store = SqliteStore(store_path, pid)
            await store.connect()
            await store.update_table_state(16384, TableState.ready())
            await store.close()

            doc = await (await client.get(
                f"/v1/pipelines/{pid}/replication-status",
                headers=H)).json()
            assert doc["slot_lag"], doc
            slot = doc["slot_lag"][0]
            assert slot["slot_name"].startswith("supabase_etl_")
            assert "confirmed_flush_lag_bytes" in slot
        finally:
            await client.close()
            await server.stop()

    async def test_slot_lag_null_when_source_unreachable(self, tmp_path):
        from etl_tpu_torch.runtime.state import TableState
        from etl_tpu_torch.store.sql import SqliteStore

        store_path = str(tmp_path / "pipe.db")
        client, _ = await make_client(tmp_path)
        try:
            await client.post("/v1/tenants", json={"id": "acme", "name": "A"})
            src = await (await client.post(
                "/v1/sources", headers=H,
                json={"name": "s", "config": {
                    "host": "127.0.0.1", "port": 1,
                    "name": "postgres", "username": "etl"}})).json()
            dst = await (await client.post(
                "/v1/destinations", headers=H,
                json={"name": "d", "config": {"type": "memory"}})).json()
            resp = await client.post(
                "/v1/pipelines", headers=H,
                json={"source_id": src["id"], "destination_id": dst["id"],
                      "publication_name": "pub", "store_path": store_path})
            pid = (await resp.json())["id"]
            store = SqliteStore(store_path, pid)
            await store.connect()
            await store.update_table_state(1, TableState.ready())
            await store.close()
            doc = await (await client.get(
                f"/v1/pipelines/{pid}/replication-status",
                headers=H)).json()
            assert doc["slot_lag"] is None
        finally:
            await client.close()


class TestAuth:
    async def test_bearer_key_required_when_configured(self, tmp_path):
        client, state = await make_client(tmp_path, api_key="k-12345")
        try:
            # no key → 401 before tenant routing
            r = await client.get("/v1/tenants", headers=H)
            assert r.status == 401
            r = await client.get("/v1/tenants", headers={
                **H, "Authorization": "Bearer wrong"})
            assert r.status == 401
            r = await client.get("/v1/tenants", headers={
                **H, "Authorization": "Bearer k-12345"})
            assert r.status == 200
            # health/metrics/openapi stay open for probes
            assert (await client.get("/health")).status == 200
            assert (await client.get("/openapi.json")).status == 200
        finally:
            await client.close()


class TestImages:
    async def test_images_crud_and_default_used_at_start(self, tmp_path):
        orch = StubOrchestrator()
        client, _ = await make_client(tmp_path, orch)
        try:
            pid = await setup_pipeline(client)
            img = await (await client.post(
                "/v1/images", headers=H,
                json={"name": "replicator:v2", "default": True})).json()
            await client.post("/v1/images", headers=H,
                              json={"name": "replicator:v3"})
            imgs = await (await client.get("/v1/images",
                                           headers=H)).json()
            assert {i["name"]: i["default"] for i in imgs} == {
                "replicator:v2": True, "replicator:v3": False}
            # duplicate name → 409
            assert (await client.post(
                "/v1/images", headers=H,
                json={"name": "replicator:v2"})).status == 409

            await client.post(f"/v1/pipelines/{pid}/start", headers=H)
            # StubOrchestrator doesn't capture image; assert via spec calls
            assert orch.specs[-1].image == "replicator:v2"

            v3 = next(i for i in imgs if i["name"] == "replicator:v3")
            await client.post(f"/v1/images/{v3['id']}/set-default",
                              headers=H)
            await client.post(f"/v1/pipelines/{pid}/restart", headers=H)
            assert orch.specs[-1].image == "replicator:v3"
            assert (await client.delete(f"/v1/images/{v3['id']}",
                                        headers=H)).status == 204
        finally:
            await client.close()

    async def test_pipeline_version_pins_and_rolls_out(self, tmp_path):
        """POST /pipelines/{id}/version (reference
        routes/pipelines.rs:662-735): pins the image the pipeline runs
        independent of the tenant default, re-applies a RUNNING
        pipeline so the rollout happens now, and reverts to
        default-tracking when image_id is omitted."""
        orch = StubOrchestrator()
        client, _ = await make_client(tmp_path, orch)
        try:
            pid = await setup_pipeline(client)
            await client.post("/v1/images", headers=H,
                              json={"name": "replicator:v2",
                                    "default": True})
            v9 = await (await client.post(
                "/v1/images", headers=H,
                json={"name": "replicator:v9"})).json()

            # stopped pipeline: version pin persists, no rollout yet
            r = await (await client.post(
                f"/v1/pipelines/{pid}/version", headers=H,
                json={"image_id": v9["id"]})).json()
            assert r == {"id": pid, "image": "replicator:v9",
                         "pinned": True, "rolled_out": False}
            got = await (await client.get(
                f"/v1/pipelines/{pid}", headers=H)).json()
            assert got["image"] == "replicator:v9"
            # start uses the PIN, not the default
            await client.post(f"/v1/pipelines/{pid}/start", headers=H)
            assert orch.specs[-1].image == "replicator:v9"

            # running pipeline: a version change rolls out immediately
            r = await (await client.post(
                f"/v1/pipelines/{pid}/version", headers=H,
                json={})).json()
            assert r["pinned"] is False and r["rolled_out"] is True
            assert r["image"] == "replicator:v2"  # back on the default
            assert orch.specs[-1].image == "replicator:v2"

            # unknown image → 404; non-int → 400
            assert (await client.post(
                f"/v1/pipelines/{pid}/version", headers=H,
                json={"image_id": 999})).status == 404
            assert (await client.post(
                f"/v1/pipelines/{pid}/version", headers=H,
                json={"image_id": "vX"})).status == 400

            # deleting an image a pipeline PINS → 409 (a silent delete
            # would leave the pipeline deploying an unregistered name);
            # unpin → delete succeeds
            await client.post(f"/v1/pipelines/{pid}/version", headers=H,
                              json={"image_id": v9["id"]})
            assert (await client.delete(
                f"/v1/images/{v9['id']}", headers=H)).status == 409
            await client.post(f"/v1/pipelines/{pid}/version", headers=H,
                              json={})
            assert (await client.delete(
                f"/v1/images/{v9['id']}", headers=H)).status == 204
        finally:
            await client.close()


class TestRollbackDepth:
    async def test_rollback_reports_prior_state_and_clears_progress(
            self, tmp_path):
        from etl_tpu_torch.models import Lsn, RetryKind
        from etl_tpu_torch.postgres.slots import table_sync_slot_name
        from etl_tpu_torch.runtime.state import TableState, TableStateType
        from etl_tpu_torch.store.sql import SqliteStore

        store_path = str(tmp_path / "p.db")
        client, _ = await make_client(tmp_path)
        try:
            await client.post("/v1/tenants", json={"id": "acme", "name": "A"})
            src = await (await client.post(
                "/v1/sources", headers=H,
                json={"name": "s", "config": {
                    "host": "db", "port": 5432, "name": "app",
                    "username": "etl"}})).json()
            dst = await (await client.post(
                "/v1/destinations", headers=H,
                json={"name": "d", "config": {"type": "memory"}})).json()
            pid = (await (await client.post(
                "/v1/pipelines", headers=H,
                json={"source_id": src["id"], "destination_id": dst["id"],
                      "publication_name": "pub",
                      "store_path": store_path})).json())["id"]
            store = SqliteStore(store_path, pid)
            await store.connect()
            await store.update_table_state(7, TableState.errored(
                "kaput", retry_policy=RetryKind.MANUAL, retry_attempts=3))
            await store.update_durable_progress(
                table_sync_slot_name(pid, 7), Lsn(900))
            await store.close()

            doc = await (await client.post(
                f"/v1/pipelines/{pid}/rollback-tables", headers=H,
                json={"table_ids": [7, 999]})).json()
            assert doc["rolled_back"] == [7]
            assert doc["unknown_table_ids"] == [999]
            assert doc["tables"][0]["previous_state"] == "errored"
            assert doc["tables"][0]["previous_reason"] == "kaput"

            store = SqliteStore(store_path, pid)
            await store.connect()
            assert (await store.get_table_state(7)).type \
                is TableStateType.INIT
            assert await store.get_durable_progress(
                table_sync_slot_name(pid, 7)) is None
            await store.close()
        finally:
            await client.close()


class TestOpenApi:
    async def test_document_covers_every_route(self, tmp_path):
        client, _ = await make_client(tmp_path)
        try:
            doc = await (await client.get("/openapi.json")).json()
            assert doc["openapi"].startswith("3.")
            app_routes = {
                "/v1/tenants", "/v1/sources", "/v1/sources/{id}",
                "/v1/destinations", "/v1/destinations/{id}", "/v1/images",
                "/v1/images/{id}", "/v1/images/{id}/set-default",
                "/v1/pipelines", "/v1/pipelines/{id}",
                "/v1/pipelines/{id}/start", "/v1/pipelines/{id}/stop",
                "/v1/pipelines/{id}/restart", "/v1/pipelines/{id}/status",
                "/v1/pipelines/{id}/replication-status",
                "/v1/pipelines/{id}/rollback-tables"}
            assert app_routes <= set(doc["paths"])
            # every operation carries a human summary + response schema
            for path, ops in doc["paths"].items():
                for method, op in ops.items():
                    assert op.get("summary"), (path, method)
                    assert "responses" in op, (path, method)
            assert "bearer" in doc["components"]["securitySchemes"]
        finally:
            await client.close()


class TestSecretRoundTrip:
    async def test_put_back_masked_config_keeps_real_secret(self, tmp_path):
        """GET → edit → PUT must not overwrite the stored credential with
        the mask sentinel."""
        orch = StubOrchestrator()
        client, _ = await make_client(tmp_path, orch)
        try:
            pid = await setup_pipeline(client)
            got = await (await client.get("/v1/sources/1",
                                          headers=H)).json()
            assert got["config"]["password"] == "********"
            got["config"]["host"] = "db2"  # unrelated edit
            r = await client.put("/v1/sources/1", headers=H,
                                 json={"config": got["config"]})
            assert r.status == 200
            await client.post(f"/v1/pipelines/{pid}/start", headers=H)
            cfg = orch.calls[-1][2]
            assert cfg["pg_connection"]["password"] == "s3cret-password-42"
            assert cfg["pg_connection"]["host"] == "db2"
        finally:
            await client.close()

    async def test_nested_secret_values_masked(self, tmp_path):
        client, _ = await make_client(tmp_path)
        try:
            await client.post("/v1/tenants", json={"id": "acme", "name": "A"})
            await client.post(
                "/v1/sources", headers=H,
                json={"name": "s", "config": {
                    "token": {"value": "eyJhbGci"},
                    "keys": ["k1", "k2"], "host": "h", "port": 5432,
                    "name": "app", "username": "etl"}})
            got = await (await client.get("/v1/sources/1",
                                          headers=H)).json()
            assert got["config"]["token"] == "********"
            assert got["config"]["keys"] == "********"
            assert got["config"]["host"] == "h"
        finally:
            await client.close()


class TestImageTenancy:
    async def test_images_are_tenant_scoped(self, tmp_path):
        client, _ = await make_client(tmp_path)
        try:
            await client.post("/v1/tenants", json={"id": "acme", "name": "A"})
            await client.post("/v1/tenants", json={"id": "rival", "name": "R"})
            await client.post("/v1/images", headers=H,
                              json={"name": "mine:v1", "default": True})
            other = {"tenant_id": "rival"}
            assert await (await client.get("/v1/images",
                                           headers=other)).json() == []
            # rival can't hijack acme's default or delete acme's image
            assert (await client.post("/v1/images/1/set-default",
                                      headers=other)).status == 404
            await client.delete("/v1/images/1", headers=other)
            imgs = await (await client.get("/v1/images", headers=H)).json()
            assert imgs and imgs[0]["name"] == "mine:v1"
        finally:
            await client.close()


class TestValidationRoutes:
    """Reject-before-store + the :validate live-probe routes (reference
    routes/destinations.rs:468-516, validation/ framework)."""

    async def test_create_rejects_invalid_source_config(self, tmp_path):
        client, _ = await make_client(tmp_path)
        await client.post("/v1/tenants", json={"id": "acme", "name": "A"})
        resp = await client.post("/v1/sources", headers=H, json={
            "name": "bad", "config": {"port": 99999}})
        assert resp.status == 400
        doc = await resp.json()
        names = {f["name"] for f in doc["validation_failures"]}
        # invalid-config snapshot: every static failure reported at once
        assert {"Missing host", "Missing name", "Missing username",
                "Invalid port"} <= names
        assert all(f["failure_type"] == "critical"
                   for f in doc["validation_failures"])
        await client.close()

    async def test_create_rejects_unknown_destination_type(self, tmp_path):
        client, _ = await make_client(tmp_path)
        await client.post("/v1/tenants", json={"id": "acme", "name": "A"})
        resp = await client.post("/v1/destinations", headers=H, json={
            "name": "bad", "config": {"type": "warehouse9000"}})
        assert resp.status == 400
        doc = await resp.json()
        assert doc["validation_failures"][0]["name"] == \
            "Unknown destination type"
        # nothing was stored
        listing = await (await client.get("/v1/destinations",
                                          headers=H)).json()
        assert listing == []
        await client.close()

    async def test_update_rejects_invalid_config(self, tmp_path):
        client, _ = await make_client(tmp_path)
        await setup_pipeline(client)
        resp = await client.put("/v1/destinations/1", headers=H, json={
            "config": {"type": "bigquery"}})  # missing project/dataset
        assert resp.status == 400
        stored = await (await client.get("/v1/destinations/1",
                                         headers=H)).json()
        assert stored["config"]["type"] == "lake"  # unchanged
        await client.close()

    async def test_validate_source_live_probes(self, tmp_path):
        from etl_tpu_torch.testing.fake_pg_server import FakePgServer
        from tests.test_pipeline_e2e import make_db

        server = FakePgServer(make_db())
        await server.start()
        client, _ = await make_client(tmp_path)
        await client.post("/v1/tenants", json={"id": "acme", "name": "A"})
        try:
            good = {"host": "127.0.0.1", "port": server.port,
                    "name": "postgres", "username": "etl"}
            doc = await (await client.post(
                "/v1/sources:validate", headers=H,
                json={"config": good})).json()
            assert doc["validation_failures"] == []
            # existing publication passes; missing one is critical
            doc = await (await client.post(
                "/v1/sources:validate", headers=H,
                json={"config": good,
                      "pipeline_config": {"publication_name": "pub"}})).json()
            assert doc["validation_failures"] == []
            doc = await (await client.post(
                "/v1/sources:validate", headers=H,
                json={"config": good,
                      "pipeline_config": {"publication_name": "nope"}})).json()
            assert [f["name"] for f in doc["validation_failures"]] == \
                ["Publication missing"]
            # unreachable endpoint is a critical failure, not a 500
            bad = dict(good, port=1)
            doc = await (await client.post(
                "/v1/sources:validate", headers=H,
                json={"config": bad})).json()
            assert doc["validation_failures"][0]["name"] == \
                "Source connection failed"
        finally:
            await client.close()
            await server.stop()

    async def test_validate_destination_live_probes(self, tmp_path):
        from etl_tpu_torch.testing.fake_http import RecordingHttpServer

        server = RecordingHttpServer()
        await server.start()
        client, _ = await make_client(tmp_path)
        await client.post("/v1/tenants", json={"id": "acme", "name": "A"})
        try:
            doc = await (await client.post(
                "/v1/destinations:validate", headers=H,
                json={"config": {"type": "clickhouse",
                                 "url": server.url(),
                                 "database": "etl"}})).json()
            assert doc["validation_failures"] == []
            # auth rejection surfaces as a critical failure
            server.responders.append(
                lambda rec: (401, {"error": "bad token"})
                if "/datasets/" in rec.path else None)
            doc = await (await client.post(
                "/v1/destinations:validate", headers=H,
                json={"config": {"type": "bigquery", "project_id": "p",
                                 "dataset_id": "d",
                                 "base_url": server.url(),
                                 "auth_token": "bad"}})).json()
            assert doc["validation_failures"][0]["name"] == \
                "BigQuery authentication failed"
            # source_id and pipeline_config must travel together
            resp = await client.post(
                "/v1/destinations:validate", headers=H,
                json={"config": {"type": "lake", "warehouse_path": "/tmp"},
                      "source_id": 1})
            assert resp.status == 400
        finally:
            await client.close()
            await server.stop()


def k8s_existence_responder():
    """Emulates resource existence: POST of an already-created name →
    409; DELETE forgets it (so the orchestrator's replace path works the
    way the real API does)."""
    existing: set[str] = set()

    def responder(rec):
        if rec.method == "POST":
            name = (rec.json or {}).get("metadata", {}).get("name", "")
            key = f"{rec.path}/{name}"
            if key in existing:
                return 409, {}
            existing.add(key)
            return None
        if rec.method == "DELETE":
            existing.discard(rec.path)
        return None

    return responder


class TestOrchestratorRollout:
    async def test_statefulset_update_rolls_template(self):
        """An image change on an EXISTING pipeline must PATCH the
        StatefulSet with a fresh restarted-at template annotation — the
        rolling-restart trigger (reference k8s/http.rs:1676,1708)."""
        server = RecordingHttpServer()
        await server.start()
        try:
            server.responders.append(k8s_existence_responder())
            orch = K8sOrchestrator(api_url=server.url(), namespace="etl")
            spec = ReplicatorSpec(3, "t", {"publication_name": "pub"},
                                  image="img:v1")
            await orch.start_pipeline(spec)
            first = [r for r in server.requests
                     if r.path.endswith("/statefulsets")][0].json
            anno1 = first["spec"]["template"]["metadata"]["annotations"][
                "etl/restarted-at"]
            # every resource now exists → conflict on each create
            await orch.start_pipeline(ReplicatorSpec(
                3, "t", {"publication_name": "pub"}, image="img:v2"))
            patches = [r for r in server.requests if r.method == "PATCH"]
            sts = [r for r in patches
                   if "statefulsets/etl-replicator-3" in r.path][0].json
            tpl = sts["spec"]["template"]
            assert tpl["spec"]["containers"][0]["image"] == "img:v2"
            assert tpl["metadata"]["annotations"]["etl/restarted-at"] \
                != anno1
            await orch.shutdown()
        finally:
            await server.stop()

    async def test_restart_rolls_without_teardown(self):
        """K8sOrchestrator.restart_pipeline must NOT delete+recreate (the
        base-class default): it re-applies with a fresh restarted-at
        annotation so the controller rolls the pods in place."""
        server = RecordingHttpServer()
        await server.start()
        try:
            server.responders.append(k8s_existence_responder())
            orch = K8sOrchestrator(api_url=server.url(), namespace="etl")
            spec = ReplicatorSpec(9, "t", {"publication_name": "pub"})
            await orch.start_pipeline(spec)
            first = [r for r in server.requests
                     if r.path.endswith("/statefulsets")][0].json
            anno1 = first["spec"]["template"]["metadata"]["annotations"][
                "etl/restarted-at"]
            await orch.restart_pipeline(spec)
            # the WORKLOAD is never torn down (secrets/configmaps are
            # replaced, which is invisible to running pods until restart)
            assert not any(r.method == "DELETE" and "statefulsets" in r.path
                           for r in server.requests)
            patches = [r for r in server.requests if r.method == "PATCH"]
            sts = [r for r in patches
                   if "statefulsets/etl-replicator-9" in r.path][0]
            assert sts.headers["Content-Type"] == \
                "application/strategic-merge-patch+json"
            anno2 = sts.json["spec"]["template"]["metadata"][
                "annotations"]["etl/restarted-at"]
            assert anno2 != anno1  # pods roll even with unchanged config
            await orch.shutdown()
        finally:
            await server.stop()

    async def test_local_orchestrator_restarts_on_config_change(
            self, tmp_path, monkeypatch):
        """Same spec → keep the process; changed config/image → restart
        with the new config on disk (single-host template roll)."""
        import asyncio as aio
        import sys

        from etl_tpu_torch.api.orchestrator import LocalOrchestrator

        spawned = []
        real_exec = aio.create_subprocess_exec

        async def fake_exec(*args, **kwargs):
            # record then run an inert long-lived process
            spawned.append(args)
            return await real_exec(sys.executable, "-c",
                                   "import time; time.sleep(60)",
                                   **{k: v for k, v in kwargs.items()
                                      if k in ("stdout", "stderr")})

        monkeypatch.setattr(aio, "create_subprocess_exec", fake_exec)
        orch = LocalOrchestrator(str(tmp_path))
        spec_a = ReplicatorSpec(5, "t", {"publication_name": "a"})
        await orch.start_pipeline(spec_a)
        pid1 = orch._procs[5].pid
        await orch.start_pipeline(spec_a)  # unchanged → same process
        assert orch._procs[5].pid == pid1 and len(spawned) == 1
        spec_b = ReplicatorSpec(5, "t", {"publication_name": "b"})
        await orch.start_pipeline(spec_b)  # changed → restart
        assert orch._procs[5].pid != pid1 and len(spawned) == 2
        import yaml
        conf = yaml.safe_load(
            (tmp_path / "pipeline-5" / "base.yaml").read_text())
        assert conf["publication_name"] == "b"
        assert (await orch.status(5)).state == "running"
        await orch.shutdown()
        assert (await orch.status(5)).state == "stopped"


class TestDocsPage:
    async def test_docs_served_self_contained(self, tmp_path):
        client, _ = await make_client(tmp_path)
        try:
            resp = await client.get("/docs")
            assert resp.status == 200
            assert "text/html" in resp.headers["Content-Type"]
            body = await resp.text()
            # renders the spec client-side with ZERO external assets
            assert "/openapi.json" in body
            assert "http://" not in body and "https://" not in body
        finally:
            await client.close()
