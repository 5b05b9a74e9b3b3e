"""The port's control plane held to the reference's, request for
request: the route snapshots of `tests/test_api_snapshots.py` sent to the
reference's app and to the port's (each with its own stub orchestrator,
on both storage backends) with the statuses and bodies compared and the
rows each `ApiDb` wrote compared; the OpenAPI document; the K8s manifests
byte for byte apart from the package a container runs; the reference's
`TestShardedOrchestration` (`tests/test_sharding.py`) on the port; the
aggregated view of `/v1/fleet` against the reference's; and `LocalOrchestrator` starting, scaling
(K = 1 → 2 behind a shard rebalance) and stopping the port's replicator
children on the CPU (`benchmarks.control_plane`).

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_api*.py -q

Tolerance: exact. The manifests' restarted-at annotation reads the wall
clock; both packages read one injected clock here.
"""

import json
from pathlib import Path

import pytest
from aiohttp.test_utils import TestClient, TestServer

SNAP_DIR = Path(__file__).parent / "snapshots"
H = {"tenant_id": "acme"}


def _stub(pkg):
    """The stub orchestrator of tests/test_api.py over `pkg`'s base."""
    orch = __import__(f"{pkg}.api.orchestrator", fromlist=["x"])

    class Stub(orch.Orchestrator):
        def __init__(self):
            self.calls = []
            self.running = set()

        async def start_pipeline(self, spec):
            self.calls.append(("start", spec.pipeline_id, spec.config,
                               spec.image))
            self.running.add(spec.pipeline_id)

        async def stop_pipeline(self, pipeline_id):
            self.calls.append(("stop", pipeline_id))
            self.running.discard(pipeline_id)

        async def status(self, pipeline_id):
            state = "running" if pipeline_id in self.running \
                else "stopped"
            return orch.ReplicatorStatus(pipeline_id, state)

    return Stub()


async def _client(pkg: str, backend: str, tmp_path, tag: str):
    app_mod = __import__(f"{pkg}.api.app", fromlist=["x"])
    crypto = __import__(f"{pkg}.api.crypto", fromlist=["x"])
    cleanup = None
    if backend == "postgres":
        db_mod = __import__(f"{pkg}.api.db", fromlist=["x"])
        config = __import__(f"{pkg}.config", fromlist=["x"])
        fake = __import__(f"{pkg}.postgres.fake", fromlist=["x"])
        srv = __import__(f"{pkg}.testing.fake_pg_server", fromlist=["x"])
        server = srv.FakePgServer(fake.FakeDatabase())
        await server.start()
        db = db_mod.PostgresApiDb(config.PgConnectionConfig(
            host="127.0.0.1", port=server.port, name="postgres",
            username="etl"))
        cleanup = server.stop
    else:
        db = str(tmp_path / f"api-{tag}.db")
    stub = _stub(pkg)
    state = app_mod.ApiState(db, crypto.ConfigCipher(
        crypto.EncryptionKey.generate()), stub)
    app = app_mod.build_app(state)
    if cleanup is not None:
        async def _stop(_app):
            await cleanup()

        app.on_cleanup.append(_stop)
    client = TestClient(TestServer(app))
    await client.start_server()
    return client, state, stub


#: the request sequence of tests/test_api_snapshots.py, by snapshot name
SURFACE = [
    ("tenant_create", "post", "/v1/tenants",
     {"json": {"id": "acme", "name": "Acme"}}),
    ("tenant_conflict", "post", "/v1/tenants",
     {"json": {"id": "acme", "name": "Acme"}}),
    ("tenant_missing_header", "get", "/v1/sources", {}),
    ("source_create", "post", "/v1/sources", {"headers": H, "json": {
        "name": "prod", "config": {"host": "db", "port": 5432,
                                   "name": "app", "username": "etl",
                                   "password": "pw-1234567"}}}),
    ("source_invalid_config", "post", "/v1/sources", {"headers": H,
     "json": {"name": "bad", "config": {"port": "nope"}}}),
    ("source_get_masks_secrets", "get", "/v1/sources/1", {"headers": H}),
    ("source_404", "get", "/v1/sources/99", {"headers": H}),
    ("destination_create", "post", "/v1/destinations", {"headers": H,
     "json": {"name": "lake", "config": {"type": "lake",
                                         "warehouse_path": "/tmp/wh"}}}),
    ("pipeline_create", "post", "/v1/pipelines", {"headers": H, "json": {
        "source_id": 1, "destination_id": 1, "publication_name": "pub"}}),
    ("pipeline_get", "get", "/v1/pipelines/1", {"headers": H}),
    ("pipeline_list", "get", "/v1/pipelines", {"headers": H}),
    ("pipeline_missing_source", "post", "/v1/pipelines", {"headers": H,
     "json": {"source_id": 77, "destination_id": 1,
              "publication_name": "pub"}}),
    ("image_create", "post", "/v1/images", {"headers": H, "json": {
        "name": "repl:v1", "default": True}}),
    ("image_list", "get", "/v1/images", {"headers": H}),
    ("pipeline_start", "post", "/v1/pipelines/1/start", {"headers": H}),
    ("pipeline_status", "get", "/v1/pipelines/1/status", {"headers": H}),
    ("pipeline_version_pin", "post", "/v1/pipelines/1/version",
     {"headers": H, "json": {"image_id": 1}}),
    ("image_delete_pinned", "delete", "/v1/images/1", {"headers": H}),
    ("pipeline_version_unpin", "post", "/v1/pipelines/1/version",
     {"headers": H, "json": {}}),
    ("pipeline_stop", "post", "/v1/pipelines/1/stop", {"headers": H}),
    ("replication_status_no_store", "get",
     "/v1/pipelines/1/replication-status", {"headers": H}),
    ("source_delete_in_use", "delete", "/v1/sources/1", {"headers": H}),
    ("pipeline_delete", "delete", "/v1/pipelines/1", {"headers": H}),
    # beyond the pinned snapshots: the rest of the surface
    ("tenant_list", "get", "/v1/tenants", {}),
    ("source_update", "put", "/v1/sources/1", {"headers": H, "json": {
        "name": "prod-2", "config": {"host": "db2", "port": 5433,
                                     "name": "app", "username": "etl",
                                     "password": "********"}}}),
    ("source_list", "get", "/v1/sources", {"headers": H}),
    ("destination_get", "get", "/v1/destinations/1", {"headers": H}),
    ("destination_bad_type", "post", "/v1/destinations", {"headers": H,
     "json": {"name": "x", "config": {"type": "nope"}}}),
    ("destination_validate_shape", "post", "/v1/destinations:validate",
     {"headers": H, "json": {"config": {"type": "clickhouse"}}}),
    ("pipeline_recreate", "post", "/v1/pipelines", {"headers": H, "json": {
        "source_id": 1, "destination_id": 1, "publication_name": "pub2",
        "config": {"batch": {"max_fill_ms": 50}}}}),
    ("pipeline_restart", "post", "/v1/pipelines/2/restart",
     {"headers": H}),
    ("pipeline_rival_404", "get", "/v1/pipelines/2",
     {"headers": {"tenant_id": "rival"}}),
    ("health", "get", "/health", {}),
]


async def _drive(client) -> list:
    out = []
    for name, method, path, kw in SURFACE:
        resp = await getattr(client, method)(path, **kw)
        text = await resp.text()
        body = json.loads(text) \
            if text and resp.content_type == "application/json" else text
        out.append((name, {"status": resp.status, "body": body}))
    return out


async def _rows(state) -> dict:
    """Every API table's rows, each encrypted config decrypted."""
    out = {}
    for table, enc_col in (("api_tenants", None), ("api_sources", 3),
                           ("api_destinations", 3), ("api_images", None),
                           ("api_pipelines", None)):
        rows = await state.db.run(f"SELECT * FROM {table} ORDER BY id")
        out[table] = [tuple(state.cipher.decrypt(v) if i == enc_col
                            else str(v) for i, v in enumerate(r))
                      for r in rows]
    return out


@pytest.mark.parametrize("backend", ["sqlite", "postgres"])
class TestRouteParity:
    async def test_surface_equals_reference_and_snapshots(self, tmp_path,
                                                          backend):
        results, rows, calls = {}, {}, {}
        for pkg in ("etl_tpu", "etl_tpu_torch"):
            client, state, stub = await _client(pkg, backend, tmp_path, pkg)
            try:
                results[pkg] = await _drive(client)
                rows[pkg] = await _rows(state)
                calls[pkg] = stub.calls
            finally:
                await client.close()
        ref, port = results["etl_tpu"], results["etl_tpu_torch"]
        assert [n for n, _ in port] == [n for n, _ in ref]
        for (name, got), (_, want) in zip(port, ref):
            assert got == want, name
            snap = SNAP_DIR / f"{name}.json"
            if snap.exists():
                assert got == json.loads(snap.read_text()), name
        # the same rows written, and the same specs handed to the
        # orchestrator (the replicator config documents included)
        assert rows["etl_tpu_torch"] == rows["etl_tpu"]
        assert calls["etl_tpu_torch"] == calls["etl_tpu"]

    async def test_openapi_document_equals_reference(self, tmp_path,
                                                     backend):
        docs = {}
        for pkg in ("etl_tpu", "etl_tpu_torch"):
            client, _, _ = await _client(pkg, backend, tmp_path, pkg)
            try:
                resp = await client.get("/openapi.json")
                docs[pkg] = (resp.status, await resp.json())
            finally:
                await client.close()
        assert docs["etl_tpu_torch"] == docs["etl_tpu"]
        pinned = json.loads((SNAP_DIR / "openapi.json").read_text())
        assert {"status": docs["etl_tpu_torch"][0],
                "body": docs["etl_tpu_torch"][1]} == pinned

    async def test_fleet_route_refused_typed(self, tmp_path, backend):
        """`/v1/fleet`, a typed 501 until the fleet reconciler was
        ported, answers the reference's aggregated view: the same status
        and body from both apps over the same fleet spec (a quota that
        clamps) and the same observed fleet (a stray, a missing
        pipeline)."""
        docs = {}
        for pkg in ("etl_tpu", "etl_tpu_torch"):
            client, state, stub = await _client(pkg, backend, tmp_path, pkg)
            spec_mod = __import__(f"{pkg}.fleet.spec", fromlist=["x"])
            memory = __import__(f"{pkg}.store.memory", fromlist=["x"])
            store = memory.MemoryStore()
            spec = spec_mod.FleetSpec(
                spec_version=3,
                pipelines=(spec_mod.PipelineSpec(
                    pipeline_id=1, tenant_id="acme", shard_count=2),
                           spec_mod.PipelineSpec(
                    pipeline_id=2, tenant_id="globex", shard_count=3,
                    profile="tiny_txs")),
                quotas={"globex": spec_mod.TenantQuota(max_shards=2,
                                                       slo_weight=0.5)})
            await store.update_fleet_spec(spec.to_json())
            state.fleet_store = store
            stub.running = {1, 7}

            async def listing():
                return {1: 2, 7: 1}

            stub.list_pipelines = listing
            try:
                resp = await client.get("/v1/fleet")
                docs[pkg] = (resp.status, await resp.json())
            finally:
                await client.close()
        assert docs["etl_tpu_torch"] == docs["etl_tpu"]
        status, doc = docs["etl_tpu_torch"]
        assert status == 200 and doc["converged"] is False
        assert [p["desired_shards"] for p in doc["pipelines"]] == [2, 2, 0]


#: the specs whose K8s requests are compared: plain, with secrets and an
#: image, sharded (fan-out), lake with maintenance (the CronJob and the
#: warehouse PVC), coordinated maintenance behind a control-plane URL
MANIFEST_SPECS = [
    (1, "acme", {"pipeline_id": 1, "publication_name": "pub",
                 "pg_connection": {"host": "db", "port": 5432,
                                   "name": "app", "username": "etl",
                                   "password": "pw"},
                 "destination": {"type": "clickhouse",
                                 "url": "http://ch:8123",
                                 "database": "etl", "password": "k"}},
     "repl:v2"),
    (2, "acme", {"pipeline_id": 2, "publication_name": "pub",
                 "shard_count": 3}, None),
    (3, "t", {"destination": {"type": "lake", "warehouse_path": "/wh"},
              "maintenance": {"schedule": "0 2 * * *"}}, None),
    (4, "t", {"destination": {"type": "lake", "warehouse_path": "/wh"},
              "maintenance": {"coordination": True}}, None),
]


class TestManifestParity:
    async def test_k8s_requests_byte_for_byte(self, monkeypatch):
        import time

        monkeypatch.setattr(time, "time", lambda: 1_790_000_000.25)
        recorded = {}
        for pkg in ("etl_tpu", "etl_tpu_torch"):
            orch_mod = __import__(f"{pkg}.api.orchestrator", fromlist=["x"])
            http = __import__(f"{pkg}.testing.fake_http", fromlist=["x"])
            server = http.RecordingHttpServer()
            await server.start()
            try:
                orch = orch_mod.K8sOrchestrator(
                    api_url=server.url(), namespace="etl",
                    control_api_url="http://api:8080",
                    control_api_key_secret="api-key")
                for pid, tenant, config, image in MANIFEST_SPECS:
                    spec = orch_mod.ReplicatorSpec(pid, tenant, config,
                                                   image=image)
                    await orch.start_pipeline(spec)
                    await orch.restart_pipeline(spec)
                    await orch.scale_pipeline(spec, 2)
                    await orch.status(pid)
                    await orch.stop_pipeline(pid)
                await orch.delete_pipeline(3)
                await orch.shutdown()
                recorded[pkg] = [(r.method, r.path, r.body)
                                 for r in server.requests]
            finally:
                await server.stop()
        ref, port = recorded["etl_tpu"], recorded["etl_tpu_torch"]
        assert len(port) == len(ref) > 40
        maint = [i for i, (_, _, body) in enumerate(ref)
                 if b"etl_tpu.maintenance" in body]
        assert maint  # the maintenance CronJob is among them
        for i, ((m1, p1, b1), (m2, p2, b2)) in enumerate(zip(port, ref)):
            assert (m1, p1) == (m2, p2), i
            assert b1 == b2.replace(b"etl_tpu.maintenance",
                                    b"etl_tpu_torch.maintenance"), i


class TestShardedOrchestration:
    async def test_k8s_fan_out_creates_one_replica_set_per_shard(self):
        from etl_tpu_torch.api.orchestrator import (K8sOrchestrator,
                                              ReplicatorSpec)
        from etl_tpu_torch.testing.fake_http import RecordingHttpServer

        server = RecordingHttpServer()
        await server.start()
        try:
            orch = K8sOrchestrator(api_url=server.url(), namespace="etl")
            spec = ReplicatorSpec(
                pipeline_id=7, tenant_id="acme",
                config={"pipeline_id": 7, "publication_name": "pub",
                        "shard_count": 2})
            await orch.start_pipeline(spec)
            sts = [r.json for r in server.requests
                   if r.path.endswith("/statefulsets")
                   and r.method == "POST"]
            names = [s["metadata"]["name"] for s in sts]
            assert names == ["etl-replicator-7-s0", "etl-replicator-7-s1"]
            for i, s in enumerate(sts):
                assert s["metadata"]["labels"]["shard"] == str(i)
            # each pod's ConfigMap carries its OWN shard identity
            cms = [r.json for r in server.requests
                   if r.path.endswith("/configmaps")]
            for i, cm in enumerate(cms):
                assert f"shard: {i}" in cm["data"]["base.yaml"]
                assert "shard_count: 2" in cm["data"]["base.yaml"]
            await orch.shutdown()
        finally:
            await server.stop()

    async def test_k8s_stop_sweeps_discovered_shards(self):
        from etl_tpu_torch.api.orchestrator import K8sOrchestrator
        from etl_tpu_torch.testing.fake_http import RecordingHttpServer

        server = RecordingHttpServer()
        await server.start()
        try:
            # the fake returns {} by default; script real-looking
            # statefulset docs for shards 0 and 1 so discovery finds
            # exactly two replica sets
            def responder(req):
                if req.method == "GET" and "statefulsets" in req.path:
                    for s in (0, 1):
                        if req.path.endswith(f"etl-replicator-3-s{s}"):
                            return 200, {"metadata": {
                                "name": f"etl-replicator-3-s{s}"}}
                    return 404, {}
                return None

            server.responders.append(responder)
            orch = K8sOrchestrator(api_url=server.url(), namespace="etl")
            await orch.stop_pipeline(3)
            deletes = [p for p in server.paths() if p.startswith("DELETE")]
            for name in ("etl-replicator-3", "etl-replicator-3-s0",
                         "etl-replicator-3-s1"):
                assert f"DELETE /apis/apps/v1/namespaces/etl/" \
                       f"statefulsets/{name}" in deletes
            assert not any("-s2" in p for p in deletes)
            await orch.shutdown()
        finally:
            await server.stop()

    async def test_k8s_status_aggregates_worst_shard(self):
        from etl_tpu_torch.api.orchestrator import K8sOrchestrator
        from etl_tpu_torch.testing.fake_http import RecordingHttpServer

        server = RecordingHttpServer()
        await server.start()
        try:
            def responder(req):
                if req.method != "GET":
                    return None
                if "statefulsets" in req.path:
                    if req.path.endswith("-s0"):
                        return 200, {"metadata": {},
                                     "status": {"readyReplicas": 1}}
                    if req.path.endswith("-s1"):
                        return 200, {"metadata": {},
                                     "status": {"readyReplicas": 0}}
                    return 404, {}
                if "/pods" in req.path:
                    return 200, {"items": []}
                return None

            server.responders.append(responder)
            orch = K8sOrchestrator(api_url=server.url(), namespace="etl")
            st = await orch.status(4)
            # one ready shard + one still coming up → starting, not
            # running: a hidden dead shard must never read as healthy
            assert st.state == "starting"
            assert "s0=running" in st.detail and "s1=" in st.detail
            await orch.shutdown()
        finally:
            await server.stop()

    async def test_local_orchestrator_shards_and_reshards(
            self, tmp_path, monkeypatch):
        import asyncio as aio
        import sys

        import yaml

        from etl_tpu_torch.api.orchestrator import (LocalOrchestrator,
                                              ReplicatorSpec)

        spawned = []
        real_exec = aio.create_subprocess_exec

        async def fake_exec(*args, **kwargs):
            spawned.append(args)
            return await real_exec(sys.executable, "-c",
                                   "import time; time.sleep(60)",
                                   **{k: v for k, v in kwargs.items()
                                      if k in ("stdout", "stderr")})

        monkeypatch.setattr(aio, "create_subprocess_exec", fake_exec)
        orch = LocalOrchestrator(str(tmp_path))
        spec = ReplicatorSpec(5, "t", {"publication_name": "p",
                                       "shard_count": 2})
        await orch.start_pipeline(spec)
        assert set(orch._procs) == {(5, 0), (5, 1)}
        assert (await orch.status(5)).state == "running"
        for shard in range(2):
            conf = yaml.safe_load(
                (tmp_path / f"pipeline-5-s{shard}" / "base.yaml")
                .read_text())
            assert conf["shard"] == shard and conf["shard_count"] == 2
        # reshard 2→3: the old fleet keys are reused/extended
        spec3 = ReplicatorSpec(5, "t", {"publication_name": "p",
                                        "shard_count": 3})
        await orch.start_pipeline(spec3)
        assert set(orch._procs) == {(5, 0), (5, 1), (5, 2)}
        await orch.stop_pipeline(5)
        assert not orch._procs
        assert (await orch.status(5)).state == "stopped"
        await orch.shutdown()


class TestLocalOrchestratorChildren:
    async def test_start_scale_stop_on_the_cpu(self):
        """The API's routes start one CPU replicator child, a shard
        rebalance and `scale_pipeline` roll it to two, each child shows
        its own device-route work on its own /metrics, every row and
        sequence key arrives once, and the stop leaves no child."""
        from etl_tpu_torch.benchmarks.control_plane import run_control_plane

        r = await run_control_plane(copy_rows=2_000, events=4_000,
                                    tables=4, device="cpu")
        assert r["ok"], r["checks"]
        assert r["routes"]["POST /v1/pipelines/1/start"] == 202
        assert r["status_k1"]["state"] == "running"
        assert r["status_k2"]["state"] == "running"
        assert len(r["children"]) == 3 and r["children_left"] == []

    async def test_local_shards_get_their_own_metrics_port(
            self, tmp_path, monkeypatch):
        import asyncio as aio
        import sys

        import yaml

        from etl_tpu_torch.api.orchestrator import (LocalOrchestrator,
                                                    ReplicatorSpec)

        real_exec = aio.create_subprocess_exec

        async def fake_exec(*args, **kwargs):
            return await real_exec(sys.executable, "-c",
                                   "import time; time.sleep(60)",
                                   **{k: v for k, v in kwargs.items()
                                      if k in ("stdout", "stderr")})

        monkeypatch.setattr(aio, "create_subprocess_exec", fake_exec)
        orch = LocalOrchestrator(str(tmp_path))
        await orch.start_pipeline(ReplicatorSpec(
            6, "t", {"publication_name": "p", "metrics_port": 9100}))
        await orch.scale_pipeline(orch._specs[6], 3)
        assert set(orch._procs) == {(6, 0), (6, 1), (6, 2)}
        for shard in range(3):
            conf = yaml.safe_load(
                (tmp_path / f"pipeline-6-s{shard}" / "base.yaml")
                .read_text())
            assert conf["metrics_port"] == 9100 + shard
            assert conf["shard"] == shard and conf["shard_count"] == 3
        await orch.shutdown()
        assert not orch._procs
