"""The port's replicator binary and what it stands on, held to the
reference's: the config loader (`etl_tpu_torch.config.load`) against
`etl_tpu.config.load` on the same documents and `APP_` overrides, with
secrets redacted (the reference's TestConfigLoad and
TestReplicatorStoreConfig), in YAML's block style and in its JSON subset
(what `bench.write_replicator_config` writes), and its typed refusals; the destination registry; `/health`,
`/health/detail` and `/metrics` against the reference's app in every
health state (TestReplicatorHealthEndpoint); `python -m
etl_tpu_torch.replicator` as a process on the CPU against the port's fake
server: `/health` 200, the slot confirmed to the last commit, a clean
exit on SIGTERM; the DLQ CLI's `--postgres` and `replay
--destination-json` against the reference CLI's JSON output; and the
slot-lag query (TestSlotLag). Tolerance: none — equal documents, status
codes and JSON bodies.
"""

import asyncio
import dataclasses
import enum
import json
import logging
import os
import signal
import sys

import pytest

from etl_tpu_torch.bench import free_port, http_get
from etl_tpu_torch.chaos import failpoints
from etl_tpu_torch.ops import engine
from etl_tpu_torch.ops.pipeline import reset_global_admission

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _port_hygiene():
    yield
    engine.clear_forced_oracle()
    failpoints.disarm_all()
    reset_global_admission()


@pytest.fixture
def root_logging():
    """`run_replicator` installs the process's log handlers (init_tracing),
    as the binary's main does: put the test process's back afterwards."""
    root = logging.getLogger()
    handlers, level = list(root.handlers), root.level
    yield
    root.handlers = handlers
    root.setLevel(level)


def plain(obj):
    """A config as plain data: enums by value, secrets exposed."""
    if dataclasses.is_dataclass(obj):
        return {f.name: plain(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, enum.Enum):
        return obj.value
    if hasattr(obj, "expose"):
        return ("secret", obj.expose())
    if isinstance(obj, (list, tuple)):
        return [plain(v) for v in obj]
    return obj


def as_reference(port_doc: dict) -> dict:
    """The port's config, spelled as the reference's: `cuda` is its
    `tpu`, and `batch.device` is the port's own field."""
    doc = json.loads(json.dumps(port_doc))
    # the reference's loader leaves `poison` a mapping, which its own
    # validate() cannot take: the port builds it (checked apart)
    doc.pop("poison", None)
    batch = doc.get("batch", {})
    batch.pop("device", None)
    if batch.get("batch_engine") == "cuda":
        batch["batch_engine"] = "tpu"
    return doc


BASE = {"pipeline_id": 1, "publication_name": "pub",
        "pg_connection": {"host": "db.internal", "port": 6432,
                          "name": "app", "username": "etl",
                          "tls": {"enabled": True}},
        "batch": {"max_size_bytes": 1048576, "max_fill_ms": 200,
                  "batch_engine": "cuda"},
        "apply_retry": {"max_attempts": 7, "initial_delay_ms": 50},
        "supervision": {"stall_deadline_s": 30.0},
        "poison": {"budget_rows": 1000},
        "invalidated_slot_behavior": "recreate_and_resync"}
ENVIRON = {"APP_PG_CONNECTION__PASSWORD": "hunter2",
           "APP_BATCH__MAX_FILL_MS": "123",
           "APP_PIPELINE_ID": "9",
           "APP_ENVIRONMENT": "prod",
           "UNRELATED": "x"}


def write_docs(d, base: dict, prod: dict | None = None,
               spelling: str = "json-subset") -> None:
    """`base.yaml` (and `prod.yaml`) in YAML's JSON subset, or in its
    block style."""
    import yaml

    dump = (lambda doc: json.dumps(doc, indent=2)) \
        if spelling == "json-subset" else yaml.safe_dump
    d.mkdir(parents=True, exist_ok=True)
    (d / "base.yaml").write_text(dump(base))
    if prod is not None:
        (d / "prod.yaml").write_text(dump(prod))


class TestConfigLoad:
    def test_env_overlay_equals_reference(self):
        from etl_tpu.config.load import env_overlay as ref_overlay
        from etl_tpu_torch.config.load import env_overlay

        assert env_overlay(ENVIRON) == ref_overlay(ENVIRON) == {
            "pg_connection": {"password": "hunter2"},
            "batch": {"max_fill_ms": 123}, "pipeline_id": 9}

    @pytest.mark.parametrize("spelling", ["pyyaml", "json-subset"])
    def test_documents_and_overrides_equal_reference(self, tmp_path,
                                                     spelling):
        from etl_tpu.config.load import Environment as RefEnv
        from etl_tpu.config.load import load_pipeline_config as ref_load
        from etl_tpu_torch.config.load import (Environment,
                                               load_pipeline_config)

        write_docs(tmp_path / "port", BASE, {"publication_name": "pub_prod"},
                   spelling)
        write_docs(tmp_path / "ref", as_reference(BASE),
                   {"publication_name": "pub_prod"}, spelling)
        want = ref_load(tmp_path / "ref", RefEnv.PROD, environ=ENVIRON)
        got = load_pipeline_config(tmp_path / "port", Environment.PROD,
                                   environ=ENVIRON)
        want_doc = json.loads(json.dumps(plain(want)))
        want_doc.pop("poison")
        assert as_reference(plain(got)) == want_doc
        assert got.pipeline_id == 9 and got.batch.max_fill_ms == 123
        assert got.publication_name == "pub_prod"
        assert got.batch.device == "cuda"  # the default: the card
        assert got.poison.budget_rows == 1000
        # secrets redacted where they print
        assert "hunter2" not in repr(got.pg_connection.password)
        assert "hunter2" not in repr(got)
        assert got.pg_connection.password.expose() == "hunter2"

    def test_malformed_and_empty_documents_as_reference(self, tmp_path):
        """A document PyYAML cannot read is a typed CONFIG_INVALID naming
        the file, and an empty one an empty mapping (then the config's own
        validation), in both packages."""
        from etl_tpu.config.load import Environment as RefEnv
        from etl_tpu.config.load import load_pipeline_config as ref_load
        from etl_tpu.models.errors import EtlError as RefError
        from etl_tpu_torch.config.load import (Environment,
                                               load_pipeline_config)
        from etl_tpu_torch.models.errors import ErrorKind, EtlError

        doc = tmp_path.joinpath("base.yaml")
        doc.write_text("pipeline_id: [1\n")
        with pytest.raises(RefError) as want:
            ref_load(tmp_path, RefEnv.DEV, environ={})
        with pytest.raises(EtlError) as got:
            load_pipeline_config(tmp_path, Environment.DEV, environ={})
        assert got.value.kind is ErrorKind.CONFIG_INVALID
        assert got.value.kind.name == want.value.kind.name
        assert str(got.value) == str(want.value) and str(doc) in str(got.value)
        doc.write_text("  \n")
        with pytest.raises(RefError, match="publication_name"):
            ref_load(tmp_path, RefEnv.DEV, environ={})
        with pytest.raises(EtlError, match="publication_name"):
            load_pipeline_config(tmp_path, Environment.DEV, environ={})

    @pytest.mark.parametrize("doc,needle", [
        ({"pipeline_id": 1, "publication_name": "p", "nope": 1}, "nope"),
        ({"pipeline_id": 1, "publication_name": "p",
          "pg_connection": {"port": 99999}}, "port"),
        ({"pipeline_id": 1, "publication_name": "p",
          "batch": {"batch_engine": "tpu"}}, "'cuda'"),
    ], ids=["unknown-key", "validation", "tpu-names-cuda"])
    def test_refused_typed(self, doc, needle):
        from etl_tpu_torch.config.load import pipeline_config_from_dict
        from etl_tpu_torch.models.errors import ErrorKind, EtlError

        with pytest.raises(EtlError) as ei:
            pipeline_config_from_dict(doc)
        assert ei.value.kind is ErrorKind.CONFIG_INVALID
        assert needle in str(ei.value)

    def test_secret_redaction_equals_reference(self):
        from etl_tpu.config.load import Secret as RefSecret
        from etl_tpu_torch.config.load import Secret

        assert repr(Secret("pw123")) == repr(RefSecret("pw123"))
        assert "pw123" not in repr(Secret("pw123"))
        assert Secret("pw123").expose() == "pw123"


class TestReplicatorStoreConfig:
    def test_postgres_store_connection_overrides_merge(self):
        from etl_tpu.config.load import Secret as RefSecret
        from etl_tpu.config.pipeline import \
            PgConnectionConfig as RefConnection
        from etl_tpu.replicator import store_connection_from_doc as ref_merge
        from etl_tpu_torch.config.load import Secret
        from etl_tpu_torch.config.pipeline import PgConnectionConfig
        from etl_tpu_torch.models.errors import EtlError
        from etl_tpu_torch.replicator import store_connection_from_doc

        fields = dict(host="src-db", port=6000, name="app", username="etl")
        base = PgConnectionConfig(**fields, password=Secret("pw"))
        ref_base = RefConnection(**fields, password=RefSecret("pw"))
        for doc in ({"name": "etl_state"},
                    {"password": "other", "tls": {"enabled": True}}, None):
            got = store_connection_from_doc(base, doc)
            assert plain(got) == plain(ref_merge(ref_base, doc))
        merged = store_connection_from_doc(
            base, {"password": "other", "tls": {"enabled": True}})
        assert isinstance(merged.password, Secret)
        assert merged.tls.enabled is True
        with pytest.raises(EtlError):
            store_connection_from_doc(base, {"host": "x", "bogus_key": 1})


class TestRegistryAndRefusals:
    def test_registry_builds_memory_and_refuses_the_rest_typed(self):
        from etl_tpu_torch.destinations import (MemoryDestination,
                                                build_destination)
        from etl_tpu_torch.models.errors import ErrorKind, EtlError

        from etl_tpu_torch.destinations.bigquery import BigQueryDestination
        from etl_tpu_torch.destinations.clickhouse import (
            ClickHouseDestination, ClickHouseEngine)
        from etl_tpu_torch.destinations.snowflake import SnowflakeDestination

        assert isinstance(build_destination({"type": "memory"}),
                          MemoryDestination)
        ch = build_destination({"type": "clickhouse", "url": "http://x",
                                "engine": "ReplicatedReplacingMergeTree"})
        assert isinstance(ch, ClickHouseDestination)
        assert ch.config.engine is \
            ClickHouseEngine.REPLICATED_REPLACING_MERGE_TREE
        assert isinstance(build_destination(
            {"type": "bigquery", "project_id": "p", "dataset_id": "d",
             "base_url": "http://x"}), BigQueryDestination)
        assert isinstance(build_destination(
            {"type": "snowflake", "base_url": "http://x", "account": "a",
             "user": "u", "database": "db"}), SnowflakeDestination)
        for kind in ("lake", "iceberg"):
            with pytest.raises(EtlError) as ei:
                build_destination({"type": kind, "url": "http://x"})
            assert ei.value.kind is ErrorKind.CONFIG_INVALID
            assert kind in str(ei.value) and "ROADMAP" in str(ei.value)
            assert "Parquet" in str(ei.value)
        for bad in ({"type": "clickhouse", "url": "http://x",
                     "engine": "MergeTree"},
                    {"type": "bigquery", "project_id": "p"},
                    {"type": "snowflake", "base_url": "http://x",
                     "warehouse": "w"}):
            with pytest.raises(EtlError) as ei:
                build_destination(bad)
            assert ei.value.kind is ErrorKind.CONFIG_INVALID
            assert bad["type"] in str(ei.value)
        with pytest.raises(EtlError, match="unknown destination"):
            build_destination({"type": "kafka"})

    def test_maintenance_block_refused_typed(self, tmp_path, root_logging):
        from etl_tpu_torch.models.errors import ErrorKind, EtlError
        from etl_tpu_torch.replicator import run_replicator

        write_docs(tmp_path, {**BASE, "maintenance": {"coordination": True},
                              "destination": {"type": "memory"}})
        with pytest.raises(EtlError) as ei:
            asyncio.run(run_replicator(str(tmp_path)))
        assert ei.value.kind is ErrorKind.CONFIG_INVALID
        assert "lake" in str(ei.value)

    def test_shard_flags_answered_by_the_pipeline(self, tmp_path,
                                                  root_logging):
        """`--shard`/`--shard-count` reach the pipeline's config over the
        document's keys: a shard index outside the count is refused there,
        so main exits 1 before it connects (a valid pair runs a shard pod:
        tests/test_torch_sharding.py)."""
        from etl_tpu_torch.replicator import main

        write_docs(tmp_path, {**BASE, "destination": {"type": "memory"},
                              "store": {"type": "memory"}, "shard": 0,
                              "shard_count": 2})
        assert main(["--config-dir", str(tmp_path), "--shard", "2",
                     "--shard-count", "2"]) == 1


# -- /health, /health/detail, /metrics ----------------------------------------


async def _get(app, path):
    from aiohttp.test_utils import TestClient, TestServer

    client = TestClient(TestServer(app))
    await client.start_server()
    try:
        resp = await client.get(path)
        body = await resp.read()
        return resp.status, resp.content_type, body
    finally:
        await client.close()


async def _health_pair(prepare, path="/health", **cfg):
    """(reference, port) answers of `path` on pipelines over the same
    seeded database, each prepared by `prepare(pipeline, store)`."""
    from etl_tpu.replicator import build_observability_app as ref_app
    from etl_tpu_torch.replicator import build_observability_app
    from tests.test_pipeline_e2e import make_db as ref_db
    from tests.test_pipeline_e2e import make_pipeline as ref_pipeline
    from tests.test_torch_pipeline_e2e import make_db
    from tests.test_torch_supervision import make_pipeline

    out = []
    for app_of, (p, store, _) in (
            (ref_app, ref_pipeline(ref_db(), **cfg)),
            (build_observability_app, make_pipeline(make_db(), **cfg))):
        try:
            await prepare(p, store)
            status, ctype, body = await _get(app_of(p), path)
        finally:
            if p._apply_task is not None:
                await p.shutdown_and_wait()
            elif p.supervisor is not None and p.supervisor.started:
                await p.supervisor.stop()
        out.append((status, ctype, json.loads(body)))
    return out


class TestReplicatorHealthEndpoint:
    async def test_starting_is_503(self):
        async def prepare(p, store):
            return None

        ref, port = await _health_pair(prepare)
        assert port == ref
        assert port[0] == 503 and port[2] == {"status": "starting"}

    async def test_healthy_and_detail_after_start(self):
        async def steady(p, store):
            # both seeded tables READY (either package's enum) and their
            # table-sync workers gone from the registry: the component
            # set is then the same in both packages
            states = [await store.get_table_state(t) for t in (16384, 16385)]
            return all(st is not None and st.type.value == "ready"
                       for st in states) and not any(
                hb.name.startswith(("table_sync:", "decode:copy:"))
                for hb in p.supervisor.registry.components())

        async def prepare(p, store):
            await p.start()
            for _ in range(500):
                if await steady(p, store):
                    break
                await asyncio.sleep(0.02)
            assert await steady(p, store)
            p.supervisor.sweep_once()

        ref, port = await _health_pair(prepare)
        assert port == ref == (200, "application/json",
                               {"status": "healthy"})
        ref, port = await _health_pair(prepare, "/health/detail")
        assert port[0] == ref[0] == 200
        assert sorted(port[2]) == sorted(ref[2])
        assert sorted(port[2]["components"]) == sorted(ref[2]["components"])
        assert port[2]["components"]["apply"]["age_s"] < 60
        assert port[2]["breakers"]["MemoryDestination"]["state"] == "closed"

    async def test_faulted_is_503_with_detail(self):
        async def prepare(p, store):
            p.supervisor.start()
            p.supervisor.health.fault("apply worker failed: boom")

        ref, port = await _health_pair(prepare)
        assert port == ref
        assert port[0] == 503 and port[2]["status"] == "faulted"
        assert "boom" in port[2]["fatal"]

    async def test_degraded_stays_200_with_reasons(self):
        async def prepare(p, store):
            p.supervisor.started = True
            p.supervisor.health.set_reason("component:apply", "stall")

        ref, port = await _health_pair(prepare)
        assert port == ref == (200, "application/json", {
            "status": "degraded", "reasons": {"component:apply": "stall"}})

    async def test_supervision_disabled(self):
        from etl_tpu.config import SupervisionConfig as RefSupervision
        from etl_tpu_torch.config import SupervisionConfig

        # each package's own SupervisionConfig: build the pair by hand
        from etl_tpu.replicator import build_observability_app as ref_app
        from etl_tpu_torch.replicator import build_observability_app
        from tests.test_pipeline_e2e import make_db as ref_db
        from tests.test_pipeline_e2e import make_pipeline as ref_pipeline
        from tests.test_torch_pipeline_e2e import make_db
        from tests.test_torch_supervision import make_pipeline

        rp, _, _ = ref_pipeline(ref_db(),
                                supervision=RefSupervision(enabled=False))
        pp, _, _ = make_pipeline(make_db(),
                                 supervision=SupervisionConfig(enabled=False))
        ref = await _get(ref_app(rp), "/health")
        port = await _get(build_observability_app(pp), "/health")
        assert port == ref
        assert json.loads(port[2]) == {"status": "ok",
                                       "supervision": "disabled"}
        ref = await _get(ref_app(rp), "/health/detail")
        port = await _get(build_observability_app(pp), "/health/detail")
        assert port == ref

    async def test_metrics_renders_the_registry(self):
        from etl_tpu_torch.replicator import build_observability_app
        from etl_tpu_torch.telemetry.metrics import registry

        registry.counter_inc("etl_decode_routed_device_rows_total", 0)
        status, ctype, body = await _get(build_observability_app(None),
                                         "/metrics")
        assert status == 200 and ctype == "text/plain"
        assert b"etl_decode_routed_device_rows_total" in body
        status, _, body = await _get(build_observability_app(None),
                                     "/health/detail")
        assert status == 200 and json.loads(body) == {"state": "unsupervised"}


# -- the binary as a process ---------------------------------------------------


async def wait_metric(port: int, line: bytes, timeout_s: float = 30.0):
    """Until `/metrics` holds `line`."""
    for _ in range(int(timeout_s / 0.05)):
        status, body = await http_get(port, "/metrics")
        assert status == 200
        if line in body.splitlines():
            return
        await asyncio.sleep(0.05)
    raise AssertionError(f"{line!r} not in /metrics: {body[-2000:]!r}")


class TestReplicatorProcess:
    async def test_binary_health_cdc_and_sigterm(self, tmp_path):
        """`python -m etl_tpu_torch.replicator --config-dir DIR` with
        `batch: {device: cpu}`, a sqlite store and SCRAM (the password from
        APP_PG_CONNECTION__PASSWORD): `/health` answers 503 until the
        pipeline starts and 200 `healthy` after, the slot is confirmed up
        to the last commit, `/metrics` shows the decode counters, SIGTERM
        exits 0."""
        from etl_tpu_torch.postgres.client import PgReplicationClient
        from etl_tpu_torch.config import PgConnectionConfig
        from etl_tpu_torch.testing.fake_pg_server import FakePgServer
        from tests.test_torch_pipeline_e2e import ACCOUNTS, make_db

        db = make_db()
        db.create_publication("pub", [ACCOUNTS])
        server = FakePgServer(db, password="s3cret-pw",
                              keepalive_interval_s=0.03)
        await server.start()
        metrics_port = free_port()
        write_docs(tmp_path / "cfg", {
            "pipeline_id": 1, "publication_name": "pub",
            "pg_connection": {"host": "127.0.0.1", "port": server.port,
                              "name": "postgres", "username": "etl"},
            "batch": {"max_fill_ms": 30, "batch_engine": "cuda",
                      "device": "cpu"},
            "destination": {"type": "memory"},
            "store": {"type": "sqlite", "path": str(tmp_path / "s.db")},
            "metrics_port": metrics_port})
        env = {**os.environ, "PYTHONPATH": ROOT,
               "APP_PG_CONNECTION__PASSWORD": "s3cret-pw"}
        proc = await asyncio.create_subprocess_exec(
            sys.executable, "-m", "etl_tpu_torch.replicator",
            "--config-dir", str(tmp_path / "cfg"), cwd=ROOT, env=env,
            stdout=asyncio.subprocess.PIPE, stderr=asyncio.subprocess.PIPE)
        client = PgReplicationClient(PgConnectionConfig(
            host="127.0.0.1", port=server.port, name="postgres",
            username="etl", password="s3cret-pw"))
        try:
            seen = []
            for _ in range(1200):
                try:
                    status, body = await http_get(metrics_port, "/health")
                except OSError:
                    status, body = None, b""
                seen.append(status)
                if status == 200:
                    break
                assert proc.returncode is None, await proc.stderr.read()
                await asyncio.sleep(0.05)
            assert json.loads(body) == {"status": "healthy"}
            assert 503 in seen or None in seen
            # the three copied rows take the oracle route (under 64 rows)
            await wait_metric(metrics_port,
                              b"etl_decode_routed_oracle_rows_total 3")
            async with db.transaction() as tx:
                for i in range(100, 300):
                    tx.insert(ACCOUNTS, [str(i), f"n{i}", str(i)])
            last = db.current_lsn
            await client.connect()
            for _ in range(600):
                slot = await client.get_slot("supabase_etl_apply_1")
                if slot is not None and slot.confirmed_flush_lsn >= last:
                    break
                await asyncio.sleep(0.05)
            assert slot.confirmed_flush_lsn >= last
            # the 200 streamed rows take the device route (its plain
            # version on the CPU)
            await wait_metric(metrics_port,
                              b"etl_decode_routed_device_rows_total 200")
            proc.send_signal(signal.SIGTERM)
            rc = await asyncio.wait_for(proc.wait(), 60)
            err = (await proc.stderr.read()).decode()
            assert rc == 0, err[-3000:]
            assert "pipeline stopped cleanly" in err
        finally:
            if proc.returncode is None:
                proc.kill()
                await proc.wait()
            await client.close()
            await server.stop()


# -- the DLQ CLI over the wire, against the reference's -----------------------


class TestDlqCliOverWire:
    def _cli(self, main, *argv) -> tuple[int, dict]:
        import contextlib
        import io

        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = main(list(argv))
        return rc, json.loads(buf.getvalue())

    def test_postgres_and_replay_equal_reference(self, tmp_path):
        """The same dead letters on two fake servers; the reference CLI
        runs against one and the port's against the other, verb for verb:
        every JSON document and exit code equal."""
        from etl_tpu.dlq.__main__ import main as ref_main
        from etl_tpu_torch.config import PgConnectionConfig
        from etl_tpu_torch.dlq.__main__ import main
        from etl_tpu_torch.postgres.fake import FakeDatabase
        from etl_tpu_torch.store import PostgresStore
        from etl_tpu_torch.store.base import QuarantineRecord
        from etl_tpu_torch.testing.fake_pg_server import FakePgServer
        from tests.test_torch_poison_dlq import (insert_event, make_entry,
                                                 make_schema,
                                                 server_in_thread)

        dest_json = tmp_path / "dest.json"
        dest_json.write_text('{"type": "memory"}')
        transcripts = []
        for cli in (ref_main, main):
            with server_in_thread(FakePgServer(FakeDatabase(),
                                               password="pw")) as (srv, run):
                async def seed():
                    s = PostgresStore(PgConnectionConfig(
                        host="127.0.0.1", port=srv.port, name="postgres",
                        username="etl", password="pw"), 1)
                    await s.connect()
                    schema = make_schema()
                    await s.store_table_schema(schema, 1)
                    await s.append_dead_letters(
                        [make_entry(insert_event(schema, i, f"v{i}",
                                                 commit=100 + i))
                         for i in range(3)])
                    await s.set_table_quarantine(
                        16384, QuarantineRecord(16384, 100, 3))
                    await s.close()

                run(seed())
                base = ["--postgres", f"host=127.0.0.1 port={srv.port} "
                        "dbname=postgres user=etl password=pw",
                        "--pipeline-id", "1"]
                steps = [["list"], ["inspect", "1"], ["quarantined"],
                         ["replay", "--destination-json", str(dest_json)],
                         ["list"], ["list", "--status", "all"],
                         ["replay", "--destination-json", str(dest_json)],
                         ["unquarantine", "16384"], ["quarantined"]]
                transcripts.append([self._cli(cli, *base, *step)
                                    for step in steps])
        ref, port = transcripts
        for (rc_a, a), (rc_b, b) in zip(ref, port):
            for doc in (a, b):  # updated_at is a wall clock
                for e in [doc] + doc.get("entries", []):
                    e.pop("updated_at", None)
            assert (rc_b, b) == (rc_a, a)
        assert [rc for rc, _ in port] == [0] * len(port)
        assert port[0][1]["count"] == 3 and port[4][1]["count"] == 0
        assert port[3][1]["replayed"] == [1, 2, 3]


class TestSlotLag:
    async def test_lag_query_over_wire_equals_reference(self):
        from etl_tpu.postgres.lag import query_slot_lag as ref_query
        from etl_tpu.postgres.wire import PgWireConnection as RefConnection
        from etl_tpu.testing.fake_pg_server import FakePgServer as RefServer
        from etl_tpu_torch.postgres.lag import query_slot_lag
        from etl_tpu_torch.postgres.wire import PgWireConnection
        from etl_tpu_torch.testing.fake_pg_server import FakePgServer
        from tests.test_pipeline_e2e import make_db as ref_db
        from tests.test_torch_pipeline_e2e import make_db

        answers = []
        for server_cls, conn_cls, query, mk in (
                (RefServer, RefConnection, ref_query, ref_db),
                (FakePgServer, PgWireConnection, query_slot_lag, make_db)):
            db = mk()
            server = server_cls(db)
            await server.start()
            try:
                conn = conn_cls(host="127.0.0.1", port=server.port,
                                database="postgres", user="etl")
                await conn.connect()
                await conn.query(
                    'CREATE_REPLICATION_SLOT "supabase_etl_apply_9" '
                    "LOGICAL pgoutput (SNAPSHOT 'export')")
                async with db.transaction() as tx:
                    tx.insert(16384, ["999", "lag", "0"])
                before = await query(conn)
                db.invalidate_slot("supabase_etl_apply_9")
                after = await query(conn)
                await conn.close()
            finally:
                await server.stop()
            answers.append([dataclasses.asdict(m) for m in before + after])
        ref, port = answers
        assert port == ref
        assert port[0]["slot_name"] == "supabase_etl_apply_9"
        assert port[0]["confirmed_flush_lag_bytes"] > 0
        assert port[0]["wal_status"] == "reserved"
        assert port[1]["wal_status"] == "lost"


class TestWireRunsOnTheCpu:
    """The runs of `chip_smoke.py`'s phase 11, at a tiny size on the CPU
    (`device="cpu"`: the kernels' plain versions, which count no
    launch)."""

    async def test_run_replicator_copy_cdc_restart(self, root_logging):
        from etl_tpu_torch import bench

        r = await bench.run_wire_replicator(
            3000, 4000, device="cpu", warmup_events=4500,
            restart_events=700)
        assert r["ok"], r
        assert r["health"] == [[503, {"status": "starting"}],
                               [200, {"status": "healthy"}]]
        assert r["rows_delivered"] == 3000 and r["delivered_rows"] == 4000
        assert r["restart"]["rows"] == 700
        assert r["restart"]["copied_again"] == 0

    async def test_run_replicator_catalog_row_filter(self, root_logging):
        from etl_tpu_torch import bench

        r = await bench.run_wire_replicator(
            0, 4000, device="cpu", row_filter="bid <= 5",
            warmup_events=4500, restart_events=0)
        assert r["ok"], r
        assert 0.4 < r["keep_share"] < 0.6
        assert r["delivered_rows"] == r["want_rows"]

    async def test_binary_and_dlq_cli_processes(self):
        from etl_tpu_torch import bench

        r = await bench.run_replicator_binary(2000, 1000, device="cpu")
        assert r["ok"], r
        assert r["dlq_cli"]["replay"]["out"]["replayed"] == [1, 2, 3]
