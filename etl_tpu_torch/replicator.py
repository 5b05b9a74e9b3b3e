"""The replicator binary: `python -m etl_tpu_torch.replicator --config-dir DIR`.

Reference parity: crates/etl-replicator/src/main.rs:76 — config load →
tracing/metrics init → destination dispatch from config → pipeline start →
signal-driven graceful shutdown; plus the /metrics HTTP endpoint the
reference exposes through etl-telemetry.

Extra config keys consumed here (beyond PipelineConfig):
  destination: {type: memory|clickhouse|bigquery|snowflake, …params}
               (destinations/registry.py; `lake` and `iceberg` are refused
               typed until a Parquet writer without pyarrow exists)
  store:       {type: memory|sqlite|postgres, path: …, connection: …}
  metrics_port: 0 disables the endpoint

Copy of the reference's `etl_tpu/replicator.py`. The decoder runs where
`batch.batch_engine` and `batch.device` say: `cuda` on the card by
default (no card raises at start), `batch: {device: cpu}` for the tests.
`--shard`/`--shard-count` (or the document's `shard`/`shard_count` keys)
run the binary as one shard pod, and `/health` and `/health/detail` carry
the pod's shard identity. A `maintenance` block needs the lake destination
and is refused typed.
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import signal
import sys

from aiohttp import web

from .config.load import (Environment, load_config_dict,
                          pipeline_config_from_dict)
from .destinations.registry import build_destination
from .models.errors import ErrorKind, EtlError
from .postgres.client import PgReplicationClient
from .runtime.pipeline import Pipeline
from .store.memory import MemoryStore
from .store.sql import PostgresStore, SqliteStore
from .telemetry.metrics import registry
from .telemetry.tracing import init_tracing

logger = logging.getLogger("etl_tpu_torch.replicator")


def build_observability_app(pipeline=None) -> web.Application:
    """The replicator pod's /metrics + /health + /health/detail routes.

    /health is a LIVE surface of the supervision health state machine
    (docs/supervision.md), not a static ok: 503 with "starting" before
    the pipeline has started, 200 with the state while healthy/degraded,
    503 with the fatal detail once the apply worker failed permanently.
    /health/detail adds per-component heartbeat ages, breaker states,
    and recent supervision events."""

    async def metrics(_request: web.Request) -> web.Response:
        return web.Response(text=registry.render_prometheus(),
                            content_type="text/plain")

    def _supervisor():
        return pipeline.supervisor if pipeline is not None else None

    def _shard_fields() -> dict:
        # sharded pods identify their slice on every health surface so a
        # fleet dashboard can tell WHICH shard is unhealthy
        if pipeline is None or pipeline.config.shard is None:
            return {}
        ident = pipeline.shard_identity
        return {"shard": ident.describe() if ident is not None else {
            "shard": pipeline.config.shard,
            "shard_count": pipeline.config.shard_count,
            "epoch": None}}

    async def health(_request: web.Request) -> web.Response:
        sup = _supervisor()
        if sup is None:
            # supervision disabled: liveness of the process is all we
            # can honestly attest
            return web.json_response({"status": "ok",
                                      "supervision": "disabled",
                                      **_shard_fields()})
        if not sup.started:
            return web.json_response(
                {"status": "starting", **_shard_fields()}, status=503)
        from .supervision import HealthState

        state = sup.health.state
        body = {"status": state.value, **_shard_fields()}
        if state is HealthState.FAULTED:
            body["fatal"] = sup.health.fatal
            return web.json_response(body, status=503)
        if state is HealthState.DEGRADED:
            body["reasons"] = sup.health.reasons
        return web.json_response(body)

    async def health_detail(_request: web.Request) -> web.Response:
        if pipeline is None:
            return web.json_response({"state": "unsupervised"})
        snap = pipeline.health_snapshot()
        status = 503 if snap.get("health", {}).get("state") == "faulted" \
            or not snap.get("started", True) else 200
        return web.json_response(snap, status=status)

    app = web.Application()
    app.router.add_get("/metrics", metrics)
    app.router.add_get("/health", health)
    app.router.add_get("/health/detail", health_detail)
    return app


async def serve_metrics(port: int, pipeline=None) -> web.AppRunner | None:
    if not port:
        return None
    runner = web.AppRunner(build_observability_app(pipeline))
    await runner.setup()
    await web.TCPSite(runner, "0.0.0.0", port).start()
    logger.info("metrics on :%d/metrics", port)
    return runner


def store_connection_from_doc(base, overrides_doc):
    """store.connection overrides merge ONTO the source connection
    (per-field); secrets/tls convert through the loader; unknown keys are
    typed CONFIG_INVALID errors."""
    if not overrides_doc:
        return base
    import dataclasses

    from .config.load import Secret, _build
    from .config.pipeline import PgConnectionConfig, TlsConfig

    overrides = dict(overrides_doc)
    known = {f.name for f in dataclasses.fields(PgConnectionConfig)}
    unknown = set(overrides) - known
    if unknown:
        raise EtlError(ErrorKind.CONFIG_INVALID,
                       f"store.connection: unknown keys {sorted(unknown)}")
    if overrides.get("password") is not None:
        overrides["password"] = Secret(overrides["password"])
    if "tls" in overrides:
        overrides["tls"] = _build(TlsConfig, overrides["tls"])
    merged = dataclasses.replace(base, **overrides)
    merged.validate()
    return merged


async def run_replicator(config_dir: str,
                         environment: Environment | None = None,
                         shard: int | None = None,
                         shard_count: int | None = None) -> None:
    doc = load_config_dict(config_dir, environment)
    # CLI shard identity wins over the config document: the orchestrator
    # writes per-shard config docs, but an operator can also pin a pod's
    # slice at the command line (docs/sharding.md runbook)
    if shard is not None:
        doc["shard"] = shard
    if shard_count is not None:
        doc["shard_count"] = shard_count
    dest_doc = doc.pop("destination", {"type": "memory"})
    store_doc = doc.pop("store", {"type": "memory"})
    if doc.pop("maintenance", None):
        raise EtlError(
            ErrorKind.CONFIG_INVALID,
            "maintenance: external-maintenance coordination needs the lake "
            "destination, which is not ported to etl_tpu_torch yet "
            "(ROADMAP.md, queue 1)")
    metrics_port = doc.pop("metrics_port", 0)
    project_ref = doc.pop("project_ref", "")
    error_webhook = doc.pop("error_webhook_url", "")
    config = pipeline_config_from_dict(doc)

    env = environment or Environment.current()
    init_tracing(environment=env.value, project_ref=project_ref,
                 pipeline_id=config.pipeline_id)
    notifier = None
    if error_webhook:
        from .telemetry.notify import WebhookErrorNotifier

        notifier = WebhookErrorNotifier(error_webhook,
                                        pipeline_id=config.pipeline_id)
        notifier.install()
    logger.info("starting replicator pipeline=%s publication=%s engine=%s"
                "%s",
                config.pipeline_id, config.publication_name,
                config.batch.batch_engine.value,
                f" shard={config.shard}/{config.shard_count}"
                if config.shard is not None else "")

    store_type = store_doc.get("type", "memory")
    if store_type == "sqlite":
        store = SqliteStore(store_doc["path"], config.pipeline_id)
        await store.connect()
    elif store_type == "postgres":
        # durable state lives in a Postgres `etl` schema over the same
        # wire stack as replication (reference store/both/postgres.rs);
        # defaults to the SOURCE connection, overridable per-field
        store_conn = store_connection_from_doc(
            config.pg_connection, store_doc.get("connection"))
        store = PostgresStore(store_conn, config.pipeline_id)
        await store.connect()
    else:
        store = MemoryStore()
    destination = build_destination(dest_doc)

    pipeline = Pipeline(
        config=config, store=store, destination=destination,
        source_factory=lambda: PgReplicationClient(config.pg_connection))

    metrics_runner = await serve_metrics(metrics_port, pipeline)
    loop = asyncio.get_event_loop()
    # hold the shutdown-task handle: the loop keeps only a weak ref, so
    # a bare ensure_future in the handler could be GC'd mid-shutdown
    # (etl-lint: orphaned-task)
    signal_tasks: set[asyncio.Task] = set()

    def _request_shutdown() -> None:
        t = asyncio.ensure_future(pipeline.shutdown())
        signal_tasks.add(t)
        t.add_done_callback(signal_tasks.discard)

    for sig in (signal.SIGINT, signal.SIGTERM):
        loop.add_signal_handler(sig, _request_shutdown)

    try:
        await pipeline.start()
        logger.info("pipeline started")
        await pipeline.wait()
        logger.info("pipeline stopped cleanly")
    except BaseException as e:
        if not isinstance(e, asyncio.CancelledError):
            # log INSIDE the loop so the error webhook can still fire
            # (main() runs after asyncio.run() returns, where the hook
            # has no loop to post from)
            logger.error("replicator failed: %s", e)
        raise
    finally:
        if metrics_runner is not None:
            await metrics_runner.cleanup()
        close = getattr(store, "close", None)
        if close is not None:
            await close()
        if notifier is not None:
            await notifier.close()  # awaits in-flight notifications


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="etl_tpu_torch.replicator",
        description="Postgres logical-replication replicator on a CUDA "
                    "card")
    parser.add_argument("--config-dir", required=True,
                        help="directory with base.yaml / {env}.yaml")
    parser.add_argument("--environment", choices=[e.value for e in Environment],
                        default=None)
    parser.add_argument("--shard", type=int, default=None,
                        help="this pod's shard index in a K-way split of "
                             "the publication; overrides the config "
                             "document's `shard` key")
    parser.add_argument("--shard-count", dest="shard_count", type=int,
                        default=None,
                        help="total shard count K of the deployment; "
                             "overrides the config document's "
                             "`shard_count` key and must match the "
                             "store's authoritative assignment")
    args = parser.parse_args(argv)
    env = Environment(args.environment) if args.environment else None
    try:
        asyncio.run(run_replicator(args.config_dir, env,
                                   shard=args.shard,
                                   shard_count=args.shard_count))
        return 0
    except KeyboardInterrupt:
        return 0
    except EtlError:
        return 1  # already logged (and webhooked) inside the loop


if __name__ == "__main__":
    sys.exit(main())
