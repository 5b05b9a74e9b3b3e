"""The control plane end to end: the API's routes start replicator
children through `LocalOrchestrator`, which decode on `device`, and a
shard rebalance plus `scale_pipeline` rolls them from K = 1 to K = 2.

    r = asyncio.run(run_control_plane(device="cpu"))   # r["ok"]

The run, in one process beside three kinds of children:

- the source: the port's fake Postgres server in a child process
  (`testing.pg_process`) holding `tables` tables of pgbench_accounts'
  shape, `copy_rows` rows each, one publication over all of them;
- the destination: the ClickHouse fake in a child process
  (`testing.http_process`), which counts rows and sequence keys outside
  the replicators;
- the API (`api.app.build_app` over `SqliteApiDb` and a
  `LocalOrchestrator`) served on localhost; a tenant, the source, the
  destination and the pipeline are created through its routes, and
  `POST /v1/pipelines/1/start` starts one `python -m
  etl_tpu_torch.replicator` child: shard 0 of 1 over a PostgresStore on
  the fake server, its `/metrics` on a port of its own;
- K = 1: the child copies every table and streams `events` inserts
  (500-row transactions, spread over the tables); its own `/metrics`
  must show device-routed rows (and, on the card, kernel seconds);
- the roll: `ShardCoordinator.add_shard()` fences the new shard and
  flips the assignment to K = 2, then `LocalOrchestrator.scale_pipeline`
  stops the K = 1 child and starts shards 0 and 1 of 2 (each serving
  `/metrics` on the base port plus its shard index); another `events`
  inserts, and each child's own `/metrics` must show its own device
  work;
- every copied row and every sequence key arrives once, table by table;
- `POST /v1/pipelines/1/stop` and `shutdown()`: no child is left.

On the card the kernel libraries are built once in this process before
any child starts; each child loads them from `_build/`. A child that
cannot build or launch fails its batches, and the run fails with them:
nothing degrades to the host oracle.
"""

from __future__ import annotations

import asyncio
import os
import tempfile
import time

TENANT = {"tenant_id": "acme"}
TX_SIZE = 500


def _metric(text: str, name: str) -> float:
    """The sum of a Prometheus text exposition's samples of `name`."""
    total = 0.0
    for line in text.splitlines():
        if line.startswith(name) and line[len(name):len(name) + 1] in " {":
            total += float(line.rsplit(" ", 1)[1])
    return total


class PortPair:
    """Two adjacent ports on 127.0.0.1, p and p + 1 (the K = 2 children's
    `/metrics`), held from the choice until `close()`.

    Each port stays bound here by a socket marked SO_REUSEADDR before its
    bind, which never listens: an outgoing connection never picks a
    bound port as its local port, and an exclusive bind (another run's
    `PortPair` probe, a `bind(0)` probe) is refused, while the children's
    servers (aiohttp binds with SO_REUSEADDR) bind and listen beside it,
    and a child restarted on the same port finds it still held. Each
    port is first probed by an exclusive bind, released and taken at
    once by the holder (a gap of two system calls). The holder is marked
    before its bind because some kernels (the card's host) refuse the
    child's bind beside a socket marked after it. A probe released until
    the child bound it lost the port, now and then, to another socket
    (an outgoing connection's local port, or one in TIME_WAIT): the child
    then failed to bind and exited."""

    def __init__(self):
        import socket

        def take(port: int) -> "socket.socket":
            probe = socket.socket()
            try:
                probe.bind(("127.0.0.1", port))  # exclusive: nobody else
                port = probe.getsockname()[1]
            finally:
                probe.close()
            held = socket.socket()
            held.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            try:
                held.bind(("127.0.0.1", port))
            except OSError:
                held.close()
                raise
            return held

        for _ in range(100):
            try:
                a = take(0)
            except OSError:
                continue
            port = a.getsockname()[1]
            try:
                if port + 1 > 65535:
                    raise OSError("no port above")
                b = take(port + 1)
            except OSError:
                a.close()
                continue
            self.port = port
            self._held = [a, b]
            return
        raise RuntimeError("no free pair of ports")

    def close(self) -> None:
        for sock in self._held:
            sock.close()
        self._held = []


def _alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    return True


async def run_control_plane(copy_rows: int = 2_000, events: int = 4_000, *,
                            tables: int = 4, device: str = "cuda",
                            seed: int = 7) -> dict:
    import aiohttp
    from aiohttp import web

    from .. import bench
    from ..api.app import ApiState, build_app
    from ..api.crypto import ConfigCipher, EncryptionKey
    from ..api.db import SqliteApiDb
    from ..api.orchestrator import LocalOrchestrator
    from ..config import PgConnectionConfig
    from ..postgres.client import PgReplicationClient
    from ..sharding import ShardCoordinator, ShardMap
    from ..store import PostgresStore
    from ..testing.http_process import HttpServerProcess
    from ..testing.pg_process import PgServerProcess

    table_ids = [bench.PGBENCH_TID + i for i in range(tables)]
    part = ShardMap(2).partition(table_ids)
    out: dict = {"mode": "control_plane", "device": device,
                 "tables": tables, "copy_rows": copy_rows,
                 "events": events, "tx_size": TX_SIZE}
    if any(not part[s] for s in (0, 1)):
        raise ValueError(f"{tables} tables leave a shard of K = 2 empty")
    if device.split(":")[0] == "cuda":
        # one nvcc build a source, in this process, before any child
        from ..ops import decode_kernel, egress_kernel

        t0 = time.perf_counter()
        decode_kernel.load()
        egress_kernel.load()
        out["build_s"] = time.perf_counter() - t0

    tmp = tempfile.TemporaryDirectory()
    server = PgServerProcess(password=bench.WIRE_PASSWORD)
    fake = HttpServerProcess("clickhouse")
    orch = LocalOrchestrator(os.path.join(tmp.name, "work"))
    runner = None
    ports = PortPair()
    store = None
    children: dict = {}  # key → pid, every child the run saw

    async def acall(proc, cmd, **kw):
        return await asyncio.to_thread(proc.call, cmd, **kw)

    per = events // tables  # inserts a table, at each K

    async def produce(first_aid: int, seed0: int) -> None:
        """`per` inserts into each table, in 500-row transactions."""
        for i, tid in enumerate(table_ids):
            await acall(server, "prepare", n_events=per, seed=seed0 + i,
                        first_aid=first_aid, table_id=tid)
            await acall(server, "produce", tx_size=TX_SIZE)

    async def until_counted(key: str, want: int, timeout_s: float,
                            what: str) -> None:
        async def done():
            return (await acall(fake, "count"))[key] >= want

        await bench._until(done, timeout_s, what, interval=0.05)

    async def scrape(port: int) -> dict:
        status, body = await bench.http_get(port, "/metrics")
        text = body.decode()
        return {"status": status,
                "device_rows": _metric(
                    text, "etl_decode_routed_device_rows_total"),
                "kernel_s": _metric(text, "etl_decode_kernel_seconds_total")}

    async def healthy(ports: list, timeout_s: float) -> float:
        t0 = time.perf_counter()

        async def up():
            for key, proc in orch._procs.items():
                children[key] = proc.pid
                if proc.returncode is not None:
                    raise RuntimeError(
                        f"replicator child {key} exited with "
                        f"{proc.returncode}")
            for p in ports:
                try:
                    status, _ = await bench.http_get(p, "/health")
                except OSError:
                    return False
                if status != 200:
                    return False
            return True

        await bench._until(up, timeout_s, f"/health 200 on {ports}",
                           interval=0.1)
        return time.perf_counter() - t0

    def device_work_ok(m: dict) -> bool:
        if m["status"] != 200 or m["device_rows"] <= 0:
            return False
        return m["kernel_s"] > 0 if device.split(":")[0] == "cuda" \
            else True

    try:
        for i, tid in enumerate(table_ids):
            await acall(server, "table", n_rows=copy_rows, seed=seed + i,
                        table_id=tid, name=f"pgbench_accounts_{i}")
        await acall(server, "publication", name="pub", row_filter=None,
                    offload=False, table_ids=table_ids)
        conn = PgConnectionConfig(host="127.0.0.1", port=server.port,
                                  name="postgres", username="etl",
                                  password=bench.WIRE_PASSWORD)

        state = ApiState(SqliteApiDb(os.path.join(tmp.name, "api.db")),
                         ConfigCipher(EncryptionKey.generate()), orch)
        runner = web.AppRunner(build_app(state))
        await runner.setup()
        api_port = bench.free_port()
        await web.TCPSite(runner, "127.0.0.1", api_port).start()
        base = f"http://127.0.0.1:{api_port}"
        metrics_port = ports.port
        routes: dict = {}
        async with aiohttp.ClientSession() as http:
            async def call(method: str, path: str, doc=None,
                           headers=TENANT) -> dict:
                async with http.request(method, base + path, json=doc,
                                        headers=headers) as resp:
                    body = await resp.json() if resp.content_type \
                        == "application/json" else await resp.text()
                    routes[f"{method} {path}"] = resp.status
                    if resp.status >= 400:
                        raise RuntimeError(f"{method} {path} → "
                                           f"{resp.status}: {body}")
                    return body

            await call("POST", "/v1/tenants", {"id": "acme",
                                               "name": "Acme"}, headers={})
            src = await call("POST", "/v1/sources", {
                "name": "fake-pg", "config": {
                    "host": "127.0.0.1", "port": server.port,
                    "name": "postgres", "username": "etl",
                    "password": bench.WIRE_PASSWORD}})
            dst = await call("POST", "/v1/destinations", {
                "name": "clickhouse", "config": fake.destination_doc()})
            pipe = await call("POST", "/v1/pipelines", {
                "source_id": src["id"], "destination_id": dst["id"],
                "publication_name": "pub",
                "config": {"shard": 0, "shard_count": 1,
                           "batch": {"batch_engine": "cuda",
                                     "device": device, "max_fill_ms": 30},
                           "store": {"type": "postgres"},
                           "metrics_port": metrics_port}})
            pid = pipe["id"]
            await call("POST", f"/v1/pipelines/{pid}/start")
            out["k1_start_s"] = await healthy([metrics_port], 300)
            out["status_k1"] = (await call(
                "GET", f"/v1/pipelines/{pid}/status"))

            # -- K = 1: copy, then stream -----------------------------------
            t0 = time.perf_counter()
            await until_counted("copy_rows", tables * copy_rows, 600,
                                "the copy at K = 1")
            out["copy_s"] = time.perf_counter() - t0
            first_aid = copy_rows + 1
            t0 = time.perf_counter()
            await produce(first_aid, seed + 100)
            await until_counted("cdc_rows", per * tables, 600,
                                "CDC at K = 1")
            out["k1_cdc_s"] = time.perf_counter() - t0
            out["k1_metrics"] = await scrape(metrics_port)

            # -- the roll to K = 2 -----------------------------------------
            store = PostgresStore(conn, pid)
            await store.connect()
            coordinator = ShardCoordinator(
                store, pid, lambda: PgReplicationClient(conn),
                quiesce_timeout_s=120.0)
            t0 = time.perf_counter()
            rebalance = await coordinator.add_shard()
            out["rebalance_s"] = time.perf_counter() - t0
            out["rebalance"] = rebalance.describe()
            spec = orch._specs[pid]
            t0 = time.perf_counter()
            await orch.scale_pipeline(spec, 2)
            ports2 = [metrics_port, metrics_port + 1]
            out["k2_start_s"] = await healthy(ports2, 300)
            out["roll_s"] = time.perf_counter() - t0
            out["keys_k2"] = sorted(str(k) for k in orch._procs)
            out["status_k2"] = (await call(
                "GET", f"/v1/pipelines/{pid}/status"))

            t0 = time.perf_counter()
            await produce(first_aid + per, seed + 200)
            await until_counted("cdc_rows", 2 * per * tables, 600,
                                "CDC at K = 2")
            out["k2_cdc_s"] = time.perf_counter() - t0
            out["k2_metrics"] = [await scrape(p) for p in ports2]

            # -- stop: no child left ---------------------------------------
            await call("POST", f"/v1/pipelines/{pid}/stop")
            out["status_stopped"] = (await call(
                "GET", f"/v1/pipelines/{pid}/status"))
            out["routes"] = routes
        report = await acall(fake, "report")
        per_table: dict = {}
        for name, t in report["tables"].items():
            keys = list(zip(t["lsn"].tolist(), t["ordinal"].tolist()))
            copied = t["by_lsn"].get(0, [0, 0])[0]
            per_table[name] = {"copy_rows": int(copied),
                               "cdc_rows": len(keys),
                               "distinct_keys": len(set(keys))}
        out["per_table"] = per_table
        out["children"] = {str(k): v for k, v in children.items()}
    finally:
        await orch.shutdown()
        if store is not None:
            await store.close()
        if runner is not None:
            await runner.cleanup()
        ports.close()
        fake.close()
        server.close()
        tmp.cleanup()

    out["children_left"] = [k for k, p in out["children"].items()
                            if _alive(p)]
    checks = {
        "k1_device_work": device_work_ok(out["k1_metrics"]),
        "k2_device_work_each": all(device_work_ok(m)
                                   for m in out["k2_metrics"]),
        "k2_two_children": out["keys_k2"] == [f"({pid}, 0)",
                                              f"({pid}, 1)"],
        "rebalance_flipped": out["rebalance"]["new_shard_count"] == 2,
        "tables": len(per_table) == tables,
        "copy_once": all(t["copy_rows"] == copy_rows
                         for t in per_table.values()),
        "keys_once": sum(t["cdc_rows"] for t in per_table.values())
        == 2 * per * tables
        and all(t["cdc_rows"] == t["distinct_keys"]
                for t in per_table.values()),
        "no_child_left": out["children_left"] == []
        and not orch._procs,
        "stopped": out["status_stopped"]["state"] == "stopped",
    }
    out["checks"] = checks
    out["ok"] = all(checks.values())
    return out
