"""Time one COPY over the wire against each fake server, read by each client.

The reference's `FakePgServer` writes every CopyData row with a `write()` of
its own and yields the loop only at the end of the COPY. The port's writes
512 rows a `write()` and yields between writes. This script holds the two
apart at a copy partition's size:

    JAX_PLATFORMS=cpu python tests/torch_wire_copy_cost.py \\
        [--rows 15625,31250,62500] [--row-us 10.8] [--out FILE]

For each server package, client package and row count it starts the server
in a process of its own (`--serve PKG N`, as chip_smoke.py's phase 11 keeps
its server), COPYs the whole table (pgbench_accounts' four columns, an
84-character filler) through that client's `copy_table_stream`, spending
`--row-us` microseconds of the client's CPU on each row it reads (the
replicator's pace over the wire: 92,801 rows/s on the H100 is 10.8 µs a
row), and prints one JSON line: the seconds of the COPY, the rows read, the server process's
CPU seconds over the COPY, and `scanned`, the buffer entries that the
server's transports summed in `get_write_buffer_size`. On CPython 3.12 that
call sums the length of every buffered chunk on each `write()` that finds
the buffer non-empty, so a COPY whose rows outrun the socket buffer costs
the server a number of steps that grows with the square of its rows. Each
side of a pair runs its own package only: the server process imports the
server's package, the parent the client's.

    python tests/torch_wire_copy_cost.py --pipeline 1000000 \\
        [--device cuda] [--timeout 300]

runs the port's whole table copy instead, as phase 11(a) of chip_smoke.py
does (`runtime.Pipeline` with the default PipelineConfig and a 30 ms fill
window, 16 CTID partitions on 4 connections of the port's wire client, the
decoder on `--device`, a memory destination), against each server package
in turn: one JSON line each with whether the table reached READY within
`--timeout` seconds, the seconds it took, the rows delivered, and the
server's CPU seconds and `scanned` count, read while the copy runs.
"""

from __future__ import annotations

import argparse
import asyncio
import importlib
import json
import os
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
TABLE_ID = 16384
FILLER = 84


def _rows(n: int) -> list:
    return [[str(i), str(1 + (i - 1) // 100_000), str((i * 7919) % 10_000
                                                       - 5_000),
             (f"{i:08d}" * 11)[:FILLER]] for i in range(1, n + 1)]


def _schema(pkg: str):
    m = importlib.import_module(f"{pkg}.models")
    return m.TableSchema(
        TABLE_ID, m.TableName("public", "pgbench_accounts"),
        (m.ColumnSchema("aid", m.Oid.INT4, nullable=False,
                        primary_key_ordinal=1),
         m.ColumnSchema("bid", m.Oid.INT4),
         m.ColumnSchema("abalance", m.Oid.INT4),
         m.ColumnSchema("filler", m.Oid.BPCHAR, modifier=FILLER + 4)))


async def _serve(pkg: str, n_rows: int) -> None:
    import asyncio.selector_events as se

    scanned = [0]
    real = se._SelectorTransport.get_write_buffer_size

    def counted(self):
        scanned[0] += len(self._buffer)
        return real(self)

    se._SelectorTransport.get_write_buffer_size = counted
    fake = importlib.import_module(f"{pkg}.postgres.fake")
    server_mod = importlib.import_module(f"{pkg}.testing.fake_pg_server")
    db = fake.FakeDatabase()
    db.create_table(_schema(pkg), rows=_rows(n_rows))
    db.create_publication("pub", [TABLE_ID])
    server = server_mod.FakePgServer(db)
    await server.start()
    print(server.port, flush=True)
    loop = asyncio.get_running_loop()
    done = asyncio.Event()

    def control() -> None:
        # a thread of its own: it answers while the loop is busy writing
        marks = {}
        for line in sys.stdin:
            line = line.strip()
            if line == "stop":
                break
            marks[line] = (time.process_time(), scanned[0])
            if line == "end":
                (c0, s0), (c1, s1) = marks["begin"], marks["end"]
                print(json.dumps({"server_cpu_s": c1 - c0,
                                  "scanned": s1 - s0}), flush=True)
        loop.call_soon_threadsafe(done.set)

    threading.Thread(target=control, daemon=True).start()
    await done.wait()
    await server.stop()


async def _copy(pkg: str, port: int, row_us: float) -> int:
    cfg = importlib.import_module(f"{pkg}.config")
    client_mod = importlib.import_module(f"{pkg}.postgres.client")
    client = client_mod.PgReplicationClient(cfg.PgConnectionConfig(
        host="127.0.0.1", port=port, name="postgres", username="etl"))
    await client.connect()
    try:
        stream = await client.copy_table_stream(TABLE_ID, "pub", "")
        rows = 0
        spin_until = time.perf_counter()
        async for _ in stream:
            rows += 1
            if rows % 64 == 0:  # the replicator's work on these rows
                spin_until = max(spin_until, time.perf_counter()) \
                    + 64 * row_us * 1e-6
                while time.perf_counter() < spin_until:
                    pass
        return rows
    finally:
        await client.close()


def _with_server(server_pkg: str, n_rows: int, run) -> dict:
    """Start the server process, mark `begin`, await `run(port)`, mark
    `end` and return the run's record with the server's."""
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--serve", server_pkg,
         str(n_rows)], cwd=ROOT, stdin=subprocess.PIPE,
        stdout=subprocess.PIPE, text=True,
        env={**os.environ, "PYTHONPATH": ROOT})
    try:
        port = int(proc.stdout.readline())
        proc.stdin.write("begin\n")
        proc.stdin.flush()
        rec = asyncio.run(run(port))
        proc.stdin.write("end\n")
        proc.stdin.flush()
        rec.update(json.loads(proc.stdout.readline()))
        proc.stdin.write("stop\n")
        proc.stdin.flush()
        proc.wait(60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return {"server": server_pkg, "rows": n_rows, **rec}


def measure(server_pkg: str, client_pkg: str, n_rows: int,
            row_us: float) -> dict:
    async def run(port):
        t0 = time.perf_counter()
        rows = await _copy(client_pkg, port, row_us)
        return {"client": client_pkg, "row_us": row_us, "rows_read": rows,
                "seconds": time.perf_counter() - t0}

    return _with_server(server_pkg, n_rows, run)


async def _pipeline_copy(port: int, device: str, timeout_s: float) -> dict:
    from etl_tpu_torch.config import (BatchConfig, BatchEngine,
                                      PgConnectionConfig, PipelineConfig)
    from etl_tpu_torch.destinations import MemoryDestination
    from etl_tpu_torch.postgres.client import PgReplicationClient
    from etl_tpu_torch.runtime import Pipeline, TableStateType
    from etl_tpu_torch.store import NotifyingStore

    conn = PgConnectionConfig(host="127.0.0.1", port=port, name="postgres",
                              username="etl")
    store, dest = NotifyingStore(), MemoryDestination()
    pipeline = Pipeline(
        config=PipelineConfig(
            pipeline_id=1, publication_name="pub", pg_connection=conn,
            batch=BatchConfig(max_fill_ms=30, batch_engine=BatchEngine.CUDA,
                              device=device)),
        store=store, destination=dest,
        source_factory=lambda: PgReplicationClient(conn))
    await pipeline.start()
    t0 = time.perf_counter()
    try:
        await asyncio.wait_for(store.notify_on(TABLE_ID,
                                               TableStateType.READY),
                               timeout_s)
        ready = True
    except asyncio.TimeoutError:
        ready = False
    seconds = time.perf_counter() - t0
    rows = len(dest.table_rows.get(TABLE_ID, []))
    try:
        await asyncio.wait_for(pipeline.shutdown_and_wait(), 60)
    except asyncio.TimeoutError:
        pass
    return {"client": "etl_tpu_torch pipeline", "device": device,
            "ready": ready, "seconds": seconds, "rows_delivered": rows}


def measure_pipeline(server_pkg: str, n_rows: int, device: str,
                     timeout_s: float) -> dict:
    return _with_server(server_pkg, n_rows,
                        lambda port: _pipeline_copy(port, device, timeout_s))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", default="15625,31250,62500")
    ap.add_argument("--row-us", type=float, default=10.8)
    ap.add_argument("--out", default=None)
    ap.add_argument("--pipeline", type=int, default=None, metavar="ROWS")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--timeout", type=float, default=300.0)
    ap.add_argument("--serve", nargs=2, metavar=("PKG", "ROWS"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.serve:
        asyncio.run(_serve(args.serve[0], int(args.serve[1])))
        return 0
    if args.pipeline is not None:
        for server in ("etl_tpu_torch", "etl_tpu"):
            print(json.dumps(measure_pipeline(server, args.pipeline,
                                              args.device, args.timeout)),
                  flush=True)
        return 0
    lines = []
    for n in [int(x) for x in args.rows.split(",")]:
        for server in ("etl_tpu_torch", "etl_tpu"):
            for client in ("etl_tpu_torch", "etl_tpu"):
                rec = measure(server, client, n, args.row_us)
                lines.append(json.dumps(rec))
                print(lines[-1], flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")
    ok = all(json.loads(ln)["rows_read"] == json.loads(ln)["rows"]
             for ln in lines)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
