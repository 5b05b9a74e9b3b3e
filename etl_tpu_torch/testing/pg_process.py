"""A fake Postgres server in a process of its own, with its database and a
pgbench producer, driven over a pipe.

`FakePgServer` encodes every COPY row and WAL frame in Python. On the
replicator's event loop that work would be charged to the replicator, so
a measured run keeps the server in a child process of its own (a new
interpreter: it inherits no CUDA state). The child owns the `FakeDatabase`, the `pgbench_accounts`
table and the producer that commits CDC into it; the parent sends it
commands and waits for each answer:

    with PgServerProcess(password="pw") as server:
        server.call("table", n_rows=1_000_000, seed=7)
        server.call("publication", name="pub", row_filter=None,
                    offload=False)
        server.call("prepare", n_events=500_000, seed=8, first_aid=1)
        out = server.call("produce", tx_size=500)

`produce` commits the prepared payloads in transactions of `tx_size` rows
as fast as the child can, and returns each commit's LSN, its rows and
`time.perf_counter()` just after it (the clock is CLOCK_MONOTONIC, shared
by the processes of one host, so the parent compares its arrival times
with it). `slot` reads a replication slot's confirmed flush, `state` a
table's current state in the `etl` schema a PostgresStore keeps on the
server. `call` is thread-safe (one command
in flight at a time), so an event loop can run it in `asyncio.to_thread`.
"""

from __future__ import annotations

import asyncio
import json
import os
import pickle
import secrets
import socket
import struct
import subprocess
import sys
import threading
import time


class _Channel:
    """Length-prefixed pickles over a socket between the two processes
    (both ends are this package)."""

    def __init__(self, sock: socket.socket):
        self._file = sock.makefile("rwb")
        self._sock = sock

    def send(self, obj) -> None:
        data = pickle.dumps(obj)
        self._file.write(struct.pack(">I", len(data)) + data)
        self._file.flush()

    def recv(self):
        head = self._file.read(4)
        if len(head) < 4:
            raise EOFError("the other process closed the channel")
        (n,) = struct.unpack(">I", head)
        return pickle.loads(self._file.read(n))

    def close(self) -> None:
        self._file.close()
        self._sock.close()


class ServerProcess:
    """A fake server in a child process (`python -m <module> PORT TOKEN
    ARGS…`, which imports nothing of its parent's main module) and its
    channel; `port` is the server's TCP port on 127.0.0.1. The child
    connects back to PORT, sends TOKEN and then the port it serves on."""

    def __init__(self, module: str, args: list, *, what: str,
                 start_timeout_s: float = 120.0):
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        token = secrets.token_hex(16)
        self._what = what
        self._lock = threading.Lock()
        self._chan = None
        with socket.create_server(("127.0.0.1", 0)) as listener:
            listener.settimeout(start_timeout_s)
            self.process = subprocess.Popen(
                [sys.executable, "-m", module,
                 str(listener.getsockname()[1]), token, *args],
                cwd=root, env={**os.environ, "PYTHONPATH": root})
            try:
                sock, _ = listener.accept()
            except OSError:
                self.close()
                raise RuntimeError(f"the {what} process did not start")
        sock.settimeout(None)
        self._chan = _Channel(sock)
        if self._recv() != token:
            self.close()
            raise RuntimeError(f"the {what} process did not answer")
        self.port = self._recv()

    def _recv(self):
        kind, value = self._chan.recv()
        if kind == "error":
            raise RuntimeError(f"{self._what} process: {value}")
        return value

    def call(self, cmd: str, **kwargs):
        with self._lock:
            self._chan.send((cmd, kwargs))
            return self._recv()

    def close(self) -> None:
        if self._chan is not None:
            try:
                with self._lock:
                    self._chan.send(("stop", {}))
            except OSError:
                pass
        try:
            self.process.wait(30)
        except subprocess.TimeoutExpired:
            self.process.kill()
            self.process.wait(10)
        if self._chan is not None:
            self._chan.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class PgServerProcess(ServerProcess):
    """The fake Postgres server's child process
    (`python -m etl_tpu_torch.testing.pg_process`)."""

    def __init__(self, *, password: str | None = None,
                 start_timeout_s: float = 120.0):
        super().__init__("etl_tpu_torch.testing.pg_process",
                         [json.dumps(password)], what="fake server",
                         start_timeout_s=start_timeout_s)


def _child_main(argv: list) -> None:
    port, token, password = int(argv[0]), argv[1], json.loads(argv[2])
    chan = _Channel(socket.create_connection(("127.0.0.1", port)))
    chan.send(("ok", token))
    asyncio.run(_serve(chan, password))


async def _serve(conn, password):
    from ..postgres.fake import FakeDatabase
    from .fake_pg_server import FakePgServer

    db = FakeDatabase()
    server = FakePgServer(db, password=password)
    await server.start()
    conn.send(("ok", server.port))
    state: dict = {}
    loop = asyncio.get_running_loop()
    try:
        while True:
            cmd, kwargs = await loop.run_in_executor(None, conn.recv)
            if cmd == "stop":
                return
            try:
                out = await _COMMANDS[cmd](db, state, **kwargs)
            except Exception as e:  # answered, not fatal to the server
                conn.send(("error", f"{cmd}: {e!r}"))
                continue
            conn.send(("ok", out))
    finally:
        await server.stop()
        conn.close()


async def _table(db, state, *, n_rows: int, seed: int) -> dict:
    """pgbench_accounts with `n_rows` seeded rows (`bench.pgbench_table`);
    returns the COPY text's size in bytes."""
    from .. import bench

    rows = bench.table_text_rows(bench.pgbench_table(n_rows, seed))
    table = db.create_table(bench.make_schema().table_schema, rows=rows)
    return {"copy_bytes": sum(len(line) + 1 for line in table.encoded)}


async def _publication(db, state, *, name: str, row_filter: str | None,
                       offload: bool) -> None:
    """The publication of the table; with `row_filter`, that filter in the
    catalog (a COPY that spells it out applies it); with `offload`, the
    walsender ships every row and leaves the filter to the client."""
    from .. import bench

    filters = None
    if row_filter is not None:
        from ..ops.predicate import parse_row_filter

        allows = parse_row_filter(row_filter).compile_texts(
            bench.make_schema().table_schema)
        filters = {bench.PGBENCH_TID: (row_filter, allows)}
    db.create_publication(name, [bench.PGBENCH_TID], row_filters=filters)
    db.server_row_filtering = not offload


async def _prepare(db, state, *, n_events: int, seed: int,
                   first_aid: int) -> None:
    """INSERT payloads of `n_events` seeded rows, encoded before the
    window (`bench.table_payloads`)."""
    from .. import bench

    state["payloads"] = bench.table_payloads(
        bench.pgbench_table(n_events, seed, first_aid=first_aid))


async def _produce(db, state, *, tx_size: int) -> dict:
    from .. import bench

    payloads = state.pop("payloads")
    commits, times = [], []
    t0 = time.perf_counter()
    for lo in range(0, len(payloads), tx_size):
        tx = db.transaction()
        for p in payloads[lo:lo + tx_size]:
            tx.insert_preencoded(bench.PGBENCH_TID, p)
        lsn = int(await tx.commit())
        times.append(time.perf_counter())
        commits.append((lsn, lo, min(lo + tx_size, len(payloads))))
        # the walsender streams while the producer commits, as Postgres's
        # does: a commit does not yield the loop by itself
        await asyncio.sleep(0)
    return {"commits": commits, "times": times, "t0": t0,
            "t1": time.perf_counter()}


async def _slot(db, state, *, name: str) -> "dict | None":
    slot = db.slots.get(name)
    if slot is None:
        return None
    return {"confirmed_flush": int(slot.confirmed_flush),
            "active": slot.active}


async def _state(db, state, *, pipeline_id: int, table_id: int
                 ) -> "str | None":
    store = getattr(db, "_store_sql_db", None)
    if store is None:
        return None
    row = store.execute(
        "SELECT state FROM etl_replication_state WHERE pipeline_id = ? "
        "AND table_id = ? AND is_current = 1",
        (pipeline_id, table_id)).fetchone()
    return None if row is None else row[0]


_COMMANDS = {"table": _table, "publication": _publication,
             "prepare": _prepare, "produce": _produce, "slot": _slot,
             "state": _state}


if __name__ == "__main__":
    _child_main(sys.argv[1:])
