"""A warehouse destination's HTTP fake in a process of its own, driven
over a pipe: the HTTP counterpart of `pg_process.py`.

The fakes (`fake_http.RecordingHttpServer` with ClickHouse's SQL
interface, `fake_bq.StorageWriteFake` behind it for BigQuery,
`fake_snowpipe.FakeSnowpipeServer`) decode every request in Python. On
the replicator's event loop that work would be charged to the
replicator, so a measured run keeps the fake in a child process (a new
interpreter: it inherits no CUDA state). The child keeps no request body:
it tallies the `pgbench_accounts` rows of each write as it arrives and
answers what the destination's commit seam asks:

    with HttpServerProcess("clickhouse") as fake:
        doc = fake.destination_doc()   # the replicator's `destination`
        fake.call("watch", aids=[...])
        ...                            # replicate
        fake.call("count")             # {"copy_rows": n, "cdc_rows": n}
        report = fake.call("report")

Per data table the report holds the delivered rows and their digest
(`bench._rows_digest`, order-free) by commit LSN (0 for copied rows),
the (commit LSN, ordinal, aid) of every CDC row in arrival order (each
`_CHANGE_SEQUENCE_NUMBER`, or Snowpipe offset token, with the times it
arrived), each commit LSN's first arrival (`time.perf_counter()`, the
host's CLOCK_MONOTONIC, shared with the parent), and the delivered lines
(ClickHouse TSV, Snowpipe NDJSON) or decoded rows (BigQuery) of the
watched aids. Besides: the DDL statements, the commit seam's records
(ClickHouse `_etl_commit_log`, BigQuery's marker, Snowpipe's committed
offset tokens), inserts ClickHouse's `insert_deduplication_token` would
drop, and, for BigQuery, the requests whose rows the independent decoder
(`pb_reader`) read differently from `StorageWriteFake`.

ClickHouse's fake answers as the server would: a repeated
`insert_deduplication_token` inserts nothing, the commit-log SELECTs
read what the log holds. BigQuery's marker table keeps the description
PATCHed into it. Snowpipe commits each insert at once.
"""

from __future__ import annotations

import asyncio
import socket
import sys
import time

import numpy as np

from .pg_process import ServerProcess, _Channel

KINDS = ("clickhouse", "bigquery", "snowflake")


class HttpServerProcess(ServerProcess):
    """The child process of one fake (`kind` in KINDS)."""

    def __init__(self, kind: str, *, start_timeout_s: float = 120.0):
        if kind not in KINDS:
            raise ValueError(f"no HTTP fake for destination {kind!r}")
        self.kind = kind
        super().__init__("etl_tpu_torch.testing.http_process", [kind],
                         what=f"{kind} fake",
                         start_timeout_s=start_timeout_s)

    def url(self) -> str:
        return f"http://127.0.0.1:{self.port}"

    def destination_doc(self) -> dict:
        """The replicator's `destination` document for this fake."""
        if self.kind == "clickhouse":
            return {"type": "clickhouse", "url": self.url(),
                    "database": "etl"}
        if self.kind == "bigquery":
            return {"type": "bigquery", "project_id": "proj",
                    "dataset_id": "etl", "base_url": self.url()}
        return {"type": "snowflake", "base_url": self.url(),
                "account": "acct", "user": "etl", "database": "ETL",
                "private_key_pem": "", "commit_poll_interval_s": 0.01}


# -- the child -----------------------------------------------------------------


class _Table:
    """What arrived in one data table."""

    def __init__(self):
        self.by_lsn: dict = {}  # commit LSN → [rows, digest]
        self.keys: list = []  # per write: (lsn, ordinal, aid) arrays
        self.arrivals: dict = {}  # commit LSN → first arrival

    def add(self, values: list, lsns: list, txos: list) -> None:
        from .. import bench

        now = time.perf_counter()
        lsn = np.asarray(lsns, dtype=np.uint64)
        aids = np.asarray([v[0] for v in values], dtype=np.int64)
        for u in np.unique(lsn).tolist():
            rows = [values[i] for i in np.flatnonzero(lsn == u).tolist()]
            d = bench._rows_digest(*bench._rows_of(rows))
            tally = self.by_lsn.setdefault(u, [0, 0])
            tally[0] += len(rows)
            tally[1] = (tally[1] + d) % (1 << 64)
            self.arrivals.setdefault(u, now)
        cdc = lsn != 0
        if cdc.any():
            self.keys.append((lsn[cdc], np.asarray(txos, dtype=np.uint64)[
                cdc], aids[cdc]))

    def report(self) -> dict:
        def cat(k, dtype):
            return np.concatenate([p[k] for p in self.keys]) if self.keys \
                else np.zeros(0, dtype=dtype)

        return {"by_lsn": dict(self.by_lsn),
                "lsn": cat(0, np.uint64), "ordinal": cat(1, np.uint64),
                "aid": cat(2, np.int64), "arrivals": dict(self.arrivals)}


class _Sink:
    """The tallies of one fake, whatever its wire format."""

    def __init__(self):
        self.tables: dict = {}
        self.watch: set = set()
        self.watched: dict = {}  # aid → [delivered line or row]
        self.statements: list = []
        self.commit_log: list = []
        self.dedup_tokens: set = set()
        self.dedup_inserts = 0
        self.pb_mismatches = 0
        self.committed_tokens: dict = {}  # channel → [offset tokens]
        self.requests = 0
        self.body_bytes = 0

    def rows(self, table: str, values: list, lsns: list, txos: list,
             items: list) -> None:
        self.tables.setdefault(table, _Table()).add(values, lsns, txos)
        if self.watch:
            for v, item in zip(values, items):
                if v[0] in self.watch:
                    self.watched.setdefault(v[0], []).append(item)

    def count(self) -> dict:
        copy = cdc = 0
        for t in self.tables.values():
            for lsn, (n, _) in t.by_lsn.items():
                if lsn:
                    cdc += n
                else:
                    copy += n
        return {"copy_rows": copy, "cdc_rows": cdc}

    def report(self) -> dict:
        return {"tables": {k: t.report() for k, t in self.tables.items()},
                "watched": self.watched, "statements": self.statements,
                "commit_log": self.commit_log,
                "dedup_inserts": self.dedup_inserts,
                "pb_mismatches": self.pb_mismatches,
                "committed_tokens": self.committed_tokens,
                "requests": self.requests, "body_bytes": self.body_bytes}


def _seq_key(seq: str) -> tuple:
    """(commit LSN, ordinal) of a `%016x/%016x[/…]` sequence key."""
    return int(seq[0:16], 16), int(seq[17:33], 16)


def _tsv_field(raw: bytes) -> str:
    text = raw.decode()
    if "\\" not in text:
        return text
    return (text.replace("\\t", "\t").replace("\\n", "\n")
            .replace("\\r", "\r").replace("\\\\", "\\"))


class _ClickHouse:
    """Responder for ClickHouse's HTTP interface: `?query=` SQL, TSV
    bodies, the `_etl_commit_log` the destination's seam reads back."""

    def __init__(self, sink: _Sink):
        self.sink = sink

    def __call__(self, rec):
        sink = self.sink
        sql = rec.query.get("query", "")
        if sql.startswith("INSERT INTO"):
            table = sql.split("`")[3]
            if table == "_etl_commit_log":
                for line in rec.body.decode().splitlines():
                    token, lsn, ordinal, end, replay = line.split("\t")
                    sink.commit_log.append((token, int(lsn), int(ordinal),
                                            int(end), int(replay)))
                return (200, b"")
            token = rec.query.get("insert_deduplication_token")
            if token is not None:
                if token in sink.dedup_tokens:  # ClickHouse drops it
                    sink.dedup_inserts += 1
                    return (200, b"")
                sink.dedup_tokens.add(token)
            values, lsns, txos, items = [], [], [], []
            for line in rec.body.split(b"\n"):
                if not line:
                    continue
                f = line.split(b"\t")
                values.append((int(f[0]), int(f[1]), int(f[2]),
                               _tsv_field(f[3])))
                lsn, txo = _seq_key(f[-1].decode())
                lsns.append(lsn)
                txos.append(txo)
                items.append(line + b"\n")
            sink.rows(table, values, lsns, txos, items)
            return (200, b"")
        if sql.startswith("SELECT") and "_etl_commit_log" in sql:
            if "WHERE token = " in sql:
                token = sql.split("'")[1]
                n = sum(1 for r in sink.commit_log
                        if r[0] == token and r[4] == 1)
                return (200, f"{n}\n".encode())
            live = [r for r in sink.commit_log if r[4] == 0]
            if not live:
                return (200, b"")
            _, lsn, ordinal, end, _ = max(live, key=lambda r: (r[1], r[2]))
            return (200, f"{lsn}\t{ordinal}\t{end}\n".encode())
        sink.statements.append(sql)
        return (200, b"")


class _BigQuery:
    """Responders for BigQuery: the commit marker's description, then the
    Storage Write fake, whose decoded rows are tallied and dropped, each
    request's rows read again by `pb_reader`."""

    def __init__(self, sink: _Sink):
        from .fake_bq import StorageWriteFake

        self.sink = sink
        self.fake = StorageWriteFake()
        self.marker: dict = {}

    def __call__(self, rec):
        from . import pb_reader

        sink = self.sink
        if "/tables/_etl_commit_marker" in rec.path:
            if rec.method == "PATCH":
                self.marker.update(rec.json)
                sink.commit_log.append(rec.json.get("description"))
            return (200, dict(self.marker))
        if not rec.path.endswith(":appendRows"):
            sink.statements.append(f"{rec.method} {rec.path} "
                                   f"{rec.text[:200]}")
            return self.fake(rec)
        out = self.fake(rec)
        for table, _, rows in self.fake.appends:
            if pb_reader.decode_append_rows(rec.body)["rows"] != rows:
                sink.pb_mismatches += 1
            values, lsns, txos = [], [], []
            for r in rows:
                values.append((r["aid"], r["bid"], r["abalance"],
                               r["filler"]))
                lsn, txo = _seq_key(r["_CHANGE_SEQUENCE_NUMBER"])
                lsns.append(lsn)
                txos.append(txo)
            sink.rows(table, values, lsns, txos, rows)
        self.fake.appends.clear()
        self.fake.attempts.clear()
        return out


def _snowpipe_server(sink: _Sink):
    """A FakeSnowpipeServer (immediate commits) that tallies and drops
    each insert's rows and records each committed offset token."""
    from .fake_snowpipe import FakeSnowpipeServer

    class _Tallying(FakeSnowpipeServer):
        async def _insert(self, request):
            resp = await super()._insert(request)
            self.requests.clear()
            sink.requests += 1
            if resp.status != 200:
                return resp
            import zstandard

            key = self._key(request)
            sink.committed_tokens.setdefault(key, []).append(
                request.query["endOffsetToken"])
            body = await request.read()
            sink.body_bytes += len(body)
            lines = [ln + b"\n" for ln in zstandard.ZstdDecompressor()
                     .decompress(body, max_output_size=64 << 20)
                     .split(b"\n") if ln]
            for pipe, docs in self.rows.items():
                table = pipe.split("/")[2]
                values, lsns, txos = [], [], []
                for d in docs:
                    values.append((d["aid"], d["bid"], d["abalance"],
                                   d["filler"]))
                    lsn, txo = _seq_key(d["_cdc_sequence_number"])
                    lsns.append(lsn)
                    txos.append(txo)
                sink.rows(table, values, lsns, txos, lines)
            self.rows.clear()
            return resp

    return _Tallying(commit_mode="immediate")


def _child_main(argv: list) -> None:
    port, token, kind = int(argv[0]), argv[1], argv[2]
    chan = _Channel(socket.create_connection(("127.0.0.1", port)))
    chan.send(("ok", token))
    asyncio.run(_serve(chan, kind))


async def _serve(conn, kind: str) -> None:
    from .fake_http import RecordingHttpServer

    sink = _Sink()
    if kind == "snowflake":
        server = _snowpipe_server(sink)
    else:
        class _Unrecorded(RecordingHttpServer):
            """Keeps no request: each is tallied by the responders and
            dropped."""

            async def _handle(self, request):
                try:
                    return await super()._handle(request)
                finally:
                    sink.requests += 1
                    sink.body_bytes += sum(len(r.body)
                                           for r in self.requests)
                    self.requests.clear()

        # a copy chunk's body is ~7 MB at 62,500 pgbench rows
        server = _Unrecorded(client_max_size=256 << 20)
        server.responders.append(_ClickHouse(sink) if kind == "clickhouse"
                                 else _BigQuery(sink))
    await server.start()
    conn.send(("ok", server.port))
    loop = asyncio.get_running_loop()
    try:
        while True:
            cmd, kwargs = await loop.run_in_executor(None, conn.recv)
            if cmd == "stop":
                return
            try:
                if cmd == "watch":
                    sink.watch = {int(a) for a in kwargs["aids"]}
                    out = None
                elif cmd == "count":
                    out = sink.count()
                elif cmd == "report":
                    out = sink.report()
                else:
                    raise KeyError(cmd)
            # answered, not fatal to the server; no spin: each turn of the
            # loop waits for the parent's next command
            except Exception as e:  # etl-lint: ignore[unbounded-retry]
                conn.send(("error", f"{cmd}: {e!r}"))
                continue
            conn.send(("ok", out))
    finally:
        await server.stop()
        conn.close()


if __name__ == "__main__":
    _child_main(sys.argv[1:])
