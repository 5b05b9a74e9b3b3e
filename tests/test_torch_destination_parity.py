"""The port's warehouse destinations held to the reference's on the wire.

1. Within the port (the reference's `TestClickHouseWireParity`,
   `TestBigQueryWireParity` and `TestSnowpipeNdjsonParity` of
   `tests/test_columnar_egress.py`): the columnar writes put the same
   bytes on the wire as the row path, on decoded batches with and
   without device-rendered text.
2. Across the packages: the same seeded events (numpy) go through the
   reference's decoder (JAX on the CPU) and destination, and through the
   port's decoder (`device="cpu"`: the kernels' plain versions) and
   destination, each against a fake HTTP server of either package: a
   copy write, a committed CDC write (two decoded batches and a per-row
   delete), the commit seam's recovery read, a truncate. The recorded
   requests (method, path, query, body) must be equal byte for byte in
   all four pairings. Masked: BigQuery's AppendRows `trace_id`, which
   embeds a random number; nothing else (the server's TCP port is in no
   recorded field, and the Snowpipe fake's continuation tokens count
   from one in both packages).
3. The slice as a whole: `run_replicator` with a `clickhouse` destination,
   the reference's and the port's, each over the port's fake Postgres
   server and ClickHouse fake (`testing.http_process`), on the CPU:
   the same rows and sequence keys arrive.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_destination*.py -q
"""

import asyncio
import importlib
import json
import logging
import os
import signal

import numpy as np
import pytest

from etl_tpu_torch.ops import engine
from etl_tpu_torch.ops.pipeline import reset_global_admission

REF, PORT = "etl_tpu", "etl_tpu_torch"
TID = 41070
SEED = 20261017


@pytest.fixture(autouse=True)
def _port_hygiene():
    yield
    engine.clear_forced_oracle()
    reset_global_admission()


def _m(pkg: str, sub: str):
    return importlib.import_module(f"{pkg}.{sub}")


def _retry_fast(pkg: str):
    return _m(pkg, "destinations.util").DestinationRetryPolicy(
        max_attempts=2, initial_delay_s=0.01, max_delay_s=0.02)


def _schema(pkg: str, tid: int = TID):
    M = _m(pkg, "models")
    return M.ReplicatedTableSchema.with_all_columns(M.TableSchema(
        tid, M.TableName("public", f"w{tid}"),
        (M.ColumnSchema("id", M.Oid.INT8, nullable=False,
                        primary_key_ordinal=1),
         M.ColumnSchema("v", M.Oid.INT4), M.ColumnSchema("d", M.Oid.DATE),
         M.ColumnSchema("ok", M.Oid.BOOL), M.ColumnSchema("note", M.Oid.TEXT))))


def _seeded_rows(n: int, start: int, seed: int) -> list:
    """Text fields of `n` rows, made with numpy from `seed`: int, date and
    bool fields with NULLs, notes with TSV/JSON escapes."""
    rng = np.random.default_rng(seed)
    v = rng.integers(-2**31, 2**31, n)
    days = rng.integers(-40_000, 40_000, n)
    ok = rng.integers(0, 3, n)
    nulls = rng.random((n, 3)) < 0.1
    out = []
    for i in range(n):
        date = (np.datetime64("2000-01-01") + int(days[i])).astype(str)
        out.append([
            str(start + i).encode(),
            None if nulls[i, 0] else str(int(v[i])).encode(),
            None if nulls[i, 1] else date.encode(),
            None if nulls[i, 2] else (b"t" if ok[i] else b"f"),
            f"note-{start + i}\t\"q\"\\{'é' * int(ok[i])}".encode()])
    return out


def _decoded(pkg: str, rows: list, encoder):
    """A batch of `rows` through `pkg`'s staging and decoder on the CPU,
    with `encoder`'s device text."""
    wal = _m(pkg, "ops.wal")
    enc = _m(pkg, "postgres.codec.pgoutput").encode_insert
    schema = _schema(pkg)
    staged = wal.stage_wal_batch(*wal.concat_payloads(
        [enc(TID, r) for r in rows]), 5).staged
    kw = {"device": "cpu"} if pkg == PORT else {}
    dec = _m(pkg, "ops.engine").DeviceDecoder(schema, egress=encoder,
                                              device_min_rows=1, **kw)
    return dec.decode(staged)


_EVENTS: dict = {}


def _events(pkg: str, encoder) -> dict:
    """The scenario's writes for `pkg`: a copy batch, two decoded CDC
    batches (the second with updates and deletes) and a per-row delete,
    their commit range, and a truncate; the same seeded rows for both
    packages."""
    key = (pkg, encoder)
    if key in _EVENTS:
        return _EVENTS[key]
    if pkg == REF:
        from tests.test_torch_runtime_parity import _fresh_reference_programs

        _fresh_reference_programs()
    M = _m(pkg, "models")
    base = _m(pkg, "destinations.base")
    schema = _schema(pkg)
    copy = _decoded(pkg, _seeded_rows(80, 1, SEED), encoder)

    def event(rows, lsn0, cts):
        b = _decoded(pkg, rows, encoder)
        n = b.num_rows
        return M.DecodedBatchEvent(
            M.Lsn(lsn0), M.Lsn(lsn0 + n), schema,
            change_types=np.asarray(cts, dtype=np.int8),
            commit_lsns=np.repeat(np.uint64(lsn0) + np.arange(
                4, dtype=np.uint64) * 0x100, -(-n // 4))[:n],
            tx_ordinals=np.tile(np.arange(-(-n // 4), dtype=np.uint64),
                                4)[:n], batch=b)

    ev1 = event(_seeded_rows(72, 1000, SEED + 1), 0x5000, [0] * 72)
    rng = np.random.default_rng(SEED + 2)
    ev2 = event(_seeded_rows(68, 2000, SEED + 3), 0x9000,
                rng.integers(0, 3, 68))
    delete = M.DeleteEvent(M.Lsn(0x9800), M.Lsn(0x9800), 0, schema,
                           M.TableRow([7, None, None, None, None]))
    cdc = [ev1, ev2, delete]
    _EVENTS[key] = {
        "schema": schema, "copy": copy, "cdc": cdc,
        "commit": base.CommitRange.from_events(cdc,
                                               commit_end_lsn=0x9900),
        "truncate": M.TruncateEvent(M.Lsn(0xA000), M.Lsn(0xA000), 1, 0,
                                    (schema,))}
    return _EVENTS[key]


# -- one scenario against one fake ---------------------------------------------


async def _scenario(dest, ev: dict) -> dict:
    await dest.startup()
    ack = await dest.write_table_batch(ev["schema"], ev["copy"])
    await ack.wait_durable()
    ack = await dest.write_event_batches_committed(ev["cdc"], ev["commit"])
    await ack.wait_durable()
    high = await dest.recover_high_water()
    ack = await dest.write_events([ev["truncate"]])
    await ack.wait_durable()
    await dest.shutdown()
    return {"high": None if high is None
            else [list(high.high), high.commit_end_lsn]}


async def _clickhouse(dest_pkg: str, fake_pkg: str) -> dict:
    ch = _m(dest_pkg, "destinations.clickhouse")
    server = _m(fake_pkg, "testing.fake_http").RecordingHttpServer()
    # the commit log's high-water read answers as ClickHouse would
    log: list = []

    def commit_log(rec):
        q = rec.query.get("query", "")
        if q.startswith("INSERT INTO") and "_etl_commit_log" in q:
            log.append(rec.body.decode().split("\t"))
        elif q.startswith("SELECT commit_lsn") and log:
            best = max(log, key=lambda r: (int(r[1]), int(r[2])))
            return (200, f"{best[1]}\t{best[2]}\t{best[3]}\n".encode())
        elif q.startswith("SELECT"):
            return (200, b"")
        return None

    server.responders.append(commit_log)
    await server.start()
    try:
        d = ch.ClickHouseDestination(
            ch.ClickHouseConfig(url=server.url(), database="etl"),
            _retry_fast(dest_pkg))
        out = await _scenario(d, _events(dest_pkg, "tsv"))
        out["requests"] = [(r.method, r.path, sorted(r.query.items()), r.body)
                           for r in server.requests]
        return out
    finally:
        await server.stop()


def _mask_trace(body: bytes) -> bytes:
    """An AppendRowsRequest with its `trace_id` (field 6, a random number
    in it) replaced by a fixed string."""
    from etl_tpu_torch.destinations import bq_proto

    trace = bq_proto.decode_append_rows_request(body).trace_id
    field = bq_proto.f_string(6, trace)
    assert body.endswith(field)
    return body[:-len(field)] + bq_proto.f_string(6, "<trace>")


async def _bigquery(dest_pkg: str, fake_pkg: str) -> dict:
    bq = _m(dest_pkg, "destinations.bigquery")
    server = _m(fake_pkg, "testing.fake_http").RecordingHttpServer()
    marker: dict = {}

    def commit_marker(rec):
        if "/tables/_etl_commit_marker" not in rec.path:
            return None
        if rec.method == "PATCH":
            marker.update(rec.json)
        return (200, dict(marker))

    server.responders.append(commit_marker)
    server.responders.append(_m(fake_pkg, "testing.fake_bq")
                             .StorageWriteFake())
    await server.start()
    try:
        d = bq.BigQueryDestination(
            bq.BigQueryConfig(project_id="p", dataset_id="ds",
                              base_url=server.url()), _retry_fast(dest_pkg))
        out = await _scenario(d, _events(dest_pkg, "tsv"))
        out["requests"] = [
            (r.method, r.path, sorted(r.query.items()),
             _mask_trace(r.body) if r.path.endswith(":appendRows")
             else r.body) for r in server.requests]
        return out
    finally:
        await server.stop()


async def _snowflake(dest_pkg: str, fake_pkg: str) -> dict:
    sf = _m(dest_pkg, "destinations.snowflake")
    server = _m(fake_pkg, "testing.fake_snowpipe").FakeSnowpipeServer()
    bodies: list = []
    insert = server._insert

    async def recorded(request):
        bodies.append(await request.read())
        return await insert(request)

    server._insert = recorded  # bound by start()'s routes
    await server.start()
    try:
        d = sf.SnowflakeDestination(sf.SnowflakeConfig(
            base_url=server.url(), account="acct", user="etl",
            database="DB", commit_poll_interval_s=0.01),
            _retry_fast(dest_pkg))
        out = await _scenario(d, _events(dest_pkg, "json"))
        out["requests"] = [(m, p, sorted(q.items()))
                           for m, p, q in server.requests]
        out["bodies"] = bodies
        out["statements"] = server.statements
        return out
    finally:
        await server.stop()


RUNS = {"clickhouse": _clickhouse, "bigquery": _bigquery,
        "snowflake": _snowflake}
PAIRINGS = [(PORT, PORT), (PORT, REF), (REF, PORT)]


class TestWireParityAcrossPackages:
    @pytest.mark.parametrize("dest_pkg,fake_pkg", PAIRINGS,
                             ids=["port-port", "port-ref", "ref-port"])
    @pytest.mark.parametrize("kind", sorted(RUNS))
    async def test_requests_equal_reference(self, kind, dest_pkg, fake_pkg):
        """The recorded requests of (destination, fake) equal those of the
        reference's destination against the reference's fake."""
        want = await RUNS[kind](REF, REF)
        got = await RUNS[kind](dest_pkg, fake_pkg)
        assert want["requests"] and got["requests"] == want["requests"]
        assert got["high"] == want["high"] is not None
        for k in ("bodies", "statements"):
            assert got.get(k) == want.get(k)

    @pytest.mark.parametrize("kind", sorted(RUNS))
    async def test_device_text_reaches_the_wire(self, kind):
        """Both packages' batches carried device-rendered text, so the
        parity above holds on the fast path, not on host renders only."""
        encoder = "json" if kind == "snowflake" else "tsv"
        for pkg in (REF, PORT):
            ev = _events(pkg, encoder)
            assert ev["copy"].device_egress is not None
            assert all(e.batch.device_egress is not None
                       for e in ev["cdc"][:2])


# -- within the port: the columnar writes against the row path ------------------


def _retry():
    return _retry_fast(PORT)


class TestClickHouseWireParity:
    @pytest.mark.parametrize("encoder", [None, "tsv"])
    async def test_cdc_bodies_byte_identical(self, encoder):
        from etl_tpu_torch.destinations.clickhouse import (
            ClickHouseConfig, ClickHouseDestination)
        from etl_tpu_torch.testing.fake_http import RecordingHttpServer

        events = _events(PORT, encoder)["cdc"][:2]

        async def run(method):
            server = RecordingHttpServer()
            await server.start()
            try:
                d = ClickHouseDestination(
                    ClickHouseConfig(url=server.url(), database="etl"),
                    _retry())
                await d.startup()
                await getattr(d, method)(events)
                await d.shutdown()
                return [r.body for r in server.requests
                        if "INSERT INTO" in r.query.get("query", "")]
            finally:
                await server.stop()

        legacy = await run("write_events")
        columnar = await run("write_event_batches")
        assert legacy and b"".join(legacy) == b"".join(columnar)

    @pytest.mark.parametrize("encoder", [None, "tsv"])
    async def test_copy_bodies_byte_identical(self, encoder):
        from etl_tpu_torch.destinations.clickhouse import (
            ClickHouseConfig, ClickHouseDestination)
        from etl_tpu_torch.testing.fake_http import RecordingHttpServer

        ev = _events(PORT, encoder)

        async def run(method):
            server = RecordingHttpServer()
            await server.start()
            try:
                d = ClickHouseDestination(
                    ClickHouseConfig(url=server.url(), database="etl"),
                    _retry())
                await d.startup()
                await getattr(d, method)(ev["schema"], ev["copy"])
                await d.shutdown()
                return [r.body for r in server.requests
                        if "INSERT INTO" in r.query.get("query", "")]
            finally:
                await server.stop()

        assert await run("write_table_rows") == \
            await run("write_table_batch")


class TestBigQueryWireParity:
    async def _bq(self):
        from etl_tpu_torch.testing.fake_bq import StorageWriteFake
        from etl_tpu_torch.testing.fake_http import RecordingHttpServer

        server = RecordingHttpServer()
        await server.start()
        fake = StorageWriteFake()
        server.responders.append(fake)
        return server, fake

    def _dest(self, server):
        from etl_tpu_torch.destinations.bigquery import (BigQueryConfig,
                                                         BigQueryDestination)

        return BigQueryDestination(BigQueryConfig(
            project_id="p", dataset_id="ds", base_url=server.url()),
            _retry())

    @pytest.mark.parametrize("encoder", [None, "tsv"])
    async def test_cdc_rows_byte_identical(self, encoder):
        events = _events(PORT, encoder)["cdc"][:2]

        async def run(method):
            server, fake = await self._bq()
            try:
                d = self._dest(server)
                await d.startup()
                ack = await getattr(d, method)(events)
                await ack.wait_durable()
                await d.shutdown()
                return [req.serialized_rows for _, req, _ in fake.appends]
            finally:
                await server.stop()

        legacy = await run("write_events")
        columnar = await run("write_event_batches")
        assert legacy and legacy == columnar

    @pytest.mark.parametrize("encoder", [None, "tsv"])
    async def test_copy_rows_byte_identical(self, encoder):
        ev = _events(PORT, encoder)

        async def run(method):
            server, fake = await self._bq()
            try:
                d = self._dest(server)
                await d.startup()
                ack = await getattr(d, method)(ev["schema"], ev["copy"])
                await ack.wait_durable()
                await d.shutdown()
                return [req.serialized_rows for _, req, _ in fake.appends]
            finally:
                await server.stop()

        assert await run("write_table_rows") == \
            await run("write_table_batch")


class TestSnowpipeNdjsonParity:
    """The port's columnar NDJSON (with and without device text) equals
    the row path's `json.dumps(_doc(...), separators=(",", ":"),
    ensure_ascii=False, allow_nan=False) + "\\n"` line for line, and a
    whole Snowpipe CDC write decompresses to those lines."""

    @staticmethod
    def _reference_lines(schema, batch, ops, seqs):
        from etl_tpu_torch.destinations.bigquery import encode_value
        from etl_tpu_torch.destinations.snowflake import (
            CDC_OPERATION_COLUMN, CDC_SEQUENCE_COLUMN)

        lines = []
        for i in range(batch.num_rows):
            doc = {c.schema.name: encode_value(c.value(i), c.schema.kind)
                   for c in batch.columns}
            doc[CDC_OPERATION_COLUMN] = \
                ops if isinstance(ops, str) else ops[i]
            doc[CDC_SEQUENCE_COLUMN] = \
                seqs if isinstance(seqs, str) else seqs[i]
            lines.append((json.dumps(doc, separators=(",", ":"),
                                     ensure_ascii=False, allow_nan=False)
                          + "\n").encode())
        return lines

    @pytest.mark.parametrize("encoder", [None, "json"])
    def test_engine_batch_byte_identical(self, encoder):
        from etl_tpu_torch.destinations.base import CoalescedBatch
        from etl_tpu_torch.destinations.snowflake import (
            encode_batch_ndjson, encode_batch_ndjson_fast,
            offset_token_batch)

        ev = _events(PORT, encoder)
        cb = CoalescedBatch(ev["cdc"][:1])
        n = cb.num_rows
        labels = ["insert" if i % 3 else "update" for i in range(n)]
        seqs = offset_token_batch(cb.commit_lsns, cb.tx_ordinals)
        want = self._reference_lines(ev["schema"], cb.batch, labels, seqs)
        assert encode_batch_ndjson(ev["schema"], cb.batch, labels,
                                   seqs) == want
        fast, used = encode_batch_ndjson_fast(ev["schema"], cb.batch, labels,
                                              seqs, egress=cb.egress)
        assert used == (encoder is not None) and fast == want

    async def test_cdc_write_decompresses_to_the_row_lines(self):
        import zstandard

        from etl_tpu_torch.destinations.snowflake import offset_token_batch

        got = await _snowflake(PORT, PORT)
        ev = _events(PORT, "json")
        ev1 = ev["cdc"][0]
        seqs = offset_token_batch(ev1.commit_lsns, ev1.tx_ordinals)
        want = b"".join(self._reference_lines(ev["schema"], ev1.batch,
                                              "insert", seqs))
        lines = b"".join(zstandard.ZstdDecompressor().decompress(
            b, max_output_size=1 << 24) for b in got["bodies"][1:])
        assert lines.startswith(want)


# -- the slice as a whole --------------------------------------------------------


@pytest.fixture
def root_logging():
    """`run_replicator` installs the process's log handlers (init_tracing):
    put the test process's back afterwards."""
    root = logging.getLogger()
    handlers, level = list(root.handlers), root.level
    yield
    root.handlers = handlers
    root.setLevel(level)


async def _replicate(pkg: str, tmp_path, copy_rows: int, txs: int) -> dict:
    """`pkg`'s `run_replicator` with a `clickhouse` destination over the
    port's fake Postgres server (in process) and ClickHouse fake (a child
    process): the copy of `copy_rows` pgbench rows, then `txs`
    transactions of 250 inserts, then SIGTERM. Returns the fake's report
    and the commit LSNs in commit order."""
    from etl_tpu_torch import bench
    from etl_tpu_torch.postgres.fake import FakeDatabase
    from etl_tpu_torch.testing.fake_pg_server import FakePgServer
    from etl_tpu_torch.testing.http_process import HttpServerProcess

    if pkg == REF:
        from tests.test_torch_runtime_parity import _fresh_reference_programs

        _fresh_reference_programs()
    else:
        reset_global_admission()
    replicator = _m(pkg, "replicator")
    db = FakeDatabase()
    db.create_table(bench.make_schema().table_schema,
                    rows=bench.table_text_rows(
                        bench.pgbench_table(copy_rows, SEED)))
    db.create_publication("pub", [bench.PGBENCH_TID])
    server = FakePgServer(db, password=bench.WIRE_PASSWORD)
    await server.start()
    fake = HttpServerProcess("clickhouse")
    config_dir = str(tmp_path / pkg / "config")
    metrics_port = bench.free_port()
    bench.write_replicator_config(
        config_dir, server_port=server.port, metrics_port=metrics_port,
        device="cpu", destination=fake.destination_doc(),
        store={"type": "sqlite", "path": str(tmp_path / pkg / "s.db")})
    if pkg == REF:  # the reference spells the engine `tpu`, has no device
        path = os.path.join(config_dir, "base.yaml")
        doc = json.load(open(path))
        doc["batch"] = {"max_fill_ms": 30, "batch_engine": "tpu"}
        json.dump(doc, open(path, "w"))
    env_key = "APP_PG_CONNECTION__PASSWORD"
    os.environ[env_key] = bench.WIRE_PASSWORD
    lsns = []
    try:
        task = asyncio.ensure_future(replicator.run_replicator(config_dir))

        async def count(key, want):
            async def done():
                if task.done():
                    task.result()
                got = await asyncio.to_thread(fake.call, "count")
                return got[key] >= want

            await bench._until(done, 90, f"{want} {key}", interval=0.05)

        await count("copy_rows", copy_rows)
        for k in range(txs):
            tx = db.transaction()
            for p in bench.table_payloads(bench.pgbench_table(
                    250, SEED + 1 + k, first_aid=copy_rows + 1 + 250 * k)):
                tx.insert_preencoded(bench.PGBENCH_TID, p)
            lsns.append(int(await tx.commit()))
        await count("cdc_rows", 250 * txs)
        os.kill(os.getpid(), signal.SIGTERM)
        await asyncio.wait_for(task, 60)
        return {"report": await asyncio.to_thread(fake.call, "report"),
                "lsns": lsns}
    finally:
        os.environ.pop(env_key, None)
        fake.close()
        await server.stop()


class TestSliceAgainstReference:
    async def test_clickhouse_replicator_delivers_what_the_reference_does(
            self, tmp_path, root_logging):
        """The same pgbench copy and CDC through the reference's binary and
        the port's into the ClickHouse fake: equal copied rows (count and
        digest), equal CDC rows by commit (count and digest), and the
        same (commit, ordinal, aid) sequence keys, each once."""
        runs = {}
        for pkg in (REF, PORT):
            runs[pkg] = await _replicate(pkg, tmp_path, 1200, 4)

        def summary(run):
            rep, lsns = run["report"], run["lsns"]
            (table,) = rep["tables"].values()
            index = {u: k for k, u in enumerate(lsns)}
            keys = sorted(zip((index[int(u)] for u in table["lsn"]),
                              table["ordinal"].tolist(),
                              table["aid"].tolist()))
            by_commit = {index.get(u, -1): v
                         for u, v in table["by_lsn"].items() if u}
            return {"copy": table["by_lsn"][0], "by_commit": by_commit,
                    "keys": keys, "dedup": rep["dedup_inserts"],
                    "seam": len(rep["commit_log"]) > 0}

        ref, port = summary(runs[REF]), summary(runs[PORT])
        assert port == ref
        assert port["copy"][0] == 1200 and len(port["keys"]) == 1000
        assert len(set(port["keys"])) == 1000
        assert sorted(port["by_commit"]) == [0, 1, 2, 3]
