"""The port's Postgres wire client (`etl_tpu_torch.postgres.{wire,client,
version}`), its socket-level fake server (`etl_tpu_torch.testing.
fake_pg_server`) and a pipeline over TCP, held to the reference's
tests/test_wire_client.py.

Each case builds the same seeded FakeDatabase once per package and runs
the same client calls over real TCP: the catalog answers, the
`ReplicatedTableSchema`s with their attached row predicate, the COPY
bytes, the replication frames' payload bytes and the SQL the client
issued must be equal, with no tolerance, for the reference's client on
the reference's server, the port's on the port's, and across the two
(the port's client against the reference's server and the other way
round), at Postgres 14, 15, 16 and 17 and under trust and SCRAM. md5
and cleartext auth run against a one-shot server that records what each
client sends; TLS against the fake server with a self-signed
certificate (skipped, with the reason, where `cryptography` is absent).
The pinned SCRAM transcript and pgoutput bytes are the reference's. A
pipeline over TCP (`device="cpu"`: the kernels' plain versions) copies,
streams, restarts, filters by the catalog's row filter in both of the
walsender's modes and survives a TCP partition through the chaos proxy:
its end state equals the reference pipeline's on the same workload.
"""

import asyncio
import base64
import hashlib
import hmac
import importlib
import struct
from types import SimpleNamespace

import numpy as np
import pytest

from etl_tpu_torch.chaos import failpoints
from etl_tpu_torch.ops import engine
from etl_tpu_torch.ops.pipeline import reset_global_admission

from tests.test_torch_runtime_parity import (ACCOUNTS, ORDERS, PGBENCH,
                                             _accounts_rows, _make_db, _pkg,
                                             _pgbench_rows, _row_events,
                                             _wait_for,
                                             _warm_reference_pyarrow,
                                             reduce_state)

REF, PORT = "etl_tpu", "etl_tpu_torch"
#: (client package, server package)
PAIRS = [(REF, REF), (PORT, PORT), (PORT, REF), (REF, PORT)]
PAIR_IDS = ["ref-ref", "port-port", "port-client-ref-server",
            "ref-client-port-server"]


@pytest.fixture(autouse=True)
def _port_hygiene():
    yield
    engine.clear_forced_oracle()
    failpoints.disarm_all()
    reset_global_admission()


def wire(name: str) -> SimpleNamespace:
    m = lambda sub: importlib.import_module(f"{name}.{sub}")  # noqa: E731
    return SimpleNamespace(
        name=name, server=m("testing.fake_pg_server"),
        client=m("postgres.client"), wire=m("postgres.wire"),
        version=m("postgres.version"), pgoutput=m("postgres.codec.pgoutput"),
        cfg=m("config"), proxy=m("testing.chaos_proxy"),
        errors=m("models.errors"))


def conn_config(name: str, port: int, password=None, **kw):
    return wire(name).cfg.PgConnectionConfig(
        host="127.0.0.1", port=port, name="postgres", username="etl",
        password=password, **kw)


def client_for(name: str, port: int, password=None, **kw):
    return wire(name).client.PgReplicationClient(
        conn_config(name, port, password, **kw))


async def start_server(name: str, db, **kw):
    server = wire(name).server.FakePgServer(db, **kw)
    await server.start()
    return server


def seeded_db(name: str, seed: int = 21):
    """accounts (40 rows, row filter `id <= 30`) and orders (12 rows,
    column list oid/amount, REPLICA IDENTITY FULL) in publication `pub`;
    a fixed commit clock, so Begin and Commit bytes repeat."""
    pkg = _pkg(name)
    db, _ = _make_db(pkg, seed, n_accounts=40, n_orders=12)
    db.create_publication(
        "pub", [ACCOUNTS, ORDERS], column_filters={ORDERS: ["oid", "amount"]},
        row_filters={ACCOUNTS: ("id <= 30", lambda r: int(r[0]) <= 30)})
    db.set_replica_identity(ORDERS, "f")
    db.clock_us = 1_700_000_000_000_000
    return db


def schema_plain(s) -> tuple:
    ts = s.table_schema
    pred = s.row_predicate
    return (int(ts.id), ts.name.schema, ts.name.name,
            tuple((c.name, int(c.type_oid), c.modifier, c.nullable,
                   c.primary_key_ordinal, c.default_expression)
                  for c in ts.columns),
            tuple(c.name for c in s.replicated_columns),
            tuple(c.name for c in s.identity_columns()),
            None if pred is None else pred.to_json())


async def catalog_transcript(client: str, server_pkg: str,
                             version: str = "16.3", password=None) -> dict:
    """Every call the runtime makes of the client, over TCP, reduced to
    plain data: catalog, schemas, a snapshot-pinned COPY of each table,
    the replication frames of one transaction and the slot after a
    standby status update."""
    db = seeded_db(server_pkg)
    server = await start_server(server_pkg, db, password=password,
                                server_version=version,
                                keepalive_interval_s=0.03)
    out: dict = {}
    try:
        c = client_for(client, server.port, password)
        await c.connect()
        out["version"] = c.server_version
        out["pub"] = (await c.publication_exists("pub"),
                      await c.publication_exists("nope"))
        tables = await c.get_publication_table_ids("pub")
        out["tables"] = tables
        out["schemas"] = [schema_plain(await c.get_table_schema(t, "pub"))
                          for t in tables]
        out["row_filters"] = await c.get_row_filters("pub")
        out["wal"] = str(await c.get_current_wal_lsn())
        out["stats"] = await c.estimate_table_stats(ACCOUNTS)
        out["recovery"] = await c.is_in_recovery()
        out["migrations"] = await c.applied_source_migrations()
        created = await c.create_slot("s1")
        out["slot"] = (created.name, str(created.consistent_point),
                       bool(created.snapshot_id))
        # after the snapshot: the COPY must not see these
        async with db.transaction() as tx:
            tx.insert(ACCOUNTS, ["99", "late", "0"])
            tx.update(ORDERS, ["1", None, None], ["1", "5.50", "2025-01-01"])
            tx.delete(ACCOUNTS, ["2", None, None])
        copies = {}
        for t in tables:
            stream = await c.copy_table_stream(t, "pub", created.snapshot_id)
            copies[t] = b"".join([chunk async for chunk in stream])
        out["copy"] = copies
        stream = await c.start_replication("s1", "pub",
                                           created.consistent_point)
        frames, commit_end = [], None
        async for f in stream:
            if type(f).__name__ == "XLogData":
                frames.append((int(f.start_lsn), f.payload))
                if f.payload[:1] == b"C":
                    commit_end = f.start_lsn
                    break
        out["frames"] = frames
        await stream.send_status_update(commit_end, commit_end, commit_end)
        await _wait_for(lambda: db.slots["s1"].confirmed_flush >= commit_end,
                        10)
        info = await c.get_slot("s1")
        out["slot_info"] = (str(info.confirmed_flush_lsn), info.invalidated)
        await stream.close()
        await c.delete_slot("s1")
        await c.delete_slot("s1")  # absent: no error
        out["slot_after_delete"] = await c.get_slot("s1")
        await c.close()
    finally:
        await server.stop()
    out["queries"] = list(server.queries)
    return out


class TestCatalogParity:
    @pytest.mark.parametrize("version", ["14.11", "15.4", "16.3", "17.0"])
    async def test_every_client_call_equal_across_packages(self, version):
        got = {pair: await catalog_transcript(*pair, version=version)
               for pair in PAIRS}
        ref = got[(REF, REF)]
        for pair, t in got.items():
            assert t == ref, pair
        assert ref["frames"] and ref["copy"][ACCOUNTS]
        accounts = ref["schemas"][0]
        orders = ref["schemas"][1]
        if version == "14.11":
            # no column lists or row filters before 15: every column,
            # every row, and the PG15-only catalog query never issued
            assert orders[4] == ("oid", "amount", "placed")
            assert accounts[6] is None and ref["row_filters"] == {}
            assert not any("pt.attnames" in q or "pt.rowfilter" in q
                           for q in ref["queries"])
            assert ref["copy"][ACCOUNTS].count(b"\n") == 40
        else:
            assert orders[4] == ("oid", "amount")
            assert accounts[6] is not None  # the parsed `id <= 30`
            assert ref["row_filters"] == {ACCOUNTS: "id <= 30"}
            assert ref["copy"][ACCOUNTS].count(b"\n") == 30

    @pytest.mark.parametrize("client,server_pkg", PAIRS, ids=PAIR_IDS)
    async def test_scram_transcript_equal(self, client, server_pkg):
        ref = await catalog_transcript(REF, REF, password="s3cret")
        got = await catalog_transcript(client, server_pkg, password="s3cret")
        assert got == ref

    @pytest.mark.parametrize("client,server_pkg", PAIRS, ids=PAIR_IDS)
    async def test_wrong_password_fails_typed(self, client, server_pkg):
        db = seeded_db(server_pkg)
        server = await start_server(server_pkg, db, password="s3cret")
        try:
            bad = client_for(client, server.port, password="wrong")
            with pytest.raises(wire(client).errors.EtlError) as ei:
                await bad.connect()
            assert ei.value.kind.name == "SOURCE_AUTH_FAILED"
        finally:
            await server.stop()

    async def test_slot_errors_typed(self):
        db = seeded_db(PORT)
        server = await start_server(PORT, db)
        try:
            c = client_for(PORT, server.port)
            await c.connect()
            await c.create_slot("dup")
            with pytest.raises(wire(PORT).errors.EtlError) as ei:
                await c.create_slot("dup")
            assert ei.value.kind.name == "SLOT_ALREADY_EXISTS"
            with pytest.raises(wire(PORT).errors.EtlError) as ei:
                await c.start_replication("missing", "pub",
                                          await c.get_current_wal_lsn())
            assert ei.value.kind.name == "SLOT_NOT_FOUND"
            await c.close()
        finally:
            await server.stop()

    def test_server_version_parse(self):
        from etl_tpu_torch.postgres.version import (POSTGRES_15,
                                                    meets_version,
                                                    parse_server_version)

        ref = wire(REF).version
        for raw in ("15.4", "16.3 (Debian 16.3-1)", "17beta1", "", "junk"):
            assert parse_server_version(raw) == ref.parse_server_version(raw)
        assert parse_server_version("16.3 (Debian 16.3-1)") == 160003
        assert meets_version(150004, POSTGRES_15)
        assert not meets_version(140011, POSTGRES_15)
        assert not meets_version(0, POSTGRES_15)


async def _one_shot_auth(code: int, salt: bytes = b"\x01\x02\x03\x04"):
    """A server that asks for cleartext (3) or md5 (5) auth once per
    connection and records the password message each client sends."""
    received: list = []

    async def handle(r, w):
        (n,) = struct.unpack(">i", await r.readexactly(4))
        await r.readexactly(n - 4)
        extra = salt if code == 5 else b""
        w.write(b"R" + struct.pack(">ii", 8 + len(extra), code) + extra)
        await w.drain()
        tag = await r.readexactly(1)
        (n,) = struct.unpack(">i", await r.readexactly(4))
        received.append(tag + await r.readexactly(n - 4))
        w.write(b"R" + struct.pack(">ii", 8, 0))
        w.write(b"Z" + struct.pack(">i", 5) + b"I")
        await w.drain()
        try:
            await r.read()
        finally:
            w.close()

    server = await asyncio.start_server(handle, "127.0.0.1", 0)
    return server, received


class TestPasswordAuth:
    @pytest.mark.parametrize("code", [3, 5], ids=["cleartext", "md5"])
    async def test_password_message_equal_and_correct(self, code):
        sent = {}
        for name in (REF, PORT):
            server, received = await _one_shot_auth(code)
            port = server.sockets[0].getsockname()[1]
            try:
                conn = wire(name).wire.PgWireConnection(
                    host="127.0.0.1", port=port, database="postgres",
                    user="etl", password="pencil")
                await conn.connect()
                await conn.close()
            finally:
                server.close()
                await server.wait_closed()
            sent[name] = received
        if code == 3:
            want = b"ppencil\x00"
        else:
            inner = hashlib.md5(b"pencil" + b"etl").hexdigest()
            want = b"pmd5" + hashlib.md5(
                inner.encode() + b"\x01\x02\x03\x04").hexdigest().encode() \
                + b"\x00"
        assert sent[PORT] == sent[REF] == [want]

    @pytest.mark.parametrize("code", [3, 5], ids=["cleartext", "md5"])
    async def test_password_required(self, code):
        server, _ = await _one_shot_auth(code)
        port = server.sockets[0].getsockname()[1]
        try:
            conn = wire(PORT).wire.PgWireConnection(
                host="127.0.0.1", port=port, database="postgres", user="etl")
            with pytest.raises(wire(PORT).errors.EtlError) as ei:
                await conn.connect()
            assert ei.value.kind.name == "SOURCE_AUTH_FAILED"
        finally:
            server.close()
            await server.wait_closed()


class TestWireTls:
    """The client's TLS path (the reference's sslmode=require) against the
    fake server with a self-signed certificate."""

    @pytest.fixture
    def cert(self):
        pytest.importorskip("cryptography", reason="the self-signed "
                            "certificate is made with `cryptography`, which "
                            "is not installed")
        from etl_tpu_torch.testing.tls import make_self_signed_cert

        return make_self_signed_cert()

    def _tls_client(self, name, port, cert_pem, password=None):
        tls = wire(name).cfg.TlsConfig(enabled=True,
                                       trusted_root_certs=cert_pem.decode())
        return client_for(name, port, password, tls=tls)

    @pytest.mark.parametrize("client,server_pkg", PAIRS, ids=PAIR_IDS)
    async def test_scram_and_catalog_over_tls(self, cert, client,
                                              server_pkg):
        db = seeded_db(server_pkg)
        server = await start_server(server_pkg, db, password="tls-secret",
                                    tls_cert=cert)
        try:
            c = self._tls_client(client, server.port, cert[0],
                                 password="tls-secret")
            await c.connect()
            assert c.server_version == 160003
            schema = await c.get_table_schema(ACCOUNTS, "pub")
            assert [col.name for col in schema.replicated_columns] == \
                ["id", "name", "balance"]
            await c.close()
        finally:
            await server.stop()

    async def test_server_refuses_tls_errors_typed(self, cert):
        server = await start_server(PORT, seeded_db(PORT))
        try:
            c = self._tls_client(PORT, server.port, cert[0])
            with pytest.raises(wire(PORT).errors.EtlError) as ei:
                await c.connect()
            assert ei.value.kind.name == "SOURCE_TLS_FAILED"
        finally:
            await server.stop()

    async def test_untrusted_ca_fails_verification(self, cert):
        from etl_tpu_torch.testing.tls import make_self_signed_cert

        other, _ = make_self_signed_cert()
        server = await start_server(PORT, seeded_db(PORT), tls_cert=cert)
        try:
            c = self._tls_client(PORT, server.port, other)
            with pytest.raises(wire(PORT).errors.EtlError) as ei:
                await c.connect()
            assert ei.value.kind.name == "SOURCE_TLS_FAILED"
        finally:
            await server.stop()


class TestGoldenTranscripts:
    """The reference's pinned bytes, on the port's client, server and
    codec."""

    @pytest.mark.parametrize("client,server_pkg",
                             [(PORT, PORT), (PORT, REF), (REF, PORT)],
                             ids=PAIR_IDS[1:])
    async def test_scram_exchange_matches_pinned_transcript(
            self, monkeypatch, client, server_pkg):
        conn_cls = wire(client).wire.PgWireConnection
        monkeypatch.setattr(conn_cls, "_scram_nonce_bytes",
                            staticmethod(lambda: bytes(range(18))))
        server = await start_server(server_pkg, seeded_db(server_pkg),
                                    password="pencil",
                                    scram_salt=bytes(range(16)),
                                    scram_nonce_tail="FIXEDSERVERNONCE")
        try:
            c = client_for(client, server.port, password="pencil")
            await c.connect()
            await c.close()
        finally:
            await server.stop()
        assert server.scram_transcript == [
            ("C", "n,,n=,r=AAECAwQFBgcICQoLDA0ODxAR"),
            ("S", "r=AAECAwQFBgcICQoLDA0ODxARFIXEDSERVERNONCE,"
                  "s=AAECAwQFBgcICQoLDA0ODw==,i=4096"),
            ("C", "c=biws,r=AAECAwQFBgcICQoLDA0ODxARFIXEDSERVERNONCE,"
                  "p=k1+3DsLb3BLeE7IUByi2TYW5Un24LiB+SdvlSjsO2QY="),
            ("S", "v=4DPyfFjArFn8MEqHF4h0GV+j4KCJmanPBOiXaZcs4kc="),
        ]
        salted = hashlib.pbkdf2_hmac("sha256", b"pencil", bytes(range(16)),
                                     4096)
        client_key = hmac.new(salted, b"Client Key", hashlib.sha256).digest()
        auth_message = (
            "n=,r=AAECAwQFBgcICQoLDA0ODxAR,"
            "r=AAECAwQFBgcICQoLDA0ODxARFIXEDSERVERNONCE,"
            "s=AAECAwQFBgcICQoLDA0ODw==,i=4096,"
            "c=biws,r=AAECAwQFBgcICQoLDA0ODxARFIXEDSERVERNONCE")
        sig = hmac.new(hashlib.sha256(client_key).digest(),
                       auth_message.encode(), hashlib.sha256).digest()
        proof = bytes(a ^ b for a, b in zip(client_key, sig))
        assert base64.b64encode(proof).decode() == \
            "k1+3DsLb3BLeE7IUByi2TYW5Un24LiB+SdvlSjsO2QY="

    def test_pgoutput_frame_bytes_pinned(self):
        from etl_tpu_torch.postgres.codec import pgoutput as pg

        assert pg.encode_begin(0x12345678, 1_700_000_000_000_000, 42).hex() \
            == "4200000000123456780002ad22dce660000000002a"
        assert pg.encode_insert(16384, [b"7", None, b"x"]).hex() \
            == "49000040004e00037400000001376e740000000178"
        assert pg.encode_commit(0x12345678, 0x12345680,
                                1_700_000_000_000_000).hex() \
            == "4300000000001234567800000000123456800002ad22dce66000"
        assert pg.encode_xlog_data(0x100, 0x200, 999, b"ABC").hex() \
            == "7700000000000001000000000000000200fffca2fec4c823e7414243"
        msg = pg.decode_logical_message(bytes.fromhex(
            "49000040004e00037400000001376e740000000178"))
        assert isinstance(msg, pg.InsertMessage)
        assert msg.new_tuple.values == [b"7", None, b"x"]


class TestCopyWriteBookkeeping:
    """The port's fake server writes a COPY's rows 512 to a `write()`,
    where the reference's writes each row on its own
    (`tests/torch_wire_copy_cost.py` times the two). On CPython 3.12 every
    `write()` that finds the transport's buffer non-empty sums the entries
    in it, so a reader that falls behind costs the server steps that grow
    with the square of its writes: they must grow with the chunks."""

    async def test_one_write_per_chunk_of_rows(self, monkeypatch):
        import asyncio.selector_events as se

        writes = [0]
        real = se._SelectorSocketTransport.write

        def counted(self, data):
            writes[0] += 1
            return real(self, data)

        pkg = _pkg(PORT)
        M = pkg.models
        n = 5_000
        db = pkg.fake.FakeDatabase()
        table = db.create_table(M.TableSchema(
            PGBENCH, M.TableName("public", "pgbench_accounts"),
            (M.ColumnSchema("aid", M.Oid.INT4, nullable=False,
                            primary_key_ordinal=1),
             M.ColumnSchema("bid", M.Oid.INT4),
             M.ColumnSchema("abalance", M.Oid.INT4),
             M.ColumnSchema("filler", M.Oid.BPCHAR, modifier=88))),
            rows=_pgbench_rows(np.random.default_rng(5), range(1, n + 1)))
        server = await start_server(PORT, db)
        conn = wire(PORT).wire.PgWireConnection(
            host="127.0.0.1", port=server.port, database="postgres",
            user="etl")
        try:
            await conn.connect()
            monkeypatch.setattr(se._SelectorSocketTransport, "write",
                                counted)
            got = [c async for c in conn.copy_out(
                'COPY (SELECT "aid", "bid", "abalance", "filler" FROM '
                '"public"."pgbench_accounts") TO STDOUT')]
            monkeypatch.undo()
        finally:
            await conn.close()
            await server.stop()
        assert got == [line + b"\n" for line in table.encoded]
        chunk = wire(PORT).server.COPY_CHUNK_ROWS
        # the client's query, then the server's CopyOutResponse, the
        # chunks, CopyDone, CommandComplete and ReadyForQuery
        assert writes[0] == 1 + 1 + -(-n // chunk) + 3


class TestDrainBufferedErrorFrame:
    """An 'E' frame mid-drain keeps the frames parsed before it; the error
    surfaces on the next drain."""

    def test_frames_before_error_survive(self):
        from etl_tpu_torch.postgres.client import _WireReplicationStream
        from etl_tpu_torch.postgres.codec.pgoutput import (
            PrimaryKeepalive, encode_primary_keepalive)
        from etl_tpu_torch.postgres.wire import PgServerError

        def copy_data(payload: bytes) -> bytes:
            return b"d" + (4 + len(payload)).to_bytes(4, "big") + payload

        fields = b"SERROR\x00C57P01\x00Mterminating connection\x00\x00"
        buf = bytearray(
            copy_data(encode_primary_keepalive(0x100, 1_000_000))
            + copy_data(encode_primary_keepalive(0x200, 2_000_000))
            + b"E" + (4 + len(fields)).to_bytes(4, "big") + fields
            + copy_data(encode_primary_keepalive(0x300, 3_000_000)))
        stream = _WireReplicationStream.__new__(_WireReplicationStream)
        stream._conn = SimpleNamespace(_reader=SimpleNamespace(_buffer=buf))
        stream._closed = False
        stream._pending_error = None
        out = stream.drain_buffered(10)
        assert [f.end_lsn for f in out] == [0x100, 0x200]
        assert all(isinstance(f, PrimaryKeepalive) for f in out)
        with pytest.raises(PgServerError, match="terminating"):
            stream.drain_buffered(10)
        assert [f.end_lsn for f in stream.drain_buffered(10)] == [0x300]


# -- a pipeline over TCP -------------------------------------------------------


def _tcp_pipeline(pkg, port, store, dest, *, defaults=False, **fields):
    """`pkg`'s Pipeline with its PgReplicationClient on 127.0.0.1:`port`;
    `defaults` keeps PipelineConfig's defaults (supervision and poison
    on)."""
    W = wire("etl_tpu_torch" if pkg.port else "etl_tpu")
    batch = dict(max_size_bytes=256 * 1024, max_fill_ms=30,
                 batch_engine=pkg.engine)
    if pkg.port:
        batch["device"] = "cpu"
    if not defaults:
        fields = dict(supervision=pkg.cfg.SupervisionConfig(enabled=False),
                      poison=pkg.cfg.PoisonConfig(enabled=False), **fields)
    conn = W.cfg.PgConnectionConfig(host="127.0.0.1", port=port,
                                    name="postgres", username="etl")
    config = pkg.cfg.PipelineConfig(
        pipeline_id=1, publication_name="pub", pg_connection=conn,
        batch=pkg.cfg.BatchConfig(**batch), **fields)
    return pkg.runtime.Pipeline(
        config=config, store=store, destination=dest,
        source_factory=lambda: W.client.PgReplicationClient(conn))


async def wire_copy_cdc_restart(client: str, server_pkg: str) -> dict:
    """Copy, CDC (inserts, updates, deletes; REPLICA IDENTITY FULL on
    orders) under the default config, shutdown, offline WAL, restart on
    the same store: no re-copy, no re-delivery."""
    pkg, spkg = _pkg(client), _pkg(server_pkg)
    db, rng = _make_db(spkg, seed=31, n_accounts=90, n_orders=30)
    db.create_publication("pub", [ACCOUNTS, ORDERS])
    db.set_replica_identity(ORDERS, "f")
    db.clock_us = 1_700_000_000_000_000
    server = await start_server(server_pkg, db, keepalive_interval_s=0.03)
    store, dest = pkg.store.NotifyingStore(), pkg.dest.MemoryDestination()
    try:
        p = _tcp_pipeline(pkg, server.port, store, dest, defaults=True)
        await p.start()
        for tid in (ACCOUNTS, ORDERS):
            await asyncio.wait_for(
                store.notify_on(tid, pkg.runtime.TableStateType.READY), 30)
        async with db.transaction() as tx:
            for r in _accounts_rows(rng, range(1000, 1080)):
                tx.insert(ACCOUNTS, r)
        async with db.transaction() as tx:
            for i in range(1, 21):
                tx.update(ACCOUNTS, [str(i), None, None],
                          [str(i), f"u{i}", str(i * 7)])
            for i in range(1, 6):
                tx.update(ORDERS, [str(i), None, None],
                          [str(i), f"{i}.5", "2025-01-01"])
            tx.delete(ACCOUNTS, ["50", None, None])
        await _wait_for(lambda: len(_row_events(dest)) >= 106)
        await p.shutdown_and_wait()
        async with db.transaction() as tx:
            for r in _accounts_rows(rng, range(2000, 2070)):
                tx.insert(ACCOUNTS, r)
        p2 = _tcp_pipeline(pkg, server.port, store, dest, defaults=True)
        await p2.start()
        await _wait_for(lambda: len(_row_events(dest)) >= 176)
        await asyncio.sleep(0.2)  # a re-delivered event would land here
        await p2.shutdown_and_wait()
    finally:
        await server.stop()
    return reduce_state(dest)


async def wire_catalog_filter(client: str, server_pkg: str,
                              offload: bool) -> dict:
    """pgbench_accounts under the catalog's row filter `bid <= 5`: the
    client reads it from pg_publication_tables (PG16), the COPY spells it
    out, and the walsender filters CDC itself or, offloaded, ships every
    row for the client's fused filter."""
    pkg, spkg = _pkg(client), _pkg(server_pkg)
    M = spkg.models
    rng = np.random.default_rng(33)
    db = spkg.fake.FakeDatabase()
    db.create_table(M.TableSchema(
        PGBENCH, M.TableName("public", "pgbench_accounts"),
        (M.ColumnSchema("aid", M.Oid.INT4, nullable=False,
                        primary_key_ordinal=1),
         M.ColumnSchema("bid", M.Oid.INT4),
         M.ColumnSchema("abalance", M.Oid.INT4),
         M.ColumnSchema("filler", M.Oid.BPCHAR, modifier=88))),
        rows=_pgbench_rows(rng, range(1, 201)))
    db.create_publication("pub", [PGBENCH], row_filters={
        PGBENCH: ("bid <= 5", lambda r: r[1] is not None
                  and int(r[1]) <= 5)})
    db.server_row_filtering = not offload
    db.clock_us = 1_700_000_000_000_000
    server = await start_server(server_pkg, db, keepalive_interval_s=0.03)
    store, dest = pkg.store.NotifyingStore(), pkg.dest.MemoryDestination()
    want = 0
    try:
        p = _tcp_pipeline(pkg, server.port, store, dest)
        await p.start()
        await asyncio.wait_for(
            store.notify_on(PGBENCH, pkg.runtime.TableStateType.READY), 30)
        for k in range(3):
            rows = _pgbench_rows(rng, range(1000 + 100 * k, 1100 + 100 * k))
            want += sum(int(r[1]) <= 5 for r in rows)
            async with db.transaction() as tx:
                for r in rows:
                    tx.insert(PGBENCH, r)
        await _wait_for(lambda: len(_row_events(dest)) >= want)
        await asyncio.sleep(0.2)  # a wrongly unfiltered row would land here
        await p.shutdown_and_wait()
    finally:
        await server.stop()
    state = reduce_state(dest)
    state["want_cdc"] = want
    return state


async def wire_partition(client: str, server_pkg: str) -> list:
    """A TCP partition through the chaos proxy mid-stream: the apply
    worker's retry reconnects and resumes from confirmed_flush. Returns
    the delivered inserts (commit LSN, ordinal, values), sorted."""
    pkg, spkg = _pkg(client), _pkg(server_pkg)
    db, rng = _make_db(spkg, seed=35, n_accounts=20, n_orders=5)
    db.create_publication("pub", [ACCOUNTS])
    server = await start_server(server_pkg, db, keepalive_interval_s=0.03)
    proxy = wire(client).proxy.ChaosProxy("127.0.0.1", server.port)
    await proxy.start()
    store, dest = pkg.store.NotifyingStore(), pkg.dest.MemoryDestination()
    p = _tcp_pipeline(pkg, proxy.port, store, dest,
                      apply_retry=pkg.cfg.RetryConfig(max_attempts=12,
                                                      initial_delay_ms=20))

    def inserted(ids) -> bool:
        got = {e.row.values[0] for e in _row_events(dest)}
        return set(ids) <= got

    try:
        await p.start()
        await asyncio.wait_for(
            store.notify_on(ACCOUNTS, pkg.runtime.TableStateType.READY), 30)
        for wave, ids in enumerate((range(500, 520), range(600, 620),
                                    range(700, 720))):
            async with db.transaction() as tx:
                for r in _accounts_rows(rng, ids):
                    tx.insert(ACCOUNTS, r)
            if wave == 1:
                proxy.sever()  # the rows of this wave cross the outage
            await _wait_for(lambda: inserted(ids), 20)
        assert proxy.severed >= 1
    finally:
        await p.shutdown_and_wait()
        await proxy.stop()
        await server.stop()
    return sorted((int(e.commit_lsn), e.tx_ordinal, tuple(e.row.values))
                  for e in _row_events(dest))


_REFERENCE_STATES: dict = {}


async def reference_state(scenario, *args) -> dict:
    """The reference's end state of `scenario(REF, REF, *args)`, run once
    a process: every case compares with the same state, and each run of
    the reference's pipeline risks its known crash in
    `_gather_string_arrow` (ROADMAP, reference caveats)."""
    key = (scenario.__name__, *args)
    if key not in _REFERENCE_STATES:
        _warm_reference_pyarrow()
        _REFERENCE_STATES[key] = await scenario(REF, REF, *args)
    return _REFERENCE_STATES[key]


class TestPipelineOverWire:
    @pytest.mark.parametrize("client,server_pkg", PAIRS[1:], ids=PAIR_IDS[1:])
    async def test_copy_cdc_restart_equals_reference(self, client,
                                                     server_pkg):
        ref = await reference_state(wire_copy_cdc_restart)
        got = await wire_copy_cdc_restart(client, server_pkg)
        assert got == ref
        assert len(ref["rows"][ACCOUNTS]) == 90
        inserts = [e for e in ref["events"] if e[0] == "InsertEvent"]
        assert len(inserts) == len({e[5] for e in inserts}) == 150

    @pytest.mark.parametrize("offload", [False, True],
                             ids=["walsender-filters", "offload"])
    async def test_catalog_row_filter_equals_reference_and_truth(
            self, offload):
        _warm_reference_pyarrow()
        ref = await wire_catalog_filter(REF, REF, offload)
        got = await wire_catalog_filter(PORT, PORT, offload)
        assert got == ref
        truth = np.random.default_rng(33)
        copied = [r for r in _pgbench_rows(truth, range(1, 201))
                  if int(r[1]) <= 5]
        assert [r[0] for r in got["rows"][PGBENCH]] == \
            sorted(int(r[0]) for r in copied)
        inserts = [e for e in got["events"] if e[0] == "InsertEvent"]
        assert len(inserts) == got["want_cdc"]
        assert all(e[5][1][1] <= 5 for e in inserts)

    async def test_tcp_partition_delivers_once_as_reference(self):
        ref = await wire_partition(REF, REF)
        got = await wire_partition(PORT, PORT)
        assert got == ref
        assert len(got) == len({v[2][0] for v in got}) == 60

    async def test_port_client_through_reference_proxy_and_server(self):
        got = await wire_partition(PORT, REF)
        assert len(got) == len({v[2][0] for v in got}) == 60
