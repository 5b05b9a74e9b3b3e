"""Socket-level fake Postgres backend for wire-client tests.

Speaks protocol v3 over real TCP: startup (trust or SCRAM-SHA-256), the
simple-query subset the framework issues (catalog introspection, slot
management, snapshot transactions, COPY OUT), and the replication
sub-protocol (CREATE/DROP_REPLICATION_SLOT, START_REPLICATION with
CopyBoth + standby status updates). Backed by the same FakeDatabase used
by the in-process fake source, so wire-level pipelines exercise identical
semantics.

This is the analogue of the reference's dockerized test clusters
(SURVEY §4.2) for an environment with no Postgres server, and of its mock
`K8sClient` pattern — the protocol seam is faked at the lowest level the
environment allows.

Copy of the reference's `etl_tpu/testing/fake_pg_server.py`, over the port's
`FakeDatabase` and `PostgresStore`; the names of the reference's control-
plane tables (its `api/db.py`, not ported) are copied here. It sends the
reference's bytes, but not a `write()` per message: COPY OUT writes the
CopyData of 512 rows at a time and yields the loop between them, and the
walsender writes up to 1,024 frames at a time. On CPython 3.12 each
`write()` that finds the transport's buffer non-empty sums the length of
every buffered chunk, so a message-by-message COPY that outruns its reader
costs the server time that grows with the square of its rows, while its
loop serves no other session (`tests/torch_wire_copy_cost.py` measures it).
"""

from __future__ import annotations

import asyncio
import base64
import hashlib
import hmac
import os
import re
import sqlite3
import struct
import time
from dataclasses import dataclass

from ..models.lsn import Lsn
from ..postgres import fake as fakemod
from ..postgres.codec import pgoutput
from ..postgres.codec.copy_text import encode_copy_row
from ..postgres.fake import FakeDatabase


# the reference's control-plane tables (its `api/db.py`), which the port
# does not have yet: the fake server still serves them as the reference's
API_TABLE_NAMES = ("api_tenants", "api_sources", "api_destinations",
                   "api_images", "api_pipelines")


def _msg(tag: bytes, payload: bytes = b"") -> bytes:
    return tag + struct.pack(">i", len(payload) + 4) + payload


def _cstr(s: str) -> bytes:
    return s.encode() + b"\x00"


def _error(code: str, message: str) -> bytes:
    payload = b"SERROR\x00" + b"C" + _cstr(code) + b"M" + _cstr(message) + b"\x00"
    return _msg(b"E", payload)


def _row_description(names: list[str], oids: list[int] | None = None) -> bytes:
    oids = oids or [25] * len(names)
    payload = struct.pack(">h", len(names))
    for name, oid in zip(names, oids):
        payload += _cstr(name) + struct.pack(">ihihih", 0, 0, oid, -1, -1, 0)
    return _msg(b"T", payload)


def _data_row(values: list[str | None]) -> bytes:
    payload = struct.pack(">h", len(values))
    for v in values:
        if v is None:
            payload += struct.pack(">i", -1)
        else:
            b = v.encode()
            payload += struct.pack(">i", len(b)) + b
    return _msg(b"D", payload)


def _command_complete(tag: str) -> bytes:
    return _msg(b"C", _cstr(tag))


READY = _msg(b"Z", b"I")

#: rows of a COPY's CopyData messages sent in one write
COPY_CHUNK_ROWS = 512
#: replication frames sent in one write
WAL_FRAMES_PER_WRITE = 1024


class _WireStreamHandle:
    """Chaos handle for a WIRE replication session.

    Registered in ``db.active_streams`` alongside the in-process
    ``_FakeReplicationStream`` handles so ``FakeDatabase.sever_streams()``
    (the NetworkChaos partition analogue, mirroring Chaos Mesh on
    replicator pods — reference xtask chaos) cuts TCP-backed sessions
    too: ``close()`` aborts the transport, so the client observes a hard
    connection reset mid-stream rather than a graceful CopyDone.
    """

    def __init__(self, writer: asyncio.StreamWriter):
        self._writer = writer

    async def close(self) -> None:
        transport = self._writer.transport
        if transport is not None:
            transport.abort()


@dataclass
class _Session:
    reader: asyncio.StreamReader
    writer: asyncio.StreamWriter
    replication: bool = False
    user: str = ""
    snapshot_id: str | None = None  # pinned via SET TRANSACTION SNAPSHOT
    # extended-protocol state (unnamed statement/portal only)
    ext_sql: str | None = None
    ext_params: "list[str | None]" = None  # type: ignore[assignment]
    # store-transaction ownership: the embedded store sqlite is shared
    # across sessions, so an open BEGIN..COMMIT holds the server's store
    # lock — exactly the observable serialization real PG applies to
    # same-row writers, without sqlite's shared-handle txn nesting errors
    holds_store_lock: bool = False


class FakePgServer:
    """asyncio TCP server; `await start()` then connect clients to
    `('127.0.0.1', server.port)`."""

    def __init__(self, db: FakeDatabase, *, password: str | None = None,
                 keepalive_interval_s: float = 0.05,
                 server_version: str = "16.3",
                 tls_cert: "tuple[bytes, bytes] | None" = None,
                 scram_salt: bytes | None = None,
                 scram_nonce_tail: str | None = None):
        self.db = db
        self.password = password  # None = trust auth
        self.keepalive_interval_s = keepalive_interval_s
        self.server_version = server_version
        # (cert_pem, key_pem): accept SSLRequest and upgrade; None = refuse
        self.tls_cert = tls_cert
        self._tls_ctx = None
        # fixed SCRAM parameters for golden-transcript tests (None = random)
        self.scram_salt = scram_salt
        self.scram_nonce_tail = scram_nonce_tail
        self.scram_transcript: list[tuple[str, str]] = []  # (dir, message)
        self._server: asyncio.AbstractServer | None = None
        self._store_lock = asyncio.Lock()
        self.allow_generic_sql = False  # devtools fill-table passthrough
        self.port = 0
        self.connections = 0
        self.queries: list[str] = []  # every simple-query SQL, in order
        self._writers: set[asyncio.StreamWriter] = set()

    @property
    def version_num(self) -> int:
        from ..postgres.version import parse_server_version

        return parse_server_version(self.server_version)

    async def start(self) -> None:
        self._server = await asyncio.start_server(self._handle, "127.0.0.1", 0)
        self.port = self._server.sockets[0].getsockname()[1]

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            # 3.12's wait_closed blocks until every handler exits — force
            # lingering client connections shut first
            for w in list(self._writers):
                w.close()
            await self._server.wait_closed()
            self._server = None

    # -- connection handling ---------------------------------------------------

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        self.connections += 1
        self._writers.add(writer)
        sess = _Session(reader, writer)
        try:
            if not await self._startup(sess):
                return
            while True:
                header = await reader.readexactly(5)
                tag = header[:1]
                (length,) = struct.unpack(">i", header[1:5])
                payload = await reader.readexactly(length - 4)
                if tag == b"X":
                    return
                if tag == b"Q":
                    sql = payload.rstrip(b"\x00").decode()
                    await self._dispatch(sess, sql)
                elif tag in (b"P", b"B", b"D", b"E", b"H", b"S"):
                    await self._extended(sess, tag, payload)
                # CopyData outside CopyBoth: ignore
        except (asyncio.IncompleteReadError, ConnectionResetError,
                BrokenPipeError):
            pass
        finally:
            if sess.holds_store_lock:
                # a client that died mid-transaction must not wedge every
                # other pooled connection (PG aborts the txn on disconnect)
                sess.holds_store_lock = False
                try:
                    db = getattr(self.db, "_store_sql_db", None)
                    if db is not None and db.in_transaction:
                        db.execute("ROLLBACK")
                except Exception:
                    pass
                self._store_lock.release()
            self._writers.discard(writer)
            writer.close()
            try:
                await writer.wait_closed()
            except (ConnectionResetError, BrokenPipeError, OSError):
                pass

    async def _startup(self, sess: _Session) -> bool:
        r = sess.reader
        w = sess.writer
        (length,) = struct.unpack(">i", await r.readexactly(4))
        body = await r.readexactly(length - 4)
        (version,) = struct.unpack(">i", body[:4])
        if version == 80877103:  # SSLRequest
            if self.tls_cert is None:
                w.write(b"N")  # refuse; client decides (require → error)
                await w.drain()
                return await self._startup(sess)
            w.write(b"S")
            await w.drain()
            if self._tls_ctx is None:
                import ssl as ssl_mod
                import tempfile

                ctx = ssl_mod.SSLContext(ssl_mod.PROTOCOL_TLS_SERVER)
                cert_pem, key_pem = self.tls_cert
                with tempfile.NamedTemporaryFile(suffix=".pem") as cf, \
                        tempfile.NamedTemporaryFile(suffix=".pem") as kf:
                    cf.write(cert_pem)
                    cf.flush()
                    kf.write(key_pem)
                    kf.flush()
                    ctx.load_cert_chain(cf.name, kf.name)
                self._tls_ctx = ctx
            loop = asyncio.get_event_loop()
            transport = w.transport
            new_transport = await loop.start_tls(
                transport, transport.get_protocol(), self._tls_ctx,
                server_side=True)
            if new_transport is None:  # client dropped mid-handshake
                return False
            w._transport = new_transport  # type: ignore[attr-defined]
            r._transport = new_transport  # type: ignore[attr-defined]
            return await self._startup(sess)
        params: dict[str, str] = {}
        parts = body[4:].split(b"\x00")
        for k, v in zip(parts[::2], parts[1::2]):
            if k:
                params[k.decode()] = v.decode()
        sess.user = params.get("user", "")
        sess.replication = params.get("replication") == "database"
        if self.password is not None:
            if not await self._scram(sess):
                return False
        w.write(_msg(b"R", struct.pack(">i", 0)))  # AuthenticationOk
        w.write(_msg(b"S", _cstr("server_version")
                     + _cstr(self.server_version)))
        w.write(_msg(b"S", _cstr("client_encoding") + _cstr("UTF8")))
        w.write(_msg(b"K", struct.pack(">ii", os.getpid(), 12345)))
        w.write(READY)
        await w.drain()
        return True

    async def _scram(self, sess: _Session) -> bool:
        r, w = sess.reader, sess.writer
        w.write(_msg(b"R", struct.pack(">i", 10) + _cstr("SCRAM-SHA-256")
                     + b"\x00"))
        await w.drain()
        header = await r.readexactly(5)
        (length,) = struct.unpack(">i", header[1:5])
        payload = await r.readexactly(length - 4)
        mech_end = payload.index(b"\x00")
        (resp_len,) = struct.unpack(">i", payload[mech_end + 1 : mech_end + 5])
        client_first = payload[mech_end + 5 :][:resp_len].decode()
        self.scram_transcript.append(("C", client_first))
        bare = client_first.split(",", 2)[2]
        client_nonce = dict(p.split("=", 1)
                            for p in bare.split(","))["r"]
        salt = self.scram_salt if self.scram_salt is not None \
            else os.urandom(16)
        iterations = 4096
        tail = self.scram_nonce_tail \
            if self.scram_nonce_tail is not None \
            else base64.b64encode(os.urandom(9)).decode()
        server_nonce = client_nonce + tail
        server_first = (f"r={server_nonce},"
                        f"s={base64.b64encode(salt).decode()},i={iterations}")
        self.scram_transcript.append(("S", server_first))
        w.write(_msg(b"R", struct.pack(">i", 11) + server_first.encode()))
        await w.drain()
        header = await r.readexactly(5)
        (length,) = struct.unpack(">i", header[1:5])
        client_final = (await r.readexactly(length - 4)).decode()
        self.scram_transcript.append(("C", client_final))
        attrs = dict(p.split("=", 1) for p in client_final.split(","))
        salted = hashlib.pbkdf2_hmac("sha256", self.password.encode(), salt,
                                     iterations)
        client_key = hmac.new(salted, b"Client Key", hashlib.sha256).digest()
        stored = hashlib.sha256(client_key).digest()
        without_proof = client_final.rsplit(",p=", 1)[0]
        auth_message = ",".join([bare, server_first, without_proof])
        sig = hmac.new(stored, auth_message.encode(), hashlib.sha256).digest()
        expected = bytes(a ^ b for a, b in zip(client_key, sig))
        if base64.b64decode(attrs.get("p", "")) != expected:
            w.write(_error("28P01", "password authentication failed"))
            await w.drain()
            return False
        server_key = hmac.new(salted, b"Server Key", hashlib.sha256).digest()
        verifier = hmac.new(server_key, auth_message.encode(),
                            hashlib.sha256).digest()
        final = f"v={base64.b64encode(verifier).decode()}"
        self.scram_transcript.append(("S", final))
        w.write(_msg(b"R", struct.pack(">i", 12) + final.encode()))
        return True

    # -- extended protocol (unnamed statement/portal) ---------------------------

    async def _extended(self, sess: _Session, tag: bytes,
                        payload: bytes) -> None:
        """Parse/Bind/Describe/Execute/Sync: the server binds parameters
        SERVER-side; execution happens at Sync by substituting quoted
        literals into the parsed statement and reusing the simple-query
        dispatch (the real server plans instead — same observable
        behavior for the statement shapes the framework issues)."""
        w = sess.writer
        if tag == b"P":
            zero = payload.index(b"\x00")
            rest = payload[zero + 1:]
            sess.ext_sql = rest[: rest.index(b"\x00")].decode()
            sess.ext_params = []
        elif tag == b"B":
            pos = payload.index(b"\x00") + 1  # portal name
            pos = payload.index(b"\x00", pos) + 1  # statement name
            (n_fmt,) = struct.unpack_from(">h", payload, pos)
            pos += 2 + 2 * n_fmt
            (n_params,) = struct.unpack_from(">h", payload, pos)
            pos += 2
            params: list[str | None] = []
            for _ in range(n_params):
                (ln,) = struct.unpack_from(">i", payload, pos)
                pos += 4
                if ln < 0:
                    params.append(None)
                else:
                    params.append(payload[pos : pos + ln].decode())
                    pos += ln
            sess.ext_params = params
        elif tag == b"S":
            if sess.ext_sql is None:
                w.write(READY)
                await w.drain()
                return
            params = sess.ext_params or []

            def lit(m: re.Match) -> str:
                v = params[int(m.group(1)) - 1]
                return "NULL" if v is None \
                    else "'" + v.replace("'", "''") + "'"

            # ONE pass over the original statement: bound values containing
            # "$n" text must never be re-substituted
            sql = re.sub(r"\$(\d+)", lit, sess.ext_sql)
            w.write(_msg(b"1"))  # ParseComplete
            w.write(_msg(b"2"))  # BindComplete
            sess.ext_sql = None
            sess.ext_params = None
            await self._dispatch(sess, sql)  # rows + tag + ReadyForQuery
        # D (describe) / E (execute) / H (flush): folded into Sync

    # -- SQL dispatch ------------------------------------------------------------

    async def _dispatch(self, sess: _Session, sql: str) -> None:
        w = sess.writer
        db = self.db
        norm = " ".join(sql.split())
        self.queries.append(norm)
        if self.version_num < 150000 and ("pt.attnames" in norm
                                          or "pt.rowfilter" in norm):
            # faithful PG14: publication column lists / row filters don't
            # exist — the catalog columns are absent, queries ERROR
            w.write(_error("42703",
                           'column pt.attnames does not exist'))
            w.write(READY)
            await w.drain()
            return
        try:
            handled = await self._try_handle(sess, norm, sql)
            if not handled and self.allow_generic_sql:
                handled = await self._try_generic_sql(sess, norm, sql)
        except Exception as e:  # surface as server error, keep session alive
            w.write(_error("XX000", f"fake server error: {e!r}"))
            w.write(READY)
            await w.drain()
            return
        if not handled:
            w.write(_error("0A000", f"fake server: unhandled SQL: {norm[:120]}"))
            w.write(READY)
        await w.drain()

    async def _try_generic_sql(self, sess: _Session, norm: str,
                               sql: str) -> bool:
        """Opt-in generic DDL/DML passthrough to the embedded sqlite — the
        devtools fill-table loader needs plain CREATE TABLE / INSERT /
        SELECT against arbitrary user tables (off by default so protocol
        tests still assert unhandled-SQL errors)."""
        first = norm.split(" ", 1)[0].upper() if norm else ""
        if first not in ("CREATE", "INSERT", "SELECT", "DROP", "DELETE"):
            return False
        db = self.db
        store = getattr(db, "_generic_sql_db", None)
        if store is None:
            store = sqlite3.connect(":memory:", check_same_thread=False)
            store.isolation_level = None
            db._generic_sql_db = store
        w = sess.writer
        # no lock needed: this sqlite is separate from the store's, every
        # execute is synchronous (no await between statements), and the
        # loader speaks autocommit statements only
        try:
            cur = store.execute(sql)
        except sqlite3.Error as e:
            w.write(_error("42601", f"generic sql: {e}"))
            w.write(READY)
            return True
        if cur.description is not None:
            names = [d[0] for d in cur.description]
            rows = [[None if v is None else str(v) for v in r]
                    for r in cur.fetchall()]
            self._send_rows(w, names, rows)
        else:
            tag = {"INSERT": f"INSERT 0 {cur.rowcount}",
                   "DELETE": f"DELETE {cur.rowcount}"}.get(first, first)
            w.write(_command_complete(tag))
            w.write(READY)
        return True

    async def _try_store_sql(self, sess: _Session, norm: str,
                             sql: str) -> bool:
        """Execute `etl` store-schema statements (PostgresStore over the
        wire) against an embedded per-database sqlite — the statements are
        the store's shared dialect, so sqlite semantics match; only the
        identity-column DDL spelling differs."""
        from ..store.sql import STORE_TABLE_NAMES

        w = sess.writer
        # the Postgres dialect schema-qualifies into `etl.` (reference
        # postgres_store layout); the embedded sqlite keeps flat names —
        # reverse the SAME table list the store qualifies, no drift.
        # Quote-aware: bound parameters arrive substituted as quoted
        # literals and must NEVER be rewritten (real Postgres binds
        # server-side and would not touch them).
        def unqualify(s: str) -> str:
            parts = s.split("'")
            for i in range(0, len(parts), 2):  # even = outside quotes
                for t in STORE_TABLE_NAMES:
                    parts[i] = parts[i].replace(f"etl.{t[4:]}", t)
            return "'".join(parts)

        norm = unqualify(norm)
        sql = unqualify(sql)
        first = norm.split(" ", 1)[0].upper() if norm else ""
        is_txn = first in ("BEGIN", "COMMIT", "ROLLBACK") and " " not in norm
        # the control-plane's api_* tables (the reference's api/db.py
        # PostgresApiDb) ride the same embedded-sqlite path, flat names,
        # no schema qualification — the API owns its own database there

        if not is_txn and not any(t in norm for t in STORE_TABLE_NAMES
                                  + API_TABLE_NAMES):
            return False
        if first == "ALTER" and ("SET SCHEMA etl" in norm
                                 or "RENAME TO" in norm):
            # the store's one-time legacy migration (SET SCHEMA + RENAME).
            # In the embedded sqlite's flat namespace the legacy and
            # migrated spellings coincide, so both steps are no-ops that
            # preserve seeded rows — the legacy-upgrade test pre-seeds
            # flat tables and asserts the store still reads them.
            w.write(_command_complete("ALTER TABLE"))
            w.write(READY)
            return True
        if first == "ALTER" and "ADD COLUMN" in norm.upper() \
                and any(t in norm for t in STORE_TABLE_NAMES
                        + API_TABLE_NAMES):
            # api AND store migrations use ALTER TABLE ... ADD COLUMN —
            # pass it to the embedded sqlite (same dialect),
            # duplicate-column errors surface for the client's
            # idempotence check
            pass
        elif first not in ("CREATE", "INSERT", "UPDATE", "DELETE",
                           "SELECT", "BEGIN", "COMMIT", "ROLLBACK"):
            return False
        db = self.db
        store = getattr(db, "_store_sql_db", None)
        if store is None:
            store = sqlite3.connect(":memory:", check_same_thread=False)
            store.isolation_level = None  # explicit BEGIN/COMMIT pass through
            db._store_sql_db = store
        # transaction serialization across pooled client connections: a
        # bare BEGIN holds the store lock until its COMMIT/ROLLBACK;
        # autocommit statements hold it per-statement. A failed statement
        # inside a transaction keeps the lock — the client still owns the
        # open transaction and will ROLLBACK.
        if not sess.holds_store_lock:
            await self._store_lock.acquire()
            sess.holds_store_lock = True
            release_after = first != "BEGIN"
        else:
            release_after = False
        if first in ("COMMIT", "ROLLBACK"):
            release_after = True

        def maybe_release() -> None:
            if release_after:
                sess.holds_store_lock = False
                self._store_lock.release()

        stmt = sql.replace("BIGINT GENERATED BY DEFAULT AS IDENTITY",
                           "INTEGER")
        # real Postgres supports `INSERT ... RETURNING id` everywhere;
        # the embedded sqlite only grew it in 3.35 — emulate the one
        # form the control plane uses so old runtimes stay faithful
        emulate_returning = (sqlite3.sqlite_version_info < (3, 35, 0)
                             and stmt.rstrip().lower()
                                 .endswith(" returning id"))
        if emulate_returning:
            stmt = stmt.rstrip()[:-len(" returning id")]
        try:
            cur = store.execute(stmt)
        except sqlite3.Error as e:
            maybe_release()
            w.write(_error("42601", f"store sql: {e}"))
            w.write(READY)
            return True
        maybe_release()
        if emulate_returning:
            self._send_rows(w, ["id"], [[str(cur.lastrowid)]])
        elif cur.description is not None:
            names = [d[0] for d in cur.description]
            rows = [[None if v is None else str(v) for v in r]
                    for r in cur.fetchall()]
            self._send_rows(w, names, rows)
        else:
            tag = {"INSERT": "INSERT 0 1", "UPDATE": f"UPDATE {cur.rowcount}",
                   "DELETE": f"DELETE {cur.rowcount}"}.get(first, first)
            w.write(_command_complete(tag))
            w.write(READY)
        return True

    async def _try_handle(self, sess: _Session, norm: str, sql: str) -> bool:
        w = sess.writer
        db = self.db

        if await self._try_store_sql(sess, norm, sql):
            return True

        if norm == "SELECT pg_is_in_recovery()":
            self._send_rows(w, ["pg_is_in_recovery"],
                            [["t" if db.is_standby else "f"]])
            return True
        if norm.startswith("SELECT name FROM etl.source_migrations"):
            if not db.applied_migrations:
                w.write(_error("42P01",
                               'relation "etl.source_migrations" does not '
                               "exist"))
                w.write(READY)
                return True
            self._send_rows(w, ["name"],
                            [[n] for n in sorted(db.applied_migrations)])
            return True
        if norm.startswith("CREATE SCHEMA IF NOT EXISTS etl"):
            # the source-migration SCRIPT (schema + functions + event
            # triggers, one multi-statement query) installs the trigger;
            # a bare CREATE SCHEMA (e.g. PostgresStore creating its own
            # schema) must NOT set the flag
            if "CREATE EVENT TRIGGER" in sql:
                db.ddl_trigger_installed = True
            w.write(_command_complete("CREATE SCHEMA"))
            w.write(READY)
            return True
        if norm.startswith("INSERT INTO etl.source_migrations"):
            m2 = re.search(r"VALUES \('([^']+)'\)", norm)
            if m2 and m2.group(1) not in db.applied_migrations:
                db.applied_migrations.append(m2.group(1))
            w.write(_command_complete("INSERT 0 1"))
            w.write(READY)
            return True

        m = re.match(r"SELECT 1 FROM pg_publication WHERE pubname = '([^']*)'",
                     norm)
        if m:
            rows = [["1"]] if m.group(1) in db.publications else []
            self._send_rows(w, ["?column?"], rows)
            return True

        if "FROM pg_publication_tables pt" in norm and "SELECT c.oid" in norm:
            m = re.search(r"pt\.pubname = '([^']*)'", norm)
            tids = db.publications.get(m.group(1), []) if m else []
            self._send_rows(w, ["oid"], [[str(t)] for t in sorted(tids)])
            return True

        m = re.match(r"SELECT n\.nspname, c\.relname, c\.relreplident .*"
                     r"WHERE c\.oid = (\d+)", norm)
        if m:
            t = db.tables.get(int(m.group(1)))
            rows = [[t.schema.name.schema, t.schema.name.name,
                     chr(t.replica_identity)]] if t else []
            self._send_rows(w, ["nspname", "relname", "relreplident"], rows)
            return True

        m = re.match(r"SELECT n\.nspname, c\.relname FROM pg_class c .*"
                     r"WHERE c\.oid = (\d+)", norm)
        if m:
            t = db.tables.get(int(m.group(1)))
            rows = [[t.schema.name.schema, t.schema.name.name]] if t else []
            self._send_rows(w, ["nspname", "relname"], rows)
            return True

        m = re.match(r"SELECT a\.attname FROM pg_attribute a WHERE "
                     r"a\.attrelid = (\d+)", norm)
        if m:
            t = db.tables.get(int(m.group(1)))
            rows = [[c.name] for c in t.schema.columns] if t else []
            self._send_rows(w, ["attname"], rows)
            return True

        m = re.search(r"SELECT a\.attname, a\.atttypid.*a\.attrelid = (\d+)",
                      norm)
        if m:
            t = db.tables.get(int(m.group(1)))
            rows = []
            if t:
                for c in t.schema.columns:
                    rows.append([c.name, str(c.type_oid), str(c.modifier),
                                 "t" if not c.nullable else "f",
                                 str(c.primary_key_ordinal or 0),
                                 c.default_expression])
            self._send_rows(w, ["attname", "atttypid", "atttypmod",
                                "attnotnull", "ord", "default"], rows)
            return True

        if "SELECT pc.oid, pt.rowfilter" in norm \
                and "FROM pg_publication_tables" in norm:
            pub = re.search(r"pt\.pubname = '([^']*)'", norm).group(1)
            rows = [[str(tid), sql]
                    for (p, tid), sql in db.row_filter_sql.items()
                    if p == pub and tid in db.publications.get(pub, [])]
            self._send_rows(w, ["oid", "rowfilter"], rows)
            return True

        if "SELECT pt.attnames" in norm \
                and "FROM pg_publication_tables" in norm:
            pub = re.search(r"pt\.pubname = '([^']*)'", norm).group(1)
            tid = int(re.search(r"pc\.oid = (\d+)", norm).group(1))
            filt = db.column_filters.get((pub, tid))
            attnames = "{" + ",".join(filt) + "}" if filt else None
            rowfilter = db.row_filter_sql.get((pub, tid))
            published = tid in db.publications.get(pub, [])
            rows = [[attnames, rowfilter]] if published else []
            self._send_rows(w, ["attnames", "rowfilter"], rows)
            return True

        if "FROM pg_replication_slots s" in norm and "LEFT JOIN" in norm:
            rows = []
            for slot in db.slots.values():
                rows.append([
                    slot.name, "t" if slot.active else "f",
                    "lost" if slot.invalidated else "reserved",
                    str(int(db.current_lsn) - int(slot.consistent_point)),
                    str(int(db.current_lsn) - int(slot.confirmed_flush)),
                    None, None, None, None])
            self._send_rows(w, ["slot_name", "active", "wal_status",
                                "restart_lag", "flush_lag", "safe_wal",
                                "write_ms", "flush_ms", "replay_ms"], rows)
            return True

        if norm == "SELECT pg_current_wal_lsn()":
            self._send_rows(w, ["pg_current_wal_lsn"], [[str(db.current_lsn)]])
            return True

        m = re.search(r"FROM pg_replication_slots WHERE slot_name = '([^']*)'",
                      norm)
        if m:
            s = db.slots.get(m.group(1))
            rows = []
            if s is not None:
                rows = [[str(s.confirmed_flush),
                         "t" if s.active else "f",
                         "lost" if s.invalidated else "reserved"]]
            self._send_rows(w, ["confirmed_flush_lsn", "active", "wal_status"],
                            rows)
            return True

        m = re.match(r'CREATE_REPLICATION_SLOT "([^"]+)" LOGICAL pgoutput',
                     norm)
        if m:
            name = m.group(1)
            if name in db.slots:
                w.write(_error("42710", f'slot "{name}" already exists'))
                w.write(READY)
                return True
            point = db.current_lsn
            sid = db.take_snapshot()
            db.slots[name] = fakemod._FakeSlot(
                name=name, consistent_point=point, confirmed_flush=point,
                snapshot_id=sid)
            self._send_rows(
                w, ["slot_name", "consistent_point", "snapshot_name",
                    "output_plugin"],
                [[name, str(point), sid, "pgoutput"]])
            return True

        m = re.match(r'DROP_REPLICATION_SLOT "([^"]+)"', norm)
        if m:
            if m.group(1) not in db.slots:
                w.write(_error("42704",
                               f'replication slot "{m.group(1)}" does not exist'))
                w.write(READY)
                return True
            db.slots.pop(m.group(1), None)
            w.write(_command_complete("DROP_REPLICATION_SLOT"))
            w.write(READY)
            return True

        if norm.startswith("BEGIN"):
            w.write(_command_complete("BEGIN"))
            w.write(READY)
            return True

        m = re.match(r"SET TRANSACTION SNAPSHOT '([^']*)'", norm)
        if m:
            sess.snapshot_id = m.group(1)
            w.write(_command_complete("SET"))
            w.write(READY)
            return True

        m = re.match(r"COPY \(SELECT (.+) FROM \"([^\"]+)\"\.\"([^\"]+)\""
                     r"(?: WHERE (?:ctid >= '\((\d+),0\)' AND ctid < "
                     r"'\((\d+),0\)')?(?: ?(?:AND )?\((.+)\))?)?"
                     r"\) TO STDOUT", norm)
        if m:
            await self._copy_out(sess, m)
            return True

        m = re.search(r"FROM pg_partition_tree\((\d+)\) pt", norm)
        if m:
            t = db.tables.get(int(m.group(1)))
            rows = []
            for leaf_id in (t.partition_leaves if t else []):
                leaf = db.tables[leaf_id]
                n = len(leaf.rows)
                rows.append([str(leaf_id), str(n), str(max(1, n // 64))])
            self._send_rows(w, ["oid", "greatest", "greatest"], rows)
            return True

        m = re.search(r"FROM pg_class WHERE oid = (\d+)", norm)
        if m and "reltuples" in norm:
            t = db.tables.get(int(m.group(1)))
            n = len(t.rows) if t else 0
            self._send_rows(w, ["reltuples", "relpages"],
                            [[str(n), str(max(1, n // 64))]])
            return True

        m = re.match(r'START_REPLICATION SLOT "([^"]+)" LOGICAL '
                     r"([0-9A-Fa-f]+/[0-9A-Fa-f]+) \((.*)\)", norm)
        if m:
            await self._start_replication(sess, m.group(1), Lsn(m.group(2)),
                                          m.group(3))
            return True

        return False

    def _send_rows(self, w, names: list[str],
                   rows: list[list[str | None]]) -> None:
        w.write(_row_description(names))
        for row in rows:
            w.write(_data_row(row))
        w.write(_command_complete(f"SELECT {len(rows)}"))
        w.write(READY)

    async def _copy_out(self, sess: _Session, m: re.Match) -> None:
        w = sess.writer
        db = self.db
        col_sql, schema_name, rel_name = m.group(1), m.group(2), m.group(3)
        lo = int(m.group(4)) if m.group(4) else None
        hi = int(m.group(5)) if m.group(5) else None
        table = next((t for t in db.tables.values()
                      if t.schema.name.schema == schema_name
                      and t.schema.name.name == rel_name), None)
        if table is None:
            w.write(_error("42P01", f"relation {rel_name} does not exist"))
            w.write(READY)
            return
        snap = db.snapshots.get(sess.snapshot_id or "", None)
        rows = snap.get(table.schema.id, ([], None))[0] \
            if snap is not None else table.rows
        # apply a row filter ONLY when the COPY SQL carried its predicate
        # (the walsender applies filters at send time; the snapshot COPY
        # must spell them out — a client that forgets gets unfiltered rows
        # here, so the regression is visible to tests)
        rowfilter_text = m.group(6)
        if rowfilter_text:
            pred = next(
                (fn for (pub, tid), sql_text in db.row_filter_sql.items()
                 if " ".join(sql_text.split()).lower()
                 == " ".join(rowfilter_text.split()).lower()
                 and (fn := db.row_filters.get((pub, tid))) is not None),
                None)
            if pred is None:
                w.write(_error("42601",
                               f"fake server: unknown row filter "
                               f"{rowfilter_text!r}"))
                w.write(READY)
                return
            rows = [r for r in rows if pred(r)]
        if lo is not None:
            rows = rows[lo * 64 : hi * 64]
        wanted = [c.strip().strip('"') for c in col_sql.split(",")]
        idx = [table.schema.column_index(c) for c in wanted]
        w.write(_msg(b"H", struct.pack(">bh", 0, len(idx))
                     + b"\x00\x00" * len(idx)))
        # one write per chunk of rows, and a turn of the loop between
        # chunks: a write per row costs the transport a scan of its
        # buffer per row once the reader falls behind (quadratic in the
        # rows), and the copy of one partition must not hold every other
        # session of this server
        for start in range(0, len(rows), COPY_CHUNK_ROWS):
            w.write(b"".join([
                _msg(b"d", encode_copy_row([row[i] for i in idx]) + b"\n")
                for row in rows[start:start + COPY_CHUNK_ROWS]]))
            await asyncio.sleep(0)
        w.write(_msg(b"c"))
        w.write(_command_complete(f"COPY {len(rows)}"))
        w.write(READY)
        await w.drain()

    async def _start_replication(self, sess: _Session, slot_name: str,
                                 start_lsn: Lsn, opts: str) -> None:
        w = sess.writer
        db = self.db
        slot = db.slots.get(slot_name)
        if slot is None:
            w.write(_error("42704", f'slot "{slot_name}" does not exist'))
            w.write(READY)
            await w.drain()
            return
        if slot.invalidated:
            w.write(_error("55000", "can no longer get changes from "
                           "replication slot (invalidated)"))
            w.write(READY)
            await w.drain()
            return
        m = re.search(r"publication_names '([^']*)'", opts)
        publication = m.group(1) if m else ""
        pub_tables = set(db.publications.get(publication, []))
        slot.active = True
        # register with the database's chaos hook: sever_streams() must
        # cut WIRE replication sessions too, not only in-process streams
        # (otherwise TCP-backed chaos scenarios partition nothing).
        # Registration happens inside the try so an early connection drop
        # (drain raising before the loop starts) still unregisters the
        # handle and resets slot.active in the finally.
        handle = _WireStreamHandle(w)
        pos = max(start_lsn, slot.confirmed_flush)
        wal_index = 0
        reader_task = asyncio.ensure_future(
            self._read_status_updates(sess, slot))
        try:
            db.active_streams.append(handle)
            w.write(_msg(b"W", struct.pack(">bh", 0, 0)))
            await w.drain()
            while not reader_task.done():
                frames: list = []
                while wal_index < len(db.wal):
                    lsn, payload, tid, row = db.wal[wal_index]
                    wal_index += 1
                    # inclusive of the requested start position (see
                    # fake.py note: BEGIN lands at the prior commit's end)
                    if lsn < pos:
                        continue
                    if not self._pub_allows(payload, pub_tables):
                        continue
                    if not db.row_filter_allows(publication, tid, row):
                        continue
                    frame = pgoutput.encode_xlog_data(
                        int(lsn), int(db.current_lsn),
                        int(time.time() * 1e6), payload)
                    frames.append(_msg(b"d", frame))
                    if len(frames) >= WAL_FRAMES_PER_WRITE:
                        # one write per batch of frames, as COPY OUT
                        # writes its rows
                        w.write(b"".join(frames))
                        frames.clear()
                        await w.drain()
                if frames:
                    w.write(b"".join(frames))
                    await w.drain()
                try:
                    async with db._wal_cond:
                        await asyncio.wait_for(
                            db._wal_cond.wait(),
                            timeout=self.keepalive_interval_s)
                except asyncio.TimeoutError:
                    if slot.invalidated:
                        return
                    # the sent position, not the server's end: WAL
                    # appended since the last read is not sent yet
                    ka = pgoutput.encode_primary_keepalive(
                        int(fakemod._sent_lsn(db, wal_index, pos)),
                        int(time.time() * 1e6), True)
                    w.write(_msg(b"d", ka))
                    await w.drain()
        except (ConnectionResetError, BrokenPipeError):
            pass
        finally:
            slot.active = False
            if handle in db.active_streams:
                db.active_streams.remove(handle)
            if not reader_task.done():
                reader_task.cancel()
            try:
                await reader_task
            except (asyncio.CancelledError, asyncio.IncompleteReadError,
                    ConnectionResetError):
                pass

    def _pub_allows(self, payload: bytes, pub_tables: set[int]) -> bool:
        tag = payload[0:1]
        if tag in (b"I", b"U", b"D", b"R"):
            rid = int.from_bytes(payload[1:5], "big")
            return rid in pub_tables
        if tag == b"T":
            n = int.from_bytes(payload[1:5], "big")
            rids = [int.from_bytes(payload[6 + 4 * i : 10 + 4 * i], "big")
                    for i in range(n)]
            return any(r in pub_tables for r in rids)
        return True

    async def _read_status_updates(self, sess: _Session,
                                   slot) -> None:
        """Drain incoming CopyData standby status updates ('r' frames)."""
        r = sess.reader
        while True:
            header = await r.readexactly(5)
            tag = header[:1]
            (length,) = struct.unpack(">i", header[1:5])
            payload = await r.readexactly(length - 4)
            if tag == b"d" and payload[:1] == b"r":
                upd = pgoutput.decode_standby_status_update(payload)
                if upd.flushed > slot.confirmed_flush:
                    slot.confirmed_flush = upd.flushed
            elif tag in (b"c", b"X"):
                return
