"""The port's warehouse destinations (ClickHouse, BigQuery Storage Write,
Snowflake Snowpipe Streaming) against the port's HTTP fakes: the cases of
the reference's `tests/test_destinations.py` for these three, run on the
port's modules (`etl_tpu_torch`), plus the port's own rules: a failed
columnar render fails the write and posts nothing, the registry builds
the three, and the Parquet destinations where pyarrow imports (refused
typed, naming pyarrow, where it does not).

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_destination*.py -q
"""

import asyncio
import json

import pytest

from etl_tpu_torch.destinations.bigquery import (BigQueryConfig,
                                                 BigQueryDestination)
from etl_tpu_torch.destinations.clickhouse import (ClickHouseConfig,
                                                   ClickHouseDestination,
                                                   ClickHouseEngine,
                                                   create_current_view_sql,
                                                   create_table_sql)
from etl_tpu_torch.destinations.snowflake import (SnowflakeConfig,
                                                  SnowflakeDestination,
                                                  make_jwt)
from etl_tpu_torch.destinations.util import (DestinationRetryPolicy,
                                             escaped_table_name,
                                             versioned_table_name)
from etl_tpu_torch.models import (ChangeType, ColumnSchema, ColumnarBatch,
                                  DeleteEvent, InsertEvent, Lsn, Oid,
                                  PgNumeric, ReplicatedTableSchema,
                                  TableName, TableRow, TableSchema,
                                  TruncateEvent, UpdateEvent)
from etl_tpu_torch.testing.fake_bq import StorageWriteFake
from etl_tpu_torch.testing.fake_http import RecordingHttpServer
from etl_tpu_torch.testing.fake_snowpipe import FakeSnowpipeServer

TID = 700


async def bq_server():
    """RecordingHttpServer with a validating Storage Write proto fake."""
    server = RecordingHttpServer()
    fake = StorageWriteFake()
    server.responders.append(fake)
    await server.start()
    return server, fake


def make_schema():
    return ReplicatedTableSchema.with_all_columns(TableSchema(
        TID, TableName("public", "user_events"),
        (ColumnSchema("id", Oid.INT4, nullable=False, primary_key_ordinal=1),
         ColumnSchema("note", Oid.TEXT),
         ColumnSchema("amount", Oid.NUMERIC))))


def batch(rows):
    return ColumnarBatch.from_rows(make_schema(), [TableRow(r) for r in rows])


def ins(i, row, lsn=0x100):
    return InsertEvent(Lsn(lsn), Lsn(lsn), i, make_schema(), TableRow(row))


RETRY_FAST = DestinationRetryPolicy(max_attempts=3, initial_delay_s=0.01,
                                    max_delay_s=0.05)


class TestNaming:
    def test_escaped_names(self):
        assert escaped_table_name(TableName("public", "user_events")) == \
            "public_user__events"
        assert escaped_table_name(TableName("my_app", "t")) == "my__app_t"

    def test_versioned(self):
        assert versioned_table_name("t", 0) == "t"
        assert versioned_table_name("t", 3) == "t_3"


def make_schema():
    return ReplicatedTableSchema.with_all_columns(TableSchema(
        TID, TableName("public", "user_events"),
        (ColumnSchema("id", Oid.INT4, nullable=False, primary_key_ordinal=1),
         ColumnSchema("note", Oid.TEXT),
         ColumnSchema("amount", Oid.NUMERIC))))


def batch(rows):
    return ColumnarBatch.from_rows(make_schema(), [TableRow(r) for r in rows])


def ins(i, row, lsn=0x100):
    return InsertEvent(Lsn(lsn), Lsn(lsn), i, make_schema(), TableRow(row))


RETRY_FAST = DestinationRetryPolicy(max_attempts=3, initial_delay_s=0.01,
                                    max_delay_s=0.05)


class TestNaming:
    def test_escaped_names(self):
        assert escaped_table_name(TableName("public", "user_events")) == \
            "public_user__events"
        assert escaped_table_name(TableName("my_app", "t")) == "my__app_t"

    def test_versioned(self):
        assert versioned_table_name("t", 0) == "t"
        assert versioned_table_name("t", 3) == "t_3"


class TestClickHouse:
    def config(self, server):
        return ClickHouseConfig(url=server.url(), database="etl")

    def test_ddl_sql(self):
        sql = create_table_sql("etl", "t", make_schema(),
                               ClickHouseEngine.REPLACING_MERGE_TREE)
        assert "`id` Int32" in sql
        assert "`note` Nullable(String)" in sql
        assert "ReplacingMergeTree(`_CHANGE_SEQUENCE_NUMBER`)" in sql
        assert "ORDER BY (`id`)" in sql
        view = create_current_view_sql("etl", "t", make_schema())
        assert "FINAL" in view and "!= 'DELETE'" in view

    async def test_copy_and_cdc(self):
        server = RecordingHttpServer()
        await server.start()
        try:
            d = ClickHouseDestination(self.config(server), RETRY_FAST)
            await d.startup()
            await d.write_table_rows(make_schema(),
                                     batch([[1, "a", PgNumeric("1.5")],
                                            [2, None, None]]))
            ack = await d.write_events([
                ins(0, [3, "x\ty", PgNumeric("2")]),
                DeleteEvent(Lsn(0x110), Lsn(0x110), 1, make_schema(),
                            TableRow([1, None, None])),
            ])
            assert ack.is_durable
            qs = server.queries()
            assert any(q.startswith("CREATE DATABASE") for q in qs)
            assert any("CREATE TABLE IF NOT EXISTS" in q for q in qs)
            inserts = [r for r in server.requests
                       if "INSERT INTO" in r.query.get("query", "")]
            assert len(inserts) == 2
            body = inserts[0].text
            assert "1\ta\t1.5\tUPSERT" in body
            assert "2\t\\N\t\\N\tUPSERT" in body
            cdc = inserts[1].text
            assert "3\tx\\ty\t2\tUPSERT" in cdc
            assert "DELETE" in cdc
            await d.shutdown()
        finally:
            await server.stop()

    async def test_retry_on_transient(self):
        server = RecordingHttpServer()
        await server.start()
        try:
            server.fail_next = [503]
            d = ClickHouseDestination(self.config(server), RETRY_FAST)
            await d.startup()  # survives one 503
            assert len(server.requests) == 2
            await d.shutdown()
        finally:
            await server.stop()

    async def test_permanent_error_raises(self):
        from etl_tpu_torch.models.errors import ErrorKind, EtlError

        server = RecordingHttpServer()
        await server.start()
        try:
            server.fail_next = [400]
            d = ClickHouseDestination(self.config(server), RETRY_FAST)
            with pytest.raises(EtlError) as ei:
                await d.startup()
            # a definitive 4xx is the permanent REJECTED kind (the
            # poison-isolation trigger), not the ambiguous FAILED
            assert ei.value.kind is ErrorKind.DESTINATION_REJECTED
            await d.shutdown()
        finally:
            await server.stop()


class TestBigQuery:
    def config(self, server):
        return BigQueryConfig(project_id="p", dataset_id="ds",
                              base_url=server.url())

    async def test_copy_cdc_and_sequence_keys(self):
        server, fake = await bq_server()
        try:
            d = BigQueryDestination(self.config(server), RETRY_FAST)
            await d.startup()
            ack = await d.write_table_rows(make_schema(),
                                           batch([[1, "a", None]]))
            await ack.wait_durable()
            ack = await d.write_events([
                ins(0, [2, "b", PgNumeric("7")], lsn=0x900),
                DeleteEvent(Lsn(0x901), Lsn(0x901), 1, make_schema(),
                            TableRow([1, None, None])),
            ])
            assert not ack.is_durable  # Accepted: background append
            await ack.wait_durable()
            assert len(fake.appends) == 2
            # the fake DECODED the proto rows against the carried writer
            # schema; typed values round-tripped through the wire format
            rows = fake.appends[1][2]
            assert rows[0]["_CHANGE_TYPE"] == "UPSERT"
            assert rows[0]["id"] == 2 and rows[0]["note"] == "b"
            assert rows[0]["amount"] == "7"  # NUMERIC travels as text
            assert rows[1]["_CHANGE_TYPE"] == "DELETE"
            assert rows[1]["id"] == 1 and "note" not in rows[1]  # NULL omitted
            assert rows[0]["_CHANGE_SEQUENCE_NUMBER"] < \
                rows[1]["_CHANGE_SEQUENCE_NUMBER"]
            creates = [r for r in server.requests
                       if r.path.endswith("/tables")]
            assert creates[0].json["tableConstraints"]["primaryKey"][
                "columns"] == ["id"]
            await d.shutdown()
        finally:
            await server.stop()

    async def test_truncate_versioned_successor(self):
        server, fake = await bq_server()
        try:
            d = BigQueryDestination(self.config(server), RETRY_FAST)
            await d.startup()
            (await d.write_table_rows(make_schema(),
                                      batch([[1, "a", None]]))).is_durable
            await d.write_events([TruncateEvent(Lsn(1), Lsn(1), 0, 0,
                                                (make_schema(),))])
            ack = await d.write_events([ins(0, [5, "after", None])])
            await ack.wait_durable()
            paths = server.paths()
            # new generation table + repointed view + append to table_1
            assert any("/tables" in p for p in paths)
            assert any(p.endswith("/views") for p in paths)
            assert fake.appends[-1][0] == "public_user__events_1"
            assert fake.rows_for("public_user__events_1")[0]["id"] == 5
            await d.shutdown()
        finally:
            await server.stop()

    async def test_failed_append_fails_ack(self):
        from etl_tpu_torch.models.errors import EtlError

        server, fake = await bq_server()
        try:
            d = BigQueryDestination(self.config(server), RETRY_FAST)
            await d.startup()
            ack0 = await d.write_events([ins(0, [0, "warm", None])])
            await ack0.wait_durable()  # table now exists
            server.fail_next = [400]
            ack = await d.write_events([ins(1, [1, "x", None])])
            with pytest.raises(EtlError):
                await ack.wait_durable()
            await d.shutdown()
        finally:
            await server.stop()


class TestIndependentWireVerifiers:
    """Each wire client decoded by a reader that shares NO code with its
    encoder: AppendRows bytes through testing/pb_reader (a spec-written
    protobuf reader), Snowpipe bodies re-decoded from the recorded zstd
    NDJSON."""

    async def test_bq_append_rows_cross_decode(self):
        from etl_tpu_torch.testing import pb_reader

        server, fake = await bq_server()
        try:
            d = BigQueryDestination(
                BigQueryConfig(project_id="p", dataset_id="ds",
                               base_url=server.url()), RETRY_FAST)
            await d.startup()
            ack = await d.write_events([
                ins(0, [2, "b", PgNumeric("7")], lsn=0x900),
                DeleteEvent(Lsn(0x901), Lsn(0x901), 1, make_schema(),
                            TableRow([1, None, None])),
            ])
            await ack.wait_durable()
            raw = [r.body for r in server.requests
                   if r.path.endswith(":appendRows")]
            assert len(raw) == 1
            req = pb_reader.decode_append_rows(raw[0])
            # request frame
            assert req["write_stream"].endswith("/streams/_default")
            assert req["trace_id"]
            # descriptor: field numbers are ordinals+1, CDC columns after
            by_name = {f["name"]: f for f in req["descriptor"]["fields"]}
            assert by_name["id"]["number"] == 1
            assert by_name["_CHANGE_TYPE"]["number"] == 4
            # rows decoded purely from the wire + carried descriptor
            assert req["rows"][0]["id"] == 2
            assert req["rows"][0]["note"] == "b"
            assert req["rows"][0]["amount"] == "7"
            assert req["rows"][0]["_CHANGE_TYPE"] == "UPSERT"
            assert req["rows"][1]["id"] == 1
            assert "note" not in req["rows"][1]
            assert req["rows"][1]["_CHANGE_TYPE"] == "DELETE"
            # and it agrees with the in-repo decoder, field for field
            assert req["rows"] == fake.appends[0][2]
            await d.shutdown()
        finally:
            await server.stop()

    async def test_snowpipe_rejects_nonadvancing_offset_tokens(self):
        """The emulator re-decodes each zstd NDJSON body independently
        and now enforces strictly-advancing offset tokens per channel."""
        import zstandard
        import aiohttp

        server = FakeSnowpipeServer()
        await server.start()
        try:

            async def open_channel(s):
                async with s.put(
                        f"{server.url()}/v2/streaming/databases/d/schemas"
                        "/PUBLIC/pipes/P/channels/ch") as r:
                    return (await r.json())["next_continuation_token"]

            def body(rows):
                nd = "\n".join(json.dumps(r) for r in rows).encode()
                return zstandard.ZstdCompressor().compress(nd)

            headers = {"Content-Encoding": "zstd",
                       "Content-Type": "application/x-ndjson"}
            async with aiohttp.ClientSession() as s:
                ct = await open_channel(s)
                url = (f"{server.url()}/v2/streaming/data/databases/d/"
                       "schemas/PUBLIC/pipes/P/channels/ch/rows")
                async with s.post(
                        url, params={"continuationToken": ct,
                                     "offsetToken": "001",
                                     "endOffsetToken": "005"},
                        data=body([{"id": 1}]), headers=headers) as r:
                    assert r.status == 200
                    ct = (await r.json())["next_continuation_token"]
                # REGRESSING token: must be rejected
                async with s.post(
                        url, params={"continuationToken": ct,
                                     "offsetToken": "002",
                                     "endOffsetToken": "003"},
                        data=body([{"id": 2}]), headers=headers) as r:
                    assert r.status == 400
                    assert "advance" in (await r.json())["message"]
        finally:
            await server.stop()


class TestBigQueryStorageWrite:
    """Fault injection against the Storage Write proto wire format —
    reference retry/propagation semantics (bigquery/client.rs:317-450,
    551-650, 1224-1285)."""

    def config(self, server, timeout_s=5.0):
        return BigQueryConfig(
            project_id="p", dataset_id="ds", base_url=server.url(),
            storage_write_retry_timeout_s=timeout_s,
            storage_write_retry_delay_s=0.01,
            storage_write_max_retry_delay_s=0.05)

    async def _dest(self, server, **kw):
        d = BigQueryDestination(self.config(server, **kw), RETRY_FAST)
        await d.startup()
        return d

    async def test_proto_framing_round_trip(self):
        """Typed values survive the real proto wire format: ints as
        varints, numerics/dates as strings, floats as fixed64."""
        import datetime as dt

        from etl_tpu_torch.destinations import bq_proto

        schema = ReplicatedTableSchema.with_all_columns(TableSchema(
            TID, TableName("public", "wide"),
            (ColumnSchema("i", Oid.INT8, nullable=False,
                          primary_key_ordinal=1),
             ColumnSchema("f", Oid.FLOAT8),
             ColumnSchema("d", Oid.DATE),
             ColumnSchema("ts", Oid.TIMESTAMPTZ),
             ColumnSchema("tags", Oid.TEXT_ARRAY),
             ColumnSchema("ns", Oid.INT4_ARRAY))))
        row = bq_proto.encode_row(
            schema,
            [-(2**62), 1.5, dt.date(2024, 5, 1),
             dt.datetime(2024, 5, 1, 12, 0, tzinfo=dt.timezone.utc),
             ["a", "b"], [1, -2, 3]],
            "UPSERT", "0001/0002/0003")
        req = bq_proto.append_rows_request(
            "projects/p/datasets/ds/tables/wide/streams/_default",
            bq_proto.row_descriptor(schema), [row], "trace-1")
        decoded = bq_proto.decode_append_rows_request(req)
        rows = decoded.decode_rows()
        assert rows[0]["i"] == -(2**62)
        assert rows[0]["f"] == 1.5
        assert rows[0]["d"] == "2024-05-01"
        assert rows[0]["ts"] == 1714564800000000  # instant micros (int64)
        assert rows[0]["tags"] == ["a", "b"]
        assert rows[0]["ns"] == [1, -2, 3]
        assert rows[0]["_CHANGE_TYPE"] == "UPSERT"
        assert rows[0]["_CHANGE_SEQUENCE_NUMBER"] == "0001/0002/0003"
        assert decoded.trace_id == "trace-1"

    async def test_infinity_timestamptz_fails_fast(self):
        """'infinity' has no int64-micros instant: the encoder must raise
        a typed error, not emit a string into an INT64-declared field
        (validate-then-encode, reference validation.rs stance)."""
        from etl_tpu_torch.destinations import bq_proto
        from etl_tpu_torch.models.errors import ErrorKind, EtlError
        from etl_tpu_torch.postgres.codec.text import parse_cell_text

        schema = ReplicatedTableSchema.with_all_columns(TableSchema(
            TID, TableName("public", "ts"),
            (ColumnSchema("id", Oid.INT8, nullable=False,
                          primary_key_ordinal=1),
             ColumnSchema("at", Oid.TIMESTAMPTZ))))
        inf = parse_cell_text("infinity", Oid.TIMESTAMPTZ)
        with pytest.raises(EtlError) as ei:
            bq_proto.encode_row(schema, [1, inf], "UPSERT", "0/0/0")
        assert ei.value.kind is ErrorKind.ROW_CONVERSION_FAILED

    async def test_schema_propagation_retries_then_succeeds(self):
        """InvalidArgument + SCHEMA_MISMATCH_EXTRA_FIELDS in the status
        details is absorbed by the LOCAL retry loop (client.rs:557-579):
        the append succeeds once propagation completes, the ack resolves
        durable, and the same rows were re-sent."""
        from etl_tpu_torch.destinations import bq_proto

        server, fake = await bq_server()
        try:
            d = await self._dest(server)
            fake.script_status(
                bq_proto.GRPC_INVALID_ARGUMENT, "schema mismatch",
                bq_proto.STORAGE_ERROR_SCHEMA_MISMATCH_EXTRA_FIELDS,
                times=2)
            ack = await d.write_events([ins(0, [1, "x", None])])
            await ack.wait_durable()
            assert len(fake.attempts) == 3  # 2 rejected + 1 accepted
            assert len(fake.appends) == 1
            assert fake.appends[0][2][0]["id"] == 1
            await d.shutdown()
        finally:
            await server.stop()

    async def test_schema_propagation_message_form_retries(self):
        """Unstructured message fallback: 'missing in the proto message'
        without a storage error code still classifies as propagation."""
        from etl_tpu_torch.destinations import bq_proto

        server, fake = await bq_server()
        try:
            d = await self._dest(server)
            fake.script_status(
                bq_proto.GRPC_INVALID_ARGUMENT,
                "Input schema has more fields than BigQuery schema, "
                "extra proto fields: note2")
            ack = await d.write_events([ins(0, [1, "x", None])])
            await ack.wait_durable()
            assert len(fake.attempts) == 2
            await d.shutdown()
        finally:
            await server.stop()

    async def test_not_found_with_existing_table_retries(self):
        """Storage Write NOT_FOUND can be stale default-stream routing
        after delete/recreate: retry only when the table API confirms the
        table exists (client.rs:600-615)."""
        from etl_tpu_torch.destinations import bq_proto

        server, fake = await bq_server()
        try:
            d = await self._dest(server)
            fake.script_status(bq_proto.GRPC_NOT_FOUND,
                               "Requested entity was not found")
            ack = await d.write_events([ins(0, [1, "x", None])])
            await ack.wait_durable()
            assert len(fake.attempts) == 2
            # the probe hit the table API between attempts
            probes = [r for r in server.requests if r.method == "GET"
                      and "/tables/public_user__events" in r.path]
            assert probes
            await d.shutdown()
        finally:
            await server.stop()

    async def test_not_found_with_missing_table_fails(self):
        from etl_tpu_torch.destinations import bq_proto
        from etl_tpu_torch.models.errors import EtlError

        server, fake = await bq_server()
        try:
            d = await self._dest(server)
            ack0 = await d.write_events([ins(0, [0, "warm", None])])
            await ack0.wait_durable()
            fake.missing_tables.add("public_user__events")
            fake.script_status(bq_proto.GRPC_NOT_FOUND,
                               "Requested entity was not found")
            ack = await d.write_events([ins(1, [1, "x", None])])
            with pytest.raises(EtlError):
                await ack.wait_durable()
            await d.shutdown()
        finally:
            await server.stop()

    async def test_propagation_retry_window_bounded(self):
        """When BigQuery never accepts, the local window expires with the
        RETRYABLE kind so the worker-level timed policy takes over
        (client.rs:322-334)."""
        from etl_tpu_torch.destinations import bq_proto
        from etl_tpu_torch.models.errors import ErrorKind, EtlError

        server, fake = await bq_server()
        try:
            d = await self._dest(server, timeout_s=0.05)
            fake.script_status(
                bq_proto.GRPC_INVALID_ARGUMENT, "schema mismatch",
                bq_proto.STORAGE_ERROR_SCHEMA_MISMATCH_EXTRA_FIELDS,
                times=1000)
            ack = await d.write_events([ins(0, [1, "x", None])])
            with pytest.raises(EtlError) as ei:
                await ack.wait_durable()
            assert ei.value.kind is ErrorKind.DESTINATION_THROTTLED
            await d.shutdown()
        finally:
            await server.stop()

    async def test_row_errors_are_permanent(self):
        from etl_tpu_torch.models.errors import ErrorKind, EtlError

        server, fake = await bq_server()
        try:
            d = await self._dest(server)
            fake.script_row_error(0, 3, "invalid value")
            ack = await d.write_events([ins(0, [1, "x", None])])
            with pytest.raises(EtlError) as ei:
                await ack.wait_durable()
            # per-row refusal = the poison-pill trigger kind: the
            # isolation protocol bisects instead of blind-retrying
            assert ei.value.kind is ErrorKind.DESTINATION_REJECTED
            assert len(fake.attempts) == 1  # no retry for row errors
            await d.shutdown()
        finally:
            await server.stop()

    async def test_transient_grpc_code_maps_to_retryable_kind(self):
        from etl_tpu_torch.destinations import bq_proto
        from etl_tpu_torch.models.errors import ErrorKind, EtlError

        server, fake = await bq_server()
        try:
            d = await self._dest(server)
            fake.script_status(bq_proto.GRPC_UNAVAILABLE,
                               "Task is overloaded", times=1000)
            ack = await d.write_events([ins(0, [1, "x", None])])
            with pytest.raises(EtlError) as ei:
                await ack.wait_durable()
            # not locally retryable (not propagation/NOT_FOUND) — surfaces
            # immediately with the kind the worker retry policy times
            assert ei.value.kind is ErrorKind.DESTINATION_THROTTLED
            await d.shutdown()
        finally:
            await server.stop()


class TestSnowflake:
    """Against the protocol-enforcing Snowpipe emulator: stale
    continuation tokens 400, uncommitted rows 409, zstd NDJSON bodies
    required (reference snowflake/streaming/ wire surface)."""

    PIPE = "d/PUBLIC/PUBLIC_USER__EVENTS-STREAMING"

    def make_key(self):
        from cryptography.hazmat.primitives.asymmetric import rsa
        from cryptography.hazmat.primitives import serialization

        key = rsa.generate_private_key(public_exponent=65537, key_size=2048)
        return key.private_bytes(
            serialization.Encoding.PEM,
            serialization.PrivateFormat.PKCS8,
            serialization.NoEncryption()).decode()

    def config(self, server, **kw):
        kw.setdefault("commit_poll_interval_s", 0.005)
        kw.setdefault("commit_wait_timeout_s", 2.0)
        return SnowflakeConfig(base_url=server.url(), account="acct",
                               user="etl", database="d", **kw)

    async def dest(self, **server_kw):
        server = FakeSnowpipeServer(**server_kw)
        await server.start()
        d = SnowflakeDestination(self.config(server), RETRY_FAST)
        await d.startup()
        return server, d

    async def test_jwt_claims(self):
        cfg = SnowflakeConfig(base_url="http://x", account="acct",
                              user="etl", database="db",
                              private_key_pem=self.make_key())
        jwt = make_jwt(cfg)
        assert jwt.count(".") == 2
        import base64 as b64

        claims = json.loads(b64.urlsafe_b64decode(jwt.split(".")[1] + "=="))
        assert claims["sub"] == "ACCT.ETL"
        assert claims["iss"].startswith("ACCT.ETL.SHA256:")

    async def test_streaming_wire_shape(self):
        server = FakeSnowpipeServer(require_auth=True)
        await server.start()
        try:
            d = SnowflakeDestination(
                self.config(server, private_key_pem=self.make_key()),
                RETRY_FAST)
            await d.startup()
            await d.write_events([
                ins(0, [1, "sf", None], lsn=0x700),
                DeleteEvent(Lsn(0x700), Lsn(0x700), 1, make_schema(),
                            TableRow([1, None, None]))])
            # hostname discovered once, channel opened via PUT, rows
            # POSTed with the offset range in the query string
            assert server.hostname_discoveries == 1
            inserts = [q for m, p, q in server.requests
                       if p.endswith("/rows")]
            assert len(inserts) == 1
            assert inserts[0]["continuationToken"].startswith("ct-")
            assert inserts[0]["startOffsetToken"] == \
                f"{0x700:016x}/{0:016x}"
            assert inserts[0]["endOffsetToken"] == f"{0x700:016x}/{1:016x}"
            docs = server.rows[self.PIPE]
            assert docs[0]["_cdc_operation"] == "insert"
            assert docs[0]["_cdc_sequence_number"] == \
                f"{0x700:016x}/{0:016x}"
            assert docs[1]["_cdc_operation"] == "delete"
            assert docs[1]["id"] == 1
            # DDL went through the statements API with CDC columns
            create = [s for s in server.statements
                      if s.startswith("CREATE TABLE")][0]
            assert '"_cdc_operation" VARCHAR NOT NULL' in create
            assert '"_cdc_sequence_number" VARCHAR NOT NULL' in create
            await d.shutdown()
        finally:
            await server.stop()

    async def test_offset_token_dedup_on_redelivery(self):
        server, d = await self.dest()
        try:
            evs = [ins(0, [1, "x", None], lsn=0x800)]
            await d.write_events(evs)
            await d.write_events(evs)  # offsets <= committed → skipped
            rows_reqs = [p for _, p, _ in server.requests
                         if p.endswith("/rows")]
            assert len(rows_reqs) == 1
            assert len(server.rows[self.PIPE]) == 1
            await d.shutdown()
        finally:
            await server.stop()

    async def test_stale_continuation_reopens_and_retries(self):
        server, d = await self.dest()
        try:
            await d.write_events([ins(0, [1, "a", None], lsn=0x900)])
            # server rotates the token behind the client's back: next
            # insert gets 400 STALE_CONTINUATION_TOKEN_SEQUENCER, the
            # client must reopen the channel and resend
            server.rotate_continuation_once = True
            await d.write_events([ins(1, [2, "b", None], lsn=0x910)])
            assert [r["id"] for r in server.rows[self.PIPE]] == [1, 2]
            ch = next(iter(server.channels.values()))
            assert ch.epoch == 1  # exactly one reopen
            from etl_tpu_torch.telemetry.metrics import (
                ETL_SNOWPIPE_CHANNEL_RECOVERIES_TOTAL, registry)

            assert registry.get_counter(
                ETL_SNOWPIPE_CHANNEL_RECOVERIES_TOTAL) >= 1
            await d.shutdown()
        finally:
            await server.stop()

    async def test_copy_durability_barrier_polls_status(self):
        """commit_mode=on_poll: inserts do NOT commit until a status
        poll — write_table_rows must poll the durability barrier before
        acking, with synthetic 0/N copy offsets."""
        server, d = await self.dest(commit_mode="on_poll")
        try:
            ack = await d.write_table_rows(
                make_schema(), batch([[1, "a", None], [2, "b", None]]))
            assert ack.is_durable
            assert server.status_polls >= 1
            inserts = [q for m, p, q in server.requests
                       if p.endswith("/rows")]
            assert inserts[0]["startOffsetToken"] == f"{0:016x}/{1:016x}"
            ch = next(iter(server.channels.values()))
            assert ch.committed == f"{0:016x}/{1:016x}"
            # streaming after the barrier works and commits
            await d.write_events([ins(0, [3, "c", None], lsn=0xA00)])
            assert [r["id"] for r in server.rows[self.PIPE]] == [1, 2, 3]
            await d.shutdown()
        finally:
            await server.stop()

    async def test_copy_requires_reset_channel(self):
        """A channel with foreign committed offsets cannot host a table
        copy (channel.rs:461-467) — truncate resets it first."""
        server, d = await self.dest()
        try:
            await d.write_events([ins(0, [1, "x", None], lsn=0xB00)])
            from etl_tpu_torch.models.errors import EtlError

            with pytest.raises(EtlError, match="reset channel"):
                await d.write_table_rows(make_schema(),
                                         batch([[2, "y", None]]))
            await d.truncate_table(TID)
            ack = await d.write_table_rows(make_schema(),
                                           batch([[2, "y", None]]))
            assert ack.is_durable
            await d.shutdown()
        finally:
            await server.stop()

    async def test_401_invalidates_and_resigns_token(self):
        server = FakeSnowpipeServer(require_auth=True)
        await server.start()
        try:
            d = SnowflakeDestination(
                self.config(server, private_key_pem=self.make_key()),
                RETRY_FAST)
            await d.startup()
            server.fail_next.append((401, '{"message": "expired"}'))
            await d.write_events([ins(0, [1, "t", None], lsn=0xC00)])
            assert len(server.rows[self.PIPE]) == 1
            await d.shutdown()
        finally:
            await server.stop()

    async def test_batch_splitting_under_api_limit(self):
        import random

        server, d = await self.dest()
        try:
            rng = random.Random(3)
            evs = [ins(i, [i, "".join(chr(rng.randrange(33, 127))
                                      for _ in range(120_000)), None],
                       lsn=0xD00 + i)
                   for i in range(60)]
            await d.write_events(evs)
            inserts = [p for _, p, _ in server.requests
                       if p.endswith("/rows")]
            assert len(inserts) > 1  # ~7MB of incompressible text split
            assert len(server.rows[self.PIPE]) == 60
            await d.shutdown()
        finally:
            await server.stop()

    async def test_restart_drop_recovers_name_and_channel(self):
        """A restarted process has empty name mappings; drop_table with
        the stored-schema hint must still drop the SQL table AND the
        server-side channel, or the re-copy hard-fails on foreign
        committed offsets."""
        server, d = await self.dest()
        try:
            await d.write_events([ins(0, [1, "x", None], lsn=0xF00)])
            await d.shutdown()
            # "restart": fresh destination, no in-memory mappings
            d2 = SnowflakeDestination(self.config(server), RETRY_FAST)
            await d2.startup()
            await d2.drop_table(TID, make_schema())
            assert not server.channels  # server-side channel dropped
            assert any(s.startswith("DROP TABLE")
                       for s in server.statements)
            ack = await d2.write_table_rows(make_schema(),
                                            batch([[2, "y", None]]))
            assert ack.is_durable
            await d2.shutdown()
        finally:
            await server.stop()

    async def test_concurrent_copy_partitions_serialize(self):
        """Parallel copy partitions share one table channel; the per-table
        lock must serialize the continuation-token chain (no stale-token
        reopens)."""
        server, d = await self.dest()
        try:
            import asyncio as aio

            chunks = [batch([[i * 10 + j, f"r{i}{j}", None]
                             for j in range(5)]) for i in range(4)]
            acks = await aio.gather(*(
                d.write_table_rows(make_schema(), c) for c in chunks))
            assert all(a.is_durable for a in acks)
            assert len(server.rows[self.PIPE]) == 20
            ch = next(iter(server.channels.values()))
            assert ch.epoch == 0  # no stale-continuation recoveries
            await d.shutdown()
        finally:
            await server.stop()

    async def test_truncate_resets_server_side_offsets(self):
        server, d = await self.dest()
        try:
            evs = [ins(0, [1, "x", None], lsn=0xE00)]
            await d.write_events(evs)
            await d.truncate_table(TID)
            await d.write_events(evs)  # same offsets accepted again
            assert len(server.rows[self.PIPE]) == 2
            await d.shutdown()
        finally:
            await server.stop()


class TestWalOrderBarriers:
    """Rows preceding a truncate inside ONE write_events batch must land
    before the truncate executes (barrier reordering)."""

    def mixed_batch(self):
        return [
            ins(0, [1, "pre", None], lsn=0x9000),
            TruncateEvent(Lsn(0x9010), Lsn(0x9010), 1, 0, (make_schema(),)),
            ins(2, [2, "post", None], lsn=0x9020),
        ]

    async def test_clickhouse_order(self):
        server = RecordingHttpServer()
        await server.start()
        try:
            d = ClickHouseDestination(
                ClickHouseConfig(url=server.url(), database="etl"),
                RETRY_FAST)
            await d.startup()
            await d.write_events(self.mixed_batch())
            ops = []
            for r in server.requests:
                q = r.query.get("query", "")
                if "INSERT INTO" in q:
                    ops.append(("insert", r.text))
                elif q.startswith("TRUNCATE"):
                    ops.append(("truncate", ""))
            kinds = [k for k, _ in ops]
            assert kinds == ["insert", "truncate", "insert"], kinds
            assert "pre" in ops[0][1] and "post" in ops[2][1]
            await d.shutdown()
        finally:
            await server.stop()

    async def test_bigquery_order(self):
        server, fake = await bq_server()
        try:
            d = BigQueryDestination(
                BigQueryConfig(project_id="p", dataset_id="ds",
                               base_url=server.url()), RETRY_FAST)
            await d.startup()
            ack = await d.write_events(self.mixed_batch())
            await ack.wait_durable()
            assert len(fake.appends) == 2
            # pre-truncate append went to the generation-0 table, the
            # post-truncate one to the versioned successor
            assert fake.appends[0][0] == "public_user__events"
            assert fake.appends[1][0] == "public_user__events_1"
            await d.shutdown()
        finally:
            await server.stop()

    async def test_delete_with_null_nonkey_columns_accepted(self):
        """Destination DDL must keep non-identity columns nullable so
        key-only DELETE rows are representable."""
        sql = create_table_sql("etl", "t", make_schema(),
                               ClickHouseEngine.REPLACING_MERGE_TREE)
        # note column is NOT NULL at the source? No — but even a source
        # NOT NULL non-key column must be Nullable at the destination
        schema_notnull = ReplicatedTableSchema.with_all_columns(TableSchema(
            TID, TableName("public", "t2"),
            (ColumnSchema("id", Oid.INT4, nullable=False,
                          primary_key_ordinal=1),
             ColumnSchema("note", Oid.TEXT, nullable=False))))
        sql = create_table_sql("etl", "t2", schema_notnull,
                               ClickHouseEngine.REPLACING_MERGE_TREE)
        assert "`note` Nullable(String)" in sql
        assert "`id` Int32" in sql  # identity stays strict
        from etl_tpu_torch.destinations.bigquery import bq_field
        f = bq_field(schema_notnull.replicated_columns[1], {"id"})
        assert f["mode"] == "NULLABLE"


class TestToastUnchanged:
    """Unchanged-TOAST columns must never be flattened to NULL at a
    destination (reference ducklake Partial updates,
    bigquery_update_new_row error)."""

    def _toast_update(self, i=0, lsn=0x200):
        from etl_tpu_torch.models.cell import TOAST_UNCHANGED

        # id=1 updated, note TOASTed-unchanged (no old image)
        return UpdateEvent(Lsn(lsn), Lsn(lsn), i, make_schema(),
                           TableRow([1, TOAST_UNCHANGED, PgNumeric("5")]))

    async def test_bigquery_refuses_toast_upsert(self):
        from etl_tpu_torch.models.errors import ErrorKind, EtlError

        srv = RecordingHttpServer()
        await srv.start()
        try:
            dest = BigQueryDestination(BigQueryConfig(
                project_id="p", dataset_id="d", base_url=srv.url()),
                retry=RETRY_FAST)
            await dest.startup()
            with pytest.raises(EtlError) as ei:
                ack = await dest.write_events([self._toast_update()])
                await ack.wait_durable()
            assert ei.value.kind is ErrorKind.SOURCE_REPLICA_IDENTITY
            await dest.shutdown()
        finally:
            await srv.stop()

    async def test_clickhouse_refuses_toast_upsert(self):
        from etl_tpu_torch.models.errors import ErrorKind, EtlError

        srv = RecordingHttpServer()
        await srv.start()
        try:
            dest = ClickHouseDestination(ClickHouseConfig(
                url=srv.url(), database="db"), retry=RETRY_FAST)
            await dest.startup()
            with pytest.raises(EtlError) as ei:
                await dest.write_events([self._toast_update()])
            assert ei.value.kind is ErrorKind.SOURCE_REPLICA_IDENTITY
            await dest.shutdown()
        finally:
            await srv.stop()


class TestDefaultExpressions:
    """Portable default classification → destination DDL (reference
    etl-postgres/src/default_expression.rs + bigquery/schema.rs:28-36).
    Literal defaults travel; now()/serial/expressions are must-backfill
    and omitted."""

    def test_parser_classification_matches_reference_vectors(self):
        from etl_tpu_torch.models.default_expression import (
            DefaultKind, parse_default_expression as p)
        from etl_tpu_torch.models.pgtypes import CellKind as K

        # reference default_expression.rs test vectors
        assert p("'pending'::text", K.STRING).text == "pending"
        assert p("('don''t'::text)", K.STRING).text == "don't"  # unescaped
        assert p("42", K.I32) == \
            p("'42'::integer", K.I32)
        assert p("42", K.I32).kind is DefaultKind.NUMERIC
        assert p("false", K.BOOL).kind is DefaultKind.BOOLEAN
        assert p("true::text", K.STRING).text == "true"
        assert p("42::text", K.STRING).text == "42"
        assert p("'true'::boolean", K.BOOL).text == "true"
        assert p("'42.10'::numeric(10,2)", K.NUMERIC).text == "42.10"
        assert p("'abc'::text", K.I32) is None  # not numeric-shaped
        assert p("'2024-05-01'::date", K.DATE).kind is DefaultKind.DATE
        assert p("'2024-05-01'::date", K.DATE).text == "2024-05-01"

    def test_portability_boundaries_are_must_backfill(self):
        from etl_tpu_torch.models.default_expression import parse_default_expression as p
        from etl_tpu_torch.models.pgtypes import CellKind as K

        assert p("nextval('t_id_seq'::regclass)", K.I64) is None  # serial
        assert p("now()", K.TIMESTAMPTZ) is None
        assert p("CURRENT_TIMESTAMP", K.TIMESTAMPTZ) is None
        assert p("(select 1)", K.I32) is None
        assert p("ARRAY['a']", K.ARRAY) is None
        assert p("1 + 2", K.I32) is None
        assert p("'a' || 'b'", K.STRING) is None
        assert p(None, K.I32) is None
        assert p("NULL", K.I32) is None

    def test_clickhouse_ddl_with_defaults(self):
        schema = ReplicatedTableSchema.with_all_columns(TableSchema(
            TID, TableName("public", "d"),
            (ColumnSchema("id", Oid.INT8, nullable=False,
                          primary_key_ordinal=1,
                          default_expression="nextval('d_id_seq'::regclass)"),
             ColumnSchema("status", Oid.TEXT,
                          default_expression="'pending'::text"),
             ColumnSchema("n", Oid.INT4, default_expression="42"),
             ColumnSchema("created", Oid.TIMESTAMPTZ,
                          default_expression="now()"))))
        sql = create_table_sql("etl", "d", schema,
                               ClickHouseEngine.REPLACING_MERGE_TREE)
        assert "`status` Nullable(String) DEFAULT 'pending'" in sql
        assert "`n` Nullable(Int32) DEFAULT 42" in sql
        assert "DEFAULT nextval" not in sql  # serial: must-backfill
        assert "`created` Nullable(DateTime64(6)) DEFAULT" not in sql

    async def test_clickhouse_add_column_carries_default(self):
        from etl_tpu_torch.models.event import SchemaChangeEvent

        server = RecordingHttpServer()
        await server.start()
        try:
            d = ClickHouseDestination(
                ClickHouseConfig(url=server.url(), database="etl"),
                RETRY_FAST)
            await d.startup()
            await d.write_events([ins(0, [1, "a", None])])
            new_schema = TableSchema(
                TID, TableName("public", "user_events"),
                (ColumnSchema("id", Oid.INT4, nullable=False,
                              primary_key_ordinal=1),
                 ColumnSchema("note", Oid.TEXT),
                 ColumnSchema("amount", Oid.NUMERIC),
                 ColumnSchema("state", Oid.TEXT,
                              default_expression="'new'::text"),
                 ColumnSchema("seq", Oid.INT8,
                              default_expression="nextval('s'::regclass)")))
            await d.write_events([SchemaChangeEvent(
                Lsn(0x300), Lsn(0x300), TID,
                ReplicatedTableSchema.with_all_columns(new_schema))])
            alters = [q for q in server.queries() if "ADD COLUMN" in q]
            state = [q for q in alters if "`state`" in q]
            seq = [q for q in alters if "`seq`" in q]
            assert state and "DEFAULT 'new'" in state[0]
            assert seq and "DEFAULT" not in seq[0]  # backfill, no DDL default
            await d.shutdown()
        finally:
            await server.stop()

    def test_array_and_bytea_defaults_are_must_backfill(self):
        """A quoted literal default on an ARRAY/BYTEA column would be
        type-mismatched at the destination (STRING default on a BQ JSON
        array / SF VARIANT column) — classification must return None."""
        from etl_tpu_torch.models.default_expression import column_default_sql

        tags = ColumnSchema("tags", Oid.TEXT_ARRAY,
                            default_expression="'{}'::text[]")
        assert column_default_sql(tags, "bigquery") is None
        assert column_default_sql(tags, "snowflake") is None
        blob = ColumnSchema("blob", Oid.BYTEA,
                            default_expression="'\\x'::bytea")
        assert column_default_sql(blob, "bigquery") is None
        # UUID stays expressible: STRING columns at every destination
        uid = ColumnSchema(
            "uid", Oid.UUID,
            default_expression="'a0eebc99-9c0b-4ef8-bb6d-6bb9bd380a11'::uuid")
        assert column_default_sql(uid, "clickhouse") == \
            "'a0eebc99-9c0b-4ef8-bb6d-6bb9bd380a11'"

    def test_dialect_escaping(self):
        """Postgres ''-doubling and raw backslashes must be re-escaped per
        target dialect: GoogleSQL/ClickHouse escape with backslash,
        Snowflake doubles quotes but treats backslash as an escape,
        DuckDB is standard-conforming."""
        from etl_tpu_torch.models.default_expression import (
            parse_default_expression as p, render_default_sql as r)
        from etl_tpu_torch.models.pgtypes import CellKind as K

        tricky = p("'don''t \\ win'::text", K.STRING)
        assert tricky.text == "don't \\ win"
        assert r(tricky, "bigquery") == "'don\\'t \\\\ win'"
        assert r(tricky, "clickhouse") == "'don\\'t \\\\ win'"
        assert r(tricky, "snowflake") == "'don''t \\\\ win'"
        assert r(tricky, "duckdb") == "'don''t \\ win'"

    def test_bigquery_field_default(self):
        from etl_tpu_torch.destinations.bigquery import bq_field

        col = ColumnSchema("status", Oid.TEXT,
                           default_expression="'pending'::text")
        assert bq_field(col, set())["defaultValueExpression"] == "'pending'"
        col2 = ColumnSchema("at", Oid.TIMESTAMPTZ,
                            default_expression="now()")
        assert "defaultValueExpression" not in bq_field(col2, set())
        col3 = ColumnSchema("d", Oid.DATE,
                            default_expression="'2024-05-01'::date")
        assert bq_field(col3, set())["defaultValueExpression"] == \
            "DATE '2024-05-01'"




class TestKeyChangingUpdate:
    """An update that changes the replica identity deletes the
    old-identity row first (reference ducklake Full -> Delete{origin:
    update} + Upsert): the ClickHouse and BigQuery counterparts of the
    reference's lake case, each held to the reference destination's
    requests on the same event."""

    @staticmethod
    def _update(M):
        schema = M.ReplicatedTableSchema.with_all_columns(M.TableSchema(
            TID, M.TableName("public", "user_events"),
            (M.ColumnSchema("id", M.Oid.INT4, nullable=False,
                            primary_key_ordinal=1),
             M.ColumnSchema("note", M.Oid.TEXT),
             M.ColumnSchema("amount", M.Oid.NUMERIC))))
        # PK 1 -> 9 with a key-only old image
        return M.UpdateEvent(M.Lsn(0x300), M.Lsn(0x300), 0, schema,
                             M.TableRow([9, "a2", M.PgNumeric("1")]),
                             M.PartialTableRow([1, None, None],
                                               [True, False, False]))

    async def _clickhouse(self, pkg: str) -> list:
        import importlib

        M = importlib.import_module(f"{pkg}.models")
        ch = importlib.import_module(f"{pkg}.destinations.clickhouse")
        fake = importlib.import_module(f"{pkg}.testing.fake_http")
        server = fake.RecordingHttpServer()
        await server.start()
        try:
            d = ch.ClickHouseDestination(
                ch.ClickHouseConfig(url=server.url(), database="etl"),
                RETRY_FAST)
            await d.startup()
            await d.write_events([self._update(M)])
            await d.shutdown()
            return [r.text for r in server.requests
                    if "INSERT INTO" in r.query.get("query", "")]
        finally:
            await server.stop()

    async def test_clickhouse_deletes_old_identity(self):
        bodies = await self._clickhouse("etl_tpu_torch")
        lines = "".join(bodies).splitlines()
        assert [ln.split("\t")[0] for ln in lines] == ["1", "9"]
        assert lines[0].split("\t")[-2] == "DELETE"
        assert lines[1].split("\t")[-2] == "UPSERT"
        assert bodies == await self._clickhouse("etl_tpu")

    async def _bigquery(self, pkg: str) -> list:
        import importlib

        M = importlib.import_module(f"{pkg}.models")
        bq = importlib.import_module(f"{pkg}.destinations.bigquery")
        fake_bq = importlib.import_module(f"{pkg}.testing.fake_bq")
        fake = importlib.import_module(f"{pkg}.testing.fake_http")
        server = fake.RecordingHttpServer()
        sw = fake_bq.StorageWriteFake()
        server.responders.append(sw)
        await server.start()
        try:
            d = bq.BigQueryDestination(
                bq.BigQueryConfig(project_id="p", dataset_id="ds",
                                  base_url=server.url()), RETRY_FAST)
            await d.startup()
            ack = await d.write_events([self._update(M)])
            await ack.wait_durable()
            await d.shutdown()
            return [row for _, _, rows in sw.appends for row in rows]
        finally:
            await server.stop()

    async def test_bigquery_deletes_old_identity(self):
        rows = await self._bigquery("etl_tpu_torch")
        assert [(r["id"], r["_CHANGE_TYPE"]) for r in rows] == \
            [(1, "DELETE"), (9, "UPSERT")]
        assert rows[0]["_CHANGE_SEQUENCE_NUMBER"] \
            < rows[1]["_CHANGE_SEQUENCE_NUMBER"]
        assert rows == await self._bigquery("etl_tpu")


# -- the port's rules ------------------------------------------------------------


def _egress_event(encoder: str | None, n: int = 96, tid: int = 41060,
                  start: int = 0):
    """A DecodedBatchEvent through the port's staging and decode on the
    CPU, with the text the decoders render for `encoder` (the plain
    version of the render kernel) attached as its `device_egress`."""
    import numpy as np

    from etl_tpu_torch.models import DecodedBatchEvent
    from etl_tpu_torch.ops.engine import DeviceDecoder
    from etl_tpu_torch.ops.wal import concat_payloads, stage_wal_batch
    from etl_tpu_torch.postgres.codec.pgoutput import encode_insert

    schema = ReplicatedTableSchema.with_all_columns(TableSchema(
        tid, TableName("public", f"t{tid}"),
        (ColumnSchema("id", Oid.INT8, nullable=False, primary_key_ordinal=1),
         ColumnSchema("v", Oid.INT4), ColumnSchema("d", Oid.DATE),
         ColumnSchema("note", Oid.TEXT))))
    payloads = [encode_insert(tid, [
        str(start + i).encode(), str(i % 97 - 40).encode(),
        f"2024-{i % 12 + 1:02d}-{i % 28 + 1:02d}".encode(),
        b"note-%d" % (start + i)]) for i in range(n)]
    wal = stage_wal_batch(*concat_payloads(payloads), 4)
    batch = DeviceDecoder(schema, device="cpu",
                          egress=encoder).decode(wal.staged)
    assert (batch.device_egress is not None) == (encoder is not None)
    ev = DecodedBatchEvent(
        Lsn(start + 1), Lsn(start + n), schema,
        change_types=np.zeros(n, dtype=np.int8),
        commit_lsns=np.arange(start, start + n, dtype=np.uint64) + 0x1000,
        tx_ordinals=np.arange(n, dtype=np.uint64), batch=batch)
    return schema, ev


def _writes(path: str) -> float:
    from etl_tpu_torch.telemetry.metrics import (ETL_EGRESS_WRITES_TOTAL,
                                                 registry)

    return registry.get_counter(ETL_EGRESS_WRITES_TOTAL, {"path": path})


class TestNoFallback:
    """The port's departure from the reference: a failure inside a
    destination's fast columnar render (the assembly of device-rendered
    text into a request body) fails the write with a typed EtlError
    (DEVICE_DECODE_FAILED), and no data is posted; the reference
    re-renders host-side. The counterpart, for the destinations, of
    `test_torch_egress.py::TestNoFallback`."""

    @staticmethod
    def _break(monkeypatch, target: str):
        import importlib

        module, name = target.rsplit(".", 1)

        def broken(*args, **kw):
            raise RuntimeError("assembly refused")

        monkeypatch.setattr(importlib.import_module(module), name, broken)

    @staticmethod
    def _typed(e) -> None:
        from etl_tpu_torch.models.errors import ErrorKind, EtlError

        assert isinstance(e, EtlError)
        assert e.kind is ErrorKind.DEVICE_DECODE_FAILED
        assert "columnar render failed" in str(e)
        assert isinstance(e.__cause__, RuntimeError)

    @pytest.mark.parametrize("method", ["write_table_batch",
                                        "write_event_batches"])
    @pytest.mark.parametrize("target", [
        "etl_tpu_torch.ops.egress.assemble_rows",
        "etl_tpu_torch.destinations.clickhouse._column_piece_tsv"])
    async def test_clickhouse(self, monkeypatch, method, target):
        from etl_tpu_torch.models.errors import EtlError

        schema, ev = _egress_event("tsv")
        server = RecordingHttpServer()
        await server.start()
        try:
            d = ClickHouseDestination(
                ClickHouseConfig(url=server.url(), database="etl"),
                RETRY_FAST)
            await d.startup()
            self._break(monkeypatch, target)
            with pytest.raises(EtlError) as ei:
                if method == "write_table_batch":
                    await d.write_table_batch(schema, ev.batch)
                else:
                    await d.write_event_batches([ev])
            self._typed(ei.value)
            assert not [q for q in server.queries()
                        if q.startswith("INSERT INTO")]
            await d.shutdown()
        finally:
            await server.stop()

    @pytest.mark.parametrize("method", ["write_table_batch",
                                        "write_event_batches"])
    async def test_bigquery(self, monkeypatch, method):
        from etl_tpu_torch.models.errors import EtlError

        schema, ev = _egress_event("tsv")
        server, fake = await bq_server()
        try:
            d = BigQueryDestination(
                BigQueryConfig(project_id="p", dataset_id="ds",
                               base_url=server.url()), RETRY_FAST)
            await d.startup()
            self._break(monkeypatch,
                        "etl_tpu_torch.destinations.bq_proto._column_cells")
            with pytest.raises(EtlError) as ei:
                if method == "write_table_batch":
                    ack = await d.write_table_batch(schema, ev.batch)
                else:
                    ack = await d.write_event_batches([ev])
                await ack.wait_durable()
            self._typed(ei.value)
            assert not fake.attempts
            assert not [r for r in server.requests
                        if r.path.endswith(":appendRows")]
            await d.shutdown()
        finally:
            await server.stop()

    @pytest.mark.parametrize("method", ["write_table_batch",
                                        "write_event_batches"])
    async def test_snowflake(self, monkeypatch, method):
        from etl_tpu_torch.models.errors import EtlError

        schema, ev = _egress_event("json")
        server = FakeSnowpipeServer()
        await server.start()
        try:
            d = SnowflakeDestination(SnowflakeConfig(
                base_url=server.url(), account="acct", user="etl",
                database="DB", commit_poll_interval_s=0.01), RETRY_FAST)
            await d.startup()
            self._break(monkeypatch, "etl_tpu_torch.ops.egress.assemble_rows")
            with pytest.raises(EtlError) as ei:
                if method == "write_table_batch":
                    await d.write_table_batch(schema, ev.batch)
                else:
                    await d.write_event_batches([ev])
            self._typed(ei.value)
            assert not server.rows
            assert not [p for _, p, _ in server.requests
                        if p.endswith("/rows")]
            await d.shutdown()
        finally:
            await server.stop()

    @pytest.mark.parametrize("encoder", [None, "tsv"])
    async def test_host_render_by_routing(self, encoder):
        """A batch without device text renders host-side, by routing, not
        as a fallback: the same body, counted `path=host`; with the text,
        `path=device`."""
        import numpy as np

        from etl_tpu_torch.destinations.clickhouse import \
            render_batch_tsv_columnar

        schema, ev = _egress_event(encoder)
        server = RecordingHttpServer()
        await server.start()
        try:
            d = ClickHouseDestination(
                ClickHouseConfig(url=server.url(), database="etl"),
                RETRY_FAST)
            await d.startup()
            path = "device" if encoder else "host"
            before = _writes(path)
            await d.write_event_batches([ev])
            assert _writes(path) == before + 1
            body = [r.body for r in server.requests
                    if r.query.get("query", "").startswith("INSERT INTO")]
            n = len(ev)
            seqs = [f"{int(ev.commit_lsns[i]):016x}/{i:016x}/{0:016x}"
                    for i in range(n)]
            assert body == [render_batch_tsv_columnar(
                schema, ev.batch, ["UPSERT"] * n, seqs)]
            assert np.array_equal(ev.tx_ordinals, np.arange(n))
            await d.shutdown()
        finally:
            await server.stop()


class TestRegistry:
    @pytest.mark.parametrize("doc,cls,encoder", [
        ({"type": "clickhouse", "url": "http://x", "database": "etl",
          "engine": "ReplacingMergeTree"}, ClickHouseDestination, "tsv"),
        ({"type": "bigquery", "project_id": "p", "dataset_id": "d",
          "base_url": "http://x"}, BigQueryDestination, "tsv"),
        ({"type": "snowflake", "base_url": "http://x", "account": "a",
          "user": "u", "database": "db"}, SnowflakeDestination, "json"),
    ], ids=["clickhouse", "bigquery", "snowflake"])
    def test_builds_the_reference_documents(self, doc, cls, encoder):
        """The reference's registry and the port's build the same type
        from the same document, with the same config; the supervised
        wrapper forwards the encoder the decoders render for."""
        import dataclasses

        from etl_tpu.destinations.registry import \
            build_destination as ref_build
        from etl_tpu_torch.destinations import build_destination
        from etl_tpu_torch.supervision import SupervisedDestination

        dest, ref = build_destination(dict(doc)), ref_build(dict(doc))
        assert type(dest) is cls and type(ref).__name__ == cls.__name__
        assert json.dumps(dataclasses.asdict(dest.config), default=str) \
            == json.dumps(dataclasses.asdict(ref.config), default=str)
        assert dest.egress_encoder == ref.egress_encoder == encoder
        assert SupervisedDestination(dest).egress_encoder == encoder
        assert dest.supports_transactional_commit()

    @pytest.mark.parametrize("kind", ["lake", "iceberg"])
    def test_refuses_the_parquet_destinations(self, kind):
        """Where pyarrow cannot be imported (a subprocess with
        `sys.modules["pyarrow"] = None`, as on a host without it), the
        registry refuses the Parquet destinations with CONFIG_INVALID
        naming the destination and pyarrow; where it imports, it builds
        them as the reference's registry does."""
        import os
        import subprocess
        import sys

        from etl_tpu_torch.destinations import build_destination

        doc = {"type": kind, "warehouse_path": "/x"}
        if kind == "iceberg":
            doc["catalog_url"] = "http://127.0.0.1:9"
        assert type(build_destination(dict(doc))).__name__ \
            == {"lake": "LakeDestination",
                "iceberg": "IcebergDestination"}[kind]
        code = (
            "import json, sys\n"
            "sys.modules['pyarrow'] = None\n"
            "from etl_tpu_torch.destinations import build_destination\n"
            "from etl_tpu_torch.models.errors import EtlError\n"
            "try:\n"
            f"    build_destination({doc!r})\n"
            "    print(json.dumps(None))\n"
            "except EtlError as e:\n"
            "    print(json.dumps([e.kind.name, str(e)]))\n")
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        env["PYTHONPATH"] = root
        proc = subprocess.run([sys.executable, "-c", code],
                              capture_output=True, text=True, timeout=120,
                              cwd=root, env=env)
        assert proc.returncode == 0, proc.stderr[-2000:]
        got = json.loads(proc.stdout.strip().splitlines()[-1])
        assert got is not None
        kind_name, msg = got
        assert kind_name == "CONFIG_INVALID"
        assert kind in msg and "pyarrow" in msg


class TestDelayedAck:
    """`DelayedAckDestination` (the ack-window chaos slice's wrapper): the
    write applies at once, its ack settles `delay_s` later, the
    transactional seam passes through, and a shut-down wrapper fails the
    acks still pending; the same counts as the reference's wrapper."""

    @staticmethod
    async def _drive(pkg: str) -> dict:
        import importlib
        import time

        M = importlib.import_module(f"{pkg}.models")
        dests = importlib.import_module(f"{pkg}.destinations")
        delay = importlib.import_module(f"{pkg}.destinations.delay")
        inner = dests.TransactionalMemoryDestination()
        d = delay.DelayedAckDestination(inner, 0.05)
        await d.startup()
        schema = M.ReplicatedTableSchema.with_all_columns(M.TableSchema(
            TID, M.TableName("public", "user_events"),
            (M.ColumnSchema("id", M.Oid.INT4, nullable=False,
                            primary_key_ordinal=1),)))
        events = [M.InsertEvent(M.Lsn(0x100 + i), M.Lsn(0x100 + i), 0,
                                schema, M.TableRow([i])) for i in range(3)]
        t0 = time.perf_counter()
        acks = [await d.write_events([e]) for e in events]
        applied = sum(type(e).__name__ == "InsertEvent" for e in inner.events)
        out = {"applied_at_once": applied, "pending": d.pending,
               "durable_at_once": [a.is_durable for a in acks]}
        for a in acks:
            await a.wait_durable()
        out["waited_s"] = time.perf_counter() - t0 >= 0.05
        commit = dests.CommitRange.from_events(events[:1],
                                               commit_end_lsn=0x200)
        ack = await d.write_event_batches_committed(events[:1], commit)
        await ack.wait_durable()
        high = await d.recover_high_water()
        out["high"] = list(high.high)
        held = await d.write_events(events[1:2])
        await asyncio.sleep(0.01)  # its settle task is waiting out the delay
        await d.shutdown()
        try:
            await held.wait_durable()
            out["held"] = "durable"
        except M.EtlError as e:
            out["held"] = e.kind.name
        out.update(max_pending=d.max_pending, acks_issued=d.acks_issued,
                   telemetry_name=d.telemetry_name)
        return out

    async def test_delays_acks_as_the_reference_does(self):
        got = await self._drive("etl_tpu_torch")
        assert got["applied_at_once"] == 3 and got["pending"] == 3
        assert got["durable_at_once"] == [False] * 3 and got["waited_s"]
        assert got["held"] == "DESTINATION_FAILED"
        assert got == await self._drive("etl_tpu")


# -- the typed zstandard refusal (a departure: the reference fails untyped) ----

WITHOUT_ZSTANDARD = """
import json, sys
sys.modules["zstandard"] = None
from etl_tpu_torch.destinations.snowflake import (SnowflakeConfig,
                                                  SnowflakeDestination)
from etl_tpu_torch.destinations.snowpipe import RowBatchBuilder
from etl_tpu_torch.models.errors import EtlError
out = {}
for name, build in (
        ("destination", lambda: SnowflakeDestination(SnowflakeConfig(
            "http://127.0.0.1:9", "acct", "etl", "db"))),
        ("row_batches", RowBatchBuilder)):
    try:
        build()
        out[name] = "built"
    except EtlError as e:
        out[name] = [e.kind.name, str(e)]
if "--phase" in sys.argv:
    import argparse
    import chip_smoke
    r = chip_smoke.snowflake_case(argparse.Namespace(seed=7), {},
                                  device="cpu")
    out["phase"] = {k: r[k] for k in ("zstandard", "refused",
                                      "k1_launches", "egress_launches")}
print(json.dumps(out))
"""


def _without_zstandard(*argv):
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = root
    proc = subprocess.run([sys.executable, "-c", WITHOUT_ZSTANDARD, *argv],
                          capture_output=True, text=True, timeout=120,
                          cwd=root, env=env)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return proc.stdout, json.loads(proc.stdout.strip().splitlines()[-1])


def test_snowflake_refused_typed_without_zstandard():
    """Where zstandard cannot be imported, the Snowflake destination and
    the Snowpipe row-batch builder refuse at construction with
    CONFIG_INVALID naming zstandard, never a ModuleNotFoundError at the
    first write."""
    _, out = _without_zstandard()
    for name in ("destination", "row_batches"):
        kind, msg = out[name]
        assert kind == "CONFIG_INVALID" and "zstandard" in msg, (name, msg)


def test_chip_smoke_phase_12c_without_zstandard():
    """chip_smoke.py's 12(c) as on a host without zstandard: it prints so,
    prints the typed refusal and launches nothing."""
    stdout, out = _without_zstandard("--phase")
    assert "[12c] zstandard imports: no" in stdout
    assert "Snowflake through K1 did not run" in stdout
    phase = out["phase"]
    assert phase["zstandard"] is False and "zstandard" in phase["refused"]
    assert phase["k1_launches"] == phase["egress_launches"] == 0
