"""Validating Storage Write fake for BigQuery destination tests.

Copy of the reference's `etl_tpu/testing/fake_bq.py`.

A RecordingHttpServer responder that DECODES every `:appendRows` proto
request (the `destinations.bq_proto` wire format), validates the framing
the way a real Storage Write backend would — rows must decode against the
carried writer schema, CDC pseudo-columns must be present — records the
decoded rows, and plays scripted error responses for the retry tests
(reference test stance: bigquery/test_utils.rs + the fault-injection
cases around client.rs:317-450).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..destinations import bq_proto


@dataclass
class _Scripted:
    response: bytes
    times: int


@dataclass
class StorageWriteFake:
    """Responder for RecordingHttpServer: server.responders.append(fake)."""

    attempts: list[tuple[str, object, list[dict]]] = field(
        default_factory=list)  # every decoded request (incl. failed ones)
    appends: list[tuple[str, object, list[dict]]] = field(
        default_factory=list)  # requests answered with success
    missing_tables: set[str] = field(default_factory=set)
    _scripted: list[_Scripted] = field(default_factory=list)

    # -- scripting -----------------------------------------------------------

    def script_status(self, grpc_code: int, message: str,
                      storage_error_code: int | None = None,
                      times: int = 1) -> None:
        """Next `times` appends answer with this google.rpc.Status error."""
        self._scripted.append(_Scripted(
            bq_proto.encode_append_rows_response(
                error=bq_proto.encode_rpc_status(
                    grpc_code, message, storage_error_code)),
            times))

    def script_row_error(self, index: int, code: int, message: str) -> None:
        self._scripted.append(_Scripted(
            bq_proto.encode_append_rows_response(
                row_errors=[bq_proto.RowError(index, code, message)]), 1))

    # -- assertions ----------------------------------------------------------

    def rows_for(self, table: str) -> list[dict]:
        return [row for t, _, rows in self.appends if t == table
                for row in rows]

    # -- responder -----------------------------------------------------------

    def __call__(self, rec):
        if rec.method == "GET" and "/tables/" in rec.path \
                and not rec.path.endswith(":appendRows"):
            table = rec.path.rsplit("/tables/", 1)[-1].split("/")[0]
            if table in self.missing_tables:
                return (404, {"error": "table not found"})
            return None  # default 200 {} == exists
        if not rec.path.endswith(":appendRows"):
            return None
        table = rec.path.rsplit("/tables/", 1)[-1].split("/")[0]
        req = bq_proto.decode_append_rows_request(rec.body)
        # framing validation: every row decodes against the writer schema
        rows = req.decode_rows()
        names = {name for name, *_ in req.descriptor_fields}
        assert bq_proto.CHANGE_TYPE_FIELD in names \
            and bq_proto.CHANGE_SEQUENCE_FIELD in names, \
            "writer schema missing CDC pseudo-columns"
        for row in rows:
            assert bq_proto.CHANGE_TYPE_FIELD in row, \
                f"append row missing {bq_proto.CHANGE_TYPE_FIELD}"
            assert bq_proto.CHANGE_SEQUENCE_FIELD in row, \
                f"append row missing {bq_proto.CHANGE_SEQUENCE_FIELD}"
            assert row[bq_proto.CHANGE_TYPE_FIELD] in ("UPSERT", "DELETE")
        assert req.write_stream.endswith(f"/tables/{table}/streams/_default")
        assert req.trace_id, "append request must carry a trace id"
        self.attempts.append((table, req, rows))
        if self._scripted:
            s = self._scripted[0]
            s.times -= 1
            if s.times <= 0:
                self._scripted.pop(0)
            return (200, s.response)
        self.appends.append((table, req, rows))
        return (200, bq_proto.encode_append_rows_response(
            offset=sum(len(r) for _, _, r in self.appends)))
