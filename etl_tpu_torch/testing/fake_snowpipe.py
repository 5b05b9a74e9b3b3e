"""In-process Snowpipe Streaming emulator.

Copy of the reference's `etl_tpu/testing/fake_snowpipe.py`.

Validates the REAL wire surface the destination speaks (reference
rest_client.rs): hostname discovery, channel PUT/DELETE with
`fail_on_uncommitted_rows`, zstd NDJSON row POSTs with continuation-token
chaining and offset-range query params, and `:bulk-channel-status`. Enforces
the protocol (stale continuation tokens → 400 STALE_CONTINUATION_TOKEN_
SEQUENCER, uncommitted rows → 409 ERR_CHANNEL_HAS_UNCOMMITTED_DATA) so the
destination's recovery paths are exercised against a server that actually
objects, not one that accepts anything."""

from __future__ import annotations

import json
from dataclasses import dataclass, field

from aiohttp import web

from ..destinations.snowpipe import MAX_COMPRESSED_BYTES


@dataclass
class FakeChannel:
    continuation: str
    committed: str | None = None  # last committed offset token
    pending: list[tuple[str, int]] = field(default_factory=list)
    rows_inserted: int = 0
    rows_parsed: int = 0
    rows_errors: int = 0
    epoch: int = 0  # bumped on reopen


class FakeSnowpipeServer:
    """Snowpipe Streaming + statements-API emulator.

    `commit_mode`:
      - "immediate": rows commit as each insert lands;
      - "on_poll":   rows commit when channel status is next polled —
                     exercises the client's durability barrier for real.
    """

    def __init__(self, commit_mode: str = "immediate",
                 hostname_as_json: bool = False,
                 require_auth: bool = False):
        self.commit_mode = commit_mode
        self.hostname_as_json = hostname_as_json
        self.require_auth = require_auth
        self.channels: dict[str, FakeChannel] = {}
        self.rows: dict[str, list[dict]] = {}  # pipe key -> NDJSON docs
        self.statements: list[str] = []
        self.requests: list[tuple[str, str, dict]] = []  # method, path, query
        self.fail_next: list[tuple[int, str]] = []  # (status, body) FIFO
        self.rotate_continuation_once = False  # simulate a stale client token
        self.hostname_discoveries = 0
        self.status_polls = 0
        self._ct = 0
        self._runner: web.AppRunner | None = None
        self.port = 0

    def url(self) -> str:
        return f"http://127.0.0.1:{self.port}"

    def _next_ct(self) -> str:
        self._ct += 1
        return f"ct-{self._ct:04d}"

    async def start(self) -> None:
        # client_max_size: the API's own body bound is 4 MB compressed
        app = web.Application(client_max_size=MAX_COMPRESSED_BYTES + 1024)
        app.router.add_get("/v2/streaming/hostname", self._hostname)
        app.router.add_route(
            "*",
            "/v2/streaming/databases/{db}/schemas/{sch}/pipes/{pipe}"
            "/channels/{ch}", self._channel)
        app.router.add_post(
            "/v2/streaming/data/databases/{db}/schemas/{sch}/pipes/{pipe}"
            "/channels/{ch}/rows", self._insert)
        app.router.add_post(
            "/v2/streaming/databases/{db}/schemas/{sch}/pipes/"
            "{pipe_status}", self._bulk_status)
        app.router.add_post("/api/v2/statements", self._statement)
        # auto_decompress=False: aiohttp's parser would otherwise try (and
        # fail) to decode Content-Encoding: zstd itself — the emulator
        # must see the raw compressed body like the real service does
        self._runner = web.AppRunner(app, auto_decompress=False)
        await self._runner.setup()
        site = web.TCPSite(self._runner, "127.0.0.1", 0)
        await site.start()
        self.port = site._server.sockets[0].getsockname()[1]

    async def stop(self) -> None:
        if self._runner is not None:
            await self._runner.cleanup()
            self._runner = None

    # -- helpers ---------------------------------------------------------------

    def _gate(self, request: web.Request) -> web.Response | None:
        self.requests.append((request.method, request.path,
                              dict(request.query)))
        if self.require_auth and \
                not request.headers.get("Authorization", "").startswith(
                    "Bearer "):
            return web.json_response({"message": "no token"}, status=401)
        if self.fail_next:
            status, body = self.fail_next.pop(0)
            return web.Response(status=status, text=body,
                                content_type="application/json")
        return None

    @staticmethod
    def _key(request: web.Request) -> str:
        i = request.match_info
        return f"{i['db']}/{i['sch']}/{i['pipe']}/{i['ch']}"

    def _status_doc(self, ch: FakeChannel, name: str) -> dict:
        return {"channel_name": name, "channel_status_code": "ACTIVE",
                "last_committed_offset_token": ch.committed,
                "rows_inserted": ch.rows_inserted,
                "rows_parsed": ch.rows_parsed,
                "rows_errors": ch.rows_errors}

    def _commit_pending(self, ch: FakeChannel) -> None:
        if ch.pending:
            ch.committed = ch.pending[-1][0]
            ch.rows_inserted += sum(n for _, n in ch.pending)
            ch.pending.clear()

    # -- endpoints -------------------------------------------------------------

    async def _hostname(self, request: web.Request) -> web.Response:
        gate = self._gate(request)
        if gate is not None:
            return gate
        self.hostname_discoveries += 1
        # the real server returns plain text even when docs say JSON
        # (rest_client.rs:67-71); both shapes are exercised
        if self.hostname_as_json:
            return web.json_response({"hostname": self.url()})
        return web.Response(text=self.url())

    async def _channel(self, request: web.Request) -> web.Response:
        gate = self._gate(request)
        if gate is not None:
            return gate
        key = self._key(request)
        body = json.loads(await request.read() or b"{}")
        fail_on_uncommitted = body.get("fail_on_uncommitted_rows", True)
        ch = self.channels.get(key)
        if request.method == "PUT":
            if ch is not None and ch.pending and fail_on_uncommitted:
                if self.commit_mode == "on_poll":
                    # an open with uncommitted rows objects; the client
                    # polls status (committing them) and retries
                    return web.json_response(
                        {"code": "ERR_CHANNEL_HAS_UNCOMMITTED_DATA"},
                        status=409)
                self._commit_pending(ch)
            if ch is None:
                ch = self.channels[key] = FakeChannel(self._next_ct())
            else:
                ch.continuation = self._next_ct()
                ch.epoch += 1
            return web.json_response({
                "next_continuation_token": ch.continuation,
                "channel_status": self._status_doc(
                    ch, request.match_info["ch"])})
        if request.method == "DELETE":
            if ch is None:
                return web.json_response({"message": "no such channel"},
                                         status=404)
            if ch.pending and fail_on_uncommitted:
                if self.commit_mode == "on_poll":
                    return web.json_response(
                        {"code": "ERR_CHANNEL_HAS_UNCOMMITTED_DATA"},
                        status=409)
                self._commit_pending(ch)
            del self.channels[key]
            return web.json_response({})
        return web.json_response({"message": "bad method"}, status=405)

    async def _insert(self, request: web.Request) -> web.Response:
        gate = self._gate(request)
        if gate is not None:
            return gate
        key = self._key(request)
        ch = self.channels.get(key)
        if ch is None:
            return web.json_response({"message": "channel not found"},
                                     status=404)
        if self.rotate_continuation_once:
            self.rotate_continuation_once = False
            ch.continuation = self._next_ct()
        if request.query.get("continuationToken") != ch.continuation:
            return web.json_response(
                {"code": "STALE_CONTINUATION_TOKEN_SEQUENCER"}, status=400)
        if request.headers.get("Content-Encoding") != "zstd":
            return web.json_response(
                {"message": "body must be zstd-compressed"}, status=400)
        if request.headers.get("Content-Type") != "application/x-ndjson":
            return web.json_response(
                {"message": "body must be NDJSON"}, status=400)
        import zstandard

        raw = zstandard.ZstdDecompressor().decompress(
            await request.read(), max_output_size=64 * 1024 * 1024)
        docs = [json.loads(line) for line in
                raw.decode().splitlines() if line]
        end = request.query.get("endOffsetToken", "")
        if not end:
            return web.json_response({"message": "missing offset range"},
                                     status=400)
        # offset tokens must advance strictly: a client replaying or
        # reordering batches within a channel would corrupt exactly-once
        # accounting (tokens are zero-padded sequence keys, so string
        # order == numeric order)
        last = ch.pending[-1][0] if ch.pending else ch.committed
        if last is not None and end <= last:
            return web.json_response(
                {"message": f"offset token {end!r} does not advance "
                            f"past {last!r}"}, status=400)
        pipe_key = key.rsplit("/", 1)[0]
        self.rows.setdefault(pipe_key, []).extend(docs)
        ch.rows_parsed += len(docs)
        ch.pending.append((end, len(docs)))
        ch.continuation = self._next_ct()
        if self.commit_mode == "immediate":
            self._commit_pending(ch)
        return web.json_response(
            {"next_continuation_token": ch.continuation})

    async def _bulk_status(self, request: web.Request) -> web.Response:
        gate = self._gate(request)
        if gate is not None:
            return gate
        tail = request.match_info["pipe_status"]
        if not tail.endswith(":bulk-channel-status"):
            return web.json_response({"message": "unknown route"},
                                     status=404)
        pipe = tail[: -len(":bulk-channel-status")]
        i = request.match_info
        self.status_polls += 1
        names = json.loads(await request.read())["channel_names"]
        out = {}
        for name in names:
            key = f"{i['db']}/{i['sch']}/{pipe}/{name}"
            ch = self.channels.get(key)
            if ch is None:
                continue
            if self.commit_mode == "on_poll":
                self._commit_pending(ch)
            out[name] = self._status_doc(ch, name)
        return web.json_response({"channel_statuses": out})

    async def _statement(self, request: web.Request) -> web.Response:
        gate = self._gate(request)
        if gate is not None:
            return gate
        self.statements.append(json.loads(await request.read())["statement"])
        return web.json_response({"resultSetMetaData": {}})
