"""Recording HTTP server for destination tests.

Copy of the reference's `etl_tpu/testing/fake_http.py`, with the body
bound (`client_max_size`) a parameter.

Captures every request (method, path, query, body) and returns scriptable
responses — the emulator pattern the reference uses for BigQuery/ClickHouse
destination suites (SURVEY §4.6), reduced to what assertions need."""

from __future__ import annotations

import asyncio
import json
from dataclasses import dataclass, field
from typing import Awaitable, Callable

from aiohttp import web


@dataclass
class RecordedRequest:
    method: str
    path: str
    query: dict[str, str]
    body: bytes
    headers: dict[str, str]

    @property
    def json(self):
        return json.loads(self.body) if self.body else None

    @property
    def text(self) -> str:
        return self.body.decode("utf-8", "replace")


Responder = Callable[[RecordedRequest], "tuple[int, dict] | None"]


class RecordingHttpServer:
    def __init__(self, client_max_size: int = 1024 ** 2) -> None:
        # aiohttp's default body bound; a bulk load's bodies need more
        self.client_max_size = client_max_size
        self.requests: list[RecordedRequest] = []
        self.responders: list[Responder] = []
        self.fail_next: list[int] = []  # status codes to fail with, FIFO
        self._runner: web.AppRunner | None = None
        self.port = 0

    def url(self) -> str:
        return f"http://127.0.0.1:{self.port}"

    async def start(self) -> None:
        app = web.Application(client_max_size=self.client_max_size)
        app.router.add_route("*", "/{tail:.*}", self._handle)
        self._runner = web.AppRunner(app)
        await self._runner.setup()
        site = web.TCPSite(self._runner, "127.0.0.1", 0)
        await site.start()
        self.port = site._server.sockets[0].getsockname()[1]

    async def stop(self) -> None:
        if self._runner is not None:
            await self._runner.cleanup()
            self._runner = None

    async def _handle(self, request: web.Request) -> web.Response:
        body = await request.read()
        rec = RecordedRequest(
            method=request.method, path=request.path,
            query=dict(request.query), body=body,
            headers=dict(request.headers))
        self.requests.append(rec)
        if self.fail_next:
            status = self.fail_next.pop(0)
            return web.Response(status=status, text="scripted failure")
        for responder in self.responders:
            out = responder(rec)
            if out is not None:
                status, doc = out
                if isinstance(doc, (bytes, bytearray)):
                    return web.Response(
                        body=bytes(doc), status=status,
                        content_type="application/x-protobuf")
                return web.json_response(doc, status=status)
        return web.json_response({}, status=200)

    # -- assertion helpers ------------------------------------------------------

    def queries(self) -> list[str]:
        """ClickHouse-style ?query= params in arrival order."""
        return [r.query["query"] for r in self.requests if "query" in r.query]

    def paths(self) -> list[str]:
        return [f"{r.method} {r.path}" for r in self.requests]
