"""Chaos TCP proxy: the NetworkChaos pod-level fault injector, in
process.

The reference drives Chaos Mesh NetworkChaos against replicator pods
(crates/xtask/src/commands/chaos/{mod,scenario}.rs — PacketLoss,
Partition, Latency with jitter). Here the same fault matrix is applied
at the one place a single-process test can: a TCP proxy between the
wire client and the (fake) Postgres server.

- latency: every forwarded chunk sleeps delay_ms ± jitter_ms first
  (tc netem delay analogue);
- corruption: every Nth server→client chunk of ≥64 bytes gets one byte
  flipped (tc netem corrupt analogue — at the application layer TCP
  checksum escapes manifest as protocol-violation parse errors the
  client must convert into typed, retryable failures);
- partition: sever() hard-closes every live connection pair
  (100% directional loss).

Copy of the reference's `etl_tpu/testing/chaos_proxy.py`.
"""

from __future__ import annotations

import asyncio
import random


class ChaosProxy:
    def __init__(self, upstream_host: str, upstream_port: int, *,
                 delay_ms: float = 0.0, jitter_ms: float = 0.0,
                 corrupt_every: int = 0, seed: int = 7):
        self.upstream = (upstream_host, upstream_port)
        self.delay_ms = delay_ms
        self.jitter_ms = jitter_ms
        self.corrupt_every = corrupt_every
        self._rng = random.Random(seed)
        self._server: asyncio.AbstractServer | None = None
        self._writers: list[asyncio.StreamWriter] = []
        self._chunks = 0
        self.port = 0
        self.corrupted = 0  # bytes flipped (test observability)
        self.severed = 0

    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._handle, "127.0.0.1", 0)
        self.port = self._server.sockets[0].getsockname()[1]

    async def stop(self) -> None:
        self.sever()
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None

    def sever(self) -> None:
        """Hard partition: close every live connection pair."""
        for w in self._writers:
            if not w.is_closing():
                w.close()
        if self._writers:
            self.severed += 1
        self._writers.clear()

    async def _handle(self, cr: asyncio.StreamReader,
                      cw: asyncio.StreamWriter) -> None:
        try:
            ur, uw = await asyncio.open_connection(*self.upstream)
        except OSError:
            cw.close()
            return
        self._writers += [cw, uw]
        # client→server never corrupted (chaos on the walsender's
        # answers is the scenario; corrupting requests just kills the
        # session before it starts)
        up = asyncio.ensure_future(self._pump(cr, uw, corrupt=False))
        # downstream corruption is gated per-chunk on corrupt_every so
        # a scenario can ARM it mid-run (e.g. only after initial copy)
        down = asyncio.ensure_future(self._pump(ur, cw, corrupt=True))
        await asyncio.wait({up, down},
                           return_when=asyncio.FIRST_COMPLETED)
        for t in (up, down):
            t.cancel()
        for w in (cw, uw):
            if not w.is_closing():
                w.close()

    async def _pump(self, r: asyncio.StreamReader,
                    w: asyncio.StreamWriter, corrupt: bool) -> None:
        try:
            while True:
                chunk = await r.read(65536)
                if not chunk:
                    break
                if self.delay_ms > 0:
                    d = self.delay_ms + self._rng.uniform(
                        -self.jitter_ms, self.jitter_ms)
                    await asyncio.sleep(max(0.0, d) / 1000)
                if corrupt and self.corrupt_every > 0 \
                        and len(chunk) >= 64:
                    self._chunks += 1
                    if self._chunks % self.corrupt_every == 0:
                        b = bytearray(chunk)
                        b[len(b) // 2] ^= 0xFF
                        chunk = bytes(b)
                        self.corrupted += 1
                w.write(chunk)
                await w.drain()
        except (ConnectionError, asyncio.CancelledError, OSError):
            pass
        finally:
            if not w.is_closing():
                w.close()
