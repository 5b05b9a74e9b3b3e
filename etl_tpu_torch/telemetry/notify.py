"""Error-notification webhooks.

Reference parity: etl-replicator error notification webhooks
(crates/etl-replicator/src/error_notification.rs) — ERROR-level records
POST a JSON payload to a configured webhook URL, rate-limited, fired
through the tracing error hook so every component participates.

Copy of the reference's `etl_tpu/telemetry/notify.py`.
"""

from __future__ import annotations

import asyncio
import json
import logging
import time

from .tracing import set_error_hook

logger = logging.getLogger("etl_tpu_torch.notify")


class WebhookErrorNotifier:
    def __init__(self, url: str, *, pipeline_id: int | None = None,
                 min_interval_s: float = 30.0):
        self.url = url
        self.pipeline_id = pipeline_id
        self.min_interval_s = min_interval_s
        self._last_sent: float | None = None  # None = never sent
        self._session = None
        self._tasks: set[asyncio.Task] = set()
        self._closed = False

    def install(self) -> None:
        set_error_hook(self._on_error)

    def _on_error(self, record: logging.LogRecord) -> None:
        if record.name.startswith("etl_tpu_torch.notify"):
            return  # never recurse on our own failures
        if self._closed:
            return
        now = time.monotonic()
        if self._last_sent is not None \
                and now - self._last_sent < self.min_interval_s:
            return
        self._last_sent = now
        payload = {
            "pipeline_id": self.pipeline_id,
            "level": record.levelname,
            "target": record.name,
            "message": record.getMessage(),
            "ts": time.time(),
        }
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            return  # no loop (e.g. during interpreter shutdown)
        # strong reference: loops hold tasks weakly, and close() must be
        # able to await in-flight posts (the LAST error is the one that
        # matters most)
        task = loop.create_task(self._post(payload))
        self._tasks.add(task)
        task.add_done_callback(self._tasks.discard)

    async def _post(self, payload: dict) -> None:
        import aiohttp

        try:
            if self._closed:
                return
            if self._session is None:
                self._session = aiohttp.ClientSession()
            async with self._session.post(
                    self.url, json=payload,
                    timeout=aiohttp.ClientTimeout(total=10)) as resp:
                await resp.read()
        except Exception as e:
            logger.warning("error webhook failed: %r", e)

    async def flush(self) -> None:
        """Wait for in-flight notifications (call before teardown)."""
        if self._tasks:
            await asyncio.gather(*list(self._tasks), return_exceptions=True)

    async def close(self) -> None:
        await self.flush()
        self._closed = True
        if self._session is not None:
            await self._session.close()
            self._session = None
