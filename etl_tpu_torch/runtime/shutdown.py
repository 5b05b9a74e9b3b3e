"""Shutdown signaling: a watch-channel analogue on asyncio.

Reference parity: shutdown watch channel + `ShutdownResult`
(crates/etl/src/runtime/concurrency/{shutdown,signal}.rs). One tx side held
by the pipeline, many rx sides cloned into workers; `wait()` is cancel-safe
and level-triggered.

Copy of the reference's `etl_tpu/runtime/shutdown.py`.
"""

from __future__ import annotations

import asyncio
from typing import Awaitable, TypeVar

T = TypeVar("T")


class ShutdownSignal:
    def __init__(self) -> None:
        self._event = asyncio.Event()

    def trigger(self) -> None:
        self._event.set()

    @property
    def is_triggered(self) -> bool:
        return self._event.is_set()

    async def wait(self) -> None:
        await self._event.wait()  # etl-lint: ignore[unbounded-await] — this IS the shutdown race primitive the rule demands elsewhere


class ShutdownRequested(Exception):
    """Raised by `or_shutdown` when the signal wins the race."""


async def drain_cancelled(*tasks: "asyncio.Task | None") -> None:
    """Cancel-and-drain that never eats the CALLER's own cancellation.

    The naive idiom `t.cancel(); try: await t; except CancelledError:
    pass` has a liveness hole: if the caller is itself cancelled while
    parked on `await t`, its OWN CancelledError surfaces at that await
    and the except swallows it — the caller resumes as if nothing
    happened and survives the kill (the chaos runner's hard-kill found
    this: a cancel landing inside such a finally left the apply worker
    retrying forever). `asyncio.wait` never raises the drained tasks'
    exceptions, so the only CancelledError that can escape here is the
    caller's — exactly the one that must propagate."""
    pending = [t for t in tasks if t is not None]
    for t in pending:
        if not t.done():
            t.cancel()
    if pending:
        await asyncio.wait(pending)
        for t in pending:
            if not t.cancelled():
                t.exception()  # retrieved: no never-retrieved noise


async def or_shutdown(shutdown: ShutdownSignal, aw: Awaitable[T]) -> T:
    """Await `aw`, aborting with ShutdownRequested if shutdown triggers
    first. The pending awaitable is cancelled on abort."""
    task = asyncio.ensure_future(aw)
    sd = asyncio.ensure_future(shutdown.wait())
    try:
        done, _ = await asyncio.wait({task, sd},
                                     return_when=asyncio.FIRST_COMPLETED)
        if task in done:
            return task.result()
        raise ShutdownRequested()
    finally:
        await drain_cancelled(task, sd)
