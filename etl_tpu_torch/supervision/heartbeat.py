"""Heartbeats: cheap liveness + progress publication for every
long-running component.

A component publishes `beat(progress=token, busy=flag)` from wherever it
makes progress — the apply loop's select wakeups, a table-sync worker's
copy chunks, the decode pipeline's worker thread, the memory monitor's
sample tick. A beat is three attribute writes and one comparison; no
locks on the publish path (CPython attribute stores are atomic, and the
supervisor tolerates torn *pairs* because it re-reads every sweep).

The progress token is opaque to the supervisor: any value whose CHANGE
means forward progress (an LSN pair, a byte count, a completed-batch
counter). The supervisor's two detections read off this contract:

  hang   — `age() > hang_deadline`: the component stopped beating at
           all; the task/thread is wedged somewhere that never returns.
  stall  — beats keep arriving with `busy=True` but the progress token
           has not changed for `stall_deadline`: the component is alive
           but its work is stuck (a flush that never acks, an LSN that
           stops advancing).

`busy=False` beats park the stall clock: an idle component (no WAL, no
work in flight) legitimately makes no progress. Components about to
enter a long legitimate wait should either keep beating (see
`beat_while_waiting`) or have a hang deadline sized for the wait.

Copy of the reference's `etl_tpu/supervision/heartbeat.py`.
"""

from __future__ import annotations

import asyncio
import threading
import time
from dataclasses import dataclass
from typing import Awaitable, Callable, TypeVar

T = TypeVar("T")


@dataclass(frozen=True)
class ComponentPolicy:
    """Per-component deadlines; None inherits the supervisor default."""

    stall_deadline_s: float | None = None
    hang_deadline_s: float | None = None
    # True for components the supervisor may cancel-and-restart; False
    # for observe-only components (memory monitor, decode pipelines —
    # their recovery rides their owning worker's restart)
    restartable: bool = False
    # work-driven components (decode pipelines, destination wrappers)
    # beat only when work flows, so a stale heartbeat is a hang ONLY if
    # the last beat claimed work in flight; timer-driven components
    # (apply loop select wakeups, monitor sample ticks) hang on
    # staleness alone
    hang_requires_busy: bool = False


class Heartbeat:
    """One component's liveness slot. Publish-side is wait-free."""

    __slots__ = ("name", "policy", "registry", "last_beat", "progress",
                 "progress_at", "busy", "beats", "on_restart")

    def __init__(self, name: str, policy: ComponentPolicy,
                 registry: "HeartbeatRegistry | None" = None,
                 on_restart: Callable[[], None] | None = None):
        self.name = name
        self.policy = policy
        self.registry = registry
        self.on_restart = on_restart
        now = time.monotonic()
        self.last_beat = now
        self.progress: object = None
        self.progress_at = now
        self.busy = False
        self.beats = 0

    def beat(self, progress: object = None, busy: bool = False) -> None:
        """Publish liveness. Called from event-loop tasks AND worker
        threads — must stay allocation-free and lock-free."""
        now = time.monotonic()
        self.last_beat = now
        self.beats += 1
        self.busy = busy
        if progress is not None and progress != self.progress:
            self.progress = progress
            self.progress_at = now

    def reset_clocks(self) -> None:
        """Give a just-restarted component fresh deadlines so the sweep
        that triggered the restart doesn't immediately re-trip on it."""
        now = time.monotonic()
        self.last_beat = now
        self.progress_at = now
        self.busy = False

    def age(self, now: float | None = None) -> float:
        return (now if now is not None else time.monotonic()) - self.last_beat

    def progress_age(self, now: float | None = None) -> float:
        return (now if now is not None else time.monotonic()) \
            - self.progress_at

    def close(self) -> None:
        if self.registry is not None:
            self.registry.unregister(self.name)

    def snapshot(self) -> dict:
        now = time.monotonic()
        return {
            "age_s": round(self.age(now), 3),
            "progress_age_s": round(self.progress_age(now), 3),
            "busy": self.busy,
            "beats": self.beats,
            "progress": repr(self.progress),
            "restartable": self.policy.restartable,
        }


class HeartbeatRegistry:
    """All live components of one pipeline. Registration is rare and
    locked; the supervisor snapshots the component list per sweep."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._components: dict[str, Heartbeat] = {}

    def register(self, name: str,
                 policy: ComponentPolicy | None = None,
                 on_restart: Callable[[], None] | None = None) -> Heartbeat:
        """Create (or replace — a restarted worker re-registers) the
        component's heartbeat slot."""
        hb = Heartbeat(name, policy or ComponentPolicy(), registry=self,
                       on_restart=on_restart)
        with self._lock:
            self._components[name] = hb
        return hb

    def unregister(self, name: str) -> None:
        with self._lock:
            self._components.pop(name, None)

    def get(self, name: str) -> Heartbeat | None:
        with self._lock:
            return self._components.get(name)

    def components(self) -> list[Heartbeat]:
        with self._lock:
            return list(self._components.values())

    def snapshot(self) -> dict[str, dict]:
        return {hb.name: hb.snapshot() for hb in self.components()}


async def beat_while_waiting(hb: Heartbeat | None, aw: Awaitable[T],
                             interval_s: float = 0.5) -> T:
    """Await `aw` while keeping `hb` fresh — for legitimate long parks
    (the apply loop waiting out a table-sync handoff, a sync worker
    parked on its catchup target) that must not read as hangs. The beat
    carries busy=False, so the stall clock stays parked too."""
    if hb is None:
        return await aw
    task = asyncio.ensure_future(aw)
    try:
        while True:
            done, _ = await asyncio.wait({task}, timeout=interval_s)
            hb.beat(busy=False)
            if task in done:
                return task.result()
    finally:
        # drain without eating the caller's own cancellation
        # (runtime/shutdown.drain_cancelled rationale)
        from ..runtime.shutdown import drain_cancelled

        await drain_cancelled(task)
