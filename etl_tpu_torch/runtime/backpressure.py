"""Memory backpressure: monitor, budgets, and pausable streams.

Copy of the reference's `etl_tpu/runtime/backpressure.py` (without the
supervision heartbeat, not ported yet).

Reference parity:
  - `MemoryMonitor` (crates/etl/src/runtime/memory_monitor.rs:84): samples
    RSS vs cgroup-or-host limit on an interval; hysteresis activate@0.85 /
    resume@0.75 (etl-config pipeline.rs:199-201); watch-channel subscription
    consumed by streams.
  - `BatchBudgetController` (runtime/batch_budget.rs:22): ideal batch bytes
    = min(total_mem × ratio / active_streams, max_bytes) with RAII stream
    registration and a briefly-cached reader (100 ms).
  - `BackpressureStream` / `TryBatchBackpressureStream`
    (runtime/concurrency/stream.rs:45,133): pause intake under pressure;
    batch items by size/deadline with budget-aware flush.
"""

from __future__ import annotations

import asyncio
import os
import threading
import time
from dataclasses import dataclass
from typing import AsyncIterator, Awaitable, Callable, Generic, TypeVar

from ..config.pipeline import MemoryBackpressureConfig

T = TypeVar("T")


class InFlightWindow:
    """Bounded in-flight window for the decode pipeline, monitor-aware.

    The pipeline's dispatch stage `acquire()`s one slot per batch before
    packing/dispatching; the fetch stage `release()`s it after the result
    lands. The limit caps host arenas + device buffers held by in-flight
    batches; under memory pressure (`MemoryMonitor.pressure`) the
    EFFECTIVE limit drops to 1 — the pipeline degrades to serial decode
    until the monitor's hysteresis resumes, the same stance as the WAL
    intake pause (BackpressureStream), applied to the decode stage.

    Thread-based (not asyncio): acquire happens on the pipeline's pack
    worker thread; release on whichever thread consumes the result. The
    pressure flag is re-read on every wakeup AND on a short poll tick, so
    a pressure transition never needs to signal the condition to be seen.
    """

    _POLL_S = 0.05

    def __init__(self, limit: int, monitor: "MemoryMonitor | None" = None):
        if limit < 1:
            raise ValueError("in-flight window needs limit >= 1")
        self.limit = limit
        self.monitor = monitor
        self._held = 0
        self._cond = threading.Condition()

    @property
    def effective_limit(self) -> int:
        if self.monitor is not None and self.monitor.pressure:
            return 1
        return self.limit

    def __len__(self) -> int:
        return self._held

    def acquire(self, bypass: "Callable[[], bool] | None" = None) -> None:
        """Block until a slot frees. `bypass` is a liveness valve: when it
        returns True (the pipeline has a consumer blocked on a batch that
        cannot dispatch until this acquire returns), the window overshoots
        its limit rather than deadlocking — memory cap traded for
        progress, only under out-of-order consumption. Re-checked on the
        poll tick, so no extra signalling is needed."""
        with self._cond:
            while self._held >= self.effective_limit \
                    and not (bypass is not None and bypass()):
                self._cond.wait(timeout=self._POLL_S)
            self._held += 1

    def release(self) -> None:
        with self._cond:
            self._held = max(0, self._held - 1)
            self._cond.notify_all()


def read_memory_limit_bytes() -> int:
    """cgroup v2/v1 limit if set, else total host memory
    (reference memory_monitor.rs:38-45)."""
    for path in ("/sys/fs/cgroup/memory.max",
                 "/sys/fs/cgroup/memory/memory.limit_in_bytes"):
        try:
            raw = open(path).read().strip()
            if raw and raw != "max":
                v = int(raw)
                if 0 < v < 1 << 60:
                    return v
        except (OSError, ValueError):
            pass
    try:
        pages = os.sysconf("SC_PHYS_PAGES")
        page = os.sysconf("SC_PAGE_SIZE")
        return pages * page
    except (ValueError, OSError):
        return 8 << 30


def read_rss_bytes() -> int:
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError, IndexError):
        return 0


class MemoryMonitor:
    """Periodic RSS sampler with hysteresis; `pressure` is the watch value.

    `pressure_changed` is an asyncio.Event pulsed on every transition so
    streams can wait for resume without polling."""

    def __init__(self, config: MemoryBackpressureConfig,
                 limit_bytes: int | None = None,
                 rss_reader: Callable[[], int] = read_rss_bytes):
        self.config = config
        self.limit_bytes = limit_bytes or read_memory_limit_bytes()
        self._rss_reader = rss_reader
        self.pressure = False
        self.last_rss = 0
        self._mem_pressure = False
        # externally-imposed pause (maintenance coordination lease): the
        # published `pressure` is the OR of memory pressure and this flag
        self.external_pause = False
        self._resumed = asyncio.Event()
        self._resumed.set()
        self._task: asyncio.Task | None = None

    def set_external_pause(self, paused: bool) -> None:
        """Pause/resume intake for a non-memory reason (external
        maintenance pause lease). Composes with memory hysteresis: intake
        resumes only when BOTH conditions clear."""
        self.external_pause = paused
        self._publish()

    def _publish(self) -> None:
        effective = self._mem_pressure or self.external_pause
        if effective and not self.pressure:
            self.pressure = True
            self._resumed.clear()
        elif not effective and self.pressure:
            self.pressure = False
            self._resumed.set()

    def start(self) -> None:
        if self._task is None:
            self._task = asyncio.ensure_future(self._run())

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None

    def sample_once(self) -> bool:
        """One sample + hysteresis update; returns current pressure. The
        monitor owns the backpressure metrics: it is the single hysteresis
        authority, so one pressure episode counts once no matter how many
        streams pause on it."""
        from ..telemetry.metrics import (
            ETL_MEMORY_BACKPRESSURE_ACTIVATIONS_TOTAL,
            ETL_MEMORY_BACKPRESSURE_ACTIVE, registry)

        self.last_rss = self._rss_reader()
        ratio = self.last_rss / max(1, self.limit_bytes)
        if not self._mem_pressure and ratio >= self.config.activate_ratio:
            self._mem_pressure = True
            registry.counter_inc(ETL_MEMORY_BACKPRESSURE_ACTIVATIONS_TOTAL)
            registry.gauge_set(ETL_MEMORY_BACKPRESSURE_ACTIVE, 1)
        elif self._mem_pressure and ratio <= self.config.resume_ratio:
            self._mem_pressure = False
            registry.gauge_set(ETL_MEMORY_BACKPRESSURE_ACTIVE, 0)
        self._publish()
        return self.pressure

    async def _run(self) -> None:
        interval = self.config.refresh_interval_ms / 1000
        while True:
            self.sample_once()
            await asyncio.sleep(interval)

    async def wait_until_resumed(self) -> None:
        await self._resumed.wait()  # etl-lint: ignore[unbounded-await] — resume is hysteresis-driven by design; callers are cancellation-scoped (apply loop select, copy partitions under or_shutdown)


class BatchBudgetController:
    """Per-stream byte budgets: ideal = min(limit × ratio / active, max)
    (reference batch_budget.rs:72-96), cached for 100 ms."""

    CACHE_TTL_S = 0.1

    def __init__(self, config: MemoryBackpressureConfig, max_bytes: int,
                 limit_bytes: int | None = None):
        self.config = config
        self.max_bytes = max_bytes
        self.limit_bytes = limit_bytes or read_memory_limit_bytes()
        self._active = 0
        self._cached: tuple[float, int] | None = None

    def register_stream(self) -> "BudgetLease":
        self._active += 1
        self._cached = None
        return BudgetLease(self)

    def _release(self) -> None:
        self._active = max(0, self._active - 1)
        self._cached = None

    def ideal_batch_bytes(self) -> int:
        now = time.monotonic()
        if self._cached is not None and now - self._cached[0] < self.CACHE_TTL_S:
            return self._cached[1]
        share = self.limit_bytes * self.config.memory_ratio \
            / max(1, self._active)
        value = int(min(share, self.max_bytes))
        self._cached = (now, value)
        return value


class BudgetLease:
    """RAII registration (reference batch_budget.rs:49-54,141-152)."""

    def __init__(self, controller: BatchBudgetController):
        self._controller = controller
        self._released = False

    def ideal_batch_bytes(self) -> int:
        return self._controller.ideal_batch_bytes()

    def release(self) -> None:
        if not self._released:
            self._released = True
            self._controller._release()

    def __enter__(self) -> "BudgetLease":
        return self

    def __exit__(self, *exc) -> None:
        self.release()


async def backpressured(source: AsyncIterator[T],
                        monitor: MemoryMonitor) -> AsyncIterator[T]:
    """Pause pulling from `source` while the monitor reports pressure
    (reference BackpressureStream, stream.rs:45-122)."""
    async for item in source:
        yield item
        if monitor.pressure:
            await monitor.wait_until_resumed()


@dataclass
class Batch(Generic[T]):
    items: list[T]
    size_bytes: int


async def batch_with_budget(source: AsyncIterator[T],
                            size_of: Callable[[T], int],
                            lease: BudgetLease,
                            max_fill_s: float) -> AsyncIterator[Batch[T]]:
    """Batch items by budget bytes + fill deadline (reference
    TryBatchBackpressureStream, stream.rs:133)."""
    items: list[T] = []
    size = 0
    deadline: float | None = None
    it = source.__aiter__()
    pending: asyncio.Task | None = None
    try:
        while True:
            if pending is None:
                pending = asyncio.ensure_future(it.__anext__())
            timeout = None if deadline is None \
                else max(0.0, deadline - time.monotonic())
            done, _ = await asyncio.wait({pending}, timeout=timeout)
            if pending in done:
                try:
                    item = pending.result()
                except StopAsyncIteration:
                    break
                pending = None
                items.append(item)
                size += size_of(item)
                if deadline is None:
                    deadline = time.monotonic() + max_fill_s
                if size >= lease.ideal_batch_bytes():
                    yield Batch(items, size)
                    items, size, deadline = [], 0, None
            elif items:  # deadline hit
                yield Batch(items, size)
                items, size, deadline = [], 0, None
            else:
                deadline = None
    finally:
        if pending is not None and not pending.done():
            pending.cancel()
            try:
                await pending
            except (asyncio.CancelledError, StopAsyncIteration):
                pass
    if items:
        yield Batch(items, size)
