"""Failpoints: named crash/error injection sites across every layer.

Grown from runtime/failpoints.py (the seven reference-parity sites,
crates/etl/src/failpoints.rs:14-54) into the chaos subsystem's injection
surface: decode-pipeline stages, copy partition boundaries, assembler
seals, destination write/flush, store state/schema/progress commits, and
a simulated device-OOM hook the decode pipeline degrades through.

Design constraints:

  - the registry stays a no-op dict lookup when nothing is armed — the
    hot loop (per-row CDC pushes, per-chunk COPY writes) pays one `if not
    dict` check;
  - sites may be hit from the decode pipeline's WORKER THREAD as well as
    the event loop, so the global registry is guarded by a lock and
    actions must be thread-safe;
  - per-pipeline scoping: `scope("name")` binds a contextvar that
    asyncio tasks inherit, so two pipelines under test in one process can
    arm the same site without cross-firing (satellite: parallel tests).
    Worker-thread hits do not see contextvars of the arming task — sites
    that fire on the pack/dispatch thread (pipeline.*) should be armed
    globally in single-pipeline tests.

`runtime/failpoints.py` re-exports this module, so existing call sites
and tests keep importing from the runtime package unchanged.

Copy of the reference's `etl_tpu/chaos/failpoints.py`.
"""

from __future__ import annotations

import contextlib
import contextvars
import threading
from typing import Callable, Iterator

from ..models.errors import ErrorKind, EtlError

# --- the reference's named sites (failpoints.rs:14-21) ----------------------

BEFORE_SLOT_CREATION = "table_sync.before_slot_creation"
DURING_COPY = "table_sync.during_copy"
AFTER_FINISHED_COPY = "table_sync.after_finished_copy"
BEFORE_STREAMING = "table_sync.before_streaming"
ON_STATUS_UPDATE = "apply.on_status_update"
ON_PROGRESS_STORE = "apply.on_progress_store"
ON_SCHEMA_CLEANUP = "apply.on_schema_cleanup"

REFERENCE_SITES = (
    BEFORE_SLOT_CREATION, DURING_COPY, AFTER_FINISHED_COPY,
    BEFORE_STREAMING, ON_STATUS_UPDATE, ON_PROGRESS_STORE,
    ON_SCHEMA_CLEANUP,
)

# --- chaos-subsystem sites ---------------------------------------------------

# decode pipeline stages (ops/pipeline.py _process/_fetch)
PIPELINE_PACK = "pipeline.pack"
PIPELINE_DISPATCH = "pipeline.dispatch"
PIPELINE_FETCH = "pipeline.fetch"
# simulated device OOM: the pipeline catches DEVICE_UNAVAILABLE /
# MEMORY_PRESSURE_ABORT raised here and degrades the batch to the host
# oracle instead of failing the stream (ops/pipeline.py)
ENGINE_DEVICE_OOM = "engine.device_oom"
# copy partition boundaries (runtime/copy.py)
COPY_PARTITION_START = "copy.partition_start"
COPY_PARTITION_END = "copy.partition_end"
# assembler run seal (runtime/assembler.py)
ASSEMBLER_SEAL = "assembler.seal"
# apply-loop frame handling (runtime/apply_loop.py): a stall here wedges
# the loop itself — the watchdog's hang detection is the only way out
APPLY_FRAME_READ = "apply.frame_read"
# destination ack layer (destinations/base.py): WRITE fires when a
# destination constructs its ack (the write applied — an error here is
# the lost-response ambiguity), FLUSH fires on wait_durable
DESTINATION_WRITE = "destination.write"
DESTINATION_FLUSH = "destination.flush"
# store commit layer (store/memory.py, store/sql.py)
STORE_STATE_COMMIT = "store.state_commit"
STORE_SCHEMA_COMMIT = "store.schema_commit"
STORE_PROGRESS_COMMIT = "store.progress_commit"
# shard-assignment commits (store/memory.py, store/sql.py): the
# coordinator's two-phase rebalance persists through here — a fault is
# the crash-mid-rebalance window (docs/sharding.md)
STORE_SHARD_COMMIT = "store.shard_commit"

# autoscale decision-journal commits (store/memory.py, store/sql.py):
# the controller persists each scale decision here BEFORE actuating —
# a fault is the crash-before-actuation window the resume protocol
# covers (etl_tpu/autoscale/controller.py)
STORE_AUTOSCALE_COMMIT = "store.autoscale_commit"

# fleet spec/journal commits (store/memory.py, store/sql.py): the fleet
# reconciler persists each actuation decision here BEFORE driving the
# orchestrator — a fault is the crash-before-actuation window the
# successor's resume protocol covers (etl_tpu/fleet/reconciler.py)
STORE_FLEET_COMMIT = "store.fleet_commit"

# dead-letter appends (store/memory.py, store/sql.py): the isolation
# protocol persists poison rows here BEFORE acking their flush durable —
# a fault is the crash-between-bisect-and-dead-letter window the
# idempotent (keyed upsert) append covers (docs/dead-letter.md)
STORE_DLQ_COMMIT = "store.dlq_commit"

# poison-pill bisection (runtime/poison.py): fires once per bisection
# probe write — a crash here is the hard-kill-mid-bisection window the
# --dlq chaos scenario proves recoverable within the dup budget
POISON_BISECT = "poison.bisect"

CHAOS_SITES = (
    PIPELINE_PACK, PIPELINE_DISPATCH, PIPELINE_FETCH, ENGINE_DEVICE_OOM,
    COPY_PARTITION_START, COPY_PARTITION_END, ASSEMBLER_SEAL,
    APPLY_FRAME_READ,
    DESTINATION_WRITE, DESTINATION_FLUSH,
    STORE_STATE_COMMIT, STORE_SCHEMA_COMMIT, STORE_PROGRESS_COMMIT,
    STORE_SHARD_COMMIT, STORE_AUTOSCALE_COMMIT, STORE_FLEET_COMMIT,
    STORE_DLQ_COMMIT,
    POISON_BISECT,
)

#: sites that can stall asynchronously (an armed stall is consumed by the
#: site's `await stall_point(...)`); PIPELINE_FETCH stalls synchronously
#: on whichever THREAD drives the fetch (copy partitions fetch via
#: asyncio.to_thread, so the block lands off the event loop)
ASYNC_STALL_SITES = (
    APPLY_FRAME_READ, DESTINATION_WRITE, DESTINATION_FLUSH,
    COPY_PARTITION_START, COPY_PARTITION_END,
    STORE_STATE_COMMIT, STORE_SCHEMA_COMMIT, STORE_PROGRESS_COMMIT,
    STORE_SHARD_COMMIT, STORE_AUTOSCALE_COMMIT, STORE_FLEET_COMMIT,
    STORE_DLQ_COMMIT,
    POISON_BISECT,
)

ALL_SITES = REFERENCE_SITES + CHAOS_SITES

# --- registry ----------------------------------------------------------------

_lock = threading.Lock()
_armed: dict[str, Callable[[], None]] = {}
# scope name -> site -> action; consulted only when the contextvar is set
_scoped: dict[str, dict[str, Callable[[], None]]] = {}
_scope_var: contextvars.ContextVar[str | None] = \
    contextvars.ContextVar("etl_failpoint_scope", default=None)


@contextlib.contextmanager
def scope(name: str) -> Iterator[str]:
    """Bind a failpoint scope for the calling task (and every task it
    spawns). Scoped armings fire only inside their scope."""
    token = _scope_var.set(name)
    try:
        yield name
    finally:
        _scope_var.reset(token)
        with _lock:
            _scoped.pop(name, None)


def arm(name: str, action: Callable[[], None],
        scope_name: str | None = None) -> None:
    """Arm a failpoint with an action (usually raising)."""
    with _lock:
        if scope_name is None:
            _armed[name] = action
        else:
            _scoped.setdefault(scope_name, {})[name] = action


def arm_error(name: str, kind: ErrorKind = ErrorKind.SOURCE_IO,
              times: int = 1, detail: str = "",
              scope_name: str | None = None) -> None:
    """Arm to raise an EtlError of `kind` the next `times` hits."""
    remaining = [times]

    def action() -> None:
        if remaining[0] > 0:
            remaining[0] -= 1
            raise EtlError(kind, detail or f"failpoint {name}")
        disarm(name, scope_name)

    arm(name, action, scope_name)


def disarm(name: str, scope_name: str | None = None) -> None:
    with _lock:
        if scope_name is None:
            _armed.pop(name, None)
        else:
            scoped = _scoped.get(scope_name)
            if scoped is not None:
                scoped.pop(name, None)


def disarm_all() -> None:
    release_stalls()
    with _lock:
        _armed.clear()
        _scoped.clear()


def armed_sites() -> list[str]:
    """Globally armed site names (introspection for tests/CLI)."""
    with _lock:
        return sorted(_armed)


def fail_point(name: str) -> None:
    """Hit a failpoint (no-op unless armed). Hot-path cost when disarmed:
    three falsy dict checks, no lock. Armed STALLS fire here only when
    the caller is OFF the event loop (worker threads, asyncio.to_thread
    fetches) — a synchronous block on the loop would freeze the
    supervisor that is supposed to detect it, so loop-side sites consume
    stalls through `await stall_point(...)` instead."""
    if _stalls and not _on_event_loop():
        s = _consume_stall(name)
        if s is not None:
            s.release.wait(s.duration_s)
    if not _armed and not _scoped:
        return
    action = None
    if _scoped:
        scope_name = _scope_var.get()
        if scope_name is not None:
            with _lock:
                scoped = _scoped.get(scope_name)
                action = scoped.get(name) if scoped else None
    if action is None:
        with _lock:
            action = _armed.get(name)
    if action is not None:
        action()


# --- stall mode --------------------------------------------------------------


class _StallSpec:
    """One armed stall: hang for `duration_s` or until released."""

    __slots__ = ("name", "duration_s", "release", "times", "after_hits",
                 "hits", "fired", "on_fire")

    def __init__(self, name: str, duration_s: float, times: int,
                 after_hits: int, on_fire: Callable[[], None] | None):
        self.name = name
        self.duration_s = duration_s
        self.release = threading.Event()
        self.times = times
        self.after_hits = after_hits
        self.hits = 0
        self.fired = 0
        self.on_fire = on_fire


_stalls: dict[str, _StallSpec] = {}
# every spec ever armed since the last release: a consumed spec leaves
# `_stalls` but may still be blocking a thread on its release event
_all_stall_specs: list[_StallSpec] = []


def _on_event_loop() -> bool:
    import asyncio

    try:
        asyncio.get_running_loop()
        return True
    except RuntimeError:
        return False


def arm_stall(name: str, duration_s: float = 5.0, times: int = 1,
              after_hits: int = 0,
              on_fire: Callable[[], None] | None = None) -> "_StallSpec":
    """Arm a stall at `name`: the site hangs for `duration_s` (or until
    `release_stalls()` / `disarm_all()`) instead of raising. Async sites
    (`ASYNC_STALL_SITES`) stall cancellably via `stall_point`; thread
    sites block in `fail_point`. Returns the spec so tests can release
    it directly."""
    spec = _StallSpec(name, duration_s, times, after_hits, on_fire)
    with _lock:
        _stalls[name] = spec
        _all_stall_specs.append(spec)
    return spec


def _consume_stall(name: str) -> "_StallSpec | None":
    """One stall firing attempt: counts the hit, honors after_hits/times,
    self-disarms when exhausted."""
    with _lock:
        spec = _stalls.get(name)
        if spec is None:
            return None
        spec.hits += 1
        if spec.hits <= spec.after_hits:
            return None
        if spec.fired >= spec.times:
            _stalls.pop(name, None)
            return None
        spec.fired += 1
        if spec.fired >= spec.times:
            _stalls.pop(name, None)
    if spec.on_fire is not None:
        spec.on_fire()
    return spec


def stalls_armed() -> bool:
    """Per-frame hot paths guard their `await stall_point(...)` behind
    this (one dict truthiness check) so the disarmed cost stays a sync
    call, not a coroutine allocation per frame — the same contract as
    fail_point's no-op lookup."""
    return bool(_stalls)


async def stall_point(name: str) -> None:
    """Async stall site: hang (cancellably) while armed. Cost when
    nothing is armed: one falsy dict check (hot paths pre-guard with
    `stalls_armed()` to skip even the coroutine). Polling (20 ms)
    rather than an executor wait so supervisor cancellation interrupts
    the stall immediately without stranding an executor thread."""
    if not _stalls:
        return
    s = _consume_stall(name)
    if s is None:
        return
    import asyncio
    import time

    deadline = time.monotonic() + s.duration_s
    while not s.release.is_set() and time.monotonic() < deadline:
        await asyncio.sleep(0.02)


def release_stalls() -> None:
    """Unblock every stalled site, armed or mid-stall (consumed specs
    keep blocking their thread until released) — scenario teardown must
    never leave a thread parked on a chaos stall."""
    with _lock:
        specs = list(_all_stall_specs)
        _stalls.clear()
        _all_stall_specs.clear()
    for s in specs:
        s.release.set()
