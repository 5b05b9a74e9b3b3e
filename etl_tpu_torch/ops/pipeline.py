"""Three-stage pipelined decode scheduler.

Copy of the reference's `etl_tpu/ops/pipeline.py` on CUDA streams. Serial
`decode_async` runs `_pack_host` — the numpy/C gather — on the dispatch
path, so per batch the host pack, the device compute, and the result
fetch serialize and the card idles between dispatches. This module
overlaps them:

    submit(decoder, staged)            consumer (in submit order)
        │                                      ▲
        ▼                                      │ fetch: _PendingDecode
    [ pack worker thread ]                     │ .result() — event wait,
    1. route (device/oracle)                   │ combines, CPU fixup;
    2. acquire in-flight window slot           │ releases the arena and
    3. PACK into a pooled staging arena        │ the window slot
    4. DISPATCH: H2D, kernel, D2H ─────────────┘
       (the card computes while the worker
        packs the NEXT batch)

  - pack — `DeviceDecoder._pack_stage` on a dedicated worker thread,
    writing into reusable pinned arenas (staging.ARENA_POOL, bucketed by
    exact buffer shape) instead of fresh buffers per batch;
  - dispatch — `DeviceDecoder._dispatch_stage` on the same thread, inside
    `torch.cuda.stream(...)` of a stream the pipeline owns: every
    pipeline's uploads, launches and fetches queue on a stream of their
    own (PyTorch's current stream is per thread; without it every worker
    would launch on the default stream, interleaved with the others), and
    K2c's look-back buffer, keyed by stream, is the pipeline's own;
  - fetch — `_PendingDecode.result()` completion, driven by the caller
    in submit order (it waits on the decode's event) and bounded by an
    in-flight window (runtime/backpressure.InFlightWindow, default 3;
    shrinks to 1 under memory pressure) so host arenas + device buffers
    stay capped.

One worker thread per pipeline keeps dispatch order == submit order, so
call sites (runtime/copy.py per copy partition, runtime/assembler.py per
apply loop) drain completions strictly in order with no cross-stream
deadlock: the oldest submitted batch is always packed/dispatched before
any younger batch can hold a window slot. A worker that dies fails the
results still pending on it.

Telemetry: per-stage histograms (pack/dispatch/fetch seconds), the
overlap counters (seconds of pack time concurrent with another batch in
flight — the pipelining win itself), and arena reuse hits
(telemetry/metrics.py).
"""

from __future__ import annotations

import contextlib
import queue
import threading
import time
from concurrent.futures import Future
from concurrent.futures import TimeoutError as FutureTimeout
from typing import TYPE_CHECKING

import torch

from ..analysis.annotations import admission_path, hot_loop
from .staging import ARENA_POOL, StagedBatch, StagingArenaPool

if TYPE_CHECKING:  # import cycle: runtime -> ops at module import time
    from ..runtime.backpressure import MemoryMonitor
    from .engine import DeviceDecoder

#: default bounded in-flight window: 3 batches ≈ one packing, one on the
#: device, one streaming back — deeper windows only add memory (the
#: card runs one pipeline's launches in stream order anyway)
DEFAULT_WINDOW = 3


# ---------------------------------------------------------------------------
# fair batch admission: N pipelines sharing one device set
# ---------------------------------------------------------------------------


class TenantAdmission:
    """One tenant's (pipeline's) handle on a shared AdmissionScheduler.

    Exactly ONE thread — the owning pipeline's pack/dispatch worker —
    calls `acquire`; `release` may come from whichever thread drains the
    fetch. `close` releases every ticket the tenant still holds and
    deregisters it: a crashed/abandoned pipeline can never strand shared
    device capacity behind handles nobody will drain."""

    __slots__ = ("_sched", "name", "_lag_bytes", "_monitor", "_pass",
                 "_held", "_grants", "_wait_since", "_closed")

    def __init__(self, sched: "AdmissionScheduler", name: str,
                 lag_bytes, monitor):
        self._sched = sched
        self.name = name
        self._lag_bytes = lag_bytes  # () -> lag in bytes, or None
        self._monitor = monitor  # MemoryMonitor | None
        self._pass = 0.0  # stride-scheduling virtual time
        self._held = 0
        self._grants = 0
        self._wait_since: float | None = None
        self._closed = False

    @property
    def held(self) -> int:
        return self._held

    @property
    def closed(self) -> bool:
        return self._closed

    def acquire(self, bypass=None) -> None:
        self._sched._acquire(self, bypass)

    def release(self) -> None:
        self._sched._release(self)

    def close(self) -> None:
        self._sched._close_tenant(self)


class AdmissionScheduler:
    """Fair batch admission across N decode pipelines sharing one device
    set: at most `capacity` device
    batches are in flight across ALL tenants, and when tenants contend
    the grant order is weighted stride scheduling.

      weight   = 1 + lag_bytes / lag_scale_bytes (clamped to max_weight):
                 a tenant whose replication stream is behind (the
                 SlotLagMetrics / apply-loop flush-lag shape) gets
                 proportionally more batch admissions, so one device set
                 drains the laggard first instead of round-robining;
      stride   = 1 / weight; on every grant the tenant's virtual pass
                 advances by its stride and the scheduler picks the
                 waiter with the minimum pass — proportional share with
                 no tenant ever starved (a weight-1 tenant still lands
                 every max_weight'th grant);
      aging    = a waiter past `starvation_s` is granted next regardless
                 of pass (counted as a starvation grant): even a
                 pathological lag provider (stuck at +∞ for one tenant)
                 cannot lock another tenant out for longer than the
                 deadline;
      idle cap = a tenant's pass is floored to the global virtual time
                 when it starts waiting, so a long-idle tenant gets its
                 fair share going forward, not an unbounded burst of
                 back-credit.

    Memory pressure rides the existing machinery: when ANY registered
    tenant's MemoryMonitor reports pressure the effective capacity drops
    to 1 (the same stance as InFlightWindow — RSS is process-level, so
    one pressured monitor throttles every tenant). The `bypass` valve
    mirrors InFlightWindow.acquire's: when the caller's consumer is
    blocked on a batch that cannot dispatch until this acquire returns,
    the scheduler overshoots capacity instead of deadlocking.

    Purely passive (a Condition, no threads of its own): shutdown cannot
    leak tasks — the chaos leak probe asserts in_flight and waiters
    return to zero once the sharing pipelines close."""

    _POLL_S = 0.05
    STRIDE = 1.0

    def __init__(self, capacity: int, *,
                 lag_scale_bytes: float = 64 * 1024 * 1024,
                 max_weight: float = 32.0,
                 starvation_s: float = 0.5):
        if capacity < 1:
            raise ValueError("admission capacity must be >= 1")
        self.capacity = capacity
        self._lag_scale = max(1.0, float(lag_scale_bytes))
        self._max_weight = max(1.0, float(max_weight))
        self._starvation_s = starvation_s
        self._cond = threading.Condition()
        self._tenants: list[TenantAdmission] = []
        self._held_total = 0
        self._vt = 0.0  # global virtual time (max pass ever granted)
        # per-tenant SLO weight inputs (etl_tpu/autoscale feeds these):
        # a static business-priority multiplier composed WITH the dynamic
        # lag weight — lag says who is behind right now, the SLO says
        # whose backlog costs more per second. Keys match tenant names
        # exactly or as a prefix ("cdc" covers "cdc-0", "cdc-1", …).
        self._slo_weights: dict[str, float] = {}

    def set_slo_weight(self, tenant: str, weight: float) -> None:
        """Install (or update) one tenant's SLO weight. `tenant` is an
        exact tenant name or a prefix; `weight` is clamped to
        [1/max_weight, max_weight] so one tenant can neither zero itself
        out nor starve the fleet past the aging valve's reach."""
        lo = 1.0 / self._max_weight
        with self._cond:
            self._slo_weights[tenant] = min(max(float(weight), lo),
                                            self._max_weight)
            self._cond.notify_all()

    @admission_path
    def _slo_for(self, name: str) -> float:
        """Exact-name match wins; otherwise the LONGEST prefix match
        (tenant names carry per-stream suffixes the operator's config
        cannot know: "cdc-3", "copy-16384-2"). Caller holds the lock or
        tolerates a stale read — weights only drift, never tear."""
        w = self._slo_weights.get(name)
        if w is not None:
            return w
        best_len = -1
        best = 1.0
        for prefix, weight in self._slo_weights.items():
            if name.startswith(prefix) and len(prefix) > best_len:
                best_len = len(prefix)
                best = weight
        return best

    def register(self, name: str, lag_bytes=None,
                 monitor: "MemoryMonitor | None" = None) -> TenantAdmission:
        """New tenant. `lag_bytes` is read at every grant decision — pass
        the live replication-lag reader (e.g. the apply loop's
        received−durable delta), not a snapshot."""
        t = TenantAdmission(self, name, lag_bytes, monitor)
        with self._cond:
            self._tenants.append(t)
            n_tenants = len(self._tenants)
        from ..telemetry.metrics import ETL_DECODE_ADMISSION_TENANTS, registry

        registry.gauge_set(ETL_DECODE_ADMISSION_TENANTS, n_tenants)
        return t

    @property
    def effective_capacity(self) -> int:
        if any(t._monitor is not None and t._monitor.pressure
               for t in self._tenants):
            return 1
        return self.capacity

    @property
    def in_flight(self) -> int:
        return self._held_total

    @property
    def waiters(self) -> int:
        with self._cond:
            return sum(1 for t in self._tenants
                       if t._wait_since is not None)

    @admission_path
    def _weight(self, tenant: TenantAdmission) -> float:
        slo = self._slo_for(tenant.name)
        if tenant._lag_bytes is None:
            return max(slo, 1.0 / self._max_weight)
        try:
            lag = max(0.0, float(tenant._lag_bytes()))
        except Exception:  # a dying lag reader must not kill admission
            lag = 0.0
        return min(max(slo * (1.0 + lag / self._lag_scale),
                       1.0 / self._max_weight), self._max_weight)

    @admission_path
    def _pick(self, now: float) -> "tuple[TenantAdmission, bool] | None":
        """Next waiter to admit: aged-out waiter (FIFO among starved)
        first, else minimum virtual pass. Caller holds the lock."""
        waiters = [t for t in self._tenants if t._wait_since is not None]
        if not waiters:
            return None
        starved = [t for t in waiters
                   if now - t._wait_since >= self._starvation_s]
        if starved:
            return min(starved, key=lambda t: t._wait_since), True
        return min(waiters, key=lambda t: t._pass), False

    @admission_path
    def _acquire(self, tenant: TenantAdmission, bypass=None) -> None:
        from ..telemetry.metrics import (
            ETL_DECODE_ADMISSION_BYPASS_GRANTS_TOTAL,
            ETL_DECODE_ADMISSION_GRANTS_TOTAL,
            ETL_DECODE_ADMISSION_IN_FLIGHT,
            ETL_DECODE_ADMISSION_STARVATION_GRANTS_TOTAL,
            ETL_DECODE_ADMISSION_WAIT_SECONDS, ETL_DECODE_ADMISSION_WAITERS,
            registry)

        t0 = time.perf_counter()
        starved_grant = False
        bypass_grant = False
        granted = False
        with self._cond:
            if tenant._closed:
                raise RuntimeError(
                    f"admission tenant {tenant.name!r} is closed")
            tenant._wait_since = time.monotonic()
            # idle cap: fair share from NOW, no banked burst credit
            tenant._pass = max(tenant._pass, self._vt)
            registry.gauge_set(
                ETL_DECODE_ADMISSION_WAITERS,
                sum(1 for t in self._tenants if t._wait_since is not None))
            try:
                while True:
                    if bypass is not None and bypass():
                        bypass_grant = True
                        break
                    if tenant._closed:
                        raise RuntimeError(
                            f"admission tenant {tenant.name!r} closed "
                            f"while waiting")
                    if self._held_total < self.effective_capacity:
                        picked = self._pick(time.monotonic())
                        if picked is not None and picked[0] is tenant:
                            starved_grant = picked[1]
                            break
                    # poll tick: pressure transitions, lag drift, and the
                    # bypass predicate are all re-read without signalling
                    self._cond.wait(timeout=self._POLL_S)
            finally:
                tenant._wait_since = None
                # this waiter is done (granted, closed, or raising) —
                # re-derive the gauge from live state so it can't stick
                # at a stale count
                registry.gauge_set(
                    ETL_DECODE_ADMISSION_WAITERS,
                    sum(1 for t in self._tenants
                        if t._wait_since is not None))
            if not tenant._closed:
                self._vt = max(self._vt, tenant._pass)
                tenant._pass += self.STRIDE / self._weight(tenant)
                tenant._held += 1
                tenant._grants += 1
                self._held_total += 1
                granted = True
            held_total = self._held_total
            # a freed-then-granted slot may leave capacity for the next
            # waiter; wake the others to re-pick
            self._cond.notify_all()
        # grant telemetry only for REAL grants: a tenant closed during
        # the wait wakes without a ticket, and counting it would skew
        # the per-tenant fairness evidence the bench reports
        if granted:
            labels = {"pipeline": tenant.name}
            registry.counter_inc(ETL_DECODE_ADMISSION_GRANTS_TOTAL,
                                 labels=labels)
            if starved_grant:
                registry.counter_inc(
                    ETL_DECODE_ADMISSION_STARVATION_GRANTS_TOTAL,
                    labels=labels)
            if bypass_grant:
                registry.counter_inc(
                    ETL_DECODE_ADMISSION_BYPASS_GRANTS_TOTAL, labels=labels)
            registry.histogram_observe(ETL_DECODE_ADMISSION_WAIT_SECONDS,
                                       time.perf_counter() - t0, labels)
        registry.gauge_set(ETL_DECODE_ADMISSION_IN_FLIGHT, held_total)

    @admission_path
    def _release(self, tenant: TenantAdmission) -> None:
        from ..telemetry.metrics import (ETL_DECODE_ADMISSION_IN_FLIGHT,
                                         registry)

        with self._cond:
            if tenant._held <= 0:
                return  # ticket already reclaimed by close()
            tenant._held -= 1
            self._held_total = max(0, self._held_total - 1)
            held_total = self._held_total
            self._cond.notify_all()
        registry.gauge_set(ETL_DECODE_ADMISSION_IN_FLIGHT, held_total)

    @admission_path
    def _close_tenant(self, tenant: TenantAdmission) -> None:
        with self._cond:
            if tenant._closed:
                return
            tenant._closed = True
            self._held_total = max(0, self._held_total - tenant._held)
            tenant._held = 0
            if tenant in self._tenants:
                self._tenants.remove(tenant)
            n_tenants = len(self._tenants)
            held_total = self._held_total
            self._cond.notify_all()
        from ..telemetry.metrics import (ETL_DECODE_ADMISSION_IN_FLIGHT,
                                         ETL_DECODE_ADMISSION_TENANTS,
                                         registry)

        registry.gauge_set(ETL_DECODE_ADMISSION_TENANTS, n_tenants)
        registry.gauge_set(ETL_DECODE_ADMISSION_IN_FLIGHT, held_total)

    def stats(self) -> dict:
        with self._cond:
            return {
                "capacity": self.capacity,
                "effective_capacity": self.effective_capacity,
                "in_flight": self._held_total,
                "waiters": sum(1 for t in self._tenants
                               if t._wait_since is not None),
                "tenants": {t.name: {"held": t._held, "grants": t._grants,
                                     "weight": round(self._weight(t), 3)}
                            for t in self._tenants},
            }


_GLOBAL_ADMISSION: "AdmissionScheduler | None" = None
_GLOBAL_ADMISSION_LOCK = threading.Lock()


def reset_global_admission() -> None:
    """Drop the process-wide scheduler so the NEXT global_admission()
    caller fixes a fresh capacity (bench harness / test isolation). Only
    safe with no production pipelines running: live tenants keep their
    seats on the old scheduler object until they close, so a reset under
    traffic splits capacity accounting across two schedulers."""
    global _GLOBAL_ADMISSION
    with _GLOBAL_ADMISSION_LOCK:
        _GLOBAL_ADMISSION = None


def global_admission(capacity: int | None = None) -> AdmissionScheduler:
    """The process-wide scheduler every production decode pipeline
    registers with — one device set serving many replication streams
    (apply loops, table-sync catchups, copy partitions). The FIRST caller
    fixes the capacity; `None` defaults to max(4, 2 × CUDA device count)
    — two in-flight batches per device keep each card fed while one batch
    streams back, and the floor keeps single-device hosts pipelined.
    Uncontended tenants are never throttled below their own in-flight
    window, so a lone pipeline behaves exactly as before."""
    global _GLOBAL_ADMISSION
    with _GLOBAL_ADMISSION_LOCK:
        if _GLOBAL_ADMISSION is None:
            if capacity is None or capacity <= 0:
                capacity = max(4, 2 * torch.cuda.device_count())
            _GLOBAL_ADMISSION = AdmissionScheduler(capacity)
        return _GLOBAL_ADMISSION


class _Interval:
    """[start, end) of one batch's in-flight (dispatch→fetch) span;
    end None while still in flight."""

    __slots__ = ("start", "end")

    def __init__(self, start: float):
        self.start = start
        self.end: float | None = None


class PipelinedDecode:
    """Handle for one submitted batch; duck-compatible with
    `_PendingDecode` (`.result()`), so DecodedBatchEvent and destination
    writers consume it unchanged. `result()` may be called out of submit
    order — completion state is per-handle — but in-order draining is
    what keeps the window from stalling the worker."""

    __slots__ = ("_pipe", "_future", "_done", "_exc", "_windowed",
                 "_demanded", "_admitted")

    def __init__(self, pipe: "DecodePipeline"):
        self._pipe = pipe
        self._future: Future = Future()
        self._done = None
        self._exc: BaseException | None = None
        self._windowed = False  # device route holds a window slot
        self._demanded = False  # a consumer is blocked on this handle
        self._admitted = False  # holds a shared admission ticket

    def abandon(self) -> None:
        """Discard a handle that will never be consumed (a hard-killed
        apply loop's flushed-but-undelivered window entries): return the
        pooled resources — staging arena, window slot, admission ticket —
        without paying the fetch. Completed handles already returned
        them in `_fetch`; a handle still packing releases via a
        done-callback the moment the worker resolves it; a handle whose
        worker errored released in the worker's except path. After
        abandon, `result()` is forbidden (the arena may be re-leased and
        dirtied by another batch) — consumers of an abandoned handle are
        gone by construction."""
        if self._done is not None or self._exc is not None:
            return  # fetched (or failed): resources already returned
        self._exc = RuntimeError("decode handle abandoned")

        def _release(fut) -> None:
            if fut.exception() is not None:
                return  # worker error path released window/admission
            value = fut.result()
            if len(value) == 2:
                return  # oracle route: no pooled resources held
            _pending, arena, iv = value
            pipe = self._pipe
            with pipe._lock:
                iv.end = time.perf_counter()
                if iv in pipe._inflight:
                    pipe._inflight.remove(iv)
            arena.release()
            if self._admitted:
                self._admitted = False
                pipe._admission.release()
            if self._windowed:
                self._windowed = False
                pipe.window.release()

        # runs immediately if already resolved, else on the worker
        # thread when pack/dispatch completes — either way exactly once
        self._future.add_done_callback(_release)

    def result(self):
        """Complete the batch (idempotent). A failed fetch is permanent:
        the first attempt already returned the arena to the pool, so a
        retry could read buffers another batch has dirtied — re-raise the
        recorded failure instead of re-completing."""
        if self._done is None:
            if self._exc is not None:
                raise self._exc
            try:
                self._done = self._pipe._fetch(self)
            except BaseException as e:
                self._exc = e
                raise
        return self._done


class DecodePipeline:
    """The scheduler: one pack/dispatch worker thread (with a CUDA stream
    of its own per device) + a bounded in-flight window + stage
    telemetry. Decoder-agnostic per submit, so one pipeline serves every
    table of an apply loop."""

    #: how often a consumer waiting on an undispatched batch checks that
    #: the worker is still alive
    _LIVENESS_S = 0.5

    def __init__(self, *, window: int = DEFAULT_WINDOW,
                 monitor: "MemoryMonitor | None" = None,
                 arena_pool: StagingArenaPool | None = None,
                 name: str = "decode",
                 admission: "TenantAdmission | None" = None):
        from ..runtime.backpressure import InFlightWindow

        # TenantAdmission | None: this pipeline's seat at the shared
        # AdmissionScheduler. Ownership transfers here — close() closes
        # it, releasing any tickets still held by undrained handles
        self._admission = admission
        self.window = InFlightWindow(max(1, window), monitor)
        self.pool = arena_pool if arena_pool is not None else ARENA_POOL
        # gauge label: several pipelines coexist (one per copy partition
        # + the apply loop's); unlabeled globals would last-writer-win
        self._name = name
        self._jobs: "queue.SimpleQueue" = queue.SimpleQueue()
        self._closed = False
        self._lock = threading.Lock()  # interval list + overlap counters
        self._inflight: list[_Interval] = []
        # handles submitted but not yet dispatched: the window's liveness
        # valve — a consumer blocked on one of these means the worker must
        # overshoot the window instead of deadlocking against it
        self._undispatched: list[PipelinedDecode] = []
        self._pack_seconds = 0.0
        self._overlap_seconds = 0.0
        self._published_pack = 0.0
        self._published_overlap = 0.0
        self._submitted = 0
        self._completed = 0
        # the worker's CUDA streams, one per device it dispatched to
        # (created and entered on the worker thread only)
        self._streams: dict[torch.device, torch.cuda.Stream] = {}
        self._worker = threading.Thread(
            target=self._run, name=f"etl-{name}-pipeline", daemon=True)
        self._worker.start()

    # -- producer side ------------------------------------------------------

    def submit(self, decoder: "DeviceDecoder",
               staged: StagedBatch) -> PipelinedDecode:
        """Schedule route→pack→dispatch on the worker; returns at once.
        The worker blocks on the in-flight window, not the caller — the
        submit queue itself is unbounded, bounded in practice by the
        caller's own batching (flush windows / COPY chunk thresholds)."""
        if self._closed:
            raise RuntimeError("decode pipeline is closed")
        handle = PipelinedDecode(self)
        self._submitted += 1
        with self._lock:
            self._undispatched.append(handle)
        self._jobs.put((decoder, staged, handle))
        return handle

    def _demand_waiting(self) -> bool:
        with self._lock:
            return any(h._demanded for h in self._undispatched)

    @property
    def in_flight(self) -> int:
        return len(self.window)

    @property
    def streams(self) -> "dict[torch.device, torch.cuda.Stream]":
        """The CUDA stream the worker dispatches on, per device."""
        return dict(self._streams)

    @property
    def worker_alive(self) -> bool:
        return self._worker.is_alive()

    @property
    def effective_window(self) -> int:
        return self.window.effective_limit

    def close(self) -> None:
        """Stop the worker. Handles already packed/dispatched stay
        resolvable; jobs still queued fail fast with RuntimeError (their
        events are re-streamed on resume — at-least-once). Close also
        opens the window's bypass so a worker blocked on slots held by
        abandoned handles (a failed copy partition that will never drain
        them) runs the queue down and exits instead of leaking the
        thread and everything queued behind it."""
        if not self._closed:
            self._closed = True
            self._jobs.put(None)
        if self._admission is not None:
            # deregister from the shared scheduler and reclaim any
            # tickets still held by undrained handles: an abandoned
            # pipeline must not strand shared device capacity. Handles
            # still resolvable after close release into the closed
            # tenant, which is a guarded no-op.
            self._admission.close()

    def join(self, timeout: float | None = None) -> None:
        """Wait for the worker to exit after `close()`."""
        self._worker.join(timeout)

    # -- worker side --------------------------------------------------------

    def _run(self) -> None:
        try:
            while True:
                item = self._jobs.get()
                if item is None:
                    return
                decoder, staged, handle = item
                try:
                    if self._closed:
                        raise RuntimeError(
                            "decode pipeline closed before this batch "
                            "packed")
                    self._process(decoder, staged, handle)
                # worker THREAD, not a coroutine: no asyncio cancellation
                # can land here; every failure must reach the consumer's
                # result(). Not a retry spin either: the loop blocks on
                # _jobs.get(), so a failing batch is reported once
                except BaseException as e:  # etl-lint: ignore[cancellation-swallow,unbounded-retry]
                    if handle._admitted:
                        handle._admitted = False
                        self._admission.release()
                    if handle._windowed:
                        handle._windowed = False
                        self.window.release()
                    handle._future.set_exception(e)
                finally:
                    with self._lock:
                        if handle in self._undispatched:
                            self._undispatched.remove(handle)
        finally:
            # however the worker leaves (close, or a fault outside the
            # per-batch handler), nothing queued behind it stays pending
            self._fail_queued(RuntimeError("decode pipeline worker exited"))

    def _fail_queued(self, exc: BaseException) -> None:
        while True:
            try:
                item = self._jobs.get_nowait()
            except queue.Empty:
                return
            if item is None or len(item) != 3:
                continue
            handle = item[2]
            with self._lock:
                if handle in self._undispatched:
                    self._undispatched.remove(handle)
            if not handle._future.done():
                handle._future.set_exception(exc)

    def _stream(self, device: torch.device):
        """The worker's stream context for a decoder on `device`: a CUDA
        stream of this pipeline's own, or nothing on the CPU."""
        if device.type != "cuda":
            return contextlib.nullcontext()
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        st = self._streams.get(device)
        if st is None:
            st = self._streams[device] = torch.cuda.Stream(device)
        return torch.cuda.stream(st)

    @hot_loop
    def _process(self, decoder: "DeviceDecoder", staged: StagedBatch,
                 handle: PipelinedDecode) -> None:
        """Pack + dispatch one batch on the worker thread. @hot_loop: runs
        once per batch on the dispatch path — fetches belong to _fetch."""
        from ..chaos import failpoints
        from ..telemetry.metrics import (ETL_DECODE_DISPATCH_SECONDS,
                                         ETL_DECODE_PACK_SECONDS,
                                         ETL_DECODE_PIPELINE_IN_FLIGHT,
                                         registry)
        from .engine import _PendingDecode

        # chaos site: fires once per submitted batch at pack-stage entry
        # (before routing, so small oracle-routed batches hit it too)
        failpoints.fail_point(failpoints.PIPELINE_PACK)
        # no degrade to the oracle here: a device batch that cannot pack,
        # upload or launch fails (the reference's simulated-OOM degrade,
        # ENGINE_DEVICE_OOM, has no counterpart in the port)
        mode, specs = decoder._route(staged)
        if mode == "oracle":
            # no device work: nothing to overlap, no window slot — the
            # consumer's result() runs the per-row oracle as before
            handle._future.set_result(
                (_PendingDecode(decoder, staged, (), None, None), None))
            return
        # window slot held from here until the fetch completes: caps the
        # arenas + device buffers of all in-flight batches. The bypass
        # keeps the pipeline live when a consumer blocks on a handle that
        # hasn't dispatched yet (out-of-order draining) or when close()
        # fires with abandoned slots outstanding: the window overshoots
        # instead of deadlocking against its own consumer.
        self.window.acquire(
            bypass=lambda: self._closed or self._demand_waiting())
        handle._windowed = True
        if self._admission is not None and not self._admission.closed:
            # shared-capacity seat AFTER the pipeline's own window: a
            # tenant blocked on its self-imposed window must not sit on a
            # ticket other tenants could use. Same liveness valve as the
            # window — a demanded-but-undispatched handle (or close)
            # overshoots rather than deadlocking the consumer.
            self._admission.acquire(
                bypass=lambda: self._closed or self._demand_waiting())
            handle._admitted = True
        arena = self.pool.lease()
        t0 = time.perf_counter()
        try:
            with self._stream(decoder.device):
                packed = decoder._pack_stage(staged, specs, arena=arena)
                t1 = time.perf_counter()
                failpoints.fail_point(failpoints.PIPELINE_DISPATCH)
                pending = decoder._dispatch_stage(staged, specs, packed)
            t2 = time.perf_counter()
        except BaseException:
            arena.release()
            raise
        iv = _Interval(t2)
        with self._lock:
            self._inflight.append(iv)
            # overlap: the part of THIS pack that ran while another batch
            # was between dispatch and fetch — nonzero means the host
            # packed batch N+1 while the device computed batch N
            overlap = 0.0
            for other in self._inflight:
                if other is iv:
                    continue
                end = other.end if other.end is not None else t1
                overlap += max(0.0, min(t1, end) - max(t0, other.start))
            self._pack_seconds += t1 - t0
            self._overlap_seconds += min(overlap, t1 - t0)
            pack_total = self._pack_seconds
            overlap_total = self._overlap_seconds
        registry.histogram_observe(ETL_DECODE_PACK_SECONDS, t1 - t0)
        registry.histogram_observe(ETL_DECODE_DISPATCH_SECONDS, t2 - t1)
        registry.gauge_set(ETL_DECODE_PIPELINE_IN_FLIGHT, len(self.window),
                           {"pipeline": self._name})
        self._publish_overlap(pack_total, overlap_total)
        handle._future.set_result((pending, arena, iv))

    def _publish_overlap(self, pack_total: float,
                         overlap_total: float) -> None:
        from ..telemetry.metrics import (
            ETL_DECODE_PIPELINE_OVERLAP_RATIO,
            ETL_DECODE_PIPELINE_OVERLAP_SECONDS_TOTAL,
            ETL_DECODE_PIPELINE_PACK_SECONDS_TOTAL, registry)

        # counters are registry-global (monotonic across pipelines):
        # publish the delta since this pipeline's last publication (only
        # the worker thread calls this, so the delta math is race-free)
        registry.counter_inc(ETL_DECODE_PIPELINE_PACK_SECONDS_TOTAL,
                             pack_total - self._published_pack)
        registry.counter_inc(ETL_DECODE_PIPELINE_OVERLAP_SECONDS_TOTAL,
                             overlap_total - self._published_overlap)
        self._published_pack = pack_total
        self._published_overlap = overlap_total
        if pack_total > 0:
            registry.gauge_set(ETL_DECODE_PIPELINE_OVERLAP_RATIO,
                               overlap_total / pack_total,
                               {"pipeline": self._name})

    # -- consumer side ------------------------------------------------------

    def _fetch(self, handle: PipelinedDecode):
        """Stage 3: wait out pack/dispatch if still running, fetch and
        complete the batch, then return the arena and window slot."""
        from ..chaos import failpoints
        from ..telemetry.metrics import (ETL_DECODE_FETCH_SECONDS,
                                         ETL_DECODE_PIPELINE_IN_FLIGHT,
                                         registry)

        handle._demanded = True  # window liveness valve, see _process
        while True:
            try:
                value = handle._future.result(timeout=self._LIVENESS_S)
                break
            except FutureTimeout:
                if not self._worker.is_alive() \
                        and not handle._future.done():
                    raise RuntimeError(
                        f"decode pipeline {self._name!r}: the worker died "
                        f"before this batch was dispatched") from None
        handle._demanded = False
        if len(value) == 2:  # oracle route: (pending, None)
            pending, _ = value
            t0 = time.perf_counter()
            try:
                failpoints.fail_point(failpoints.PIPELINE_FETCH)
                return pending.result()
            finally:
                with self._lock:
                    self._completed += 1
                registry.histogram_observe(ETL_DECODE_FETCH_SECONDS,
                                           time.perf_counter() - t0)
        pending, arena, iv = value
        t0 = time.perf_counter()
        try:
            failpoints.fail_point(failpoints.PIPELINE_FETCH)
            batch = pending.result()
        finally:
            now = time.perf_counter()
            with self._lock:
                iv.end = now
                if iv in self._inflight:
                    self._inflight.remove(iv)
                self._completed += 1
            arena.release()
            if handle._admitted:
                handle._admitted = False
                self._admission.release()
            if handle._windowed:
                handle._windowed = False
                self.window.release()
            registry.gauge_set(ETL_DECODE_PIPELINE_IN_FLIGHT,
                               len(self.window), {"pipeline": self._name})
        registry.histogram_observe(ETL_DECODE_FETCH_SECONDS, now - t0)
        return batch

    # -- introspection ------------------------------------------------------

    def stats(self) -> dict:
        with self._lock:
            pack = self._pack_seconds
            overlap = self._overlap_seconds
            out = {
                "submitted": self._submitted,
                "completed": self._completed,
                "in_flight": len(self.window),
                "window": self.window.limit,
                "pack_seconds_total": pack,
                "overlap_seconds_total": overlap,
                "overlap_ratio": overlap / pack if pack > 0 else 0.0,
                "arena": self.pool.stats(),
            }
        if self._admission is not None:
            out["admission"] = {"tenant": self._admission.name,
                                "held": self._admission.held,
                                "closed": self._admission.closed}
        return out
