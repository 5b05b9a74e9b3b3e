"""SupervisedDestination: timeout bounds + circuit breaker + heartbeat
around any Destination.

Every `startup`/`write_*`/`truncate`/`drop` call — and the durability
wait of every returned ack — is bounded by the configured per-call
timeout, so a destination that never returns surfaces as a classified
`EtlError(TIMEOUT)` instead of an eternal await. Failures feed the
per-destination circuit breaker; an open breaker sheds subsequent calls
with DESTINATION_UNAVAILABLE before any payload is built, turning a dead
sink into worker-backoff backpressure instead of an unbounded queue.

Chaos stall surface: `destination.write` stalls fire here (before the
bounded region's clock starts for the breaker, inside it for the
timeout), `destination.flush` stalls fire inside the bounded
`wait_durable`.

Copy of the reference's `etl_tpu/supervision/destination.py`, with one
departure: the wrapper forwards the inner destination's `egress_encoder`
(see `SupervisedDestination.egress_encoder`).
"""

from __future__ import annotations

import asyncio
from typing import Sequence

from ..chaos import failpoints
from ..destinations.base import Destination, WriteAck
from ..models.errors import ErrorKind, EtlError, is_poison_error as _is_poison
from .breaker import CircuitBreaker
from .heartbeat import Heartbeat


class BoundedAck(WriteAck):
    """WriteAck whose wait_durable is bounded by the op timeout and
    reported to the breaker: a flush that never resolves is a sink
    failure like any other."""

    __slots__ = ("_inner", "_timeout", "_breaker", "_hb")

    def __init__(self, inner: WriteAck, timeout_s: float,
                 breaker: CircuitBreaker | None,
                 hb: Heartbeat | None):
        self._inner = inner
        self._timeout = timeout_s
        self._breaker = breaker
        self._hb = hb

    @property
    def is_durable(self) -> bool:
        return self._inner.is_durable

    async def wait_durable(self) -> None:
        try:
            if self._timeout > 0:
                await asyncio.wait_for(self._inner.wait_durable(),
                                       self._timeout)
            else:
                await self._inner.wait_durable()
        except asyncio.TimeoutError:
            self._record(ok=False)
            from ..telemetry.metrics import (
                ETL_DESTINATION_OP_TIMEOUTS_TOTAL, registry)

            registry.counter_inc(ETL_DESTINATION_OP_TIMEOUTS_TOTAL,
                                 labels={"op": "flush"})
            raise EtlError(
                ErrorKind.TIMEOUT,
                f"destination flush exceeded {self._timeout:.1f}s "
                f"(wait_durable never resolved)")
        except asyncio.CancelledError:
            # abandoned flush (worker restart): no verdict — release a
            # half-open trial slot instead of stranding it
            if self._breaker is not None:
                self._breaker.abort_call()
            raise
        except Exception as e:
            self._record(ok=False, available=_is_poison(e))
            raise
        else:
            self._record(ok=True)

    def _record(self, ok: bool, available: bool = False) -> None:
        if self._hb is not None:
            self._hb.beat(progress=("flush", ok), busy=False)
        if self._breaker is None:
            return
        if ok or available:
            # `available`: the sink REFUSED the payload (poison kind) —
            # a definitive 4xx-class response proves the destination is
            # up, so the availability breaker must not count it; the
            # isolation layer (runtime/poison.py) owns that failure
            # class, and tripping the breaker on it would turn one
            # poison row into shedding for every table
            self._breaker.record_success()
        else:
            self._breaker.record_failure()


class SupervisedDestination(Destination):
    """Wraps the configured destination for the pipeline's workers.

    `inner` stays reachable for tests and the maintenance agent; the
    wrapper is intentionally stateless beyond the breaker + heartbeat so
    a restarted pipeline can re-wrap the same inner destination."""

    def __init__(self, inner: Destination, *, timeout_s: float = 60.0,
                 breaker: CircuitBreaker | None = None,
                 heartbeat: Heartbeat | None = None):
        self.inner = inner
        # egress/billing labels must name the REAL sink, not the wrapper
        # (record_egress call sites read this attribute when present)
        self.telemetry_name = getattr(inner, "telemetry_name",
                                      type(inner).__name__)
        self.timeout_s = timeout_s
        self.breaker = breaker
        self.heartbeat = heartbeat
        self._ops = 0

    @property
    def egress_encoder(self) -> "str | None":
        """The inner destination's wire encoder, so that the decoders of a
        supervised pipeline (the default config) render its text on the
        card. The reference's wrapper hides it, and with supervision on
        its decoders render none; the text is the bytes the inner sink
        renders without it, so no payload changes."""
        return getattr(self.inner, "egress_encoder", None)

    @staticmethod
    async def _stallable(coro):
        """Chaos: a wedged destination call is a silent hang — injected
        INSIDE the bounded region so the per-op timeout (the companion of the
        watchdog) is what recovers it, not the raise path."""
        try:
            await failpoints.stall_point(failpoints.DESTINATION_WRITE)
        except BaseException:
            coro.close()  # cancelled mid-stall: never awaited otherwise
            raise
        return await coro

    async def _bounded(self, op: str, coro, *, gated: bool = True):
        """Run one destination call: breaker gate → stall site → bounded
        await → breaker/heartbeat accounting."""
        if gated and self.breaker is not None:
            self.breaker.before_call()
        if self.heartbeat is not None:
            self._ops += 1
            self.heartbeat.beat(progress=("op", self._ops), busy=True)
        try:
            if self.timeout_s > 0:
                result = await asyncio.wait_for(self._stallable(coro),
                                                self.timeout_s)
            else:
                result = await self._stallable(coro)
        except asyncio.TimeoutError:
            if gated and self.breaker is not None:
                self.breaker.record_failure()
            if self.heartbeat is not None:
                self.heartbeat.beat(progress=("timeout", self._ops),
                                    busy=False)
            from ..telemetry.metrics import (
                ETL_DESTINATION_OP_TIMEOUTS_TOTAL, registry)

            registry.counter_inc(ETL_DESTINATION_OP_TIMEOUTS_TOTAL,
                                 labels={"op": op})
            raise EtlError(
                ErrorKind.TIMEOUT,
                f"destination {op} exceeded {self.timeout_s:.1f}s")
        except asyncio.CancelledError:
            # no verdict on the sink: a cancelled half-open trial must
            # release its slot or the breaker wedges open forever
            if gated and self.breaker is not None:
                self.breaker.abort_call()
            raise
        except Exception as e:
            # EtlError and any unexpected failure alike count against
            # the sink (an exception with no classification is still a
            # failed call, and must not strand a half-open trial) —
            # EXCEPT poison-kind rejections: a definitive payload
            # refusal proves the sink is up and answering, and counting
            # it would let one poison row (or its bisection probes) trip
            # availability shedding for every table. The isolation layer
            # owns that failure class (runtime/poison.py).
            if gated and self.breaker is not None:
                if _is_poison(e):
                    self.breaker.record_success()
                else:
                    self.breaker.record_failure()
            if self.heartbeat is not None:
                self.heartbeat.beat(progress=("error", self._ops),
                                    busy=False)
            raise
        if self.heartbeat is not None:
            self.heartbeat.beat(progress=("done", self._ops), busy=False)
        if isinstance(result, WriteAck):
            if result.is_durable and gated and self.breaker is not None:
                # durable-on-return acks settle the breaker now; accepted
                # acks settle it when the bounded wait_durable resolves
                self.breaker.record_success()
            return BoundedAck(result, self.timeout_s,
                              self.breaker if gated else None,
                              self.heartbeat)
        if gated and self.breaker is not None:
            self.breaker.record_success()
        return result

    # -- Destination ---------------------------------------------------------

    async def startup(self) -> None:
        # startup is NOT breaker-gated: a restarted pipeline must be able
        # to probe a recovering sink without the old open breaker shedding
        # its first call
        await self._bounded("startup", self.inner.startup(), gated=False)

    async def write_table_rows(self, schema, batch) -> WriteAck:
        return await self._bounded(
            "write_table_rows", self.inner.write_table_rows(schema, batch))

    async def write_events(self, events: Sequence) -> WriteAck:
        return await self._bounded(
            "write_events", self.inner.write_events(events))

    # columnar seam: bounded + breaker-gated like the row entry points
    # (same op labels — the timeout metric and breaker verdicts must not
    # fork per encoding); the INNER destination decides whether it
    # implements the batch write natively or falls back to rows
    async def write_table_batch(self, schema, batch) -> WriteAck:
        return await self._bounded(
            "write_table_rows", self.inner.write_table_batch(schema, batch))

    async def write_event_batches(self, events: Sequence) -> WriteAck:
        return await self._bounded(
            "write_events", self.inner.write_event_batches(events))

    # transactional seam (docs/destinations.md exactly-once contract):
    # committed writes are bounded + breaker-gated under the SAME
    # "write_events" op label as the at-least-once CDC path — the timeout
    # metric and breaker verdicts must not fork per delivery guarantee.
    # The recovery query is NOT breaker-gated: it runs at restart, where
    # an open breaker from the crashed attempt must not shed the one
    # call that would trim the re-stream window (Pipeline.start must
    # never wedge on it; the caller owns retry + degradation).
    def supports_transactional_commit(self) -> bool:
        return self.inner.supports_transactional_commit()

    async def write_event_batches_committed(self, events: Sequence,
                                            commit) -> WriteAck:
        return await self._bounded(
            "write_events",
            self.inner.write_event_batches_committed(events, commit))

    async def recover_high_water(self):
        return await self._bounded(
            "recover_high_water", self.inner.recover_high_water(),
            gated=False)

    async def drop_table(self, table_id, schema=None) -> None:
        await self._bounded("drop_table",
                            self.inner.drop_table(table_id, schema))

    async def truncate_table(self, table_id) -> None:
        await self._bounded("truncate_table",
                            self.inner.truncate_table(table_id))

    async def shutdown(self) -> None:
        # shutdown is never gated or bounded-failed into the breaker —
        # teardown must always reach the inner destination
        if self.timeout_s > 0:
            await asyncio.wait_for(self.inner.shutdown(), self.timeout_s)
        else:
            await self.inner.shutdown()
