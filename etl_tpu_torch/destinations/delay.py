"""DelayedAckDestination: a latency model for the ack round trip.

Copy of the reference's `etl_tpu/destinations/delay.py`.

Wraps any destination and delays every ack's DURABILITY by `delay_s`
while the write itself applies immediately — exactly the shape of a real
destination (BigQuery commit, ClickHouse insert quorum, an object-store
PUT) where `write_*` hands the payload off fast and crash-safety is
signalled one round trip later. The apply loop's bounded write window
(runtime/ack_window.py) exists to hide this latency; `bench.py
--ack-latency` wraps the null destination with this class and measures
windowed vs window=1 throughput, and the chaos K-in-flight crash
scenario uses it to hold ≥2 acks in flight deterministically at the
kill point.

Accounting for assertions: `pending` / `max_pending` count unresolved
delayed acks — `max_pending >= 2` is the evidence that a run actually
overlapped ack round trips (window=1 can never exceed 1)."""

from __future__ import annotations

import asyncio
from typing import Sequence

from ..models.errors import ErrorKind, EtlError
from .base import Destination, WriteAck
from .util import TaskSet


class DelayedAckDestination(Destination):
    def __init__(self, inner: Destination, delay_s: float):
        self.inner = inner
        self.delay_s = delay_s
        # egress/billing labels must name the REAL sink, not the wrapper
        self.telemetry_name = getattr(inner, "telemetry_name",
                                      type(inner).__name__)
        self.pending = 0
        self.max_pending = 0
        self.acks_issued = 0
        self._tasks = TaskSet()
        self._shut_down = False

    async def _delayed(self, inner_ack: WriteAck) -> WriteAck:
        self.acks_issued += 1
        if self.delay_s <= 0:
            return inner_ack
        ack, fut = WriteAck.accepted()
        self.pending += 1
        self.max_pending = max(self.max_pending, self.pending)

        async def settle() -> None:
            try:
                await inner_ack.wait_durable()
                await asyncio.sleep(self.delay_s)
            except asyncio.CancelledError:
                if not fut.done():
                    fut.set_exception(EtlError(
                        ErrorKind.DESTINATION_FAILED,
                        "destination shut down with a delayed ack "
                        "pending"))
                    fut.exception()  # retrieved: consumer may be gone
                raise
            except Exception as e:
                if not fut.done():
                    fut.set_exception(e)
                    fut.exception()
            else:
                if not fut.done():
                    fut.set_result(None)
            finally:
                self.pending -= 1

        if self._shut_down:
            self.pending -= 1
            fut.set_exception(EtlError(
                ErrorKind.DESTINATION_FAILED,
                "destination already shut down"))
            fut.exception()
            return ack
        self._tasks.spawn(settle())
        return ack

    # -- Destination ----------------------------------------------------------

    async def startup(self) -> None:
        self._shut_down = False
        await self.inner.startup()

    async def write_table_rows(self, schema, batch) -> WriteAck:
        return await self._delayed(
            await self.inner.write_table_rows(schema, batch))

    async def write_events(self, events: Sequence) -> WriteAck:
        return await self._delayed(await self.inner.write_events(events))

    async def write_table_batch(self, schema, batch) -> WriteAck:
        return await self._delayed(
            await self.inner.write_table_batch(schema, batch))

    async def write_event_batches(self, events: Sequence) -> WriteAck:
        return await self._delayed(
            await self.inner.write_event_batches(events))

    # transactional seam: the inner sink commits data + coordinate range
    # immediately, only the ACK is delayed — exactly the crash window the
    # exactly-once chaos matrix kills inside (sink has the range, the
    # pipeline never saw the ack, recovery must not double-apply)
    def supports_transactional_commit(self) -> bool:
        return self.inner.supports_transactional_commit()

    async def write_event_batches_committed(self, events: Sequence,
                                            commit) -> WriteAck:
        return await self._delayed(
            await self.inner.write_event_batches_committed(events, commit))

    async def recover_high_water(self):
        return await self.inner.recover_high_water()

    async def drop_table(self, table_id, schema=None) -> None:
        await self.inner.drop_table(table_id, schema)

    async def truncate_table(self, table_id) -> None:
        await self.inner.truncate_table(table_id)

    async def shutdown(self) -> None:
        self._shut_down = True
        await self._tasks.cancel_all()
        await self.inner.shutdown()
