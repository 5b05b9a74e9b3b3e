"""Shared destination helpers.

Copy of the parts of the reference's `etl_tpu/destinations/util.py` that
the ported destinations use: the background task set and the
order-preserving event program row-oriented writers consume. The CDC
metadata, naming, HTTP retry and Arrow helpers of the other destinations
come with them, in a later slice.
"""

from __future__ import annotations

import asyncio


class TaskSet:
    """Background destination tasks with joined shutdown
    (reference concurrency/task_set.rs)."""

    def __init__(self) -> None:
        self._tasks: set[asyncio.Task] = set()

    def spawn(self, coro) -> asyncio.Task:
        t = asyncio.ensure_future(coro)
        self._tasks.add(t)
        t.add_done_callback(self._tasks.discard)
        return t

    async def join(self) -> None:
        if self._tasks:
            await asyncio.gather(*list(self._tasks), return_exceptions=True)

    async def cancel_all(self) -> None:
        for t in list(self._tasks):
            t.cancel()
        await self.join()


def _identity_values(schema, row):
    """Identity-column values of a row, in replicated order."""
    idx = schema.replicated_indices
    identity = schema.identity_mask
    return tuple(v for i, v in enumerate(row.values) if identity[idx[i]])


def split_key_changing_update(e):
    """An UPDATE whose old image shows a different replica identity leaves
    the old-identity row stale in upsert-keyed destinations. Emit
    DELETE(old identity) + the update, mirroring reference
    ducklake/batches.rs `Full → Delete{origin: update} + Upsert`
    (key-changing updates would otherwise leave duplicate rows in
    _current views). Returns [events…] to apply in order."""
    from ..models.event import DeleteEvent, UpdateEvent

    if not isinstance(e, UpdateEvent) or e.old_row is None:
        return [e]
    if _identity_values(e.schema, e.old_row) == \
            _identity_values(e.schema, e.row):
        return [e]
    return [DeleteEvent(e.start_lsn, e.commit_lsn, e.tx_ordinal, e.schema,
                        e.old_row), e]


def sequential_event_program(events):
    """Order-preserving destination program: yields ("rows", schema, [row
    events…]) runs and ("truncate", event) / ("schema_change", event)
    barriers, splitting runs so WAL order is preserved — rows preceding a
    truncate in the batch must land before it executes. Key-changing
    updates expand to DELETE(old identity) + update.

    Accepts expanded per-row events (use expand_batch_events first)."""
    from ..models.event import (DeleteEvent, InsertEvent, SchemaChangeEvent,
                                TruncateEvent, UpdateEvent)

    run_schema = None
    run: list = []
    flat = (e for outer in events
            for e in (split_key_changing_update(outer)
                      if isinstance(outer, UpdateEvent) else (outer,)))
    for e in flat:
        if isinstance(e, (InsertEvent, UpdateEvent, DeleteEvent)):
            if run_schema is not None and (run_schema.id != e.schema.id
                                           or run_schema != e.schema):
                yield ("rows", run_schema, run)
                run = []
            run_schema = e.schema
            run.append(e)
        elif isinstance(e, (TruncateEvent, SchemaChangeEvent)):
            if run:
                yield ("rows", run_schema, run)
                run, run_schema = [], None
            if isinstance(e, TruncateEvent):
                yield ("truncate", e)
            elif e.new_schema is not None:
                yield ("schema_change", e)
        # Begin/Commit/Relation: ordering barriers with no destination op
    if run:
        yield ("rows", run_schema, run)
