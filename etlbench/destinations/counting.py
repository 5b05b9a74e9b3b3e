"""The counting destination (`"destination": "counting"` in a mix):
counts what the pipeline delivers and keeps it for the check made once
the window has closed.

Every decoded batch is resolved inside the write, as a destination that
ships it would (the device work and the fetch complete there). A write
records, per batch, the columns the program produced and the identity
arrays the pipeline attached (commit LSN and ordinal of each CDC row);
copied batches are kept by table and by sync. Rows the poison isolator
would expand into per-row INSERT events are kept the same way, a run of
them at a time. `progress` is set after every write, so that a closed
loop producer can wait for the backlog to shrink. Each CDC batch keeps
the host clock of its arrival (`time.perf_counter`), for readers of lag.

A destination module of `etlbench/destinations/` gives `make(span)`: a
fresh destination with this one's bookkeeping (`rows`, `sync`, `copied`,
`cdc`, `last_lsn`, `last_lsn_rows`, `malformed`, `progress`), which the
traffic kinds and their checks read; another destination subclasses or
wraps this one.
"""

from __future__ import annotations

import asyncio
import contextlib
import time

import numpy as np


def make(span=None):
    """A fresh counting destination; `span(name)` is a context manager
    around each write (the traced run's host span), or None."""
    from etl_tpu_torch.destinations.base import Destination, WriteAck
    from etl_tpu_torch.models.event import DecodedBatchEvent, InsertEvent
    from etl_tpu_torch.models.table_row import ColumnarBatch

    class CountingSink(Destination):
        def __init__(self):
            self.rows = 0  # rows delivered, copy and CDC
            self.sync = 0  # the copy's sync that batches count under
            self.copied: dict = {}  # (sync, table id) -> [batch, ...]
            self.cdc: list = []  # (batch, commit LSNs, ordinals, arrival)
            self.last_lsn = -1  # highest commit LSN delivered
            self.last_lsn_rows = 0  # rows delivered of that commit
            self.malformed = 0  # batches whose rows and identities differ
            self.progress = asyncio.Event()

        async def startup(self):
            return None

        def _span(self, name):
            return span(name) if span is not None \
                else contextlib.nullcontext()

        async def write_table_rows(self, schema, batch):
            with self._span("destination.write_table_rows"):
                self.copied.setdefault((self.sync, schema.id),
                                       []).append(batch)
                self.rows += batch.num_rows
            self.progress.set()
            return WriteAck.durable()

        async def write_event_batches(self, events):
            return await self.write_events(events)

        async def write_events(self, events):
            with self._span("destination.write_events"):
                rows: list = []
                for e in events:
                    if isinstance(e, InsertEvent):
                        rows.append(e)
                        continue
                    self._keep_rows(rows)
                    if isinstance(e, DecodedBatchEvent):
                        b = e.batch  # resolves the decode
                        self._keep(b, np.asarray(e.commit_lsns),
                                   np.asarray(e.tx_ordinals))
                self._keep_rows(rows)
            self.progress.set()
            return WriteAck.durable()

        def _keep(self, b, commits, ordinals) -> None:
            if not (len(commits) == len(ordinals) == b.num_rows):
                # rows that do not line up with their identities: none of
                # them counts as delivered (the check finds them missing)
                self.malformed += 1
                return
            self.cdc.append((b, commits, ordinals, time.perf_counter()))
            self.rows += b.num_rows
            if b.num_rows:
                last = int(commits[-1])
                n_last = b.num_rows - int(np.searchsorted(commits, last))
                if last == self.last_lsn:
                    self.last_lsn_rows += n_last
                else:
                    self.last_lsn, self.last_lsn_rows = last, n_last

        def _keep_rows(self, rows: list) -> None:
            if not rows:
                return
            b = ColumnarBatch.from_rows(rows[0].schema,
                                        [e.row for e in rows])
            self._keep(b, np.asarray([int(e.commit_lsn) for e in rows],
                                     dtype=np.uint64),
                       np.asarray([e.tx_ordinal for e in rows],
                                  dtype=np.uint64))
            rows.clear()

        async def drop_table(self, table_id, schema=None):
            # a restarted table sync recopies: its earlier rows go
            dropped = self.copied.pop((self.sync, table_id), [])
            self.rows -= sum(b.num_rows for b in dropped)

        async def truncate_table(self, table_id):
            return None

    return CountingSink()
