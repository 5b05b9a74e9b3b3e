"""Operator surface of the durable dead-letter store.

`python -m etl_tpu_torch.dlq` (see `__main__.py`) and the programmatic
`DeadLetterQueue` wrap the `StateStore` dead-letter/quarantine surface
(store/base.py) with the operator verbs:

  list          — entries (optionally per table / per status)
  inspect       — one entry with its decoded payload
  replay        — re-deliver entries through the DESTINATION SEAM
                  (`Destination.write_event_batches`, the same entry
                  point the apply loop uses) in WAL order, durably, then
                  mark them `replayed`. IDEMPOTENT: already-replayed
                  entries are skipped, and a crash mid-replay re-runs
                  safely because CDC delivery is keyed by
                  (commit_lsn, tx_ordinal) — destinations collapse the
                  duplicate exactly like any at-least-once redelivery.
  discard       — mark entries `discarded` (kept for audit)
  compact       — TTL expiry: delete replayed/discarded entries older
                  than the retention window (`dead` entries are the
                  zero-loss ledger and never expire)
  unquarantine  — lift a table's quarantine record; a RUNNING
                  replicator adopts the lift live at its next
                  quarantine poll (PoisonConfig.quarantine_poll_s,
                  default 30 s) — no restart needed

The zero-loss invariant this surface completes:
`delivered ∪ dead-lettered == committed truth` (docs/dead-letter.md) —
replay moves rows from the right side of the union to the left.

Copy of the reference's `etl_tpu/dlq/__init__.py`.
"""

from __future__ import annotations

from ..models.errors import ErrorKind, EtlError
from ..store.base import (DLQ_STATUS_DEAD, DLQ_STATUS_DISCARDED,
                          DLQ_STATUS_REPLAYED, DeadLetterEntry,
                          QuarantineRecord)
from .codec import decode_cell, decode_row_event, encode_row_event

__all__ = [
    "DeadLetterQueue",
    "DeadLetterEntry",
    "QuarantineRecord",
    "decode_cell",
    "decode_row_event",
    "encode_row_event",
]


class DeadLetterQueue:
    """Operator verbs over one pipeline's dead-letter surface. `store`
    is any PipelineStore (memory / sqlite)."""

    def __init__(self, store):
        self.store = store

    async def list(self, table_id=None, status=DLQ_STATUS_DEAD
                   ) -> "list[DeadLetterEntry]":
        return await self.store.list_dead_letters(table_id, status)

    async def inspect(self, entry_id: int) -> dict:
        import json

        entry = await self.store.get_dead_letter(entry_id)
        if entry is None:
            raise EtlError(ErrorKind.STATE_STORE_FAILED,
                           f"no dead-letter entry {entry_id}")
        doc = entry.describe()
        payload = json.loads(entry.payload)
        doc["payload"] = payload
        schema = await self.store.get_table_schema(entry.table_id)
        if schema is not None:
            try:
                ev = decode_row_event(entry, schema)
                row = getattr(ev, "row", None) or getattr(ev, "old_row")
                doc["decoded_values"] = [repr(v) for v in row.values]
            except EtlError as e:
                doc["decode_error"] = str(e)
        return doc

    async def replay(self, destination, entry_ids=None, table_id=None,
                     include_replayed: bool = False) -> dict:
        """Re-deliver dead entries through `write_event_batches` in WAL
        order and mark them replayed once DURABLE. Returns a summary.

        Idempotent by construction: `replayed` entries are skipped
        (unless `include_replayed` forces a re-push — itself safe, CDC
        delivery is keyed by WAL coordinates), and a crash after the
        write but before the status flip re-replays rows a destination
        collapses as at-least-once duplicates. Against a transactional
        sink the replay ships a `CommitRange(replay=True)` so the
        re-run dedups by exact WAL row key with ZERO duplicates, and
        the sink's streaming high-water stays untouched."""
        from ..telemetry.metrics import ETL_DLQ_REPLAYED_TOTAL, registry

        if entry_ids is not None:
            entries = []
            for eid in entry_ids:
                e = await self.store.get_dead_letter(eid)
                if e is None:
                    raise EtlError(ErrorKind.STATE_STORE_FAILED,
                                   f"no dead-letter entry {eid}")
                entries.append(e)
        else:
            entries = await self.list(table_id=table_id, status=None)
        wanted = {DLQ_STATUS_DEAD}
        if include_replayed:
            wanted.add(DLQ_STATUS_REPLAYED)
        skipped_status: list[dict] = []
        if entry_ids is not None:
            # an explicitly-requested entry excluded by the status
            # filter must be REPORTED, not silently dropped — an
            # operator replaying `--ids 5` where 5 is discarded would
            # otherwise read empty success
            skipped_status = [
                {"entry_id": e.entry_id,
                 "reason": f"status is {e.status!r}, not replayable "
                           f"(pass --include-replayed to re-push "
                           f"replayed entries; discarded entries stay "
                           f"discarded)"}
                for e in entries if e.status not in wanted]
        entries = [e for e in entries if e.status in wanted]
        # WAL order across the whole replay set — destinations see the
        # rows in their original commit order
        entries.sort(key=lambda e: (e.commit_lsn, e.tx_ordinal,
                                    e.entry_id))
        skipped: list[dict] = list(skipped_status)
        events = []
        replayable: list[DeadLetterEntry] = []
        for e in entries:
            schema = await self.store.get_table_schema(e.table_id)
            if schema is None:
                skipped.append({"entry_id": e.entry_id,
                                "reason": f"no stored schema for table "
                                          f"{e.table_id}"})
                continue
            try:
                events.append(decode_row_event(e, schema))
            except EtlError as err:
                skipped.append({"entry_id": e.entry_id,
                                "reason": str(err)})
                continue
            replayable.append(e)
        if events:
            if destination.supports_transactional_commit():
                # replay-mode committed write: the original WAL
                # coordinates ride along so a transactional sink dedups
                # a re-run replay by EXACT row key — and `replay=True`
                # keeps the sink's streaming high-water untouched
                # (parked rows sit BELOW it; advancing it here would
                # make the live stream drop rows it never applied)
                from ..destinations.base import CommitRange

                rng = CommitRange.from_events(events, replay=True)
                if rng is not None:
                    ack = await destination \
                        .write_event_batches_committed(events, rng)
                else:  # pragma: no cover — replays always carry coords
                    ack = await destination.write_event_batches(events)
            else:
                ack = await destination.write_event_batches(events)
            if ack is not None:
                await ack.wait_durable()
        for e in replayable:
            await self.store.set_dead_letter_status(e.entry_id,
                                                    DLQ_STATUS_REPLAYED)
            registry.counter_inc(ETL_DLQ_REPLAYED_TOTAL)
        return {"replayed": [e.entry_id for e in replayable],
                "skipped": skipped}

    async def discard(self, entry_ids) -> list[int]:
        from ..telemetry.metrics import ETL_DLQ_DISCARDED_TOTAL, registry

        done = []
        for eid in entry_ids:
            e = await self.store.get_dead_letter(eid)
            if e is None:
                raise EtlError(ErrorKind.STATE_STORE_FAILED,
                               f"no dead-letter entry {eid}")
            await self.store.set_dead_letter_status(eid,
                                                    DLQ_STATUS_DISCARDED)
            registry.counter_inc(ETL_DLQ_DISCARDED_TOTAL)
            done.append(eid)
        return done

    async def compact(self, older_than_s: float,
                      statuses=None) -> dict:
        """TTL compaction: delete terminal (replayed/discarded) entries
        whose last status transition is older than `older_than_s`
        seconds. `dead` entries never expire — they are the zero-loss
        ledger — and passing "dead" in `statuses` is refused."""
        statuses = tuple(statuses) if statuses else (
            DLQ_STATUS_REPLAYED, DLQ_STATUS_DISCARDED)
        if DLQ_STATUS_DEAD in statuses:
            raise EtlError(
                ErrorKind.STATE_STORE_FAILED,
                "refusing to expire `dead` entries: they are the "
                "zero-loss ledger (replay or discard them first)")
        purged = await self.store.purge_dead_letters(older_than_s,
                                                     statuses)
        return {"purged": purged, "older_than_s": older_than_s,
                "statuses": sorted(statuses)}

    async def quarantined(self) -> dict:
        return await self.store.get_quarantined_tables()

    async def unquarantine(self, table_id: int) -> bool:
        """Lift a table's quarantine. Returns False when the table was
        not quarantined. A running replicator adopts the lift LIVE at
        its next quarantine poll (PoisonConfig.quarantine_poll_s,
        default 30 s) — docs/dead-letter.md runbook: replay first,
        then unquarantine; no pod roll required."""
        records = await self.store.get_quarantined_tables()
        if table_id not in records:
            return False
        await self.store.set_table_quarantine(table_id, None)
        return True
