"""`initial_copy`: initial syncs of every table of the configuration,
back to back, each a fresh Pipeline and state store over the same source
database; one sync runs before the window. A sync that the window's end
cuts counts the rows it delivered by then. Parameters (the mix's file):
none but `kind` and `destination`.
"""

from __future__ import annotations

import asyncio

import numpy as np

from .. import check, datagen, system, textenc, traffic
from ..reference import decode as ref

SUFFIX = "copy"


class Driver:
    def __init__(self, cell, seed: int, device: str, scale: float,
                 span=None):
        self.config = cell.config
        self.settings = cell.config.get("pipeline", {})
        self.lowering = cell.config["control"]
        self.mix = cell.traffic
        self.device = device
        self.seed = seed
        self.scale = scale
        self.span = span
        self.complete: list = []  # syncs that reached READY for all
        self.cut = None  # the sync the window's end cut

    async def setup(self) -> None:
        self.tspecs = self.config["tables"]
        self.tables = datagen.make_tables(self.config, self.seed, self.scale)
        self.texts = [textenc.copy_text(t.cols) for t in self.tables]
        self.db = system.fake_database(self.tables, self.tspecs, self.texts)
        self.ids = [t["relid"] for t in self.tspecs]
        self.sink = traffic.destination(self.mix, self.span)
        # the warm-up sync, off the clock
        await asyncio.wait_for(self._sync(0), traffic.WARMUP_S)
        self._task = None

    async def _sync(self, k: int) -> None:
        self.sink.sync = k
        run = traffic.Running(self.db, self.sink, self.settings, k + 1,
                              self.device)
        self.cut = k
        try:
            await run.start()
            await run.ready(self.ids)
            self.complete.append(k)
        finally:
            await run.stop()
            # the finished pipeline's slots and snapshots go with it
            self.db.slots.clear()
            self.db.snapshots.clear()
        self.cut = None

    async def _loop(self) -> None:
        k = 1
        while True:
            await self._sync(k)
            k += 1

    def mark(self) -> int:
        if self._task is None:
            self._task = asyncio.ensure_future(self._loop())
        return self.sink.rows

    def rate(self, a: int, b: int, seconds: float) -> dict:
        return {"copy_rows_per_s": (b - a) / seconds}

    async def close(self) -> None:
        self._task.cancel()
        try:
            await self._task
        except asyncio.CancelledError:
            pass

    def release(self) -> None:
        self.db = None

    def check(self, control: bool) -> dict:
        missing = extra = cells = numeric = due = 0
        bad_by: dict = {}
        rng = np.random.default_rng(datagen.seed_words(self.seed, 2))
        syncs = sorted(self.complete + ([self.cut] if self.cut is not None
                                        else []))
        for t, tspec, text in zip(self.tables, self.tspecs, self.texts):
            specs = tspec["columns"]
            fields = ref.split_copy(text, len(specs))
            pk = [i for _, i in sorted((c["pk"], i)
                                       for i, c in enumerate(specs)
                                       if c.get("pk"))]
            keys = [c.values for c in ref.decode(
                [specs[i] for i in pk], fields.columns(pk))]
            want_key = _mixed_key(keys)
            order = np.argsort(want_key, kind="stable")
            sorted_key = want_key[order]
            # every cell of a sample of the table's rows, in every sync
            picked = np.zeros(len(want_key), dtype=bool)
            picked[check.sample(len(want_key), check.COPY_SAMPLE_ROWS,
                                rng)] = True
            cols = ref.decode(specs, fields.rows(np.flatnonzero(picked)))
            at_pick = np.cumsum(picked) - 1
            for s in syncs:
                batches = self.sink.copied.get((s, tspec["relid"]), [])
                got = check.Delivered(batches, specs)
                key = _mixed_key([got.key(i) for i in pk], keys)
                pos = np.minimum(np.searchsorted(sorted_key, key),
                                 len(sorted_key) - 1)
                found = sorted_key[pos] == key
                ridx = order[pos]
                _, first_at = np.unique(np.where(found, ridx,
                                                 -1 - np.arange(len(key))),
                                        return_index=True)
                rows = np.sort(first_at[found[first_at]])
                extra += int(len(key) - len(rows))
                if s in self.complete:
                    missing += int(len(want_key) - len(rows))
                due += len(want_key) if s in self.complete else len(rows)
                rows = rows[picked[ridx[rows]]]
                want = check.take_ref(cols, at_pick[ridx[rows]])
                if control:
                    got, sel = check.Control(want, self.lowering), np.arange(len(rows))
                else:
                    sel = rows
                bad = check.cells_bad(want, got, sel)
                for k, v in bad.items():
                    bad_by[f"{t.name}.{k}"] = bad_by.get(f"{t.name}.{k}",
                                                         0) + v
                cells += sum(bad.values())
                numeric += check.numeric_bad(want, got, sel, rng)
        return {"rows_missing": missing, "rows_extra": extra,
                "cells_bad": cells, "numeric_bad": numeric,
                "detail": {"due": due, "syncs_complete": len(self.complete),
                           "sync_cut": self.cut is not None,
                           "bad_by_column": {k: v for k, v in bad_by.items()
                                             if v}}}


def _mixed_key(parts: list, ranges: "list | None" = None) -> np.ndarray:
    """One int64 a row from integer key columns, in key order, each
    shifted by the reference's range of that column (`ranges`, else the
    columns themselves); a value outside it cannot match."""
    ranges = ranges or parts
    key = np.zeros(len(parts[0]), dtype=np.int64)
    ok = np.ones(len(parts[0]), dtype=bool)
    for p, r in zip(parts, ranges):
        lo, hi = int(r.min(initial=0)), int(r.max(initial=0))
        span = hi - lo + 1
        ok &= (p >= lo) & (p <= hi)
        key = key * span + np.clip(p, lo, hi) - lo
    return np.where(ok, key, -1)
