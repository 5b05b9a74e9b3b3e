"""`cdc_insert_drain`: insert transactions into one table, as a slot's
backlog after a burst or a restart. Parameters (the mix's file):

- `table`: the configuration's table; its first column is an integer key
  of the primary key;
- `tx_rows`: rows a transaction;
- `backlog_rows`: closed loop: the next transaction commits whenever
  fewer than this many produced rows are unfinished, so the apply loop
  always has a backlog to seal into large runs;
- `arrival_rows_per_s` (optional): open loop instead: transactions
  commit at this pace of rows, whatever the backlog;
- `pool_rows`: rows pre-encoded in set-up and cycled; each pass writes
  the key anew as `key_base` + the row's place in the stream, so no key
  repeats;
- `columns` (optional): generators that replace the configuration's for
  the stream's rows, by column name;
- `row_filter` (optional): the publication carries that filter and the
  walsender ships every row: the client filters;
- `warmup_rows`: rows finished before the window opens.

A row is finished once its transaction is: delivered whole, or filtered
out. The rate is the finished rows over the window.
"""

from __future__ import annotations

import asyncio
import bisect
import copy
import time

import numpy as np

from .. import check, datagen, system, textenc, traffic
from ..reference import decode as ref

SUFFIX = "cdc"


class Driver:
    def __init__(self, cell, seed: int, device: str, scale: float,
                 span=None):
        mix = cell.traffic
        self.mix = mix
        self.settings = cell.config.get("pipeline", {})
        self.lowering = cell.config["control"]
        self.device = device
        self.seed = seed
        self.tspec = next(t for t in cell.config["tables"]
                          if t["name"] == mix["table"])
        key = self.tspec["columns"][0]
        if not key.get("pk") or key["type"] not in ("int2", "int4", "int8"):
            raise ValueError("the stream's key must be the table's first "
                             "column, an integer of the primary key")
        self.pool_rows = max(mix["tx_rows"],
                             int(round(mix["pool_rows"] * scale)))
        self.tx_rows = mix["tx_rows"]
        self.backlog = max(self.tx_rows,
                           int(round(mix["backlog_rows"] * scale)))
        self.pace = mix.get("arrival_rows_per_s")
        if self.pace:
            self.pace *= scale
        self.warmup = int(round(mix["warmup_rows"] * scale))
        self.key_base = mix["key_base"]
        self.key_width = len(str(self.key_base))
        self.span = span
        self.sink = None
        self.lsns: list = []  # commit LSN of each transaction
        self.first: list = []  # its first row's place in the stream
        self.cum_rows = [0]  # rows produced before each transaction
        self.keep_n: list = []  # its rows the filter keeps
        self.commit_t: list = []  # its commit's host clock
        self.produced = 0
        self.producer_s = 0.0  # host seconds spent building transactions
        self.marks: list = []  # producer_s at each mark
        self._stop = False

    # -- set-up ---------------------------------------------------------

    async def setup(self) -> None:
        spec = copy.deepcopy(self.tspec)
        spec["rows"] = self.pool_rows
        spec["columns"][0]["gen"] = {"kind": "key", "add": self.key_base}
        for c in spec["columns"]:
            c["gen"] = self.mix.get("columns", {}).get(c["name"], c["gen"])
        rng = np.random.default_rng(datagen.seed_words(self.seed, 1))
        pool = datagen.make_table(rng, spec, {})
        if len(str(self.key_base + self.pool_rows - 1)) != self.key_width:
            raise ValueError("the pool's keys change width")
        self.buf, self.offs = textenc.insert_payloads(pool.cols, pool.relid)
        self._pool = np.frombuffer(self.buf, dtype=np.uint8)
        sql = self.mix.get("row_filter")
        self.keep_pool = ref.keep_mask(sql, pool.cols) if sql \
            else np.ones(self.pool_rows, dtype=bool)
        self.relid = pool.relid
        self.db = system.fake_database([pool], [self.tspec], None,
                                       (pool.relid, sql) if sql else None)
        self.sink = traffic.destination(self.mix, self.span)
        self.run = traffic.Running(self.db, self.sink, self.settings, 1,
                                   self.device)
        await self.run.start()
        await self.run.ready([self.relid])
        self._task = asyncio.ensure_future(self._produce())
        await self._until(lambda: self.finished() >= self.warmup,
                          traffic.WARMUP_S)

    # -- the stream -----------------------------------------------------

    def _payloads(self, lo: int, hi: int) -> list:
        """INSERT payloads of stream rows [lo, hi): the pool's rows with
        the key written as key_base + the row's place."""
        out = []
        while lo < hi:
            i0 = lo % self.pool_rows
            i1 = min(self.pool_rows, i0 + (hi - lo))
            seg = self._pool[self.offs[i0]:self.offs[i1]].copy()
            rel = self.offs[i0:i1] - self.offs[i0]
            keys = self.key_base + lo + np.arange(i1 - i0, dtype=np.int64)
            if keys[-1] >= 10 ** self.key_width:
                raise RuntimeError("the stream ran past its key width")
            digits = np.empty((i1 - i0, self.key_width), dtype=np.uint8)
            x = keys.copy()
            for j in range(self.key_width - 1, -1, -1):
                digits[:, j] = 48 + x % 10
                x //= 10
            # 'I', relation id, 'N', column count, 't', length: 13 bytes
            seg[(rel + 13)[:, None] + np.arange(self.key_width)] = digits
            raw = seg.tobytes()
            ends = np.append(rel[1:], len(raw)).tolist()
            out += [raw[a:b] for a, b in zip(rel.tolist(), ends)]
            lo += i1 - i0
        return out

    async def _commit(self) -> None:
        t0 = time.perf_counter()
        lo, hi = self.produced, self.produced + self.tx_rows
        tx = self.db.transaction()
        for p in self._payloads(lo, hi):
            tx.insert_preencoded(self.relid, p)
        # the commit is the source's (the walsender's WAL and wake-up)
        self.producer_s += time.perf_counter() - t0
        lsn = int(await tx.commit())
        idx = np.arange(lo, hi) % self.pool_rows
        self.lsns.append(lsn)
        self.first.append(lo)
        self.keep_n.append(int(self.keep_pool[idx].sum()))
        self.cum_rows.append(hi)
        self.produced = hi
        self.commit_t.append(time.perf_counter())

    def finished(self) -> int:
        """Rows of the transactions the pipeline has finished."""
        last = self.sink.last_lsn
        if last < 0:
            return 0
        i = bisect.bisect_left(self.lsns, last)
        done = i + (self.sink.last_lsn_rows >= self.keep_n[i])
        return self.cum_rows[done]

    async def _produce(self) -> None:
        """Fill the backlog to `backlog_rows` without yielding the loop,
        then wait for the pipeline to finish some of it: the walsender
        always holds a backlog, as a slot does after a burst or a
        restart. Paced, commit each transaction when it falls due."""
        if self.pace:
            t0 = time.perf_counter()
            while not self._stop:
                due = t0 + (self.produced + self.tx_rows) / self.pace
                await asyncio.sleep(max(0.0, due - time.perf_counter()))
                if not self._stop:
                    await self._commit()
            return
        progress = self.sink.progress
        while not self._stop:
            while self.produced - self.finished() < self.backlog:
                await self._commit()
            progress.clear()
            if self.produced - self.finished() >= self.backlog:
                try:
                    await asyncio.wait_for(progress.wait(), 0.5)
                except asyncio.TimeoutError:
                    pass

    async def _until(self, cond, timeout_s: float) -> None:
        t_end = time.perf_counter() + timeout_s
        while not cond():
            self.run.check()
            if self._task.done():
                self._task.result()
            if time.perf_counter() > t_end:
                raise TimeoutError("the stream did not drain in time")
            await asyncio.sleep(0.005)

    # -- the window -----------------------------------------------------

    def mark(self) -> int:
        self.marks.append(self.producer_s)
        return self.finished()

    def rate(self, a: int, b: int, seconds: float) -> dict:
        return {"cdc_events_per_s": (b - a) / seconds}

    async def close(self) -> None:
        """Stop producing, wait for what was produced (DRAIN_S at most:
        what has not come by then counts as missing), stop the
        pipeline."""
        self._stop = True
        await self._task
        try:
            await self._until(lambda: self.finished() >= self.produced,
                              traffic.DRAIN_S)
        except TimeoutError:
            pass
        await self.run.stop()

    def release(self) -> None:
        self.run = None
        self.db = None

    # -- the check ------------------------------------------------------

    def check(self, control: bool) -> dict:
        cols = ref.decode(self.tspec["columns"],
                          ref.split_inserts(self.buf, self.offs,
                                            len(self.tspec["columns"])))
        sql = self.mix.get("row_filter")
        keep = ref.keep_mask(sql, cols) if sql \
            else np.ones(self.pool_rows, dtype=bool)
        delivered = check.Delivered([b for b, _, _, _ in self.sink.cdc],
                                    self.tspec["columns"])
        kept = {id(b) for b in delivered.batches}
        entries = [e for e in self.sink.cdc if id(e[0]) in kept]
        commits = np.concatenate([c for _, c, _, _ in entries]) \
            if entries else np.zeros(0, np.uint64)
        ords = np.concatenate([o for _, _, o, _ in entries]) \
            if entries else np.zeros(0, np.uint64)
        lsns = np.asarray(self.lsns, dtype=np.uint64)
        ti = np.searchsorted(lsns, commits)
        known = (ti < len(lsns)) & (lsns[np.minimum(ti, len(lsns) - 1)]
                                    == commits) \
            & (ords.astype(np.int64) < self.tx_rows)
        first = np.asarray(self.first, dtype=np.int64)
        g = np.where(known, first[np.minimum(ti, len(first) - 1)]
                     + ords.astype(np.int64), -1)
        key = commits.astype(np.uint64) * np.uint64(1 << 20) \
            + ords.astype(np.uint64)
        order_breaks = int(np.count_nonzero(np.diff(key) <= 0))
        due = keep[np.arange(self.produced) % self.pool_rows]
        seen = np.bincount(g[known], minlength=self.produced)
        ok = known.copy()
        ok[known] = due[g[known]]
        # each row's first delivery is compared; repeats count as extra
        _, first_at = np.unique(np.where(ok, g, -1 - np.arange(len(g))),
                                return_index=True)
        rows = np.sort(first_at[ok[first_at]])
        extra = int(len(g) - len(rows))
        missing = int(np.count_nonzero(due & (seen == 0)))
        rng = np.random.default_rng(datagen.seed_words(self.seed, 2))
        # every cell of a sample of the delivered rows
        rows = rows[check.sample(len(rows), check.CDC_SAMPLE_ROWS, rng)]
        want = check.take_ref(cols, g[rows] % self.pool_rows)
        want[0].values = self.key_base + g[rows]
        if control:
            got, sel = check.Control(want, self.lowering), np.arange(len(rows))
        else:
            got, sel = delivered, rows
        bad = check.cells_bad(want, got, sel)
        return {"rows_missing": missing, "rows_extra": extra,
                "order_breaks": order_breaks,
                "cells_bad": sum(bad.values()),
                "numeric_bad": check.numeric_bad(want, got, sel, rng),
                "detail": {"bad_by_column": bad, "delivered": len(g),
                           "malformed_batches": self.sink.malformed
                           + delivered.malformed,
                           "produced": self.produced,
                           "producer_s_window": self.marks[-1]
                           - self.marks[0] if self.marks else None,
                           "due": int(due.sum())}}
