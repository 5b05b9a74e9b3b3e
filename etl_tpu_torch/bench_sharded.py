"""Sharded replication at full size: K shard pods through the kernels.

    python -m etl_tpu_torch.bench_sharded [--copy-rows N] [--events N]
        [--device cuda|cpu]

`run_sharded_replication` drives the port's sharded scale-out the way a
deployment runs it: `tables` pgbench_accounts-shaped tables in one
publication of one fake source (`postgres.fake.FakeDatabase`), one shared
store, and K = 2 shard pods (`runtime.Pipeline` with `shard`/`shard_count`),
each with its own destination and, on the one card, its own
`DecodePipeline`s and CUDA streams. The tables shard 1 owns at K = 2 carry
the publication row filter `row_filter` in offload mode (the walsender
ships every row, the client's fused filter keeps the matching ones), so
that pod runs K2c while the other runs K1. The pods copy the tables, then
`n_events` inserts stream in `tx_size`-row transactions, one table a
transaction, round robin; halfway through, `sharding.ShardCoordinator`
adds a shard (2 → 3: the new apply slot at the fence, the losers drained to
it, the flip) while the stream goes on, and the fleet is rolled to K = 3
for the rest.

Each pod builds its decode pipelines under a decode tag of its own
(`ops.decode_kernel.DECODE_TAG`), so that its kernel launches and its
device-routed batches are counted apart from the other pods' in the one
process.

Checks: per table, the union of the pods' copied rows and of their
distinct streamed rows equals the written rows (those the filter keeps,
on filtered tables) by count and by an order-independent digest of every
column; each streamed row's aid is the one its (commit LSN, ordinal)
names; a row arrives at most twice, and twice only on a table the
rebalance moved, at or past the fence (the at-least-once window the
coordinator funds); no pod delivers a table its epoch's map gives
another; 512 sampled rows equal the CPU oracle's decode; each pod's K1 +
K2c launches equal its device-routed batches (K2 and the epilogue never
launch); a write through an old pod's store view after the flip is
refused SHARD_EPOCH_STALE; each slot's durable progress never goes back;
after shutdown no decode worker, admission ticket or tenant is left.
"""

from __future__ import annotations

import argparse
import asyncio
import contextlib
import json
import sys
import time

import numpy as np

from . import bench
from .bench import (FILLER_WIDTH, _counters, _delta, _filter_truth,
                    _pipeline_threads, _rows_arrays, _rows_digest,
                    pgbench_table, table_digest, table_text_rows)

#: the first table's id; the others follow it
BASE_TID = 16384


def table_schema(tid: int):
    """pgbench_accounts' columns under table id `tid`."""
    from .models import ReplicatedTableSchema, TableName, TableSchema

    base = bench.make_schema().table_schema
    return ReplicatedTableSchema.with_all_columns(TableSchema(
        tid, TableName("public", f"pgbench_accounts_{tid - BASE_TID}"),
        base.columns))


def _payloads(t: dict, tid: int) -> list:
    from .postgres.codec.pgoutput import encode_insert

    filler = t["filler"].view(f"S{FILLER_WIDTH}").ravel().tolist()
    return [encode_insert(tid, [str(a).encode(), str(b).encode(),
                                str(c).encode(), f])
            for a, b, c, f in zip(t["aid"].tolist(), t["bid"].tolist(),
                                  t["abalance"].tolist(), filler)]


def _pod_destination():
    """A destination that keeps what it receives by table: copied batches,
    and each streamed batch with its rows' commit LSNs and ordinals (a
    decoded batch resolves on arrival, so the decode stays on the measured
    path); the arrival time of each commit LSN."""
    from .destinations.base import Destination, WriteAck
    from .models.event import DecodedBatchEvent, InsertEvent
    from .models.table_row import ColumnarBatch

    class PodDestination(Destination):
        def __init__(self):
            self.copied: list = []  # (table id, batch)
            self.events: list = []  # (table id, batch, commits, ordinals)
            self.arrivals: list = []  # (commit LSN, perf_counter)
            self.other_events = 0

        async def startup(self):
            return None

        async def write_table_rows(self, schema, batch):
            self.copied.append((schema.id, batch))
            return WriteAck.durable()

        async def write_events(self, events):
            rows: list = []
            for e in events:
                if isinstance(e, InsertEvent):
                    if rows and rows[-1].schema.id != e.schema.id:
                        self._keep_rows(rows)
                    rows.append(e)
                    continue
                self._keep_rows(rows)
                if not isinstance(e, DecodedBatchEvent):
                    self.other_events += 1
                    continue
                self._keep(e.schema.id, e.batch,
                           np.asarray(e.commit_lsns, dtype=np.uint64),
                           np.asarray(e.tx_ordinals, dtype=np.uint64))
            self._keep_rows(rows)
            return WriteAck.durable()

        def _keep(self, tid, b, commits, ordinals) -> None:
            now = time.perf_counter()
            self.events.append((tid, b, commits, ordinals))
            for lsn in np.unique(commits).tolist():
                self.arrivals.append((int(lsn), now))

        def _keep_rows(self, rows: list) -> None:
            if not rows:
                return
            b = ColumnarBatch.from_rows(rows[0].schema, [e.row for e in rows])
            self._keep(rows[0].schema.id, b,
                       np.asarray([int(e.commit_lsn) for e in rows],
                                  dtype=np.uint64),
                       np.asarray([e.tx_ordinal for e in rows],
                                  dtype=np.uint64))
            rows.clear()

        async def drop_table(self, table_id, schema=None):
            self.copied = [(t, b) for t, b in self.copied if t != table_id]

        async def truncate_table(self, table_id):
            return None

    return PodDestination()


def _digest_rows(batches: list, pick: "np.ndarray | None" = None) -> int:
    """`_rows_digest` of the rows of `batches` (those at `pick` only)."""
    if not batches:
        return 0
    aid, bid, abal, fhash, flen, valid = _rows_arrays(batches)
    if pick is not None:
        aid, bid, abal, fhash, flen = (a[pick] for a in
                                       (aid, bid, abal, fhash, flen))
        valid = [v[pick] for v in valid]
    return _rows_digest(aid, bid, abal, fhash, flen, valid)


async def run_sharded_replication(copy_rows: int = 1_000_000,
                                  n_events: int = 400_000, tables: int = 8,
                                  tx_size: int = 500, device: str = "cuda",
                                  row_filter: str = "bid <= 5",
                                  max_fill_ms: int = 30,
                                  seed: int = 9) -> dict:
    """See the module docstring. Returns the measurements and the checks;
    `ok` is their AND."""
    from .chaos.runner import RecordingStore
    from .models.errors import EtlError
    from .models.table_state import TableState, TableStateType
    from .ops import decode_kernel, engine
    from .ops.pipeline import global_admission
    from .postgres.fake import FakeDatabase, FakeSource
    from .sharding import ShardCoordinator, ShardMap

    per_table = copy_rows // tables
    per_cdc = n_events // tables
    if per_table * tables != copy_rows or per_cdc * tables != n_events \
            or per_cdc % tx_size:
        raise ValueError(f"{copy_rows} rows and {n_events} events must split "
                         f"evenly over {tables} tables, in transactions of "
                         f"{tx_size} rows")
    tids = [BASE_TID + i for i in range(tables)]
    t_copy = {tid: pgbench_table(per_table, seed + i)
              for i, tid in enumerate(tids)}
    t_cdc = {tid: pgbench_table(per_cdc, seed + 100 + i,
                                first_aid=per_table + 1)
             for i, tid in enumerate(tids)}
    map2 = ShardMap(2)
    filtered = set(map2.tables_for_shard(tids, 1))
    keep_copy = {tid: _filter_truth(row_filter, t_copy[tid])
                 if tid in filtered else np.ones(per_table, dtype=bool)
                 for tid in tids}
    keep_cdc = {tid: _filter_truth(row_filter, t_cdc[tid])
                if tid in filtered else np.ones(per_cdc, dtype=bool)
                for tid in tids}
    db = FakeDatabase()
    for tid in tids:
        db.create_table(table_schema(tid).table_schema,
                        rows=table_text_rows(t_copy[tid]))
    db.server_row_filtering = False
    db.create_publication("pub", tids, row_filters={
        tid: (row_filter, lambda r: True) for tid in filtered})
    payloads = {tid: _payloads(t_cdc[tid], tid) for tid in tids}
    # one table a transaction, round robin: tx j writes rows
    # [(j // tables) * tx_size, +tx_size) of table j % tables
    plan = [(tids[j % tables], (j // tables) * tx_size)
            for j in range(n_events // tx_size)]

    store = RecordingStore()
    dests = {s: _pod_destination() for s in range(3)}
    pods: dict = {}  # tag → Pipeline
    fleet: list = []

    async def start_fleet(k: int, epoch_tag: str) -> list:
        out = []
        for shard in range(k):
            tag = f"{epoch_tag}pod{shard}"
            p, _ = bench._pipeline(db, dests[shard], device, max_fill_ms,
                                   store=store, shard=shard, shard_count=k)
            token = decode_kernel.DECODE_TAG.set(tag)
            try:
                await p.start()
            finally:
                decode_kernel.DECODE_TAG.reset(token)
            pods[tag] = p
            out.append(p)
        return out

    async def wait_ready(timeout: float) -> None:
        async def poll():
            while True:
                states = await store.get_table_states()
                if all((st := states.get(t)) is not None
                       and st.type is TableStateType.READY for t in tids):
                    return
                for p in fleet:
                    if p._apply_task is not None and p._apply_task.done():
                        p._apply_task.result()
                        raise RuntimeError("a pod stopped before READY")
                await asyncio.sleep(0.01)

        await asyncio.wait_for(poll(), timeout)

    want_total = sum(int(k.sum()) for k in keep_cdc.values())

    def union_size() -> int:
        """Distinct (table, commit LSN, ordinal) keys delivered so far."""
        by_table: dict = {}
        for d in dests.values():
            for tid, _b, commits, ords in d.events:
                by_table.setdefault(tid, []).append(
                    (commits << np.uint64(20)) | ords)
        return sum(len(np.unique(np.concatenate(k)))
                   for k in by_table.values())

    def rows_streamed() -> int:
        return sum(len(e[2]) for d in dests.values() for e in d.events)

    if device.split(":")[0] == "cuda":
        # the kernel library's build is the first pod's start-up cost, not
        # the copy's (phase 6 times its copy from after start() returns)
        await asyncio.to_thread(decode_kernel.load)
    c0 = _counters()
    tags0 = dict(decode_kernel.tag_launches)
    dev0 = dict(engine.tag_device_batches)
    commit_times: dict = {}
    commits: list = []  # (lsn, table, first row)
    try:
        t0 = time.perf_counter()
        fleet = await start_fleet(2, "")
        await wait_ready(600)
        t_copied = time.perf_counter()
        copy_s = t_copied - t0
        d_copy = _delta(c0, _counters())

        async def produce(j_from: int, j_to: int, stop=None) -> int:
            j = j_from
            while j < j_to and (stop is None or not stop.done()):
                tid, lo = plan[j]
                tx = db.transaction()
                for p in payloads[tid][lo:lo + tx_size]:
                    tx.insert_preencoded(tid, p)
                lsn = int(await tx.commit())
                commit_times[lsn] = time.perf_counter()
                commits.append((lsn, tid, lo))
                j += 1
                if stop is not None:
                    await asyncio.sleep(0)  # the coordinator runs between
            return j

        # as fast as the loop lets the producer commit, as phase 7's stream:
        # the window measures the fleet's throughput over a backlog, and the
        # lag that backlog's queue
        half = len(plan) // 2
        t_prod0 = time.perf_counter()
        j = await produce(0, half)
        # the rebalance, while the stream goes on
        coord = ShardCoordinator(store, 1, lambda: FakeSource(db),
                                 quiesce_timeout_s=300.0)
        t_rb0 = time.perf_counter()
        rebalance = asyncio.ensure_future(coord.add_shard())
        # a quarter of the stream at most while the coordinator fences and
        # drains (the first half's backlog is the losers' to drain); the rest
        # goes to the rolled fleet
        j = await produce(j, half + len(plan) // 4, stop=rebalance)
        result = await rebalance
        t_rb1 = time.perf_counter()
        # an old pod's view after the flip: refused, typed
        owned0 = map2.tables_for_shard(tids, 0)[0]
        try:
            await fleet[0].store.update_table_state(owned0, TableState.ready())
            stale_refusal = None
        except EtlError as e:
            stale_refusal = e.kind.name
        for p in fleet:
            await p.shutdown_and_wait()
        fleet = await start_fleet(3, "e1-")
        await wait_ready(120)
        t_rolled = time.perf_counter()
        j = await produce(j, len(plan))
        t_prod1 = time.perf_counter()

        async def all_delivered():
            while rows_streamed() < want_total or union_size() < want_total:
                for p in fleet:
                    if p._apply_task is not None and p._apply_task.done():
                        p._apply_task.result()
                        raise RuntimeError("a pod stopped before delivering")
                await asyncio.sleep(0.01)

        await asyncio.wait_for(all_delivered(), 900)
        t_e2e = time.perf_counter()
        d_all = _delta(c0, _counters())
        await asyncio.sleep(0.2)  # a duplicate past the last row lands here
        for p in fleet:
            await p.shutdown_and_wait()
    except BaseException:
        # a failed run leaves no pod running into the next phase or test
        for p in pods.values():
            if p._apply_task is not None and not p._apply_task.done():
                await p.shutdown()
                with contextlib.suppress(Exception):
                    await p.wait()
        raise

    sched = global_admission()
    threads = _pipeline_threads(timeout_s=5.0)

    # -- checks, off the clock -------------------------------------------
    out: dict = {"mode": "sharded_replication", "device": device,
                 "tables": tables, "copy_rows": copy_rows,
                 "events": n_events, "tx_size": tx_size,
                 "row_filter": row_filter,
                 "filtered_tables": sorted(filtered),
                 "tables_per_shard": {
                     "k2": {s: len(v) for s, v in map2.partition(
                         tids).items()},
                     "k3": {s: len(v) for s, v in ShardMap(3).partition(
                         tids).items()}}}
    first_of = {lsn: (tid, lo) for lsn, tid, lo in commits}
    fence = result.fence_lsn
    table_checks: dict = {}
    dup_ok = identity_ok = True
    dups = 0
    for tid in tids:
        copied = [b for d in dests.values() for t, b in d.copied if t == tid]
        n_copied = sum(b.num_rows for b in copied)
        copy_ok = (n_copied == int(keep_copy[tid].sum())
                   and _digest_rows(copied) % (1 << 64)
                   == table_digest(t_copy[tid],
                                   np.flatnonzero(keep_copy[tid])))
        evs = [e for d in dests.values() for e in d.events if e[0] == tid]
        batches = [e[1] for e in evs]
        lsn = np.concatenate([e[2] for e in evs]) if evs \
            else np.zeros(0, np.uint64)
        ords = np.concatenate([e[3] for e in evs]) if evs \
            else np.zeros(0, np.uint64)
        key = lsn * np.uint64(1 << 20) + ords
        uniq, first, counts = np.unique(key, return_index=True,
                                        return_counts=True)
        n_once = len(uniq)
        cdc_ok = (n_once == int(keep_cdc[tid].sum())
                  and _digest_rows(batches, first) % (1 << 64)
                  == table_digest(t_cdc[tid],
                                  np.flatnonzero(keep_cdc[tid])))
        twice = counts > 1
        dups += int((counts - 1).sum())
        if twice.any():
            dup_lsn = (uniq[twice] >> np.uint64(20)).astype(np.int64)
            dup_ok &= bool(counts.max() <= 2 and tid in result.moved
                           and (dup_lsn >= fence).all())
        if evs:
            aids = np.concatenate([np.asarray(b.columns[0].data)
                                   for b in batches]).astype(np.int64)
            src = np.asarray([first_of.get(int(c), (tid, -1))[1]
                              for c in lsn.tolist()], dtype=np.int64) \
                + ords.astype(np.int64)
            same = np.asarray([first_of.get(int(c), (None, 0))[0] == tid
                               for c in lsn.tolist()])
            known = same & (src >= 0) & (src < per_cdc)
            identity_ok &= bool(known.all() and np.array_equal(
                aids, t_cdc[tid]["aid"][src]) and keep_cdc[tid][src].all())
        table_checks[tid] = {"copied": n_copied, "streamed_once": n_once,
                          "duplicates": int((counts - 1).sum()),
                          "copy_ok": bool(copy_ok), "cdc_ok": bool(cdc_ok)}
    out["per_table"] = table_checks
    out["union_ok"] = all(v["copy_ok"] and v["cdc_ok"]
                          for v in table_checks.values())
    out["duplicates"] = dups
    out["dup_ok"] = bool(dup_ok)
    out["identity_ok"] = bool(identity_ok)
    # delivery isolation: a pod delivers only tables its epoch's map gives
    # it (shards 0 and 1 served both epochs: their K = 2 slice then their
    # K = 3 slice, so a table moved away is one they may have delivered)
    isolation_ok = True
    map3 = ShardMap(3)
    for s, d in dests.items():
        allowed = set(map3.tables_for_shard(tids, s))
        if s < 2:
            allowed |= set(map2.tables_for_shard(tids, s))
        seen = {t for t, _ in d.copied} | {e[0] for e in d.events}
        isolation_ok &= seen <= allowed
    out["isolation_ok"] = bool(isolation_ok)
    # 512 oracle rows: as many copied as streamed rows of each table
    sample_ok = True
    n_per = max(1, 512 // (2 * tables))
    for i, tid in enumerate(tids):
        copied = [b for d in dests.values() for t, b in d.copied if t == tid]
        streamed = [e[1] for d in dests.values() for e in d.events
                    if e[0] == tid]
        sample_ok &= await asyncio.to_thread(
            bench._oracle_sample_ok, copied, t_copy[tid], n_per, seed + i, 1)
        sample_ok &= await asyncio.to_thread(
            bench._oracle_sample_ok, streamed, t_cdc[tid], n_per,
            seed + 50 + i, per_table + 1)
    out["oracle_sample_ok"] = bool(sample_ok)
    # each pod held to its own launches: K1 + K2c == its device batches
    launches = {}
    for tag in pods:
        n = {k: decode_kernel.tag_launches.get((tag, k), 0)
             - tags0.get((tag, k), 0)
             for k in ("k1", "k2c", "k2", "epilogue")}
        n["device_batches"] = engine.tag_device_batches.get(tag, 0) \
            - dev0.get(tag, 0)
        launches[tag] = n
    out["pod_launches"] = launches
    if device == "cuda":
        out["launches_ok"] = all(
            n["k1"] + n["k2c"] == n["device_batches"]
            and n["k2"] == n["epilogue"] == 0 for n in launches.values()) \
            and sum(n["k1"] for n in launches.values()) > 0 \
            and sum(n["k2c"] for n in launches.values()) > 0
    else:  # the plain versions count no launch
        out["launches_ok"] = all(n["device_batches"] > 0
                                 for tag, n in launches.items()
                                 if not tag.startswith("e1-")) \
            and sum(n["device_batches"] for n in launches.values()) \
            == int(d_all["device_batches"])
    out["stale_epoch_refusal"] = stale_refusal
    out["stale_epoch_ok"] = stale_refusal == "SHARD_EPOCH_STALE"
    out["monotonic_ok"] = all(
        all(b >= a for a, b in zip(lsns, lsns[1:]))
        for lsns in store.progress_log.values())
    out["after_shutdown"] = {"pipeline_threads": threads,
                             "admission_in_flight": sched.in_flight,
                             "admission_tenants": sorted(
                                 sched.stats()["tenants"])}
    out["shutdown_ok"] = (not threads and sched.in_flight == 0
                          and not sched.stats()["tenants"])
    # -- numbers ------------------------------------------------------------
    lag_of = {}
    for d in dests.values():
        for lsn, at in d.arrivals:
            if lsn in commit_times:
                lag_of[lsn] = min(at, lag_of.get(lsn, at)) \
                    - commit_times[lsn]
    lags = sorted(v * 1e3 for v in lag_of.values())
    steady = sorted(lag_of[lsn] * 1e3 for lsn, _, _ in commits[:half]
                    if lsn in lag_of and commit_times[lsn] < t_rb0)

    def pct(xs, q):
        return xs[min(len(xs) - 1, int(q * len(xs)))] if xs else None

    window = t_e2e - t_prod0
    out.update({
        "copy_s": copy_s, "rows_per_second": copy_rows / copy_s,
        "copy_device_rows": int(d_copy["device_rows"]),
        "copy_oracle_rows": int(d_copy["oracle_rows"]),
        "producer_events_per_second": n_events / (t_prod1 - t_prod0),
        "events_per_second": n_events / window, "window_s": window,
        "lag_p50_ms": pct(lags, 0.5), "lag_p95_ms": pct(lags, 0.95),
        "lag_max_ms": lags[-1] if lags else None,
        "steady_lag_p50_ms": pct(steady, 0.5),
        "steady_lag_p95_ms": pct(steady, 0.95),
        "rebalance_s": t_rb1 - t_rb0, "roll_s": t_rolled - t_rb1,
        "rebalance": result.describe(),
        "moved_tables": sorted(result.moved),
        "device_rows": int(d_all["device_rows"]),
        "oracle_rows": int(d_all["oracle_rows"]),
        "small_oracle_rows": int(d_all["small_oracle_rows"]),
        "device_batches": int(d_all["device_batches"]),
        "k1_launches": int(d_all["k1_launches"]),
        "k2c_launches": int(d_all["k2c_launches"]),
        "k2_launches": int(d_all["k2_launches"]),
        "epilogue_launches": int(d_all["epilogue_launches"]),
        "egress_launches": int(d_all["egress_launches"]),
        "device_s": d_all["device_s"], "kernel_s": d_all["kernel_s"],
        "device_busy_share": d_all["device_s"] / (t_e2e - t0),
    })
    out["copy_oracle_free"] = out["copy_oracle_rows"] == 0
    out["ok"] = bool(
        out["union_ok"] and out["dup_ok"] and out["identity_ok"]
        and out["isolation_ok"] and out["oracle_sample_ok"]
        and out["launches_ok"] and out["stale_epoch_ok"]
        and out["monotonic_ok"] and out["shutdown_ok"]
        and out["copy_oracle_free"] and len(result.moved) > 0
        and all(n > 0 for n in out["tables_per_shard"]["k2"].values()))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m etl_tpu_torch.bench_sharded")
    ap.add_argument("--copy-rows", type=int, default=1_000_000)
    ap.add_argument("--events", type=int, default=400_000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            print("bench_sharded: no CUDA device", file=sys.stderr)
            return 1
    r = asyncio.run(run_sharded_replication(args.copy_rows, args.events,
                                            device=args.device))
    print(json.dumps(r, default=str))
    return 0 if r["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
