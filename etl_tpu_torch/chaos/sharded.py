"""Sharded chaos: kill one of K shard replicators mid-stream.

The sharded topology's one piece of shared state is the store (shard
assignment + table states + per-slot durable progress), so the scenario
shape mirrors production faithfully: ONE fake source database, ONE
publication, ONE shared store — and K shard-scoped Pipelines, each with
its own destination and its own `_s{shard}` slot, exactly the resource
split of K pods (multi-process semantics via the runner's `_hard_kill`:
every task cancelled, no drain, no destination shutdown).

The run proves, deterministically per seed:

  1. killing one shard leaves the SURVIVORS untouched — their entire
     remaining workload delivers during the outage window (a cross-shard
     coupling bug — shared store contention, a leaked ownership fence,
     admission tickets stranded by the dead pod — would stall them);
  2. the victim restarts from durable state and reconverges: the
     per-shard invariant check (zero loss, bounded dups funded by
     exactly one restart, monotonic per-slot durable LSN) passes for
     EVERY shard over its own slice of the committed truth;
  3. the union across shards equals the full committed source truth
     (`gen.expected`): no table fell between shards, none is owned
     twice — the cross-shard union check;
  4. no shard's destination ever saw another shard's tables (delivery
     isolation), and tasks/threads/arena leases return to baseline.

`python -m etl_tpu_torch.chaos --sharded [K] [--seed N]` replays it.

Copy of the reference's `etl_tpu/chaos/sharded.py`. The K pods are the
port's `Pipeline`s in one process: each decodes through its own
`DecodePipeline` on `device` ("cuda", the card, or "cpu").
"""

from __future__ import annotations

import asyncio
import random
import time
from dataclasses import dataclass, field

from ..analysis.annotations import shard_scoped
from ..config import (BatchConfig, BatchEngine, PipelineConfig, RetryConfig,
                      SupervisionConfig)
from ..models.event import DeleteEvent, InsertEvent, UpdateEvent
from ..models.lsn import Lsn
from ..models.table_state import TableStateType
from ..postgres.fake import FakeSource
from ..postgres.slots import apply_slot_name
from ..sharding import ShardMap
from . import failpoints
from .invariants import (InvariantReport, LeakProbe, check_invariants,
                         view_matches)
from .runner import (RecordingStore, RestartRecord, TracingDestination,
                     _hard_kill, _wait_until, _Workload)
from .scenario import Scenario

#: workload shape: enough tables that every shard owns at least one at
#: K=2 (5/3 split) and K=3 (5/2/1) under the fixed HRW map; the run
#: still guards against a degenerate (empty-shard) map before any fault
#: fires, so a larger K fails loudly instead of proving nothing
SHARDED_TABLES = 8


@dataclass
class ShardedChaosRun:
    seed: int
    shards: int
    victim: int
    report: InvariantReport = field(default_factory=InvariantReport)
    restarts: list[RestartRecord] = field(default_factory=list)
    tables_per_shard: dict = field(default_factory=dict)
    survivor_txs_during_outage: int = 0
    union_matches: bool = False
    duration_s: float = 0.0

    @property
    def ok(self) -> bool:
        return self.report.ok

    def describe(self) -> dict:
        return {
            "scenario": "sharded_pod_kill",
            "seed": self.seed,
            "shards": self.shards,
            "victim": self.victim,
            "ok": self.ok,
            "tables_per_shard": {str(s): n for s, n in
                                 sorted(self.tables_per_shard.items())},
            "restarts": [r.describe() for r in self.restarts],
            "survivor_txs_during_outage": self.survivor_txs_during_outage,
            "union_matches": self.union_matches,
            "invariants": self.report.describe(),
            "duration_s": round(self.duration_s, 3),
        }


class _UnionDest:
    """The cross-shard union view: every shard's copied baselines and
    delivered events merged into one reconstructable surface (delivery
    order preserved per shard; WAL rank does the global ordering, the
    same collapse rule the invariant checker replays by)."""

    def __init__(self, dests):
        self.events = []
        self.event_seqs = []
        self.table_rows = {}
        self.drop_seq_by_table = {}
        seq = 0
        for d in dests:
            offset = seq
            for tid, rows in d.table_rows.items():
                self.table_rows.setdefault(tid, []).extend(rows)
            for tid, drop_seq in getattr(d, "drop_seq_by_table",
                                         {}).items():
                self.drop_seq_by_table[tid] = offset + drop_seq
            for e in d.events:
                self.events.append(e)
                self.event_seqs.append(seq)
                seq += 1


def _shard_pipeline_config(shard: int, shards: int,
                           device: str = "cuda") -> PipelineConfig:
    # supervision LIVE but lenient (the chaos runner's fault-scenario
    # stance): deadlines far above any legitimate pause here, so the dup
    # budget needs no supervision-restart accounting
    return PipelineConfig(
        pipeline_id=1, publication_name="pub",
        batch=BatchConfig(max_size_bytes=64 * 1024, max_fill_ms=25,
                          batch_engine=BatchEngine.CUDA, device=device),
        apply_retry=RetryConfig(max_attempts=10, initial_delay_ms=15,
                                max_delay_ms=120),
        table_retry=RetryConfig(max_attempts=10, initial_delay_ms=15,
                                max_delay_ms=120),
        supervision=SupervisionConfig(
            check_interval_s=0.25, stall_deadline_s=10.0,
            hang_deadline_s=25.0, restart_backoff_s=1.0),
        wal_sender_timeout_ms=60_000,
        lag_sample_interval_s=0,
        shard=shard, shard_count=shards)


@shard_scoped
async def _wait_shard_ready(scoped_store, owned, timeout_s: float,
                            what: str) -> None:
    """One shard's readiness: every owned table READY in ITS view."""

    async def ready() -> bool:
        states = await scoped_store.owned_table_states()
        return all((st := states.get(tid)) is not None
                   and st.type is TableStateType.READY for tid in owned)

    deadline = time.monotonic() + timeout_s
    while not await ready():
        if time.monotonic() >= deadline:
            raise TimeoutError(what)
        await asyncio.sleep(0.02)


def _delivered(dest, owned, expected) -> bool:
    return view_matches(dest, owned,
                        {tid: expected[tid] for tid in owned})


async def run_sharded_scenario(seed: int = 7, shards: int = 2,
                               txs: int = 8, rows_per_tx: int = 60,
                               victim: int | None = None,
                               device: str = "cuda") -> ShardedChaosRun:
    """K shard replicators over one publication; the victim shard is
    hard-killed after half the transactions and restarted from durable
    state. Defaults pick the LAST shard as the victim (it always owns
    tables under the fixed map — asserted before any fault fires)."""
    failpoints.disarm_all()
    run = ShardedChaosRun(seed=seed, shards=shards,
                          victim=shards - 1 if victim is None else victim)
    t_start = time.monotonic()
    leak_probe = LeakProbe.capture()
    shape = Scenario(name="sharded", description="sharded workload",
                     tables=SHARDED_TABLES, rows_per_table=3,
                     txs=txs, rows_per_tx=rows_per_tx)
    workload = _Workload(shape, random.Random(seed))
    db = workload.build_db()
    store = RecordingStore()
    smap = ShardMap(shards)
    part = smap.partition(workload.table_ids)
    run.tables_per_shard = {s: len(t) for s, t in part.items()}
    dests = {s: TracingDestination() for s in range(shards)}
    pipes: dict[int, object] = {}

    def make_pipeline(shard: int):
        from ..runtime import Pipeline

        p = Pipeline(config=_shard_pipeline_config(shard, shards, device),
                     store=store, destination=dests[shard],
                     source_factory=lambda: FakeSource(db))
        pipes[shard] = p
        return p

    async def wait_all_ready() -> None:
        await asyncio.gather(*(
            _wait_shard_ready(pipes[s].store, part[s], 30.0,
                              f"shard {s}: tables never ready")
            for s in pipes))

    try:
        if any(not tabs for tabs in part.values()):
            run.report.fail(f"degenerate shard map: empty shard in "
                            f"{run.tables_per_shard} — grow the table set")
            return run
        for s in range(shards):
            await make_pipeline(s).start()
        await wait_all_ready()
        half = txs // 2
        while workload.tx_index < half:
            await workload.run_tx(db)

        # hard-kill the victim: process-death semantics, nothing drained
        await _hard_kill(pipes[run.victim])
        resume = await store.get_durable_progress(
            apply_slot_name(1, run.victim))
        run.restarts.append(RestartRecord(
            kind="crash", resume_lsn=int(resume or Lsn.ZERO),
            at_tx=workload.tx_index))

        # the survivors must stay whole DURING the outage: the rest of
        # the workload commits and every surviving shard delivers its
        # full slice while the victim is down
        before = workload.tx_index
        while workload.tx_index < txs:
            await workload.run_tx(db)
        run.survivor_txs_during_outage = workload.tx_index - before
        for s in range(shards):
            if s == run.victim:
                continue
            await _wait_until(
                lambda s=s: _delivered(dests[s], part[s],
                                       workload.expected),
                30.0, f"survivor shard {s} stalled during the victim's "
                      f"outage")

        # restart the victim from durable state; it must reconverge
        t_restart = time.monotonic()
        await make_pipeline(run.victim).start()
        await _wait_shard_ready(pipes[run.victim].store, part[run.victim],
                                30.0, "victim tables not ready after "
                                      "restart")
        await _wait_until(
            lambda: _delivered(dests[run.victim], part[run.victim],
                               workload.expected),
            30.0, "victim never reconverged after restart")
        run.restarts[-1].recovery_s = time.monotonic() - t_restart

        for s in range(shards):
            await pipes[s].shutdown_and_wait()
    except Exception as e:
        run.report.fail(f"scenario crashed: {e!r}")
    finally:
        failpoints.release_stalls()
        from ..ops import engine

        engine.clear_forced_oracle()
        for p in pipes.values():
            await _hard_kill(p)
        for d in dests.values():
            await d.shutdown()
        run.duration_s = time.monotonic() - t_start

    # delivery isolation: a shard's destination must never have seen a
    # row event of a table the map assigns elsewhere
    for s, dest in dests.items():
        owned = set(part[s])
        for e in dest.events:
            if isinstance(e, (InsertEvent, UpdateEvent, DeleteEvent)) \
                    and e.schema.id not in owned:
                run.report.fail(
                    f"cross-shard leak: shard {s} delivered an event of "
                    f"table {e.schema.id} (owner: "
                    f"{smap.shard_of(e.schema.id)})")
                break

    # per-shard invariants over each shard's OWN slice of the committed
    # truth — the victim's crash funds one restart of dup budget, the
    # survivors get none
    for s in range(shards):
        restarts = run.restarts if s == run.victim else []
        check_invariants(
            expected={tid: workload.expected[tid] for tid in part[s]},
            dest=dests[s], store=store, restarts=restarts,
            fault_firings=0, leak_probe=leak_probe, report=run.report)

    # the cross-shard union: merged shard views must equal the FULL
    # committed source truth — no table lost between shards
    run.union_matches = view_matches(_UnionDest(list(dests.values())),
                                     workload.table_ids, workload.expected)
    if not run.union_matches:
        run.report.fail("cross-shard union: merged shard destinations do "
                        "not reconstruct the committed source truth")
    return run
