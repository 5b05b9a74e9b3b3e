"""Dead-letter / poison-pill chaos: the availability proof for
poison isolation (runtime/poison.py, docs/dead-letter.md).

`python -m etl_tpu_torch.chaos --dlq` runs two seeded scenarios:

  dlq_poison_quarantine — a multi-table CDC stream where table 0's
    inserts carry seeded poison rows the destination rejects with
    DESTINATION_REJECTED. The run must show: poison rows bisected out
    and parked on the durable dead-letter store (inside the probe-write
    bound), table 0 QUARANTINED once the poison budget trips (later
    events parked, counted), every OTHER table delivering its FULL
    workload while the quarantine stands, the extended zero-loss
    invariant `delivered ∪ dead-lettered == committed truth`, and the
    operator round trip: replay the DLQ through the destination seam +
    unquarantine → the destination's final view equals committed truth
    EXACTLY, and a second replay is a no-op (idempotent).

  dlq_bisection_crash — the pipeline is hard-killed (process-death
    semantics) while a bisection is mid-flight (crash armed on the
    POISON_BISECT failpoint), restarted from durable progress, and must
    reconverge: every poison row in the DLQ, survivors fully delivered,
    duplicates within budget = 1 + restarts, monotonic durable LSN, no
    leaks.

Both replay bit-identically per seed (the workload generator owns all
randomness and the crash trigger is hit-count-deterministic).

Copy of the reference's `etl_tpu/chaos/dlq.py`, on the port's pipeline
with its batches decoded on `device` ("cuda", the card, or "cpu"). The
thread-leak invariant counts the port's decode workers, which a closed
pipeline joins, so it holds under load.
"""

from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass, field, replace

from ..config import (BatchConfig, BatchEngine, PipelineConfig,
                      PoisonConfig, RetryConfig, SupervisionConfig)
from ..destinations import PoisonRejectingDestination
from ..dlq import DeadLetterQueue, decode_cell
from ..models.event import DeleteEvent, InsertEvent, UpdateEvent
from ..models.lsn import Lsn
from ..models.table_state import TableStateType
from ..postgres.fake import FakeSource
from ..postgres.slots import apply_slot_name
from ..runtime import poison as poison_mod
from ..workloads import WorkloadGenerator, get_profile
from . import failpoints
from .invariants import (InvariantReport, LeakProbe,
                         reconstruct_final_view, view_matches)
from .runner import (RecordingStore, RestartRecord, SimulatedCrash,
                     TracingDestination, _hard_kill, _wait_until)


@dataclass
class DlqRun:
    scenario: str
    seed: int
    report: InvariantReport = field(default_factory=InvariantReport)
    restarts: list[RestartRecord] = field(default_factory=list)
    dlq_entries: int = 0
    poison_entries: int = 0
    parked_entries: int = 0
    quarantined_tables: list[int] = field(default_factory=list)
    isolations: int = 0
    probe_writes: int = 0
    probe_bound: int = 0
    replayed: int = 0
    duration_s: float = 0.0

    @property
    def ok(self) -> bool:
        return self.report.ok

    def describe(self) -> dict:
        return {
            "scenario": self.scenario, "seed": self.seed, "ok": self.ok,
            "restarts": [r.describe() for r in self.restarts],
            "dlq_entries": self.dlq_entries,
            "poison_entries": self.poison_entries,
            "parked_entries": self.parked_entries,
            "quarantined_tables": list(self.quarantined_tables),
            "isolations": self.isolations,
            "probe_writes": self.probe_writes,
            "probe_bound": self.probe_bound,
            "replayed": self.replayed,
            "invariants": self.report.describe(),
            "duration_s": round(self.duration_s, 3),
        }


def _dlq_view(entries, table_ids) -> dict:
    """{table_id: {pk: tuple(values)}} from dead-letter entries, rank-
    collapsed exactly like the destination view (a pk's newest entry by
    WAL rank wins; deletes remove)."""
    import json as _json

    ordered = sorted(entries, key=lambda e: (e.commit_lsn, e.tx_ordinal))
    view: dict = {tid: {} for tid in table_ids}
    for e in ordered:
        if e.table_id not in view:
            continue
        doc = _json.loads(e.payload)
        values = tuple(decode_cell(v) for v in doc["values"])
        pk = values[0]
        if e.change_type == 2:  # delete
            view[e.table_id].pop(pk, None)
        else:
            view[e.table_id][pk] = values
    return view


def _check_union(report: InvariantReport, expected: dict,
                 delivered_view: dict, dlq_view: dict) -> None:
    """The extended zero-loss invariant: every committed row is present
    with its final values at the destination OR on the dead-letter
    store; nothing undelivered is missing from both, nothing exists that
    the source never committed."""
    for tid, rows in expected.items():
        got = delivered_view.get(tid, {})
        dlq = dlq_view.get(tid, {})
        for pk, values in rows.items():
            if got.get(pk) == values:
                continue
            if dlq.get(pk) == values:
                continue
            report.fail(
                f"union-zero-loss: table {tid} pk={pk!r} neither "
                f"delivered ({got.get(pk)!r}) nor dead-lettered "
                f"({dlq.get(pk)!r}) with committed values {values!r}")
        for pk in got:
            if pk not in rows:
                report.fail(f"union-zero-loss: table {tid} pk={pk!r} "
                            f"delivered but never committed")


def _check_common(run: DlqRun, *, gen, store, inner, leak_probe,
                  dup_budget: int) -> None:
    """Duplication, monotonic-LSN, and leak checks shared by both
    scenarios (the zero-loss half is the union check — quarantined
    tables deliberately under-deliver to the destination)."""
    counts: dict = {}
    for e in inner.events:
        if not isinstance(e, (InsertEvent, UpdateEvent, DeleteEvent)):
            continue
        row = e.old_row if isinstance(e, DeleteEvent) else e.row
        key = (e.schema.id, int(e.commit_lsn), e.tx_ordinal,
               type(e).__name__, row.values[0])
        counts[key] = counts.get(key, 0) + 1
    for key, n in counts.items():
        if n > dup_budget:
            run.report.fail(f"bounded-dup: event {key} delivered {n}x, "
                            f"budget {dup_budget}")
    for key, lsns in store.progress_log.items():
        for a, b in zip(lsns, lsns[1:]):
            if b < a:
                run.report.fail(f"monotonic-lsn: progress key {key!r} "
                                f"regressed {a} -> {b}")
    leaked = leak_probe.leaked_workers()
    if leaked:
        run.report.fail(f"no-leaks: decode-pipeline worker threads leaked: "
                        f"{leaked}")
    from ..ops.staging import ARENA_POOL

    if ARENA_POOL.outstanding > leak_probe.arenas_outstanding:
        run.report.fail("no-leaks: staging arena leases leaked")


def _check_probe_bound(run: DlqRun) -> None:
    """The bisection cost bound: per isolation, probe writes must stay
    within one split probe per table + 2·⌈log₂ rows⌉ per poison row
    (quarantine parking costs zero probes)."""
    total = bound = 0
    for t in poison_mod.ISOLATION_TRACE:
        b = poison_mod.bisection_bound(t["rows"], t["tables"],
                                       t["poison_rows"])
        total += t["probe_writes"]
        bound += b
        if t["probe_writes"] > b:
            run.report.fail(
                f"bisection-bound: isolation over {t['rows']} rows / "
                f"{t['tables']} tables found {t['poison_rows']} poison "
                f"rows with {t['probe_writes']} probe writes, bound {b}")
    run.probe_writes = total
    run.probe_bound = bound
    run.isolations = len(poison_mod.ISOLATION_TRACE)


def _make_config(budget_rows: int, window_s: float = 300.0,
                 fill_ms: int = 25, device: str = "cuda") -> PipelineConfig:
    return PipelineConfig(
        pipeline_id=1, publication_name="pub",
        batch=BatchConfig(max_size_bytes=8 * 1024, max_fill_ms=fill_ms,
                          batch_engine=BatchEngine.CUDA, device=device),
        apply_retry=RetryConfig(max_attempts=10, initial_delay_ms=15,
                                max_delay_ms=120),
        table_retry=RetryConfig(max_attempts=10, initial_delay_ms=15,
                                max_delay_ms=120),
        supervision=SupervisionConfig(
            check_interval_s=0.25, stall_deadline_s=10.0,
            hang_deadline_s=25.0, restart_backoff_s=1.0),
        poison=PoisonConfig(budget_rows=budget_rows, window_s=window_s),
        wal_sender_timeout_ms=60_000,
        lag_sample_interval_s=0)


async def _collect_dlq(run: DlqRun, store) -> list:
    entries = await store.list_dead_letters(status=None)
    run.dlq_entries = len(entries)
    run.poison_entries = sum(1 for e in entries
                             if e.error_kind != "quarantine")
    run.parked_entries = sum(1 for e in entries
                             if e.error_kind == "quarantine")
    run.quarantined_tables = sorted(await store.get_quarantined_tables())
    return entries


async def run_dlq_poison(seed: int = 7, steps: int = 22,
                         budget_rows: int = 3,
                         device: str = "cuda") -> DlqRun:
    """Scenario 1: poison rows mid-stream → bisection → DLQ →
    quarantine; survivors deliver everything; replay + unquarantine
    restores exact committed truth."""
    failpoints.disarm_all()
    poison_mod.reset_isolation_trace()
    run = DlqRun(scenario="dlq_poison_quarantine", seed=seed)
    t_start = time.monotonic()
    leak_probe = LeakProbe.capture()
    # a poison rate high enough to trip the budget inside the run; the
    # profile's control-group tables (1, 2) stay clean
    profile = replace(get_profile("poison_rows"), poison_rate=0.30,
                      rows_per_tx=6)
    gen = WorkloadGenerator(profile, seed=seed)
    db = gen.build_db()
    store = RecordingStore()
    inner = TracingDestination()
    dest = PoisonRejectingDestination(inner)
    config = _make_config(budget_rows=budget_rows, device=device)
    poisoned_tid = gen.table_ids[0]
    survivors = gen.table_ids[1:]

    from ..runtime import Pipeline

    pipeline = Pipeline(config=config, store=store, destination=dest,
                        source_factory=lambda: FakeSource(db))

    async def settled() -> bool:
        """Survivor tables fully delivered AND the union invariant holds
        for the poisoned table (every committed row delivered or
        dead-lettered)."""
        if not view_matches(inner, survivors,
                            {t: gen.expected[t] for t in survivors}):
            return False
        entries = await store.list_dead_letters(status=None)
        dlq = _dlq_view(entries, [poisoned_tid])[poisoned_tid]
        view = reconstruct_final_view(inner, [poisoned_tid])[poisoned_tid]
        for pk, values in gen.expected[poisoned_tid].items():
            if view.get(pk) != values and dlq.get(pk) != values:
                return False
        return True

    try:
        await pipeline.start()
        await _wait_until(
            lambda: all(
                (st := store._states.get(tid)) is not None
                and st.type is TableStateType.READY
                for tid in gen.table_ids), 30.0, "tables never ready")
        while gen.tx_index < steps:
            await gen.run_tx(db)
        deadline = time.monotonic() + 30.0
        while not await settled():
            if time.monotonic() >= deadline:
                run.report.fail("stream never settled: survivors "
                                "undelivered or poison rows missing "
                                "from the DLQ")
                break
            await asyncio.sleep(0.05)
        await pipeline.shutdown_and_wait()
    except Exception as e:
        run.report.fail(f"scenario crashed: {e!r}")
    finally:
        failpoints.release_stalls()
        from ..ops import engine

        engine.clear_forced_oracle()
        await _hard_kill(pipeline)
        await dest.shutdown()

    entries = await _collect_dlq(run, store)
    n_poison_committed = len(gen.poison_pks[poisoned_tid])
    if n_poison_committed < budget_rows:
        run.report.fail(
            f"seed produced only {n_poison_committed} poison rows — "
            f"cannot trip budget {budget_rows}; pick another seed")
    if run.poison_entries < min(budget_rows, n_poison_committed):
        run.report.fail(
            f"only {run.poison_entries} poison rows dead-lettered of "
            f"{n_poison_committed} committed (budget {budget_rows})")
    if poisoned_tid not in run.quarantined_tables:
        run.report.fail(f"table {poisoned_tid} never quarantined despite "
                        f"{run.poison_entries} poison rows over budget "
                        f"{budget_rows}")
    if run.parked_entries == 0:
        run.report.fail("no events parked during quarantine — the "
                        "quarantine never actually parked traffic")
    if not view_matches(inner, survivors,
                        {t: gen.expected[t] for t in survivors}):
        run.report.fail("survivor tables did not deliver their full "
                        "workload during quarantine")
    _check_union(run.report, gen.expected,
                 reconstruct_final_view(inner, gen.table_ids),
                 _dlq_view(entries, gen.table_ids))
    _check_probe_bound(run)
    _check_common(run, gen=gen, store=store, inner=inner,
                  leak_probe=leak_probe, dup_budget=1)

    # operator round trip: replay the DLQ through the destination seam
    # (the "fixed destination" is the unwrapped inner), lift the
    # quarantine, and the final view must equal committed truth EXACTLY
    dlq = DeadLetterQueue(store)
    result = await dlq.replay(inner)
    run.replayed = len(result["replayed"])
    if result["skipped"]:
        run.report.fail(f"replay skipped entries: {result['skipped']}")
    if not await dlq.unquarantine(poisoned_tid):
        run.report.fail("unquarantine found no record to lift")
    if await store.get_quarantined_tables():
        run.report.fail("quarantine record survived the lift")
    if not view_matches(inner, gen.table_ids, gen.expected):
        run.report.fail("replay + unquarantine did not restore the "
                        "exact committed truth at the destination")
    # idempotence: a second replay must be a no-op (every entry already
    # `replayed`) and must not change the final view
    events_before = len(inner.events)
    again = await dlq.replay(inner)
    if again["replayed"]:
        run.report.fail(f"second replay re-delivered "
                        f"{len(again['replayed'])} entries — not "
                        f"idempotent")
    if len(inner.events) != events_before \
            or not view_matches(inner, gen.table_ids, gen.expected):
        run.report.fail("second replay changed the destination view")
    run.duration_s = time.monotonic() - t_start
    return run


async def run_dlq_bisection_crash(seed: int = 7, steps: int = 16,
                                  crash_after_probes: int = 3,
                                  device: str = "cuda") -> DlqRun:
    """Scenario 2: hard-kill mid-bisection (crash armed on the
    POISON_BISECT failpoint), restart from durable progress, reconverge
    within the dup budget."""
    failpoints.disarm_all()
    poison_mod.reset_isolation_trace()
    run = DlqRun(scenario="dlq_bisection_crash", seed=seed)
    t_start = time.monotonic()
    leak_probe = LeakProbe.capture()
    # budget high enough that quarantine never trips: this scenario is
    # about crash recovery of the bisection itself
    profile = replace(get_profile("poison_rows"), poison_rate=0.10,
                      rows_per_tx=6)
    gen = WorkloadGenerator(profile, seed=seed)
    db = gen.build_db()
    store = RecordingStore()
    inner = TracingDestination()
    dest = PoisonRejectingDestination(inner)
    config = _make_config(budget_rows=10_000, device=device)
    poisoned_tid = gen.table_ids[0]

    crashed = asyncio.Event()
    hits = [0]

    def crash_action() -> None:
        """Process-death trigger at the (crash_after_probes+1)-th probe
        write — and every later one: once tripped, no in-process retry
        can make progress (each re-isolation dies at its first probe),
        so the recovery under test is the RESTARTED pipeline's, exactly
        like a real crash."""
        hits[0] += 1
        if hits[0] > crash_after_probes:
            crashed.set()
            raise SimulatedCrash("hard kill mid-bisection")

    failpoints.arm(failpoints.POISON_BISECT, crash_action)

    from ..runtime import Pipeline

    def make_pipeline():
        return Pipeline(config=config, store=store, destination=dest,
                        source_factory=lambda: FakeSource(db))

    async def settled() -> bool:
        entries = await store.list_dead_letters(status=None)
        dlq = _dlq_view(entries, [poisoned_tid])[poisoned_tid]
        view = reconstruct_final_view(inner, gen.table_ids)
        for tid in gen.table_ids:
            for pk, values in gen.expected[tid].items():
                if view[tid].get(pk) != values \
                        and dlq.get(pk) != values:
                    return False
        return True

    pipeline = make_pipeline()
    try:
        await pipeline.start()
        await _wait_until(
            lambda: all(
                (st := store._states.get(tid)) is not None
                and st.type is TableStateType.READY
                for tid in gen.table_ids), 30.0, "tables never ready")
        while gen.tx_index < steps:
            await gen.run_tx(db)
        await _wait_until(crashed.is_set, 30.0,
                          "the bisection crash never fired — no "
                          "isolation reached the armed probe")
        # hard-kill with the bisection mid-flight: probes already
        # delivered some healthy halves, the DLQ may hold a subset —
        # durable progress never covered the failing flush, so the
        # restart re-streams and re-isolates (idempotent appends)
        await _hard_kill(pipeline)
        failpoints.disarm(failpoints.POISON_BISECT)
        resume = await store.get_durable_progress(apply_slot_name(1))
        run.restarts.append(RestartRecord(
            kind="crash", resume_lsn=int(resume or Lsn.ZERO),
            at_tx=gen.tx_index))
        pipeline = make_pipeline()
        await pipeline.start()
        deadline = time.monotonic() + 30.0
        while not await settled():
            if time.monotonic() >= deadline:
                run.report.fail("post-restart stream never reconverged "
                                "to delivered ∪ dead-lettered == "
                                "committed truth")
                break
            await asyncio.sleep(0.05)
        await pipeline.shutdown_and_wait()
    except Exception as e:
        run.report.fail(f"scenario crashed: {e!r}")
    finally:
        failpoints.disarm_all()
        from ..ops import engine

        engine.clear_forced_oracle()
        await _hard_kill(pipeline)
        await dest.shutdown()

    entries = await _collect_dlq(run, store)
    if not crashed.is_set():
        run.report.fail("crash never armed — scenario proved nothing")
    n_poison_committed = len(gen.poison_pks[poisoned_tid])
    if n_poison_committed == 0:
        run.report.fail("seed produced no poison rows")
    if run.poison_entries < n_poison_committed:
        run.report.fail(
            f"{n_poison_committed - run.poison_entries} poison rows "
            f"missing from the DLQ after crash recovery")
    _check_union(run.report, gen.expected,
                 reconstruct_final_view(inner, gen.table_ids),
                 _dlq_view(entries, gen.table_ids))
    _check_probe_bound(run)
    # budget: the crash re-streams the in-flight window once — the
    # healthy complement of the interrupted isolation may deliver twice
    _check_common(run, gen=gen, store=store, inner=inner,
                  leak_probe=leak_probe,
                  dup_budget=1 + len(run.restarts))
    run.duration_s = time.monotonic() - t_start
    return run


async def run_dlq_scenarios(seed: int = 7,
                            device: str = "cuda") -> "list[DlqRun]":
    return [await run_dlq_poison(seed=seed, device=device),
            await run_dlq_bisection_crash(seed=seed, device=device)]
