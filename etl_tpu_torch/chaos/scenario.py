"""Declarative, seeded fault schedules.

A `Scenario` is a small data object: a workload shape (tables, initial
rows, CDC transactions) plus a tuple of `FaultSpec`s. The runner arms
every spec before the pipeline starts; a spec names WHERE (a failpoint
site, a destination op, or the wire), WHAT (error kind / scripted
destination fault / hard crash), WHEN (skip the first `after_hits` hits;
wire faults trigger after workload transaction `at_tx`), and HOW OFTEN
(`times`). Everything else — row values, which table each transaction
touches — is drawn from `random.Random(seed)`, so one (scenario, seed)
pair replays the identical workload and the identical injection trace.

Copy of the reference's `etl_tpu/chaos/scenario.py`. `engine` names the
port's batch engines: `cuda` (the kernels, on the device the runner is
given) or `cpu` (the per-tuple engine).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

from ..models.errors import ErrorKind


class FaultKind(enum.Enum):
    """What an armed spec does when its trigger predicate passes."""

    ERROR = "error"  # raise EtlError(error_kind) at a failpoint site
    CRASH = "crash"  # hard process-style crash: every pipeline task is
    # cancelled with no drain; the runner restarts from durable state
    DEST_REJECT = "dest_reject"  # scripted destination fault (memory.py
    DEST_FAIL_AFTER_APPLY = "dest_fail_after_apply"  # FaultInjecting-
    DEST_HOLD = "dest_hold"  # Destination): fail before / after apply,
    # or ack Accepted and turn durable only when the runner releases
    SEVER = "sever"  # postgres wire: drop every open walsender stream
    STALL = "stall"  # hang at a failpoint site for `stall_s` (or until
    # released) instead of raising: the silent-sickness mode the
    # supervision watchdog / destination op timeout must detect and
    # recover — the component never errors on its own


@dataclass(frozen=True)
class FaultSpec:
    """One armed fault. `site` is a failpoint name (chaos/failpoints.py)
    for ERROR/CRASH, a destination op name (write_events /
    write_table_rows / truncate_table / drop_table) for DEST_*, and
    ignored for SEVER."""

    site: str
    kind: FaultKind = FaultKind.ERROR
    error_kind: ErrorKind = ErrorKind.SOURCE_IO
    times: int = 1
    after_hits: int = 0  # trigger predicate: skip the first N hits
    at_tx: int | None = None  # SEVER / DEST_*: arm after this workload tx
    hold_release_after_tx: int | None = None  # DEST_HOLD: release point
    # STALL: how long the site hangs. Async sites are cancelled the
    # moment the watchdog restarts their worker, so a generous value only
    # proves nothing else broke the hang; thread sites (decode fetch)
    # block a real thread for the full duration — keep those short
    stall_s: float = 8.0

    def describe(self) -> dict:
        return {
            "site": self.site,
            "kind": self.kind.value,
            "error_kind": self.error_kind.name,
            "times": self.times,
            "after_hits": self.after_hits,
            "at_tx": self.at_tx,
        }


@dataclass(frozen=True)
class Scenario:
    """A reproducible chaos schedule over the standard workload:
    `tables` tables copied with `rows_per_table` seed rows, then `txs`
    CDC transactions of `rows_per_tx` inserts/updates each, then
    drain + (optional clean restart) + invariant check."""

    name: str
    description: str
    faults: tuple[FaultSpec, ...] = ()
    tables: int = 1
    rows_per_table: int = 3
    txs: int = 6
    rows_per_tx: int = 4
    # named workload profile (workloads/) driving the traffic
    # instead of the default mixed-insert workload; the profile then owns
    # the table shape (tables/rows_per_table/rows_per_tx above are
    # ignored) while `txs` still counts generator steps. One (scenario,
    # workload, seed) triple replays bit-identically.
    workload: str | None = None
    # crash handling: how many hard restarts the runner should survive
    # (must be >= number of CRASH spec firings; compound crash-during-
    # recovery scenarios re-arm a crash after the first restart)
    expect_restarts: int = 0
    # commit one workload transaction WHILE the initial copy runs (the
    # runner observes the during-copy site non-destructively): guarantees
    # a catchup window between the copy snapshot and the catchup target,
    # so the before-streaming path actually executes
    tx_during_copy: bool = False
    # satellite (restart matrix): after the workload completes, shut the
    # pipeline down cleanly and restart it, then run `txs_after_restart`
    # more transactions before the invariant check
    clean_restart: bool = False
    txs_after_restart: int = 2
    engine: str = "cuda"  # BatchConfig.batch_engine
    # stall scenarios: tighten the watchdog (50 ms sweeps, sub-second
    # stall deadline, ~2 s hang deadline, 1.5 s destination op timeout,
    # 1 s wal_sender_timeout so an idle loop still beats often) so
    # detection + recovery land inside the scenario budget
    fast_watchdog: bool = False
    # assert the health state machine visited DEGRADED during the run
    # and settled back to HEALTHY before shutdown
    expect_health_recovery: bool = False
    # program-cache restart modes (ops/program_store.py; the programs
    # are the built libraries):
    #   "warm"    — seed a cache dir with the libraries, clear the
    #               in-process library state at every hard restart
    #               (process-death semantics), and assert the restarted
    #               pipeline served its first batch from DISK-cached
    #               libraries: build-counter delta == 0 across the whole
    #               post-seed run, disk hits > 0.
    #   "corrupt" — same setup, but every cache file is replaced by
    #               garbage at the restart: the load must degrade to a
    #               clean rebuild (invariants hold, at least one
    #               invalid-miss recorded), never a crash.
    program_cache: str | None = None

    def describe(self) -> dict:
        return {
            "name": self.name,
            "description": self.description,
            "workload": self.workload or "default",
            "tables": self.tables,
            "rows_per_table": self.rows_per_table,
            "txs": self.txs,
            "rows_per_tx": self.rows_per_tx,
            "expect_restarts": self.expect_restarts,
            "clean_restart": self.clean_restart,
            "engine": self.engine,
            "program_cache": self.program_cache,
            "faults": [f.describe() for f in self.faults],
        }
