"""The scenario corpus: every layer gets at least one fault, plus
compound crash-during-recovery cases. The port's tests run them on the
CPU (tests/test_torch_chaos.py), and the CLI (`python -m
etl_tpu_torch.chaos`) on the card.

Copy of the reference's `etl_tpu/chaos/corpus.py`, every scenario by name.
Two differ in what they prove on the port: `device_oom_fallback` (the
port has no per-batch OOM fallback, so each firing fails its batch and
the worker re-streams it: held to no loss and bounded duplicates), and
the two program-cache scenarios, whose programs are the port's built
libraries (ops/program_store.py): the warm restart loads them from the
cache and builds none, the corrupt one degrades to a counted invalid miss
and a real rebuild.

Layers covered:

  wire        — walsender disconnects mid-CDC, stream errors before
                table-sync streaming;
  decode      — pack / dispatch / fetch stage failures in the pipelined
                decode scheduler;
  device      — simulated OOM on the device route (the batch fails and
                is re-streamed: the port has no oracle fallback);
  destination — transient rejects, the fail-after-apply lost-response
                ambiguity, partial-batch holds (Accepted, durable later);
  store       — state-commit, schema-commit, and progress-commit
                failures;
  crash       — hard process-style crash→restart mid-apply (between
                destination write and progress store — the at-least-once
                window), mid-copy, and crash-during-recovery compounds.
"""

from __future__ import annotations

from ..models.errors import ErrorKind
from .scenario import FaultKind, FaultSpec, Scenario
from . import failpoints as fp

SCENARIOS: tuple[Scenario, ...] = (
    # --- wire layer ---------------------------------------------------------
    Scenario(
        name="wire_disconnect_mid_cdc",
        description="walsender streams severed after tx 2; the apply "
                    "worker reconnects from durable progress",
        faults=(FaultSpec("wire", kind=FaultKind.SEVER, at_tx=2),),
        txs=6),
    Scenario(
        name="wire_error_before_streaming",
        description="table-sync catchup stream fails to start once; "
                    "worker rolls back and retries",
        faults=(FaultSpec(fp.BEFORE_STREAMING,
                          error_kind=ErrorKind.REPLICATION_STREAM_FAILED),),
        txs=5, tx_during_copy=True),
    # --- copy layer ---------------------------------------------------------
    Scenario(
        name="copy_partition_fault",
        description="a copy partition fails at its start boundary; the "
                    "table rolls back to a consistent recopy",
        faults=(FaultSpec(fp.COPY_PARTITION_START,
                          error_kind=ErrorKind.SOURCE_IO),),
        rows_per_table=6, txs=4),
    Scenario(
        name="copy_stream_fault",
        description="the COPY data stream errors mid-partition "
                    "(reference during-copy failpoint)",
        faults=(FaultSpec(fp.DURING_COPY,
                          error_kind=ErrorKind.SOURCE_IO),),
        rows_per_table=6, txs=4),
    # --- decode pipeline layer ----------------------------------------------
    Scenario(
        name="pipeline_pack_fault",
        description="the pack stage of the decode pipeline fails once; "
                    "the consumer sees the error and the worker retries "
                    "from durable progress",
        faults=(FaultSpec(fp.PIPELINE_PACK,
                          error_kind=ErrorKind.DEVICE_UNAVAILABLE,
                          after_hits=2),),
        txs=6),
    Scenario(
        name="pipeline_dispatch_fault",
        description="the dispatch stage fails once mid-stream (big "
                    "transactions so runs route past the oracle and "
                    "actually reach the dispatch stage)",
        faults=(FaultSpec(fp.PIPELINE_DISPATCH,
                          error_kind=ErrorKind.DEVICE_UNAVAILABLE,
                          after_hits=1),),
        txs=4, rows_per_tx=100),
    Scenario(
        name="pipeline_fetch_fault",
        description="the fetch stage fails once at the consumer",
        faults=(FaultSpec(fp.PIPELINE_FETCH,
                          error_kind=ErrorKind.DEVICE_UNAVAILABLE,
                          after_hits=2),),
        txs=6),
    # --- device layer -------------------------------------------------------
    Scenario(
        name="device_oom_fallback",
        description="simulated device OOM on two batches; the port "
                    "has no per-batch oracle fallback, so each fails "
                    "and the worker re-streams it (no loss, duplicates "
                    "within the at-least-once budget)",
        faults=(FaultSpec(fp.ENGINE_DEVICE_OOM,
                          error_kind=ErrorKind.DEVICE_UNAVAILABLE,
                          times=2),),
        txs=4, rows_per_tx=100),
    # --- destination layer --------------------------------------------------
    Scenario(
        name="dest_transient_reject",
        description="two transient destination rejects on the CDC write "
                    "path; apply retries re-stream the window",
        faults=(FaultSpec("write_events", kind=FaultKind.DEST_REJECT,
                          times=2, at_tx=1),),
        txs=6),
    Scenario(
        name="dest_fail_after_apply",
        description="the lost-response ambiguity: the write applies, the "
                    "ack reports failure; redelivery must stay within "
                    "the at-least-once budget",
        faults=(FaultSpec("write_events",
                          kind=FaultKind.DEST_FAIL_AFTER_APPLY,
                          at_tx=1),),
        txs=6),
    Scenario(
        name="dest_partial_batch_ack",
        description="a HOLD: one write acks Accepted and turns durable "
                    "only two transactions later; durable progress must "
                    "wait for the release",
        faults=(FaultSpec("write_events", kind=FaultKind.DEST_HOLD,
                          at_tx=1, hold_release_after_tx=3),),
        txs=6),
    Scenario(
        name="dest_copy_reject",
        description="the initial-copy write path rejects once; "
                    "crash-consistent drop-and-recopy",
        faults=(FaultSpec("write_table_rows", kind=FaultKind.DEST_REJECT),),
        rows_per_table=6, txs=4),
    # --- store layer --------------------------------------------------------
    Scenario(
        name="store_progress_commit_fault",
        description="the durable-progress store write fails once after a "
                    "flush (reference on_progress_store failpoint)",
        faults=(FaultSpec(fp.ON_PROGRESS_STORE,
                          error_kind=ErrorKind.STATE_STORE_FAILED),),
        txs=6),
    Scenario(
        name="store_state_commit_fault",
        description="a table-state commit fails during table sync; the "
                    "worker parks Errored and the timed retry recovers",
        faults=(FaultSpec(fp.STORE_STATE_COMMIT,
                          error_kind=ErrorKind.STATE_STORE_FAILED,
                          after_hits=1),),
        txs=4),
    Scenario(
        name="store_schema_commit_fault",
        description="a schema-store commit fails during the copy phase",
        faults=(FaultSpec(fp.STORE_SCHEMA_COMMIT,
                          error_kind=ErrorKind.STATE_STORE_FAILED),),
        txs=4),
    # --- crash→restart ------------------------------------------------------
    Scenario(
        name="crash_mid_apply",
        description="hard crash BETWEEN destination write and progress "
                    "store (the at-least-once window): the restarted "
                    "pipeline re-streams the un-persisted window and "
                    "duplicates stay within budget",
        faults=(FaultSpec(fp.ON_PROGRESS_STORE, kind=FaultKind.CRASH,
                          after_hits=1),),
        txs=6, expect_restarts=1),
    Scenario(
        name="crash_restart_warm_programs",
        description="hard crash with a WARM program cache: "
                    "the runner seeds a cache dir with the built "
                    "libraries, drops the in-process library state at "
                    "the restart (process-death semantics), and the "
                    "restarted pipeline must serve its first batch from "
                    "DISK-cached libraries — build-counter delta == 0, "
                    "disk hits > 0 — while the usual zero-loss/bounded-"
                    "dup invariants hold",
        faults=(FaultSpec(fp.ON_PROGRESS_STORE, kind=FaultKind.CRASH,
                          after_hits=1),),
        txs=4, rows_per_tx=96, expect_restarts=1,
        program_cache="warm"),
    Scenario(
        name="crash_restart_corrupt_program_cache",
        description="hard crash with a CORRUPTED program cache: "
                    "every cache file is garbage at restart — the "
                    "load must degrade to a clean rebuild (invalid-miss "
                    "counted, file deleted, the restart awaiting the "
                    "build) and the invariants must hold; a corrupt "
                    "cache must never crash or wedge a replicator",
        faults=(FaultSpec(fp.ON_PROGRESS_STORE, kind=FaultKind.CRASH,
                          after_hits=1),),
        txs=4, rows_per_tx=96, expect_restarts=1,
        program_cache="corrupt"),
    Scenario(
        name="crash_mid_copy",
        description="hard crash mid-COPY: restart must drop the "
                    "half-written destination table and recopy",
        faults=(FaultSpec(fp.DURING_COPY, kind=FaultKind.CRASH),),
        rows_per_table=6, txs=4, expect_restarts=1),
    Scenario(
        name="crash_during_recovery_copy_then_apply",
        description="compound: crash mid-copy, then a SECOND crash in "
                    "the restarted pipeline's apply path while it is "
                    "still recovering",
        faults=(FaultSpec(fp.DURING_COPY, kind=FaultKind.CRASH),
                FaultSpec(fp.ON_PROGRESS_STORE, kind=FaultKind.CRASH,
                          after_hits=1)),
        rows_per_table=6, txs=5, expect_restarts=2),
    Scenario(
        name="crash_then_dest_fault_during_recovery",
        description="compound: crash mid-apply, then a transient "
                    "destination reject while the restarted pipeline "
                    "re-streams",
        faults=(FaultSpec(fp.ON_PROGRESS_STORE, kind=FaultKind.CRASH,
                          after_hits=1),
                FaultSpec("write_events", kind=FaultKind.DEST_REJECT,
                          at_tx=3)),
        txs=6, expect_restarts=1),
    # --- multi-table + cpu-engine coverage ----------------------------------
    Scenario(
        name="multi_table_wire_and_dest",
        description="two tables, a sever and a destination reject in one "
                    "run",
        faults=(FaultSpec("wire", kind=FaultKind.SEVER, at_tx=2),
                FaultSpec("write_events", kind=FaultKind.DEST_REJECT,
                          at_tx=3)),
        tables=2, txs=6),
    Scenario(
        name="cpu_engine_crash_mid_apply",
        description="the reference per-tuple engine under the same "
                    "at-least-once-window crash",
        faults=(FaultSpec(fp.ON_PROGRESS_STORE, kind=FaultKind.CRASH,
                          after_hits=1),),
        txs=5, expect_restarts=1, engine="cpu"),
    # --- stall layer: silent hangs the watchdog must detect -----------------
    Scenario(
        name="stall_apply_frame_read",
        description="the apply loop wedges mid-frame (stops beating "
                    "entirely); the watchdog's hang detection cancels "
                    "and restarts the apply worker from durable progress",
        faults=(FaultSpec(fp.APPLY_FRAME_READ, kind=FaultKind.STALL,
                          stall_s=20.0, after_hits=6),),
        txs=6, fast_watchdog=True, expect_health_recovery=True),
    Scenario(
        name="stall_dest_write",
        description="a destination write never returns; the per-op "
                    "timeout bound (or the stall watchdog, whichever "
                    "fires first) classifies it and the worker "
                    "re-streams",
        faults=(FaultSpec(fp.DESTINATION_WRITE, kind=FaultKind.STALL,
                          stall_s=20.0, after_hits=2),),
        txs=6, fast_watchdog=True, expect_health_recovery=True),
    Scenario(
        name="stall_dest_flush",
        description="a destination flush (wait_durable) never resolves; "
                    "the bounded ack times out and recovery re-streams "
                    "the window",
        faults=(FaultSpec(fp.DESTINATION_FLUSH, kind=FaultKind.STALL,
                          stall_s=20.0, after_hits=2),),
        txs=6, fast_watchdog=True, expect_health_recovery=True),
    Scenario(
        name="stall_store_progress_commit",
        description="the durable-progress store write hangs INSIDE the "
                    "apply loop (heartbeat goes stale); hang detection "
                    "restarts the worker",
        faults=(FaultSpec(fp.STORE_PROGRESS_COMMIT, kind=FaultKind.STALL,
                          stall_s=20.0, after_hits=1),),
        txs=6, fast_watchdog=True, expect_health_recovery=True),
    Scenario(
        name="stall_copy_partition",
        description="a copy partition wedges before reading data; the "
                    "table-sync worker is cancelled, parks Errored, and "
                    "the timed retry recopies",
        faults=(FaultSpec(fp.COPY_PARTITION_START, kind=FaultKind.STALL,
                          stall_s=20.0),),
        rows_per_table=6, txs=4, fast_watchdog=True,
        expect_health_recovery=True),
    Scenario(
        name="stall_decode_fetch",
        description="a decode-pipeline fetch blocks its thread mid-copy "
                    "(the one stall that parks a REAL thread): the "
                    "owning sync worker is restarted by hang detection "
                    "while the thread unblocks on its own deadline",
        faults=(FaultSpec(fp.PIPELINE_FETCH, kind=FaultKind.STALL,
                          stall_s=3.0),),
        rows_per_table=8, txs=4, fast_watchdog=True,
        expect_health_recovery=True),
)


def get_scenario(name: str) -> Scenario:
    for s in SCENARIOS + WORKLOAD_MATRIX:
        if s.name == name:
            return s
    raise KeyError(f"unknown scenario {name!r}; known: "
                   f"{', '.join(s.name for s in SCENARIOS + WORKLOAD_MATRIX)}")


# --- chaos × workload matrix ------------------------------------------------
#
# A curated subset of the corpus re-run under adversarial workload
# profiles (workloads/): the invariant checker must hold for
# update/delete/TOAST/truncate/DDL/partitioned traffic through the same
# fault schedules, not just insert-CDC. Curated rather than full
# cross-product to stay inside the tier-1 wall-clock budget — the
# crash→restart base runs against every profile (the at-least-once window
# is where non-insert semantics bite hardest); the stall and wire bases
# sample the profiles whose recovery differs most (truncate barriers,
# full-identity re-streams, DDL mid-recovery, partition fan-in).

#: the non-insert profiles the matrix proves out (≥4 required by the
#: acceptance criteria)
WORKLOAD_MATRIX_PROFILES = (
    "update_heavy_default", "update_heavy_full", "delete_heavy_default",
    "toast_heavy_full", "truncate_storm", "ddl_churn",
)


def _with_workload(base_name: str, profile: str) -> Scenario:
    from dataclasses import replace

    base = next(s for s in SCENARIOS if s.name == base_name)
    return replace(
        base, name=f"{base_name}__{profile}", workload=profile,
        description=f"{base.description} [workload={profile}]")


WORKLOAD_MATRIX: tuple[Scenario, ...] = tuple(
    [_with_workload("crash_mid_apply", p) for p in WORKLOAD_MATRIX_PROFILES]
    + [_with_workload("stall_dest_write", p)
       for p in ("update_heavy_full", "truncate_storm")]
    + [_with_workload("wire_disconnect_mid_cdc", p)
       for p in ("delete_heavy_default", "ddl_churn", "partitioned_root",
                 "tiny_txs")]
)
