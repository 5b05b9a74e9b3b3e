"""Re-export shim: the failpoint registry moved to `etl_tpu.chaos`.

Reference parity: crates/etl/src/failpoints.rs:14-54 — the seven named
sites live on under chaos/failpoints.py alongside the chaos subsystem's
expanded injection surface. Runtime call sites and existing tests keep
importing from here unchanged.

Copy of the reference's `etl_tpu/runtime/failpoints.py`.
"""

from __future__ import annotations

from ..chaos.failpoints import (  # noqa: F401
    AFTER_FINISHED_COPY, ALL_SITES, APPLY_FRAME_READ, ASSEMBLER_SEAL,
    ASYNC_STALL_SITES, BEFORE_SLOT_CREATION,
    BEFORE_STREAMING, CHAOS_SITES, COPY_PARTITION_END, COPY_PARTITION_START,
    DESTINATION_FLUSH, DESTINATION_WRITE, DURING_COPY, ENGINE_DEVICE_OOM,
    ON_PROGRESS_STORE, ON_SCHEMA_CLEANUP, ON_STATUS_UPDATE, PIPELINE_DISPATCH,
    PIPELINE_FETCH, PIPELINE_PACK, POISON_BISECT, REFERENCE_SITES,
    STORE_DLQ_COMMIT, STORE_PROGRESS_COMMIT,
    STORE_SCHEMA_COMMIT, STORE_STATE_COMMIT, arm, arm_error, arm_stall,
    armed_sites, disarm, disarm_all, fail_point, release_stalls, scope,
    stall_point, stalls_armed)
