"""Replication runtime: pipeline orchestration, apply loop, table sync
(copy of the reference's `etl_tpu/runtime`)."""

from .apply_loop import ApplyContext, ApplyLoop, ExitIntent, TableSyncContext
from .pipeline import Pipeline
from .shutdown import ShutdownRequested, ShutdownSignal, or_shutdown
from .state import TableState, TableStateType
