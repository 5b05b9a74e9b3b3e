"""Table lifecycle state machine.

Reference parity: `TableState` with 8 states —
Init → DataSync → FinishedCopy → SyncWait → Catchup → SyncDone → Ready,
plus Errored{reason, solution, retry_policy}
(crates/etl/src/replication/state/lifecycle.rs:22,196). SyncWait and Catchup
are memory-only coordination states (lifecycle.rs:218-229): they are never
persisted; a restart collapses them back to FinishedCopy.

JSON (de)serialization mirrors the store row format (lifecycle.rs:122-164).

Copy of the reference's `etl_tpu/models/table_state.py`.
"""

from __future__ import annotations

import enum
import json
from dataclasses import dataclass, field

from ..models.errors import ErrorKind, EtlError, RetryKind
from ..models.lsn import Lsn


class TableStateType(enum.Enum):
    INIT = "init"
    DATA_SYNC = "data_sync"
    FINISHED_COPY = "finished_copy"
    SYNC_WAIT = "sync_wait"  # memory-only
    CATCHUP = "catchup"  # memory-only
    SYNC_DONE = "sync_done"
    READY = "ready"
    ERRORED = "errored"


# states that may be persisted to the state store
PERSISTENT_STATES = frozenset({
    TableStateType.INIT, TableStateType.DATA_SYNC,
    TableStateType.FINISHED_COPY, TableStateType.SYNC_DONE,
    TableStateType.READY, TableStateType.ERRORED,
})


@dataclass(frozen=True)
class TableState:
    type: TableStateType
    lsn: Lsn | None = None  # SyncWait: snapshot; Catchup: target; SyncDone: done
    # Errored payload:
    reason: str | None = None
    solution: str | None = None
    retry_policy: RetryKind | None = None
    retry_attempts: int = 0

    # -- constructors --------------------------------------------------------

    @classmethod
    def init(cls) -> "TableState":
        return cls(TableStateType.INIT)

    @classmethod
    def data_sync(cls) -> "TableState":
        return cls(TableStateType.DATA_SYNC)

    @classmethod
    def finished_copy(cls) -> "TableState":
        return cls(TableStateType.FINISHED_COPY)

    @classmethod
    def sync_wait(cls, snapshot_lsn: Lsn) -> "TableState":
        return cls(TableStateType.SYNC_WAIT, lsn=snapshot_lsn)

    @classmethod
    def catchup(cls, target_lsn: Lsn) -> "TableState":
        return cls(TableStateType.CATCHUP, lsn=target_lsn)

    @classmethod
    def sync_done(cls, done_lsn: Lsn) -> "TableState":
        return cls(TableStateType.SYNC_DONE, lsn=done_lsn)

    @classmethod
    def ready(cls) -> "TableState":
        return cls(TableStateType.READY)

    @classmethod
    def errored(cls, reason: str, *, solution: str | None = None,
                retry_policy: RetryKind = RetryKind.TIMED,
                retry_attempts: int = 0) -> "TableState":
        return cls(TableStateType.ERRORED, reason=reason, solution=solution,
                   retry_policy=retry_policy, retry_attempts=retry_attempts)

    # -- predicates ----------------------------------------------------------

    @property
    def is_persistent(self) -> bool:
        return self.type in PERSISTENT_STATES

    @property
    def is_errored(self) -> bool:
        return self.type is TableStateType.ERRORED

    @property
    def apply_worker_owns_table(self) -> bool:
        """Only Ready tables are applied by the apply worker; all other
        states are owned by (or waiting for) a table-sync worker
        (single-writer invariant, reference table_cache.rs:10-44)."""
        return self.type is TableStateType.READY

    # -- transitions ---------------------------------------------------------

    _VALID: dict[TableStateType, tuple[TableStateType, ...]] = None  # set below

    def can_transition_to(self, to: TableStateType) -> bool:
        if to is TableStateType.ERRORED or to is TableStateType.INIT:
            return True  # any state may error; INIT = full resync/rollback
        return to in _VALID_TRANSITIONS[self.type]

    def transition_to(self, new: "TableState") -> "TableState":
        if not self.can_transition_to(new.type):
            raise EtlError(
                ErrorKind.INVALID_STATE_TRANSITION,
                f"{self.type.value} → {new.type.value}")
        return new

    # -- serialization (persistent states only) ------------------------------

    def to_json(self) -> str:
        if not self.is_persistent:
            raise EtlError(ErrorKind.STORE_SERIALIZATION_FAILED,
                           f"{self.type.value} is memory-only")
        doc: dict = {"state": self.type.value}
        if self.type is TableStateType.SYNC_DONE:
            doc["lsn"] = str(self.lsn)
        if self.type is TableStateType.ERRORED:
            doc.update(reason=self.reason, solution=self.solution,
                       retry_policy=(self.retry_policy or RetryKind.TIMED).value,
                       retry_attempts=self.retry_attempts)
        return json.dumps(doc)

    @classmethod
    def from_json(cls, raw: str) -> "TableState":
        try:
            doc = json.loads(raw)
            t = TableStateType(doc["state"])
            if t is TableStateType.SYNC_DONE:
                return cls.sync_done(Lsn(doc["lsn"]))
            if t is TableStateType.ERRORED:
                return cls.errored(
                    doc.get("reason") or "",
                    solution=doc.get("solution"),
                    retry_policy=RetryKind(doc.get("retry_policy", "timed")),
                    retry_attempts=doc.get("retry_attempts", 0))
            return cls(t)
        except (KeyError, ValueError, json.JSONDecodeError) as e:
            raise EtlError(ErrorKind.STORE_SERIALIZATION_FAILED,
                           f"bad table state row: {e}")


_VALID_TRANSITIONS: dict[TableStateType, tuple[TableStateType, ...]] = {
    TableStateType.INIT: (TableStateType.DATA_SYNC,),
    TableStateType.DATA_SYNC: (TableStateType.FINISHED_COPY,),
    TableStateType.FINISHED_COPY: (TableStateType.SYNC_WAIT,),
    TableStateType.SYNC_WAIT: (TableStateType.CATCHUP,),
    TableStateType.CATCHUP: (TableStateType.SYNC_DONE,),
    TableStateType.SYNC_DONE: (TableStateType.READY,),
    TableStateType.READY: (),
    TableStateType.ERRORED: (TableStateType.DATA_SYNC,),  # retry path
}
