"""Per-pipeline actuation journal: the autoscale-journal pattern
(autoscale/controller.py AutoscaleJournal) generalized from
"K→K±1 scale decisions on one pipeline" to "create/resize/delete verbs
across a fleet".

Persist-then-actuate is the whole contract: the reconciler writes a
PENDING record to the store (one journal document PER PIPELINE — two
pipelines' rolls never contend on one row) BEFORE touching the
orchestrator, actuates, then settles the record APPLIED. A coordinator
hard-killed anywhere in that window leaves a pending record its
successor finds via `get_fleet_journals()`; the successor consults the
OBSERVED fleet to tell crash-before-actuation (re-drive, the runtime
verbs are idempotent) from crash-after-actuation (settle only, no
second actuation) — that is the zero-double-actuation guarantee the
chaos scenario verifies against the runtime's actuation log.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace

STATUS_PENDING = "pending"
STATUS_APPLIED = "applied"
STATUS_ABORTED = "aborted"

VERB_CREATE = "create"
VERB_RESIZE = "resize"
VERB_DELETE = "delete"


@dataclass(frozen=True)
class ActuationRecord:
    """One journaled fleet actuation. `decision_id` is monotonic per
    pipeline; `spec_version` pins which desired state demanded it;
    `from_k`/`to_k` are observed/target shard counts (0 = absent), so a
    resume can tell whether the actuation already took effect."""

    decision_id: int
    spec_version: int
    verb: str  # create | resize | delete
    from_k: int  # observed shard count when decided (0 = absent)
    to_k: int  # target shard count (0 = delete)
    status: str = STATUS_PENDING

    def to_json(self) -> dict:
        return {
            "decision_id": self.decision_id,
            "spec_version": self.spec_version,
            "verb": self.verb,
            "from_k": self.from_k,
            "to_k": self.to_k,
            "status": self.status,
        }

    @classmethod
    def from_json(cls, doc: dict) -> "ActuationRecord":
        return cls(
            decision_id=int(doc["decision_id"]),
            spec_version=int(doc["spec_version"]),
            verb=str(doc["verb"]),
            from_k=int(doc["from_k"]),
            to_k=int(doc["to_k"]),
            status=str(doc.get("status", STATUS_PENDING)),
        )

    def satisfied_by(self, observed_k: int) -> bool:
        """Does the OBSERVED shard count show this actuation already
        took effect? (0 = pipeline absent.) The successor's
        crash-after-actuation test."""
        return observed_k == self.to_k


@dataclass
class ActuationJournal:
    """One pipeline's persisted actuation history (bounded) + the id
    counter. Rewritten whole per transition; the StateStore surface
    keeps `next_id` monotonic across coordinators."""

    next_id: int = 1
    entries: list = field(default_factory=list)
    max_entries: int = 32

    def pending(self) -> "ActuationRecord | None":
        for rec in reversed(self.entries):
            if rec.status == STATUS_PENDING:
                return rec
        return None

    def open(self, *, verb: str, from_k: int, to_k: int,
             spec_version: int) -> ActuationRecord:
        rec = ActuationRecord(
            decision_id=self.next_id, spec_version=spec_version,
            verb=verb, from_k=from_k, to_k=to_k)
        self.next_id += 1
        self.entries.append(rec)
        if len(self.entries) > self.max_entries:
            del self.entries[:len(self.entries) - self.max_entries]
        return rec

    def settle(self, decision_id: int, status: str) -> None:
        self.entries = [
            replace(r, status=status) if r.decision_id == decision_id
            else r for r in self.entries]

    def applied(self) -> "list[ActuationRecord]":
        return [r for r in self.entries if r.status == STATUS_APPLIED]

    def to_json(self) -> dict:
        return {"next_id": self.next_id,
                "max_entries": self.max_entries,
                "entries": [r.to_json() for r in self.entries]}

    @classmethod
    def from_json(cls, doc: "dict | None") -> "ActuationJournal":
        if doc is None:
            return cls()
        j = cls(next_id=int(doc.get("next_id", 1)),
                max_entries=int(doc.get("max_entries", 32)))
        j.entries = [ActuationRecord.from_json(r)
                     for r in doc.get("entries", [])]
        return j
