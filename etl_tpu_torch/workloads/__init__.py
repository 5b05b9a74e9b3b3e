"""Seeded adversarial workload generator (ROADMAP item 3).

Every benchmark and chaos scenario used to drive ONE workload shape:
pgbench-style insert CDC. This package generates the traffic real
replication streams are made of — update/delete-heavy under both replica
identities, wide rows, TOAST-heavy, numeric/timestamp-dense, tiny vs
giant transactions, truncate storms, DDL churn, partitioned roots —
through the same `FakeDatabase`/`FakeTransaction` walsender the rest of
the test stack uses.

Copy of the reference's `etl_tpu/workloads`: the port's chaos scenarios
(chaos/dlq.py and the corpus's workload matrix) drive it.

Determinism contract: one `(profile, seed)` pair replays a byte-identical
WAL payload stream (the generator pins the fake's commit clock and is the
only consumer of its RNG). See docs/workloads.md.
"""

from .generator import (WorkloadGenerator, make_chaos_workload,
                        wal_payloads)
from .profiles import (PROFILES, WorkloadProfile, get_profile,
                       profile_names)

__all__ = [
    "PROFILES",
    "WorkloadGenerator",
    "WorkloadProfile",
    "get_profile",
    "make_chaos_workload",
    "profile_names",
    "wal_payloads",
]
