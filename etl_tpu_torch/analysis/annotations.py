"""Runtime-visible markers the static analyzer keys on.

Copy of the markers of the reference's `etl_tpu/analysis/annotations.py`
that the port's runtime carries. Each decorator is zero-cost: it tags the
function with an attribute and returns it unchanged. The port's etl-lint
matches the decorator names lexically (and through import aliases in the
whole-program pass), so the same contracts stay written — and checked —
on the same functions:

  - `@hot_loop`: per-row/per-dispatch hot path — no host<->device
    transfer (`torch.cuda.synchronize`, `.cpu()`, `.item()`, an event
    wait) inside; dispatch device work and hand back pending handles, the
    fetch happens at the consumer (`_PendingDecode.result()`);
  - `@dispatch_stage`: the decode pipeline's dispatch stage, a hot-loop
    function whose job is to start device work — uploads and enqueued
    copies (`.cuda()`, `.to(<device>)`, `.copy_(…, non_blocking=True)`)
    are its point; fetches (`.cpu()`, `.item()`, a synchronize) stay
    forbidden there;
  - `@admission_path`: the admission scheduler's grant path — no device
    traffic of any kind, or one tenant's round trip would serialize every
    tenant's admission behind it;
  - `@flush_path`: a destination flush/dispatch path — durability waits
    belong to the ack window, not to an inline `await ack.wait_durable()`;
  - `@transactional_commit`: a transactional-commit write path — data
    ships with its `CommitRange`;
  - `@shard_scoped`: code acting for ONE shard of a sharded publication —
    it reads table states through the shard view
    (`ShardScopedStore.owned_table_states()`), never the shared store's
    full list;
  - `@domain(name)`: pins a function to one execution domain (`loop`,
    `worker`, `executor`, `sweep`, `coordinator`);
  - `@handoff`: a deliberate cross-domain ownership-transfer seam (the
    shard coordinator's persist of the assignment record);
  - `@control_loop`: the autoscale controller's decision path — the pure
    signal → policy → decision computation between sampling and
    actuation: no blocking I/O and no device traffic, so shard-count
    control never waits on an external service or on the card.
"""

from __future__ import annotations

from typing import Callable, TypeVar

_F = TypeVar("_F", bound=Callable)

HOT_LOOP_ATTR = "__etl_hot_loop__"
ADMISSION_PATH_ATTR = "__etl_admission_path__"
FLUSH_PATH_ATTR = "__etl_flush_path__"
TRANSACTIONAL_COMMIT_ATTR = "__etl_transactional_commit__"
SHARD_SCOPED_ATTR = "__etl_shard_scoped__"
DOMAIN_ATTR = "__etl_domain__"
HANDOFF_ATTR = "__etl_handoff__"
CONTROL_LOOP_ATTR = "__etl_control_loop__"
DISPATCH_STAGE_ATTR = "__etl_dispatch_stage__"

#: the execution domains `@domain` accepts (a typo'd pin raises)
KNOWN_DOMAINS = frozenset({"loop", "worker", "executor", "sweep",
                           "coordinator"})


def hot_loop(fn: _F) -> _F:
    setattr(fn, HOT_LOOP_ATTR, True)
    return fn


def admission_path(fn: _F) -> _F:
    setattr(fn, ADMISSION_PATH_ATTR, True)
    return fn


def flush_path(fn: _F) -> _F:
    setattr(fn, FLUSH_PATH_ATTR, True)
    return fn


def transactional_commit(fn: _F) -> _F:
    setattr(fn, TRANSACTIONAL_COMMIT_ATTR, True)
    return fn


def shard_scoped(fn: _F) -> _F:
    setattr(fn, SHARD_SCOPED_ATTR, True)
    return fn


def domain(name: str) -> "Callable[[_F], _F]":
    if name not in KNOWN_DOMAINS:
        raise ValueError(
            f"unknown execution domain {name!r}; expected one of "
            f"{sorted(KNOWN_DOMAINS)}")

    def mark(fn: _F) -> _F:
        setattr(fn, DOMAIN_ATTR, name)
        return fn

    return mark


def handoff(fn: _F) -> _F:
    setattr(fn, HANDOFF_ATTR, True)
    return fn


def control_loop(fn: _F) -> _F:
    setattr(fn, CONTROL_LOOP_ATTR, True)
    return fn


def dispatch_stage(fn: _F) -> _F:
    setattr(fn, DISPATCH_STAGE_ATTR, True)
    return fn
