"""Runtime-visible markers the static analyzer keys on.

Copy of the markers of the reference's `etl_tpu/analysis/annotations.py`
that the port's runtime carries. Each decorator is zero-cost: it tags the
function with an attribute and returns it unchanged. The reference's
etl-lint reads the tags; the port keeps them so the same contracts stay
written on the same functions:

  - `@hot_loop`: per-row/per-dispatch hot path — no host<->device
    transfer (`torch.cuda.synchronize`, `.cpu()`, `.item()`, an event
    wait) inside; dispatch device work and hand back pending handles, the
    fetch happens at the consumer (`_PendingDecode.result()`);
  - `@admission_path`: the admission scheduler's grant path — no device
    traffic of any kind, or one tenant's round trip would serialize every
    tenant's admission behind it;
  - `@flush_path`: a destination flush/dispatch path — durability waits
    belong to the ack window, not to an inline `await ack.wait_durable()`;
  - `@transactional_commit`: a transactional-commit write path — data
    ships with its `CommitRange`.
"""

from __future__ import annotations

from typing import Callable, TypeVar

_F = TypeVar("_F", bound=Callable)

HOT_LOOP_ATTR = "__etl_hot_loop__"
ADMISSION_PATH_ATTR = "__etl_admission_path__"
FLUSH_PATH_ATTR = "__etl_flush_path__"
TRANSACTIONAL_COMMIT_ATTR = "__etl_transactional_commit__"


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
