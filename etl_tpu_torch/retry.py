"""The unified retry policy: one backoff + classification shape for the
apply worker, table-sync workers, and destination writers.

Before this module each layer carried its own ad-hoc loop:
`RetryConfig.delay_ms` (worker restarts), `DestinationRetryPolicy.delay`
(HTTP writers), and hand-rolled retryable() lambdas per destination.
`RetryPolicy` folds them together:

  - exponential backoff with a multiplier, a delay cap, and bounded
    multiplicative jitter (decorrelates retry herds across workers);
  - per-`ErrorKind` transient/permanent classification. Two granularities
    exist on purpose:
      * `WORKER_TRANSIENT_KINDS` (= models.errors._TIMED_KINDS) — what a
        WORKER may retry by re-streaming from durable progress; includes
        DESTINATION_FAILED because a re-streamed window may succeed
        against a recovered destination;
      * `DESTINATION_TRANSIENT_KINDS` — what a WRITER may retry in place
        (same payload, same call): throttles, connection drops, timeouts.
        DESTINATION_FAILED is deliberately NOT here: an in-place retry of
        the identical request against a destination that REJECTED it
        (4xx-class, schema errors) cannot succeed — that failure
        escalates to the worker loop instead.
  - an `execute()` runner destinations use directly (`with_retries` in
    destinations/util.py delegates here).

ClickHouse (and any HTTP writer) classifies its errors by raising
EtlError kinds mapped from HTTP status; the policy decides
transient/permanent — no per-destination retryable() lambdas.

Copy of the reference's `etl_tpu/retry.py`.
"""

from __future__ import annotations

import asyncio
import random
from dataclasses import dataclass, field
from typing import Awaitable, Callable, TypeVar

from .models.errors import (ErrorKind, EtlError, RetryKind, _TIMED_KINDS,
                            retry_directive)

T = TypeVar("T")

#: what a worker may retry by re-streaming from durable progress
WORKER_TRANSIENT_KINDS: frozenset[ErrorKind] = _TIMED_KINDS

#: what a destination writer may retry IN PLACE (same request): transient
#: transport/capacity conditions only — rejected payloads escalate
DESTINATION_TRANSIENT_KINDS: frozenset[ErrorKind] = frozenset({
    ErrorKind.DESTINATION_THROTTLED,
    ErrorKind.DESTINATION_CONNECTION_FAILED,
    ErrorKind.TIMEOUT,
})


@dataclass(frozen=True)
class RetryPolicy:
    """Exponential backoff + jitter + per-ErrorKind classification."""

    max_attempts: int = 5
    initial_delay_s: float = 0.2
    max_delay_s: float = 10.0
    multiplier: float = 2.0
    jitter: float = 0.2  # multiplicative: delay × (1 + U[0, jitter])
    transient_kinds: frozenset = field(
        default=DESTINATION_TRANSIENT_KINDS)

    @classmethod
    def from_config(cls, rc, *, transient_kinds: frozenset | None = None
                    ) -> "RetryPolicy":
        """Build from a config.RetryConfig (worker retry loops)."""
        return cls(max_attempts=rc.max_attempts,
                   initial_delay_s=rc.initial_delay_ms / 1000,
                   max_delay_s=rc.max_delay_ms / 1000,
                   multiplier=rc.backoff_factor,
                   transient_kinds=transient_kinds
                   if transient_kinds is not None else WORKER_TRANSIENT_KINDS)

    def base_delay(self, attempt: int) -> float:
        """Deterministic backoff for attempt N (0-based), no jitter."""
        return min(self.initial_delay_s * self.multiplier ** attempt,
                   self.max_delay_s)

    def delay(self, attempt: int,
              rng: "random.Random | None" = None) -> float:
        d = self.base_delay(attempt)
        r = rng.random() if rng is not None else random.random()
        return d * (1 + r * self.jitter)

    # -- classification ------------------------------------------------------

    def classify(self, exc: BaseException) -> RetryKind:
        """TIMED = retryable under this policy. EtlErrors start from the
        error-policy directive (models/errors.py); a TIMED directive is
        then narrowed by this policy's transient scope — worker-scoped
        policies keep the directive's full view, writer-scoped ones
        accept only in-place-retryable kinds."""
        if isinstance(exc, EtlError):
            directive = retry_directive(exc)
            if directive.kind is not RetryKind.TIMED:
                return directive.kind
            if self.transient_kinds == WORKER_TRANSIENT_KINDS \
                    or set(exc.kinds()) & self.transient_kinds:
                return RetryKind.TIMED
            return RetryKind.MANUAL
        if isinstance(exc, asyncio.CancelledError):
            return RetryKind.NO_RETRY
        if isinstance(exc, (ConnectionError, OSError, TimeoutError)):
            return RetryKind.TIMED
        # aiohttp client errors without importing aiohttp here
        if type(exc).__module__.startswith("aiohttp"):
            return RetryKind.TIMED
        return RetryKind.MANUAL

    def is_transient(self, exc: BaseException) -> bool:
        return self.classify(exc) is RetryKind.TIMED

    # -- runner --------------------------------------------------------------

    async def execute(self, op: Callable[[], Awaitable[T]],
                      retryable: "Callable[[BaseException], bool] | None"
                      = None) -> T:
        """Classify-and-backoff loop (reference retry.rs:classify). The
        default retryable predicate is `is_transient`; a custom one
        overrides classification but keeps the backoff schedule."""
        should_retry = retryable if retryable is not None \
            else self.is_transient
        last: BaseException | None = None
        for attempt in range(self.max_attempts):
            try:
                return await op()
            except asyncio.CancelledError:
                raise
            except BaseException as e:
                if not should_retry(e) \
                        or attempt + 1 >= self.max_attempts:
                    raise
                last = e
                await asyncio.sleep(self.delay(attempt))
        raise last  # pragma: no cover
