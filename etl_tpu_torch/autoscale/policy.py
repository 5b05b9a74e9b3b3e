"""The scaling policy: a pure, property-testable decision function.

DS2-style rate model (Kalavri et al., OSDI'18 — compute the target
parallelism from OBSERVED rates, don't trial-and-error) over the
SignalFrame history:

  capacity   — per-shard drain capacity in bytes/s, estimated from the
               durable-LSN advance between consecutive frames (the
               median over shards of the best observed per-shard rate
               inside the window; floored at `capacity_floor_bytes_per_s`
               so a cold start can never divide by zero);
  raw target — ceil(aggregate_backlog / (capacity × drain_slo_s)): the
               shard count that drains the current backlog inside the
               SLO at the observed rate;
  decision   — the raw target wrapped in the safety envelope below.

Safety envelope (Dhalion's lesson, VLDB'17 — a self-regulating policy
needs damping more than it needs cleverness):

  hysteresis bands — scale-up is considered only while the aggregate
      backlog sits ABOVE `up_backlog_bytes`; scale-down only BELOW
      `down_backlog_bytes`. The gap between the bands is the dead zone
      where noisy signals cannot flap the topology. When the up band is
      breached the minimum response is +1 even if the rate model says
      the current K should cope — sustained backlog above the band IS
      the evidence the model's capacity estimate is optimistic.
  sustained votes — `up_ticks` (resp. `down_ticks`) CONSECUTIVE frames
      must agree before a direction is decided; a single spiky frame
      decides nothing.
  cooldown — after any applied decision, `cooldown_ticks` evaluations
      must pass before the next decision; a rebalance's own transient
      lag (the at-least-once re-apply window) must never trigger the
      next rebalance.
  max-step — K changes by exactly ±1 per decision; the two-phase
      rebalance is proven for single steps, and repeated small steps
      with cooldowns converge without overshooting.
  vetoes — any unhealthy shard holds (never rebalance a sick fleet:
      quiesce would block on the sick shard's fence anyway); memory
      pressure vetoes scale-DOWN (the survivors' headroom isn't real).

Everything here is `@control_loop`: no wall clock, no I/O, no device
traffic — a function of (history, current_k, last_decision_tick,
config) only, enforced by etl-lint rule 16 and property-tested in
tests/test_autoscale.py (monotone response, no-flap around band edges,
cooldown enforcement).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from ..analysis.annotations import control_loop
from ..models.errors import ErrorKind, EtlError

ACTION_UP = "scale_up"
ACTION_DOWN = "scale_down"
ACTION_HOLD = "hold"


@dataclass(frozen=True)
class AutoscalePolicyConfig:
    min_shards: int = 1
    max_shards: int = 8
    #: the drain SLO: how long a fully-stalled backlog may take to drain
    #: at observed capacity before more shards are warranted
    drain_slo_s: float = 60.0
    #: hysteresis bands over the AGGREGATE backlog (bytes); up > down
    up_backlog_bytes: int = 64 * 1024 * 1024
    down_backlog_bytes: int = 8 * 1024 * 1024
    #: consecutive agreeing evaluations before a direction is decided
    up_ticks: int = 2
    down_ticks: int = 3
    #: evaluations that must pass after an applied decision
    cooldown_ticks: int = 5
    #: capacity-estimate floor (bytes/s): guards cold starts and idle
    #: windows where no durable progress was observed
    capacity_floor_bytes_per_s: float = 64 * 1024.0
    #: frames considered when estimating capacity
    window_frames: int = 8

    def validate(self) -> None:
        if self.min_shards < 1:
            raise EtlError(ErrorKind.CONFIG_INVALID,
                           f"min_shards must be >= 1, got {self.min_shards}")
        if self.max_shards < self.min_shards:
            raise EtlError(
                ErrorKind.CONFIG_INVALID,
                f"max_shards {self.max_shards} < min_shards "
                f"{self.min_shards}")
        if self.down_backlog_bytes >= self.up_backlog_bytes:
            raise EtlError(
                ErrorKind.CONFIG_INVALID,
                f"hysteresis bands inverted: down {self.down_backlog_bytes}"
                f" >= up {self.up_backlog_bytes} (the gap is the dead "
                f"zone that stops flapping)")
        if self.drain_slo_s <= 0:
            raise EtlError(ErrorKind.CONFIG_INVALID,
                           "drain_slo_s must be > 0")
        if min(self.up_ticks, self.down_ticks) < 1:
            raise EtlError(ErrorKind.CONFIG_INVALID,
                           "up_ticks/down_ticks must be >= 1")
        if self.cooldown_ticks < 0:
            raise EtlError(ErrorKind.CONFIG_INVALID,
                           "cooldown_ticks must be >= 0")
        if self.capacity_floor_bytes_per_s <= 0:
            raise EtlError(ErrorKind.CONFIG_INVALID,
                           "capacity_floor_bytes_per_s must be > 0")
        if self.window_frames < 2:
            raise EtlError(ErrorKind.CONFIG_INVALID,
                           "window_frames must be >= 2 (rates are deltas)")

    def to_json(self) -> dict:
        return {
            "min_shards": self.min_shards,
            "max_shards": self.max_shards,
            "drain_slo_s": self.drain_slo_s,
            "up_backlog_bytes": self.up_backlog_bytes,
            "down_backlog_bytes": self.down_backlog_bytes,
            "up_ticks": self.up_ticks,
            "down_ticks": self.down_ticks,
            "cooldown_ticks": self.cooldown_ticks,
            "capacity_floor_bytes_per_s": self.capacity_floor_bytes_per_s,
            "window_frames": self.window_frames,
        }

    @classmethod
    def from_json(cls, doc: dict) -> "AutoscalePolicyConfig":
        cfg = cls(**{k: doc[k] for k in cls().to_json() if k in doc})
        cfg.validate()
        return cfg


@dataclass(frozen=True)
class Decision:
    """One evaluation's outcome. `target_k` is the APPLIED target (the
    ±1-clamped next K when action is up/down, current K on hold);
    `raw_target_k` is the unclamped rate-model output, kept for
    observability — a raw target far above target_k means the system is
    under-provisioned and will keep stepping after each cooldown."""

    tick: int
    action: str
    current_k: int
    target_k: int
    raw_target_k: int
    backlog_bytes: int
    capacity_bytes_per_s: float
    reason: str

    def describe(self) -> dict:
        return {
            "tick": self.tick,
            "action": self.action,
            "current_k": self.current_k,
            "target_k": self.target_k,
            "raw_target_k": self.raw_target_k,
            "backlog_bytes": self.backlog_bytes,
            "capacity_bytes_per_s": round(self.capacity_bytes_per_s, 1),
            "reason": self.reason,
        }


class AutoscalePolicy:
    """Stateless evaluator; every public entry point is a pure function
    of its arguments plus the frozen config."""

    def __init__(self, config: AutoscalePolicyConfig | None = None):
        self.config = config or AutoscalePolicyConfig()
        self.config.validate()

    # -- rate model ----------------------------------------------------------

    @control_loop
    def estimate_capacity(self, history) -> float:
        """Per-shard drain capacity (bytes/s): for each shard, the best
        durable-LSN advance rate observed between consecutive frames in
        the window (best, not mean — idle ticks say nothing about what a
        shard CAN do); the median over shards; floored. Monotone in the
        evidence: more observed drain never lowers the estimate below
        the floor."""
        cfg = self.config
        window = list(history)[-cfg.window_frames:]
        if len(window) < 2:
            return cfg.capacity_floor_bytes_per_s
        best: dict[int, float] = {}
        for prev, cur in zip(window, window[1:]):
            dt = cur.at_s - prev.at_s
            if dt <= 0:
                continue
            prev_durable = {s.shard: s.durable_lsn for s in prev.shards}
            for s in cur.shards:
                before = prev_durable.get(s.shard)
                if before is None:
                    continue
                rate = max(0.0, (s.durable_lsn - before) / dt)
                if rate > best.get(s.shard, 0.0):
                    best[s.shard] = rate
        if not best:
            return cfg.capacity_floor_bytes_per_s
        rates = sorted(best.values())
        median = rates[len(rates) // 2]
        return max(median, cfg.capacity_floor_bytes_per_s)

    @control_loop
    def raw_target(self, backlog_bytes: int, capacity: float) -> int:
        """ceil(backlog / (capacity × drain_SLO)) — the DS2 shape. Zero
        backlog needs zero shards as far as the rate model is concerned;
        clamping to the deployment envelope happens in evaluate()."""
        if backlog_bytes <= 0:
            return 0
        return math.ceil(backlog_bytes
                         / (capacity * self.config.drain_slo_s))

    # -- decision ------------------------------------------------------------

    @control_loop
    def _votes(self, history, current_k: int, capacity: float,
               want_up: bool) -> int:
        """How many CONSECUTIVE newest frames vote for the direction.
        A frame votes up when its backlog breaches the up band; down
        when its backlog is under the down band AND the rate model at
        the (already-estimated) capacity wants fewer shards."""
        cfg = self.config
        votes = 0
        for frame in reversed(list(history)):
            backlog = frame.aggregate_backlog_bytes
            if want_up:
                agrees = backlog >= cfg.up_backlog_bytes
            else:
                agrees = (backlog <= cfg.down_backlog_bytes
                          and self.raw_target(backlog, capacity)
                          < current_k)
            if not agrees:
                break
            votes += 1
        return votes

    @control_loop
    def evaluate(self, history, current_k: int,
                 last_decision_tick: "int | None" = None) -> Decision:
        """One evaluation. `history` is the frame list (newest last,
        non-empty); `current_k` the authoritative shard count;
        `last_decision_tick` the tick of the last APPLIED decision (None
        = never scaled). Pure: same inputs, same Decision."""
        cfg = self.config
        frames = list(history)
        if not frames:
            raise EtlError(ErrorKind.INVALID_STATE_TRANSITION,
                           "evaluate() needs at least one signal frame")
        latest = frames[-1]
        backlog = latest.aggregate_backlog_bytes
        capacity = self.estimate_capacity(frames)
        raw = self.raw_target(backlog, capacity)

        def hold(reason: str) -> Decision:
            return Decision(tick=latest.tick, action=ACTION_HOLD,
                            current_k=current_k, target_k=current_k,
                            raw_target_k=raw, backlog_bytes=backlog,
                            capacity_bytes_per_s=capacity, reason=reason)

        if not latest.all_healthy:
            return hold("unhealthy shard: rebalancing a sick fleet would "
                        "block on its fence")
        in_cooldown = (last_decision_tick is not None
                       and latest.tick - last_decision_tick
                       < cfg.cooldown_ticks)

        # scale-up: sustained backlog above the band; minimum response
        # +1 even when the rate model is optimistic (see module doc)
        if backlog >= cfg.up_backlog_bytes and current_k < cfg.max_shards:
            if self._votes(frames, current_k, capacity, True) \
                    >= cfg.up_ticks:
                if in_cooldown:
                    return hold(
                        f"cooldown: {latest.tick - last_decision_tick}"
                        f"/{cfg.cooldown_ticks} ticks since last decision")
                target = current_k + 1  # max-step: the rebalance is
                # proven for single steps; a raw target further out
                # keeps stepping after each cooldown
                return Decision(
                    tick=latest.tick, action=ACTION_UP,
                    current_k=current_k, target_k=target,
                    raw_target_k=raw, backlog_bytes=backlog,
                    capacity_bytes_per_s=capacity,
                    reason=f"backlog {backlog}B over up band "
                           f"{cfg.up_backlog_bytes}B for "
                           f">={cfg.up_ticks} ticks (raw target {raw})")
            return hold("backlog over up band, votes not yet sustained")

        # scale-down: sustained quiet under the band, rate model agrees
        if backlog <= cfg.down_backlog_bytes \
                and current_k > cfg.min_shards \
                and raw < current_k:
            if latest.any_memory_pressure:
                return hold("memory pressure vetoes scale-down")
            if self._votes(frames, current_k, capacity, False) \
                    >= cfg.down_ticks:
                if in_cooldown:
                    return hold(
                        f"cooldown: {latest.tick - last_decision_tick}"
                        f"/{cfg.cooldown_ticks} ticks since last decision")
                return Decision(
                    tick=latest.tick, action=ACTION_DOWN,
                    current_k=current_k, target_k=current_k - 1,
                    raw_target_k=raw, backlog_bytes=backlog,
                    capacity_bytes_per_s=capacity,
                    reason=f"backlog {backlog}B under down band "
                           f"{cfg.down_backlog_bytes}B for "
                           f">={cfg.down_ticks} ticks (raw target {raw})")
            return hold("backlog under down band, votes not yet sustained")

        return hold("backlog inside the hysteresis dead zone"
                    if cfg.down_backlog_bytes < backlog
                    < cfg.up_backlog_bytes
                    else "no eligible transition")


@control_loop
def simulate(frames, policy: AutoscalePolicy,
             start_k: int) -> "list[Decision]":
    """Dry-run a frame sequence through the policy with the applied-K
    loop closed in memory: every non-hold decision updates the simulated
    topology and starts the cooldown, exactly as a controller applying
    each decision instantly would. Pure — the replay CLI's trace, the
    bench reaction-time gate, and the no-flap property tests all run
    through here, so they exercise the same loop semantics."""
    decisions: list[Decision] = []
    current_k = start_k
    last_tick: "int | None" = None
    history: list = []
    for frame in frames:
        history.append(frame)
        decision = policy.evaluate(history, current_k, last_tick)
        decisions.append(decision)
        if decision.action != ACTION_HOLD:
            current_k = decision.target_k
            last_tick = decision.tick
    return decisions
