"""Autoscale signal plane: per-shard lag/rate/pressure frames.

The control loop never reads raw telemetry mid-decision. A collector
samples everything the policy needs into an immutable `SignalFrame` —
per-shard replication lag (received−durable bytes, the
`postgres/lag.py` SlotLagMetrics shape), durable-progress LSNs (the
drain-rate evidence), delivered event counts, memory-pressure and
health state — and the policy is then a pure function of the frame
HISTORY (policy.py). That split is what makes the whole loop
deterministic: a recorded (or seeded-synthetic) timeline replays the
identical decision trace through `python -m etl_tpu_torch.autoscale
--replay`,
and the chaos scenarios assert on exact decision sequences per seed.

Two collectors ship:

  RegistrySignalSource — reads the in-process telemetry registry
      (`etl_slot_lag_bytes{shard}` + `etl_shard_delivered_events{shard}`,
      published by the apply loop on its status-update cadence, and the
      memory-backpressure gauge). The single-process vantage: bench
      runs, tests, and a sidecar controller sharing the pod.
  StoreSignalSource — the COORDINATOR's vantage: per-shard lag computed
      as (source WAL position − per-shard apply-slot durable progress)
      against the shared StateStore, plus per-shard health probes. This
      is what the pod-external controller runs against K replicator
      pods it cannot share a process with.

Frames and timelines serialize to JSON (`--replay` files, chaos
manifests). `seeded_surge_timeline` generates the canonical synthetic
surge→drain story deterministically per seed — the replay CLI default,
the bench reaction-time gate, and the hysteresis property tests all
draw from it.

Copy of the reference's `etl_tpu/autoscale/signals.py`. In one process
the K pods share the telemetry registry; each publishes its lag under its
own `shard` label, which is what `RegistrySignalSource` reads.
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field

from ..models.errors import ErrorKind, EtlError


@dataclass(frozen=True)
class ShardSignals:
    """One shard's sampled state inside a frame. `lag_bytes` is
    received−durable WAL bytes (SlotLagMetrics.confirmed_flush_lag
    shape); `durable_lsn` is the raw progress LSN so the policy can
    derive drain rates from consecutive frames without the collector
    smuggling a clock into the data."""

    shard: int
    lag_bytes: int
    durable_lsn: int = 0
    delivered_events: int = 0
    memory_pressure: bool = False
    healthy: bool = True

    def to_json(self) -> dict:
        return {
            "shard": self.shard,
            "lag_bytes": self.lag_bytes,
            "durable_lsn": self.durable_lsn,
            "delivered_events": self.delivered_events,
            "memory_pressure": self.memory_pressure,
            "healthy": self.healthy,
        }

    @classmethod
    def from_json(cls, doc: dict) -> "ShardSignals":
        return cls(
            shard=int(doc["shard"]),
            lag_bytes=int(doc.get("lag_bytes", 0)),
            durable_lsn=int(doc.get("durable_lsn", 0)),
            delivered_events=int(doc.get("delivered_events", 0)),
            memory_pressure=bool(doc.get("memory_pressure", False)),
            healthy=bool(doc.get("healthy", True)),
        )


@dataclass(frozen=True)
class SignalFrame:
    """One evaluation tick's complete input. `at_s` is the sample time
    in SECONDS on whatever clock the collector used — the policy only
    ever takes deltas, so synthetic timelines use the tick index and
    live collectors use a monotonic clock; neither leaks into the
    decision beyond rate denominators."""

    tick: int
    at_s: float
    shards: tuple = ()

    @property
    def shard_count(self) -> int:
        return len(self.shards)

    @property
    def aggregate_backlog_bytes(self) -> int:
        return sum(s.lag_bytes for s in self.shards)

    @property
    def any_memory_pressure(self) -> bool:
        return any(s.memory_pressure for s in self.shards)

    @property
    def all_healthy(self) -> bool:
        return all(s.healthy for s in self.shards)

    def to_json(self) -> dict:
        return {"tick": self.tick, "at_s": self.at_s,
                "shards": [s.to_json() for s in self.shards]}

    @classmethod
    def from_json(cls, doc: dict) -> "SignalFrame":
        return cls(tick=int(doc["tick"]), at_s=float(doc["at_s"]),
                   shards=tuple(ShardSignals.from_json(s)
                                for s in doc.get("shards", [])))


@dataclass
class SignalTimeline:
    """Bounded frame history (newest last). The policy receives the
    whole list; the bound exists so a long-lived controller's memory
    stays flat, not to hide data from the policy — `max_frames` is
    always ≥ the policy's evaluation window."""

    max_frames: int = 256
    frames: list = field(default_factory=list)

    def record(self, frame: SignalFrame) -> None:
        if self.frames and frame.tick <= self.frames[-1].tick:
            raise EtlError(
                ErrorKind.INVALID_STATE_TRANSITION,
                f"signal frame tick regression: "
                f"{self.frames[-1].tick} -> {frame.tick}")
        self.frames.append(frame)
        if len(self.frames) > self.max_frames:
            del self.frames[:len(self.frames) - self.max_frames]

    def to_json(self) -> dict:
        return {"max_frames": self.max_frames,
                "frames": [f.to_json() for f in self.frames]}

    @classmethod
    def from_json(cls, doc: dict) -> "SignalTimeline":
        tl = cls(max_frames=int(doc.get("max_frames", 256)))
        for f in doc.get("frames", []):
            tl.record(SignalFrame.from_json(f))
        return tl


class RegistrySignalSource:
    """Samples the in-process telemetry registry: the per-shard lag and
    delivered-events gauges the apply loop publishes on its status
    cadence (`runtime/apply_loop.py`), plus the process-wide memory
    backpressure gauge. Shards that have never published read as lag 0 /
    healthy — a frame is always total over the CURRENT shard count.

    `shard_count` may be an int (a fixed topology) or a zero-arg
    callable returning the live K (pass the controller's
    assignment-reader on an autoscaled fleet): a pinned count would keep
    sampling retired shards' never-cleared gauges after a scale-down —
    inflating backlog forever — and miss new shards after a scale-up."""

    def __init__(self, shard_count):
        if not callable(shard_count) and int(shard_count) < 1:
            raise EtlError(ErrorKind.CONFIG_INVALID,
                           f"shard_count must be >= 1, got {shard_count}")
        self._count_reader = shard_count if callable(shard_count) \
            else (lambda: shard_count)
        self._tick = 0

    @property
    def shard_count(self) -> int:
        return max(1, int(self._count_reader()))

    async def sample(self, at_s: float) -> SignalFrame:
        from ..telemetry.metrics import (ETL_MEMORY_BACKPRESSURE_ACTIVE,
                                         ETL_SHARD_DELIVERED_EVENTS,
                                         ETL_SLOT_LAG_BYTES, registry)

        pressure = bool(registry.get_gauge(
            ETL_MEMORY_BACKPRESSURE_ACTIVE) or 0)
        shards = []
        for shard in range(self.shard_count):
            labels = {"shard": str(shard)}
            lag = registry.get_gauge(ETL_SLOT_LAG_BYTES, labels) or 0
            delivered = registry.get_gauge(ETL_SHARD_DELIVERED_EVENTS,
                                           labels) or 0
            shards.append(ShardSignals(
                shard=shard, lag_bytes=int(lag),
                delivered_events=int(delivered),
                memory_pressure=pressure))
        tick = self._tick
        self._tick += 1
        return SignalFrame(tick=tick, at_s=at_s, shards=tuple(shards))


class StoreSignalSource:
    """The pod-external (coordinator-vantage) collector: lag per shard =
    source WAL position − that shard's apply-slot durable progress, read
    from the SHARED store — the exact quantity the two-phase rebalance
    quiesce waits on, so the policy scales on the same evidence the
    actuation will later fence against. `health` is an optional async
    per-shard probe (e.g. the pod's /health endpoint); absent probes
    read healthy, because an autoscaler that refuses to act whenever a
    health endpoint is unreachable would freeze exactly when it is
    needed most — the policy still HOLDS on explicit unhealthy."""

    def __init__(self, store, pipeline_id: int, source_factory,
                 shard_count_reader, health=None, pressure=None):
        self.store = store
        self.pipeline_id = pipeline_id
        self.source_factory = source_factory
        # () -> int: the CURRENT topology K (the authoritative
        # assignment's shard_count — the controller passes a closure
        # over its last-read assignment so collector and policy agree)
        self.shard_count_reader = shard_count_reader
        self._health = health  # async (shard) -> bool | None
        self._pressure = pressure  # (shard) -> bool | None
        self._tick = 0

    async def sample(self, at_s: float) -> SignalFrame:
        from ..postgres.slots import apply_slot_name

        source = self.source_factory()
        await source.connect()
        try:
            wal_end = int(await source.get_current_wal_lsn())
        finally:
            await source.close()
        shards = []
        for shard in range(max(1, int(self.shard_count_reader()))):
            durable = await self.store.get_durable_progress(
                apply_slot_name(self.pipeline_id, shard))
            durable_i = int(durable) if durable is not None else 0
            healthy = True
            if self._health is not None:
                probed = await self._health(shard)
                healthy = True if probed is None else bool(probed)
            pressure = bool(self._pressure(shard)) \
                if self._pressure is not None else False
            shards.append(ShardSignals(
                shard=shard,
                lag_bytes=max(0, wal_end - durable_i),
                durable_lsn=durable_i,
                memory_pressure=pressure,
                healthy=healthy))
        tick = self._tick
        self._tick += 1
        return SignalFrame(tick=tick, at_s=at_s, shards=tuple(shards))


def seeded_surge_timeline(seed: int = 7, *, shards: int = 2,
                          ticks: int = 40, surge_at: int = 10,
                          surge_ticks: int = 6,
                          baseline_lag: int = 2_048,
                          surge_lag: int = 512 * 1024,
                          drain_per_tick: int = 128 * 1024,
                          noise: int = 512,
                          interval_s: float = 1.0) -> SignalTimeline:
    """The canonical synthetic story, bit-identical per seed: quiet
    baseline (small noisy lag), a backlog surge at `surge_at` held for
    `surge_ticks`, then a linear drain back to baseline. Durable LSNs
    advance at a steady per-tick rate so the policy's capacity estimate
    is well-defined. Used by the replay CLI's --synthetic mode, the
    bench reaction-time gate (`bench.py --autoscale`), and the
    hysteresis property tests (noise around a band edge must not flap).
    """
    rng = random.Random(seed)
    tl = SignalTimeline(max_frames=max(ticks, 256))
    durable = [0] * shards
    lag = [baseline_lag] * shards
    for tick in range(ticks):
        if tick == surge_at:
            for s in range(shards):
                lag[s] += surge_lag
        elif tick > surge_at + surge_ticks:
            for s in range(shards):
                lag[s] = max(baseline_lag, lag[s] - drain_per_tick)
        frame_shards = []
        for s in range(shards):
            durable[s] += drain_per_tick
            jitter = rng.randrange(-noise, noise + 1)
            frame_shards.append(ShardSignals(
                shard=s, lag_bytes=max(0, lag[s] + jitter),
                durable_lsn=durable[s],
                delivered_events=durable[s] // 64))
        tl.record(SignalFrame(tick=tick, at_s=tick * interval_s,
                              shards=tuple(frame_shards)))
    return tl
