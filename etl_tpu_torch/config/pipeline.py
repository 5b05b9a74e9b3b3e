"""Typed pipeline configuration.

Reference parity: `PipelineConfig`, `BatchConfig`, `MemoryBackpressureConfig`,
`PgConnectionConfig`, `TableSyncCopyConfig`, retry configs
(crates/etl-config/src/shared/pipeline.rs:11,185,239; connection.rs).
Defaults mirror the reference's tuning constants (BASELINE.md):
batch 8 MiB / 10 s fill / memory ratio 0.2; backpressure 0.85/0.75;
copy 4 partitions-per-connection / 250k rows / ≤1024 partitions.

Copy of the reference's `etl_tpu/config/pipeline.py`. `batch_engine`
selects the decode path at the BatchConfig boundary: "cpu" (the per-row
oracle) or "cuda" (the port's DeviceDecoder, in place of the reference's
"tpu"). `BatchConfig.device` names the torch device the decoder runs on:
"cuda" by default; "cpu" runs the kernels' plain versions (the tests).
Every other field keeps the reference's name and default; the program
cache, prewarm and device-egress fields have no effect in the port yet.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field

from ..models.errors import ErrorKind, EtlError


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise EtlError(ErrorKind.CONFIG_INVALID, what)


class InvalidatedSlotBehavior(enum.Enum):
    """What to do when the replication slot was invalidated by the source
    (reference apply/worker.rs:476-527)."""

    ERROR = "error"
    RECREATE_AND_RESYNC = "recreate_and_resync"


class BatchEngine(enum.Enum):
    CPU = "cpu"
    CUDA = "cuda"


@dataclass(frozen=True)
class TlsConfig:
    enabled: bool = False
    trusted_root_certs: str = ""


@dataclass(frozen=True)
class PgConnectionConfig:
    host: str = "localhost"
    port: int = 5432
    name: str = "postgres"  # database name
    username: str = "postgres"
    password: str | None = None
    tls: TlsConfig = field(default_factory=TlsConfig)
    keepalive_idle_s: int = 60
    connect_timeout_s: int = 30

    def validate(self) -> None:
        _require(1 <= self.port <= 65535, f"port out of range: {self.port}")
        _require(bool(self.host), "host must be non-empty")


@dataclass(frozen=True)
class BatchConfig:
    """Flush sizing (reference pipeline.rs:52-68)."""

    max_size_bytes: int = 8 * 1024 * 1024
    max_fill_ms: int = 10_000
    batch_engine: BatchEngine = BatchEngine.CUDA
    # torch device of the CUDA engine's decoders: "cuda" (the card; no
    # card raises at Pipeline.start) or "cpu" (the kernels' plain
    # versions on CPU tensors)
    device: str = "cuda"
    # bounded in-flight window of the decode pipeline (ops/pipeline.py):
    # batches packed/dispatched but not yet fetched. 3 ≈ one packing, one
    # on the device, one streaming back; drops to 1 under memory pressure
    decode_window: int = 3
    # bounded destination-ack write window (runtime/ack_window.py): the
    # apply loop keeps dispatching flushes in WAL order while up to this
    # many earlier acks are still pending, advancing durable progress
    # only over the contiguous acked prefix. 4 hides one ack round-trip
    # behind three later writes on real destinations; 1 reproduces the
    # reference's one-in-flight loop exactly. Shrinks to 1 under memory
    # pressure. The copy path caps its per-partition outstanding acks
    # with the same knob.
    write_window: int = 4
    # byte cap on the window's pending payloads (0 = unbounded): mega
    # batches under backlog growth stop stacking K × 128 MiB of
    # in-flight payload; an empty window always admits one dispatch, so
    # a single over-budget batch can never deadlock
    write_window_max_bytes: int = 64 * 1024 * 1024
    # shared-capacity cap of the fair batch-admission scheduler
    # (ops/pipeline.AdmissionScheduler): maximum device/host batches in
    # flight across EVERY pipeline sharing this process's device set.
    # 0 = auto (max(4, 2 × device count)); the FIRST pipeline to start
    # fixes the process-wide value. Drops to 1 under memory pressure.
    admission_capacity: int = 0
    # AOT program cache directory (ops/program_store.py): compiled decode
    # executables persist here, keyed by canonical layout + backend +
    # versions, so a restarted replicator LOADS its programs instead of
    # re-paying the XLA builds. None = in-memory only (also honors
    # $ETL_TPU_PROGRAM_CACHE_DIR). The store is PROCESS-global, like the
    # admission scheduler's capacity: the first pipeline to configure a
    # dir fixes it for every pipeline in the process (a later pipeline
    # naming a different dir is ignored with a warning; one naming None
    # shares the configured store). Safe to share across pods on
    # identical images/machine types — see the OPERATIONS.md runbook.
    program_cache_dir: str | None = None
    # warm stored table schemas' canonical host programs at
    # Pipeline.start, before the apply loop sees traffic. None = auto
    # (prewarm iff a program cache dir is configured — without one a
    # fresh process has nothing to load and the nonblocking background
    # compiles cover first-touch); the row buckets default to
    # program_store.PREWARM_ROW_BUCKETS.
    prewarm_programs: bool | None = None
    prewarm_row_buckets: tuple | None = None
    # device-resident wire encoding (ops/egress.py): when True and the
    # destination declares an egress encoder, decode programs gain a
    # second fused stage that renders int/bool/temporal field TEXT on
    # device, and decoded batches arrive with wire-ready byte buffers
    # the destination splices instead of re-rendering host-side. Purely
    # a fast path: batches without buffers (cold program, unsupported
    # layout, filtered batches) encode host-side byte-identically.
    device_egress: bool = True

    def validate(self) -> None:
        _require(self.max_size_bytes > 0, "max_size_bytes must be > 0")
        _require(self.max_fill_ms > 0, "max_fill_ms must be > 0")
        _require(self.device.split(":")[0] in ("cuda", "cpu"),
                 f"batch device must be cuda or cpu, got {self.device!r}")
        _require(self.decode_window >= 1, "decode_window must be >= 1")
        _require(self.write_window >= 1, "write_window must be >= 1")
        _require(self.write_window_max_bytes >= 0,
                 "write_window_max_bytes must be >= 0 (0 = unbounded)")
        _require(self.admission_capacity >= 0,
                 "admission_capacity must be >= 0 (0 = auto)")
        _require(all(b > 0 for b in self.prewarm_row_buckets or ()),
                 "prewarm_row_buckets must be positive row capacities")


@dataclass(frozen=True)
class MemoryBackpressureConfig:
    """RSS hysteresis thresholds (reference pipeline.rs:199-201)."""

    activate_ratio: float = 0.85
    resume_ratio: float = 0.75
    refresh_interval_ms: int = 100
    memory_ratio: float = 0.2  # share of memory for batch budgets

    def validate(self) -> None:
        _require(0 < self.resume_ratio < self.activate_ratio <= 1.0,
                 "need 0 < resume < activate <= 1")
        _require(self.refresh_interval_ms > 0, "refresh interval must be > 0")


@dataclass(frozen=True)
class TableSyncCopyConfig:
    """CTID-partitioned parallel copy planning (reference copy.rs:54-58)."""

    max_connections: int = 4
    partitions_per_connection: int = 4
    rows_per_partition_target: int = 250_000
    max_partitions: int = 1024

    def validate(self) -> None:
        _require(self.max_connections >= 1, "need >= 1 copy connection")
        _require(self.max_partitions >= 1, "need >= 1 partition")


@dataclass(frozen=True)
class SupervisionConfig:
    """Liveness supervision (etl_tpu/supervision): heartbeat deadlines,
    escalation pacing, breaker thresholds. A component HANGS when its
    heartbeat goes stale past `hang_deadline_s`; it STALLS when it keeps
    beating with work in flight but its progress token freezes past
    `stall_deadline_s`. Deadlines must comfortably exceed the apply
    loop's keepalive pacing (60% of wal_sender_timeout) — an idle loop
    beats only once per select timeout."""

    enabled: bool = True
    check_interval_s: float = 1.0
    stall_deadline_s: float = 60.0
    hang_deadline_s: float = 120.0
    # minimum spacing between cancel-and-restart escalations of the same
    # component (the restarted worker also rides RetryPolicy backoff)
    restart_backoff_s: float = 5.0
    # device-side decode stalls before the batch engine degrades to the
    # host oracle, and for how long the degrade sticks
    device_degrade_threshold: int = 3
    device_degrade_cooldown_s: float = 60.0
    # destination circuit breaker: consecutive failures to trip OPEN, and
    # the cooldown before a HALF_OPEN trial call is admitted
    breaker_failure_threshold: int = 5
    breaker_cooldown_s: float = 15.0

    def validate(self) -> None:
        _require(self.check_interval_s > 0, "check_interval_s must be > 0")
        _require(self.stall_deadline_s > 0, "stall_deadline_s must be > 0")
        _require(self.hang_deadline_s > 0, "hang_deadline_s must be > 0")
        _require(self.breaker_failure_threshold >= 1,
                 "breaker_failure_threshold must be >= 1")
        _require(self.breaker_cooldown_s > 0, "breaker_cooldown_s must be > 0")
        _require(self.device_degrade_threshold >= 1,
                 "device_degrade_threshold must be >= 1")


@dataclass(frozen=True)
class PoisonConfig:
    """Poison-pill isolation (runtime/poison.py, docs/dead-letter.md).

    When a CDC flush fails with a PERMANENT destination error
    (models.errors.POISON_KINDS — the payload is refused, the
    destination is healthy), the apply loop bisects the failing batch
    down to the poison row(s), delivers the healthy complement in WAL
    order, and parks the poison rows on the durable dead-letter surface
    instead of dying. Tables that exceed `budget_rows` dead-lettered
    rows inside a sliding `window_s` window transition to QUARANTINE:
    their events bypass the destination (parked straight to the DLQ,
    counted) while every other table keeps replicating."""

    enabled: bool = True
    # dead-lettered rows per table per window before the table
    # quarantines (also the bisection work bound: once tripped, the
    # remaining rows of that table park without further probe writes)
    budget_rows: int = 8
    window_s: float = 300.0
    # truncate the stored error detail per entry (payloads are bounded
    # by the flush sizing already)
    max_detail_chars: int = 500
    # how often the flush path re-reads the store's quarantine records
    # so an operator `unquarantine` (another process) takes effect
    # WITHOUT a worker restart; 0 disables the poll (restart-only
    # adoption, the pre-live behavior)
    quarantine_poll_s: float = 30.0
    # age past which replayed/discarded dead-letter rows are eligible
    # for `python -m etl_tpu.dlq compact` (rows still `dead` are never
    # expired — they are the zero-loss ledger)
    dlq_retention_s: float = 7 * 24 * 3600.0

    def validate(self) -> None:
        _require(self.budget_rows >= 1, "poison budget_rows must be >= 1")
        _require(self.window_s > 0, "poison window_s must be > 0")
        _require(self.quarantine_poll_s >= 0,
                 "poison quarantine_poll_s must be >= 0")
        _require(self.dlq_retention_s > 0,
                 "poison dlq_retention_s must be > 0")


@dataclass(frozen=True)
class RetryConfig:
    max_attempts: int = 5
    initial_delay_ms: int = 1_000
    max_delay_ms: int = 60_000
    backoff_factor: float = 2.0

    def delay_ms(self, attempt: int) -> int:
        d = self.initial_delay_ms * (self.backoff_factor ** attempt)
        return int(min(d, self.max_delay_ms))


@dataclass(frozen=True)
class PipelineConfig:
    pipeline_id: int
    publication_name: str
    pg_connection: PgConnectionConfig = field(default_factory=PgConnectionConfig)
    batch: BatchConfig = field(default_factory=BatchConfig)
    backpressure: MemoryBackpressureConfig = field(
        default_factory=MemoryBackpressureConfig)
    table_sync_copy: TableSyncCopyConfig = field(
        default_factory=TableSyncCopyConfig)
    apply_retry: RetryConfig = field(default_factory=RetryConfig)
    table_retry: RetryConfig = field(default_factory=RetryConfig)
    supervision: SupervisionConfig = field(default_factory=SupervisionConfig)
    poison: PoisonConfig = field(default_factory=PoisonConfig)
    # every Destination.startup/write/flush await is bounded by this (a
    # destination that never returns surfaces as EtlError(TIMEOUT), not
    # an eternal await); 0 disables the bound
    destination_op_timeout_s: float = 60.0
    max_table_sync_workers: int = 4
    invalidated_slot_behavior: InvalidatedSlotBehavior = \
        InvalidatedSlotBehavior.ERROR
    run_source_migrations: bool = True
    wal_sender_timeout_ms: int = 60_000
    # background schema-version pruning cadence (reference hourly task,
    # apply.rs:123,423-631); 0 disables
    schema_cleanup_interval_s: float = 3600.0
    # out-of-band lag sampler cadence (reference apply.rs:579-624 polling
    # pg_current_wal_lsn on a lazy side connection); 0 disables
    lag_sample_interval_s: float = 10.0
    # horizontal scale-out (etl_tpu/sharding, docs/sharding.md): this
    # pod's shard index within a K-way split of the publication. None =
    # unsharded (the pod owns every published table, slot names carry no
    # suffix). A sharded pod filters publication tables by ShardMap
    # membership, replicates through `_s{shard}`-suffixed slots, and
    # fences its store writes against the authoritative epoch.
    shard: int | None = None
    shard_count: int = 1

    def validate(self) -> None:
        _require(self.pipeline_id >= 0, "pipeline_id must be >= 0")
        _require(bool(self.publication_name), "publication_name required")
        _require(self.shard_count >= 1, "shard_count must be >= 1")
        if self.shard is not None:
            _require(0 <= self.shard < self.shard_count,
                     f"shard must be in [0, {self.shard_count}), "
                     f"got {self.shard}")
        else:
            _require(self.shard_count == 1,
                     "shard_count > 1 requires a shard index (every pod "
                     "of a sharded deployment must know which slice it "
                     "owns)")
        _require(self.max_table_sync_workers >= 1,
                 "need >= 1 table sync worker")
        _require(self.destination_op_timeout_s >= 0,
                 "destination_op_timeout_s must be >= 0")
        self.pg_connection.validate()
        self.batch.validate()
        self.backpressure.validate()
        self.table_sync_copy.validate()
        self.supervision.validate()
        self.poison.validate()

    @property
    def keepalive_deadline_ms(self) -> int:
        """60% of wal_sender_timeout, floored at 100ms (reference
        apply.rs:94-116)."""
        return max(100, int(self.wal_sender_timeout_ms * 0.6))
