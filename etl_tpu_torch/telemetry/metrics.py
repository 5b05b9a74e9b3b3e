"""Metrics: registry + Prometheus text exposition.

Reference parity: the `metrics` facade + Prometheus recorder
(crates/etl-telemetry/src/metrics.rs:23-62) and the metric-name constants
(crates/etl/src/observability.rs:7-72). Implemented dependency-free:
counters/gauges/histograms in-process, rendered in Prometheus text format
for the API `/metrics` route and the replicator's endpoint.

Copy of the reference's `etl_tpu/telemetry/metrics.py`.
"""

from __future__ import annotations

import threading
from collections import defaultdict
from dataclasses import dataclass, field

# --- metric names (reference observability.rs) ------------------------------

ETL_TABLE_COPY_ROWS_TOTAL = "etl_table_copy_rows_total"
# TableRow/PartialTableRow constructions (models/table_row keeps the hot
# counter; publish_table_rows_constructed() mirrors it here). Zero over a
# streamed-CDC window = the egress path stayed columnar fetch-to-wire —
# bench.py --smoke gates on exactly that.
ETL_TABLE_ROWS_CONSTRUCTED_TOTAL = "etl_table_rows_constructed_total"
ETL_TABLE_COPY_BYTES_TOTAL = "etl_table_copy_bytes_total"
ETL_TABLE_COPY_DURATION_SECONDS = "etl_table_copy_duration_seconds"
ETL_TABLE_COPY_END_TO_END_LAG_BYTES = "etl_table_copy_end_to_end_lag_bytes"
ETL_APPLY_LOOP_EVENTS_TOTAL = "etl_apply_loop_events_total"
ETL_APPLY_LOOP_BATCHES_TOTAL = "etl_apply_loop_batches_total"
ETL_APPLY_LOOP_RECEIVED_LAG_BYTES = "etl_apply_loop_received_lag_bytes"
ETL_APPLY_LOOP_FLUSH_LAG_BYTES = "etl_apply_loop_flush_lag_bytes"
ETL_APPLY_LOOP_EFFECTIVE_FLUSH_LAG_BYTES = \
    "etl_apply_loop_effective_flush_lag_bytes"
ETL_APPLY_LOOP_END_TO_END_LAG_BYTES = "etl_apply_loop_end_to_end_lag_bytes"
ETL_TRANSACTION_SIZE_BYTES = "etl_transaction_size_bytes"
ETL_TRANSACTIONS_TOTAL = "etl_transactions_total"
ETL_MEMORY_BACKPRESSURE_ACTIVATIONS_TOTAL = \
    "etl_memory_backpressure_activations_total"
ETL_MEMORY_BACKPRESSURE_ACTIVE = "etl_memory_backpressure_active"
ETL_WORKER_ERRORS_TOTAL = "etl_worker_errors_total"
ETL_SLOT_INVALIDATIONS_TOTAL = "etl_slot_invalidations_total"
ETL_TABLES_TOTAL = "etl_tables_total"
ETL_TABLES_READY = "etl_tables_ready"
ETL_TABLES_ERRORED = "etl_tables_errored"
ETL_DEVICE_DECODE_ROWS_TOTAL = "etl_device_decode_rows_total"
ETL_DEVICE_DECODE_FALLBACK_ROWS_TOTAL = \
    "etl_device_decode_fallback_rows_total"
ETL_DEVICE_DECODE_SECONDS = "etl_device_decode_seconds"
# fused publication row filtering (ops/predicate.py + the fused decode
# program): rows the predicate compacted out of decode output, the bytes
# the packed-result fetch actually moved over the device→host link
# (filtered dispatches fetch a survivor-count-sized slice, so this
# counter — not an assumption — is the evidence that fetched bytes scale
# with selectivity), and the last-batch selectivity (survivors / staged
# rows) of filter-bearing decoders
ETL_DECODE_ROWS_FILTERED_TOTAL = "etl_decode_rows_filtered_total"
ETL_DECODE_FETCHED_BYTES_TOTAL = "etl_decode_fetched_bytes_total"
ETL_DECODE_FILTER_SELECTIVITY = "etl_decode_filter_selectivity"
# decode routing by path (device / per-row oracle; the reference's host
# route has no counterpart in the port): benches report the device share
# so a host-only steady state can't hide
ETL_DECODE_ROUTED_DEVICE_ROWS_TOTAL = "etl_decode_routed_device_rows_total"
ETL_DECODE_ROUTED_HOST_ROWS_TOTAL = "etl_decode_routed_host_rows_total"
ETL_DECODE_ROUTED_ORACLE_ROWS_TOTAL = "etl_decode_routed_oracle_rows_total"
ETL_PROCESSED_BYTES_TOTAL = "etl_processed_bytes_total"
# decode pipeline stage timings (ops/pipeline.py): pack = host gather into
# the staging arena, dispatch = uploads + launch (device work starts), fetch =
# result wait + unpack/combine. Overlap = seconds of pack time that ran
# while another batch was in flight on the device — the whole point of the
# three-stage scheduler; the ratio gauge is overlap/pack cumulatively.
ETL_DECODE_PACK_SECONDS = "etl_decode_pack_seconds"
ETL_DECODE_DISPATCH_SECONDS = "etl_decode_dispatch_seconds"
ETL_DECODE_FETCH_SECONDS = "etl_decode_fetch_seconds"
ETL_DECODE_PIPELINE_PACK_SECONDS_TOTAL = \
    "etl_decode_pipeline_pack_seconds_total"
ETL_DECODE_PIPELINE_OVERLAP_SECONDS_TOTAL = \
    "etl_decode_pipeline_overlap_seconds_total"
ETL_DECODE_PIPELINE_OVERLAP_RATIO = "etl_decode_pipeline_overlap_ratio"
ETL_DECODE_PIPELINE_IN_FLIGHT = "etl_decode_pipeline_in_flight"
# staging-arena pool (ops/staging.py): hit = a preallocated buffer was
# reused, miss = a fresh allocation (labels: {"result": "hit"|"miss"})
ETL_STAGING_ARENA_REQUESTS_TOTAL = "etl_staging_arena_requests_total"
# the card's time per decode, from the dispatch stream's events (H2D,
# kernel, D2H, a filtered decode's second fetch, the egress render and
# its fetch; the decode kernel alone; the render alone and its fetch):
# the device busy share of a window is their delta over its wall time
ETL_DECODE_DEVICE_SECONDS_TOTAL = "etl_decode_device_seconds_total"
ETL_DECODE_KERNEL_SECONDS_TOTAL = "etl_decode_kernel_seconds_total"
ETL_EGRESS_RENDER_SECONDS_TOTAL = "etl_egress_render_seconds_total"
ETL_EGRESS_FETCH_SECONDS_TOTAL = "etl_egress_fetch_seconds_total"
# rows of each run the CDC assembler seals into one decode batch (what the
# runtime hands the card: launches and copies are paid per run)
ETL_ASSEMBLER_RUN_ROWS = "etl_assembler_run_rows"
# mesh-sharded decode (ops/engine.py mesh path): shard count of the last
# sharded dispatch, batches/rows routed through the mesh program, padding
# rows appended by pad_to_multiple so odd buckets shard (the waste-ratio
# gauge is cumulative padded/uploaded — upload bytes are the binding
# resource, so sustained waste above a few percent means the row buckets
# and the mesh size disagree), and the device-reduced per-shard
# fallback-candidate counts (total + a per-shard last-batch gauge; skew
# across shards points at a sick device, not bad data)
ETL_DECODE_MESH_SHARDS = "etl_decode_mesh_shards"
ETL_DECODE_MESH_BATCHES_TOTAL = "etl_decode_mesh_batches_total"
ETL_DECODE_MESH_ROWS_TOTAL = "etl_decode_mesh_rows_total"
ETL_DECODE_MESH_PADDED_ROWS_TOTAL = "etl_decode_mesh_padded_rows_total"
ETL_DECODE_MESH_PAD_WASTE_RATIO = "etl_decode_mesh_pad_waste_ratio"
ETL_DECODE_MESH_FALLBACK_CANDIDATE_ROWS_TOTAL = \
    "etl_decode_mesh_fallback_candidate_rows_total"
ETL_DECODE_MESH_SHARD_FALLBACK_CANDIDATES = \
    "etl_decode_mesh_shard_fallback_candidates"
# fair batch-admission scheduler (ops/pipeline.AdmissionScheduler): N
# decode pipelines sharing one device set. Wait histogram + grant
# counters are labeled per pipeline tenant; starvation grants count the
# aging valve overriding the lag-weighted pick (a tenant waited past the
# starvation deadline); bypass grants count the liveness valve
# (consumer blocked on an undispatched batch, or close) overshooting the
# capacity instead of deadlocking
ETL_DECODE_ADMISSION_WAIT_SECONDS = "etl_decode_admission_wait_seconds"
ETL_DECODE_ADMISSION_GRANTS_TOTAL = "etl_decode_admission_grants_total"
ETL_DECODE_ADMISSION_STARVATION_GRANTS_TOTAL = \
    "etl_decode_admission_starvation_grants_total"
ETL_DECODE_ADMISSION_BYPASS_GRANTS_TOTAL = \
    "etl_decode_admission_bypass_grants_total"
ETL_DECODE_ADMISSION_WAITERS = "etl_decode_admission_waiters"
ETL_DECODE_ADMISSION_IN_FLIGHT = "etl_decode_admission_in_flight"
ETL_DECODE_ADMISSION_TENANTS = "etl_decode_admission_tenants"
# pending catalog-inlined bytes per lake table (reference
# ETL_DUCKLAKE_TABLE_ACTIVE_INLINED_DATA_BYTES, ducklake/inline_size.rs)
ETL_LAKE_INLINED_DATA_BYTES = "etl_lake_inlined_data_bytes"
# Snowpipe channel reopened after a stale continuation token (reference
# ETL_SNOWFLAKE_CHANNEL_RECOVERIES_TOTAL, snowflake/metrics.rs)
ETL_SNOWPIPE_CHANNEL_RECOVERIES_TOTAL = \
    "etl_snowpipe_channel_recoveries_total"
# horizontal scale-out (etl_tpu/sharding): the authoritative topology
# (shard count + epoch), tables-per-shard (labeled per shard — skew means
# the HRW map and the table population disagree), rebalance timings +
# moved-table counts from the two-phase coordinator, and write refusals
# from the shard fence (labeled by reason: not_owned = a routing bug or a
# racing rebalance, epoch_stale = a pod outliving its topology — both
# should be zero in steady state and NONZERO refusals are the fence
# doing its job during a rollout)
ETL_SHARD_COUNT = "etl_shard_count"
ETL_SHARD_EPOCH = "etl_shard_epoch"
ETL_SHARD_TABLES = "etl_shard_tables"
ETL_SHARD_REBALANCE_DURATION_SECONDS = \
    "etl_shard_rebalance_duration_seconds"
ETL_SHARD_REBALANCE_MOVED_TABLES_TOTAL = \
    "etl_shard_rebalance_moved_tables_total"
ETL_SHARD_WRITE_REFUSALS_TOTAL = "etl_shard_write_refusals_total"
# exactly-once delivery (destinations/base.py transactional seam +
# runtime recovery): rows a transactional sink dropped as coordinate
# duplicates of a blind re-stream (label mode=stream|replay), restart
# recoveries that successfully read the sink's high-water mark vs fell
# back to the legacy blind re-stream (the loud-warning degradation,
# labeled by reason: error = typed sink failure after retries, timeout =
# the op bound cut it off), and the high coordinate of the last acked
# transactional commit range — the operator-visible high-water mark
ETL_EXACTLY_ONCE_DEDUP_ROWS_TOTAL = "etl_exactly_once_dedup_rows_total"
ETL_EXACTLY_ONCE_RECOVERIES_TOTAL = "etl_exactly_once_recoveries_total"
ETL_EXACTLY_ONCE_RECOVERY_FALLBACKS_TOTAL = \
    "etl_exactly_once_recovery_fallbacks_total"
ETL_EXACTLY_ONCE_HIGH_WATER_LSN = "etl_exactly_once_high_water_lsn"
# chaos subsystem (etl_tpu/chaos): fault firings per site, per-scenario
# pass/fail, and how long crash→restart recovery took until the workload
# fully re-delivered
ETL_CHAOS_INJECTED_FAULTS_TOTAL = "etl_chaos_injected_faults_total"
ETL_CHAOS_SCENARIOS_TOTAL = "etl_chaos_scenarios_total"
ETL_CHAOS_RECOVERY_DURATION_SECONDS = "etl_chaos_recovery_duration_seconds"
# decode pipeline degraded a batch to the host oracle after a (simulated
# or real) device allocation failure — the OOM-resilience path
ETL_DECODE_DEVICE_OOM_FALLBACKS_TOTAL = \
    "etl_decode_device_oom_fallbacks_total"
# a nonblocking decoder found its host-path program uncompiled and kicked
# the compile to a background thread, decoding the triggering batches on
# the oracle meanwhile (wide schemas compile for tens of seconds — inline
# that would wedge the apply loop into a stall-restart cycle)
ETL_DECODE_BACKGROUND_COMPILES_TOTAL = \
    "etl_decode_background_compiles_total"
# device-resident wire egress (ops/egress.py): batches whose dispatch
# attached device-rendered wire buffers, and destination writes that
# consumed them via the fast assembly path vs fell back to the host
# columnar encoders (label path=device|host)
ETL_EGRESS_DEVICE_BATCHES_TOTAL = "etl_egress_device_batches_total"
ETL_EGRESS_WRITES_TOTAL = "etl_egress_writes_total"
# program store (ops/program_store.py): cache hits by layer (memory =
# the in-process _SHARED_FN_CACHE, disk = a deserialized AOT
# executable), misses by reason (absent = never compiled on this
# version tag, invalid = corrupt/stale file deleted and rebuilt), disk
# load latency, and ACTUAL XLA program builds — the counter the
# warm-restart gates pin at zero (bench.py --coldstart, the chaos
# crash_restart_warm_programs scenario). The canonical-layout gauge is
# the number of distinct padded layouts live in this process: its ratio
# to tables-seen is the compile sharing canonicalization buys.
ETL_COMPILE_CACHE_HITS_TOTAL = "etl_compile_cache_hits_total"
ETL_COMPILE_CACHE_MISSES_TOTAL = "etl_compile_cache_misses_total"
ETL_COMPILE_CACHE_LOAD_SECONDS = "etl_compile_cache_load_seconds"
ETL_PROGRAMS_COMPILED_TOTAL = "etl_programs_compiled_total"
ETL_DECODE_CANONICAL_LAYOUTS = "etl_decode_canonical_layouts"
# closed-loop autoscaling (etl_tpu/autoscale): per-shard replication lag
# as a FIRST-CLASS gauge, sampled on the apply loop's existing
# status-update cadence — the same received−durable number the admission
# weight reads, so the autoscale collector and a human operator stare at
# the identical series (no ad-hoc lag.py query drift). The decision
# metrics mirror the policy's outputs: the last raw rate-model target,
# the aggregate backlog and estimated per-shard drain capacity it was
# computed from, applied decisions by direction (up/down), holds by
# reason (cooldown/band/in_flight/unhealthy), and whether an actuation
# (two-phase rebalance + orchestrator roll) is currently in flight.
ETL_SLOT_LAG_BYTES = "etl_slot_lag_bytes"
ETL_SHARD_DELIVERED_EVENTS = "etl_shard_delivered_events"
ETL_AUTOSCALE_TARGET_SHARDS = "etl_autoscale_target_shards"
ETL_AUTOSCALE_BACKLOG_BYTES = "etl_autoscale_backlog_bytes"
ETL_AUTOSCALE_CAPACITY_BYTES_PER_S = "etl_autoscale_capacity_bytes_per_s"
ETL_AUTOSCALE_DECISIONS_TOTAL = "etl_autoscale_decisions_total"
ETL_AUTOSCALE_HOLDS_TOTAL = "etl_autoscale_holds_total"
ETL_AUTOSCALE_DECISION_IN_FLIGHT = "etl_autoscale_decision_in_flight"
ETL_AUTOSCALE_RESUMES_TOTAL = "etl_autoscale_resumes_total"
# fleet reconciler (etl_tpu/fleet): desired-vs-observed pipeline counts
# and total desired shards per tick, the spec version currently being
# reconciled, applied actuations by verb (create/resize/delete), ticks
# that held a pipeline because a pending journal record was in flight,
# successor resumes by mode (settle = actuation had landed, journal-only;
# redrive = crash before actuation, verb re-driven; abort = spec moved
# on), and a 0/1 converged flag the /fleet endpoint surfaces
ETL_FLEET_PIPELINES_DESIRED = "etl_fleet_pipelines_desired"
ETL_FLEET_PIPELINES_OBSERVED = "etl_fleet_pipelines_observed"
ETL_FLEET_SHARDS_DESIRED = "etl_fleet_shards_desired"
ETL_FLEET_SPEC_VERSION = "etl_fleet_spec_version"
ETL_FLEET_RECONCILE_ACTIONS_TOTAL = "etl_fleet_reconcile_actions_total"
ETL_FLEET_RECONCILE_HOLDS_TOTAL = "etl_fleet_reconcile_holds_total"
ETL_FLEET_RESUMES_TOTAL = "etl_fleet_resumes_total"
ETL_FLEET_CONVERGED = "etl_fleet_converged"
# supervision subsystem (etl_tpu/supervision): watchdog detections by
# kind+component, cancel-and-restart escalations, the pipeline health
# state (0 healthy / 1 degraded / 2 faulted), the oldest heartbeat age
# observed in the last sweep, per-destination breaker state (0 closed /
# 1 half-open / 2 open) + open transitions, and destination calls the
# per-op timeout bound had to cut off
# windowed destination-ack pipeline (runtime/ack_window.py): destination
# writes in flight right now (labeled {"path": "apply"|"copy"} — the
# apply loop's bounded write window vs the per-partition copy window),
# dispatch→durable latency per ack, and the overlap evidence: busy =
# seconds with ≥1 write in flight, overlap = seconds with ≥2 (the time
# the window actually hid ack latency behind later writes). The ratio
# gauge is overlap/busy cumulatively — 0 at window=1 by construction,
# approaching (K-1)/K when a K-deep window stays saturated.
ETL_DESTINATION_ACK_IN_FLIGHT = "etl_destination_ack_in_flight"
ETL_DESTINATION_ACK_LATENCY_SECONDS = "etl_destination_ack_latency_seconds"
ETL_DESTINATION_ACK_BUSY_SECONDS_TOTAL = \
    "etl_destination_ack_busy_seconds_total"
ETL_DESTINATION_ACK_OVERLAP_SECONDS_TOTAL = \
    "etl_destination_ack_overlap_seconds_total"
ETL_DESTINATION_ACK_OVERLAP_RATIO = "etl_destination_ack_overlap_ratio"
# poison-pill isolation + dead-letter store (runtime/poison.py,
# docs/dead-letter.md): isolations run (one per poisoned flush),
# bisection probe writes (the O(log batch) isolation cost — bounded by
# the chaos invariant), rows appended to the DLQ by reason (poison =
# bisected to a poison row; quarantine = parked because the table is
# quarantined), events parked, replay/discard operator actions, and the
# live quarantined-table count
ETL_POISON_ISOLATIONS_TOTAL = "etl_poison_isolations_total"
ETL_POISON_BISECTION_WRITES_TOTAL = "etl_poison_bisection_writes_total"
ETL_DLQ_ENTRIES_TOTAL = "etl_dlq_entries_total"
ETL_DLQ_REPLAYED_TOTAL = "etl_dlq_replayed_total"
ETL_DLQ_DISCARDED_TOTAL = "etl_dlq_discarded_total"
ETL_QUARANTINED_TABLES = "etl_quarantined_tables"
ETL_QUARANTINE_PARKED_EVENTS_TOTAL = "etl_quarantine_parked_events_total"
ETL_SUPERVISION_EVENTS_TOTAL = "etl_supervision_events_total"
ETL_SUPERVISION_RESTARTS_TOTAL = "etl_supervision_restarts_total"
ETL_PIPELINE_HEALTH_STATE = "etl_pipeline_health_state"
ETL_HEARTBEAT_MAX_AGE_SECONDS = "etl_heartbeat_max_age_seconds"
ETL_DESTINATION_BREAKER_STATE = "etl_destination_breaker_state"
ETL_DESTINATION_BREAKER_OPENS_TOTAL = "etl_destination_breaker_opens_total"
ETL_DESTINATION_OP_TIMEOUTS_TOTAL = "etl_destination_op_timeouts_total"

# label keys
LABEL_PIPELINE_ID = "pipeline_id"
LABEL_TABLE = "table"
LABEL_WORKER_TYPE = "worker_type"
LABEL_DESTINATION = "destination"

_HISTOGRAM_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0,
                      30.0, 60.0)

# byte-scale series use byte-scale buckets (the default set is seconds)
_BYTE_BUCKETS = (1 << 10, 16 << 10, 64 << 10, 256 << 10, 1 << 20, 4 << 20,
                 16 << 20, 64 << 20, 256 << 20, 1 << 30)
# decode stages run sub-millisecond on warm paths; the default second-scale
# buckets would collapse every observation into the first bucket
_FINE_TIME_BUCKETS = (0.0002, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
                      0.05, 0.1, 0.25, 1.0, 5.0)
# row counts of sealed runs: the device routing threshold (64) and the
# standard staging row buckets
_ROW_BUCKETS = (63, 256, 1024, 4096, 16384, 65536, 262144)
_BUCKETS_BY_NAME = {
    ETL_ASSEMBLER_RUN_ROWS: _ROW_BUCKETS,
    "etl_transaction_size_bytes": _BYTE_BUCKETS,
    ETL_DECODE_PACK_SECONDS: _FINE_TIME_BUCKETS,
    ETL_DECODE_DISPATCH_SECONDS: _FINE_TIME_BUCKETS,
    ETL_DECODE_FETCH_SECONDS: _FINE_TIME_BUCKETS,
    # admission waits are sub-millisecond when uncontended and only reach
    # the coarse buckets under real multi-tenant contention
    ETL_DECODE_ADMISSION_WAIT_SECONDS: _FINE_TIME_BUCKETS,
}

LabelSet = tuple[tuple[str, str], ...]


def _labels(labels: dict[str, str] | None) -> LabelSet:
    return tuple(sorted((labels or {}).items()))


@dataclass
class _Histogram:
    bounds: tuple = _HISTOGRAM_BUCKETS
    buckets: list[int] = None  # type: ignore[assignment]
    total: float = 0.0
    count: int = 0

    def __post_init__(self):
        if self.buckets is None:
            self.buckets = [0] * (len(self.bounds) + 1)


class MetricsRegistry:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: dict[str, dict[LabelSet, float]] = defaultdict(dict)
        self._gauges: dict[str, dict[LabelSet, float]] = defaultdict(dict)
        self._histograms: dict[str, dict[LabelSet, _Histogram]] = \
            defaultdict(dict)

    def counter_inc(self, name: str, value: float = 1.0,
                    labels: dict[str, str] | None = None) -> None:
        key = _labels(labels)
        with self._lock:
            self._counters[name][key] = \
                self._counters[name].get(key, 0.0) + value

    def gauge_set(self, name: str, value: float,
                  labels: dict[str, str] | None = None) -> None:
        with self._lock:
            self._gauges[name][_labels(labels)] = value

    def histogram_observe(self, name: str, value: float,
                          labels: dict[str, str] | None = None) -> None:
        key = _labels(labels)
        with self._lock:
            h = self._histograms[name].setdefault(
                key, _Histogram(bounds=_BUCKETS_BY_NAME.get(
                    name, _HISTOGRAM_BUCKETS)))
            h.total += value
            h.count += 1
            for i, b in enumerate(h.bounds):
                if value <= b:
                    h.buckets[i] += 1
                    return
            h.buckets[-1] += 1

    def get_counter(self, name: str,
                    labels: dict[str, str] | None = None) -> float:
        return self._counters.get(name, {}).get(_labels(labels), 0.0)

    def get_gauge(self, name: str,
                  labels: dict[str, str] | None = None) -> float | None:
        return self._gauges.get(name, {}).get(_labels(labels))

    def get_histogram(self, name: str,
                      labels: dict[str, str] | None = None
                      ) -> tuple[int, float]:
        """(count, sum) of one histogram series; (0, 0.0) when unseen —
        benches and tests read stage totals without parsing exposition."""
        h = self._histograms.get(name, {}).get(_labels(labels))
        return (h.count, h.total) if h is not None else (0, 0.0)

    def get_histogram_buckets(self, name: str,
                              labels: dict[str, str] | None = None
                              ) -> dict[str, int]:
        """Per-bucket (not cumulative) counts of one histogram series,
        keyed "<=bound" and ">last bound"; {} when unseen."""
        with self._lock:
            h = self._histograms.get(name, {}).get(_labels(labels))
            if h is None:
                return {}
            names = [f"<={b}" for b in h.bounds] + [f">{h.bounds[-1]}"]
            return dict(zip(names, h.buckets))

    def sum_counter(self, name: str) -> float:
        """Sum of a counter over EVERY label set (per-tenant admission
        counters roll up to a fleet total without the caller enumerating
        tenant names)."""
        with self._lock:
            return sum(self._counters.get(name, {}).values())

    def sum_histogram(self, name: str) -> tuple[int, float]:
        """(count, sum) of a histogram summed over every label set."""
        count, total = 0, 0.0
        with self._lock:
            for h in self._histograms.get(name, {}).values():
                count += h.count
                total += h.total
        return count, total

    def render_prometheus(self) -> str:
        """Prometheus text exposition format 0.0.4."""
        out: list[str] = []

        def fmt_labels(key: LabelSet, extra: str = "") -> str:
            parts = [f'{k}="{v}"' for k, v in key]
            if extra:
                parts.append(extra)
            return "{" + ",".join(parts) + "}" if parts else ""

        with self._lock:
            for name in sorted(self._counters):
                out.append(f"# TYPE {name} counter")
                for key, v in sorted(self._counters[name].items()):
                    out.append(f"{name}{fmt_labels(key)} {v:g}")
            for name in sorted(self._gauges):
                out.append(f"# TYPE {name} gauge")
                for key, v in sorted(self._gauges[name].items()):
                    out.append(f"{name}{fmt_labels(key)} {v:g}")
            for name in sorted(self._histograms):
                out.append(f"# TYPE {name} histogram")
                for key, h in sorted(self._histograms[name].items()):
                    cum = 0
                    for i, b in enumerate(h.bounds):
                        cum += h.buckets[i]
                        le = f'le="{b:g}"'
                        out.append(
                            f"{name}_bucket{fmt_labels(key, le)} {cum}")
                    cum += h.buckets[-1]
                    inf = 'le="+Inf"'
                    out.append(
                        f"{name}_bucket{fmt_labels(key, inf)} {cum}")
                    out.append(f"{name}_sum{fmt_labels(key)} {h.total:g}")
                    out.append(f"{name}_count{fmt_labels(key)} {h.count}")
        return "\n".join(out) + "\n"


# process-global registry (reference: once-only Prometheus recorder)
registry = MetricsRegistry()


def publish_table_rows_constructed() -> int:
    """Mirror the models/table_row construction counter into the registry
    (the hot path pays a bare list-index increment, not a registry lock;
    scrapes and the bench gates read through here) and return it."""
    from ..models.table_row import rows_constructed

    n = rows_constructed()
    registry.gauge_set(ETL_TABLE_ROWS_CONSTRUCTED_TOTAL, n)
    return n
