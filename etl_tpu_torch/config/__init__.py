"""Typed configuration (copy of the reference's `etl_tpu/config`)."""

from .pipeline import (BatchConfig, BatchEngine, InvalidatedSlotBehavior,
                       MemoryBackpressureConfig, PgConnectionConfig,
                       PipelineConfig, PoisonConfig, RetryConfig,
                       SupervisionConfig, TableSyncCopyConfig, TlsConfig)
