"""Egress/billing accounting.

Reference parity: `etl_processed_bytes` structured log on destination ack
(crates/etl/src/egress.rs:1-20) with payload accounting via
StreamingPayloadMetadata/TableCopyPayloadMetadata
(source_payload_metadata.rs). Emits both a metric counter and a structured
log record so billing pipelines can consume either.

Copy of the reference's `etl_tpu/telemetry/egress.py`.
"""

from __future__ import annotations

import logging

from .metrics import (ETL_PROCESSED_BYTES_TOTAL, LABEL_DESTINATION,
                      LABEL_PIPELINE_ID, registry)

logger = logging.getLogger("etl_tpu_torch.egress")


def record_egress(*, pipeline_id: int, destination: str, bytes_processed: int,
                  kind: str) -> None:
    """kind: 'table_copy' | 'streaming'. Called on durable destination acks."""
    registry.counter_inc(ETL_PROCESSED_BYTES_TOTAL, bytes_processed, {
        LABEL_PIPELINE_ID: str(pipeline_id),
        LABEL_DESTINATION: destination,
    })
    logger.info("etl_processed_bytes", extra={"fields": {
        "pipeline_id": pipeline_id, "destination": destination,
        "bytes": bytes_processed, "kind": kind}})
