"""Telemetry: metrics registry, egress accounting."""

from .egress import record_egress
from .metrics import MetricsRegistry, registry
