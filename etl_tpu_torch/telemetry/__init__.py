"""Telemetry: metrics registry, tracing init, egress accounting."""

from .egress import record_egress
from .metrics import MetricsRegistry, registry
from .tracing import init_tracing, set_error_hook
