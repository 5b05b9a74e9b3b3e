"""Structured logging / tracing initialization.

Reference parity: `init_tracing` (crates/etl-telemetry/src/tracing.rs:272)
— JSON logs in production, pretty in development, with global
project-ref/pipeline-id fields on every record (tracing.rs:95-117). Sentry
capture is represented by an optional error-callback hook (no egress in
this environment).

Copy of the reference's `etl_tpu/telemetry/tracing.py`.
"""

from __future__ import annotations

import json
import logging
import sys
import time
from typing import Callable


class JsonFormatter(logging.Formatter):
    def __init__(self, static_fields: dict[str, str]):
        super().__init__()
        self.static_fields = static_fields

    def format(self, record: logging.LogRecord) -> str:
        doc = {
            "ts": time.strftime("%Y-%m-%dT%H:%M:%S",
                                time.gmtime(record.created))
            + f".{int(record.msecs):03d}Z",
            "level": record.levelname,
            "target": record.name,
            "message": record.getMessage(),
            **self.static_fields,
        }
        if record.exc_info and record.exc_info[0] is not None:
            doc["exception"] = self.formatException(record.exc_info)
        extra = getattr(record, "fields", None)
        if isinstance(extra, dict):
            doc.update(extra)
        return json.dumps(doc)


class PrettyFormatter(logging.Formatter):
    def __init__(self, static_fields: dict[str, str]):
        suffix = " ".join(f"{k}={v}" for k, v in static_fields.items())
        fmt = "%(asctime)s %(levelname)-5s %(name)s: %(message)s"
        if suffix:
            fmt += f"  [{suffix}]"
        super().__init__(fmt)


_error_hook: Callable[[logging.LogRecord], None] | None = None


class _HookHandler(logging.Handler):
    def emit(self, record: logging.LogRecord) -> None:
        if _error_hook is not None and record.levelno >= logging.ERROR:
            _error_hook(record)


def set_error_hook(hook: Callable[[logging.LogRecord], None]) -> None:
    """Error capture hook (the Sentry-layer analogue). Self-installing:
    attaches the dispatch handler to the root logger if init_tracing has
    not run yet."""
    global _error_hook
    _error_hook = hook
    root = logging.getLogger()
    if not any(isinstance(h, _HookHandler) for h in root.handlers):
        root.addHandler(_HookHandler())


def init_tracing(*, environment: str = "dev", project_ref: str = "",
                 pipeline_id: int | None = None,
                 level: int = logging.INFO) -> None:
    static: dict[str, str] = {}
    if project_ref:
        static["project"] = project_ref
    if pipeline_id is not None:
        static["pipeline_id"] = str(pipeline_id)
    handler = logging.StreamHandler(sys.stderr)
    if environment in ("prod", "staging"):
        handler.setFormatter(JsonFormatter(static))
    else:
        handler.setFormatter(PrettyFormatter(static))
    root = logging.getLogger()
    root.handlers = [handler, _HookHandler()]
    root.setLevel(level)
