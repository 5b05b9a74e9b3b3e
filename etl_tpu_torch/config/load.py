"""Config loading: YAML base + environment overlay + APP_ env vars.

Reference parity: crates/etl-config/src/load.rs — a base YAML file plus an
environment-specific overlay (`base.yaml`, `{env}.yaml`), then `APP_`-
prefixed environment variables with `__` as the nesting separator
(`APP_PG_CONNECTION__HOST=db` → pg_connection.host), highest precedence.
`Environment` (dev/staging/prod) from `APP_ENVIRONMENT`.
Secrets are wrapped in `Secret` so accidental logging shows `[REDACTED]`
(reference SerializableSecretString, etl-config/src/secret.rs).

Copy of the reference's `etl_tpu/config/load.py`, with two departures.
A `poison` section builds its PoisonConfig (the reference's loader leaves
it a mapping, which fails `validate()` untyped).
`batch.batch_engine` takes the port's engines, `cpu` and `cuda`: the
reference's `tpu` is refused with a typed error that names `cuda`, never
aliased.
"""

from __future__ import annotations

import enum
import os
from pathlib import Path
from typing import Any

import yaml

from ..models.errors import ErrorKind, EtlError
from .pipeline import (BatchConfig, BatchEngine, InvalidatedSlotBehavior,
                       MemoryBackpressureConfig, PgConnectionConfig,
                       PipelineConfig, PoisonConfig, RetryConfig,
                       SupervisionConfig, TableSyncCopyConfig, TlsConfig)

ENV_PREFIX = "APP_"
ENV_SEPARATOR = "__"


class Environment(enum.Enum):
    DEV = "dev"
    STAGING = "staging"
    PROD = "prod"

    @classmethod
    def current(cls) -> "Environment":
        raw = os.environ.get(f"{ENV_PREFIX}ENVIRONMENT", "dev").lower()
        try:
            return cls(raw)
        except ValueError:
            raise EtlError(ErrorKind.CONFIG_INVALID,
                           f"unknown environment {raw!r}")


class Secret(str):
    """A string that redacts itself in repr/str contexts used for logging."""

    def __repr__(self) -> str:
        return "Secret('[REDACTED]')"

    def expose(self) -> str:
        return str.__str__(self)


def _deep_merge(base: dict, overlay: dict) -> dict:
    out = dict(base)
    for k, v in overlay.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def _coerce(value: str) -> Any:
    low = value.lower()
    if low in ("true", "false"):
        return low == "true"
    try:
        return int(value)
    except ValueError:
        pass
    try:
        return float(value)
    except ValueError:
        pass
    return value


def env_overlay(environ: dict[str, str] | None = None) -> dict:
    """APP_A__B=c → {"a": {"b": c}} (reference load.rs env source)."""
    environ = environ if environ is not None else dict(os.environ)
    out: dict = {}
    for key, value in environ.items():
        if not key.startswith(ENV_PREFIX) or key == f"{ENV_PREFIX}ENVIRONMENT":
            continue
        path = key[len(ENV_PREFIX):].lower().split(ENV_SEPARATOR)
        node = out
        for part in path[:-1]:
            nxt = node.setdefault(part, {})
            if not isinstance(nxt, dict):
                raise EtlError(
                    ErrorKind.CONFIG_INVALID,
                    f"conflicting env vars: {key} nests under a scalar "
                    f"prefix {ENV_PREFIX}{part.upper()}")
            node = nxt
        if isinstance(node.get(path[-1]), dict):
            raise EtlError(ErrorKind.CONFIG_INVALID,
                           f"conflicting env vars: {key} is a scalar but "
                           f"nested keys exist under it")
        node[path[-1]] = _coerce(value)
    return out


def _batch_engine(value: Any) -> BatchEngine:
    try:
        return BatchEngine(value)
    except ValueError:
        raise EtlError(
            ErrorKind.CONFIG_INVALID,
            f"batch.batch_engine {value!r}: this package's engines are "
            f"{sorted(e.value for e in BatchEngine)}; the device engine is "
            "'cuda'")


def load_config_dict(config_dir: str | Path | None = None,
                     environment: Environment | None = None,
                     environ: dict[str, str] | None = None) -> dict:
    environment = environment or Environment.current()
    merged: dict = {}
    if config_dir is not None:
        d = Path(config_dir)
        for name in ("base.yaml", f"{environment.value}.yaml"):
            p = d / name
            if p.exists():
                try:
                    doc = yaml.safe_load(p.read_text()) or {}
                except yaml.YAMLError as e:
                    raise EtlError(ErrorKind.CONFIG_INVALID,
                                   f"{p}: {e}")
                if not isinstance(doc, dict):
                    raise EtlError(ErrorKind.CONFIG_INVALID,
                                   f"{p}: top level must be a mapping")
                merged = _deep_merge(merged, doc)
    merged = _deep_merge(merged, env_overlay(environ))
    return merged


def _build(cls, doc: dict, **converters):
    import dataclasses

    known = {f.name for f in dataclasses.fields(cls)}
    unknown = set(doc) - known
    if unknown:
        raise EtlError(ErrorKind.CONFIG_INVALID,
                       f"{cls.__name__}: unknown keys {sorted(unknown)}")
    kwargs = {}
    for k, v in doc.items():
        conv = converters.get(k)
        kwargs[k] = conv(v) if conv else v
    return cls(**kwargs)


def pipeline_config_from_dict(doc: dict) -> PipelineConfig:
    try:
        cfg = _build(
            PipelineConfig, doc,
            pg_connection=lambda d: _build(
                PgConnectionConfig, d,
                password=lambda s: Secret(s) if s is not None else None,
                tls=lambda t: _build(TlsConfig, t)),
            batch=lambda d: _build(BatchConfig, d,
                                   batch_engine=_batch_engine),
            backpressure=lambda d: _build(MemoryBackpressureConfig, d),
            table_sync_copy=lambda d: _build(TableSyncCopyConfig, d),
            apply_retry=lambda d: _build(RetryConfig, d),
            table_retry=lambda d: _build(RetryConfig, d),
            supervision=lambda d: _build(SupervisionConfig, d),
            poison=lambda d: _build(PoisonConfig, d),
            invalidated_slot_behavior=InvalidatedSlotBehavior,
        )
    except (TypeError, ValueError) as e:
        raise EtlError(ErrorKind.CONFIG_INVALID, str(e))
    cfg.validate()
    return cfg


def load_pipeline_config(config_dir: str | Path | None = None,
                         environment: Environment | None = None,
                         environ: dict[str, str] | None = None
                         ) -> PipelineConfig:
    return pipeline_config_from_dict(
        load_config_dict(config_dir, environment, environ))
