"""Property-test harness: random typed values with seed replay.

Reference parity: the wall-clock-budgeted property runner with seed replay
(crates/etl/src/test_utils/property.rs:59-96) and the value-roundtrip
differential suite (tests/value_roundtrip.rs) where Postgres renders values
and the production codec parses them back. Without a Postgres in this
environment the renderers below play the oracle's rendering side: they
format values exactly as `COPY TO`/pgoutput text output does; the
differential property is CPU-decode ≡ device-decode ≡ original value.

Copy of the reference's `etl_tpu/testing/property.py` over the port's own
`models.pgtypes.Oid`: the same seed draws the same text from both
(tests/test_torch_property_and_lag.py holds them to that).
"""

from __future__ import annotations

import datetime as dt
import random
import time
import uuid
from dataclasses import dataclass
from typing import Callable

from ..models.pgtypes import Oid


@dataclass
class GeneratedValue:
    oid: int
    text: str | None  # Postgres text rendering (None = NULL)


def _r_int(rng: random.Random, lo: int, hi: int) -> str:
    return str(rng.randint(lo, hi))


def _r_float8(rng: random.Random) -> str:
    c = rng.random()
    if c < 0.05:
        return rng.choice(["NaN", "Infinity", "-Infinity", "0"])
    if c < 0.5:
        return repr(rng.uniform(-1e6, 1e6))  # shortest roundtrip (17 sig)
    return f"{rng.uniform(-1e9, 1e9):.6f}"


def _r_numeric(rng: random.Random) -> str:
    c = rng.random()
    if c < 0.05:
        return "NaN"
    digits = rng.randint(1, 30)
    scale = rng.randint(0, min(10, digits))
    n = rng.randint(0, 10**digits - 1)
    s = str(n).rjust(scale + 1, "0")
    out = s[:-scale] + "." + s[-scale:] if scale else s
    return ("-" if rng.random() < 0.5 else "") + out


def _r_text(rng: random.Random) -> str:
    alphabet = ("abc xyz 123 äöü 日本語 emoji🎉 quote'dq\" comma, "
                "newline\ntab\tbackslash\\ ")
    n = rng.randint(0, 40)
    return "".join(rng.choice(alphabet) for _ in range(n))


def _r_date(rng: random.Random) -> str:
    d = dt.date(1, 1, 1) + dt.timedelta(days=rng.randint(0, 3_650_000))
    return d.isoformat()


def _r_time(rng: random.Random) -> str:
    t = dt.time(rng.randint(0, 23), rng.randint(0, 59), rng.randint(0, 59),
                rng.choice([0, rng.randint(0, 999_999)]))
    s = t.isoformat()
    return s


def _r_timestamp(rng: random.Random) -> str:
    return f"{_r_date(rng)} {_r_time(rng)}"


def _r_timestamptz(rng: random.Random) -> str:
    off_h = rng.randint(-12, 14)
    off = f"{'+' if off_h >= 0 else '-'}{abs(off_h):02d}"
    if rng.random() < 0.3:
        off += f":{rng.choice([0, 30, 45]):02d}"
    # clamp away from datetime range edges so UTC conversion stays valid
    d = dt.date(1000, 1, 1) + dt.timedelta(days=rng.randint(0, 2_900_000))
    return f"{d.isoformat()} {_r_time(rng)}{off}"


def _r_bytea(rng: random.Random) -> str:
    return "\\x" + bytes(rng.randint(0, 255)
                         for _ in range(rng.randint(0, 32))).hex()


def _r_uuid(rng: random.Random) -> str:
    return str(uuid.UUID(int=rng.getrandbits(128)))


def _r_json(rng: random.Random) -> str:
    import json

    def val(depth: int):
        c = rng.random()
        if depth > 2 or c < 0.3:
            return rng.choice([None, True, False, rng.randint(-1000, 1000),
                               "str"])
        if c < 0.6:
            return [val(depth + 1) for _ in range(rng.randint(0, 3))]
        return {f"k{i}": val(depth + 1) for i in range(rng.randint(0, 3))}

    return json.dumps(val(0))


def _r_int_array(rng: random.Random) -> str:
    items = [rng.choice(["NULL", str(rng.randint(-10**6, 10**6))])
             for _ in range(rng.randint(0, 8))]
    return "{" + ",".join(items) + "}"


GENERATORS: dict[int, Callable[[random.Random], str]] = {
    Oid.BOOL: lambda r: r.choice(["t", "f"]),
    Oid.INT2: lambda r: _r_int(r, -(2**15), 2**15 - 1),
    Oid.INT4: lambda r: _r_int(r, -(2**31), 2**31 - 1),
    Oid.INT8: lambda r: _r_int(r, -(2**63), 2**63 - 1),
    Oid.FLOAT8: _r_float8,
    Oid.FLOAT4: lambda r: f"{r.uniform(-1e6, 1e6):.4f}",
    Oid.NUMERIC: _r_numeric,
    Oid.TEXT: _r_text,
    Oid.DATE: _r_date,
    Oid.TIME: _r_time,
    Oid.TIMESTAMP: _r_timestamp,
    Oid.TIMESTAMPTZ: _r_timestamptz,
    Oid.BYTEA: _r_bytea,
    Oid.UUID: _r_uuid,
    Oid.JSONB: _r_json,
    Oid.INT4_ARRAY: _r_int_array,
}


def generate_value(rng: random.Random, oid: int,
                   null_rate: float = 0.1) -> GeneratedValue:
    if rng.random() < null_rate:
        return GeneratedValue(oid, None)
    return GeneratedValue(oid, GENERATORS[oid](rng))


class PropertyRunner:
    """Wall-clock-budgeted property loop with seed replay (property.rs)."""

    def __init__(self, budget_s: float = 3.0, seed: int | None = None):
        self.budget_s = budget_s
        self.base_seed = seed if seed is not None \
            else random.SystemRandom().randint(0, 2**32)
        self.cases_run = 0

    def run(self, case: Callable[[random.Random], None]) -> None:
        deadline = time.monotonic() + self.budget_s
        i = 0
        while time.monotonic() < deadline:
            seed = (self.base_seed + i) & 0xFFFFFFFF
            rng = random.Random(seed)
            try:
                case(rng)
            except BaseException as e:
                raise AssertionError(
                    f"property failed at seed {seed} (replay with "
                    f"PropertyRunner(seed={seed}))") from e
            i += 1
        self.cases_run = i
