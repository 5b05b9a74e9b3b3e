"""Postgres server version constants and gates.

Reference parity: crates/etl-postgres/src/version.rs. Version numbers use
Postgres's internal format `MAJOR * 10000 + MINOR` (e.g. 150004 for 15.4);
officially supported majors are 14 through 18. A version of 0 means
"unknown" and fails every gate — the conservative fallback the reference
gets from `meets_version(None, _) == false`.

Copy of the reference's `etl_tpu/postgres/version.py`.
"""

from __future__ import annotations

POSTGRES_14 = 140000
POSTGRES_15 = 150000
POSTGRES_16 = 160000
POSTGRES_17 = 170000
POSTGRES_18 = 180000


def meets_version(server_version: int, required: int) -> bool:
    """True when a KNOWN server version meets `required` (unknown = 0 never
    does)."""
    return server_version > 0 and server_version >= required


def parse_server_version(raw: str) -> int:
    """'15.4' → 150004; '16beta1 (Debian...)' → 160000; junk → 0."""
    import re

    m = re.match(r"(\d+)(?:\.(\d+))?", raw.split()[0] if raw else "")
    if not m:
        return 0
    return int(m.group(1)) * 10000 + int(m.group(2) or 0)
