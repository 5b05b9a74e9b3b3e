"""Fetch and assemble seconds (etl_decode_fetch_seconds) a million routed rows, ms: copy."""

from etlbench import readers


def read(w):
    return readers.stage_ms_per_mrow(w, "copy", "fetch")
