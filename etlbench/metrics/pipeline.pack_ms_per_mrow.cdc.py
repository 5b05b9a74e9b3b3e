"""Host pack seconds (etl_decode_pack_seconds) a million routed rows, ms: ops/pipeline.py and ops/engine.py, CDC."""

from etlbench import readers


def read(w):
    return readers.stage_ms_per_mrow(w, "cdc", "pack")
