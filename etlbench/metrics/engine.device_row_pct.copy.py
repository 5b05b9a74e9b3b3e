"""Share of routed rows the engine sent to the device route (ops/engine.py, ops/autotune.py), %: copy."""

from etlbench import readers


def read(w):
    return readers.device_row_pct(w, "copy")
