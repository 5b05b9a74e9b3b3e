"""Share of the traced window in which no operation ran on the card, from the profiler, %: copy."""

from etlbench import readers


def read(w):
    return readers.idle_pct(w, "copy")
