"""Share of the traced window in which no operation ran on the card, from the profiler, %: CDC."""

from etlbench import readers


def read(w):
    return readers.idle_pct(w, "cdc")
