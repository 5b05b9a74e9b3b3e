"""Mean rows a sealed run (etl_assembler_run_rows) over the window: runtime/assembler.py, CDC."""

from etlbench import readers


def read(w):
    return readers.run_rows_mean(w, "cdc")
