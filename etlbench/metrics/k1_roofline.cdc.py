"""K1 (decode_pack_kernel, csrc/decode_pack.cu) against its byte bound, from the profiler's device time, %: CDC."""

from etlbench import readers


def read(w):
    return readers.roofline_pct(w, "cdc", "k1")
