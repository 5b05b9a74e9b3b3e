"""K1 (decode_pack_kernel, csrc/decode_pack.cu) against its byte bound, from the profiler's device time, %: copy."""

from etlbench import readers


def read(w):
    return readers.roofline_pct(w, "copy", "k1")
