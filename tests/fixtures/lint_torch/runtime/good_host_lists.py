# etl-lint fixture (PyTorch sinks): `.tolist()` and `.item()` of numpy
# host arrays in async code of a module that never imports torch — the
# receivers cannot be tensors, so the host-ambiguous sinks stay quiet.
# (no expectations: zero findings)
import numpy as np


async def survivors(mask):
    rows = np.flatnonzero(mask).tolist()
    return rows, np.int64(len(rows)).item()
