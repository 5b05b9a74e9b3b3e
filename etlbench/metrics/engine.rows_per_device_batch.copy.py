"""Device-routed rows a device-routed batch (runtime/copy.py partitions, ops/engine.py): copy."""

from etlbench import readers


def read(w):
    return readers.rows_per_device_batch(w, "copy")
