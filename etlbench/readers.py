"""What the per-layer metric readers (`metrics/<name>.py`) compute, from
the traced window's readings `w`:

- `w["kind"]`: the `SUFFIX` of the cell's kind of traffic ("cdc",
  "copy"), which a reader holds against its own name's suffix;
- `w["counters"]`: the port's counters and stage sums over the window
  (`system.counters`);
- `w["trace"]`: the profiler window reduced (`tracing.reduce_trace`);
- `w["launches"]`: the bytes and launches of K1 and K2c in the window;
- `w["window_s"]`: the traced window's length;
- `w["driver"]`: the traffic's driver (`kinds/<kind>.py`), for readers
  of the stream itself (a CDC driver's `commit_t` against the
  destination's arrival of each batch, `sink.cdc`).

Each returns None where the cell gives it nothing to read.
"""

from __future__ import annotations

from . import yardstick


def routed_rows(c: dict) -> float:
    return c["device_rows"] + c["host_rows"] + c["oracle_rows"]


def run_rows_mean(w: dict, kind: str):
    c = w["counters"]
    if w["kind"] != kind or c["run_rows_n"] <= 0:
        return None
    return c["run_rows_sum"] / c["run_rows_n"]


def stage_ms_per_mrow(w: dict, kind: str, stage: str):
    """A decode-pipeline stage's summed host seconds a million routed
    rows, in ms."""
    c = w["counters"]
    rows = routed_rows(c)
    if w["kind"] != kind or rows <= 0 or c[f"{stage}_n"] <= 0:
        return None
    return c[f"{stage}_sum"] / rows * 1e9


def device_row_pct(w: dict, kind: str):
    c = w["counters"]
    rows = routed_rows(c)
    if w["kind"] != kind or rows <= 0:
        return None
    return 100.0 * c["device_rows"] / rows


def rows_per_device_batch(w: dict, kind: str):
    c = w["counters"]
    if w["kind"] != kind or c["device_batches"] <= 0:
        return None
    return c["device_rows"] / c["device_batches"]


def roofline_pct(w: dict, kind: str, kernel: str):
    """The kernel's bytes over the card's peak, over its device time in
    the profiler, in percent."""
    if w["kind"] != kind:
        return None
    n_bytes = w["launches"][f"{kernel}_bytes"]
    seconds = w["trace"]["kernels"][kernel]["seconds"]
    return yardstick.roofline_pct(n_bytes, seconds)


def idle_pct(w: dict, kind: str):
    if w["kind"] != kind or w["window_s"] <= 0 or w["trace"]["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - w["trace"]["busy_s"] / w["window_s"])
