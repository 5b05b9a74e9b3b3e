"""Measured device break-even for decode routing.

Port of the reference's `etl_tpu/ops/autotune.py`. It measures, once per
process, the two quantities a routing threshold stands in for:

  - the card's round trip: wall time of a pageable host buffer's upload,
    a trivial op on the card and the fetch back, synchronised, at two
    payload sizes, solved as ``t(n) = fixed_s + n / bytes_per_s``;
  - the host route's decode rate, normalized per dense column, from a
    real decode of a synthetic 4-INT8-column staged batch through the
    host route (X1's plain version on CPU tensors: the path that competes
    for mid-size batches), and its per-call cost, from the same decode
    of a HOST_MIN_ROWS-row batch.

`DeviceDecoder` then solves, per schema, for the row count where the
device route starts winning:

    host_fixed_s + R / host_rows_per_s
        >=  fixed_s + R * bytes_per_row / bytes_per_s

No card → `measure()` returns None and decoders keep the static default;
the routing question is moot there because "device" and "host" are the
same backend.

Departure from the reference: its floor of 4,096 rows guards against a
probe run during a lucky window of a tunnel-attached TPU's link. The
port's floor is the decoder's DEVICE_MIN_ROWS, 64 rows (`_FLOOR_ROWS`),
for the reason the port set 64 in the first place: the card sits on the
local PCIe bus. The measurement decides above it.

Second departure: the reference's host route is a compiled XLA program
whose per-call cost it neglects (`host_fixed_s` 0 gives its formula
exactly). The port's is plain PyTorch on the CPU, which pays each op's
dispatch on every call, so its measured per-call cost enters the solve.
"""

from __future__ import annotations

import asyncio
import dataclasses
import logging
import threading
import time

import numpy as np

log = logging.getLogger("etl_tpu_torch.ops.autotune")

# probe payload sizes for the round-trip fit: far enough apart that the
# bandwidth term is observable over the fixed cost
_PROBE_SMALL = 256 * 1024
_PROBE_LARGE = 8 * 1024 * 1024
_PROBE_REPS = 3

# synthetic host-rate probe: 4 int64 columns × one mid-size bucket
_HOST_PROBE_ROWS = 16_384
_HOST_PROBE_COLS = 4
# the host route's per-call probe: the same columns at its smallest batch
# (DeviceDecoder.HOST_MIN_ROWS)
_HOST_FIXED_PROBE_ROWS = 64

# never route batches this small to the card, whatever the probe says
# (the reference's 4,096; see the module docstring)
_FLOOR_ROWS = 64


@dataclasses.dataclass(frozen=True)
class DeviceCostModel:
    """Per-process measurement of the decode routing trade."""

    fixed_s: float  # device upload + op + fetch fixed cost (seconds)
    bytes_per_s: float  # effective host↔device round-trip bandwidth
    host_col_rows_per_s: float  # host-route decode rate × dense columns
    backend: str
    host_fixed_s: float = 0.0  # host-route per-call cost (seconds)

    def device_min_rows(self, n_dense: int, bytes_per_row: float,
                        default: int) -> int:
        """Smallest row count where the device round trip beats the host
        route for a schema with `n_dense` device-parsed columns moving
        `bytes_per_row` over the link (upload + packed fetch)."""
        if n_dense <= 0:
            return default
        host_s_per_row = n_dense / self.host_col_rows_per_s
        link_s_per_row = bytes_per_row / self.bytes_per_s
        margin = host_s_per_row - link_s_per_row
        if margin <= 0:
            # the link cannot even stream the bytes as fast as the host
            # decodes: the device never wins on throughput alone, and
            # batches go at the static default
            return default
        want = int((self.fixed_s - self.host_fixed_s) / margin) + 1
        return max(_FLOOR_ROWS, want)


_MEASURED: "list[DeviceCostModel | None] | None" = None
# `measure()` runs on the event loop (a decoder built mid-stream) AND in
# prewarm's executor thread; the lock makes the probe single-flight
_MEASURE_LOCK = threading.Lock()


def _fit_round_trip(device) -> tuple[float, float]:
    """min-of-reps wall time of upload → `x + 1` → fetch at two sizes →
    solve t(n) = a + n/bw. Min, not mean: link noise is one-sided."""
    import torch

    def timed(n: int) -> float:
        buf = np.zeros(n, dtype=np.uint8)  # pageable, as a staged batch

        def once() -> None:
            (torch.from_numpy(buf).to(device) + 1).cpu()
            torch.cuda.synchronize(device)

        once()  # warm this size's allocations and transfer path
        best = float("inf")
        for _ in range(_PROBE_REPS):
            t0 = time.perf_counter()
            once()
            best = min(best, time.perf_counter() - t0)
        return best

    t_small, t_large = timed(_PROBE_SMALL), timed(_PROBE_LARGE)
    bw = (_PROBE_LARGE - _PROBE_SMALL) / max(t_large - t_small, 1e-9)
    fixed = max(t_small - _PROBE_SMALL / bw, 1e-6)
    return fixed, bw


def _probe_schema():
    from ..models import (ColumnSchema, Oid, ReplicatedTableSchema,
                          TableName, TableSchema)

    return ReplicatedTableSchema.with_all_columns(TableSchema(
        1, TableName("etl", "autotune_probe"),
        tuple(ColumnSchema(f"c{i}", Oid.INT8)
              for i in range(_HOST_PROBE_COLS))))


def _measure_host_route() -> tuple[float, float]:
    """The host route's per-call cost (seconds) and decode rate
    (column-rows/second; schemas scale it by their dense column count),
    from synthetic staged batches of `_HOST_FIXED_PROBE_ROWS` and
    `_HOST_PROBE_ROWS` rows."""
    from .engine import DeviceDecoder
    from .staging import stage_copy_chunk

    line = b"\t".join(str(1234567 + i).encode()
                      for i in range(_HOST_PROBE_COLS))
    # a decoder whose device route starts above the probe and whose host
    # route starts at one row: every probe batch takes the host route,
    # the same code a CUDA decoder runs there; telemetry=False keeps the
    # probe's decodes out of the routing counters
    dec = DeviceDecoder(_probe_schema(), device="cpu",
                        device_min_rows=1 << 30, host_min_rows=1,
                        telemetry=False)

    def timed(rows: int) -> float:
        staged = stage_copy_chunk((line + b"\n") * rows, _HOST_PROBE_COLS)
        dec.decode(staged)  # warm
        best = float("inf")
        for _ in range(_PROBE_REPS):
            t0 = time.perf_counter()
            dec.decode(staged)
            best = min(best, time.perf_counter() - t0)
        return best

    rate = _HOST_PROBE_ROWS * _HOST_PROBE_COLS / timed(_HOST_PROBE_ROWS)
    t_small = timed(_HOST_FIXED_PROBE_ROWS)
    fixed = max(t_small - _HOST_FIXED_PROBE_ROWS * _HOST_PROBE_COLS / rate,
                0.0)
    return fixed, rate


def measure(force: bool = False) -> DeviceCostModel | None:
    """Probe once per process (about a second); None when there is no
    card. Single-flight under `_MEASURE_LOCK`: safe to race from the
    loop and prewarm's executor thread. A probe that fails raises: a
    card that cannot move 8 MiB does not decode either."""
    global _MEASURED
    if _MEASURED is not None and not force:
        return _MEASURED[0]
    with _MEASURE_LOCK:
        if _MEASURED is not None and not force:
            return _MEASURED[0]
        import torch

        if not torch.cuda.is_available():
            _MEASURED = [None]
            return None
        device = torch.device("cuda", torch.cuda.current_device())
        fixed, bw = _fit_round_trip(device)
        host_fixed, host_rate = _measure_host_route()
        model = DeviceCostModel(fixed_s=fixed, bytes_per_s=bw,
                                host_col_rows_per_s=host_rate,
                                backend=torch.cuda.get_device_name(device),
                                host_fixed_s=host_fixed)
        log.info("device cost model: fixed=%.4fms bw=%.1fMB/s host=%.2fM "
                 "col-rows/s host_fixed=%.4fms (%s)", fixed * 1e3, bw / 1e6,
                 host_rate / 1e6, host_fixed * 1e3, model.backend)
        _MEASURED = [model]
        return model


async def prewarm() -> DeviceCostModel | None:
    """Measure from async code WITHOUT blocking the event loop.
    `Pipeline.start()` awaits this before spawning workers, so the
    per-process model is cached by the time a decoder is built on the
    loop."""
    if _MEASURED is not None:
        return _MEASURED[0]
    loop = asyncio.get_running_loop()
    return await loop.run_in_executor(None, measure)


def resolve_device_min_rows(n_dense: int, bytes_per_row: float,
                            default: int) -> int:
    """The measured routing threshold for one schema, or `default` when
    no measurement is possible."""
    model = measure()
    if model is None:
        return default
    return model.device_min_rows(n_dense, bytes_per_row, default)
