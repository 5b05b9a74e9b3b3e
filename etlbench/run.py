"""The benchmark of etl_tpu_torch: one run of one cell.

    python -m etlbench.run --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout that holds BENCHMARK.json. The run makes
every input from the seed, starts the port's Pipeline on the card, warms
it up off the clock, measures for S seconds, checks what the timed path
delivered against the plain reference, and prints one JSON line last:
`correct`, `attempted`, `failed`, `metrics`, `device` (and `breakdown`
with `--trace 1`), and under `checks`, last, each number compared with
its limit; the same numbers close its standard error. With `--trace 0`
the metrics are the cell's end-to-end metrics, with `--trace 1` its
per-layer metrics, read from the profiler's window and the port's
counters.

It exits non-zero and prints no result where there is no CUDA card, or
fewer than the cell asks for, or where JAX or the JAX package is loaded
once the window has closed. `--control 1` puts the plain reference,
computed one step below the stated precision, in the program's place in
the check: such a run has to come out not correct.
"""

from __future__ import annotations

import argparse
import asyncio
import gc
import json
import os
import sys
import time

FORBIDDEN = ("jax", "jaxlib", "flax", "etl_tpu")


def process_age_s() -> float:
    """Seconds since this process started (Linux `/proc`)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


class HostWatch:
    """What the host did in the window, for the run's `detail`: seconds
    of garbage collection and full collections in this process, and the
    process's CPU seconds."""

    def __init__(self):
        self.gc_s, self.gc_full, self._t = 0.0, 0, None
        self._on = False
        gc.callbacks.append(self._gc)

    def _gc(self, phase, info):
        if not self._on:
            return
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.gc_s += time.perf_counter() - self._t
            self.gc_full += info["generation"] == 2

    def start(self) -> None:
        self._on = True
        self._cpu0 = time.process_time()

    def stop(self) -> dict:
        self._on = False
        gc.callbacks.remove(self._gc)
        return {"gc_s": self.gc_s, "gc_full": self.gc_full,
                "cpu_s": time.process_time() - self._cpu0}


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (names compared whole: `etl_tpu_torch` is not `etl_tpu`)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


async def run_cell(cell, seed: int, seconds: float, trace: bool,
                   control: bool = False, device: str = "cuda",
                   scale: float = 1.0) -> dict:
    """Set up, measure and check one cell; returns the result's parts.
    `device="cpu"` and `scale` < 1 are for the CPU tests (the port's
    plain versions at a small size): such a result is never printed."""
    from . import check, spec, system, tracing, traffic

    span = tracing.span if trace else None
    drv = traffic.driver(cell, seed, device, scale, span)
    await drv.setup()
    # what set-up made (the inputs, the source's rows) lives to the end
    # of the run: no collection in the window walks it
    gc.freeze()
    watch = HostWatch()
    c0 = system.counters()
    patches = launches = window = None
    if trace:
        patches, launches = tracing.Patches(), tracing.Launches()
        tracing.install_spans(patches)
        launches.install(patches)
        window = tracing.Window(cuda=device == "cuda")
        window.start()
    setup_s = process_age_s()
    watch.start()
    t0 = time.perf_counter()
    m0 = drv.mark()
    await asyncio.sleep(seconds)
    m1 = drv.mark()
    t1 = time.perf_counter()
    host = watch.stop()
    if trace:
        window.stop()
        patches.undo()
    c1 = system.counters()
    rates = drv.rate(m0, m1, t1 - t0)
    await drv.close()
    t_closed = time.perf_counter()
    out: dict = {"device": {"platform": "gpu" if device == "cuda" else
                            "cpu", "count": cell.chips}}
    if device == "cuda":
        import torch

        out["device"]["kind"] = torch.cuda.get_device_name(0)
        out["device"]["memory_peak_bytes"] = \
            max(torch.cuda.max_memory_allocated(d)
                for d in range(cell.chips))
    if trace:
        reduced = window.reduce()
        w = {"kind": traffic.suffix(cell),
             "counters": system.delta(c0, c1), "trace": reduced,
             "window_s": window.window_s,
             "launches": {"k1_bytes": launches.k1_bytes,
                          "k1_launches": launches.k1_launches,
                          "k2c_bytes": launches.k2c_bytes(),
                          "k2c_launches": len(launches.k2c)},
             "driver": drv}  # for readers of the stream (not printed)
        metrics = {}
        for m in cell.per_layer:
            v = spec.reader(m["name"])(w)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        out["device"]["busy_s"] = reduced["busy_s"]
        out["device"]["window_s"] = window.window_s
        out["breakdown"] = {"device_ops": reduced["device_ops"],
                            "idle_gaps": reduced["idle_gaps"]}
        out["readings"] = {k: v for k, v in w.items() if k != "driver"}
    else:
        values = dict(rates, setup_s=setup_s)
        metrics = {m["name"]: {"value": values[m["name"]],
                               "unit": m["unit"]}
                   for m in cell.end_to_end}
    out["metrics"] = metrics
    drv.release()
    gc.unfreeze()
    gc.collect()
    out["forbidden"] = forbidden_modules()
    numbers = drv.check(control)
    out["detail"] = numbers.pop("detail")
    out["detail"].update(host, close_s=t_closed - t1,
                         check_s=time.perf_counter() - t_closed)
    out["numbers"] = numbers
    out["correct"] = check.verdict(numbers)
    out["attempted"] = out["detail"]["due"]
    out["failed"] = sum(numbers.values())
    return out


def result_line(out: dict) -> dict:
    """The contract's last line: its keys in order, `checks` last."""
    from . import check

    line = {"correct": out["correct"], "attempted": out["attempted"],
            "failed": out["failed"], "metrics": out["metrics"],
            "device": out["device"]}
    if "breakdown" in out:
        line["breakdown"] = out["breakdown"]
    line["checks"] = check.report(out["numbers"])
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m etlbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from . import spec

    cell = spec.cell(args.workload)
    # the program's build cache stays in its fixed directory inside the
    # checkout (etl_tpu_torch/_build/); nothing from outside redirects it
    os.environ.pop("ETL_TPU_PROGRAM_CACHE_DIR", None)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"etlbench: {args.workload} needs {cell.chips} CUDA "
              f"device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = asyncio.run(run_cell(cell, args.seed, args.seconds,
                               bool(args.trace), bool(args.control)))
    if out["forbidden"]:
        print(f"etlbench: loaded after the window: {out['forbidden']}",
              file=sys.stderr)
        return 3
    print(json.dumps({"detail": out["detail"]}, default=str),
          file=sys.stderr)
    if "readings" in out:
        print(json.dumps({"readings": out["readings"]}, default=str),
              file=sys.stderr)
    line = result_line(out)
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0 if out["correct"] else 1


if __name__ == "__main__":
    rc = main()
    sys.stdout.flush()
    sys.stderr.flush()
    # every thread of the run has ended; skip tearing down gigabytes of
    # inputs and delivered batches object by object
    os._exit(rc)
