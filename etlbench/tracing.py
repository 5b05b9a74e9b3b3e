"""The traced run: host spans around the port's public entry points, the
bytes of each kernel launch, the profiler window, and its reduction.

Spans are `torch.profiler.record_function` ranges recorded by the
benchmark's own wrappers, installed for the traced window only, around
`ops.wal.stage_wal_batch`, `ops.staging.stage_copy_chunk`,
`DeviceDecoder.decode_async` and the pending decode's `result()` (and
the counting destination's writes, `destinations/counting.py`). A wrapper replaces the function wherever a
module of the port bound it by name, and is taken out after the window.

Kernel bytes come from each launch's own tensors, recorded around
`decode_kernel.prepare_decode_pack` (K1) and
`decode_kernel.prepare_filter_pack_compact` (K2c) and priced by
`yardstick.py`. Device time is read from the profiler's device events by
kernel name; busy time is the union of the device's intervals.
"""

from __future__ import annotations

import heapq
import sys
import time

from . import yardstick

SPAN_PREFIX = "etlbench/"
#: kernel name fragments → the kernel they belong to
KERNELS = {"k1": "decode_pack_kernel", "k2c": "filter_pack_compact"}


def span(name: str):
    """A host span in the trace."""
    import torch

    return torch.profiler.record_function(SPAN_PREFIX + name)


class Patches:
    """Replace callables for the traced window and put them back."""

    def __init__(self):
        self._undo: list = []

    def wrap(self, owner, attr: str, make) -> None:
        orig = getattr(owner, attr)
        new = make(orig)
        targets = [(owner, attr)]
        if isinstance(owner, type(sys)):  # a module function: every binding
            for mod in list(sys.modules.values()):
                name = getattr(mod, "__name__", "") or ""
                if name.startswith("etl_tpu_torch") and mod is not owner:
                    for k, v in list(vars(mod).items()):
                        if v is orig:
                            targets.append((mod, k))
        for o, k in targets:
            self._undo.append((o, k, getattr(o, k)))
            setattr(o, k, new)

    def undo(self) -> None:
        for o, k, v in reversed(self._undo):
            setattr(o, k, v)
        self._undo.clear()


def _spanned(name: str):
    def make(fn):
        def wrapper(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        wrapper.__wrapped__ = fn
        return wrapper
    return make


class Launches:
    """The bytes of every K1 and K2c launch made while installed: K1's are
    known at the launch; K2c's need its survivor count, read from the
    launch's output once the window has closed."""

    def __init__(self):
        self.k1_bytes = 0
        self.k1_launches = 0
        self.k2c: list = []  # (bytes before survivors, words, counts)

    def install(self, patches: Patches) -> None:
        from etl_tpu_torch.ops import decode_kernel

        def k1(prepare):
            def wrapper(bmat, lengths, specs, nibble, out=None, walk=None):
                launch = prepare(bmat, lengths, specs, nibble, out, walk)
                if bmat.device.type != "cuda":
                    return launch
                words = launch.outputs[0]
                n = yardstick.k1_bytes(bmat.nbytes, lengths.nbytes,
                                       words.shape[0], bmat.shape[0])

                def counted():
                    got = launch()
                    self.k1_bytes += n
                    self.k1_launches += 1
                    return got
                return counted
            return wrapper

        def k2c(prepare):
            def wrapper(bmat, lengths, row_flags, specs, nibble, pred,
                        walk=None, rpt=None):
                launch = prepare(bmat, lengths, row_flags, specs, nibble,
                                 pred, walk, rpt)
                if bmat.device.type != "cuda":
                    return launch

                def counted():
                    words, mask, counts = launch()
                    self.k2c.append((bmat.nbytes, lengths.nbytes,
                                     row_flags.nbytes, words.shape[0],
                                     bmat.shape[0], counts))
                    return words, mask, counts
                return counted
            return wrapper

        patches.wrap(decode_kernel, "prepare_decode_pack", k1)
        patches.wrap(decode_kernel, "prepare_filter_pack_compact", k2c)

    def k2c_bytes(self) -> int:
        return sum(yardstick.fused_bytes(bm, ln, fl, n_words, rows,
                                         int(counts[0].item()))
                   for bm, ln, fl, n_words, rows, counts in self.k2c)


def install_spans(patches: Patches) -> None:
    from etl_tpu_torch.ops import engine, staging, wal

    patches.wrap(wal, "stage_wal_batch", _spanned("wal.stage_wal_batch"))
    patches.wrap(staging, "stage_copy_chunk",
                 _spanned("staging.stage_copy_chunk"))
    patches.wrap(engine.DeviceDecoder, "decode_async",
                 _spanned("engine.decode_async"))
    patches.wrap(engine._PendingDecode, "result",
                 _spanned("engine.decode_result"))


class Window:
    """The profiler over the measured window (host spans and the card's
    activity), started and stopped by the caller."""

    def __init__(self, cuda: bool = True):
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)
        self._cuda = cuda
        self.window_s = 0.0
        self._t0 = 0.0

    def start(self) -> None:
        self._prof.__enter__()
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        import torch

        if self._cuda:
            torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self._t0
        self._prof.__exit__(None, None, None)

    def reduce(self) -> dict:
        """busy_s, per-kernel device seconds and launches, the top device
        ops, and the idle gaps by the host span open across them."""
        res = self._prof.profiler.kineto_results
        t0 = res.trace_start_ns()
        t1 = t0 + int(self.window_s * 1e9)
        device, spans = [], []
        for e in res.events():
            s, d, name = e.start_ns(), e.duration_ns(), e.name()
            if name.startswith(SPAN_PREFIX):
                # the host span, or its copy on the device's timeline
                if "CUDA" not in str(e.device_type()):
                    spans.append((s, s + d, name[len(SPAN_PREFIX):]))
            elif "CUDA" in str(e.device_type()):
                device.append((s, s + d, name))
        return reduce_trace(device, spans, t0, t1)


def reduce_trace(device: list, spans: list, t0: int, t1: int) -> dict:
    """The trace's readings from device intervals and host spans (ns):
    the union of device activity inside [t0, t1], seconds and launches by
    kernel, the ten device ops that took most time, and the idle time
    between device intervals attributed to the host spans open over it
    (`_attribute`)."""
    iv = sorted((max(s, t0), min(e, t1), n) for s, e, n in device
                if e > t0 and s < t1)
    busy, gaps = 0, []
    cur_s = cur_e = None
    for s, e, _ in iv:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
                gaps.append((cur_e, s))
            else:
                gaps.append((t0, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
        gaps.append((cur_e, t1))
    else:
        gaps.append((t0, t1))
    ops: dict = {}
    kernels = {k: [0.0, 0] for k in KERNELS}
    for s, e, n in iv:
        ops[n] = ops.get(n, 0.0) + (e - s) / 1e9
        for k, frag in KERNELS.items():
            if frag in n:
                kernels[k][0] += (e - s) / 1e9
                kernels[k][1] += 1
    idle = _attribute(gaps, spans)
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
    top_idle = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": busy / 1e9, "device_ops": [[k, v] for k, v in top],
            "idle_gaps": [[k, v] for k, v in top_idle],
            "kernels": {k: {"seconds": v[0], "launches": v[1]}
                        for k, v in kernels.items()}}


def _attribute(gaps: list, spans: list) -> dict:
    """Idle seconds by the host span open across them: each moment of a
    gap goes to the latest-started span open then, or to "no span". One
    sweep over the gaps and the spans in time order, the open spans in a
    heap by start."""
    idle: dict = {}
    spans = sorted(spans)
    bounds = sorted({t for g in gaps for t in g}
                    | {t for s, e, _ in spans for t in (s, e)})
    gaps = sorted(g for g in gaps if g[1] > g[0])
    open_: list = []  # (-start, end, name)
    k = gi = 0
    for a, b in zip(bounds, bounds[1:]):
        while gi < len(gaps) and gaps[gi][1] <= a:
            gi += 1
        if gi == len(gaps):
            break
        if not gaps[gi][0] <= a < gaps[gi][1]:
            continue
        while k < len(spans) and spans[k][0] <= a:
            heapq.heappush(open_, (-spans[k][0], spans[k][1], spans[k][2]))
            k += 1
        while open_ and open_[0][1] <= a:
            heapq.heappop(open_)
        owner = open_[0][2] if open_ else "no span"
        idle[owner] = idle.get(owner, 0.0) + (b - a) / 1e9
    return idle
