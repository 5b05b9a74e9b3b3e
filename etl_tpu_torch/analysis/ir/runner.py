"""IR-tier driver: launch every catalogued program, run the contracts.

How one program runs (`run_program`), in the engine's dispatch order:

  1. its synthetic input at its row capacity, seeded from its path and
     scope: the packed byte matrix and lengths the engine hands the
     kernel (`testing.field_matrix`; `testing.filter_case`, with row
     flags, for the fused filter), or, for the render, decoded words
     (`testing.egress_words`) — a pool of rows tiled to the capacity, in
     pinned host memory on the card (what the pack stage leaves);
  2. on the card, the kernel library and the descriptors the launch
     reads are made ready first (`load`, `_device_desc`, `_device_pred`:
     cached per layout, as the pipeline's prewarm readies them — the
     one upload a new layout pays, once, like the reference's compile);
  3. the dispatch window: device buffers, the wrapper's prepare
     (`prepare_decode_pack`, `prepare_filtered`, `prepare_render`), the
     non-blocking H2D copies, the launch, and the non-blocking D2H copies
     the engine's dispatch enqueues (words; keep mask and count under a
     filter; text and lengths for the render) into pinned buffers. On
     the card a @hot_loop program's window runs under
     `torch.cuda.set_sync_debug_mode("error")`, and every run records
     the `torch.distributed` collectives called;
  4. the consumer, as `_PendingDecode.result()`: the copies' event
     waited on and, under a filter, the second D2H of the count-sized
     slice of the words (`staging.slice_rows`, `copy_columns`);
  5. on the card, the plain version (`bitpack.parse_and_pack_plain`,
     `egress.render_plain`, torch ops on the same device tensors) held
     bit for bit against what came back; on the CPU the launch IS the
     plain version, and nothing is held.

A mesh variant (`desc.mesh`) runs the same steps a shard at a time,
as the engine's `_dispatch_cuda`: its input split into the mesh's row
blocks, every shard's launch prepared through the shard helpers
(`prepare_decode_pack_shards`, `prepare_filtered_shards`,
`prepare_render_shards`), then each shard's upload, launch, reduction of
its fallback candidates and D2H copies on its own device's stream, and
each shard held against the plain version of its own block. The record
keeps the row tensors each shard's launch read and wrote, for the
restated `ir-collective` (no shard touches another's block), and the
launches, which must be one a shard for each kernel of the program.

The contracts (`contracts`) are pure functions of what the run recorded.
On the CPU `ir-host-callback` cannot be checked: the report lists it as
`not_checked: cpu`, and that is the only reason a CPU run passes without
it.

Ordering is load-bearing: descriptors are enumerated sorted, findings
are emitted per descriptor in contract-catalog order and then sorted by
the same (path, line, col, rule) key the AST tier uses, so two runs over
the same layout set give byte-identical findings.
"""

from __future__ import annotations

import array
import contextlib
import dataclasses
import hashlib
import os
import time

from ..findings import _PACKAGE_SEGMENT, Finding, canonical_path
from . import IR_CONTRACT_NAMES, contracts
from .catalog import ProgramDescriptor, build_catalog

#: rows of the synthetic pool a program's input is tiled from
POOL_ROWS = 1024


class IrAnalysisError(RuntimeError):
    """Analyzer failure (not a lint finding): exit-code-2 territory."""


def device_problem(device: str) -> "str | None":
    """Why the tier cannot run on `device`, or None. No card and
    `--device cuda`: a typed refusal — the tier never drops to the CPU
    quietly."""
    if device == "cuda":
        import torch

        if not torch.cuda.is_available():
            return ("NO_CUDA_DEVICE: --device cuda: no CUDA device is "
                    "available; nothing run (pass --device cpu to run "
                    "the plain versions on the CPU)")
    elif device != "cpu":
        return f"unsupported --device {device!r} (cuda or cpu)"
    return None


@dataclasses.dataclass
class Record:
    """What one program's run recorded: all the contracts read."""
    inputs: list = dataclasses.field(default_factory=list)   # (name, t)
    outputs: list = dataclasses.field(default_factory=list)  # (name, t)
    fetched: list = dataclasses.field(default_factory=list)  # host tensors
    #: sites of the synchronising calls raised in the window; None when
    #: not checked (on the CPU)
    sync_events: "list | None" = None
    collectives: list = dataclasses.field(default_factory=list)
    launches: dict = dataclasses.field(default_factory=dict)
    route: str = ""
    count: "int | None" = None
    #: the launch stopped at a raise in the window (a sync under debug
    #: mode): only ir-host-callback and ir-collective are judged
    aborted: bool = False
    plain_ok: "bool | None" = None
    words: object = None  # the fetched words, for ir-canonical-dedup
    #: mesh variants: one list of (name, tensor) a shard — the row
    #: tensors its launch read and wrote
    shards: list = dataclasses.field(default_factory=list)


# -- launch accounting --------------------------------------------------------


def launch_counts() -> dict:
    """This process's kernel launches so far, by kernel."""
    from ...ops import decode_kernel as dk
    from ...ops import egress_kernel as ek

    return {"k1": dk.launches, "k2": dk.filter_launches,
            "epilogue": dk.compact_launches, "k2c": dk.fused_launches,
            "render": ek.launches}


def _delta(before: dict, after: dict) -> dict:
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}


# -- recording hooks ----------------------------------------------------------


@contextlib.contextmanager
def recording_collectives(calls: list):
    """Wrap `torch.distributed`'s collectives for the block: each call
    appends its name to `calls` and goes on to the real op. The
    originals are restored afterwards."""
    import torch

    dist = getattr(torch, "distributed", None)
    saved = {}
    if dist is not None:
        for op in contracts.COLLECTIVE_OPS:
            real = getattr(dist, op, None)
            if real is None:
                continue

            def wrapped(*a, _op=op, _real=real, **kw):
                calls.append(_op)
                return _real(*a, **kw)

            saved[op] = real
            setattr(dist, op, wrapped)
    try:
        yield calls
    finally:
        for op, real in saved.items():
            setattr(dist, op, real)


def _sync_site(exc: BaseException) -> str:
    """`path:function` of the innermost frame outside torch in the
    traceback of a sync-debug raise (the call that synchronised): a
    package file by its canonical path, any other by its name."""
    import torch

    torch_dir = os.path.dirname(os.path.abspath(torch.__file__))
    site = "unknown"
    tb = exc.__traceback__
    while tb is not None:
        f = tb.tb_frame.f_code
        path = os.path.abspath(f.co_filename)
        if not path.startswith(torch_dir):
            name = canonical_path(path) if _PACKAGE_SEGMENT in \
                path.split(os.sep) else os.path.basename(path)
            site = f"{name}:{f.co_name}"
        tb = tb.tb_next
    return site


def _is_sync_raise(exc: BaseException) -> bool:
    return isinstance(exc, RuntimeError) and "synchroniz" in str(exc)


@contextlib.contextmanager
def sync_checked(record: Record, enabled: bool):
    """The dispatch window of a program (every one is a @hot_loop
    dispatch): on the card (`enabled`), sync debug mode "error"; a
    synchronising call raises there, is recorded as a site, and aborts
    the rest of the window."""
    if not enabled:
        yield
        return
    import torch

    record.sync_events = []
    prev = torch.cuda.get_sync_debug_mode()
    _set_sync_debug_mode("error")
    try:
        yield
    except RuntimeError as e:
        if not _is_sync_raise(e):
            raise
        record.sync_events.append(_sync_site(e))
        record.aborted = True
    finally:
        _set_sync_debug_mode(prev)


def _set_sync_debug_mode(mode) -> None:
    """`torch.cuda.set_sync_debug_mode` without its warning that the mode
    is a prototype (once a program, it would bury the report)."""
    import warnings

    import torch

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        torch.cuda.set_sync_debug_mode(mode)


# -- synthetic inputs ---------------------------------------------------------


def program_seed(desc: ProgramDescriptor) -> int:
    h = hashlib.sha256(f"{desc.path}|{desc.scope}".encode()).hexdigest()
    return int(h[:8], 16)


def _tile(a, rows: int, axis: int):
    import numpy as np

    reps = -(-rows // a.shape[axis])
    tiled = np.concatenate([a] * reps, axis=axis) if reps > 1 else a
    return np.ascontiguousarray(tiled[:rows] if axis == 0
                                else tiled[:, :rows])


def synthetic_inputs(desc: ProgramDescriptor) -> dict:
    """The program's host inputs (numpy): bmat/lengths (+ flags under a
    filter) for a decode, words for a render."""
    import numpy as np

    from ...testing import egress_words, field_matrix, filter_case

    rng = np.random.default_rng(program_seed(desc))
    R, pool = desc.row_capacity, min(POOL_ROWS, desc.row_capacity)
    if desc.egress is not None:
        words = egress_words(desc.specs, pool, rng).numpy()
        return {"words": _tile(words.view(np.int32), R, 1)}
    if desc.pred is not None:
        bm, ln, fl = filter_case(desc.specs, pool, rng, desc.nibble)
        return {"bmat": _tile(bm, R, 0), "lengths": _tile(ln, R, 0),
                "row_flags": _tile(fl, R, 0)}
    bm, ln = field_matrix(desc.specs, pool, rng, desc.nibble)
    return {"bmat": _tile(bm, R, 0), "lengths": _tile(ln, R, 0)}


# -- one program --------------------------------------------------------------


def _plan(desc: ProgramDescriptor):
    from ...ops.egress import plan_for_specs

    plan = plan_for_specs(desc.specs, desc.egress)
    if plan is None:
        raise IrAnalysisError(f"{desc.path} [{desc.scope}]: the layout "
                              f"renders no column for {desc.egress}")
    return plan


def _ready(desc: ProgramDescriptor, dev) -> list:
    """Load the library and upload the descriptors the launch reads
    (outside the window); returns them as (name, tensor) inputs."""
    from ...ops import decode_kernel, egress_kernel

    if desc.egress is not None:
        egress_kernel.load()
        return [("render_desc", egress_kernel._device_desc(
            desc.specs, _plan(desc), dev))]
    decode_kernel.load()
    out = [("desc", decode_kernel._device_desc(desc.specs, desc.nibble,
                                               dev))]
    if desc.pred is not None:
        out.append(("pred_desc", decode_kernel._device_pred(
            desc.pred, desc.specs, dev)))
    return out


def _host_descriptors(desc: ProgramDescriptor) -> list:
    """The descriptor tensors of the program, built on the CPU (the
    plain versions read none, but the widening contract holds the
    tables the kernels would read)."""
    import torch

    from ...ops import decode_kernel, egress_kernel

    cpu = torch.device("cpu")
    if desc.egress is not None:
        return [("render_desc", egress_kernel._device_desc(
            desc.specs, _plan(desc), cpu))]
    out = [("desc", decode_kernel._device_desc(desc.specs, desc.nibble,
                                               cpu))]
    if desc.pred is not None and desc.pred.kernel_supported:
        out.append(("pred_desc", decode_kernel._device_pred(
            desc.pred, desc.specs, cpu)))
    return out


def _run_cpu(desc: ProgramDescriptor, host: dict, rec: Record,
             wrap) -> None:
    """The plain versions on CPU tensors: the host route, and every
    program of a `--device cpu` run. No D2H: what the consumer reads
    are the outputs themselves."""
    import torch

    from ...ops import decode_kernel, egress_kernel
    from ...ops.staging import slice_rows

    t = {k: torch.from_numpy(v) for k, v in host.items()}
    rec.inputs = sorted(t.items()) + _host_descriptors(desc)
    if desc.egress is not None:
        launch = wrap(egress_kernel.prepare_render(
            t["words"], desc.specs, _plan(desc)))
        ebytes, elens = launch()
        rec.outputs = [("text", ebytes), ("lengths", elens)]
        rec.fetched = [ebytes, elens]
        rec.route = "render-plain"
        return
    if desc.pred is not None:
        launch = wrap(decode_kernel.prepare_filtered(
            t["bmat"], t["lengths"], t["row_flags"], desc.specs,
            desc.nibble, desc.pred))
        words, mask, counts = launch()
        rec.outputs = [("words", words), ("keep_mask", mask),
                       ("count", counts)]
        rec.count = int(counts[0])
        sb = slice_rows(rec.count, desc.row_capacity)
        rec.fetched = [mask, counts, words[:, :sb]]
        rec.words = words[:, :rec.count]
        rec.route = "filtered-plain"
        return
    launch = wrap(decode_kernel.prepare_decode_pack(
        t["bmat"], t["lengths"], desc.specs, desc.nibble))
    words = launch()
    rec.outputs = [("words", words)]
    rec.fetched = [words]
    rec.words = words
    rec.route = "k1-plain"


def _pinned(a):
    import torch

    return torch.from_numpy(a).pin_memory()


def _run_cuda(desc: ProgramDescriptor, host: dict, rec: Record,
              wrap) -> None:
    """One dispatch on the card, as the engine's (module docstring)."""
    import torch

    from ...ops import decode_kernel, egress_kernel
    from ...ops.staging import slice_rows

    dev = torch.device("cuda", torch.cuda.current_device())
    stream = torch.cuda.current_stream(dev)
    pinned = {k: _pinned(v) for k, v in host.items()}
    descs = _ready(desc, dev)
    done = torch.cuda.Event()
    with sync_checked(rec, True):
        d = {k: torch.empty(v.shape, dtype=v.dtype, device=dev)
             for k, v in pinned.items()}
        rec.inputs = sorted(d.items()) + descs
        if desc.egress is not None:
            launch = wrap(egress_kernel.prepare_render(
                d["words"], desc.specs, _plan(desc)))
        elif desc.pred is not None:
            launch = wrap(decode_kernel.prepare_filtered(
                d["bmat"], d["lengths"], d["row_flags"], desc.specs,
                desc.nibble, desc.pred))
        else:
            launch = wrap(decode_kernel.prepare_decode_pack(
                d["bmat"], d["lengths"], desc.specs, desc.nibble))
        for k, v in d.items():
            v.copy_(pinned[k], non_blocking=True)
        out = launch()
        out = out if isinstance(out, tuple) else (out,)
        rec.outputs = list(zip(_out_names(desc), out))
        # the dispatch's D2H copies: everything but a filtered decode's
        # words, which wait for the count
        fetch = out if desc.pred is None else out[1:]
        hosts = []
        for t in fetch:
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            h.copy_(t, non_blocking=True)
            hosts.append(h)
        done.record(stream)
    if rec.aborted:
        return
    done.synchronize()  # the consumer's wait (`_PendingDecode.result`)
    if desc.pred is not None:
        mask_h, counts_h = hosts
        rec.count = int(counts_h[0])
        sb = slice_rows(rec.count, desc.row_capacity)
        words_d = rec.outputs[0][1]
        words_h = torch.empty((words_d.shape[0], sb), dtype=torch.int32,
                              pin_memory=True)
        if sb:
            decode_kernel.copy_columns(words_h, words_d.view(torch.int32),
                                       sb)
        stream.synchronize()
        rec.fetched = [mask_h, counts_h, words_h]
        rec.words = words_h[:, :rec.count]
        rec.route = "filtered"
    else:
        rec.fetched = hosts
        rec.words = hosts[0] if desc.egress is None else None
        rec.route = "render" if desc.egress is not None else "k1"
    rec.plain_ok = _held_to_plain(desc, d, hosts, rec)


def _held_to_plain(desc: ProgramDescriptor, d: dict, hosts: list,
                   rec: Record) -> bool:
    """The fetched outputs against the plain version on the same device
    inputs, bit for bit (a filtered decode in its first `count`
    columns, the mask and the count: K2c writes no column past it)."""
    import torch

    from ...ops.bitpack import parse_and_pack_plain
    from ...ops.egress import render_plain

    if desc.egress is not None:
        want = render_plain(d["words"], desc.specs, _plan(desc))
        return all(torch.equal(h, w.cpu()) for h, w in zip(hosts, want))
    if desc.pred is not None:
        words, mask, counts = parse_and_pack_plain(
            d["bmat"], d["lengths"], desc.specs, desc.nibble,
            pred=desc.pred, row_flags=d["row_flags"])
        n = int(counts[0])
        return (n == rec.count
                and torch.equal(hosts[0].view(torch.int32),
                                mask.view(torch.int32).cpu())
                and torch.equal(rec.words.view(torch.int32),
                                words[:, :n].view(torch.int32).cpu()))
    want = parse_and_pack_plain(d["bmat"], d["lengths"], desc.specs,
                                desc.nibble)
    return torch.equal(hosts[0].view(torch.int32),
                       want.view(torch.int32).cpu())


def _shard_launches(desc: ProgramDescriptor, blocks: dict) -> list:
    """One prepared launch a shard over `blocks` (name → one tensor a
    shard), in shard order."""
    from ...ops import decode_kernel, egress_kernel

    if desc.egress is not None:
        return egress_kernel.prepare_render_shards(
            blocks["words"], desc.specs, _plan(desc))
    if desc.pred is not None:
        return decode_kernel.prepare_filtered_shards(
            blocks["bmat"], blocks["lengths"], blocks["row_flags"],
            desc.specs, desc.nibble, desc.pred)
    return decode_kernel.prepare_decode_pack_shards(
        blocks["bmat"], blocks["lengths"], desc.specs, desc.nibble)


def _touched(launch, original, out: tuple) -> list:
    """The row tensors a shard's launch read (its `inputs`: the wrapped
    launch's where a wrap set them, else the prepared one's) and wrote."""
    reads = getattr(launch, "inputs", None)
    if reads is None:
        reads = original.inputs
    names = ("words",) if len(reads) == 1 else \
        ("bmat", "lengths", "row_flags")[:len(reads)]
    return [(f"in:{n}", t) for n, t in zip(names, reads)] \
        + [(f"out:{i}", t) for i, t in enumerate(out)]


def _out_names(desc: ProgramDescriptor) -> tuple:
    return ("text", "lengths") if desc.egress is not None else \
        ("words", "keep_mask", "count") if desc.pred is not None \
        else ("words",)


def _mesh_blocks(desc: ProgramDescriptor, host: dict, to_tensor) -> dict:
    """name → one tensor a shard: the host inputs split into the mesh's
    row blocks (rows lead bmat, lengths and flags; the words run along
    their second axis), each made a tensor by `to_tensor`."""
    import numpy as np

    out = {}
    for k, v in host.items():
        parts = np.split(v, desc.n_shards, axis=1 if k == "words" else 0)
        out[k] = [to_tensor(np.ascontiguousarray(b)) for b in parts]
    return out


def _run_mesh_cpu(desc: ProgramDescriptor, host: dict, rec: Record,
                  wrap) -> None:
    """A mesh program's shards through the plain versions on CPU tensors
    (`--device cpu`): row-block views of the input, as the engine's CPU
    mesh dispatch takes them. No D2H: the consumer reads the outputs."""
    import torch

    from ...ops.bitpack import layout_for_specs, shard_fallback_counts
    from ...ops.staging import slice_rows

    blocks = _mesh_blocks(desc, host, torch.from_numpy)
    prepared = _shard_launches(desc, blocks)
    launches = [wrap(launch) for launch in prepared]
    rec.inputs = _host_descriptors(desc)
    names = _out_names(desc)
    rps = desc.row_capacity // desc.n_shards
    words = []
    for s, (launch, orig) in enumerate(zip(launches, prepared)):
        out = launch()
        out = out if isinstance(out, tuple) else (out,)
        touched = _touched(launch, orig, out)
        rec.shards.append(touched)
        rec.inputs += [(f"{n}[{s}]", v) for n, v in touched
                       if n.startswith("in:")]
        rec.outputs += [(f"{n}[{s}]", v) for n, v in zip(names, out)]
        if desc.egress is not None:
            rec.fetched += list(out)
        elif desc.pred is not None:
            count = int(out[2][0])
            rec.fetched += [out[1], out[2],
                            out[0][:, :slice_rows(count, rps)]]
            words.append(out[0][:, :count])
        else:
            bad = shard_fallback_counts(
                out[0], blocks["lengths"][s], layout_for_specs(desc.specs))
            rec.fetched += [out[0], bad]
            words.append(out[0])
    if words:
        rec.words = torch.cat([w.view(torch.int32) for w in words], dim=1)
    rec.route = "mesh-" + ("render" if desc.egress is not None else
                           "filtered" if desc.pred is not None else "k1") \
        + "-plain"


def _run_mesh_cuda(desc: ProgramDescriptor, host: dict, rec: Record,
                   wrap) -> None:
    """One mesh dispatch on the card(s), as the engine's `_dispatch_cuda`
    (module docstring), every shard then held against the plain version
    of its own block."""
    import torch

    from ...ops import decode_kernel
    from ...ops.bitpack import (layout_for_specs, parse_and_pack_plain,
                                shard_fallback_counts)
    from ...ops.staging import slice_rows

    devs = list(desc.mesh.flat)
    hblocks = _mesh_blocks(desc, host, _pinned)
    descs = []
    for dev in sorted(set(devs), key=str):
        with decode_kernel.device_scope(dev):
            descs += [(f"{n}@{dev}", v) for n, v in _ready(desc, dev)]
    names = _out_names(desc)
    layout = layout_for_specs(desc.specs)
    rps = desc.row_capacity // desc.n_shards
    done = []
    hosts_by_shard, d_by_shard, words_d = [], [], []
    with sync_checked(rec, True):
        dblocks = {k: [torch.empty(b.shape, dtype=b.dtype, device=d)
                       for b, d in zip(bs, devs)]
                   for k, bs in hblocks.items()}
        rec.inputs = list(descs)
        prepared = _shard_launches(desc, dblocks)
        launches = [wrap(launch) for launch in prepared]
        for s, dev in enumerate(devs):
            with torch.cuda.device(dev):
                stream = torch.cuda.current_stream(dev)
                for k in dblocks:
                    dblocks[k][s].copy_(hblocks[k][s], non_blocking=True)
                out = launches[s]()
                out = out if isinstance(out, tuple) else (out,)
                rec.shards.append(_touched(launches[s], prepared[s], out))
                rec.inputs += [(f"{k}[{s}]", dblocks[k][s]) for k in dblocks]
                rec.outputs += [(f"{n}[{s}]", v) for n, v in zip(names, out)]
                words_d.append(out[0])
                fetch = list(out if desc.pred is None else out[1:])
                if desc.egress is None and desc.pred is None:
                    fetch.append(shard_fallback_counts(
                        out[0], dblocks["lengths"][s], layout))
                hosts = []
                for t in fetch:
                    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                    h.copy_(t, non_blocking=True)
                    hosts.append(h)
                ev = torch.cuda.Event()
                ev.record(stream)
                done.append(ev)
                hosts_by_shard.append(hosts)
                d_by_shard.append({k: dblocks[k][s] for k in dblocks})
    if rec.aborted:
        return
    for ev in done:
        ev.synchronize()  # the consumer's wait (`_PendingDecode.result`)
    ok = True
    words = []
    for s, dev in enumerate(devs):
        hosts, d = hosts_by_shard[s], d_by_shard[s]
        srec = Record()
        if desc.pred is not None:
            mask_h, counts_h = hosts
            srec.count = int(counts_h[0])
            sb = slice_rows(srec.count, rps)
            words_h = torch.empty((words_d[s].shape[0], sb),
                                  dtype=torch.int32, pin_memory=True)
            with torch.cuda.device(dev):
                if sb:
                    decode_kernel.copy_columns(
                        words_h, words_d[s].view(torch.int32), sb)
                torch.cuda.current_stream(dev).synchronize()
            rec.fetched += [mask_h, counts_h, words_h]
            srec.words = words_h[:, :srec.count]
            words.append(srec.words)
        else:
            rec.fetched += hosts
            if desc.egress is None:
                srec.words = hosts[0]
                words.append(hosts[0].view(torch.int32))
        with torch.cuda.device(dev):
            ok = _held_to_plain(desc, d, hosts, srec) and ok
            if desc.egress is None and desc.pred is None:
                want = shard_fallback_counts(parse_and_pack_plain(
                    d["bmat"], d["lengths"], desc.specs, desc.nibble),
                    d["lengths"], layout)
                ok = ok and torch.equal(hosts[1], want.cpu())
    if words:
        rec.words = torch.cat([w.view(torch.int32).cpu() for w in words],
                              dim=1)
    rec.route = "mesh-" + ("render" if desc.egress is not None else
                           "filtered" if desc.pred is not None else "k1")
    rec.plain_ok = ok


def run_program(desc: ProgramDescriptor, device: str, wrap=None,
                calls: "list | None" = None) -> Record:
    """Launch one program on `device` and record what the contracts
    read. `wrap(launch) -> launch` replaces the prepared launch (the
    deliberate violations of tests and of the chip smoke)."""
    wrap = wrap or (lambda launch: launch)
    calls = [] if calls is None else calls
    rec = Record()
    host = synthetic_inputs(desc)
    before, n_calls = launch_counts(), len(calls)
    if desc.mesh is not None:
        if device == "cuda":
            _run_mesh_cuda(desc, host, rec, wrap)
        else:
            _run_mesh_cpu(desc, host, rec, wrap)
    elif device == "cuda" and not desc.host:
        _run_cuda(desc, host, rec, wrap)
    else:
        # the host route is a @hot_loop dispatch too: on the card its
        # plain versions run under the same sync check
        with sync_checked(rec, device == "cuda"):
            _run_cpu(desc, host, rec, wrap)
    rec.launches = _delta(before, launch_counts())
    if rec.route in ("filtered", "mesh-filtered"):  # by shape
        rec.route = rec.route.replace("filtered", "") + (
            "k2c" if rec.launches.get("k2c") else "k2+epilogue")
    rec.collectives = calls[n_calls:]
    return rec


# -- contracts over one record ---------------------------------------------


def _descriptor_bytes(specs: tuple, nibble: bool) -> bytes:
    from ...ops import decode_kernel

    return array.array("i", decode_kernel.descriptor(specs, nibble)).tobytes()


def library_digest(desc: ProgramDescriptor) -> str:
    """The digest of the kernel library a program launches from: its
    source and flags (one library serves every layout)."""
    from ...ops import decode_kernel, egress_kernel

    mod = egress_kernel if desc.egress is not None else decode_kernel
    lib = mod.LIBRARY
    h = hashlib.sha256(lib.source.read_bytes())
    h.update(" ".join(lib.flags).encode())
    return h.hexdigest()[:16]


def _twin_words_equal(desc: ProgramDescriptor, twin_specs: tuple,
                      rec: Record, device: str, calls: list):
    """The twin's words on the same canonical input, where its specs
    differ from the program's (equal specs are the same launch)."""
    import torch

    if twin_specs == desc.specs or rec.words is None:
        return None
    twin = dataclasses.replace(desc, specs=twin_specs, dedup_twin=None)
    other = run_program(twin, device, calls=calls)
    if other.words is None:
        return None
    return bool(torch.equal(rec.words.view(torch.int32).cpu(),
                            other.words.view(torch.int32).cpu()))


def analyze_descriptor(desc: ProgramDescriptor, device: str,
                       wrap=None, calls: "list | None" = None) -> tuple:
    """(findings, record) of one program descriptor."""
    from ...ops.bitpack import layout_for_specs

    calls = [] if calls is None else calls
    rec = run_program(desc, device, wrap, calls)
    findings: list[Finding] = []

    def emit(rule: str, pairs) -> None:
        for detail, message in pairs:
            findings.append(Finding(rule=rule, path=desc.path, line=1,
                                    col=0, scope=desc.scope,
                                    detail=detail, message=message))

    if rec.sync_events is not None:
        emit("ir-host-callback",
             contracts.check_host_callback(rec.sync_events))
    emit("ir-collective", contracts.check_collectives(rec.collectives))
    if desc.mesh is not None and not rec.aborted:
        from .catalog import MESH_KERNEL_OF_VARIANT

        emit("ir-collective", contracts.check_shard_locality(rec.shards))
        if device == "cuda":  # only the card's launches are counted
            emit("ir-collective", contracts.check_shard_launches(
                rec.launches, MESH_KERNEL_OF_VARIANT[desc.variant],
                desc.n_shards))
    if not rec.aborted:
        emit("ir-donation",
             contracts.check_donation(rec.inputs, rec.outputs))
        emit("ir-widening",
             contracts.check_widening(rec.inputs + rec.outputs))
        if desc.egress is not None:
            plan = _plan(desc)
            emit("ir-egress-output-budget",
                 contracts.check_egress_output_budget(
                     rec.fetched, desc.row_capacity, plan.total_width,
                     len(plan.slots)))
        else:
            emit("ir-output-budget", contracts.check_output_budget(
                rec.fetched, layout_for_specs(desc.specs).n_words,
                desc.row_capacity, filtered=desc.pred is not None,
                n_shards=desc.n_shards))
        if desc.dedup_twin is not None:
            from ...ops.program_store import canonical_plan

            twin_specs = canonical_plan(desc.dedup_twin).specs
            twin = dataclasses.replace(desc, specs=twin_specs)
            emit("ir-canonical-dedup", contracts.check_canonical_dedup(
                _descriptor_bytes(desc.specs, desc.nibble),
                _descriptor_bytes(twin_specs, desc.nibble),
                library_digest(desc), library_digest(twin),
                _twin_words_equal(desc, twin_specs, rec, device, calls)))
    findings.sort(key=lambda f: (IR_CONTRACT_NAMES.index(f.rule), f.detail))
    return findings, rec


def _finding_sort_key(f: Finding):
    # same composite the AST tier's analyze_paths sorts on, extended
    # with (scope, detail) — IR findings share line/col
    return (f.path, f.line, f.col, f.rule, f.scope, f.detail)


#: shards of the `--mesh` pass: the reference's forced host devices
MESH_SHARDS = 8


def analyze_local(*, device: str = "cuda", row_buckets=None,
                  include_observed: bool = True, mesh=None) -> tuple:
    """Run the tier in-process over the catalog. Returns (findings,
    program_paths, report) — paths cover every ENUMERATED program, clean
    or not, so `--check-baseline` can treat the whole namespace as
    scanned; the report is plain data (the run's programs, launches,
    contract counts, what was not checked and what disagreed with its
    plain version). `mesh` (a DecodeMesh, or True for `MESH_SHARDS`
    shards over the devices at hand: `parallel.mesh.shard_mesh`) adds
    the mesh's variants to the same run — one process drives every
    shard, so the reference's forced-device subprocess has no
    counterpart."""
    problem = device_problem(device)
    if problem is not None:
        raise IrAnalysisError(problem)
    t0 = time.perf_counter()
    try:
        descriptors = build_catalog(row_buckets=row_buckets,
                                    include_observed=include_observed)
        if mesh is True:
            from ...parallel.mesh import shard_mesh

            mesh = shard_mesh(MESH_SHARDS, device)
        if mesh is not None:
            descriptors += build_catalog(mesh=mesh, row_buckets=row_buckets,
                                         include_observed=include_observed)
    except Exception as e:
        raise IrAnalysisError(f"program enumeration failed: {e}") from e
    findings: list[Finding] = []
    paths: list[str] = []
    variants: dict = {}
    routes: dict = {}
    launches: dict = {}
    program_launches: dict = {}
    mismatches: list = []
    seconds: dict = {}
    calls: list = []
    before = launch_counts()
    with recording_collectives(calls):
        for desc in descriptors:
            paths.append(desc.path)
            variants[desc.variant] = variants.get(desc.variant, 0) + 1
            t1 = time.perf_counter()
            try:
                got, rec = analyze_descriptor(desc, device, calls=calls)
            except IrAnalysisError:
                raise
            except Exception as e:
                raise IrAnalysisError(
                    f"launching {desc.path} [{desc.scope}] failed: "
                    f"{type(e).__name__}: {e}") from e
            findings.extend(got)
            seconds[desc.variant] = seconds.get(desc.variant, 0.0) \
                + time.perf_counter() - t1
            routes[rec.route] = routes.get(rec.route, 0) + 1
            for k, n in rec.launches.items():
                program_launches[k] = program_launches.get(k, 0) + n
            if rec.plain_ok is False:
                mismatches.append(f"{desc.path} [{desc.scope}]")
    launches = _delta(before, launch_counts())
    findings.sort(key=_finding_sort_key)
    by_rule = {name: 0 for name in IR_CONTRACT_NAMES}
    for f in findings:
        by_rule[f.rule] += 1
    report = {
        "device": device,
        "row_buckets": list(row_buckets or (4096,)),
        "programs": len(descriptors),
        "variants": dict(sorted(variants.items())),
        "routes": dict(sorted(routes.items())),
        "launches": dict(sorted(launches.items())),
        "program_launches": dict(sorted(program_launches.items())),
        "findings": by_rule,
        "not_checked": {"ir-host-callback": "cpu"} if device == "cpu"
        else {},
        "plain_held": device == "cuda",
        "mesh_shards": mesh.size if mesh is not None else 0,
        "plain_mismatches": mismatches,
        "seconds": time.perf_counter() - t0,
        "seconds_by_variant": {k: round(v, 3)
                               for k, v in sorted(seconds.items())},
    }
    if mismatches:
        raise IrAnalysisError(
            "launches disagree with their plain versions: "
            + ", ".join(mismatches))
    return findings, sorted(set(paths)), report


def report_lines(report: dict) -> list:
    """The report as a few human lines (the CLI prints them on stderr)."""
    lines = [f"ir: {report['programs']} programs on {report['device']} "
             f"(row buckets {report['row_buckets']}) in "
             f"{report['seconds']:.2f} s; variants "
             + " ".join(f"{k}={v}" for k, v in report["variants"].items()),
             "ir: launches " + (" ".join(
                 f"{k}={v}" for k, v in report["launches"].items())
                 or "none") + "; routes " + " ".join(
                 f"{k}={v}" for k, v in report["routes"].items()),
             "ir: findings " + " ".join(
                 f"{k}={v}" for k, v in report["findings"].items())]
    if report.get("mesh_shards"):
        lines.append(f"ir: mesh variants on {report['mesh_shards']} shards")
    for rule, why in report["not_checked"].items():
        lines.append(f"ir: {rule} not_checked: {why}")
    return lines
