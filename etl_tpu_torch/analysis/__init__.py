"""etl-lint for the port: AST-based async-safety & device-sync static
analysis, and the IR tier over the port's kernel launches.

The reference's analyzer (etl_tpu/analysis), ported: the same rules,
the same finding model, fingerprints, baseline format and CLI contract,
over etl_tpu_torch/ — lexically per module AND interprocedurally over the
whole program (wrapping a sink in a helper one file away does not
defeat a rule):

  - `rules`      — the per-module rule set (docs/static-analysis.md has
                   the reference's contracts; the device sinks are
                   restated below)
  - `visitor`    — scope/context-tracking AST walk the rules plug into
  - `callgraph`  — whole-program symbol tables + resolved call graph
  - `contexts`   — async/hot-loop context propagation along call edges
  - `cfg`        — per-function CFG + forward dataflow
  - `interproc`  — transitive rule upgrades + resource/deadlock rules
  - `domains`, `concurrency` — execution domains and the race rules
  - `findings`   — the finding model + stable fingerprints + chains
  - `baseline`   — suppression file I/O (`baseline.json`, the port's own)
  - `cli`        — `python -m etl_tpu_torch.analysis [paths]`
  - `annotations`— the runtime-visible markers (`@hot_loop`, ...)
  - `ir`         — the IR tier (`--programs`, alias `--ir`)

Device sinks, the reference's beside the port's:

  reference (JAX)                        port (PyTorch)
  -------------------------------------  --------------------------------
  jax.device_get, np.asarray / np.array  .cpu(), .item(), .tolist(),
  of a device value,                     .numpy(), .to("cpu"),
  .block_until_ready()                   torch.cuda.synchronize, an
                                         Event's / a Stream's
                                         .synchronize(), .copy_(…)
                                         without non_blocking=True
  jax.device_put (an upload; allowed     .cuda(), .to(<device>),
  inside @dispatch_stage)                .copy_(…, non_blocking=True)
                                         (enqueued; allowed inside
                                         @dispatch_stage)
  jax.jit (compiles in async code)       program_store.acquire, a kernel
                                         module's load() (an nvcc build on
                                         a cold store)
  autotune.measure,                      the same names in the port's
  autotune.resolve_device_min_rows       ops/autotune.py
  donated-buffer-use: a buffer passed    the destination of a
  in a donate_argnums position, read     .copy_(…, non_blocking=True),
  afterwards                             read on the host before an
                                         event's or a stream's
                                         synchronize() / wait_event

`np.asarray` of a CPU tensor is no sync in the port, so it is in no
device set (it stays a row-materialisation sink). `.item()` and
`.tolist()`, which numpy values have too, count only in a module that
imports torch; past depth 0 of a call chain only the definite sinks
count (`.numpy()`, which raises on a CUDA tensor, is not one).

IR contracts, the reference's (compiled JAX programs) beside the
port's (kernel launches, `ir/contracts.py`):

  ir-host-callback       no callback primitive in the jaxpr → no
                         synchronising call in the prepare, launch and
                         D2H enqueue, under CUDA's sync debug mode (on the
                         CPU: not checked, and listed so)
  ir-donation            declared donation realized → no launch output
                         shares storage with an input (no donation)
  ir-collective          no collective in a mesh program → no
                         torch.distributed call during a dispatch
  ir-widening            no 64-bit equation → no 64-bit tensor taken or
                         returned by a launch
  ir-output-budget,      the reference's formulas, over the bytes the
  ir-egress-output-budget  dispatch's D2H copies move
  ir-canonical-dedup     byte-identical lowered IR → byte-identical
                         kernel descriptors and one library digest (and
                         the same words where launched)

The AST, interprocedural and concurrency tiers are stdlib-only, as the
reference's are: `import etl_tpu_torch.analysis` imports no torch, so hot
modules can import the markers. The IR tier imports torch lazily.
"""

from __future__ import annotations

from .annotations import hot_loop
from .findings import Finding

__all__ = ["Finding", "analyze_paths", "analyze_source", "hot_loop"]


def analyze_source(source: str, rel_path: str):
    """Lint one module's source; `rel_path` drives path-scoped rules."""
    from .rules import analyze_source as _impl

    return _impl(source, rel_path)


def analyze_paths(paths, root=None):
    from .rules import analyze_paths as _impl

    return _impl(paths, root=root)
