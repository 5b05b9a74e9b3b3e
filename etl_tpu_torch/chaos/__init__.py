"""etl-chaos: deterministic fault injection + crash-recovery verification.

Three parts (the reference's docs/chaos.md):

  - `failpoints` — the named-site injection registry (grown from
    runtime/failpoints.py; that module is now a re-export shim);
  - `scenario` / `corpus` — seeded, reproducible fault schedules armed
    across layers (wire, decode pipeline, device, destination, store,
    hard crash→restart);
  - `runner` / `invariants` — runs a scenario against the fake walsender
    + MemoryDestination and asserts the recovery invariants: zero-loss,
    bounded duplication, monotonic durable LSN, store consistency, no
    leaked tasks / arenas / pipeline threads.

`python -m etl_tpu_torch.chaos --seed N` replays a scenario
deterministically.

Copy of the reference's `etl_tpu/chaos`, on the port's pipeline, every
scenario family included (the autoscale and fleet families with their
modules, the program-cache scenarios on the port's program store).

Only `failpoints` is imported eagerly: the runtime package imports it at
module-import time, so the heavyweight runner/corpus (which import the
runtime back) resolve lazily to keep the import graph acyclic.
"""

from __future__ import annotations

from . import failpoints  # noqa: F401

_LAZY = {
    "FaultSpec": "scenario",
    "Scenario": "scenario",
    "InvariantReport": "invariants",
    "check_invariants": "invariants",
    "ChaosRun": "runner",
    "run_scenario": "runner",
    "SCENARIOS": "corpus",
    "get_scenario": "corpus",
}

__all__ = ["failpoints", *_LAZY]


def __getattr__(name: str):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module 'etl_tpu_torch.chaos' has no attribute "
                             f"{name!r}")
    import importlib

    return getattr(importlib.import_module(f".{mod}", __name__), name)
