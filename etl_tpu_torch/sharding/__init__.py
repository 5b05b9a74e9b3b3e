"""Horizontal scale-out: shard one publication across K replicators.

Copy of the reference's `etl_tpu/sharding`. Each shard pod is a `Pipeline`
of its own with its own `DecodePipeline` and CUDA stream; on one card the
pods share the device and the process-wide admission scheduler.

Four parts (the reference's docs/sharding.md):

  - `shardmap` — rendezvous (HRW) table→shard hashing, versioned by
    epoch, plus the persisted `ShardAssignment` record;
  - `runtime` — the shard-scoped runtime seam: `ShardScopedStore` filters
    a shared PipelineStore down to one shard's tables and FENCES writes
    (a pod holding a stale epoch, or touching a table another shard owns,
    gets a typed refusal instead of silently corrupting the handoff);
  - `coordinator` — `ShardCoordinator` drives add/remove-shard
    rebalancing as a two-phase epoch bump: quiesce moved tables at a
    fence LSN, flip the assignment, resume on the new owner from durable
    progress — zero-loss / bounded-dup by construction;
  - slot naming rides `postgres/slots.py` (`_s{shard}` suffixes).

Only `shardmap` is imported eagerly: `store/base.py` imports the
assignment record at module-import time, so the runtime/coordinator
halves (which import the store back) resolve lazily to keep the import
graph acyclic — the same convention as `etl_tpu/chaos`.
"""

from __future__ import annotations

from .shardmap import (ShardAssignment, ShardMap, STATUS_REBALANCING,
                       STATUS_STEADY, moved_tables)  # noqa: F401

_LAZY = {
    "ShardScopedStore": "runtime",
    "ShardIdentity": "runtime",
    "resolve_shard_scope": "runtime",
    "ShardCoordinator": "coordinator",
    "RebalanceResult": "coordinator",
}

__all__ = ["ShardAssignment", "ShardMap", "STATUS_REBALANCING",
           "STATUS_STEADY", "moved_tables", *_LAZY]


def __getattr__(name: str):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module 'etl_tpu_torch.sharding' has no "
                             f"attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(f".{mod}", __name__), name)
