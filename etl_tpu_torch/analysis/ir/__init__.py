"""etl-lint IR tier: contract verification of the port's kernel launches.

The AST tier (..rules) guards source; this tier guards the launches
themselves. It enumerates every decode program the port can launch —
canonical layouts from the program store + the schema catalog, observed
signatures, the variants the engine dispatches (K1, K1 nibble-packed,
the fused filter, the egress render, the host route) — prepares each
through the same `prepare_*` wrappers the engine's dispatch uses, runs
the launch on `--device` with the D2H copies the dispatch enqueues, and
checks per-program contracts on what the run recorded: the tensors a
launch takes and returns, the bytes its D2H copies move, the
synchronising calls CUDA's sync debug mode raised, the collectives
called, and the kernel descriptors of permuted twins.

Findings flow through the same `findings.Finding` model, fingerprints,
baseline, and `--format=github` machinery as AST findings. IR findings
live under the reserved `programs/<layout-tag>` path namespace (which
`findings.canonical_path` passes through untouched) with the program
variant as the scope, so fingerprints are stable across runs and
machines.

This module stays import-light (no torch): the CLI imports it
unconditionally for the contract names and namespace; the runner, which
imports torch and the decode engine, loads only behind `--programs`.
"""

from __future__ import annotations

#: reserved path namespace for IR-tier findings ("programs/<tag>");
#: never collides with a real file path, so baseline entries for the two
#: tiers cannot alias
IR_NAMESPACE = "programs/"

#: the contract catalog, in check order. These are finding `rule` names,
#: deliberately NOT part of rules.RULE_NAMES: the AST fixture-coverage
#: tests pin that tuple to source-level rules, and IR contracts are
#: exercised against launched programs, not fixture files.
IR_CONTRACT_NAMES = (
    "ir-host-callback",
    "ir-donation",
    "ir-collective",
    "ir-widening",
    "ir-output-budget",
    "ir-egress-output-budget",
    "ir-canonical-dedup",
)
