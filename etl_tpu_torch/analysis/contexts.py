"""Context propagation along call-graph edges.

The lexical visitor knows a function's OWN context (inside `async def`,
under `@hot_loop`). This module extends those contexts transitively: a
function reachable from an event-loop `async def` through plain sync
calls runs ON the event loop; a helper called from a `@hot_loop`
function runs IN the hot loop. Each reached function carries the chain
that proves it, entry first, so findings render `a → b → c: time.sleep`
and `--explain` can print one resolvable file:line per hop.

Edge semantics (the part that keeps this sound for asyncio):

  - a plain call edge into a SYNC project function propagates every
    context — the callee executes inline, in the caller's frame;
  - a call into an ASYNC function is followed only when the call site is
    awaited AND the callee is not its own entry for the querying rule
    (`follow_await`): un-awaited, the call just builds a coroutine
    object (rule 4 territory); awaited into another entry, the callee
    reports its own closure and re-reporting it from every upstream
    `async def` would multiply one sink into a finding per caller;
  - function REFERENCES are never edges, so the sanctioned off-loop
    idioms — `run_in_executor(None, fn)`, `asyncio.to_thread(fn)`,
    handing a lambda to an executor — break propagation exactly where
    execution actually leaves the loop/hot path;
  - `prune(site, callee)` lets a rule stop at a call that is ITSELF a
    sink (e.g. `autotune.resolve_device_min_rows`): the finding names
    the sink call; the sink's own internals would only produce noisier
    duplicates of the same root cause.

Traversal is BFS per entry, so the recorded chain is a shortest witness
and deterministic (call sites are visited in (line, col) order); cycles
terminate via the per-entry visited set.
"""

from __future__ import annotations

from .callgraph import CallSite, FunctionInfo, Project


class Reached:
    """One function reached from one entry, with its witness chain."""

    __slots__ = ("fn", "chain", "chain_sites", "entry", "dispatch",
                 "anchor")

    def __init__(self, fn: FunctionInfo, chain: tuple, chain_sites: tuple,
                 entry: FunctionInfo, dispatch: bool,
                 anchor: "CallSite | None"):
        self.fn = fn
        self.chain = chain  # qualnames, entry first, `fn` last
        self.chain_sites = chain_sites  # (path, line) per hop's call site
        self.entry = entry
        self.dispatch = dispatch  # dispatch-stage sanction along chain
        #: the call site in the ENTRY function that starts this chain —
        #: where the finding anchors (and where an inline ignore goes);
        #: None for the entry itself
        self.anchor = anchor


def reach_from(entry: FunctionInfo, *, max_depth: int = 12,
               follow_await=None, prune=None) -> "list[Reached]":
    """All project functions reachable from `entry` (including the entry
    itself at depth 0), shortest chains first.

    `follow_await(callee) -> bool` gates edges into async callees (the
    site must be awaited regardless); default: never follow — every
    `async def` is its own entry for the async-context rules, so
    following would only duplicate findings upstream. `prune(site,
    callee) -> bool` stops traversal into a callee (the sink itself)."""
    out = [Reached(entry, (entry.qualname,),
                   ((entry.module.path, entry.line),), entry,
                   entry.is_dispatch, None)]
    seen = {id(entry)}
    queue = [(entry, out[0], 0)]
    while queue:
        fn, reached, depth = queue.pop(0)
        if depth >= max_depth:
            continue
        for site in fn.calls:
            callee = site.resolved
            if callee is None or id(callee) in seen:
                continue
            if callee.is_async:
                if not site.awaited:
                    continue  # builds a coroutine; does not run here
                if follow_await is None or not follow_await(callee):
                    continue
            if prune is not None and prune(site, callee):
                continue
            seen.add(id(callee))
            sites = reached.chain_sites[:-1] \
                + ((fn.module.path, site.line),) \
                + ((callee.module.path, callee.line),)
            nxt = Reached(
                callee, reached.chain + (callee.qualname,), sites, entry,
                reached.dispatch or callee.is_dispatch,
                reached.anchor if reached.anchor is not None else site)
            out.append(nxt)
            queue.append((callee, nxt, depth + 1))
    return out


def async_entries(project: Project, scopes: "tuple[str, ...] | None" = None):
    """Every `async def` (optionally restricted to modules whose first
    path segment is in `scopes`) — the event-loop entry set."""
    for fn in project.iter_functions():
        if not fn.is_async:
            continue
        if scopes is not None \
                and fn.module.path.split("/", 1)[0] not in scopes:
            continue
        yield fn


def hot_entries(project: Project):
    """Every function marked `@hot_loop` (alias-resolved)."""
    for fn in project.iter_functions():
        if fn.is_hot:
            yield fn
