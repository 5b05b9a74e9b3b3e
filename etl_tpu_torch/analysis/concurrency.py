"""Concurrency tier: lockset + happens-before race detection.

Static twin of the chaos corpus, in the style of Eraser (Savage et al.
1997) and FastTrack (Flanagan & Freund 2009), adapted to lint time: the
domain inference in domains.py plays the role of thread identity, the
rule-11 lock tables play the role of the dynamic lockset, and the
happens-before edges a dynamic detector would observe (fork, join,
message receive) become STATIC sanctions the analysis recognizes:

  lock-held           — every write to the attribute holds one common
                        `threading.Lock` (Eraser's lockset invariant;
                        asyncio locks do NOT count — they serialize
                        loop tasks, not OS threads).
  init-before-spawn   — writes inside `__init__` happen before any
                        thread the object spawns can observe them
                        (fork edge).
  queue/condition     — writes under a `threading.Condition` guard are
                        handoff-mediated (the Condition's lock IS the
                        lockset member, so this falls out of lock-held
                        once Condition counts as a lock ctor).
  immutable-after-publish / contextvar-scoped — frozen dataclasses and
                        `ContextVar.set()` never appear as attribute
                        rebinds, so they are sanctioned by construction
                        (documented, not detected).
  @handoff            — an explicit ownership-transfer seam
                        (annotations.py): the function establishes its
                        own happens-before edge (publish via future/
                        queue/journal) that the lockset cannot see.

Three rules, all chain-carrying and fingerprint-stable:

  unsynchronized-shared-mutation — an attribute (or module global)
      written from ≥ 2 execution domains with no common thread lock
      across the writes. Anchored at the first unguarded write.
  loop-state-from-thread — thread-domain code calling loop-affine
      scheduling surfaces (`.call_soon`, `.create_task`,
      `asyncio.ensure_future`, …) directly; `call_soon_threadsafe` /
      `run_coroutine_threadsafe` are the sanctioned crossings.
  coordinator-store-bypass — coordinator-domain code mutating a
      multi-process-reachable StateStore surface outside a @handoff
      persist-then-actuate seam.

Precision contract (docs/static-analysis.md): writes are syntactic
`self.x` rebinds and declared-global rebinds — container mutation
(`self.d[k] = v` mutates the dict, not the attribute binding) is out of
scope, as is aliasing through locals. Domains come from resolved call
edges only, so a callable handed to an external framework needs a
`@domain` pin to participate.
"""

from __future__ import annotations

import ast

from .domains import (COORDINATOR, LOOP, THREAD_DOMAINS, DomainMap,
                      infer_domains, is_handoff)
from .findings import Finding
from .visitor import terminal_name

#: path heads the shared-mutation/loop-affinity rules police (chaos/,
#: testing/, benchmarks/ double deliberately race or are single-process
#: test scaffolding; top-level production modules listed by filename —
#: their canonical path has no directory segment)
CONCURRENCY_RULE_SCOPES = (
    "runtime", "ops", "destinations", "postgres", "store", "supervision",
    "api", "telemetry", "parallel", "dlq", "fleet", "autoscale",
    "sharding", "replicator.py", "maintenance.py",
    "maintenance_coordination.py", "retry.py",
)

#: loop-affine scheduling surfaces: calling these from a worker thread
#: corrupts the loop's internal structures (asyncio documents them as
#: not thread-safe). `call_soon_threadsafe`/`run_coroutine_threadsafe`
#: are different terminals, so the sanctioned crossings never match.
LOOP_AFFINE_METHODS = frozenset({
    "call_soon", "call_later", "call_at", "create_task", "ensure_future",
})
LOOP_AFFINE_DOTTED = frozenset({
    "asyncio.create_task", "asyncio.ensure_future",
})

#: StateStore surfaces other PROCESSES act on (store/base.py): shard
#: fences, autoscale/fleet journals and specs. Mutating one outside a
#: persist-then-actuate @handoff seam lets a crashed coordinator leave
#: actuation and journal disagreeing — the exact split-brain the
#: journal protocol exists to prevent.
MULTIPROC_STORE_MUTATORS = frozenset({
    "update_shard_assignment", "update_autoscale_journal",
    "update_fleet_spec", "update_fleet_journal",
})

CONCURRENCY_RULE_NAMES = (
    "unsynchronized-shared-mutation",
    "loop-state-from-thread",
    "coordinator-store-bypass",
)


def _in_scope(path: str) -> bool:
    return path.split("/", 1)[0] in CONCURRENCY_RULE_SCOPES


def _own_class_name(fn) -> "str | None":
    scope = fn
    while scope is not None and scope.class_name is None:
        scope = scope.parent
    return scope.class_name if scope is not None else None


def _flatten_targets(node):
    if isinstance(node, (ast.Tuple, ast.List)):
        for el in node.elts:
            yield from _flatten_targets(el)
    elif isinstance(node, ast.Starred):
        yield from _flatten_targets(node.value)
    else:
        yield node


class _Write:
    """One attribute/global write site with its Eraser lockset."""

    __slots__ = ("fn", "node", "locks", "is_init", "domains")

    def __init__(self, fn, node, locks, is_init, domains):
        self.fn = fn
        self.node = node
        self.locks = locks  # frozenset of held THREAD-lock ids
        self.is_init = is_init
        self.domains = domains  # relevant domains reaching fn


def _walk_writes(fn, tables, on_write):
    """Walk `fn`'s own body tracking held THREAD locks; report every
    `self.x` rebind and declared-global rebind. Mirrors interproc's
    `_walk_holding` (nested defs own their activation and are skipped)
    but keys on assignment statements instead of calls/awaits."""
    globals_decl: set = set()
    body = getattr(fn.node, "body", None)
    if not isinstance(body, list):
        return

    def collect_globals(node):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            return  # nested defs declare their own globals
        if isinstance(node, ast.Global):
            globals_decl.update(node.names)
        for child in ast.iter_child_nodes(node):
            collect_globals(child)

    for stmt in body:
        collect_globals(stmt)

    def targets_of(node):
        if isinstance(node, ast.Assign):
            return node.targets
        if isinstance(node, (ast.AugAssign, ast.AnnAssign)):
            return (node.target,) if node.value is not None \
                or isinstance(node, ast.AugAssign) else ()
        return ()

    def walk(node, held):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            return
        if isinstance(node, (ast.With, ast.AsyncWith)):
            new_held = list(held)
            for item in node.items:
                walk(item.context_expr, new_held)
                lock = tables.identify(fn, item.context_expr)
                if lock is not None and not lock[1]:  # thread locks only
                    new_held = new_held + [lock[0]]
            for stmt in node.body:
                walk(stmt, new_held)
            return
        for tgt in targets_of(node):
            for el in _flatten_targets(tgt):
                if isinstance(el, ast.Attribute) \
                        and isinstance(el.value, ast.Name) \
                        and el.value.id == "self":
                    on_write(("self", el.attr), frozenset(held), node)
                elif isinstance(el, ast.Name) and el.id in globals_decl:
                    on_write(("global", el.id), frozenset(held), node)
        for child in ast.iter_child_nodes(node):
            walk(child, held)

    for stmt in body:
        walk(stmt, [])


def _domain_chain(dm: DomainMap, fn, sink_line=None):
    """(chain, chain_sites) from the thread-preferred witness, rendered
    exactly like interproc chains: last hop's site is the sink line in
    the reached function's own module. Depth-0 (the root IS the scope)
    collapses to empty per the chain convention."""
    w = dm.witness(fn)
    if w is None or len(w.chain) <= 1:
        return (), ()
    sites = w.chain_sites
    if sink_line is not None:
        sites = sites[:-1] + ((fn.module.path, sink_line),)
    return w.chain, sites


def _unsynchronized_shared_mutation(project, dm, tables, supp):
    relevant = THREAD_DOMAINS | {LOOP}
    findings: list[Finding] = []
    for path in sorted(project.modules):
        if not _in_scope(path):
            continue
        m = project.modules[path]
        writes: dict = {}  # (class|<module>, attr) -> [_Write]
        for qual in sorted(m.functions):
            fn = m.functions[qual]
            doms = dm.of(fn) & relevant
            if not doms or is_handoff(fn):
                continue
            cls = _own_class_name(fn)
            is_init = qual == (f"{cls}.__init__" if cls else "__init__")

            def on_write(key, locks, node, fn=fn, cls=cls,
                         is_init=is_init, doms=doms):
                kind, name = key
                owner = cls if kind == "self" else "<module>"
                if kind == "self" and cls is None:
                    return  # `self` outside a class: not shared state
                writes.setdefault((owner, name), []).append(
                    _Write(fn, node, locks, is_init, doms))

            _walk_writes(fn, tables, on_write)
        for (owner, attr) in sorted(writes):
            sites = writes[(owner, attr)]
            live = [w for w in sites if not w.is_init]
            if not live:
                continue  # init-before-spawn: all writes precede fork
            doms = frozenset().union(*(w.domains for w in live))
            if len(doms) < 2:
                continue
            lockset = frozenset.intersection(*(w.locks for w in live))
            if lockset:
                continue  # Eraser invariant holds: a common thread lock
            live.sort(key=lambda w: (w.node.lineno, w.node.col_offset))
            anchor = next((w for w in live if not w.locks), live[0])
            line = anchor.node.lineno
            s = supp.get(path)
            if s is not None and s.suppresses(
                    "unsynchronized-shared-mutation", line):
                continue
            detail = f"{owner}.{attr}"
            chain, chain_sites = _domain_chain(dm, anchor.fn, line)
            findings.append(Finding(
                rule="unsynchronized-shared-mutation", path=path,
                line=line, col=anchor.node.col_offset + 1,
                scope=anchor.fn.qualname, detail=detail,
                message=f"`{detail}` is written from domains "
                        f"{{{', '.join(sorted(doms))}}} with no common "
                        f"thread lock — hold one threading.Lock at every "
                        f"write, hand off through a queue/future, or mark "
                        f"the ownership-transfer seam @handoff",
                chain=chain, chain_sites=chain_sites))
    return findings


def _loop_state_from_thread(project, dm, supp):
    findings: list[Finding] = []
    for fn in list(project.iter_functions()):
        path = fn.module.path
        if not _in_scope(path):
            continue
        tdoms = dm.of(fn) & THREAD_DOMAINS
        if not tdoms or is_handoff(fn):
            continue
        for site in fn.calls:
            subject = None
            if site.external in LOOP_AFFINE_DOTTED:
                subject = site.external
            else:
                term = terminal_name(site.node.func)
                if term in LOOP_AFFINE_METHODS \
                        and isinstance(site.node.func, ast.Attribute):
                    subject = f".{term}"
            if subject is None:
                continue
            s = supp.get(path)
            if s is not None and s.suppresses(
                    "loop-state-from-thread", site.line):
                continue
            chain, chain_sites = _domain_chain(dm, fn, site.line)
            findings.append(Finding(
                rule="loop-state-from-thread", path=path,
                line=site.line, col=site.col + 1,
                scope=fn.qualname, detail=subject,
                message=f"`{subject}` called from thread domain"
                        f"{{{', '.join(sorted(tdoms))}}} — asyncio's "
                        f"scheduling surfaces are not thread-safe; cross "
                        f"with call_soon_threadsafe()/"
                        f"run_coroutine_threadsafe(), or resolve a "
                        f"future the loop awaits",
                chain=chain, chain_sites=chain_sites))
    return findings


def _coordinator_store_bypass(project, dm, supp):
    findings: list[Finding] = []
    for fn in list(project.iter_functions()):
        path = fn.module.path
        if COORDINATOR not in dm.of(fn) or is_handoff(fn):
            continue
        for site in fn.calls:
            term = terminal_name(site.node.func)
            if term not in MULTIPROC_STORE_MUTATORS \
                    or not isinstance(site.node.func, ast.Attribute):
                continue
            s = supp.get(path)
            if s is not None and s.suppresses(
                    "coordinator-store-bypass", site.line):
                continue
            subject = f".{term}"
            w = dm.info(fn, COORDINATOR)
            chain = w.chain if w is not None and len(w.chain) > 1 else ()
            sites = ()
            if chain:
                sites = w.chain_sites[:-1] + ((path, site.line),)
            findings.append(Finding(
                rule="coordinator-store-bypass", path=path,
                line=site.line, col=site.col + 1,
                scope=fn.qualname, detail=subject,
                message=f"`{subject}` mutates a multi-process-reachable "
                        f"StateStore surface from the coordinator domain "
                        f"outside a persist-then-actuate seam — route the "
                        f"write through the @handoff journal method so a "
                        f"crash cannot leave actuation and journal "
                        f"disagreeing",
                chain=chain, chain_sites=sites))
    return findings


def analyze_concurrency(project, supp) -> list[Finding]:
    """The concurrency tier over an already-built Project. `supp` maps
    module path → Suppressions, as in analyze_interprocedural."""
    from .interproc import _LockTables  # deferred: interproc calls us

    dm = infer_domains(project)
    tables = _LockTables(project)
    findings: list[Finding] = []
    findings += _unsynchronized_shared_mutation(project, dm, tables, supp)
    findings += _loop_state_from_thread(project, dm, supp)
    findings += _coordinator_store_bypass(project, dm, supp)
    return findings
