"""Execution-domain inference for the concurrency tier.

The runtime spans five execution domains, and every concurrency rule
starts from knowing which of them can reach a given function:

  loop        — the asyncio event loop: every `async def`, plus every
                sync function a loop task calls inline.
  worker      — a dedicated `threading.Thread(target=…)`: the decode
                pipeline worker, the bg-compile threads.
  executor    — `loop.run_in_executor(…)` / `asyncio.to_thread(…)`
                offloads: pool threads running one callable.
  sweep       — supervision-owned threads (a thread spawned from a
                `supervision/` module): liveness sweeps, monitors.
  coordinator — out-of-process control loops (fleet/autoscale/shard)
                acting on shared state THROUGH the StateStore; rooted
                at `@control_loop` ticks and `@domain("coordinator")`
                pins, since the spawning process manager is outside
                the scanned tree.

Inference propagates from roots along RESOLVED call edges, exactly the
edge semantics of contexts.py: a call into a sync project function
executes in the caller's domain; a call into an async function runs in
the caller's domain only when awaited; function REFERENCES are never
edges — handing a callable to `Thread(target=…)`/`to_thread` does not
leak the spawner's domain into the target, it roots the target in the
spawned domain instead. Spawn targets resolve through
`functools.partial` wrappers, and INLINE lambda targets — which the
callgraph deliberately leaves unowned — get a synthesized FunctionInfo
here so the lambda's body propagates like any other function.

`@domain("…")` (analysis/annotations.py) pins a function: incoming
propagation of any OTHER domain is ignored (recorded as a conflict for
introspection), while the pinned domain still propagates outward.

Domains are not exclusive — a function called from a loop task and a
worker thread holds both, which is precisely the situation the race
rules exist to interrogate. Traversal is BFS with per-(function,
domain) visited marking, so each witness chain is shortest and
deterministic (call sites visit in (line, col) order, roots in
project iteration order); cycles — including cycles through a
thread-spawn edge back into the spawner — terminate via the visited
set.
"""

from __future__ import annotations

import ast
from collections import deque

from .callgraph import CallSite, FunctionInfo, Project
from .visitor import dotted_name, terminal_name

LOOP = "loop"
WORKER = "worker"
EXECUTOR = "executor"
SWEEP = "sweep"
COORDINATOR = "coordinator"

#: stable presentation/priority order (thread domains first so witness
#: selection for race findings prefers the thread side of a conflict)
DOMAIN_ORDER = (WORKER, EXECUTOR, SWEEP, LOOP, COORDINATOR)

#: domains whose code runs on a real OS thread other than the loop's —
#: a write reachable from one of these plus any second domain is a
#: cross-thread write and needs a THREAD lock (asyncio locks only
#: serialize loop tasks)
THREAD_DOMAINS = frozenset({WORKER, EXECUTOR, SWEEP})

#: chain-length bound: propagation beyond this depth adds no new
#: information (the repo's deepest real chains are < 15 hops)
_MAX_DEPTH = 25


class DomainInfo:
    """Why one function holds one domain: the witness chain proving it."""

    __slots__ = ("domain", "chain", "chain_sites", "origin")

    def __init__(self, domain: str, chain: tuple, chain_sites: tuple,
                 origin: str):
        self.domain = domain
        self.chain = chain  # qualnames, root first, this fn last
        self.chain_sites = chain_sites  # (path, line) per hop
        self.origin = origin  # human-readable root cause


class DomainMap:
    """fn → {domain → DomainInfo}, plus pins and override conflicts."""

    def __init__(self):
        self._info: dict[int, dict[str, DomainInfo]] = {}
        self._fns: dict[int, FunctionInfo] = {}
        #: id(fn) → pinned domain name (from @domain("…"))
        self.pins: dict[int, str] = {}
        #: (fn, pinned, rejected domain, witness chain) — incoming
        #: propagation a pin overrode; introspection only, not findings
        self.conflicts: list = []

    def of(self, fn: FunctionInfo) -> frozenset:
        return frozenset(self._info.get(id(fn), ()))

    def info(self, fn: FunctionInfo, domain: str) -> "DomainInfo | None":
        return self._info.get(id(fn), {}).get(domain)

    def witness(self, fn: FunctionInfo,
                prefer=DOMAIN_ORDER) -> "DomainInfo | None":
        """One deterministic witness, thread domains preferred."""
        held = self._info.get(id(fn), {})
        for d in prefer:
            if d in held:
                return held[d]
        return None

    def items(self):
        """(fn, sorted domain names) in stable project order."""
        fns = sorted(self._fns.values(),
                     key=lambda f: (f.module.path, f.qualname))
        for fn in fns:
            yield fn, sorted(self._info[id(fn)])

    def _record(self, fn: FunctionInfo, info: DomainInfo) -> bool:
        cur = self._info.setdefault(id(fn), {})
        if info.domain in cur:
            return False
        self._fns[id(fn)] = fn
        cur[info.domain] = info
        return True


def pinned_domain(fn: FunctionInfo) -> "str | None":
    """The @domain("…") pin on `fn`, decorator name alias-resolved."""
    for dec in getattr(fn.node, "decorator_list", []):
        if not isinstance(dec, ast.Call) or not dec.args:
            continue
        d = dotted_name(dec.func)
        if d is None:
            continue
        head, _, rest = d.partition(".")
        imported = fn.module.imports.get(head)
        resolved = ((f"{imported}.{rest}" if rest else imported)
                    if imported is not None else d)
        if resolved.rsplit(".", 1)[-1] != "domain":
            continue
        arg = dec.args[0]
        if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
            return arg.value
    return None


def is_handoff(fn: FunctionInfo) -> bool:
    """`fn` or an enclosing def carries @handoff (alias-resolved)."""
    scope = fn
    while scope is not None:
        if "handoff" in scope.decorators:
            return True
        scope = scope.parent
    return False


def _kwarg(call: ast.Call, name: str) -> "ast.AST | None":
    for kw in call.keywords:
        if kw.arg == name:
            return kw.value
    return None


def _posarg(call: ast.Call, idx: int) -> "ast.AST | None":
    return call.args[idx] if len(call.args) > idx else None


def _qualify(fn: FunctionInfo, expr: ast.AST) -> "str | None":
    """Import-resolved dotted name of `expr` (like Project._ctor_name)."""
    d = dotted_name(expr)
    if d is None:
        return None
    head, _, rest = d.partition(".")
    target = fn.module.imports.get(head)
    if target is not None:
        return f"{target}.{rest}" if rest else target
    return d


def spawn_targets(fn: FunctionInfo):
    """(domain, target expr, spawn site) per spawn/offload call in `fn`.

    A thread spawned from a supervision/ module is the SWEEP domain —
    supervision owns those threads and their restart discipline; every
    other `threading.Thread` is WORKER. `run_in_executor`/`to_thread`
    targets are EXECUTOR regardless of spawner."""
    head = fn.module.path.split("/", 1)[0]
    thread_domain = SWEEP if head == "supervision" else WORKER
    for site in fn.calls:
        node = site.node
        if site.external == "threading.Thread":
            expr = _kwarg(node, "target") or _posarg(node, 1)
            if expr is not None:
                yield thread_domain, expr, site
            continue
        if site.external == "asyncio.to_thread":
            expr = _posarg(node, 0) or _kwarg(node, "func")
            if expr is not None:
                yield EXECUTOR, expr, site
            continue
        term = terminal_name(node.func)
        if term == "run_in_executor" and isinstance(node.func, ast.Attribute):
            # loop.run_in_executor(executor, fn, *args)
            expr = _posarg(node, 1)
            if expr is not None:
                yield EXECUTOR, expr, site


def _synthesize_lambda(project: Project, fn: FunctionInfo,
                       expr: ast.Lambda) -> FunctionInfo:
    """Inline lambda spawn targets get a FunctionInfo of their own —
    the callgraph leaves anonymous lambdas unowned, but a lambda handed
    to a thread IS the thread's entry point and its body's calls must
    propagate the spawned domain."""
    qual = f"{fn.qualname}.<lambda@{expr.lineno}:{expr.col_offset}>"
    m = fn.module
    existing = m.functions.get(qual)
    if existing is not None:
        return existing
    lam = FunctionInfo(m, qual, expr, False, fn.class_name, fn)
    m.functions[qual] = lam
    project._collect_calls(lam)
    return lam


def resolve_target(project: Project, fn: FunctionInfo,
                   expr: "ast.AST | None",
                   depth: int = 0) -> "FunctionInfo | None":
    """A spawn-target expression → the project function it names, or
    None for externals/unresolvable receivers. Unwraps
    `functools.partial(f, …)` to `f`; synthesizes inline lambdas."""
    if expr is None or depth > 3:
        return None
    if isinstance(expr, ast.Lambda):
        return _synthesize_lambda(project, fn, expr)
    if isinstance(expr, ast.Call):
        qualified = _qualify(fn, expr.func)
        if qualified in ("functools.partial", "partial"):
            return resolve_target(project, fn, _posarg(expr, 0), depth + 1)
        return None
    if dotted_name(expr) is None:
        return None
    fake = ast.Call(func=expr, args=[], keywords=[])
    ast.copy_location(fake, expr)
    site = CallSite(fake, dotted_name(expr), False)
    project._resolve_call(fn, site)
    return site.resolved


def infer_domains(project: Project) -> DomainMap:
    """Classify every reachable function into execution domains."""
    dm = DomainMap()
    roots: list = []  # (fn, domain, origin)

    # intrinsic roots: pins, async defs, coordinator ticks
    for fn in list(project.iter_functions()):
        pin = pinned_domain(fn)
        if pin is not None:
            dm.pins[id(fn)] = pin
            roots.append((fn, pin, "@domain pin"))
        if fn.is_async:
            roots.append((fn, LOOP, "async def"))
        if "control_loop" in fn.decorators:
            roots.append((fn, COORDINATOR, "@control_loop"))

    # spawn roots: walk a worklist so targets synthesized along the way
    # (inline lambdas) get THEIR spawn sites scanned too
    processed: set = set()
    queue = deque(project.iter_functions())
    while queue:
        fn = queue.popleft()
        if id(fn) in processed:
            continue
        processed.add(id(fn))
        for domain, expr, site in spawn_targets(fn):
            target = resolve_target(project, fn, expr)
            if target is None:
                continue
            origin = f"spawned at {fn.module.path}:{site.line}"
            roots.append((target, domain, origin))
            queue.append(target)

    # BFS propagation with witness chains
    work = deque()
    for fn, domain, origin in roots:
        work.append((fn, domain,
                     (fn.qualname,), ((fn.module.path, fn.line),), origin))
    while work:
        fn, domain, chain, sites, origin = work.popleft()
        pin = dm.pins.get(id(fn))
        if pin is not None and domain != pin:
            dm.conflicts.append((fn, pin, domain, chain))
            continue
        if not dm._record(fn, DomainInfo(domain, chain, sites, origin)):
            continue
        if len(chain) > _MAX_DEPTH:
            continue
        for site in fn.calls:
            callee = site.resolved
            if callee is None or callee is fn:
                continue
            if callee.is_async and not site.awaited:
                continue  # builds a coroutine; does not run here
            work.append((
                callee, domain, chain + (callee.qualname,),
                sites[:-1] + ((fn.module.path, site.line),
                              (callee.module.path, callee.line)),
                origin))
    return dm
