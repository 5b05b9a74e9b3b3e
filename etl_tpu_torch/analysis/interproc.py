"""Whole-program (interprocedural) analysis pass.

Runs after the per-module lexical pass over the same parsed trees.
Three upgraded rules and four new ones:

  - `blocking-call-in-async`, `device-sync-in-async`,
    `hot-loop-host-transfer` go TRANSITIVE: a sink anywhere in the call
    closure of an event-loop `async def` / `@hot_loop` function is
    reported with the full call chain (`a → b → c: time.sleep`). Wrapping
    the sink in a helper one file away no longer defeats the rule, and
    import aliasing (`from time import sleep`) is resolved — the hole
    annotations.py used to document is closed.
  - `arena-lease-leak` — a `StagingArenaPool` lease acquired on a path
    that can exit the function without `release()` (the static twin of
    chaos's `ARENA_POOL.outstanding` invariant).
  - `donated-buffer-use` — the port's counterpart of a donation: a
    tensor that is the destination of `.copy_(…, non_blocking=True)` is
    read on the host before an event's or a stream's `synchronize()` /
    `wait_event` on the path: the copy engine still owns its bytes, so
    the read sees whatever the buffer held before.
  - `lock-held-across-await` — an `await` while an asyncio
    Lock/Semaphore is held, outside the sanctioned own-resource idiom
    (docs/CONCURRENCY.md); plus ANY await under a sync `threading.Lock`,
    which parks the whole event loop on a mutex.
  - `lock-order-inversion` — two locks acquired in opposite orders on
    different call paths (lock-set reasoning over the call graph).

Precision contract (documented in docs/static-analysis.md): transitive
sink sets are restricted to calls that DEFINITELY synchronize
(`.item()` / `.tolist()`, which numpy values have too, stay
lexical-only); receiver-typed
calls (`obj.m()` on unknown `obj`) are not traversed; escape of a lease
variable (passed/returned/stored) transfers ownership and ends tracking.

Findings fingerprint as (rule, entry module, entry scope, sink subject)
— stable under intermediate-helper renames — and anchor at the entry
function's own call site, which is also where an inline
`# etl-lint: ignore[...]` applies.
"""

from __future__ import annotations

import ast

from .callgraph import HOT_DECORATOR, Project, nonblocking_copy_target
from .cfg import CFG, EXC_EXIT, EXIT, dataflow_forward
from .contexts import async_entries, hot_entries, reach_from
from .findings import Finding
from .rules import device_method, imports_torch
from .visitor import Suppressions, dotted_name, terminal_name

#: transitive sinks for device-sync/hot-loop rules: DEFINITE device
#: synchronization only. `.item()` / `.tolist()` are host-ambiguous
#: (numpy scalars and arrays have them, and most sync numpy helpers
#: reachable from async code legitimately use them) and stay
#: lexical-only — the documented precision trade.
DEVICE_SYNC_TRANSITIVE = frozenset({
    "torch.cuda.synchronize",
    "autotune.measure", "autotune.resolve_device_min_rows",
})
HOT_TRANSFER_TRANSITIVE = frozenset({
    "torch.cuda.synchronize",
    # the probe builds and times the kernels over the link — reaching it
    # from a @hot_loop function is a per-batch transfer storm
    "autotune.measure", "autotune.resolve_device_min_rows",
})
#: method sinks past depth 0: the definite ones. `.numpy()` is not among
#: them — it raises on a CUDA tensor, so where it runs it reads host
#: memory (a pinned buffer, the host route's CPU tensors)
SYNC_METHOD_SINKS = frozenset({".cpu", ".to(cpu)", ".synchronize", ".copy_",
                               ".cuda", ".to(device)",
                               ".copy_(non_blocking)"})

#: project-function sinks (module path, qualname): hit when a call
#: resolves to the function itself no matter how it was imported/aliased
HOT_TRANSFER_PROJECT_SINKS = frozenset({
    ("ops/autotune.py", "measure"),
    ("ops/autotune.py", "resolve_device_min_rows"),
})
#: rule 2 adds the builds (the reference's `jax.jit`), as its lexical set
#: does; rule 6 leaves them out, as the reference's leaves out `jax.jit`
DEVICE_SYNC_PROJECT_SINKS = HOT_TRANSFER_PROJECT_SINKS | frozenset({
    # a kernel library's load: an nvcc build when the store is cold (the
    # store's own `acquire` also serves the C framer's cc build, which is
    # host work, so the kernel modules' entries are the sinks)
    ("ops/decode_kernel.py", "load"), ("ops/decode_kernel.py", "load_library"),
    ("ops/egress_kernel.py", "load"), ("ops/egress_kernel.py", "load_library"),
})

#: awaits sanctioned while holding a lock when the awaited call's
#: receiver chain is rooted at one of these (after unwrapping wait_for)
_AWAIT_WRAPPERS = frozenset({"wait_for", "shield"})

#: directories whose locks the await-holding rule polices (testing/ and
#: chaos/ doubles deliberately hold locks in ways production must not)
LOCK_RULE_SCOPES = ("runtime", "destinations", "postgres", "store",
                    "supervision", "api", "ops")


class ModuleUnit:
    """One module's inputs to the whole-program pass."""

    __slots__ = ("path", "source", "tree", "suppressions")

    def __init__(self, path: str, source: str, tree: ast.Module,
                 suppressions: Suppressions):
        self.path = path
        self.source = source
        self.tree = tree
        self.suppressions = suppressions


def analyze_interprocedural(units: "list[ModuleUnit]") -> list[Finding]:
    from .concurrency import analyze_concurrency  # deferred: imports us

    project = Project.build([(u.path, u.source, u.tree) for u in units])
    supp = {u.path: u.suppressions for u in units}
    findings: list[Finding] = []
    findings += _transitive_blocking(project, supp)
    findings += _transitive_device_sync(project, supp)
    findings += _transitive_hot_transfer(project, supp)
    findings += _arena_lease_leak(project, supp)
    findings += _donated_buffer_use(project, supp)
    findings += _lock_held_across_await(project, supp)
    findings += _lock_order_inversion(project, supp)
    findings += analyze_concurrency(project, supp)
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule, f.detail))
    return findings


# -- shared helpers -----------------------------------------------------------


def _sink_subject(site, lexical_set, transitive_set, bare_set=frozenset(),
                  method_set=frozenset(), project_sinks=frozenset(),
                  depth0: bool = False,
                  torch_module: bool = True) -> "str | None":
    """The matched sink name, or None. Depth-0 sites match the FULL
    lexical sets (alias-resolved) — the entry's own async context makes
    even ambiguous sinks suspect, mirroring the lexical rule; deeper
    sites match only the curated transitive set."""
    allowed = lexical_set if depth0 else transitive_set
    if site.resolved is not None:
        key = (site.resolved.module.path, site.resolved.qualname)
        if key in project_sinks:
            return site.resolved.qualname
    for name in (site.external, site.lexical):
        if name is not None and name in allowed:
            return name
    if site.external is None and site.lexical in bare_set \
            and isinstance(site.node.func, ast.Name):
        return site.lexical
    subject = device_method(site.node, torch_module)
    return subject if subject in method_set else None


def _lexically_visible(site, lexical_set, bare_set=frozenset(),
                       method_set=frozenset()) -> bool:
    """Would the per-module lexical rule already report this site? Used
    to keep depth-0 interprocedural findings (alias-resolution catches)
    from duplicating lexical ones."""
    if site.lexical in lexical_set or site.lexical in bare_set:
        return True
    return device_method(site.node) in method_set


def _emit_chain(findings, supp, rule, reached, site, subject, message):
    """One chain-carrying finding anchored in the entry function."""
    entry = reached.entry
    anchor = reached.anchor if reached.anchor is not None else site
    line, col = anchor.line, anchor.col
    s = supp.get(entry.module.path)
    if s is not None and s.suppresses(rule, line):
        return
    chain = reached.chain
    sites = reached.chain_sites[:-1] + (
        (reached.fn.module.path, site.line),)
    if len(chain) == 1:
        chain, sites = (), ()  # depth-0: the scope IS the chain
    findings.append(Finding(
        rule=rule, path=entry.module.path, line=line, col=col,
        scope=entry.qualname, detail=subject, message=message,
        chain=chain, chain_sites=sites))


def _dedupe(findings: list[Finding]) -> list[Finding]:
    seen = set()
    out = []
    for f in findings:
        key = (f.rule, f.path, f.scope, f.detail, f.line, f.col)
        if key not in seen:
            seen.add(key)
            out.append(f)
    return out


# -- upgraded rules 1/2/6 -----------------------------------------------------


def _transitive_blocking(project, supp) -> list[Finding]:
    from .rules import BLOCKING_BARE, BLOCKING_DOTTED, EVENT_LOOP_SCOPES

    def follow_await(callee) -> bool:
        # an awaited async callee in an event-loop dir is its own entry;
        # following into OTHER dirs keeps coverage for e.g. an ops/
        # helper coroutine awaited from runtime/ without double-reporting
        return callee.module.path.split("/", 1)[0] not in EVENT_LOOP_SCOPES

    findings: list[Finding] = []
    for entry in async_entries(project, EVENT_LOOP_SCOPES):
        for r in reach_from(entry, follow_await=follow_await):
            depth0 = r.fn is entry
            for site in r.fn.calls:
                subject = _sink_subject(
                    site, BLOCKING_DOTTED, BLOCKING_DOTTED,
                    bare_set=BLOCKING_BARE, depth0=depth0)
                if subject is None:
                    continue
                if depth0 and _lexically_visible(
                        site, BLOCKING_DOTTED, BLOCKING_BARE):
                    continue  # the lexical rule already reports it
                _emit_chain(
                    findings, supp, "blocking-call-in-async", r, site,
                    subject,
                    f"blocking call `{subject}` reachable on the event "
                    f"loop via `{' → '.join(r.chain)}` stalls replication "
                    f"keepalives; route the chain off-loop "
                    f"(run_in_executor) or use the async equivalent")
    return _dedupe(findings)


def _transitive_device_sync(project, supp) -> list[Finding]:
    from .rules import (DEVICE_SYNC_DOTTED, DEVICE_SYNC_METHODS,
                        DISPATCH_UPLOADS)

    def prune(site, callee) -> bool:
        # a call that IS the sink (the autotune probe, a library build)
        # gets reported at
        # the call; its internals would only re-describe the same cause
        return (callee.module.path, callee.qualname) \
            in DEVICE_SYNC_PROJECT_SINKS

    findings: list[Finding] = []
    for entry in async_entries(project):
        for r in reach_from(entry, prune=prune):
            depth0 = r.fn is entry
            for site in r.fn.calls:
                subject = _sink_subject(
                    site, DEVICE_SYNC_DOTTED, DEVICE_SYNC_TRANSITIVE,
                    method_set=(DEVICE_SYNC_METHODS if depth0
                                else SYNC_METHOD_SINKS),
                    project_sinks=DEVICE_SYNC_PROJECT_SINKS,
                    depth0=depth0, torch_module=imports_torch(
                        r.fn.module.tree, r.fn.module.source))
                if subject is None:
                    continue
                if depth0 and _lexically_visible(
                        site, DEVICE_SYNC_DOTTED,
                        method_set=DEVICE_SYNC_METHODS):
                    continue
                if r.dispatch and subject in DISPATCH_UPLOADS:
                    continue  # an upload riding the pipeline
                _emit_chain(
                    findings, supp, "device-sync-in-async", r, site,
                    subject,
                    f"device sync point `{subject}` reachable from async "
                    f"code via `{' → '.join(r.chain)}` blocks the event "
                    f"loop on the host<->device link; dispatch and hand "
                    f"back a pending handle, or run the chain in an "
                    f"executor")
    return _dedupe(findings)


def _transitive_hot_transfer(project, supp) -> list[Finding]:
    from .rules import (DISPATCH_UPLOADS, HOT_TRANSFER_DOTTED,
                        HOT_TRANSFER_METHODS)

    def prune(site, callee) -> bool:
        return (callee.module.path, callee.qualname) \
            in HOT_TRANSFER_PROJECT_SINKS

    findings: list[Finding] = []
    for entry in hot_entries(project):
        for r in reach_from(entry, prune=prune):
            depth0 = r.fn is entry
            for site in r.fn.calls:
                subject = _sink_subject(
                    site, HOT_TRANSFER_DOTTED, HOT_TRANSFER_TRANSITIVE,
                    method_set=(HOT_TRANSFER_METHODS if depth0
                                else SYNC_METHOD_SINKS),
                    project_sinks=HOT_TRANSFER_PROJECT_SINKS,
                    depth0=depth0, torch_module=imports_torch(
                        r.fn.module.tree, r.fn.module.source))
                if subject is None:
                    continue
                # the lexical rule reports depth-0 sinks only when it
                # could SEE the hot context: an aliased decorator
                # (`@hl`) defeats it, so the resolver must not defer
                lexically_hot = bool(entry.lex_decorators
                                     & {HOT_DECORATOR})
                if depth0 and lexically_hot and _lexically_visible(
                        site, HOT_TRANSFER_DOTTED,
                        method_set=HOT_TRANSFER_METHODS):
                    continue
                if r.dispatch and subject in DISPATCH_UPLOADS:
                    continue
                _emit_chain(
                    findings, supp, "hot-loop-host-transfer", r, site,
                    subject,
                    f"host transfer `{subject}` reachable from @hot_loop "
                    f"code via `{' → '.join(r.chain)}` serializes the hot "
                    f"path against the device link; fetch at the consumer "
                    f"(_PendingDecode.result) instead")
    return _dedupe(findings)


# -- rule: arena-lease-leak ---------------------------------------------------


def _is_lease_call(value) -> bool:
    return (isinstance(value, ast.Call)
            and terminal_name(value.func) == "lease"
            and isinstance(value.func, ast.Attribute)
            and not value.args and not value.keywords)


def _stmt_names(stmt):
    """(loads, stores, receiver_uses) of bare Names at one CFG node —
    compound statements contribute only their header (cfg.header_roots);
    nested callables are their own activation and are skipped. A Name
    that is the receiver of an attribute access (`x.release()`,
    `x.take(...)`) is a receiver use, not a value load — method calls on
    a lease keep ownership local."""
    from .cfg import header_roots

    loads, stores, receivers = [], [], []
    parents: dict[int, ast.AST] = {}
    nodes = []
    stack = list(header_roots(stmt))
    while stack:
        node = stack.pop()
        if node is not stmt and isinstance(
                node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            continue
        nodes.append(node)
        for child in ast.iter_child_nodes(node):
            parents[id(child)] = node
            stack.append(child)
    for node in nodes:
        if not isinstance(node, ast.Name):
            continue
        parent = parents.get(id(node))
        if isinstance(node.ctx, ast.Store):
            stores.append(node.id)
        elif isinstance(parent, ast.Attribute) and parent.value is node:
            receivers.append((node.id, parent))
        else:
            loads.append(node.id)
    return loads, stores, receivers


def _iter_own_stmts(fn):
    """Every statement lexically in `fn`, excluding nested callables."""
    body = getattr(fn.node, "body", None)
    if not isinstance(body, list):
        return
    stack = list(body)
    while stack:
        stmt = stack.pop()
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        yield stmt
        for child in ast.iter_child_nodes(stmt):
            if isinstance(child, ast.stmt):
                stack.append(child)
            elif hasattr(child, "body") and isinstance(
                    getattr(child, "body", None), list):
                stack.extend(s for s in child.body
                             if isinstance(s, ast.stmt))


def _releases_in(stmt) -> set:
    from .cfg import iter_header_nodes

    out = set()
    for node in iter_header_nodes(stmt):
        if isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and node.func.attr == "release" \
                and isinstance(node.func.value, ast.Name):
            out.add(node.func.value.id)
    return out


def _arena_lease_leak(project, supp) -> list[Finding]:
    findings: list[Finding] = []
    for fn in project.iter_functions():
        acquires: list[tuple[ast.stmt, str]] = []
        for stmt in _iter_own_stmts(fn):
            if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                    and isinstance(stmt.targets[0], ast.Name) \
                    and _is_lease_call(stmt.value):
                acquires.append((stmt, stmt.targets[0].id))
        if not acquires:
            continue
        escaped = _leak_escapes(fn, acquires)
        tracked = [(s, v) for (s, v) in acquires if v not in escaped]
        if not tracked:
            continue
        cfg = CFG(fn.node)
        acq_ids = {id(s): (s, v) for (s, v) in tracked}

        def transfer(node, state, _ids=acq_ids):
            if not isinstance(node, ast.stmt):
                return state
            out = set(state)
            released = _releases_in(node)
            if released:
                out = {a for a in out if _ids[a][1] not in released}
            _loads, stores, _recv = _stmt_names(node)
            if stores:  # reassignment of the lease var drops tracking
                out = {a for a in out if _ids[a][1] not in stores}
            if id(node) in _ids:  # gen after kill: `x = pool.lease()`
                out.add(id(node))
            return frozenset(out)

        def exc_transfer(node, state, _ids=acq_ids):
            # exception paths: a raising `x = pool.lease()` did NOT
            # acquire (no gen), but a release that ran still released —
            # without this, the release statement's own exception edge
            # would resurrect the lease and flag every finally block
            if not isinstance(node, ast.stmt):
                return state
            released = _releases_in(node)
            if released:
                return frozenset(a for a in state
                                 if _ids[a][1] not in released)
            return state

        in_states = dataflow_forward(cfg, transfer,
                                     exc_transfer=exc_transfer)
        live_exit = in_states.get(EXIT, frozenset())
        live_exc = in_states.get(EXC_EXIT, frozenset())
        for a in sorted(live_exit | live_exc,
                        key=lambda a: acq_ids[a][0].lineno):
            stmt, var = acq_ids[a]
            s = supp.get(fn.module.path)
            if s is not None and s.suppresses("arena-lease-leak",
                                              stmt.lineno):
                continue
            where = "on a normal path" if a in live_exit \
                else "when an exception escapes"
            findings.append(Finding(
                rule="arena-lease-leak", path=fn.module.path,
                line=stmt.lineno, col=stmt.col_offset + 1,
                scope=fn.qualname, detail=var,
                message=f"arena lease `{var}` can reach function exit "
                        f"{where} without release(); put the release in "
                        f"a finally/with (or hand the lease off "
                        f"explicitly) — leaked leases pin pool arenas "
                        f"forever (ARENA_POOL.outstanding)"))
    return findings


#: method terminals that STORE their argument (container inserts,
#: future/queue hand-offs): a lease passed to one of these escapes —
#: some later consumer owns the release now
_HANDOFF_TERMINALS = frozenset({
    "append", "appendleft", "add", "insert", "extend", "put",
    "put_nowait", "set_result", "send", "send_nowait", "setdefault",
})


def _leak_escapes(fn, acquires) -> set:
    """Lease variables whose ownership TRANSFERS out of the function:
    returned/yielded, stored into a container or attribute/subscript,
    aliased to another name, or passed to a storing method
    (`self._pending.append(lease)`, `queue.put_nowait(lease)`,
    `fut.set_result(lease)`). Passing the lease as any OTHER call
    argument is a BORROW (the pack stage writes into it; the caller
    still releases) — the distinction that keeps the real pipeline
    pattern `decoder._pack_stage(staged, arena=lease)` tracked while
    `handle.set_result((pending, lease))` correctly hands off."""
    escaped: set[str] = set()
    names = {v for (_s, v) in acquires}
    for stmt in _iter_own_stmts(fn):
        parents: dict[int, ast.AST] = {}
        stack = [stmt]
        while stack:
            node = stack.pop()
            if node is not stmt and isinstance(
                    node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            for child in ast.iter_child_nodes(node):
                parents[id(child)] = node
                stack.append(child)
        for node in ast.walk(stmt):
            if not isinstance(node, ast.Name) or node.id not in names \
                    or not isinstance(node.ctx, ast.Load):
                continue
            if any(s is stmt for (s, v) in acquires if v == node.id):
                continue  # the acquiring statement itself
            parent = parents.get(id(node))
            if isinstance(parent, ast.Attribute) and parent.value is node:
                continue  # receiver use: x.take()/x.release()
            if isinstance(parent, ast.Call):
                if terminal_name(parent.func) in _HANDOFF_TERMINALS:
                    escaped.add(node.id)  # stored for a later consumer
                continue  # otherwise borrowed: plain positional argument
            if isinstance(parent, ast.keyword):
                continue  # borrowed: keyword argument
            if isinstance(parent, ast.Compare):
                continue  # identity/None checks don't move ownership
            escaped.add(node.id)
    return escaped


# -- rule: donated-buffer-use -------------------------------------------------

#: calls that order the host after the stream: an Event's or a Stream's
#: `synchronize()` (and `torch.cuda.synchronize`), `wait_event` /
#: `wait_stream` (the waiting stream's later work, a D2H fetch included)
_STREAM_SYNC_TERMINALS = frozenset({"synchronize", "wait_event",
                                    "wait_stream"})
#: attribute uses of an in-flight destination that read no bytes: another
#: enqueued copy into it, a stream hand-off, and metadata
_NON_READ_ATTRS = frozenset({"copy_", "record_stream", "shape", "dtype",
                             "device", "is_pinned", "data_ptr"})
#: external call heads whose arguments are read on the host at the call
_HOST_READ_HEADS = frozenset({"np", "numpy", "torch", "bytes", "bytearray",
                              "memoryview", "list", "tuple", "sum"})


def _is_stream_sync(stmt) -> bool:
    from .cfg import header_roots

    for root in header_roots(stmt):
        for node in ast.walk(root):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
                break
            if isinstance(node, ast.Call) \
                    and terminal_name(node.func) in _STREAM_SYNC_TERMINALS:
                return True
    return False


def _host_reads(stmt, tainted) -> list[str]:
    """The tainted names `stmt` reads on the host: a method call or
    attribute on one (but `_NON_READ_ATTRS`), a subscript of one, one
    handed to numpy/torch/a bytes constructor, or iteration over one.
    Storing one in a container, returning it or passing it to a project
    call hands it to a consumer that waits (`_PendingDecode`) and is no
    read here."""
    from .cfg import header_roots

    parents: dict[int, ast.AST] = {}
    nodes = []
    stack = list(header_roots(stmt))
    while stack:
        node = stack.pop()
        if node is not stmt and isinstance(
                node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            continue
        nodes.append(node)
        for child in ast.iter_child_nodes(node):
            parents[id(child)] = node
            stack.append(child)
    out = []
    for node in nodes:
        if not (isinstance(node, ast.Name) and node.id in tainted
                and isinstance(node.ctx, ast.Load)):
            continue
        parent = parents.get(id(node))
        if isinstance(parent, ast.Attribute):
            read = parent.attr not in _NON_READ_ATTRS
        elif isinstance(parent, ast.Subscript):
            read = parent.value is node
        elif isinstance(parent, ast.Call):
            head = (dotted_name(parent.func) or "").split(".", 1)[0]
            read = node in parent.args and head in _HOST_READ_HEADS
        elif isinstance(parent, (ast.For, ast.comprehension)):
            read = parent.iter is node
        else:
            read = False
        if read and node.id not in out:
            out.append(node.id)
    return sorted(out)


def _donated_buffer_use(project, supp) -> list[Finding]:
    findings: list[Finding] = []
    for fn in project.iter_functions():
        # non-blocking copy statements -> the destinations they taint
        taint_at: dict[int, tuple[str, ...]] = {}
        for stmt in _iter_own_stmts(fn):
            if not isinstance(stmt, ast.Expr):
                continue
            dst = nonblocking_copy_target(stmt.value)
            if dst is not None:
                taint_at[id(stmt)] = (dst,)
        if not taint_at:
            continue
        cfg = CFG(fn.node)

        def transfer(node, state, _taints=taint_at):
            if not isinstance(node, ast.stmt):
                return state
            _loads, stores, _recv = _stmt_names(node)
            out = set(state) - set(stores)
            if _is_stream_sync(node):
                out = set()
            out |= set(_taints.get(id(node), ()))
            return frozenset(out)

        in_states = dataflow_forward(cfg, transfer)
        for stmt in sorted((s for s in cfg.statements()),
                           key=lambda s: (s.lineno, s.col_offset)):
            tainted_in = in_states.get(stmt, frozenset())
            if not tainted_in:
                continue
            for name in _host_reads(stmt, tainted_in):
                s = supp.get(fn.module.path)
                if s is not None and s.suppresses("donated-buffer-use",
                                                  stmt.lineno):
                    continue
                findings.append(Finding(
                    rule="donated-buffer-use", path=fn.module.path,
                    line=stmt.lineno, col=stmt.col_offset + 1,
                    scope=fn.qualname, detail=name,
                    message=f"`{name}` is the destination of a "
                            f"non-blocking copy and is read before an "
                            f"event or the stream is synchronised on this "
                            f"path: the copy engine may not have written "
                            f"it yet — wait on the copy's event first"))
    return findings


# -- rules: lock-held-across-await / lock-order-inversion ---------------------


class _LockTables:
    """Project-wide lock identity resolution (see docs/static-analysis.md
    for the heuristics and their limits)."""

    def __init__(self, project: Project):
        self.project = project
        self.attr_owner: dict[str, list[str]] = {}
        self.thread_attr_owner: dict[str, list[str]] = {}
        self.getter_owner: dict[str, list[str]] = {}
        for path in sorted(project.modules):
            m = project.modules[path]
            for cname in sorted(m.classes):
                cls = m.classes[cname]
                for a in cls.lock_attrs:
                    self.attr_owner.setdefault(a, []).append(
                        f"{m.path}::{cname}.{a}")
                for a in cls.thread_lock_attrs:
                    self.thread_attr_owner.setdefault(a, []).append(
                        f"{m.path}::{cname}.{a}")
                for g in cls.lock_getters:
                    self.getter_owner.setdefault(g, []).append(
                        f"{m.path}::{cname}.{g}()")

    def identify(self, fn, item) -> "tuple[str, bool] | None":
        """(lock id, is_async_lock) for a with-item context expr, else
        None when the expression is not recognizably a lock."""
        m = fn.module
        expr = item
        d = dotted_name(expr)
        if d is not None:
            head, _, rest = d.partition(".")
            if not rest:
                if d in m.module_locks:
                    return (f"{m.path}::{d}", True)
                if d in m.module_thread_locks:
                    return (f"{m.path}::{d}", False)
                return None
            attr = d.rsplit(".", 1)[-1]
            if head in ("self", "cls"):
                cls = self._own_class(fn)
                if cls is not None and "." not in rest:
                    if rest in cls.lock_attrs:
                        return (f"{cls.module.path}::{cls.name}.{rest}",
                                True)
                    if rest in cls.thread_lock_attrs:
                        return (f"{cls.module.path}::{cls.name}.{rest}",
                                False)
            owners = self.attr_owner.get(attr)
            if owners:
                return (owners[0] if len(owners) == 1
                        else f"<attr:{attr}>", True)
            owners = self.thread_attr_owner.get(attr)
            if owners:
                return (owners[0] if len(owners) == 1
                        else f"<attr:{attr}>", False)
            return None
        if isinstance(expr, ast.Call):
            term = terminal_name(expr.func)
            owners = self.getter_owner.get(term or "")
            if owners:
                return (owners[0] if len(owners) == 1
                        else f"<getter:{term}>", True)
        return None

    def _own_class(self, fn):
        scope = fn
        while scope is not None and scope.class_name is None:
            scope = scope.parent
        if scope is None:
            return None
        return fn.module.classes.get(scope.class_name)


def _self_derived_names(fn) -> set:
    """Locals transitively assigned from `self`/`cls` expressions —
    the own-resource sanction for awaits under a held lock."""
    derived = {"self", "cls"}
    for _ in range(6):  # fixpoint for assignment chains in any order
        before = len(derived)
        for stmt in _iter_own_stmts(fn):
            targets: list[str] = []
            value = None
            if isinstance(stmt, ast.Assign):
                value = stmt.value
                for t in stmt.targets:
                    if isinstance(t, ast.Name):
                        targets.append(t.id)
                    elif isinstance(t, (ast.Tuple, ast.List)):
                        targets.extend(e.id for e in t.elts
                                       if isinstance(e, ast.Name))
            elif isinstance(stmt, (ast.AnnAssign, ast.AugAssign)) \
                    and isinstance(stmt.target, ast.Name):
                targets, value = [stmt.target.id], stmt.value
            elif isinstance(stmt, (ast.With, ast.AsyncWith)):
                for item in stmt.items:
                    if isinstance(item.optional_vars, ast.Name) and any(
                            isinstance(n, ast.Name) and n.id in derived
                            for n in ast.walk(item.context_expr)):
                        derived.add(item.optional_vars.id)
                continue
            if value is None or not targets:
                continue
            if any(isinstance(n, ast.Name) and n.id in derived
                   for n in ast.walk(value)):
                derived.update(targets)
        if len(derived) == before:
            break
    return derived


def _await_root(node: ast.Await) -> "str | None":
    """The receiver-chain root name of the awaited expression, unwrapping
    asyncio.wait_for/shield to their first argument and walking through
    attribute/call chains: `self._channel(schema).reset()` roots at
    `self` — the own-resource idiom with an inline receiver."""
    value = node.value
    if isinstance(value, ast.Call):
        term = terminal_name(value.func)
        if term in _AWAIT_WRAPPERS and value.args:
            value = value.args[0]
    while True:
        if isinstance(value, ast.Call):
            value = value.func
        elif isinstance(value, ast.Attribute):
            value = value.value
        else:
            break
    return value.id if isinstance(value, ast.Name) else None


def _await_subject(node: ast.Await) -> str:
    value = node.value
    target = value.func if isinstance(value, ast.Call) else value
    return dotted_name(target) or terminal_name(target) or "<await>"


def _walk_holding(fn, tables, on_acquire, on_await, on_call):
    """Walk `fn`'s body tracking the held-lock stack. Calls the hooks:
    on_acquire(lock, held_before, node), on_await(node, held),
    on_call(callsite, held). Nested defs are skipped (own activation)."""
    calls_by_node = {id(s.node): s for s in fn.calls}

    def walk(node, held):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            return
        if isinstance(node, (ast.With, ast.AsyncWith)):
            new_held = list(held)
            for item in node.items:
                # context expr evaluates BEFORE the lock is held
                walk(item.context_expr, new_held)
                lock = tables.identify(fn, item.context_expr)
                if lock is not None:
                    on_acquire(lock, tuple(new_held), node)
                    new_held = new_held + [lock]
            for stmt in node.body:
                walk(stmt, new_held)
            return
        if isinstance(node, ast.Await):
            on_await(node, tuple(held))
        if isinstance(node, ast.Call):
            site = calls_by_node.get(id(node))
            if site is not None:
                on_call(site, tuple(held))
        for child in ast.iter_child_nodes(node):
            walk(child, held)

    body = getattr(fn.node, "body", None)
    if isinstance(body, list):
        for stmt in body:
            walk(stmt, [])


def _lock_held_across_await(project, supp) -> list[Finding]:
    tables = _LockTables(project)
    findings: list[Finding] = []
    for fn in project.iter_functions():
        if fn.module.path.split("/", 1)[0] not in LOCK_RULE_SCOPES:
            continue
        derived = None
        resolved_calls = {id(s.node) for s in fn.calls
                          if s.resolved is not None}

        def on_await(node, held, fn=fn, resolved_calls=resolved_calls):
            nonlocal derived
            if not held:
                return
            if derived is None:
                derived = _self_derived_names(fn)
            sync_locks = [lk for (lk, is_async) in held if not is_async]
            async_locks = [lk for (lk, is_async) in held if is_async]
            subject = _await_subject(node)
            s = supp.get(fn.module.path)
            if sync_locks:
                if s is not None and s.suppresses(
                        "lock-held-across-await", node.lineno):
                    return
                findings.append(Finding(
                    rule="lock-held-across-await", path=fn.module.path,
                    line=node.lineno, col=node.col_offset + 1,
                    scope=fn.qualname,
                    detail=f"{_short(sync_locks[0])}:{subject}",
                    message=f"`await {subject}` while holding sync lock "
                            f"`{_short(sync_locks[0])}`: a threading "
                            f"mutex held across an await blocks every "
                            f"other loop task that touches it — release "
                            f"before awaiting"))
                return
            if not async_locks:
                return
            root = _await_root(node)
            if root is not None and root in derived:
                return  # own-resource serialization: the sanctioned idiom
            if isinstance(node.value, ast.Call) \
                    and id(node.value) in resolved_calls:
                # awaiting a PROJECT coroutine is a design choice the
                # lock-order rule polices (held locks propagate into the
                # callee there); this rule targets parking on foreign
                # awaitables — sleeps, queues, other components' I/O
                return
            if s is not None and s.suppresses(
                    "lock-held-across-await", node.lineno):
                return
            findings.append(Finding(
                rule="lock-held-across-await", path=fn.module.path,
                line=node.lineno, col=node.col_offset + 1,
                scope=fn.qualname,
                detail=f"{_short(async_locks[-1])}:{subject}",
                message=f"`await {subject}` while holding "
                        f"`{_short(async_locks[-1])}` parks every other "
                        f"waiter behind a foreign awaitable; move the "
                        f"await outside the lock, or serialize only the "
                        f"owner's own resource (docs/CONCURRENCY.md)"))

        _walk_holding(fn, tables, lambda *a: None, on_await,
                      lambda *a: None)
    return findings


def _short(lock_id: str) -> str:
    return lock_id.split("::", 1)[-1]


def _lock_order_inversion(project, supp) -> list[Finding]:
    tables = _LockTables(project)
    # pair -> (site path, line, chain tuple) of the first witness
    pairs: dict[tuple[str, str], tuple] = {}
    # (function, frozen held-set) states already expanded
    seen: set = set()
    work: list = []

    def scan(fn, incoming, chain):
        key = (id(fn), incoming)
        if key in seen or len(chain) > 8:
            return
        seen.add(key)

        def on_acquire(lock, held, node, fn=fn, chain=chain):
            lid = lock[0]
            for h in tuple(incoming) + tuple(x[0] for x in held):
                if h == lid:
                    continue
                pairs.setdefault((h, lid), (
                    fn.module.path, node.lineno, chain + (fn.qualname,)))

        def on_call(site, held, fn=fn, chain=chain):
            callee = site.resolved
            if callee is None or (callee.is_async and not site.awaited):
                return
            eff = frozenset(incoming) | {x[0] for x in held}
            if eff:
                work.append((callee, frozenset(eff),
                             chain + (fn.qualname,)))

        _walk_holding(fn, tables, on_acquire, lambda *a: None, on_call)

    for fn in project.iter_functions():
        scan(fn, frozenset(), ())
    while work:
        fn, held, chain = work.pop(0)
        scan(fn, held, chain)

    findings: list[Finding] = []
    reported = set()
    for (a, b), (path, line, chain) in sorted(pairs.items()):
        if (b, a) not in pairs or frozenset((a, b)) in reported:
            continue
        reported.add(frozenset((a, b)))
        other_path, other_line, other_chain = pairs[(b, a)]
        first, second = sorted([(a, b, path, line, chain),
                                (b, a, other_path, other_line,
                                 other_chain)])
        s = supp.get(first[2])
        if s is not None and s.suppresses("lock-order-inversion",
                                          first[3]):
            continue
        detail = " <> ".join(sorted((_short(a), _short(b))))
        findings.append(Finding(
            rule="lock-order-inversion", path=first[2], line=first[3],
            col=1, scope=" → ".join(first[4]) or "<module>",
            detail=detail,
            chain=first[4], chain_sites=((first[2], first[3]),),
            message=f"locks `{_short(first[0])}` and `{_short(first[1])}` "
                    f"are acquired in opposite orders "
                    f"(here {_short(first[0])} → {_short(first[1])}; "
                    f"at {second[2]}:{second[3]} "
                    f"{_short(second[0])} → {_short(second[1])}): two "
                    f"tasks interleaving these paths deadlock — pick one "
                    f"global order (docs/CONCURRENCY.md)"))
    return findings
