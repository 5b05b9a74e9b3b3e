"""Whole-program symbol tables and call graph.

One `Project` holds every scanned module's AST plus the resolution
tables the interprocedural rules key on:

  - per-module import tables mapping local aliases to qualified names
    (`np` → `numpy`, `sleep` → `time.sleep`, `hl` →
    `analysis.annotations.hot_loop`, `eng` → project module `ops.engine`);
  - per-function call sites with both the LEXICAL dotted target and the
    RESOLVED target — a project `FunctionInfo` when the call lands on a
    function we can see, else the fully qualified external name;
  - class tables (methods, base names, lock-valued attributes) so
    `self.method()` and `ClassName()` construction resolve.

Resolution rules (the documented contract — see docs/static-analysis.md
for the precision limits):

  - bare `foo()`: enclosing functions' nested defs, then module-level
    defs, then classes (→ `__init__`), then imports;
  - `self.m()` / `cls.m()`: the enclosing class, then base classes
    resolvable in module scope (single-pass, depth-first);
  - `alias.attr()`: follow the import table; project modules resolve to
    their symbols (chasing at most `_MAX_CHASE` re-export hops), other
    modules produce a qualified external name for sink matching;
  - anything receiver-typed (`obj.method()` on a parameter or local of
    unknown type) stays unresolved — reported only when a lexical rule
    sees it.

Paths are canonical (findings.canonical_path): the module key for
`runtime/copy.py` is `runtime.copy`, and absolute `etl_tpu_torch.x.y` imports
strip the package prefix, so fixture trees mirroring the package layout
resolve exactly like the real tree.
"""

from __future__ import annotations

import ast

from .findings import canonical_path
from .visitor import dotted_name, terminal_name

#: decorator terminal names carrying analysis context (annotations.py);
#: matched on the RESOLVED name's terminal component so import aliases
#: (`from ...annotations import hot_loop as hl`) no longer defeat them
HOT_DECORATOR = "hot_loop"
DISPATCH_DECORATOR = "dispatch_stage"

#: wrappers that forward an await into their argument coroutines:
#: `await wait_for(helper(), t)` runs helper()'s body on this task
AWAIT_FORWARDERS = frozenset({"wait_for", "shield", "gather"})

#: constructors whose result is an asyncio lock-ish resource
_LOCK_CTORS = frozenset({"asyncio.Lock", "asyncio.Semaphore",
                         "asyncio.BoundedSemaphore", "asyncio.Condition"})
#: a threading.Condition IS a mutex (acquire/release around its lock)
#: — holding it guards state for both the lock rules and the
#: concurrency tier's lockset analysis (the queue/Condition-handoff
#: sanction in docs/CONCURRENCY.md rides on this)
_THREAD_LOCK_CTORS = frozenset({"threading.Lock", "threading.RLock",
                                "threading.Condition"})

_MAX_CHASE = 5  # re-export hops followed before giving up


def module_key(path: str) -> str:
    """Canonical path → dotted module key: `ops/engine.py` → `ops.engine`,
    `runtime/__init__.py` → `runtime`."""
    p = canonical_path(path)
    if p.endswith(".py"):
        p = p[:-3]
    parts = [x for x in p.split("/") if x]
    if parts and parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


def strip_package(dotted: str) -> str:
    """`etl_tpu_torch.ops.engine` → `ops.engine` (project-root names)."""
    if dotted == "etl_tpu_torch":
        return ""
    if dotted.startswith("etl_tpu_torch."):
        return dotted[len("etl_tpu_torch."):]
    return dotted


class CallSite:
    """One `Call` node inside a function body."""

    __slots__ = ("node", "lexical", "resolved", "external", "awaited")

    def __init__(self, node: ast.Call, lexical: "str | None",
                 awaited: bool):
        self.node = node
        self.lexical = lexical  # dotted source text, e.g. "eng.decode"
        self.resolved: "FunctionInfo | None" = None  # project target
        self.external: "str | None" = None  # qualified external name
        self.awaited = awaited

    @property
    def line(self) -> int:
        return self.node.lineno

    @property
    def col(self) -> int:
        return self.node.col_offset + 1


class FunctionInfo:
    """One def/async-def (or a lambda bound to a simple name)."""

    __slots__ = ("module", "qualname", "node", "is_async", "class_name",
                 "parent", "nested", "calls", "decorators",
                 "lex_decorators", "is_hot", "is_dispatch")

    def __init__(self, module: "ModuleInfo", qualname: str, node,
                 is_async: bool, class_name: "str | None",
                 parent: "FunctionInfo | None"):
        self.module = module
        self.qualname = qualname
        self.node = node
        self.is_async = is_async
        self.class_name = class_name
        self.parent = parent
        self.nested: dict[str, FunctionInfo] = {}
        self.calls: list[CallSite] = []
        self.decorators: set[str] = set()  # resolved terminal names
        self.lex_decorators: set[str] = set()  # as written in source
        self.is_hot = False
        self.is_dispatch = False

    @property
    def line(self) -> int:
        return self.node.lineno

    @property
    def label(self) -> str:
        """Display name for chains: `path::qualname` only when ambiguity
        needs it; chains render qualnames (module given by chain_sites)."""
        return self.qualname

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"<fn {self.module.path}::{self.qualname}>"


class ClassInfo:
    __slots__ = ("module", "name", "node", "methods", "bases",
                 "lock_attrs", "thread_lock_attrs", "lock_getters")

    def __init__(self, module: "ModuleInfo", name: str, node: ast.ClassDef):
        self.module = module
        self.name = name
        self.node = node
        self.methods: dict[str, FunctionInfo] = {}
        self.bases: list[str] = [d for d in
                                 (dotted_name(b) for b in node.bases)
                                 if d is not None]
        self.lock_attrs: set[str] = set()  # self.X = asyncio.Lock()
        self.thread_lock_attrs: set[str] = set()
        self.lock_getters: set[str] = set()  # methods returning a Lock


class ModuleInfo:
    __slots__ = ("path", "key", "tree", "source", "imports", "top",
                 "classes", "functions", "module_locks",
                 "module_thread_locks")

    def __init__(self, path: str, source: str, tree: ast.Module):
        self.path = canonical_path(path)
        self.key = module_key(path)
        self.source = source
        self.tree = tree
        #: local alias -> qualified dotted target. Project targets are
        #: package-stripped (`ops.engine`, `analysis.annotations.hot_loop`);
        #: external targets keep their import name (`numpy`, `time.sleep`).
        self.imports: dict[str, str] = {}
        self.top: dict[str, FunctionInfo] = {}
        self.classes: dict[str, ClassInfo] = {}
        self.functions: dict[str, FunctionInfo] = {}  # all, incl. nested
        self.module_locks: set[str] = set()
        self.module_thread_locks: set[str] = set()


class Project:
    """All scanned modules + the resolved call graph."""

    def __init__(self):
        self.modules: dict[str, ModuleInfo] = {}  # by canonical path
        self.by_key: dict[str, ModuleInfo] = {}

    # -- construction --------------------------------------------------------

    @classmethod
    def build(cls, sources: "list[tuple[str, str, ast.Module]]") -> "Project":
        """`sources` = (rel_path, source, parsed tree) triples."""
        proj = cls()
        for path, source, tree in sources:
            m = ModuleInfo(path, source, tree)
            proj.modules[m.path] = m
            # first module wins a key collision (e.g. two fixture trees
            # with the same layout scanned together): determinism over
            # completeness, and real trees never collide
            proj.by_key.setdefault(m.key, m)
        for m in proj.modules.values():
            proj._collect_imports(m)
            proj._collect_defs(m)
        for m in proj.modules.values():
            proj._collect_lock_tables(m)
        for m in proj.modules.values():
            for fn in m.functions.values():
                proj._collect_calls(fn)
                proj._resolve_decorators(fn)
        return proj

    def _collect_imports(self, m: ModuleInfo) -> None:
        pkg_parts = m.key.split(".")[:-1] if m.key else []
        for node in ast.walk(m.tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    name = alias.name
                    asname = alias.asname or name.split(".")[0]
                    if alias.asname is None and "." in name:
                        # `import a.b.c` binds `a`; dotted access chases
                        # from the root name
                        m.imports[asname] = strip_package(
                            name.split(".")[0])
                    else:
                        m.imports[asname] = strip_package(name)
            elif isinstance(node, ast.ImportFrom):
                if node.level:
                    base = pkg_parts[: len(pkg_parts) - (node.level - 1)] \
                        if node.level - 1 <= len(pkg_parts) else []
                    prefix = ".".join(base)
                    if node.module:
                        prefix = f"{prefix}.{node.module}" if prefix \
                            else node.module
                else:
                    prefix = strip_package(node.module or "")
                for alias in node.names:
                    if alias.name == "*":
                        continue  # star imports: unresolvable, skip
                    asname = alias.asname or alias.name
                    m.imports[asname] = f"{prefix}.{alias.name}" \
                        if prefix else alias.name

    def _collect_defs(self, m: ModuleInfo) -> None:
        def walk_body(body, class_name, parent, prefix):
            for node in body:
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    qual = f"{prefix}{node.name}"
                    fn = FunctionInfo(m, qual,
                                      node, isinstance(
                                          node, ast.AsyncFunctionDef),
                                      class_name, parent)
                    m.functions[qual] = fn
                    if parent is not None:
                        parent.nested[node.name] = fn
                    elif class_name is None:
                        m.top[node.name] = fn
                    else:
                        m.classes[class_name].methods[node.name] = fn
                    walk_body(node.body, None, fn, f"{qual}.")
                elif isinstance(node, ast.ClassDef):
                    if parent is None and class_name is None:
                        m.classes[node.name] = ClassInfo(m, node.name, node)
                        walk_body(node.body, node.name, None,
                                  f"{node.name}.")
                    else:
                        # nested class: methods tracked under the quali-
                        # fied name but not self-resolvable (rare)
                        walk_body(node.body, None, parent,
                                  f"{prefix}{node.name}.")
                elif isinstance(node, ast.Assign) and parent is None \
                        and class_name is None \
                        and isinstance(node.value, ast.Lambda) \
                        and len(node.targets) == 1 \
                        and isinstance(node.targets[0], ast.Name):
                    name = node.targets[0].id
                    fn = FunctionInfo(m, name, node.value, False,
                                      None, None)
                    m.functions.setdefault(name, fn)
                    m.top.setdefault(name, fn)
                else:
                    for sub in ast.iter_child_nodes(node):
                        if isinstance(sub, (ast.stmt,)):
                            walk_body([sub], class_name, parent, prefix)

        walk_body(m.tree.body, None, None, "")
        # lambdas bound inside functions: resolvable as locals
        for fn in list(m.functions.values()):
            body = getattr(fn.node, "body", None)
            if not isinstance(body, list):
                continue
            for node in body:
                if isinstance(node, ast.Assign) \
                        and isinstance(node.value, ast.Lambda) \
                        and len(node.targets) == 1 \
                        and isinstance(node.targets[0], ast.Name):
                    name = node.targets[0].id
                    lam = FunctionInfo(
                        m, f"{fn.qualname}.<lambda:{name}>",
                        node.value, False, fn.class_name, fn)
                    m.functions[lam.qualname] = lam
                    fn.nested.setdefault(name, lam)

    def _ctor_name(self, m: ModuleInfo, call: ast.Call) -> "str | None":
        """Qualified name of a constructor-ish call, import-resolved."""
        d = dotted_name(call.func)
        if d is None:
            return None
        head, _, rest = d.partition(".")
        target = m.imports.get(head)
        if target is not None:
            return f"{target}.{rest}" if rest else target
        return d

    def _collect_lock_tables(self, m: ModuleInfo) -> None:
        def is_lock_ctor(node, ctors) -> bool:
            return (isinstance(node, ast.Call)
                    and (self._ctor_name(m, node) or "") in ctors)

        for node in ast.walk(m.tree):
            if not isinstance(node, ast.Assign):
                continue
            for tgt in node.targets:
                if isinstance(tgt, ast.Name):
                    if is_lock_ctor(node.value, _LOCK_CTORS):
                        m.module_locks.add(tgt.id)
                    elif is_lock_ctor(node.value, _THREAD_LOCK_CTORS):
                        m.module_thread_locks.add(tgt.id)
                elif isinstance(tgt, ast.Attribute) \
                        and isinstance(tgt.value, ast.Name) \
                        and tgt.value.id == "self":
                    cls = self._class_of_assign(m, node)
                    if cls is None:
                        continue
                    if is_lock_ctor(node.value, _LOCK_CTORS):
                        cls.lock_attrs.add(tgt.attr)
                    elif is_lock_ctor(node.value, _THREAD_LOCK_CTORS):
                        cls.thread_lock_attrs.add(tgt.attr)
        # lock getters: methods whose return expression CONTAINS an
        # asyncio lock constructor (`return self._locks.setdefault(k,
        # asyncio.Lock())` — the per-key lock factory idiom)
        for cls in m.classes.values():
            for name, fn in cls.methods.items():
                for node in ast.walk(fn.node):
                    if isinstance(node, ast.Return) \
                            and node.value is not None \
                            and any(is_lock_ctor(c, _LOCK_CTORS)
                                    for c in ast.walk(node.value)
                                    if isinstance(c, ast.Call)):
                        cls.lock_getters.add(name)
                        break

    def _class_of_assign(self, m: ModuleInfo,
                         node: ast.Assign) -> "ClassInfo | None":
        # attribute assigns live inside methods; find the class whose
        # span contains the assignment (top-level classes only)
        for cls in m.classes.values():
            if cls.node.lineno <= node.lineno \
                    <= (cls.node.end_lineno or cls.node.lineno):
                return cls
        return None

    def _collect_calls(self, fn: FunctionInfo) -> None:
        body = getattr(fn.node, "body", None)
        nodes = body if isinstance(body, list) else [body]
        stack = [(n, False) for n in nodes]
        while stack:
            node, awaited = stack.pop()
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
                continue  # nested callables own their call sites
            if isinstance(node, ast.Call):
                site = CallSite(node, dotted_name(node.func), awaited)
                self._resolve_call(fn, site)
                fn.calls.append(site)
            # `await asyncio.wait_for(helper(), 5)` executes helper()'s
            # coroutine — the wrapper forwards the await, so argument
            # call sites stay "awaited" through it (the repo's own
            # unbounded-await rule TELLS authors to wrap awaits this
            # way; the edge must not vanish when they comply)
            propagate = isinstance(node, ast.Await) or (
                awaited and isinstance(node, ast.Call)
                and terminal_name(node.func) in AWAIT_FORWARDERS)
            stack.extend((c, propagate)
                         for c in ast.iter_child_nodes(node))
        fn.calls.sort(key=lambda s: (s.line, s.col))

    def _resolve_decorators(self, fn: FunctionInfo) -> None:
        for dec in getattr(fn.node, "decorator_list", []):
            target = dec.func if isinstance(dec, ast.Call) else dec
            d = dotted_name(target)
            if d is None:
                continue
            fn.lex_decorators.add(d.rsplit(".", 1)[-1])
            head, _, rest = d.partition(".")
            imported = fn.module.imports.get(head)
            resolved = (f"{imported}.{rest}" if rest else imported) \
                if imported is not None else d
            fn.decorators.add(resolved.rsplit(".", 1)[-1])
        fn.is_hot = HOT_DECORATOR in fn.decorators
        fn.is_dispatch = DISPATCH_DECORATOR in fn.decorators

    # -- resolution ----------------------------------------------------------

    def _lookup_symbol(self, modkey: str, parts: list[str],
                       depth: int = 0) -> "FunctionInfo | None":
        """Resolve `parts` inside project module `modkey`."""
        m = self.by_key.get(modkey)
        if m is None or not parts or depth > _MAX_CHASE:
            return None
        head, rest = parts[0], parts[1:]
        if not rest:
            fn = m.top.get(head)
            if fn is not None:
                return fn
            cls = m.classes.get(head)
            if cls is not None:
                return cls.methods.get("__init__")
            # re-exported name (`from .x import f` then callers do m.f())
            target = m.imports.get(head)
            if target is not None:
                return self._resolve_qualified(target, depth + 1)
            return None
        cls = m.classes.get(head)
        if cls is not None and len(rest) == 1:
            return cls.methods.get(rest[0])
        target = m.imports.get(head)
        if target is not None:
            return self._resolve_qualified(
                f"{target}.{'.'.join(rest)}", depth + 1)
        return None

    def _resolve_qualified(self, qualified: str,
                           depth: int = 0) -> "FunctionInfo | None":
        """Resolve a package-stripped dotted name against project
        modules, trying the longest module-key prefix first."""
        parts = qualified.split(".")
        for i in range(len(parts), 0, -1):
            key = ".".join(parts[:i])
            if key in self.by_key:
                if i == len(parts):
                    return None  # names a module, not a callable
                return self._lookup_symbol(key, parts[i:], depth)
        return None

    def resolve_class(self, m: ModuleInfo, name: str) -> "ClassInfo | None":
        """A class name (possibly dotted through imports) → ClassInfo."""
        head, _, rest = name.partition(".")
        cls = m.classes.get(head)
        if cls is not None and not rest:
            return cls
        target = m.imports.get(head)
        if target is None:
            return None
        qualified = f"{target}.{rest}" if rest else target
        parts = qualified.split(".")
        for i in range(len(parts) - 1, 0, -1):
            mod = self.by_key.get(".".join(parts[:i]))
            if mod is not None and len(parts) - i == 1:
                return mod.classes.get(parts[-1])
        return None

    def resolve_method(self, cls: ClassInfo, name: str,
                       depth: int = 0) -> "FunctionInfo | None":
        """`self.name` in `cls`, walking project-resolvable bases."""
        fn = cls.methods.get(name)
        if fn is not None or depth > _MAX_CHASE:
            return fn
        for base in cls.bases:
            parent = self.resolve_class(cls.module, base)
            if parent is not None:
                fn = self.resolve_method(parent, name, depth + 1)
                if fn is not None:
                    return fn
        return None

    def _resolve_call(self, fn: FunctionInfo, site: CallSite) -> None:
        d = site.lexical
        if d is None:
            return
        m = fn.module
        head, _, rest = d.partition(".")
        # nested defs / lambda locals of enclosing functions
        if not rest:
            scope = fn
            while scope is not None:
                if head in scope.nested:
                    site.resolved = scope.nested[head]
                    return
                scope = scope.parent
        # self/cls method
        if head in ("self", "cls") and rest and "." not in rest:
            cls = m.classes.get(fn.class_name or "")
            if cls is not None:
                site.resolved = self.resolve_method(cls, rest)
            return
        # module-level def / class constructor / ClassName.method
        if not rest and head in m.top:
            site.resolved = m.top[head]
            return
        cls = m.classes.get(head)
        if cls is not None:
            site.resolved = cls.methods.get(rest) if rest and "." not in rest \
                else (cls.methods.get("__init__") if not rest else None)
            return
        # imports
        target = m.imports.get(head)
        if target is not None:
            qualified = f"{target}.{rest}" if rest else target
            resolved = self._resolve_qualified(qualified)
            if resolved is not None:
                site.resolved = resolved
            else:
                site.external = qualified
            return
        # unknown receiver: leave lexical-only

    # -- introspection -------------------------------------------------------

    def iter_functions(self):
        for path in sorted(self.modules):
            m = self.modules[path]
            for qual in sorted(m.functions):
                yield m.functions[qual]

    def edges(self) -> "list[tuple[str, str]]":
        """Resolved caller → callee pairs (for `--callgraph`)."""
        out = []
        for fn in self.iter_functions():
            src = f"{fn.module.path}::{fn.qualname}"
            for site in fn.calls:
                if site.resolved is not None:
                    out.append((src, f"{site.resolved.module.path}::"
                                     f"{site.resolved.qualname}"))
        return sorted(set(out))


def nonblocking_copy_target(value: ast.AST) -> "str | None":
    """The destination name when `value` is `dst.copy_(src,
    non_blocking=True)` on a plain name `dst`, else None.

    This is the port's counterpart of a donation: the copy is only
    enqueued on the stream, so until an event or the stream is
    synchronised (or waited on) the destination's bytes belong to the
    copy engine — a host read of `dst` sees whatever was there before."""
    if not (isinstance(value, ast.Call)
            and isinstance(value.func, ast.Attribute)
            and value.func.attr == "copy_"
            and isinstance(value.func.value, ast.Name)):
        return None
    for kw in value.keywords:
        if kw.arg == "non_blocking" and isinstance(kw.value, ast.Constant) \
                and kw.value.value is True:
            return value.func.value.id
    return None
