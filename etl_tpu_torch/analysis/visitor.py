"""Scope/context-tracking AST walk the lint rules plug into.

One traversal per module serves every rule. The visitor maintains the
lexical facts rules key on:

  - `in_async`: inside an `async def` body — reset by a nested sync
    `def`/`lambda`, because that is exactly how blocking work is legally
    routed off the loop (`run_in_executor(None, nested_fn)`);
  - `in_hot_loop`: inside a function decorated `@hot_loop` (inherited by
    nested defs — a closure defined in a hot loop runs in the hot loop);
  - `scope`: dotted qualname for fingerprints;
  - ancestor stack: lets a rule inspect enclosing statements — e.g.
    CancellationSwallow finds the governing `try` and enclosing function
    to recognize the cancel-then-drain idiom;
  - inline suppressions: `# etl-lint: ignore[rule-a,rule-b]` on the
    finding's line (or on the first line of its enclosing multi-line
    statement) drops the finding at collection time; usage is tracked
    so `--check-baseline` can flag ignores that suppress nothing.

Rules subclass `Rule` and receive `on_*` callbacks with the visitor as
context. They report via `ctx.report(...)`, which applies suppressions.
"""

from __future__ import annotations

import ast
import io
import re
import tokenize
from typing import Callable

from .findings import Finding, canonical_path

_IGNORE_RE = re.compile(r"#\s*etl-lint:\s*ignore\[([a-z0-9_,\s-]+)\]")

#: compound statements: only their HEADER lines (condition / with-items /
#: signature) belong to the statement for suppression purposes — a
#: suppression on `with ...:` must not blanket the whole body
_COMPOUND_STMTS = (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef,
                   ast.For, ast.AsyncFor, ast.While, ast.If, ast.With,
                   ast.AsyncWith, ast.Try)


class Suppressions:
    """One module's inline `# etl-lint: ignore[...]` comments.

    Three jobs:
      - parse COMMENT tokens only (a docstring or log string QUOTING the
        ignore syntax must not suppress findings on its line);
      - map continuation lines of a multi-line statement back to the
        statement's first line, so a suppression on the line a human
        reads as "the statement" covers findings the AST anchors on a
        continuation line (a nested call's own lineno);
      - track which ignores actually suppressed something, so
        `--check-baseline` can flag stale ones.
    """

    def __init__(self, source: str):
        #: comment line -> set of rule names (or "all")
        self.by_line: dict[int, set[str]] = {}
        #: continuation line -> first line of its enclosing statement
        self._stmt_first: dict[int, int] = {}
        #: (comment line, rule) pairs that suppressed >=1 finding
        self._used: set[tuple[int, str]] = set()
        try:
            for tok in tokenize.generate_tokens(
                    io.StringIO(source).readline):
                if tok.type != tokenize.COMMENT:
                    continue
                m = _IGNORE_RE.search(tok.string)
                if m:
                    self.by_line[tok.start[0]] = {
                        r.strip() for r in m.group(1).split(",")
                        if r.strip()}
        except (tokenize.TokenError, IndentationError):
            pass  # unparseable source fails in ast.parse anyway

    def attach_tree(self, tree: ast.Module) -> None:
        """Build the continuation-line map. Simple statements span their
        full extent; compound statements contribute only their header
        (first line through the line before their first body statement)."""
        for node in ast.walk(tree):
            if not isinstance(node, ast.stmt):
                continue
            end = getattr(node, "end_lineno", None) or node.lineno
            if isinstance(node, _COMPOUND_STMTS):
                body = getattr(node, "body", None)
                if body:
                    end = min(end, body[0].lineno - 1)
            for line in range(node.lineno + 1, end + 1):
                # innermost statement wins: walk yields outer before
                # inner, so later (inner) writes override
                self._stmt_first[line] = node.lineno

    def _match_line(self, rule: str, line: int) -> "int | None":
        rules = self.by_line.get(line)
        if rules is not None and (rule in rules or "all" in rules):
            return line
        return None

    def suppresses(self, rule: str, line: int) -> bool:
        """True (and marks the ignore used) when an ignore on `line` or
        on the first line of `line`'s enclosing statement names `rule`."""
        hit = self._match_line(rule, line)
        if hit is None:
            first = self._stmt_first.get(line)
            if first is not None:
                hit = self._match_line(rule, first)
        if hit is None:
            return False
        named = self.by_line[hit]
        self._used.add((hit, rule if rule in named else "all"))
        return True

    def unused(self) -> list[tuple[int, str]]:
        """(line, rule) of every ignore entry that suppressed nothing —
        sorted, deterministic."""
        out = []
        for line, rules in self.by_line.items():
            for rule in rules:
                if (line, rule) not in self._used:
                    out.append((line, rule))
        return sorted(out)

#: decorator names that mark a hot-path function (matched on the
#: terminal name so `@hot_loop`, `@annotations.hot_loop`, and
#: `@analysis.hot_loop` all count)
HOT_LOOP_DECORATORS = frozenset({"hot_loop"})

#: decorator marking the decode pipeline's dispatch stage
#: (annotations.dispatch_stage): a hot-loop function where host→device
#: UPLOADS are the point — the hot-loop-host-transfer rule permits
#: `.cuda()`, `.to(<device>)` and `.copy_(…, non_blocking=True)` there
#: while still forbidding fetch-side transfers
DISPATCH_STAGE_DECORATORS = frozenset({"dispatch_stage"})

#: decorator marking the admission scheduler's grant path
#: (annotations.admission_path): the admission-blocking-fetch rule
#: forbids ALL device traffic there — a fetch under the scheduler lock
#: head-of-line-blocks every tenant's admission. Same sanctioning
#: machinery as @dispatch_stage: a lexical frame flag inherited by
#: nested defs/lambdas (lag/weight providers defined inline).
ADMISSION_PATH_DECORATORS = frozenset({"admission_path"})

#: decorator marking shard-scoped replication code
#: (annotations.shard_scoped): the cross-shard-table-access rule forbids
#: unfiltered full-table-list store reads there — against a shared store
#: they return every shard's tables. Same sanctioning machinery as
#: @dispatch_stage: a lexical frame flag inherited by nested
#: defs/lambdas.
SHARD_SCOPED_DECORATORS = frozenset({"shard_scoped"})

#: decorator marking destination flush/dispatch paths
#: (annotations.flush_path): the inline-durability-wait rule forbids a
#: bare `await ack.wait_durable()` there — the bounded ack window
#: (runtime/ack_window.py) owns durability waits, and an inline wait
#: re-serializes the pipeline to one ack round-trip per batch. Same
#: sanctioning machinery as @dispatch_stage: a lexical frame flag
#: inherited by nested defs/lambdas (the flush submit closures).
FLUSH_PATH_DECORATORS = frozenset({"flush_path"})

#: decorator marking transactional-commit destination entry points
#: (annotations.transactional_commit): the seam through which a
#: destination atomically records the acked WAL coordinate range
#: alongside the data (docs/destinations.md). The
#: uncoordinated-transactional-write rule requires a marked function
#: that performs CDC writes to consult its commit-range parameter —
#: data landing without its coordinates silently downgrades the sink
#: to at-least-once. Same sanctioning machinery as @dispatch_stage: a
#: lexical frame flag inherited by nested defs/lambdas (the retried
#: write closures).
TRANSACTIONAL_COMMIT_DECORATORS = frozenset({"transactional_commit"})

#: decorator marking the autoscaling control loop's decision path
#: (annotations.control_loop): the control-loop-blocking-io rule forbids
#: blocking I/O and ALL device traffic there — the policy must stay a
#: pure function of (signal history, config). Same sanctioning machinery
#: as @dispatch_stage: a lexical frame flag inherited by nested
#: defs/lambdas (inline capacity estimators, comparator keys).
CONTROL_LOOP_DECORATORS = frozenset({"control_loop"})


def dotted_name(node: ast.AST) -> str | None:
    """`a.b.c` for a Name/Attribute chain, else None."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def terminal_name(node: ast.AST) -> str | None:
    """Last component of a call target: `loop.create_task` -> create_task."""
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def _contains_raise(node: ast.AST) -> bool:
    for child in ast.iter_child_nodes(node):
        if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda)):
            continue  # prune nested callables, keep walking siblings
        if isinstance(child, ast.Raise) or _contains_raise(child):
            return True
    return False


def has_raise(handler: ast.ExceptHandler) -> bool:
    """Any `raise` lexically inside the handler body (nested defs don't
    count — a raise inside a closure doesn't re-raise the handler's
    exception)."""
    return any(isinstance(stmt, ast.Raise) or _contains_raise(stmt)
               for stmt in handler.body)


def handler_type_names(handler: ast.ExceptHandler) -> tuple[str, ...]:
    """Terminal names of the caught types; `("<bare>",)` for `except:`."""
    t = handler.type
    if t is None:
        return ("<bare>",)
    nodes = t.elts if isinstance(t, ast.Tuple) else [t]
    out = []
    for n in nodes:
        name = terminal_name(n)
        out.append(name if name is not None else "<unknown>")
    return tuple(out)


class Rule:
    """Base class: override the hooks a rule cares about."""

    name: str = ""

    def applies_to(self, rel_path: str) -> bool:
        return True

    def before_module(self, ctx: "LintContext", tree: ast.Module) -> None:
        """One pre-pass hook (e.g. collect locally-defined async names)."""

    def on_call(self, ctx: "LintContext", node: ast.Call) -> None:
        pass

    def on_expr_statement(self, ctx: "LintContext", node: ast.Expr) -> None:
        pass

    def on_except_handler(self, ctx: "LintContext",
                          node: ast.ExceptHandler) -> None:
        pass

    def on_function(self, ctx: "LintContext",
                    node: "ast.FunctionDef | ast.AsyncFunctionDef") -> None:
        pass

    def on_while(self, ctx: "LintContext", node: ast.While) -> None:
        pass


class _Frame:
    __slots__ = ("name", "is_async", "is_hot", "is_dispatch",
                 "is_admission", "is_shard_scoped", "is_control",
                 "is_flush", "is_transactional")

    def __init__(self, name: str, is_async: bool, is_hot: bool,
                 is_dispatch: bool = False, is_admission: bool = False,
                 is_shard_scoped: bool = False, is_control: bool = False,
                 is_flush: bool = False, is_transactional: bool = False):
        self.name = name
        self.is_async = is_async
        self.is_hot = is_hot
        self.is_dispatch = is_dispatch
        self.is_admission = is_admission
        self.is_shard_scoped = is_shard_scoped
        self.is_control = is_control
        self.is_flush = is_flush
        self.is_transactional = is_transactional


class LintContext(ast.NodeVisitor):
    """One module's traversal state, shared by every active rule."""

    def __init__(self, source: str, rel_path: str, rules: list[Rule],
                 suppressions: "Suppressions | None" = None):
        self.rel_path = canonical_path(rel_path)
        self.source = source
        self.rules = [r for r in rules if r.applies_to(self.rel_path)]
        self.findings: list[Finding] = []
        self.suppressions = suppressions if suppressions is not None \
            else Suppressions(source)
        # lexical scope stacks
        self._frames: list[_Frame] = []
        self._class_stack: list[str] = []
        self._ancestors: list[ast.AST] = []

    # -- facts rules query ---------------------------------------------------

    @property
    def in_async(self) -> bool:
        return bool(self._frames) and self._frames[-1].is_async

    @property
    def in_hot_loop(self) -> bool:
        return bool(self._frames) and self._frames[-1].is_hot

    @property
    def in_dispatch_stage(self) -> bool:
        return bool(self._frames) and self._frames[-1].is_dispatch

    @property
    def in_admission_path(self) -> bool:
        return bool(self._frames) and self._frames[-1].is_admission

    @property
    def in_shard_scoped(self) -> bool:
        return bool(self._frames) and self._frames[-1].is_shard_scoped

    @property
    def in_control_loop(self) -> bool:
        return bool(self._frames) and self._frames[-1].is_control

    @property
    def in_flush_path(self) -> bool:
        return bool(self._frames) and self._frames[-1].is_flush

    @property
    def in_transactional_commit(self) -> bool:
        return bool(self._frames) and self._frames[-1].is_transactional

    @property
    def current_class(self) -> "str | None":
        return self._class_stack[-1] if self._class_stack else None

    @property
    def scope(self) -> str:
        parts = list(self._class_stack)
        parts += [f.name for f in self._frames]
        return ".".join(parts) if parts else "<module>"

    def ancestors(self) -> list[ast.AST]:
        """Enclosing nodes, innermost last (excludes the current node)."""
        return self._ancestors

    def report(self, rule: str, node: ast.AST, detail: str,
               message: str) -> None:
        line = getattr(node, "lineno", 0)
        if self.suppressions.suppresses(rule, line):
            return
        self.findings.append(Finding(
            rule=rule, path=self.rel_path, line=line,
            col=getattr(node, "col_offset", 0) + 1,
            scope=self.scope, detail=detail, message=message))

    # -- traversal -----------------------------------------------------------

    def run(self, tree: ast.Module) -> list[Finding]:
        self.suppressions.attach_tree(tree)
        for rule in self.rules:
            rule.before_module(self, tree)
        self.visit(tree)
        self.findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
        return self.findings

    def generic_visit(self, node: ast.AST) -> None:
        self._ancestors.append(node)
        try:
            super().generic_visit(node)
        finally:
            self._ancestors.pop()

    def _visit_function(self, node, is_async: bool) -> None:
        decorators = {terminal_name(d.func if isinstance(d, ast.Call) else d)
                      for d in node.decorator_list}
        is_hot = bool(decorators & HOT_LOOP_DECORATORS) or self.in_hot_loop
        is_dispatch = bool(decorators & DISPATCH_STAGE_DECORATORS) \
            or self.in_dispatch_stage
        is_admission = bool(decorators & ADMISSION_PATH_DECORATORS) \
            or self.in_admission_path
        is_shard_scoped = bool(decorators & SHARD_SCOPED_DECORATORS) \
            or self.in_shard_scoped
        is_control = bool(decorators & CONTROL_LOOP_DECORATORS) \
            or self.in_control_loop
        is_flush = bool(decorators & FLUSH_PATH_DECORATORS) \
            or self.in_flush_path
        is_transactional = bool(
            decorators & TRANSACTIONAL_COMMIT_DECORATORS) \
            or self.in_transactional_commit
        for rule in self.rules:
            rule.on_function(self, node)
        # decorators, default args, and annotations execute ONCE at def
        # time in the ENCLOSING scope — visiting them inside the new
        # frame would misclassify `@deco(time.sleep(0))` or
        # `async def f(x=open(p))` as running on the event loop
        self._ancestors.append(node)
        try:
            for dec in node.decorator_list:
                self.visit(dec)
            self.visit(node.args)
            if node.returns is not None:
                self.visit(node.returns)
            self._frames.append(_Frame(node.name, is_async, is_hot,
                                       is_dispatch, is_admission,
                                       is_shard_scoped, is_control,
                                       is_flush, is_transactional))
            try:
                for stmt in node.body:
                    self.visit(stmt)
            finally:
                self._frames.pop()
        finally:
            self._ancestors.pop()

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        self._visit_function(node, is_async=False)

    def visit_AsyncFunctionDef(self, node: ast.AsyncFunctionDef) -> None:
        self._visit_function(node, is_async=True)

    def visit_Lambda(self, node: ast.Lambda) -> None:
        # a lambda body is a sync callable: blocking calls inside it are
        # (usually) executor-routed; hot-loop status still inherits.
        # Defaults evaluate at def time in the enclosing scope.
        self._ancestors.append(node)
        try:
            self.visit(node.args)
            self._frames.append(_Frame("<lambda>", False, self.in_hot_loop,
                                       self.in_dispatch_stage,
                                       self.in_admission_path,
                                       self.in_shard_scoped,
                                       self.in_control_loop,
                                       self.in_flush_path))
            try:
                self.visit(node.body)
            finally:
                self._frames.pop()
        finally:
            self._ancestors.pop()

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self._class_stack.append(node.name)
        try:
            self.generic_visit(node)
        finally:
            self._class_stack.pop()

    def visit_Call(self, node: ast.Call) -> None:
        for rule in self.rules:
            rule.on_call(self, node)
        self.generic_visit(node)

    def visit_Expr(self, node: ast.Expr) -> None:
        for rule in self.rules:
            rule.on_expr_statement(self, node)
        self.generic_visit(node)

    def visit_ExceptHandler(self, node: ast.ExceptHandler) -> None:
        for rule in self.rules:
            rule.on_except_handler(self, node)
        self.generic_visit(node)

    def visit_While(self, node: ast.While) -> None:
        for rule in self.rules:
            rule.on_while(self, node)
        self.generic_visit(node)


def collect_async_defs(
        tree: ast.Module) -> tuple[set[str], dict[str, set[str]]]:
    """(module-level-resolvable async def names, async method names keyed
    by enclosing class name).

    Plain names resolve bare calls `foo()`; method names resolve
    `self.foo()` / `cls.foo()` receivers only, and only within the SAME
    class — a flat module-wide method set would false-positive a sync
    `self.flush()` because some unrelated class defines `async def
    flush` (common names like close/stop/flush make that likely).
    """
    plain: set[str] = set()
    methods: dict[str, set[str]] = {}

    def walk(node: ast.AST, class_name: "str | None") -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.AsyncFunctionDef):
                if class_name is None:
                    plain.add(child.name)
                else:
                    methods.setdefault(class_name, set()).add(child.name)
                walk(child, None)
            elif isinstance(child, ast.ClassDef):
                walk(child, child.name)
            elif isinstance(child, ast.FunctionDef):
                walk(child, None)
            else:
                walk(child, class_name)

    walk(tree, None)
    return plain, methods


Visitor = Callable[[str, str, list[Rule]], list[Finding]]


def lint_module(source: str, rel_path: str, rules: list[Rule],
                tree: "ast.Module | None" = None,
                suppressions: "Suppressions | None" = None) -> list[Finding]:
    if tree is None:
        tree = ast.parse(source, filename=rel_path)
    return LintContext(source, rel_path, rules, suppressions).run(tree)
