"""Per-function control-flow graph + forward dataflow.

Statement-granularity CFG over one function body: nodes are the
function's `ast.stmt` objects plus three synthetic markers (ENTRY, EXIT
for normal returns/fall-through, EXC_EXIT for exceptions escaping the
function). Edges cover branches (`if`/`else`), loops (`while`/`for`,
`break`/`continue`, `else` clauses), `try`/`except`/`else`/`finally`,
`with`, `return`, and `raise`.

Exception edges are deliberately coarse — any statement that *contains a
call, await, subscript, or attribute access* may raise, and it may raise
*before or after* its own effect took hold, so a may-analysis gets an
exception edge from the statement itself (state as of the statement's
ENTRY, not its exit). The edge lands on the innermost enclosing
handler/finally, else on EXC_EXIT. That is exactly the precision the
resource rules need: "`lease = pool.lease()` then work that can raise
with no `finally` release" produces a path acquire → EXC_EXIT that
avoids the release, while `finally: lease.release()` routes every
exception edge through the release first.

`dataflow_forward` runs a classic union-join worklist over the graph;
rules supply a transfer function over frozensets. Used by
`arena-lease-leak` (live-lease facts) and `donated-buffer-use` (tainted
buffer names).
"""

from __future__ import annotations

import ast

ENTRY = "<entry>"
EXIT = "<exit>"
EXC_EXIT = "<exc-exit>"

#: node kinds whose evaluation can raise — the coarse may-raise test
_RAISING = (ast.Call, ast.Await, ast.Subscript, ast.Attribute,
            ast.BinOp, ast.Raise, ast.Assert)


def header_roots(stmt: ast.stmt) -> list:
    """The sub-expressions that execute AT a statement's own CFG node.
    For a simple statement that is the whole statement; for a compound
    statement only its header (condition / iterable / with-items) — the
    body statements are separate CFG nodes and must not contribute
    their effects (releases, raises) to the header's transfer."""
    if isinstance(stmt, (ast.If, ast.While)):
        return [stmt.test]
    if isinstance(stmt, (ast.For, ast.AsyncFor)):
        return [stmt.target, stmt.iter]
    if isinstance(stmt, (ast.With, ast.AsyncWith)):
        return [i.context_expr for i in stmt.items]
    if isinstance(stmt, ast.Try):
        return []
    if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                         ast.ClassDef)):
        return list(stmt.decorator_list)
    return [stmt]


def iter_header_nodes(stmt: ast.stmt):
    for root in header_roots(stmt):
        yield from ast.walk(root)


def may_raise(stmt: ast.stmt) -> bool:
    if isinstance(stmt, (ast.Raise, ast.Assert)):
        return True
    return any(isinstance(node, _RAISING)
               for node in iter_header_nodes(stmt))


class CFG:
    """succs/preds over `ast.stmt` nodes + the synthetic markers.

    Two edge kinds: NORMAL edges propagate a statement's post-state
    (its effect happened), EXC edges (`exc_succs`) propagate its
    PRE-state — an exception may fire before the statement's own effect,
    so `x = pool.lease()` raising must not claim the lease was taken,
    and `x.release()` raising must not claim it was released."""

    def __init__(self, fn_node):
        self.fn = fn_node
        self.succs: dict[object, set] = {ENTRY: set(), EXIT: set(),
                                         EXC_EXIT: set()}
        self.exc_succs: dict[object, set] = {}
        self._loop_stack: list[tuple[set, set]] = []  # (breaks, continues)
        self._exc_targets: list[object] = [EXC_EXIT]
        self._finally_stack: list[ast.stmt] = []  # innermost last
        body = fn_node.body if isinstance(fn_node.body, list) \
            else [ast.Expr(fn_node.body)]  # lambda
        frontier = self._block(body, {ENTRY})
        for n in frontier:
            self._edge(n, EXIT)
        self.preds: dict[object, set] = {k: set() for k in self.succs}
        for src, dsts in list(self.succs.items()) \
                + list(self.exc_succs.items()):
            for d in dsts:
                self.preds.setdefault(d, set()).add(src)

    # -- construction --------------------------------------------------------

    def _edge(self, src, dst) -> None:
        self.succs.setdefault(src, set()).add(dst)
        self.succs.setdefault(dst, set())

    def _exc_edge(self, src, dst) -> None:
        self.exc_succs.setdefault(src, set()).add(dst)
        self.succs.setdefault(dst, set())

    def _enter(self, stmt: ast.stmt, preds: set) -> None:
        for p in preds:
            self._edge(p, stmt)
        # a Try node evaluates nothing itself — giving it an exception
        # edge would fabricate a path that bypasses its own finally
        if may_raise(stmt) and not isinstance(stmt, ast.Try):
            self._exc_edge(stmt, self._exc_targets[-1])

    def _block(self, stmts: list, preds: set) -> set:
        """Wire `stmts` sequentially; returns the fall-through frontier."""
        frontier = set(preds)
        for stmt in stmts:
            if not frontier:
                break  # unreachable tail (after return/raise/break)
            self._enter(stmt, frontier)
            frontier = self._stmt(stmt)
        return frontier

    def _stmt(self, stmt: ast.stmt) -> set:
        if isinstance(stmt, (ast.Return, ast.Raise)):
            if isinstance(stmt, ast.Return):
                # a return inside try/finally runs the finally first
                if self._finally_stack:
                    self._edge(stmt, self._finally_stack[-1].finalbody[0])
                else:
                    self._edge(stmt, EXIT)
            else:
                self._edge(stmt, self._exc_targets[-1])
            return set()
        if isinstance(stmt, ast.Break):
            if self._loop_stack:
                self._loop_stack[-1][0].add(stmt)
            return set()
        if isinstance(stmt, ast.Continue):
            if self._loop_stack:
                self._loop_stack[-1][1].add(stmt)
            return set()
        if isinstance(stmt, ast.If):
            then = self._block(stmt.body, {stmt})
            if stmt.orelse:
                other = self._block(stmt.orelse, {stmt})
            else:
                other = {stmt}
            return then | other
        if isinstance(stmt, (ast.While, ast.For, ast.AsyncFor)):
            breaks: set = set()
            continues: set = set()
            self._loop_stack.append((breaks, continues))
            body_exit = self._block(stmt.body, {stmt})
            self._loop_stack.pop()
            for n in body_exit | continues:
                self._edge(n, stmt)  # back edge
            # loop exit: condition false (or iterator exhausted) / break;
            # while True only exits via break
            exits = set(breaks)
            infinite = isinstance(stmt, ast.While) \
                and isinstance(stmt.test, ast.Constant) \
                and stmt.test.value is True
            if not infinite:
                exits.add(stmt)
            if stmt.orelse and not infinite:
                exits = self._block(stmt.orelse, {stmt}) | set(breaks)
            return exits
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            return self._block(stmt.body, {stmt})
        if isinstance(stmt, ast.Try):
            return self._try(stmt)
        return {stmt}

    def _try(self, stmt: ast.Try) -> set:
        has_finally = bool(stmt.finalbody)
        # while inside the try body, exceptions flow to the handler
        # dispatch marker (handlers are tried in order but any may
        # match) or, with no handlers, straight to the finally
        exc_target: object
        if stmt.handlers:
            exc_target = ("handlers", stmt)
            self.succs.setdefault(exc_target, set())
        elif has_finally:
            exc_target = stmt.finalbody[0]
        else:
            exc_target = self._exc_targets[-1]
        self._exc_targets.append(exc_target)
        if has_finally:
            self._finally_stack.append(stmt)
        body_exit = self._block(stmt.body, {stmt})
        self._exc_targets.pop()

        after: set = set()
        if stmt.handlers:
            # handler bodies run with exceptions escaping to finally/outer
            inner_target = stmt.finalbody[0] if has_finally \
                else self._exc_targets[-1]
            for h in stmt.handlers:
                self._exc_targets.append(inner_target)
                h_exit = self._block(h.body, {exc_target})
                self._exc_targets.pop()
                after |= h_exit
            # an exception matching NO handler propagates — unless some
            # handler catches everything (bare / BaseException), in
            # which case no exception escapes the dispatch unhandled
            def _catches_all(h: ast.ExceptHandler) -> bool:
                if h.type is None:
                    return True
                types = h.type.elts if isinstance(h.type, ast.Tuple) \
                    else [h.type]
                return any(
                    isinstance(t, (ast.Name, ast.Attribute))
                    and (t.id if isinstance(t, ast.Name) else t.attr)
                    == "BaseException" for t in types)

            if not any(_catches_all(h) for h in stmt.handlers):
                self._edge(exc_target, stmt.finalbody[0] if has_finally
                           else self._exc_targets[-1])
        if stmt.orelse:
            body_exit = self._block(stmt.orelse, body_exit)
        after |= body_exit
        if has_finally:
            self._finally_stack.pop()
            fin_exit = self._block(stmt.finalbody, after if after
                                   else {stmt})
            # finally also re-raises (and completes returns): its exit
            # flows onward, toward EXIT (return-through-finally — via
            # any OUTER finally still pending, which must not be
            # bypassed), and to the outer exception target —
            # conservative all-ways edges
            exit_target = self._finally_stack[-1].finalbody[0] \
                if self._finally_stack else EXIT
            for n in fin_exit:
                self._edge(n, self._exc_targets[-1])
                self._edge(n, exit_target)
            return fin_exit
        return after

    # -- queries -------------------------------------------------------------

    def nodes(self):
        return self.succs.keys()

    def statements(self):
        return [n for n in self.succs
                if isinstance(n, ast.stmt)]


def dataflow_forward(cfg: CFG, transfer, entry_state=frozenset(),
                     exc_transfer=None):
    """Union-join forward may-analysis. `transfer(node, state) -> state`
    over frozensets; returns {node: IN-state}. Normal successors receive
    the post-state; exception successors receive `exc_transfer(node,
    state)` when given, else the PRE-state (see CFG) — a rule whose
    kills hold even when the statement raises (releasing a lease) passes
    an exc_transfer that applies kills but not gens.
    Deterministic: worklist in insertion order with stable re-queues."""
    in_states: dict = {n: frozenset() for n in cfg.succs}
    in_states[ENTRY] = entry_state
    # every node is processed at least once (a successor whose merged
    # state is unchanged still needs its own transfer run), then
    # re-queued only when its IN-state grows — monotone, terminates
    work = sorted(cfg.succs, key=_node_order)
    work.remove(ENTRY)
    work.insert(0, ENTRY)
    queued = set(work)
    while work:
        node = work.pop(0)
        queued.discard(node)
        state_in = in_states[node]
        out = transfer(node, state_in)
        exc_state = exc_transfer(node, state_in) if exc_transfer \
            else state_in
        targets = [(s, out) for s in sorted(cfg.succs.get(node, ()),
                                            key=_node_order)] \
            + [(s, exc_state) for s in sorted(cfg.exc_succs.get(node, ()),
                                              key=_node_order)]
        for succ, state in targets:
            merged = in_states[succ] | state
            if merged != in_states[succ]:
                in_states[succ] = merged
                if succ not in queued:
                    work.append(succ)
                    queued.add(succ)
    return in_states


def _node_order(node) -> tuple:
    if isinstance(node, ast.stmt):
        return (0, node.lineno, node.col_offset)
    if isinstance(node, tuple):  # handler dispatch marker
        return (1, node[1].lineno, 0)
    return (2, 0, 0, str(node))
