"""The etl-lint rule set (codebase-specific async-safety & device-sync).

Six rules, each encoding an invariant the round-5 advisor or a prior
VERDICT caught by hand (see docs/static-analysis.md for the contract and
worked examples):

  1. blocking-call-in-async   — sync sleep/subprocess/sqlite/socket/file
                                I/O lexically inside `async def` bodies in
                                runtime/, postgres/, api/
  2. device-sync-in-async     — host<->device sync points (.cpu(),
                                .item(), torch.cuda.synchronize, an event
                                wait, uploads, a kernel library's build,
                                the autotune probe) inside async code
                                unless routed through run_in_executor
  3. orphaned-task            — create_task/ensure_future whose handle is
                                discarded (GC may cancel the task mid-flight)
  4. unawaited-coroutine      — statement-level call of a locally-defined
                                `async def` without await/gather/create_task
  5. cancellation-swallow     — handlers that eat asyncio.CancelledError
                                anywhere, plus broad `except Exception` in
                                runtime/ that never re-raises
  6. hot-loop-host-transfer   — host transfers inside `@hot_loop`
                                functions; `@dispatch_stage` (the decode
                                pipeline's dispatch stage) sanctions
                                host→device uploads only
  7. unbounded-retry          — `while True` retry loops whose handlers
                                swallow exceptions and spin again with no
                                backoff (no sleep / RetryPolicy delay):
                                a failing dependency turns them into a
                                busy-loop hammering it at CPU speed
  8. unbounded-await          — bare `await q.get()` / `await ev.wait()`
                                in runtime/ and destinations/ without a
                                timeout or shutdown race: a producer that
                                dies (or an event nobody sets) wedges the
                                worker forever with no error — exactly
                                the silent-hang class the supervision
                                watchdog exists for; bound the await
                                (asyncio.wait_for / or_shutdown /
                                beat_while_waiting) or justify inline

Rules 1, 2, and 6 additionally run INTERPROCEDURALLY (interproc.py): a
blocking or host-transfer sink anywhere in the call closure of an
event-loop `async def` / `@hot_loop` function is reported with the full
call chain, and import aliases resolve (`from time import sleep`). Four
whole-program rules (arena-lease-leak, donated-buffer-use,
lock-held-across-await, lock-order-inversion) live there too — they
need the call graph and per-function CFGs, not a lexical walk.
"""

from __future__ import annotations

import ast
import os
from pathlib import Path

from .findings import _PACKAGE_SEGMENT, Finding, canonical_path
from .visitor import (LintContext, Rule, collect_async_defs, dotted_name,
                      handler_type_names, has_raise, lint_module,
                      terminal_name)

# -- rule 1 -------------------------------------------------------------------

#: directories whose async code runs on the replication event loop,
#: where one blocking call stalls keepalives for every table
EVENT_LOOP_SCOPES = ("runtime", "postgres", "api")

BLOCKING_DOTTED = frozenset({
    "time.sleep",
    "subprocess.run", "subprocess.call", "subprocess.check_call",
    "subprocess.check_output", "subprocess.Popen",
    "os.system", "os.popen", "os.waitpid",
    "sqlite3.connect",
    "socket.create_connection", "socket.getaddrinfo",
    "socket.gethostbyname",
    "urllib.request.urlopen",
    "requests.get", "requests.post", "requests.put", "requests.request",
})
#: bare built-in calls that hit the filesystem synchronously
BLOCKING_BARE = frozenset({"open"})


class BlockingCallInAsync(Rule):
    name = "blocking-call-in-async"

    def applies_to(self, rel_path: str) -> bool:
        head = rel_path.split("/", 1)[0]
        return head in EVENT_LOOP_SCOPES

    def on_call(self, ctx: LintContext, node: ast.Call) -> None:
        if not ctx.in_async:
            return
        dotted = dotted_name(node.func)
        subject = None
        if dotted in BLOCKING_DOTTED:
            subject = dotted
        elif isinstance(node.func, ast.Name) and node.func.id in BLOCKING_BARE:
            subject = node.func.id
        if subject is None:
            return
        # NOTE deliberately no run_in_executor argument exemption:
        # correct usage passes the callable UNCALLED (no Call node here),
        # while `run_in_executor(None, time.sleep(5))` runs the blocking
        # call eagerly on the loop — exactly when the rule must fire
        ctx.report(
            self.name, node, subject,
            f"blocking call `{subject}` inside async def stalls the "
            f"replication event loop; use the async equivalent or "
            f"loop.run_in_executor")


# -- the port's device sinks --------------------------------------------------
#
# The reference names JAX calls; the port names their PyTorch
# counterparts, in three families:
#   fetch  — the reference's `jax.device_get`, `np.asarray` of a device
#            value and `.block_until_ready()`: `.cpu()`, `.item()`,
#            `.tolist()`, `.numpy()`, `.to("cpu")`, `torch.cuda.
#            synchronize`, an Event's or a Stream's `.synchronize()`, and
#            a `.copy_(…)` without `non_blocking=True` (it waits for the
#            stream);
#   upload — the reference's `jax.device_put`: `.cuda()`, `.to(<device>)`
#            and `.copy_(…, non_blocking=True)`, which only enqueue; the
#            dispatch stage (@dispatch_stage) is where they belong;
#   build  — the reference's `jax.jit`: `program_store.acquire` and a
#            kernel module's `load()`, an nvcc build on a cold store.
# `np.asarray` of a CPU tensor is no sync in the port, so it is in no
# device set (rule 9 keeps it as a row-materialisation sink).

DEVICE_FETCH_DOTTED = frozenset({"torch.cuda.synchronize"})
DEVICE_BUILD_DOTTED = frozenset({
    "program_store.acquire",
    "decode_kernel.load", "decode_kernel.load_library",
    "egress_kernel.load", "egress_kernel.load_library",
})
AUTOTUNE_DOTTED = frozenset({"autotune.measure",
                             "autotune.resolve_device_min_rows"})

#: method-call sinks, by the subject `device_method` names them
FETCH_METHODS = frozenset({".cpu", ".item", ".tolist", ".numpy",
                           ".to(cpu)", ".synchronize", ".copy_"})
UPLOAD_METHODS = frozenset({".cuda", ".to(device)", ".copy_(non_blocking)"})
_PLAIN_FETCH_TERMINALS = frozenset({"cpu", "item", "tolist", "numpy",
                                    "synchronize"})
#: sinks numpy values have too (`present.tolist()` on a row index array):
#: they count only in a module that imports torch, where the receiver can
#: be a tensor — the port's form of the reference's "np.asarray of a
#: DEVICE value"
HOST_AMBIGUOUS_METHODS = frozenset({".item", ".tolist"})


def imports_torch(tree: ast.Module, source: str = "torch") -> bool:
    """Does the module import torch (at any depth: lazy imports count)?
    Cached on the tree; a source that never says `torch` is not walked."""
    cached = getattr(tree, "_etl_imports_torch", None)
    if cached is not None:
        return cached
    found = False
    if "torch" in source:
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                found = any(a.name.split(".", 1)[0] == "torch"
                            for a in node.names)
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                found = (node.module or "").split(".", 1)[0] == "torch"
            if found:
                break
    tree._etl_imports_torch = found
    return found


def _is_non_blocking(node: ast.Call) -> bool:
    return any(kw.arg == "non_blocking" and isinstance(kw.value, ast.Constant)
               and kw.value.value is True for kw in node.keywords)


def _to_target(node: ast.Call) -> "str | None":
    """"cpu" / "device" for a `.to(...)` that moves a tensor, None for a
    dtype cast. A move names its device by keyword, by a string, or by a
    name or attribute that says device (`dev`, `self.device`)."""
    arg = next((kw.value for kw in node.keywords if kw.arg == "device"),
               node.args[0] if node.args else None)
    if arg is None:
        return None
    if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
        return "cpu" if arg.value == "cpu" else "device"
    term = terminal_name(arg)
    if any(kw.arg == "device" for kw in node.keywords) \
            or (term is not None and (term in ("dev", "cuda")
                                      or "device" in term)):
        return "device"
    return None


def device_method(node: ast.Call, torch_module: bool = True) -> "str | None":
    """The sink subject of a method-call device sink (see the families
    above), or None; the host-ambiguous ones only in a module that
    imports torch."""
    func = node.func
    if not isinstance(func, ast.Attribute):
        return None
    term = func.attr
    if term in _PLAIN_FETCH_TERMINALS:
        subject = f".{term}"
        if subject in HOST_AMBIGUOUS_METHODS and not torch_module:
            return None
        return subject
    if term == "cuda":
        return ".cuda"
    if term == "copy_":
        return ".copy_(non_blocking)" if _is_non_blocking(node) else ".copy_"
    if term == "to":
        target = _to_target(node)
        if target is not None:
            return f".to({target})"
    return None


def device_sink(node: ast.Call, dotted_set: frozenset,
                method_set: frozenset,
                torch_module: bool = True) -> "str | None":
    """The subject of `node` when it is a sink of `dotted_set` (by its
    dotted name) or of `method_set` (by `device_method`), else None."""
    dotted = dotted_name(node.func)
    if dotted in dotted_set:
        return dotted
    subject = device_method(node, torch_module)
    return subject if subject in method_set else None


class _DeviceRule(Rule):
    """A rule over device sinks: knows whether its module imports torch."""

    torch_module = True

    def before_module(self, ctx: LintContext, tree: ast.Module) -> None:
        self.torch_module = imports_torch(tree, ctx.source)


# -- rule 2 -------------------------------------------------------------------

#: calls that synchronize with (or build for) the device — inside async
#: code each one stalls keepalives for the round trip
DEVICE_SYNC_DOTTED = DEVICE_FETCH_DOTTED | DEVICE_BUILD_DOTTED \
    | AUTOTUNE_DOTTED
DEVICE_SYNC_METHODS = FETCH_METHODS | UPLOAD_METHODS


class DeviceSyncInAsync(_DeviceRule):
    name = "device-sync-in-async"

    def on_call(self, ctx: LintContext, node: ast.Call) -> None:
        if not ctx.in_async:
            return
        subject = device_sink(node, DEVICE_SYNC_DOTTED, DEVICE_SYNC_METHODS,
                              self.torch_module)
        if subject is None:
            return
        # no run_in_executor argument exemption — see BlockingCallInAsync
        ctx.report(
            self.name, node, subject,
            f"device sync point `{subject}` inside async def blocks the "
            f"event loop on the host<->device link; dispatch and hand "
            f"back a pending handle, or route through run_in_executor")


# -- rule 3 -------------------------------------------------------------------

TASK_SPAWNERS = frozenset({"create_task", "ensure_future"})


class OrphanedTask(Rule):
    name = "orphaned-task"

    def _report(self, ctx: LintContext, call: ast.Call) -> None:
        subject = dotted_name(call.func) or terminal_name(call.func)
        ctx.report(
            self.name, call, subject,
            f"`{subject}` result discarded: the event loop holds only a "
            f"weak reference, so GC can cancel the task mid-flight — "
            f"keep the handle (and await it on shutdown)")

    def on_expr_statement(self, ctx: LintContext, node: ast.Expr) -> None:
        call = node.value
        if isinstance(call, ast.Call) \
                and terminal_name(call.func) in TASK_SPAWNERS:
            self._report(ctx, call)

    def on_call(self, ctx: LintContext, node: ast.Call) -> None:
        # `lambda: ensure_future(...)` as a callback (signal handlers,
        # add_done_callback): the lambda returns the handle but every
        # callback caller discards it — same GC hazard, different shape
        if terminal_name(node.func) not in TASK_SPAWNERS:
            return
        ancestors = ctx.ancestors()
        if ancestors and isinstance(ancestors[-1], ast.Lambda) \
                and ancestors[-1].body is node:
            self._report(ctx, node)


# -- rule 4 -------------------------------------------------------------------

class UnawaitedCoroutine(Rule):
    name = "unawaited-coroutine"

    def __init__(self) -> None:
        self._plain: set[str] = set()
        self._methods: dict[str, set[str]] = {}

    def before_module(self, ctx: LintContext, tree: ast.Module) -> None:
        self._plain, self._methods = collect_async_defs(tree)

    def on_expr_statement(self, ctx: LintContext, node: ast.Expr) -> None:
        call = node.value
        if not isinstance(call, ast.Call):
            return
        func = call.func
        subject = None
        if isinstance(func, ast.Name) and func.id in self._plain:
            subject = func.id
        elif (isinstance(func, ast.Attribute)
              and isinstance(func.value, ast.Name)
              and func.value.id in ("self", "cls")
              and func.attr in self._methods.get(
                  ctx.current_class or "", ())):
            subject = f"{func.value.id}.{func.attr}"
        if subject is None:
            return
        ctx.report(
            self.name, call, subject,
            f"`{subject}` is an async def: calling it without "
            f"await/gather/create_task builds a coroutine object and "
            f"silently drops it — the body never runs")


# -- rule 5 -------------------------------------------------------------------

class CancellationSwallow(Rule):
    name = "cancellation-swallow"

    @staticmethod
    def _is_cancel_drain(ctx: LintContext,
                         node: ast.ExceptHandler) -> bool:
        """The canonical safe idiom `t.cancel(); try: await t; except
        CancelledError: pass` — the swallow IS the point: awaiting a task
        you just cancelled raises its CancelledError into you. Recognized
        lexically (a `.cancel()` on the awaited target earlier in the
        same function, trivial handler body) so the repo's shutdown
        drains need no per-site suppression."""
        for stmt in node.body:
            if not (isinstance(stmt, (ast.Pass, ast.Continue, ast.Break))
                    or (isinstance(stmt, ast.Return)
                        and (stmt.value is None
                             or isinstance(stmt.value, ast.Constant)))):
                return False
        ancestors = ctx.ancestors()
        try_node = next((n for n in reversed(ancestors)
                         if isinstance(n, ast.Try)), None)
        if try_node is None or node not in try_node.handlers:
            return False
        targets = set()
        for stmt in try_node.body:
            for n in ast.walk(stmt):
                if isinstance(n, ast.Await):
                    d = dotted_name(n.value)
                    if d:
                        targets.add(d)
        if not targets:
            return False
        scope = next((n for n in reversed(ancestors)
                      if isinstance(n, (ast.FunctionDef,
                                        ast.AsyncFunctionDef))),
                     ancestors[0] if ancestors else try_node)
        for n in ast.walk(scope):
            if isinstance(n, ast.Call):
                d = dotted_name(n.func)
                if d is not None and d.endswith(".cancel") \
                        and d[:-len(".cancel")] in targets \
                        and getattr(n, "lineno", 1 << 30) <= node.lineno:
                    return True
        return False

    @staticmethod
    def _cancellation_shielded(ctx: LintContext,
                               node: ast.ExceptHandler) -> bool:
        """True when an EARLIER handler of the same `try` catches
        CancelledError and re-raises — cancellation never reaches `node`,
        so a broad catch there (panic containment) is not a swallow."""
        for anc in reversed(ctx.ancestors()):
            if isinstance(anc, ast.Try):
                for prior in anc.handlers:
                    if prior is node:
                        break
                    if "CancelledError" in handler_type_names(prior) \
                            and has_raise(prior):
                        return True
                return False
        return False

    def on_except_handler(self, ctx: LintContext,
                          node: ast.ExceptHandler) -> None:
        names = handler_type_names(node)
        if has_raise(node):
            return
        if self._is_cancel_drain(ctx, node):
            return
        if (("<bare>" in names or "BaseException" in names
                or "CancelledError" in names)
                and not self._cancellation_shielded(ctx, node)):
            caught = "except" if "<bare>" in names \
                else f"except {'|'.join(names)}"
            ctx.report(
                self.name, node, caught,
                f"`{caught}` catches asyncio.CancelledError and never "
                f"re-raises: shutdown/timeout cancellation dies here and "
                f"the worker keeps running")
            return
        broad = {"Exception", "BaseException", "<bare>"} & set(names)
        if broad and ctx.rel_path.split("/", 1)[0] == "runtime":
            caught = sorted(broad)[0]
            caught = "except" if caught == "<bare>" else f"except {caught}"
            ctx.report(
                self.name, node, caught,
                f"broad `{caught}` in runtime/ without re-raise hides "
                f"apply-loop failures; narrow it, re-raise, or baseline "
                f"with a justification")


# -- rule 6 -------------------------------------------------------------------

HOT_TRANSFER_DOTTED = DEVICE_FETCH_DOTTED
HOT_TRANSFER_METHODS = FETCH_METHODS | UPLOAD_METHODS

#: host→device UPLOADS and enqueued copies: inside a @dispatch_stage
#: function (the decode pipeline's dispatch stage, ops/pipeline.py
#: architecture) these are the point — the H2D copies of the packed
#: inputs and the D2H copies into pinned buffers ride the stream.
#: Fetch-side transfers (.cpu / .item / a synchronize) stay forbidden
#: there: they belong at the consumer, the fetch stage.
DISPATCH_UPLOADS = UPLOAD_METHODS


class HotLoopHostTransfer(_DeviceRule):
    name = "hot-loop-host-transfer"

    def on_call(self, ctx: LintContext, node: ast.Call) -> None:
        if not ctx.in_hot_loop:
            return
        subject = device_sink(node, HOT_TRANSFER_DOTTED,
                              HOT_TRANSFER_METHODS, self.torch_module)
        if subject is None:
            return
        if ctx.in_dispatch_stage and subject in DISPATCH_UPLOADS:
            return  # upload in the dispatch stage: sanctioned
        ctx.report(
            self.name, node, subject,
            f"host transfer `{subject}` inside a @hot_loop function "
            f"serializes the hot path against the device link; fetch at "
            f"the consumer (_PendingDecode.result) instead")


# -- rule 7 -------------------------------------------------------------------

#: calls that count as backoff inside a retry loop: sleeps (direct or
#: wrapped, e.g. or_shutdown(shutdown, asyncio.sleep(d))), the unified
#: RetryPolicy's delay schedule, and the destination retry wrapper
BACKOFF_TERMINALS = frozenset({"sleep", "delay", "delay_ms", "base_delay",
                               "with_retries"})
#: `.execute(...)` counts as backoff ONLY on a retry-policy receiver
#: (`policy.execute`, `self.retry.execute`) — a bare `cursor.execute`
#: inside a while-True hammer must NOT suppress the rule
_EXECUTE_RECEIVER_HINTS = ("retry", "policy")


class UnboundedRetry(Rule):
    """`while True` loops that catch exceptions, keep looping, and never
    back off. The swallowing handler turns a dead dependency into a
    CPU-speed hammer (connect storms against a down Postgres, request
    storms against a throttling destination). Fix: a RetryPolicy delay /
    sleep in the handler or loop body, or re-raise / break out."""

    name = "unbounded-retry"

    @staticmethod
    def _is_while_true(node: ast.While) -> bool:
        return isinstance(node.test, ast.Constant) and node.test.value is True

    @classmethod
    def _region(cls, node: ast.AST, with_loop_depth: bool = False):
        """The nodes belonging to ONE while-True's retry region: nested
        callables are pruned (they run in a different activation — the
        has_raise lesson, visitor._contains_raise), and nested while-True
        loops are pruned too (each gets its own on_while analysis: an
        inner hot spin must not be absolved by an outer loop's backoff,
        and one handler must not be reported per level). With
        `with_loop_depth`, yields (node, inside_inner_loop) so a
        handler's `break` can be judged against the loop it would
        actually exit."""
        stack = [(n, False) for n in ast.iter_child_nodes(node)]
        while stack:
            n, in_loop = stack.pop()
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda)):
                continue
            if isinstance(n, ast.While) and cls._is_while_true(n):
                continue
            yield (n, in_loop) if with_loop_depth else n
            nested = in_loop or isinstance(n, (ast.For, ast.AsyncFor,
                                               ast.While))
            stack.extend((c, nested) for c in ast.iter_child_nodes(n))

    @staticmethod
    def _exits_loop(handler: ast.ExceptHandler,
                    try_in_inner_loop: bool) -> bool:
        """Does the handler leave the retry loop? raise/return anywhere
        (nested callables pruned, including a def as the handler's own
        statement) exit the function; `break` counts only when it would
        exit the RETRY loop — not when the try already sits inside an
        inner loop (`try_in_inner_loop`) or the break is inside a loop
        nested within the handler."""

        def scan(node: ast.AST, in_nested_loop: bool) -> bool:
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef,
                                      ast.AsyncFunctionDef, ast.Lambda)):
                    continue
                if isinstance(child, (ast.Return, ast.Raise)):
                    return True
                if isinstance(child, ast.Break) and not in_nested_loop:
                    return True
                nested = in_nested_loop or isinstance(
                    child, (ast.For, ast.AsyncFor, ast.While))
                if scan(child, nested):
                    return True
            return False

        for stmt in handler.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue  # a def IS the statement: its body never runs here
            if isinstance(stmt, (ast.Return, ast.Raise)):
                return True
            if isinstance(stmt, ast.Break) and not try_in_inner_loop:
                return True
            if scan(stmt, try_in_inner_loop or isinstance(
                    stmt, (ast.For, ast.AsyncFor, ast.While))):
                return True
        return False

    @classmethod
    def _has_backoff(cls, node: ast.While) -> bool:
        for n in cls._region(node):
            if not isinstance(n, ast.Call):
                continue
            term = terminal_name(n.func)
            if term in BACKOFF_TERMINALS:
                return True
            if term == "execute":
                dotted = (dotted_name(n.func) or "").lower()
                receiver = dotted.rsplit(".", 1)[0]
                if any(h in receiver for h in _EXECUTE_RECEIVER_HINTS):
                    return True
        return False

    def on_while(self, ctx: LintContext, node: ast.While) -> None:
        if not self._is_while_true(node):
            return
        swallowing = []
        for n, in_inner_loop in self._region(node, with_loop_depth=True):
            if not isinstance(n, ast.Try):
                continue
            for handler in n.handlers:
                names = set(handler_type_names(handler))
                broad = names & {"Exception", "BaseException", "<bare>",
                                 "EtlError", "OSError", "ConnectionError",
                                 "ClientError", "TimeoutError"}
                if broad and not self._exits_loop(handler, in_inner_loop):
                    swallowing.append((handler, sorted(broad)[0]))
        if not swallowing or self._has_backoff(node):
            return
        handler, caught = min(swallowing,
                              key=lambda hc: hc[0].lineno)
        caught = "except" if caught == "<bare>" else f"except {caught}"
        ctx.report(
            self.name, handler, caught,
            f"`while True` retry loop swallows `{caught}` and spins with "
            f"no backoff — a failing dependency gets hammered at CPU "
            f"speed; add a RetryPolicy delay / sleep, or re-raise")


# -- rule 8 -------------------------------------------------------------------

#: directories whose workers must never park on an unbounded await: a
#: wedged queue pop / event wait there stalls replication silently
UNBOUNDED_AWAIT_SCOPES = ("runtime", "destinations")

#: awaited zero-arg methods that park until someone else acts
_PARKING_TERMINALS = frozenset({"get", "wait"})


class UnboundedAwait(Rule):
    """Bare `await X.get()` / `await X.wait()` with no timeout and no
    shutdown race. The sanctioned shapes never produce the flagged AST:
    `await asyncio.wait_for(q.get(), t)` and `await or_shutdown(sd,
    ev.wait())` await the WRAPPER call, and `asyncio.wait(...)` takes
    arguments. Receivers whose dotted path mentions shutdown are exempt —
    the shutdown signal IS the escape hatch the rule demands."""

    name = "unbounded-await"

    def applies_to(self, rel_path: str) -> bool:
        return rel_path.split("/", 1)[0] in UNBOUNDED_AWAIT_SCOPES

    def on_call(self, ctx: LintContext, node: ast.Call) -> None:
        ancestors = ctx.ancestors()
        if not ancestors or not isinstance(ancestors[-1], ast.Await):
            return
        if node.args or node.keywords:
            return  # q.get(timeout), asyncio.wait(tasks, ...) are bounded
        term = terminal_name(node.func)
        if term not in _PARKING_TERMINALS:
            return
        if not isinstance(node.func, ast.Attribute):
            return  # bare get()/wait() name: not a parking receiver
        receiver = dotted_name(node.func.value) or ""
        if receiver in ("self", "cls"):
            return  # a method on the worker itself, not an event/queue
        if "shutdown" in receiver.lower():
            return
        subject = f"{receiver}.{term}" if receiver else term
        ctx.report(
            self.name, node, subject,
            f"bare `await {subject}()` parks this worker until someone "
            f"else acts — a dead producer wedges it forever with no "
            f"error; bound it (asyncio.wait_for) or race it against "
            f"shutdown (or_shutdown), or justify with an inline ignore")


# -- rule 13 ------------------------------------------------------------------

#: lexical row-path sinks: constructing row objects, expanding a batch
#: into per-row events, or transposing rows into/out of a ColumnarBatch.
#: Inside a @hot_loop batch-encode entry point any of these means the
#: columnar egress path has fallen back to per-row Python — the exact
#: regression the fetch-to-wire refactor (ROADMAP item 2) removed.
ROW_MATERIALIZATION_CTORS = frozenset({"TableRow", "PartialTableRow"})
ROW_MATERIALIZATION_FREE_CALLS = frozenset({"expand_batch_events"})
ROW_MATERIALIZATION_METHODS = frozenset({"to_rows", "from_rows"})
#: predicate-compile sinks: binding a publication row filter re-resolves
#: columns, re-coerces every literal, and (on first dispatch) re-traces
#: the fused device program — decoder-CONSTRUCTION work. Inside a
#: @hot_loop function it runs per batch/flush, the exact per-batch
#: recompile the fused-filter design forbids (ops/predicate.py).
PREDICATE_COMPILE_CALLS = frozenset({"compile_row_filter",
                                     "parse_row_filter",
                                     "compile_texts", "compile_values"})


class HotLoopRowMaterialization(Rule):
    """`TableRow(...)` / `.to_rows()` / `.from_rows(...)` /
    `expand_batch_events(...)` inside a `@hot_loop` function: the columnar
    egress hot path is materializing Python row objects. Intentional
    compatibility-shim uses carry an inline ignore with a justification
    (they are the row fallback, not the hot path).

    Also covers the predicate-compile path (`compile_row_filter` /
    `parse_row_filter` / the per-row evaluator compilers): publication
    row filters compile ONCE at decoder construction; a compile inside a
    @hot_loop function re-binds and re-traces per batch."""

    name = "hot-loop-row-materialization"

    def on_call(self, ctx: LintContext, node: ast.Call) -> None:
        if not ctx.in_hot_loop:
            return
        term = terminal_name(node.func)
        subject = None
        pred_compile = False
        if term in ROW_MATERIALIZATION_CTORS \
                or term in ROW_MATERIALIZATION_FREE_CALLS:
            subject = f"{term}(…)"
        elif term in PREDICATE_COMPILE_CALLS:
            subject = f"{term}(…)"
            pred_compile = True
        elif term in ROW_MATERIALIZATION_METHODS \
                and isinstance(node.func, ast.Attribute):
            subject = f".{term}(…)"
        if subject is None:
            return
        if pred_compile:
            ctx.report(
                self.name, node, subject,
                f"row-filter compilation `{subject}` inside a @hot_loop "
                f"function: predicates compile at decoder construction, "
                f"never per batch — hoist it to __init__/startup, or "
                f"justify with an inline ignore")
            return
        ctx.report(
            self.name, node, subject,
            f"row materialization `{subject}` inside a @hot_loop "
            f"batch-encode entry point: encode from the ColumnarBatch "
            f"column-at-a-time instead, or justify the compatibility "
            f"shim with an inline ignore")


# -- rule 14 ------------------------------------------------------------------

#: device traffic forbidden on the admission grant path: the fetch set
#: from rule 6 PLUS the uploads — the @dispatch_stage upload sanction
#: does NOT extend here, because an admission decision holds the
#: scheduler's condition lock (or gates every tenant's dispatch), so ANY
#: device call head-of-line-blocks all tenants, uploads included
ADMISSION_DEVICE_DOTTED = HOT_TRANSFER_DOTTED
ADMISSION_DEVICE_METHODS = FETCH_METHODS | UPLOAD_METHODS


class AdmissionBlockingFetch(_DeviceRule):
    """Blocking device traffic inside the batch-admission scheduler's
    grant path (`@admission_path`, ops/pipeline.AdmissionScheduler): a
    `.cpu()` / `.item()` / a `synchronize()` / an upload
    under the scheduler lock serializes EVERY tenant's admission behind
    one tenant's device round trip — the fairness lock becomes a
    head-of-line blocker and a lagging tenant's weight can't help it.
    Lag/weight providers must read host state (LSN deltas, counters).
    Lexical, same sanctioning machinery as @dispatch_stage: the frame
    flag inherits into nested defs and lambdas (inline lag providers),
    not across call edges — keep helpers called from the grant path
    device-free or annotate them too."""

    name = "admission-blocking-fetch"

    def on_call(self, ctx: LintContext, node: ast.Call) -> None:
        if not ctx.in_admission_path:
            return
        subject = device_sink(node, ADMISSION_DEVICE_DOTTED,
                              ADMISSION_DEVICE_METHODS, self.torch_module)
        if subject is None:
            return
        ctx.report(
            self.name, node, subject,
            f"device call `{subject}` inside an @admission_path function "
            f"head-of-line-blocks every tenant's admission; read host "
            f"state in grant decisions and keep device traffic in the "
            f"dispatch/fetch stages")


# -- rule 15 ------------------------------------------------------------------

#: unfiltered full-table-list store reads: against a SHARED store these
#: return EVERY shard's tables, and shard-scoped code acting on the full
#: list re-copies / re-owns / purges tables a sibling pod owns
CROSS_SHARD_FULL_READS = frozenset({"get_table_states"})


class CrossShardTableAccess(Rule):
    """`X.get_table_states()` with no arguments inside a `@shard_scoped`
    function (sharding/): shard-scoped code must read through the
    shard view (`ShardScopedStore.owned_table_states()`), which filters
    the shared store down to the tables this shard's ShardMap slice owns.
    Lexical, same sanctioning machinery as @dispatch_stage: the frame
    flag inherits into nested defs and lambdas, not across call edges —
    keep helpers called from shard-scoped code on the filtered view or
    annotate them too. A deliberate cross-shard sweep (the coordinator's
    global view) carries an inline ignore with a justification."""

    name = "cross-shard-table-access"

    def on_call(self, ctx: LintContext, node: ast.Call) -> None:
        if not ctx.in_shard_scoped:
            return
        term = terminal_name(node.func)
        if term not in CROSS_SHARD_FULL_READS \
                or not isinstance(node.func, ast.Attribute):
            return
        if node.args or node.keywords:
            return  # a filter argument makes the read shard-aware
        ctx.report(
            self.name, node, f".{term}()",
            f"unfiltered `.{term}()` inside a @shard_scoped function "
            f"returns EVERY shard's tables on a shared store; read "
            f"through the shard view (owned_table_states()) or justify "
            f"the cross-shard sweep with an inline ignore")


# -- rule 16 ------------------------------------------------------------------

#: forbidden inside the autoscaling decision path: every blocking-I/O
#: sink rule 1 knows about, PLUS all device traffic (the admission set —
#: fetches AND uploads). The decision must be a pure function of the
#: already-sampled signal history: a blocking call ties decision latency
#: to an external service, a device call ties shard-count control to
#: accelerator health — the dependency loop an autoscaler must not have
#: (a sick device delaying the decision that would route around it).
CONTROL_LOOP_BLOCKING_DOTTED = BLOCKING_DOTTED | ADMISSION_DEVICE_DOTTED
CONTROL_LOOP_BLOCKING_BARE = BLOCKING_BARE
CONTROL_LOOP_BLOCKING_METHODS = ADMISSION_DEVICE_METHODS


class ControlLoopBlockingIo(_DeviceRule):
    """Blocking I/O or device traffic inside the autoscaling control
    loop's decision path (`@control_loop`, autoscale/): the
    signal→policy→decision computation must stay a pure, seeded-
    replayable function of (SignalFrame history, config) — that is what
    makes the policy property-testable and the decision trace
    deterministic per seed. Sampling (async store/registry reads) and
    actuation (coordinator/orchestrator calls) live OUTSIDE the marked
    path. Lexical, same sanctioning machinery as @dispatch_stage: the
    frame flag inherits into nested defs and lambdas (inline capacity
    estimators, sort keys), not across call edges — keep helpers called
    from the decision path free of blocking I/O or annotate them too."""

    name = "control-loop-blocking-io"

    def on_call(self, ctx: LintContext, node: ast.Call) -> None:
        if not ctx.in_control_loop:
            return
        if isinstance(node.func, ast.Name) \
                and node.func.id in CONTROL_LOOP_BLOCKING_BARE:
            subject = node.func.id
        else:
            subject = device_sink(node, CONTROL_LOOP_BLOCKING_DOTTED,
                                  CONTROL_LOOP_BLOCKING_METHODS,
                                  self.torch_module)
        if subject is None:
            return
        ctx.report(
            self.name, node, subject,
            f"blocking/device call `{subject}` inside a @control_loop "
            f"function: the autoscale decision path must be a pure "
            f"function of the sampled signal history — move I/O to the "
            f"collector (sampling) or the controller's actuation, or "
            f"justify with an inline ignore")


# -- rule 17 ------------------------------------------------------------------

#: the durability-wait terminal: awaiting it inline in a dispatch path
#: re-serializes the pipeline to one ack round-trip per batch
DURABILITY_WAIT_METHODS = frozenset({"wait_durable"})


class InlineDurabilityWait(Rule):
    """`await ack.wait_durable()` inside a `@flush_path` function (the
    apply loop's flush machinery, the copy partition's chunk/drain path):
    the bounded ack window (runtime/ack_window.py) OWNS durability waits
    — it chains submissions in WAL order, overlaps up to
    `BatchConfig.write_window` ack round-trips, advances durable
    progress over the contiguous acked prefix, and carries the per-entry
    timeout bounds and overlap telemetry. A bare inline wait silently
    reintroduces the one-in-flight ceiling (`batch_size / ack_rtt`) the
    window removes — route the ack through `AckWindow.dispatch` /
    `CopyAckWindow.add`, or justify a deliberate inline barrier with an
    inline ignore. Lexical, same sanctioning machinery as
    @dispatch_stage: the frame flag inherits into nested defs and
    lambdas (the flush submit closures), not across call edges."""

    name = "inline-durability-wait"

    def on_call(self, ctx: LintContext, node: ast.Call) -> None:
        if not ctx.in_flush_path:
            return
        term = terminal_name(node.func)
        if term not in DURABILITY_WAIT_METHODS \
                or not isinstance(node.func, ast.Attribute):
            return
        ctx.report(
            self.name, node, f".{term}()",
            f"bare `.{term}()` inside a @flush_path function "
            f"re-serializes the pipeline to one ack round-trip per "
            f"batch; the ack window owns durability waits — dispatch "
            f"through AckWindow/CopyAckWindow, or justify an inline "
            f"barrier with an inline ignore")


# -- rule 18 ------------------------------------------------------------------

#: destination write-path entry points: an `except Exception` that
#: re-raises unwrapped from one of these hands the worker retry layer a
#: failure with no ErrorKind — which the retry classifier treats as
#: UNKNOWN/TIMED and, worse, the poison-isolation protocol can never
#: trigger on (models.errors.POISON_KINDS needs a concrete kind)
DESTINATION_WRITE_FNS = frozenset({
    "write_events", "write_table_rows", "write_event_batches",
    "write_table_batch",
})

#: names whose appearance in a raised expression mean the failure was
#: classified: an EtlError construction, the shared classifiers, or
#: anything carrying an ErrorKind
_CLASSIFIED_RAISE_NAMES = ("EtlError", "ErrorKind", "etl_error",
                           "classify_http_error",
                           "classify_write_exception",
                           # the port's typed failure of a columnar fast
                           # render (destinations/util.py)
                           "fast_render_error")


class UnclassifiedDestinationError(Rule):
    """Broad `except Exception` (or bare `except`) on a destination
    write path or inside a `@flush_path` function whose body RE-RAISES
    without wrapping in `EtlError`/`ErrorKind`: the unclassified
    exception reaches the worker retry layer bare, where the retry
    classifier falls back to UNKNOWN (blind timed retry) and the
    poison-isolation protocol (runtime/poison.py) can never key on it —
    a permanent rejection retries forever instead of bisecting to the
    poison row. Wrap through `destinations.util.classify_write_exception`
    / `classify_http_error` (or construct a typed EtlError), or justify
    a deliberate passthrough with an inline ignore. Handlers that never
    re-raise are rule 5's (cancellation-swallow) business, not this
    rule's. Lexical: the flush-path frame flag inherits into nested
    defs/lambdas; the write-path function-name scope covers nested defs
    too (the retried `attempt()` closures)."""

    name = "unclassified-destination-error"

    @staticmethod
    def _raise_classified(node: ast.Raise) -> bool:
        if node.exc is None:
            return False  # bare re-raise: whatever was caught, unwrapped
        for n in ast.walk(node.exc):
            label = None
            if isinstance(n, ast.Name):
                label = n.id
            elif isinstance(n, ast.Attribute):
                label = n.attr
            if label in _CLASSIFIED_RAISE_NAMES:
                return True
        return False

    @staticmethod
    def _in_scope(ctx: LintContext) -> bool:
        if ctx.in_flush_path:
            return True
        if ctx.rel_path.split("/", 1)[0] != "destinations":
            return False
        return any(part in DESTINATION_WRITE_FNS
                   for part in ctx.scope.split("."))

    def on_except_handler(self, ctx: LintContext,
                          node: ast.ExceptHandler) -> None:
        if not self._in_scope(ctx):
            return
        names = set(handler_type_names(node))
        if not ({"Exception", "<bare>"} & names):
            return
        raises = [n for stmt in node.body for n in ast.walk(stmt)
                  if isinstance(n, ast.Raise)]
        if not raises:
            return  # swallowing is cancellation-swallow's concern
        if all(self._raise_classified(r) for r in raises):
            return
        caught = "except" if "<bare>" in names else "except Exception"
        ctx.report(
            self.name, node, caught,
            f"`{caught}` on a destination write path re-raises without "
            f"wrapping in EtlError/ErrorKind: the unclassified failure "
            f"reaches the retry layer bare (blind UNKNOWN retry, and "
            f"the poison-isolation trigger can never fire) — wrap via "
            f"destinations.util.classify_write_exception / "
            f"classify_http_error, or justify with an inline ignore")


# -- rule 19 ------------------------------------------------------------------

#: logger-method terminals whose arguments are emitted to logs. `.log`
#: rides along: any `.log(...)`-shaped call carrying a secret argument
#: deserves a look regardless of the receiver.
LOG_SINK_METHODS = frozenset({
    "debug", "info", "warning", "error", "exception", "critical", "log",
})

#: metric-emission calls whose `labels=` values are exported to the
#: metrics endpoint (runtime/telemetry.py registry surface)
METRIC_LABEL_CALLS = frozenset({
    "counter_inc", "gauge_set", "histogram_observe", "labels",
})

#: attribute/variable names bound to secret-typed config fields. The
#: config loader (config/load.py) wraps these in `Secret`, whose repr()
#: redacts — but str()/f-string INTERPOLATION yields the raw value
#: (Secret subclasses str), so reaching a log sink is a leak either way.
#: Mirrors the api/orchestrator.py redaction list.
SECRET_NAMES = frozenset({
    "password", "api_key", "secret_key", "private_key_pem",
    "catalog_token", "auth_token", "access_token",
})
#: deliberately NOT including bare "_token": replication progress tokens
#: (offset_token, continuation/page tokens) are identifiers, not secrets
SECRET_NAME_SUFFIXES = ("_password", "_secret", "_api_key",
                        "_auth_token", "_access_token")
#: name prefixes that mark a DERIVED non-secret (presence flags,
#: switches): `has_password` is shape, not value
_NONSECRET_PREFIXES = ("has_", "is_", "use_", "with_", "without_",
                       "no_", "needs_", "require_", "allow_")


def _is_secret_name(name: str) -> bool:
    if name.startswith(_NONSECRET_PREFIXES):
        return False
    return name in SECRET_NAMES or name.endswith(SECRET_NAME_SUFFIXES)


def _secret_subjects(tree: ast.AST) -> "list[str]":
    """Secret-valued subexpressions anywhere under `tree`, normalized:
    `.expose()` unwrap calls, secret-named attributes (`cfg.password`),
    and bare secret-named locals. Order is source order (ast.walk)."""
    out = []
    for n in ast.walk(tree):
        if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute) \
                and n.func.attr == "expose":
            out.append(".expose()")
        elif isinstance(n, ast.Attribute):
            if _is_secret_name(n.attr):
                out.append(f".{n.attr}")
        elif isinstance(n, ast.Name):
            if _is_secret_name(n.id):
                out.append(n.id)
    return out


class SecretInLog(Rule):
    """A secret-typed value (config `Secret` fields, `.expose()` unwraps,
    secret-named variables) interpolated into a logging call, an
    exception message, or a metric label value.

    `Secret.__repr__` redacts, but `Secret` subclasses `str`: %-format,
    `.format`, and f-string interpolation all emit the RAW value, and an
    `.expose()` result is a plain str with no protection at all. Log
    pipelines, exception trackers, and metric endpoints are all
    exported surfaces — log presence/shape (`"password=[set]"`), never
    the value."""

    name = "secret-in-log"

    def on_call(self, ctx: LintContext, node: ast.Call) -> None:
        term = terminal_name(node.func)
        if isinstance(node.func, ast.Attribute) \
                and term in LOG_SINK_METHODS:
            targets = list(node.args) + [kw.value for kw in node.keywords]
            sink = f"logging call `.{term}(…)`"
        elif term in METRIC_LABEL_CALLS:
            targets = [kw.value for kw in node.keywords
                       if kw.arg == "labels"]
            sink = f"metric labels of `{term}(…)`"
        elif any(isinstance(a, ast.Raise) for a in ctx.ancestors()):
            targets = list(node.args) + [kw.value for kw in node.keywords]
            sink = "exception message"
        else:
            return
        seen: set = set()
        for t in targets:
            for subject in _secret_subjects(t):
                if subject in seen:
                    continue
                seen.add(subject)
                ctx.report(
                    self.name, node, subject,
                    f"secret value `{subject}` reaches {sink}: Secret's "
                    f"repr redacts but str/f-string interpolation emits "
                    f"the raw value — log presence or shape "
                    f"(\"password=[set]\"), never the secret itself")


# -- rule 20 ------------------------------------------------------------------

#: CDC/copy write entry points that land data WITHOUT coordinates when
#: called from a transactional-commit seam; the `*_committed` variants
#: carry their range and are always fine
UNCOORDINATED_WRITE_FNS = frozenset({
    "write_events", "write_event_batches", "write_table_rows",
    "write_table_batch",
})


class UncoordinatedTransactionalWrite(Rule):
    """A `@transactional_commit` function (the exactly-once seam,
    docs/destinations.md) that performs a CDC write while NEVER
    consulting its commit-range parameter: the data lands but the WAL
    coordinate range is never recorded with it, so a crash-restart
    cannot recover the sink's high-water mark and the destination
    silently degrades to at-least-once while still ADVERTISING
    `supports_transactional_commit()` — the worst of both (the apply
    loop trusts the seam, recovery trusts the marker). Every committed
    write path must derive its dedup token / MERGE key / snapshot
    property / offset from the `commit` argument (or explicitly forward
    it to an inner `*_committed` call); a deliberate pass-through (e.g.
    offset-token sinks whose plain path already carries coordinates)
    justifies itself by touching `commit` to decide, or with an inline
    ignore. Whole-function and lexical: nested defs/lambdas (retried
    write closures) belong to the marked function's body."""

    name = "uncoordinated-transactional-write"

    @staticmethod
    def _commit_param(node) -> "str | None":
        args = node.args
        params = [a.arg for a in args.posonlyargs + args.args
                  + args.kwonlyargs]
        if "commit" in params:
            return "commit"
        # the base seam signature is (self, events, commit)
        if len(params) > 2 and params[0] in ("self", "cls"):
            return params[2]
        if len(params) > 1 and params[0] not in ("self", "cls"):
            return params[1]
        return None

    def on_function(self, ctx: LintContext, node) -> None:
        from .visitor import TRANSACTIONAL_COMMIT_DECORATORS

        if ctx.in_transactional_commit:
            return  # a nested def: the enclosing marked frame's analysis
            # already covered this body
        decorators = {terminal_name(d.func if isinstance(d, ast.Call)
                                    else d)
                      for d in node.decorator_list}
        if not (decorators & TRANSACTIONAL_COMMIT_DECORATORS):
            return
        commit = self._commit_param(node)
        consulted = commit is not None and any(
            isinstance(n, ast.Name) and n.id == commit
            and isinstance(n.ctx, ast.Load)
            for stmt in node.body for n in ast.walk(stmt))
        if consulted:
            return
        for stmt in node.body:
            for n in ast.walk(stmt):
                if not isinstance(n, ast.Call):
                    continue
                term = terminal_name(n.func)
                if term not in UNCOORDINATED_WRITE_FNS:
                    continue
                ctx.report(
                    self.name, n, f"{term}()",
                    f"`{term}()` inside a @transactional_commit function "
                    f"that never consults its commit-range parameter"
                    f"{f' `{commit}`' if commit else ''}: the data lands "
                    f"without its WAL coordinates, so recovery cannot "
                    f"rebuild the high-water mark — derive the dedup "
                    f"token / commit marker from the commit range, or "
                    f"justify a deliberate pass-through with an inline "
                    f"ignore")


# -- entry points -------------------------------------------------------------

def default_rules() -> list[Rule]:
    return [
        BlockingCallInAsync(),
        DeviceSyncInAsync(),
        OrphanedTask(),
        UnawaitedCoroutine(),
        CancellationSwallow(),
        HotLoopHostTransfer(),
        UnboundedRetry(),
        UnboundedAwait(),
        HotLoopRowMaterialization(),
        AdmissionBlockingFetch(),
        CrossShardTableAccess(),
        ControlLoopBlockingIo(),
        InlineDurabilityWait(),
        UnclassifiedDestinationError(),
        SecretInLog(),
        UncoordinatedTransactionalWrite(),
    ]


#: whole-program rules (analysis/interproc.py) — they have no
#: per-module Rule class; listed here so --list-rules and suppression
#: docs stay complete
INTERPROC_RULE_NAMES = (
    "arena-lease-leak",
    "donated-buffer-use",
    "lock-held-across-await",
    "lock-order-inversion",
    # concurrency tier (analysis/concurrency.py)
    "unsynchronized-shared-mutation",
    "loop-state-from-thread",
    "coordinator-store-bypass",
)

RULE_NAMES = tuple(r.name for r in default_rules()) + INTERPROC_RULE_NAMES


def analyze_source(source: str, rel_path: str,
                   rules: list[Rule] | None = None,
                   interprocedural: bool = True) -> list[Finding]:
    """Lint one module's source. `rel_path` drives path-scoped rules and
    fixture trees mirror the package layout, so `runtime/foo.py` gets the
    runtime/ rule scoping whether it is real or a test snippet. The
    whole-program pass runs over the single module (cross-module targets
    stay unresolved, by design)."""
    import ast as ast_mod

    from .interproc import ModuleUnit, analyze_interprocedural
    from .visitor import Suppressions

    tree = ast_mod.parse(source, filename=rel_path)
    supp = Suppressions(source)
    findings = lint_module(source, rel_path, rules or default_rules(),
                           tree=tree, suppressions=supp)
    if interprocedural:
        findings = findings + analyze_interprocedural(
            [ModuleUnit(canonical_path(rel_path), source, tree, supp)])
        findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings


def iter_python_files(path: str | Path) -> "list[Path]":
    p = Path(path)
    if p.is_file():
        return [p]
    return sorted(f for f in p.rglob("*.py")
                  if "__pycache__" not in f.parts)


def analyze_paths(paths, root: "str | None" = None,
                  scanned: "list[str] | None" = None,
                  interprocedural: bool = True,
                  lexical: bool = True,
                  units_out: "list | None" = None) -> list[Finding]:
    """Lint every .py under `paths`. Rel paths are computed against each
    argument (directory args act as scan roots), then canonicalized, so
    `analyze_paths(["etl_tpu_torch"])` and `analyze_paths(["."])` fingerprint
    identically. When `scanned` is given, the canonical path of every
    file visited is appended to it (clean files included) — baseline
    updates need the full scan scope, not just files with findings.

    All modules are parsed first, then the per-module lexical pass and
    the whole-program interprocedural pass run over the same trees —
    cross-module call chains resolve only within the scanned set, so a
    scoped run sees a smaller closure (fingerprints of what it DOES see
    are identical to the full run's). `units_out`, when given, receives
    the interproc ModuleUnits (path, source, tree, suppressions) —
    `--check-baseline` reads per-module suppression usage from them."""
    import ast as ast_mod

    from .interproc import ModuleUnit, analyze_interprocedural
    from .visitor import Suppressions

    units: list = []
    for arg in paths:
        if not Path(arg).exists():
            # a typo'd path silently scanning nothing would keep CI green
            raise OSError(f"no such path: {arg}")
        for f in iter_python_files(arg):
            resolved = f.resolve()
            # fingerprint identity must not depend on HOW the file was
            # reached: `analysis etl_tpu_torch`, `analysis
            # etl_tpu_torch/api`, and `analysis etl_tpu_torch/api/db.py`
            # all canonicalize db.py to
            # api/db.py, or path-scoped rules and baseline matching
            # silently break for scoped runs. Package files key off the
            # etl_tpu_torch segment of the FULL path (caveat: a checkout
            # whose root dir is itself named etl_tpu_torch would confuse
            # this);
            # mirror trees (fixtures) key off the scan root.
            if root is not None:
                base = Path(root).resolve()
            elif _PACKAGE_SEGMENT in resolved.parts:
                base = None  # canonical_path strips to the package
            elif Path(arg).is_dir():
                base = Path(arg).resolve()
            else:
                base = Path.cwd()
            rel = resolved
            if base is not None:
                try:
                    rel = resolved.relative_to(base)
                except ValueError:
                    pass
            canon = canonical_path(rel.as_posix())
            if scanned is not None:
                scanned.append(canon)
            source = f.read_text(encoding="utf-8")
            try:
                tree = ast_mod.parse(source, filename=str(f))
            except SyntaxError as e:
                raise SyntaxError(
                    f"etl-lint: cannot parse {f}: {e}") from e
            units.append(ModuleUnit(canon, source, tree,
                                    Suppressions(source)))

    findings: list[Finding] = []
    if lexical:
        for u in units:
            findings.extend(lint_module(u.source, u.path, default_rules(),
                                        tree=u.tree,
                                        suppressions=u.suppressions))
    if interprocedural:
        findings.extend(analyze_interprocedural(units))
    if units_out is not None:
        units_out.extend(units)
    findings.sort(key=lambda x: (x.path, x.line, x.col, x.rule))
    return findings


def repo_package_dir() -> Path:
    """The installed etl_tpu_torch package directory (the default scan
    target)."""
    return Path(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
