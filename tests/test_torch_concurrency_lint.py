"""The port's concurrency tier of etl-lint (`etl_tpu_torch.analysis`):
the reference's tests/test_concurrency_lint.py restated on the port's
analyzer — execution-domain inference edge cases (nested `to_thread`
lambdas, `functools.partial` thread targets, `@domain` pin overrides,
cycles through thread-spawn edges), determinism of the fixture runs
including witness chains, the rule behaviors fixtures can't pin (chains,
inline suppression), and regression tests for the port's lazy caches
that the loop and an offload thread both reach (the autotune probe, the
kernel library's load, the decoder's host specs).
"""

from __future__ import annotations

import ast
import threading
import time
from pathlib import Path

from etl_tpu_torch.analysis import analyze_source
from etl_tpu_torch.analysis.callgraph import Project
from etl_tpu_torch.analysis.cli import main as cli_main
from etl_tpu_torch.analysis.domains import (COORDINATOR, EXECUTOR, LOOP,
                                            SWEEP, WORKER, infer_domains)

FIXTURES = Path(__file__).parent / "fixtures" / "lint"


def build_project(*mods: "tuple[str, str]") -> Project:
    return Project.build([(p, s, ast.parse(s)) for p, s in mods])


def fn_of(project: Project, path: str, qual: str):
    return project.modules[path].functions[qual]


class TestDomainInference:
    def test_async_def_is_loop_and_thread_target_is_worker(self) -> None:
        src = ("import threading\n\n\n"
               "def run():\n"
               "    pass\n\n\n"
               "async def main():\n"
               "    threading.Thread(target=run).start()\n")
        proj = build_project(("runtime/x.py", src))
        dm = infer_domains(proj)
        assert dm.of(fn_of(proj, "runtime/x.py", "main")) == {LOOP}
        # target=run is a REFERENCE, not a call edge: run must NOT
        # inherit loop from its spawner, only root as worker
        assert dm.of(fn_of(proj, "runtime/x.py", "run")) == {WORKER}

    def test_nested_to_thread_lambda_propagates_executor(self) -> None:
        """An inline lambda handed to `asyncio.to_thread` is the pool
        thread's entry point: its body's callees run in the executor
        domain even though the callgraph leaves the lambda unowned."""
        src = ("import asyncio\n\n\n"
               "def helper():\n"
               "    return 1\n\n\n"
               "async def offload():\n"
               "    await asyncio.to_thread(lambda: helper())\n")
        proj = build_project(("runtime/x.py", src))
        dm = infer_domains(proj)
        helper = fn_of(proj, "runtime/x.py", "helper")
        assert dm.of(helper) == {EXECUTOR}
        lambdas = [q for q in proj.modules["runtime/x.py"].functions
                   if "<lambda@" in q]
        assert len(lambdas) == 1 and lambdas[0].startswith("offload.<lambda@")
        assert EXECUTOR in dm.of(fn_of(proj, "runtime/x.py", lambdas[0]))
        # the witness chain roots at the synthesized lambda
        info = dm.info(helper, EXECUTOR)
        assert info is not None and info.chain[0] == lambdas[0]
        assert info.chain[-1] == "helper"

    def test_functools_partial_thread_target_unwraps(self) -> None:
        src = ("import functools\n"
               "import threading\n\n\n"
               "def work(n):\n"
               "    pass\n\n\n"
               "def spawn():\n"
               "    threading.Thread(target=functools.partial(work, 3))"
               ".start()\n")
        proj = build_project(("runtime/x.py", src))
        dm = infer_domains(proj)
        work = fn_of(proj, "runtime/x.py", "work")
        assert dm.of(work) == {WORKER}
        info = dm.info(work, WORKER)
        assert info.origin.startswith("spawned at runtime/x.py:")

    def test_supervision_spawn_is_sweep_domain(self) -> None:
        src = ("import threading\n\n\n"
               "def sweep_once():\n"
               "    pass\n\n\n"
               "def install():\n"
               "    threading.Thread(target=sweep_once).start()\n")
        proj = build_project(("supervision/x.py", src))
        dm = infer_domains(proj)
        assert dm.of(fn_of(proj, "supervision/x.py", "sweep_once")) == {SWEEP}

    def test_domain_pin_overrides_inferred_and_records_conflict(self) -> None:
        """@domain("worker") on an async def: the pin wins (the function
        drops its intrinsic loop root) and the rejected propagation is
        recorded for introspection — both the intrinsic root and the
        awaited-call edge from a loop caller."""
        src = ("from etl_tpu_torch.analysis.annotations import domain\n\n\n"
               "@domain(\"worker\")\n"
               "async def pinned():\n"
               "    pass\n\n\n"
               "async def caller():\n"
               "    await pinned()\n")
        proj = build_project(("runtime/x.py", src))
        dm = infer_domains(proj)
        pinned = fn_of(proj, "runtime/x.py", "pinned")
        assert dm.of(pinned) == {WORKER}
        assert dm.pins[id(pinned)] == WORKER
        rejected = [(fn, pin, dom) for fn, pin, dom, _chain in dm.conflicts
                    if fn is pinned]
        assert rejected and all(pin == WORKER and dom == LOOP
                                for _fn, pin, dom in rejected)

    def test_pinned_domain_still_propagates_outward(self) -> None:
        src = ("from etl_tpu_torch.analysis.annotations import domain\n\n\n"
               "def callee():\n"
               "    pass\n\n\n"
               "@domain(\"coordinator\")\n"
               "def tick():\n"
               "    callee()\n")
        proj = build_project(("fleet/x.py", src))
        dm = infer_domains(proj)
        assert COORDINATOR in dm.of(fn_of(proj, "fleet/x.py", "callee"))

    def test_cycle_through_thread_spawn_edge_terminates(self) -> None:
        """_run → start (call edge) while start spawns _run again: the
        restart-on-crash shape. Inference must terminate and classify
        both sides worker without leaking any other domain."""
        src = ("import threading\n\n\n"
               "class Pump:\n"
               "    def start(self):\n"
               "        threading.Thread(target=self._run).start()\n\n"
               "    def _run(self):\n"
               "        self.start()\n")
        proj = build_project(("runtime/x.py", src))
        dm = infer_domains(proj)
        assert dm.of(fn_of(proj, "runtime/x.py", "Pump._run")) == {WORKER}
        assert dm.of(fn_of(proj, "runtime/x.py", "Pump.start")) == {WORKER}

    def test_unawaited_async_callee_does_not_inherit(self) -> None:
        """Calling an async def without awaiting builds a coroutine; the
        callee does not run in the caller's thread domain."""
        src = ("import asyncio\n"
               "import threading\n\n\n"
               "async def job():\n"
               "    pass\n\n\n"
               "def poll(loop):\n"
               "    asyncio.run_coroutine_threadsafe(job(), loop)\n\n\n"
               "def install(loop):\n"
               "    threading.Thread(target=poll, args=(loop,)).start()\n")
        proj = build_project(("runtime/x.py", src))
        dm = infer_domains(proj)
        assert dm.of(fn_of(proj, "runtime/x.py", "poll")) == {WORKER}
        assert dm.of(fn_of(proj, "runtime/x.py", "job")) == {LOOP}


class TestDeterminism:
    def test_fixture_domain_dump_is_byte_identical(self, capsys) -> None:
        """Two `--domains` runs over the fixture tree: identical bytes,
        line-sorted output."""
        assert cli_main([str(FIXTURES), "--domains"]) == 0
        first = capsys.readouterr().out
        assert cli_main([str(FIXTURES), "--domains"]) == 0
        second = capsys.readouterr().out
        assert first == second
        lines = [l for l in first.splitlines() if l]
        keys = [tuple(l.split(": ")[0].split("::")) for l in lines]
        assert keys == sorted(keys)  # stable (path, qualname) order
        assert any("bad_shared_mutation.py::ProgressBoard._run: worker"
                   in l for l in lines)

    def test_fixture_findings_and_chains_are_byte_identical(self) -> None:
        from etl_tpu_torch.analysis.rules import analyze_paths

        one = analyze_paths([str(FIXTURES)])
        two = analyze_paths([str(FIXTURES)])
        render = lambda fs: [(f.fingerprint, f.line, f.col, f.chain,
                              f.chain_sites, f.explain()) for f in fs]
        assert render(one) == render(two)


class TestConcurrencyRules:
    def test_shared_mutation_chain_reaches_indirect_write(self) -> None:
        """The write sits one call below the thread entry: the finding
        carries the worker-side witness chain to the racy write."""
        src = ("import threading\n\n\n"
               "class Board:\n"
               "    def __init__(self):\n"
               "        self.count = 0\n"
               "        threading.Thread(target=self._run).start()\n\n"
               "    def _run(self):\n"
               "        self._bump()\n\n"
               "    def _bump(self):\n"
               "        self.count = self.count + 1\n\n"
               "    async def reset(self):\n"
               "        self.count = 0\n")
        findings = [f for f in analyze_source(src, "runtime/x.py")
                    if f.rule == "unsynchronized-shared-mutation"]
        assert len(findings) == 1, [f.render() for f in findings]
        assert findings[0].chain == ("Board._run", "Board._bump")
        assert "Board.count" in findings[0].detail

    def test_inline_suppression_on_anchor_write(self) -> None:
        src = ("import threading\n\n\n"
               "class Board:\n"
               "    def __init__(self):\n"
               "        self.count = 0\n"
               "        threading.Thread(target=self._run).start()\n\n"
               "    def _run(self):\n"
               "        self.count = 1"
               "  # etl-lint: ignore[unsynchronized-shared-mutation]"
               " — test\n\n"
               "    async def reset(self):\n"
               "        self.count = 0\n")
        assert not [f for f in analyze_source(src, "runtime/x.py")
                    if f.rule == "unsynchronized-shared-mutation"]

    def test_thread_lock_guard_on_both_sides_is_clean(self) -> None:
        src = ("import threading\n\n\n"
               "class Board:\n"
               "    def __init__(self):\n"
               "        self._mu = threading.Lock()\n"
               "        self.count = 0\n"
               "        threading.Thread(target=self._run).start()\n\n"
               "    def _run(self):\n"
               "        with self._mu:\n"
               "            self.count = 1\n\n"
               "    async def reset(self):\n"
               "        with self._mu:\n"
               "            self.count = 0\n")
        assert not [f for f in analyze_source(src, "runtime/x.py")
                    if f.rule == "unsynchronized-shared-mutation"]

    def test_asyncio_lock_does_not_guard_cross_thread_writes(self) -> None:
        """An asyncio.Lock serializes loop tasks only; holding one on
        the loop side must NOT silence a loop-vs-worker race."""
        src = ("import asyncio\n"
               "import threading\n\n\n"
               "class Board:\n"
               "    def __init__(self):\n"
               "        self._mu = asyncio.Lock()\n"
               "        self.count = 0\n"
               "        threading.Thread(target=self._run).start()\n\n"
               "    def _run(self):\n"
               "        self.count = 1\n\n"
               "    async def reset(self):\n"
               "        async with self._mu:\n"
               "            self.count = 0\n")
        findings = [f for f in analyze_source(src, "runtime/x.py")
                    if f.rule == "unsynchronized-shared-mutation"]
        assert len(findings) == 1

    def test_module_global_rebind_races(self) -> None:
        src = ("import threading\n\n"
               "_CACHE = None\n\n\n"
               "def _fill():\n"
               "    global _CACHE\n"
               "    _CACHE = [1]\n\n\n"
               "async def ensure():\n"
               "    global _CACHE\n"
               "    if _CACHE is None:\n"
               "        _CACHE = [2]\n\n\n"
               "def install():\n"
               "    threading.Thread(target=_fill).start()\n")
        findings = [f for f in analyze_source(src, "runtime/x.py")
                    if f.rule == "unsynchronized-shared-mutation"]
        assert len(findings) == 1
        assert "_CACHE" in findings[0].detail


class TestRaceRegressions:
    """The port's lazy caches that the loop and an offload thread (the
    pipeline's `to_thread` loads, prewarm's executor) both reach, pinned
    single-flight."""

    def _race(self, call, entered: threading.Event,
              release: threading.Event):
        """Two threads through `call`; the first blocks inside until the
        second has had a chance to pile onto the lock."""
        results: list = [None, None]

        def run(i):
            results[i] = call()

        t1 = threading.Thread(target=run, args=(0,))
        t2 = threading.Thread(target=run, args=(1,))
        t1.start()
        assert entered.wait(timeout=10)
        t2.start()
        time.sleep(0.05)  # let t2 pass the fast path and block
        release.set()
        t1.join(timeout=10)
        t2.join(timeout=10)
        assert not t1.is_alive() and not t2.is_alive()
        return results

    def test_autotune_measure_is_single_flight(self, monkeypatch) -> None:
        import torch

        from etl_tpu_torch.ops import autotune

        monkeypatch.setattr(autotune, "_MEASURED", None)
        entered, release, calls = threading.Event(), threading.Event(), []

        def fake_available():
            calls.append(1)
            entered.set()
            release.wait(timeout=10)
            return False

        monkeypatch.setattr(torch.cuda, "is_available", fake_available)
        results = self._race(autotune.measure, entered, release)
        assert len(calls) == 1, "second caller re-ran the probe"
        assert results == [None, None]
        assert autotune._MEASURED == [None]

    def test_program_store_acquire_is_single_flight(self, monkeypatch,
                                                    tmp_path) -> None:
        """Two threads acquiring one library from a cold store (the
        loop's decoder construction beside the pipeline's `to_thread`
        load): one build, one bound library for both."""
        from etl_tpu_torch import native
        from etl_tpu_torch.ops import program_store

        monkeypatch.setattr(program_store, "_CONFIGURED", [str(tmp_path)])
        entered, release, calls = threading.Event(), threading.Event(), []
        real_build = program_store._build

        def slow_build(lib, tag):
            calls.append(lib.name)
            entered.set()
            release.wait(timeout=10)
            return real_build(lib, tag)

        monkeypatch.setattr(program_store, "_build", slow_build)
        results = self._race(lambda: program_store.acquire(native.LIBRARY),
                             entered, release)
        assert calls == ["framer"], "second caller built again"
        assert [r.source for r in results] == ["build", "memory"]
        assert results[0].lib is results[1].lib

    def test_device_decoder_host_specs_eager_at_init(self) -> None:
        """`_host_specs_cache` fills in __init__ (init-before-spawn), not
        lazily on first call."""
        from etl_tpu_torch.models import (ColumnSchema, Oid,
                                          ReplicatedTableSchema, TableName,
                                          TableSchema)
        from etl_tpu_torch.ops.engine import DeviceDecoder

        rts = ReplicatedTableSchema.with_all_columns(TableSchema(
            7, TableName("public", "t"),
            (ColumnSchema("id", Oid.INT4, nullable=False,
                          primary_key_ordinal=1),)))
        dec = DeviceDecoder(rts, device="cpu", device_min_rows=1 << 30,
                            host_min_rows=0)
        assert isinstance(dec._host_specs_cache, tuple)
        assert dec._host_specs_cache, "cache empty for a dense schema"
        assert dec._host_specs() is dec._host_specs_cache


class TestPortRepoDomains:
    def test_port_domain_dump_is_byte_identical(self, capsys) -> None:
        """`--domains` over the whole port twice: identical bytes, sorted
        (path, qualname) keys, and the decode pipeline's worker domain
        found."""
        from etl_tpu_torch.analysis.rules import repo_package_dir

        pkg = str(repo_package_dir())
        assert cli_main([pkg, "--domains"]) == 0
        first = capsys.readouterr().out
        assert cli_main([pkg, "--domains"]) == 0
        assert capsys.readouterr().out == first
        lines = [l for l in first.splitlines() if l]
        keys = [tuple(l.split(": ")[0].split("::")) for l in lines]
        assert keys == sorted(keys)
        assert any(l.startswith("ops/pipeline.py::") and "worker" in l
                   for l in lines)
