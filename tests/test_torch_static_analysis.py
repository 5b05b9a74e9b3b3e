"""The port's etl-lint (`etl_tpu_torch.analysis`): the reference's
tests/test_static_analysis.py restated on the port's analyzer, a
differential against the reference's analyzer, and the PyTorch sinks.

- Fixtures: `tests/fixtures/lint_torch/` mirrors each device-rule fixture
  of `tests/fixtures/lint/` with the PyTorch sinks (`.cpu()`, `.item()`,
  `torch.cuda.synchronize`, an event wait, `.cuda()`, `.to(<device>)`,
  `.copy_(…)` with and without `non_blocking=True`, a kernel library's
  load); each file declares its expected counts in `# expect:` lines.
  The reference's fixtures hold the port to the same counts for every
  rule whose sinks did not change.
- Differential: the reference's `analyze_paths` and the port's over
  `tests/fixtures/lint/` give the same findings (rule, path, line, col,
  scope, detail, chain, chain sites, message) for every rule whose sinks
  did not change.
- The repo-wide run over `etl_tpu_torch/` is clean against the port's
  baseline, byte-identical twice, and inside the smoke's 30 s budget.
"""

from __future__ import annotations

import json
import re
import time
from collections import Counter
from pathlib import Path

import pytest

from etl_tpu.analysis.rules import analyze_paths as ref_analyze_paths
from etl_tpu_torch.analysis import analyze_source, baseline as baseline_mod
from etl_tpu_torch.analysis.cli import main as cli_main
from etl_tpu_torch.analysis.concurrency import CONCURRENCY_RULE_SCOPES
from etl_tpu_torch.analysis.findings import Finding, canonical_path
from etl_tpu_torch.analysis.rules import (RULE_NAMES, analyze_paths,
                                          default_rules, device_method,
                                          repo_package_dir)

TESTS = Path(__file__).parent
REF_FIXTURES = TESTS / "fixtures" / "lint"
FIXTURES = TESTS / "fixtures" / "lint_torch"
_EXPECT_RE = re.compile(r"^#\s*expect:\s*([a-z-]+)=(\d+)\s*$", re.M)

#: the rules whose sinks the port restates for PyTorch; every other rule
#: must agree with the reference's analyzer finding for finding
CHANGED_RULES = frozenset({"device-sync-in-async", "hot-loop-host-transfer",
                           "admission-blocking-fetch",
                           "control-loop-blocking-io", "donated-buffer-use"})
UNCHANGED_RULES = tuple(r for r in RULE_NAMES if r not in CHANGED_RULES)

#: path-head scopes of the whole-program rules (interproc.py has no
#: per-module Rule objects, so negative coverage is computed from these)
_INTERPROC_SCOPES = {
    "arena-lease-leak": None,  # everywhere
    "donated-buffer-use": None,
    "lock-held-across-await": ("runtime", "destinations", "postgres",
                               "store", "supervision", "api", "ops"),
    "lock-order-inversion": None,
    "unsynchronized-shared-mutation": CONCURRENCY_RULE_SCOPES,
    "loop-state-from-thread": CONCURRENCY_RULE_SCOPES,
    "coordinator-store-bypass": None,  # follows the domain, not the path
}


def fixture_files(root: Path = FIXTURES) -> list[Path]:
    return sorted(root.rglob("*.py"))


def expected_counts(source: str) -> Counter:
    return Counter({rule: int(n) for rule, n in _EXPECT_RE.findall(source)})


_RUNS: dict = {}


def project_findings(root: Path = FIXTURES) -> list[Finding]:
    """One whole-tree analysis of a fixture project, cached — the
    cross-module fixtures only resolve when scanned together."""
    if root not in _RUNS:
        _RUNS[root] = analyze_paths([str(root)])
    return _RUNS[root]


def lint_fixture(path: Path, root: Path = FIXTURES) -> list[Finding]:
    rel = path.relative_to(root).as_posix()
    return [f for f in project_findings(root)
            if f.path == canonical_path(rel)]


def _ids(root: Path):
    return lambda p: p.relative_to(root).as_posix()


def _covered(root: Path, rules) -> tuple[set, set]:
    """(rules with a positive fixture, rules with an in-scope clean
    fixture) in the fixture tree `root`, among `rules`."""
    positive: set[str] = set()
    negative: set[str] = set()
    for path in fixture_files(root):
        rel = path.relative_to(root).as_posix()
        counts = expected_counts(path.read_text())
        positive |= {r for r, n in counts.items() if n > 0 and r in rules}
        if sum(counts.values()) == 0:
            negative |= {r.name for r in default_rules()
                         if r.applies_to(rel) and r.name in rules}
            head = rel.split("/", 1)[0]
            negative |= {r for r, scopes in _INTERPROC_SCOPES.items()
                         if (scopes is None or head in scopes)
                         and r in rules}
    return positive, negative


class TestFixtures:
    @pytest.mark.parametrize("path", fixture_files(), ids=_ids(FIXTURES))
    def test_fixture_expectations(self, path: Path) -> None:
        got = Counter(f.rule for f in lint_fixture(path))
        assert got == expected_counts(path.read_text()), \
            [f.render() for f in lint_fixture(path)]

    @pytest.mark.parametrize("path", fixture_files(REF_FIXTURES),
                             ids=_ids(REF_FIXTURES))
    def test_reference_fixture_expectations_unchanged_rules(
            self, path: Path) -> None:
        """The reference's fixtures, held to their own counts for every
        rule whose sinks the port did not restate."""
        want = Counter({r: n for r, n in
                        expected_counts(path.read_text()).items()
                        if r not in CHANGED_RULES})
        found = lint_fixture(path, REF_FIXTURES)
        got = Counter(f.rule for f in found if f.rule not in CHANGED_RULES)
        assert got == want, [f.render() for f in found]

    def test_every_rule_has_positive_and_negative_coverage(self) -> None:
        """Every rule has a fixture that triggers it and a CLEAN fixture
        whose path the rule applies to: the restated device rules in
        lint_torch/, the others in the reference's tree."""
        pos_t, neg_t = _covered(FIXTURES, CHANGED_RULES)
        pos_r, neg_r = _covered(REF_FIXTURES, set(UNCHANGED_RULES))
        assert pos_t == CHANGED_RULES and neg_t == CHANGED_RULES, \
            (CHANGED_RULES - pos_t, CHANGED_RULES - neg_t)
        assert pos_r | pos_t == set(RULE_NAMES), \
            set(RULE_NAMES) - pos_r - pos_t
        assert neg_r | neg_t == set(RULE_NAMES), \
            set(RULE_NAMES) - neg_r - neg_t

    def test_regression_autotune_probe_and_build_pattern(self) -> None:
        """device-sync-in-async catches the autotune probe and a kernel
        library's load written directly into async code, with the
        fetches beside them."""
        findings = lint_fixture(FIXTURES / "runtime" /
                                "bad_autotune_probe.py")
        details = {f.detail for f in findings
                   if f.rule == "device-sync-in-async"}
        assert details == {"autotune.resolve_device_min_rows",
                           "decode_kernel.load", ".cpu", ".synchronize",
                           ".item"}

    def test_pipeline_start_loads_off_the_loop(self) -> None:
        """The port's Pipeline.start() awaits `_load_decode`, which awaits
        autotune.prewarm() and builds the kernel libraries in
        asyncio.to_thread: a decoder built on the event loop later finds
        the cost model and the libraries in memory (the reasons of the
        baselined resolve and load chains)."""
        import ast as ast_mod

        src = (repo_package_dir() / "runtime" / "pipeline.py").read_text()
        tree = ast_mod.parse(src)
        cls = next(n for n in ast_mod.walk(tree)
                   if isinstance(n, ast_mod.ClassDef)
                   and n.name == "Pipeline")
        methods = {n.name: n for n in cls.body
                   if isinstance(n, ast_mod.AsyncFunctionDef)}

        def awaited(fn) -> set:
            out = set()
            for n in ast_mod.walk(fn):
                if isinstance(n, ast_mod.Await) \
                        and isinstance(n.value, ast_mod.Call):
                    call = n.value
                    out.add(ast_mod.unparse(call.func))
                    out.update(ast_mod.unparse(a) for a in call.args)
            return out

        assert "self._load_decode" in awaited(methods["start"])
        load = awaited(methods["_load_decode"])
        assert {"autotune.prewarm", "asyncio.to_thread",
                "decode_kernel.load", "egress_kernel.load"} <= load, load

    def test_raise_after_nested_callable_still_counts(self) -> None:
        src = ("import asyncio\n\n\n"
               "async def f(task, x):\n"
               "    try:\n"
               "        await task\n"
               "    except asyncio.CancelledError:\n"
               "        for h in (lambda: 1,):\n"
               "            if x:\n"
               "                raise\n")
        assert analyze_source(src, "runtime/x.py") == []

    def test_async_method_match_is_per_class(self) -> None:
        src = ("class A:\n"
               "    def flush(self):\n"
               "        pass\n"
               "\n"
               "    def run(self):\n"
               "        self.flush()\n"
               "\n\n"
               "class B:\n"
               "    async def flush(self):\n"
               "        pass\n")
        assert analyze_source(src, "runtime/x.py") == []
        src_bad = src.replace("class B:", "class C:\n"
                              "    async def go(self):\n"
                              "        pass\n\n"
                              "    def stop(self):\n"
                              "        self.go()\n\n\nclass B:")
        assert [f.rule for f in analyze_source(src_bad, "runtime/x.py")] \
            == ["unawaited-coroutine"]

    def test_inline_suppression_is_rule_specific(self) -> None:
        src = ("import time\n\n\n"
               "async def f():\n"
               "    time.sleep(1)  # etl-lint: ignore[orphaned-task]\n")
        findings = analyze_source(src, "runtime/x.py")
        assert [f.rule for f in findings] == ["blocking-call-in-async"]

    def test_suppression_in_string_literal_is_inert(self) -> None:
        src = ("import time\n\n\n"
               "async def f():\n"
               "    time.sleep(1); s = \"use # etl-lint: "
               "ignore[blocking-call-in-async] to suppress\"\n"
               "    return s\n")
        findings = analyze_source(src, "runtime/x.py")
        assert [f.rule for f in findings] == ["blocking-call-in-async"]


class TestDifferential:
    """The reference's analyzer and the port's over the reference's
    fixture tree: the same findings, field for field, for every rule
    whose sinks did not change."""

    @staticmethod
    def _key(f) -> tuple:
        return (f.rule, f.path, f.line, f.col, f.scope, f.detail, f.chain,
                f.chain_sites, f.message)

    @pytest.mark.parametrize("rule", UNCHANGED_RULES)
    def test_same_findings_as_the_reference(self, rule: str) -> None:
        if REF_FIXTURES not in _RUNS:
            _RUNS[REF_FIXTURES] = analyze_paths([str(REF_FIXTURES)])
        if "ref" not in _RUNS:
            _RUNS["ref"] = ref_analyze_paths([str(REF_FIXTURES)])
        want = [self._key(f) for f in _RUNS["ref"] if f.rule == rule]
        got = [self._key(f) for f in _RUNS[REF_FIXTURES] if f.rule == rule]
        assert want, f"the reference finds nothing for {rule}"
        assert got == want

    def test_rule_catalogs_agree(self) -> None:
        from etl_tpu.analysis.rules import RULE_NAMES as REF_RULE_NAMES

        assert RULE_NAMES == REF_RULE_NAMES


class TestDeviceSinks:
    """The port's restated device sinks, call by call."""

    @pytest.mark.parametrize("expr,subject", [
        ("x.cpu()", ".cpu"), ("x.item()", ".item"),
        ("x.tolist()", ".tolist"), ("x.numpy()", ".numpy"),
        ("ev.synchronize()", ".synchronize"),
        ("x.to('cpu')", ".to(cpu)"), ("x.to(device='cpu')", ".to(cpu)"),
        ("x.to('cuda')", ".to(device)"), ("x.to(dev)", ".to(device)"),
        ("x.to(self.device, non_blocking=True)", ".to(device)"),
        ("x.cuda()", ".cuda"), ("h.copy_(d)", ".copy_"),
        ("h.copy_(d, non_blocking=True)", ".copy_(non_blocking)"),
        ("x.to(torch.int32)", None), ("x.to(dtype)", None),
        ("d.items()", None), ("h.copy(d)", None)])
    def test_device_method(self, expr: str, subject) -> None:
        import ast as ast_mod

        assert device_method(ast_mod.parse(expr).body[0].value) == subject

    def test_host_ambiguous_sinks_need_a_torch_module(self) -> None:
        """`.tolist()` / `.item()` count only where torch is imported
        (numpy arrays have them too); `.cpu()` counts everywhere."""
        body = ("\n\nasync def f(a):\n"
                "    return a.tolist(), a.item(), a.cpu()\n")
        bare = analyze_source("import numpy as np" + body, "ops/x.py")
        lazy = analyze_source("def g():\n    import torch\n" + body,
                              "ops/x.py")
        assert [f.detail for f in bare] == [".cpu"]
        assert [f.detail for f in lazy] == [".tolist", ".item", ".cpu"]

    def test_dispatch_stage_sanctions_uploads_transitively(self) -> None:
        """An upload reached from a @dispatch_stage function through a
        helper rides the pipeline; a fetch through the same helper does
        not."""
        src = ("from etl_tpu_torch.analysis.annotations import "
               "dispatch_stage, hot_loop\n\n\n"
               "def up(x, dev):\n"
               "    return x.to(dev, non_blocking=True)\n\n\n"
               "def down(x):\n"
               "    return x.cpu()\n\n\n"
               "@dispatch_stage\n"
               "@hot_loop\n"
               "def stage(x, dev):\n"
               "    return down(up(x, dev))\n")
        findings = analyze_source(src, "ops/x.py")
        assert [(f.rule, f.detail) for f in findings] \
            == [("hot-loop-host-transfer", ".cpu")]

    def test_engine_dispatch_stage_is_marked(self) -> None:
        from etl_tpu_torch.analysis.annotations import (DISPATCH_STAGE_ATTR,
                                                        HOT_LOOP_ATTR)
        from etl_tpu_torch.ops.engine import DeviceDecoder

        fn = DeviceDecoder._dispatch_stage
        assert getattr(fn, DISPATCH_STAGE_ATTR) is True
        assert getattr(fn, HOT_LOOP_ATTR) is True
        assert getattr(DeviceDecoder.decode_async, HOT_LOOP_ATTR) is True


class TestFingerprints:
    def test_canonical_path_strips_package_prefix(self) -> None:
        assert canonical_path("/src/etl_tpu_torch/runtime/x.py") \
            == "runtime/x.py"
        assert canonical_path("etl_tpu_torch/runtime/x.py") \
            == "runtime/x.py"
        assert canonical_path("runtime/x.py") == "runtime/x.py"
        # the reference's package is not the port's segment
        assert canonical_path("etl_tpu/runtime/x.py") \
            == "etl_tpu/runtime/x.py"

    def test_fingerprint_survives_line_drift(self) -> None:
        src = "import time\n\n\nasync def f():\n    time.sleep(1)\n"
        shifted = "\n\n# a new header comment\n" + src
        fp = [f.fingerprint for f in analyze_source(src, "runtime/x.py")]
        fp2 = [f.fingerprint
               for f in analyze_source(shifted, "runtime/x.py")]
        assert fp == fp2 and len(fp) == 1


class TestBaseline:
    SRC = "import time\n\n\nasync def f():\n    time.sleep(1)\n"

    def findings(self) -> list[Finding]:
        return analyze_source(self.SRC, "runtime/x.py")

    def test_round_trip_add_suppress_remove(self, tmp_path: Path) -> None:
        findings = self.findings()
        assert findings, "fixture must produce a finding"
        bl_file = tmp_path / "baseline.json"
        baseline_mod.save(findings, bl_file,
                          reasons={findings[0].fingerprint: "grandfathered"})
        allowed = baseline_mod.load(bl_file)
        violations, stale = baseline_mod.apply(findings, allowed)
        assert violations == [] and stale == {}
        violations, stale = baseline_mod.apply([], allowed)
        assert violations == []
        assert stale == {findings[0].fingerprint: 1}
        baseline_mod.save([], bl_file)
        assert baseline_mod.load(bl_file) == {}

    def test_new_debt_never_hides_behind_old_debt(self,
                                                  tmp_path: Path) -> None:
        findings = self.findings()
        bl_file = tmp_path / "baseline.json"
        baseline_mod.save(findings, bl_file)
        allowed = baseline_mod.load(bl_file)
        doubled = analyze_source(
            self.SRC + "\n\nasync def g():\n    time.sleep(2)\n",
            "runtime/x.py")
        assert len(doubled) == 2
        violations, _ = baseline_mod.apply(doubled, allowed)
        assert len(violations) == 1
        assert violations[0].line == max(f.line for f in doubled)

    def test_missing_baseline_file_allows_nothing(self,
                                                  tmp_path: Path) -> None:
        assert baseline_mod.load(tmp_path / "absent.json") == {}

    def test_shipped_baseline_has_a_reason_per_entry(self) -> None:
        data = json.loads(baseline_mod.DEFAULT_BASELINE.read_text())
        assert data["version"] == baseline_mod.VERSION
        assert baseline_mod.DEFAULT_BASELINE.parent \
            == repo_package_dir() / "analysis"
        for fp, entry in data["entries"].items():
            assert entry["count"] >= 1 and len(entry["reason"]) > 40, fp


class TestCli:
    def test_bad_fixtures_exit_nonzero(self, capsys) -> None:
        rc = cli_main([str(FIXTURES), "--no-baseline", "-q"])
        assert rc == 1
        assert "bad_hot_loop.py" in capsys.readouterr().out

    def test_repo_wide_run_is_clean(self, capsys) -> None:
        """Tier-1 enforcement: the analyzer over the whole port with its
        shipped baseline is violation-free."""
        rc = cli_main([str(repo_package_dir())])
        out = capsys.readouterr()
        assert rc == 0, out.out + out.err
        assert "stale" not in out.err, out.err

    def test_json_output_shape(self, capsys) -> None:
        rc = cli_main([str(REF_FIXTURES / "runtime" / "bad_orphaned_task.py"),
                       "--no-baseline", "--json"])
        assert rc == 1
        data = json.loads(capsys.readouterr().out)
        assert data["baselined"] == 0
        assert {v["rule"] for v in data["violations"]} == {"orphaned-task"}
        for key in ("fingerprint", "path", "line", "scope", "detail"):
            assert key in data["violations"][0]

    def test_update_baseline_then_clean(self, tmp_path, capsys) -> None:
        target = str(FIXTURES / "ops" / "bad_hot_loop.py")
        bl = tmp_path / "bl.json"
        assert cli_main([target, "--baseline", str(bl),
                         "--update-baseline", "-q"]) == 0
        assert cli_main([target, "--baseline", str(bl), "-q"]) == 0
        capsys.readouterr()

    def test_scoped_update_preserves_out_of_scope_entries(
            self, tmp_path, capsys) -> None:
        bl = tmp_path / "bl.json"
        pkg = repo_package_dir()
        assert cli_main([str(pkg), "--baseline", str(bl),
                         "--update-baseline", "-q"]) == 0
        full = baseline_mod.load(bl)
        assert any(fp.split("|")[1].startswith("api/") for fp in full)
        assert cli_main([str(pkg / "testing"), "--baseline", str(bl),
                         "--update-baseline", "-q"]) == 0
        assert baseline_mod.load(bl) == full
        assert cli_main([str(pkg), "--baseline", str(bl), "-q"]) == 0
        capsys.readouterr()

    def test_subdir_scan_matches_full_scan_fingerprints(self) -> None:
        pkg = repo_package_dir()
        sub = {f.fingerprint for f in analyze_paths([str(pkg / "api")])}
        full = {f.fingerprint for f in analyze_paths([str(pkg)])
                if f.path.startswith("api/")}
        assert sub == full and sub

    def test_list_rules(self, capsys) -> None:
        assert cli_main(["--list-rules"]) == 0
        assert set(capsys.readouterr().out.split()) == set(RULE_NAMES)

    def test_syntax_error_exits_two(self, tmp_path, capsys) -> None:
        bad = tmp_path / "broken.py"
        bad.write_text("def f(:\n")
        assert cli_main([str(bad)]) == 2
        capsys.readouterr()

    def test_nonexistent_path_exits_two(self, tmp_path, capsys) -> None:
        assert cli_main([str(tmp_path / "nope")]) == 2
        capsys.readouterr()


class TestAnalyzePaths:
    def test_directory_scan_supersets_per_file(self) -> None:
        """Single-file runs see a subset of the project run; what the
        directory run ADDS is exactly the cross-module chain findings."""
        per_dir = analyze_paths([str(FIXTURES)])
        per_file = [
            f for p in fixture_files()
            for f in analyze_source(p.read_text(),
                                    p.relative_to(FIXTURES).as_posix())]
        dir_fps = Counter(f.fingerprint for f in per_dir)
        file_fps = Counter(f.fingerprint for f in per_file)
        assert all(dir_fps[fp] >= n for fp, n in file_fps.items())
        only_dir = +(dir_fps - file_fps)
        cross_module = {f.fingerprint for f in per_dir
                        if len(set(p for p, _l in f.chain_sites)) > 1}
        assert set(only_dir) <= cross_module
        assert only_dir, "cross-module fixtures must add chain findings"

    def test_single_file_arg_keeps_path_scope_and_fingerprint(self) -> None:
        target = repo_package_dir() / "api" / "db.py"
        per_file = analyze_paths([str(target)])
        assert any(f.rule == "blocking-call-in-async"
                   and f.path == "api/db.py" for f in per_file), \
            [f.render() for f in per_file]


class TestRuntimeFixes:
    """The port's runtime behaviors the baseline's reasons rest on, and
    the analyzer's own drive-bys, verified behaviorally."""

    async def test_autotune_prewarm_runs_off_loop_and_caches(
            self, monkeypatch) -> None:
        from etl_tpu_torch.ops import autotune

        monkeypatch.setattr(autotune, "_MEASURED", None)
        model = await autotune.prewarm()
        # no card here: the probe resolves to None and is cached
        assert model is None
        assert autotune._MEASURED is not None
        assert await autotune.prewarm() is None

    def _probe_batch(self):
        from etl_tpu_torch.models import (ColumnSchema, Oid,
                                          ReplicatedTableSchema, TableName,
                                          TableSchema)
        from etl_tpu_torch.ops.staging import stage_copy_chunk

        schema = ReplicatedTableSchema.with_all_columns(TableSchema(
            1, TableName("etl", "lint_probe"),
            tuple(ColumnSchema(f"c{i}", Oid.INT8) for i in range(4))))
        line = b"\t".join(str(100 + i).encode() for i in range(4))
        return schema, stage_copy_chunk((line + b"\n") * 64, 4)

    def test_probe_decode_with_telemetry_off_leaves_counters_alone(self):
        from etl_tpu_torch.ops.engine import DeviceDecoder
        from etl_tpu_torch.telemetry.metrics import (
            ETL_DECODE_ROUTED_DEVICE_ROWS_TOTAL,
            ETL_DECODE_ROUTED_HOST_ROWS_TOTAL,
            ETL_DECODE_ROUTED_ORACLE_ROWS_TOTAL, registry)

        names = (ETL_DECODE_ROUTED_DEVICE_ROWS_TOTAL,
                 ETL_DECODE_ROUTED_HOST_ROWS_TOTAL,
                 ETL_DECODE_ROUTED_ORACLE_ROWS_TOTAL)
        schema, staged = self._probe_batch()

        def routed_total() -> float:
            return sum(registry.get_counter(n) for n in names)

        silent = DeviceDecoder(schema, device="cpu",
                               device_min_rows=1 << 30, telemetry=False)
        before = routed_total()
        silent.decode(staged)
        assert routed_total() == before
        loud = DeviceDecoder(schema, device="cpu", device_min_rows=1 << 30)
        loud.decode(staged)
        assert routed_total() == before + staged.n_rows

    def test_string_column_decodes_via_arrow_gather(self):
        from etl_tpu_torch.models import (ColumnSchema, Oid,
                                          ReplicatedTableSchema, TableName,
                                          TableSchema)
        from etl_tpu_torch.ops.engine import DeviceDecoder
        from etl_tpu_torch.ops.staging import stage_copy_chunk

        schema = ReplicatedTableSchema.with_all_columns(TableSchema(
            1, TableName("etl", "lint_str"),
            (ColumnSchema("s", Oid.TEXT),)))
        staged = stage_copy_chunk(b"hello\nworld\n\\N\n", 1)
        batch = DeviceDecoder(schema, device="cpu").decode(staged)
        assert [r.values[0] for r in batch.to_rows()] \
            == ["hello", "world", None]

    def test_fault_injecting_destination_holds_release_task(self):
        from etl_tpu_torch.destinations.memory import (
            FaultInjectingDestination, MemoryDestination)

        assert hasattr(FaultInjectingDestination(MemoryDestination()),
                       "_tasks")

    async def test_shutdown_resolves_held_acks(self):
        import asyncio

        from etl_tpu_torch.destinations.memory import (
            FaultAction, FaultInjectingDestination, FaultKind,
            MemoryDestination)
        from etl_tpu_torch.models.errors import EtlError

        dest = FaultInjectingDestination(MemoryDestination())
        dest.script("write_events", FaultAction(FaultKind.HOLD))
        ack = await dest.write_events([])
        await dest.shutdown()
        with pytest.raises(EtlError):
            await asyncio.wait_for(ack.wait_durable(), timeout=5)

    async def test_hold_write_racing_shutdown_still_resolves(self):
        import asyncio

        from etl_tpu_torch.destinations.memory import (
            FaultAction, FaultInjectingDestination, FaultKind,
            MemoryDestination)
        from etl_tpu_torch.models.errors import EtlError

        dest = FaultInjectingDestination(MemoryDestination())
        dest.script("write_events", FaultAction(FaultKind.HOLD))
        writer = asyncio.create_task(dest.write_events([]))
        await dest.shutdown()
        ack = await writer
        with pytest.raises(EtlError):
            await asyncio.wait_for(ack.wait_durable(), timeout=5)


class TestInterproc:
    def test_nested_sync_in_async_in_sync(self) -> None:
        src = ("import time\n\n\n"
               "def outer():\n"
               "    async def middle():\n"
               "        def inner():\n"
               "            time.sleep(1)\n"
               "        inner()\n"
               "    return middle\n")
        findings = analyze_source(src, "runtime/x.py")
        chains = [f for f in findings
                  if f.rule == "blocking-call-in-async" and f.chain]
        assert len(chains) == 1, [f.render() for f in findings]
        assert chains[0].chain == ("outer.middle", "outer.middle.inner")
        assert chains[0].detail == "time.sleep"

    def test_executor_lambda_is_not_an_edge(self) -> None:
        src = ("import time\n\n\n"
               "async def f(loop):\n"
               "    def work():\n"
               "        time.sleep(5)\n"
               "    await loop.run_in_executor(None, work)\n"
               "    await loop.run_in_executor(None, lambda: time.sleep(1))\n")
        assert analyze_source(src, "runtime/x.py") == []

    def test_import_aliased_decorator_resolves(self) -> None:
        src = ("from etl_tpu_torch.analysis.annotations import hot_loop "
               "as hl\n\n\n"
               "@hl\n"
               "def dispatch(v):\n"
               "    return v.cpu()\n")
        findings = analyze_source(src, "ops/x.py")
        assert [f.rule for f in findings] == ["hot-loop-host-transfer"], \
            [f.render() for f in findings]

    def test_cyclic_call_graph_terminates_with_shortest_chain(self) -> None:
        src = ("import time\n\n\n"
               "def a(n):\n"
               "    time.sleep(1)\n"
               "    return b(n - 1)\n\n\n"
               "def b(n):\n"
               "    return a(n) if n else 0\n\n\n"
               "async def entry():\n"
               "    return a(3)\n")
        chains = [f for f in analyze_source(src, "runtime/x.py") if f.chain]
        assert len(chains) == 1
        assert chains[0].chain == ("entry", "a")

    def test_chain_trace_renders_resolvable_locations(self) -> None:
        src = ("import time\n\n\n"
               "def helper():\n"
               "    time.sleep(1)\n\n\n"
               "async def entry():\n"
               "    helper()\n")
        (finding,) = analyze_source(src, "runtime/x.py")
        assert finding.chain == ("entry", "helper")
        assert finding.chain_text() == "entry → helper: time.sleep"
        explain = finding.explain()
        assert "runtime/x.py:9: entry" in explain
        assert "runtime/x.py:5: helper" in explain
        assert "sink: time.sleep" in explain
        assert finding.line == 9

    def test_self_method_resolution_through_base_class(self) -> None:
        src = ("import time\n\n\n"
               "class Base:\n"
               "    def slow(self):\n"
               "        time.sleep(1)\n\n\n"
               "class Worker(Base):\n"
               "    async def run(self):\n"
               "        self.slow()\n")
        findings = analyze_source(src, "runtime/x.py")
        assert [f.rule for f in findings] == ["blocking-call-in-async"]
        assert findings[0].chain == ("Worker.run", "Base.slow")

    def test_constructor_edge_reaches_init(self) -> None:
        src = ("import sqlite3\n\n\n"
               "class Db:\n"
               "    def __init__(self, path):\n"
               "        self.conn = sqlite3.connect(path)\n\n\n"
               "async def open_db(path):\n"
               "    return Db(path)\n")
        findings = analyze_source(src, "runtime/x.py")
        assert [f.chain for f in findings] == [("open_db", "Db.__init__")]

    def test_unresolved_receiver_is_not_traversed(self) -> None:
        src = ("async def f(obj):\n"
               "    obj.anything()\n")
        assert analyze_source(src, "runtime/x.py") == []


class TestMultilineSuppression:
    def test_ignore_on_first_line_covers_continuation(self) -> None:
        src = ("import time\n\n\n"
               "async def f(x):\n"
               "    y = (x +\n"
               "         time.sleep(1))\n")
        findings = analyze_source(src, "runtime/x.py")
        assert len(findings) == 1 and findings[0].line == 6
        suppressed = src.replace(
            "y = (x +", "y = (x +  # etl-lint: ignore[blocking-call-in-async]")
        assert analyze_source(suppressed, "runtime/x.py") == []

    def test_compound_header_suppression_does_not_blanket_body(self) -> None:
        src = ("import time\n\n\n"
               "async def f(x):  # etl-lint: ignore[blocking-call-in-async]\n"
               "    time.sleep(1)\n")
        assert [f.line for f in analyze_source(src, "runtime/x.py")] == [5]

    def test_suppression_on_continuation_line_still_works(self) -> None:
        src = ("import time\n\n\n"
               "async def f(x):\n"
               "    y = (x +\n"
               "         time.sleep(1))"
               "  # etl-lint: ignore[blocking-call-in-async]\n")
        assert analyze_source(src, "runtime/x.py") == []


class TestCheckBaseline:
    def test_detects_stale_baseline_entry(self, tmp_path, capsys) -> None:
        target = tmp_path / "runtime"
        target.mkdir()
        (target / "clean.py").write_text("def f():\n    return 1\n")
        bl = tmp_path / "bl.json"
        bl.write_text(json.dumps({"version": 1, "entries": {
            "blocking-call-in-async|runtime/clean.py|f|time.sleep":
                {"count": 1, "reason": "gone"}}}))
        rc = cli_main([str(tmp_path), "--baseline", str(bl),
                       "--check-baseline", "-q"])
        out = capsys.readouterr().out
        assert rc == 1 and "stale baseline entry" in out

    def test_detects_unused_inline_ignore(self, tmp_path, capsys) -> None:
        target = tmp_path / "runtime"
        target.mkdir()
        (target / "mod.py").write_text(
            "def f():\n"
            "    return 1  # etl-lint: ignore[orphaned-task]\n")
        rc = cli_main([str(tmp_path), "--check-baseline", "--baseline",
                       str(tmp_path / "none.json"), "-q"])
        out = capsys.readouterr().out
        assert rc == 1
        assert "ignore[orphaned-task] suppresses nothing" in out

    def test_used_ignore_and_live_baseline_pass(self, tmp_path,
                                                capsys) -> None:
        target = tmp_path / "runtime"
        target.mkdir()
        (target / "mod.py").write_text(
            "import time\n\n\n"
            "async def f():\n"
            "    time.sleep(1)  # etl-lint: ignore[blocking-call-in-async]\n")
        rc = cli_main([str(tmp_path), "--check-baseline", "--baseline",
                       str(tmp_path / "none.json"), "-q"])
        assert rc == 0, capsys.readouterr().out
        capsys.readouterr()

    def test_shipped_baseline_is_live(self, capsys) -> None:
        rc = cli_main([str(repo_package_dir()), "--check-baseline", "-q"])
        out = capsys.readouterr()
        assert rc == 0, out.out + out.err


class TestCliFormats:
    def test_github_format_emits_workflow_commands(self, capsys) -> None:
        rc = cli_main([str(FIXTURES), "--no-baseline", "--format=github",
                       "-q"])
        assert rc == 1
        out = capsys.readouterr().out
        assert out.startswith("::error file=")
        assert "title=etl-lint hot-loop-host-transfer" in out
        assert "\n\n" not in out.strip()

    def test_callgraph_dump(self, capsys) -> None:
        assert cli_main([str(FIXTURES), "--callgraph"]) == 0
        out = capsys.readouterr().out
        assert ("runtime/bad_transitive_device.py::drain_results"
                " -> ops/helpers_device.py::fetch_all") in out

    def test_explain_prints_chain_hops(self, capsys) -> None:
        rc = cli_main([str(FIXTURES), "--no-baseline", "--explain", "-q"])
        assert rc == 1
        out = capsys.readouterr().out
        assert "sink: .cpu" in out
        assert "sink: torch.cuda.synchronize" in out
        assert "ops/helpers_device.py:" in out

    def test_json_includes_chain(self, capsys) -> None:
        rc = cli_main([str(FIXTURES), "--no-baseline", "--json"])
        assert rc == 1
        data = json.loads(capsys.readouterr().out)
        chained = [v for v in data["violations"] if v["chain"]]
        assert chained and all("chain_sites" in v for v in chained)


class TestTier1Enforcement:
    def test_repo_wide_run_is_deterministic_and_in_budget(self) -> None:
        """Two full runs over the port give byte-identical findings JSON
        (chains and sites included); one run stays inside the smoke's
        `static_analysis_budget_s` (30 s)."""
        pkg = str(repo_package_dir())
        t0 = time.perf_counter()
        one = analyze_paths([pkg])
        seconds = time.perf_counter() - t0
        two = analyze_paths([pkg])
        dump = lambda fs: json.dumps([f.to_dict() for f in fs],
                                     sort_keys=True)
        assert dump(one) == dump(two)
        assert one, "repo-wide run found nothing: analyzer broken"
        assert seconds < 30.0, seconds

    def test_arena_lease_is_a_context_manager(self) -> None:
        import torch

        from etl_tpu_torch.ops.staging import StagingArenaPool

        pool = StagingArenaPool()
        with pytest.raises(RuntimeError):
            with pool.lease() as lease:
                lease.take((8,), torch.uint8)
                assert pool.outstanding == 1
                raise RuntimeError("boom")
        assert pool.outstanding == 0


class TestReviewRegressions:
    def test_nonblocking_rebind_idiom_is_safe(self) -> None:
        """`buf = fresh()` after the copy rebinds the name: the in-flight
        buffer is no longer what `buf` reads."""
        src = ("def loop(buf, src, fresh):\n"
               "    buf.copy_(src, non_blocking=True)\n"
               "    buf = fresh()\n"
               "    return buf.sum()\n")
        assert analyze_source(src, "ops/x.py") == []

    def test_nested_finally_release_is_clean(self) -> None:
        src = ("def f(pool, work, log):\n"
               "    lease = pool.lease()\n"
               "    try:\n"
               "        try:\n"
               "            work()\n"
               "        finally:\n"
               "            log()\n"
               "    finally:\n"
               "        lease.release()\n")
        assert analyze_source(src, "ops/x.py") == []

    def test_wait_for_wrapped_await_keeps_the_edge(self, tmp_path) -> None:
        import ast as ast_mod

        from etl_tpu_torch.analysis.callgraph import Project

        src = ("import asyncio\n"
               "import time\n\n\n"
               "async def helper():\n"
               "    time.sleep(1)\n\n\n"
               "async def entry():\n"
               "    await asyncio.wait_for(helper(), 5)\n")
        proj = Project.build([("runtime/x.py", src, ast_mod.parse(src))])
        entry = proj.modules["runtime/x.py"].functions["entry"]
        helper_site = next(s for s in entry.calls if s.lexical == "helper")
        assert helper_site.awaited and helper_site.resolved is not None
        (tmp_path / "ops").mkdir()
        (tmp_path / "runtime").mkdir()
        (tmp_path / "ops" / "helpers.py").write_text(
            "import time\n\n\nasync def drain():\n    time.sleep(1)\n")
        (tmp_path / "runtime" / "worker.py").write_text(
            "import asyncio\n\nfrom ..ops.helpers import drain\n\n\n"
            "async def entry():\n"
            "    await asyncio.wait_for(drain(), 5)\n")
        chains = [f for f in analyze_paths([str(tmp_path)]) if f.chain]
        assert [c.chain for c in chains] == [("entry", "drain")]

    def test_lease_container_handoff_escapes(self) -> None:
        src = ("def f(self, pool, q):\n"
               "    lease = pool.lease()\n"
               "    self._pending.append(lease)\n\n\n"
               "def g(pool, q):\n"
               "    lease = pool.lease()\n"
               "    q.put_nowait(lease)\n")
        assert analyze_source(src, "ops/x.py") == []

    def test_github_annotation_path_only_prefixes_package_files(
            self, capsys, monkeypatch) -> None:
        monkeypatch.chdir(TESTS.parent)
        rc = cli_main([str(FIXTURES), "--no-baseline", "--format=github",
                       "-q"])
        assert rc == 1
        out = capsys.readouterr().out
        assert "file=etl_tpu_torch/ops/bad_" not in out
        assert "file=ops/bad_" in out
        # a finding in the package's own tree gets its prefix back
        from etl_tpu_torch.analysis.cli import _annotation_path

        assert _annotation_path("api/db.py") == "etl_tpu_torch/api/db.py"
