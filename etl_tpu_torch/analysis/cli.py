"""`python -m etl_tpu_torch.analysis [paths]` — run etl-lint.

Exit codes: 0 clean (after baseline), 1 violations (or, with
`--check-baseline`, stale suppressions), 2 usage/parse error — and, for
the IR tier, a device that is not there (`--device cuda` without a card)
or `--mesh` without `--programs`. `--programs --mesh` adds the mesh's
variants (8 shards over the devices at hand) to the same run.
"""

from __future__ import annotations

import argparse
import json
import sys

from . import baseline as baseline_mod
from .ir import IR_CONTRACT_NAMES, IR_NAMESPACE
from .rules import RULE_NAMES, analyze_paths, repo_package_dir


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m etl_tpu_torch.analysis",
        description="etl-lint: async-safety & device-sync static analysis "
                    "for the etl_tpu_torch codebase (lexical + "
                    "whole-program), and the IR tier over its kernel "
                    "launches")
    p.add_argument("paths", nargs="*",
                   help="files or directories to scan "
                        "(default: the etl_tpu_torch package)")
    p.add_argument("--baseline", default=None, metavar="FILE",
                   help="baseline suppression file "
                        "(default: etl_tpu_torch/analysis/baseline.json)")
    p.add_argument("--no-baseline", action="store_true",
                   help="report every finding, ignoring the baseline")
    p.add_argument("--update-baseline", action="store_true",
                   help="rewrite the baseline to cover all current "
                        "findings, pruning fixed entries")
    p.add_argument("--check-baseline", action="store_true",
                   help="fail (exit 1) on stale baseline entries and on "
                        "inline `# etl-lint: ignore[...]` comments that "
                        "suppress nothing")
    p.add_argument("--no-interproc", action="store_true",
                   help="skip the whole-program pass (lexical rules only)")
    p.add_argument("--programs", "--ir", action="store_true",
                   dest="programs",
                   help="also run the IR tier: launch every enumerable "
                        "decode program and check the launch contracts "
                        "(ir-*)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where the IR tier launches (default: cuda). On "
                        "the CPU the kernels' plain versions run and "
                        "ir-host-callback is listed as not checked; "
                        "cuda without a card exits 2")
    p.add_argument("--row-buckets", default=None, metavar="N[,N...]",
                   help="the IR tier's row buckets (default: 4096)")
    p.add_argument("--mesh", action="store_true",
                   help="with --programs: also the mesh-sharded variants "
                        "(mesh, mesh-filtered, mesh-egress-*) on an "
                        "8-shard mesh over the --device's devices (one "
                        "card holds all 8), in this process")
    p.add_argument("--callgraph", action="store_true",
                   help="dump the resolved call graph edges and exit")
    p.add_argument("--domains", action="store_true",
                   help="dump the inferred execution-domain map "
                        "(concurrency tier) and exit")
    p.add_argument("--explain", action="store_true",
                   help="print a resolvable file:line trace for each "
                        "violation's call chain")
    p.add_argument("--format", choices=("text", "json", "github"),
                   default="text", dest="fmt",
                   help="output format; `github` emits workflow-command "
                        "annotations (::error file=...) for CI")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="alias for --format=json")
    p.add_argument("--list-rules", action="store_true",
                   help="print the rule names and exit")
    p.add_argument("-q", "--quiet", action="store_true",
                   help="suppress the summary line")
    return p


def _dump_callgraph(paths, as_json: bool) -> int:
    from .callgraph import Project
    from .rules import analyze_paths

    # reuse the scanner so rel-path canonicalization (and therefore
    # module keys) matches the analysis run exactly — parse-only, no
    # rule pass (the findings would be discarded anyway)
    units: list = []
    analyze_paths(paths, interprocedural=False, lexical=False,
                  units_out=units)
    project = Project.build([(u.path, u.source, u.tree) for u in units])
    edges = project.edges()
    if as_json:
        print(json.dumps({"edges": [list(e) for e in edges]}, indent=2))
    else:
        for src, dst in edges:
            print(f"{src} -> {dst}")
        print(f"etl-lint: {len(edges)} resolved call edges",
              file=sys.stderr)
    return 0


def _dump_domains(paths, as_json: bool) -> int:
    """`path::qualname: domain,domain` lines, sorted and stable — the
    review-diffable twin of --callgraph (two runs over an unchanged
    tree print byte-identical output; see docs/CONCURRENCY.md)."""
    from .callgraph import Project
    from .domains import infer_domains
    from .rules import analyze_paths

    units: list = []
    analyze_paths(paths, interprocedural=False, lexical=False,
                  units_out=units)
    project = Project.build([(u.path, u.source, u.tree) for u in units])
    dm = infer_domains(project)
    rows = [(f"{fn.module.path}::{fn.qualname}", domains)
            for fn, domains in dm.items()]
    if as_json:
        print(json.dumps({"domains": {name: domains
                                      for name, domains in rows}},
                         indent=2, sort_keys=True))
    else:
        for name, domains in rows:
            print(f"{name}: {','.join(domains)}")
        print(f"etl-lint: {len(rows)} functions classified",
              file=sys.stderr)
    return 0


def _annotation_path(path: str) -> str:
    """Repo-relative path for a workflow annotation. Finding paths are
    canonical (package-stripped), so package files need the
    `etl_tpu_torch/` prefix back; files from other scan roots (fixture
    trees) keep their canonical path — anchoring to a nonexistent file
    helps nobody."""
    import os

    prefixed = os.path.join("etl_tpu_torch", path)
    return prefixed if os.path.exists(prefixed) else path


def _render_github(f) -> str:
    # workflow commands reject newlines in the message; title carries
    # the rule so annotations group in the PR UI
    msg = f.message.replace("\n", " ")
    if f.chain:
        msg += f" (via {f.chain_text()})"
    return (f"::error file={_annotation_path(f.path)},line={f.line},"
            f"col={f.col},title=etl-lint {f.rule}::{msg}")


def _row_buckets(text: "str | None") -> "tuple[int, ...] | None":
    if text is None:
        return None
    out = tuple(int(x) for x in text.split(",") if x.strip())
    if not out or any(n <= 0 for n in out):
        raise ValueError(f"want positive row counts, got {text!r}")
    return out


def main(argv: "list[str] | None" = None) -> int:
    args = build_parser().parse_args(argv)
    if args.as_json:
        args.fmt = "json"
    if args.list_rules:
        names = RULE_NAMES + (IR_CONTRACT_NAMES if args.programs else ())
        print("\n".join(names))
        return 0
    if args.mesh and not args.programs:
        print("etl-lint: --mesh requires --programs", file=sys.stderr)
        return 2
    try:
        row_buckets = _row_buckets(args.row_buckets)
    except ValueError as e:
        print(f"etl-lint: --row-buckets: {e}", file=sys.stderr)
        return 2
    if args.programs and args.device == "cuda":
        # checked before the AST pass: no card, no run — the tier never
        # drops to the CPU quietly
        from .ir import runner as ir_runner

        problem = ir_runner.device_problem(args.device)
        if problem is not None:
            print(f"etl-lint: {problem}", file=sys.stderr)
            return 2
    paths = args.paths or [str(repo_package_dir())]
    if args.callgraph:
        try:
            return _dump_callgraph(paths, args.fmt == "json")
        except (SyntaxError, OSError) as e:
            print(f"etl-lint: {e}", file=sys.stderr)
            return 2
    if args.domains:
        try:
            return _dump_domains(paths, args.fmt == "json")
        except (SyntaxError, OSError) as e:
            print(f"etl-lint: {e}", file=sys.stderr)
            return 2
    scanned: list[str] = []
    units: list = []
    try:
        findings = analyze_paths(paths, scanned=scanned,
                                 interprocedural=not args.no_interproc,
                                 units_out=units)
    except (SyntaxError, OSError) as e:
        print(f"etl-lint: {e}", file=sys.stderr)
        return 2
    except RecursionError as e:  # analyzer bug, not a lint result
        print(f"etl-lint: analyzer error: {e}", file=sys.stderr)
        return 2

    ir_report = None
    if args.programs:
        from .ir import runner as ir_runner

        try:
            mesh = {"mesh": True} if args.mesh else {}
            ir_findings, ir_paths, ir_report = ir_runner.analyze_local(
                device=args.device, row_buckets=row_buckets, **mesh)
        except ir_runner.IrAnalysisError as e:
            print(f"etl-lint: {e}", file=sys.stderr)
            return 2
        findings = sorted(findings + ir_findings,
                          key=lambda f: (f.path, f.line, f.col, f.rule))
        scanned.extend(ir_paths)
        if not args.quiet or ir_report["not_checked"]:
            for line in ir_runner.report_lines(ir_report):
                print(f"etl-lint: {line}", file=sys.stderr)

    if args.update_baseline:
        # scanned_paths bounds the rewrite: a scoped run only rewrites
        # entries for the files it actually looked at
        out = baseline_mod.save(findings, args.baseline,
                                scanned_paths=set(scanned))
        if not args.quiet:
            print(f"etl-lint: baseline updated: {out} "
                  f"({len(findings)} findings grandfathered)")
        return 0

    if args.no_baseline:
        allowed: dict[str, int] = {}
    else:
        try:
            allowed = baseline_mod.load(args.baseline)
        except (ValueError, OSError) as e:
            print(f"etl-lint: {e}", file=sys.stderr)
            return 2
    violations, stale = baseline_mod.apply(findings, allowed)
    # stale warnings only make sense for files this run actually looked
    # at — a scoped run can't know whether out-of-scope debt was fixed.
    # When the IR tier ran, the ENTIRE `programs/` namespace counts as
    # scanned (not just the enumerated paths): that pass enumerates
    # every program any tier can produce, so a baseline entry it did not
    # re-produce — including one for a layout that no longer exists, or
    # a finding that migrated between tiers — is genuinely stale.
    scanned_set = set(scanned)
    stale = {fp: n for fp, n in stale.items()
             if baseline_mod.fingerprint_path(fp) in scanned_set
             or (args.programs and baseline_mod.fingerprint_path(fp)
                 .startswith(IR_NAMESPACE))}

    if args.check_baseline:
        unused_ignores = [(u.path, line, rule) for u in units
                          for line, rule in u.suppressions.unused()]
        for fp, n in sorted(stale.items()):
            print(f"etl-lint: stale baseline entry ({n} unused): {fp}")
        for path, line, rule in sorted(unused_ignores):
            print(f"etl-lint: stale inline ignore at {path}:{line}: "
                  f"ignore[{rule}] suppresses nothing")
        dirty = bool(stale) or bool(unused_ignores)
        if not args.quiet:
            print(f"etl-lint: --check-baseline: {len(stale)} stale "
                  f"baseline entries, {len(unused_ignores)} stale "
                  f"inline ignores")
        return 1 if dirty else 0

    if args.fmt == "json":
        doc = {
            "findings": [f.to_dict() for f in findings],
            "violations": [f.to_dict() for f in violations],
            "stale_baseline": stale,
            "baselined": len(findings) - len(violations),
        }
        if ir_report is not None:
            doc["programs"] = ir_report
        print(json.dumps(doc, indent=2))
    elif args.fmt == "github":
        for f in violations:
            print(_render_github(f))
        if not args.quiet:
            print(f"etl-lint: {len(violations)} violations "
                  f"({len(findings) - len(violations)} baselined)",
                  file=sys.stderr)
    else:
        for f in violations:
            print(f.render())
            if args.explain:
                print(f.explain())
        for fp, unused in sorted(stale.items()):
            print(f"etl-lint: stale baseline entry ({unused} unused): {fp}",
                  file=sys.stderr)
        if not args.quiet:
            print(f"etl-lint: {len(findings)} findings, "
                  f"{len(findings) - len(violations)} baselined, "
                  f"{len(violations)} violations"
                  + (f", {len(stale)} stale baseline entries" if stale
                     else ""))
    return 1 if violations else 0


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
