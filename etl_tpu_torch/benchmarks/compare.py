"""Benchmark comparison: diff two JSON reports.

Reference parity: `cargo x benchmark-compare`
(crates/xtask/src/commands/benchmark_compare.rs) — CI compares reports
run-over-run instead of asserting absolute thresholds.

Usage: python -m etl_tpu_torch.benchmarks.compare old.json new.json
[--fail-pct N]

Copy of the reference's `etl_tpu/benchmarks/compare.py`.
"""

from __future__ import annotations

import argparse
import json
import sys

HIGHER_IS_BETTER = ("per_second", "throughput", "value")
LOWER_IS_BETTER = ("_ms",)


def compare(old: dict, new: dict) -> "tuple[list[str], float]":
    lines = []
    worst_regression = 0.0
    for key in sorted(set(old) | set(new)):
        ov, nv = old.get(key), new.get(key)
        if not isinstance(ov, (int, float)) or not isinstance(nv, (int, float)) \
                or isinstance(ov, bool):
            continue
        if ov == 0:
            continue
        delta_pct = (nv - ov) / abs(ov) * 100
        direction = ""
        if delta_pct != 0:
            if any(t in key for t in HIGHER_IS_BETTER):
                direction = "better" if delta_pct > 0 else "worse"
            elif any(t in key for t in LOWER_IS_BETTER):
                direction = "better" if delta_pct < 0 else "worse"
        lines.append(f"{key}: {ov:g} -> {nv:g} ({delta_pct:+.1f}%"
                     + (f", {direction}" if direction else "") + ")")
        if direction == "worse":
            worst_regression = max(abs(delta_pct), worst_regression)
    return lines, worst_regression


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="etl_tpu_torch.benchmarks.compare")
    p.add_argument("old")
    p.add_argument("new")
    p.add_argument("--fail-pct", type=float, default=None,
                   help="exit 1 if any 'worse' metric regresses more than N%%")
    args = p.parse_args(argv)
    old = json.load(open(args.old))
    new = json.load(open(args.new))
    lines, worst = compare(old, new)
    for line in lines:
        print(line)
    if args.fail_pct is not None and worst and worst > args.fail_pct:
        print(f"REGRESSION: worst {worst:.1f}% > {args.fail_pct}%")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
