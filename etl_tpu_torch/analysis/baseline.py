"""Baseline suppression file: grandfathered findings by fingerprint.

Format (JSON, committed at etl_tpu_torch/analysis/baseline.json):

    {
      "version": 1,
      "entries": {
        "<rule>|<path>|<scope>|<detail>": {"count": N, "reason": "..."}
      }
    }

Matching is by fingerprint + count, never by line number, so unrelated
edits don't invalidate the baseline. If a file accrues MORE occurrences
of a grandfathered fingerprint than the baseline allows, the newest
occurrences (highest line numbers) are reported — new debt never hides
behind old debt.
"""

from __future__ import annotations

import json
from collections import Counter
from pathlib import Path

from .findings import Finding

VERSION = 1

DEFAULT_BASELINE = Path(__file__).resolve().parent / "baseline.json"


def load(path: "str | Path | None" = None) -> dict[str, int]:
    """fingerprint -> allowed count; empty when the file is absent."""
    p = Path(path) if path is not None else DEFAULT_BASELINE
    if not p.exists():
        return {}
    data = json.loads(p.read_text(encoding="utf-8"))
    if data.get("version") != VERSION:
        raise ValueError(
            f"baseline {p}: unsupported version {data.get('version')!r}")
    out: dict[str, int] = {}
    for fp, entry in data.get("entries", {}).items():
        out[fp] = int(entry["count"]) if isinstance(entry, dict) \
            else int(entry)
    return out


def fingerprint_path(fp: str) -> str:
    """The canonical-path component of a fingerprint. Safe to split on
    the first two '|'s: rule and path never contain one (details may —
    e.g. `except A|B` tuples)."""
    return fp.split("|", 2)[1]


def save(findings: list[Finding], path: "str | Path | None" = None,
         reasons: "dict[str, str] | None" = None,
         scanned_paths: "set[str] | None" = None) -> Path:
    """Write a baseline covering every current finding (the
    `--update-baseline` path). Existing reasons are preserved for
    fingerprints that survive. `scanned_paths` bounds the rewrite: old
    entries for files OUTSIDE the scanned set are kept verbatim, so a
    scoped run (`... etl_tpu_torch/runtime --update-baseline`) can't silently
    destroy the grandfathered debt (and hand-written reasons) of the
    rest of the tree. Omit it only for a full-tree scan."""
    p = Path(path) if path is not None else DEFAULT_BASELINE
    old_reasons: dict[str, str] = {}
    entries: dict[str, dict] = {}
    if p.exists():
        try:
            old = json.loads(p.read_text(encoding="utf-8"))
            for fp, entry in old.get("entries", {}).items():
                if isinstance(entry, dict) and entry.get("reason"):
                    old_reasons[fp] = entry["reason"]
                if scanned_paths is not None \
                        and fingerprint_path(fp) not in scanned_paths:
                    entries[fp] = entry if isinstance(entry, dict) \
                        else {"count": int(entry)}
        except (ValueError, KeyError):
            pass
    counts = Counter(f.fingerprint for f in findings)
    for fp in sorted(counts):
        entry = {"count": counts[fp]}
        reason = (reasons or {}).get(fp) or old_reasons.get(fp)
        if reason:
            entry["reason"] = reason
        entries[fp] = entry
    entries = {fp: entries[fp] for fp in sorted(entries)}
    p.write_text(json.dumps({"version": VERSION, "entries": entries},
                            indent=2, sort_keys=True) + "\n",
                 encoding="utf-8")
    return p


def apply(findings: list[Finding],
          baseline: dict[str, int]) -> tuple[list[Finding], dict[str, int]]:
    """(violations, stale) — violations are findings beyond the baselined
    count per fingerprint (newest occurrences reported); stale maps
    baselined fingerprints that no longer occur (or occur fewer times)
    to their unused allowance, so fixed debt can be pruned."""
    by_fp: dict[str, list[Finding]] = {}
    for f in findings:
        by_fp.setdefault(f.fingerprint, []).append(f)
    violations: list[Finding] = []
    for fp, group in by_fp.items():
        allowed = baseline.get(fp, 0)
        if len(group) > allowed:
            group.sort(key=lambda f: (f.line, f.col))
            violations.extend(group[allowed:])
    stale: dict[str, int] = {}
    for fp, allowed in baseline.items():
        used = len(by_fp.get(fp, ()))
        if used < allowed:
            stale[fp] = allowed - used
    violations.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return violations, stale
