"""Finding model + stable fingerprints for baseline matching.

A fingerprint deliberately excludes the line number: baselines must
survive unrelated edits above a grandfathered finding. Identity is
(rule, canonical path, enclosing scope, normalized subject) — when the
same subject appears N times in one scope, the baseline stores a count
and only occurrences beyond it are violations.

Interprocedural findings additionally carry the call chain that reaches
the sink (`chain`, entry first) and the per-hop source locations
(`chain_sites`, for `--explain`). Neither participates in the
fingerprint: identity stays (rule, entry module, entry scope, sink
subject), so renaming or re-routing an INTERMEDIATE helper — the most
common refactor — does not invalidate a baselined entry, and a direct
finding that later becomes transitive (the sink moved into a helper)
keeps matching the same grandfathered fingerprint.
"""

from __future__ import annotations

import dataclasses
from pathlib import PurePosixPath

#: path segments stripped from the front of fingerprint paths so the
#: same file fingerprints identically whether the scan root was the repo
#: root, the package dir, or a mirrored fixtures tree
_PACKAGE_SEGMENT = "etl_tpu_torch"


def canonical_path(path: str) -> str:
    """Posix-normalize and strip everything up to the package segment:
    `/src/etl_tpu_torch/runtime/x.py` and `runtime/x.py` both canonicalize
    to `runtime/x.py` (fixture trees mirror the package layout)."""
    parts = PurePosixPath(path.replace("\\", "/")).parts
    for i in range(len(parts) - 1, -1, -1):
        if parts[i] == _PACKAGE_SEGMENT:
            parts = parts[i + 1:]
            break
    return "/".join(p for p in parts if p not in (".", ""))


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str  # kebab-case rule name
    path: str  # canonical posix path (see canonical_path)
    line: int
    col: int
    scope: str  # dotted qualname of the enclosing def/class, or <module>
    detail: str  # normalized subject, e.g. "time.sleep" / "except Exception"
    message: str
    #: interprocedural call chain, entry first, e.g.
    #: ("Pipeline.start", "_bootstrap", "helper") — empty for lexical
    #: findings (the "chain" is the scope itself)
    chain: tuple = ()
    #: (canonical path, line) of each hop in `chain`, same order
    chain_sites: tuple = ()

    @property
    def fingerprint(self) -> str:
        return "|".join((self.rule, self.path, self.scope, self.detail))

    def chain_text(self) -> str:
        """`a → b → c: time.sleep` — the trace the finding proves."""
        if not self.chain:
            return f"{self.scope}: {self.detail}"
        return " → ".join(self.chain) + f": {self.detail}"

    def render(self) -> str:
        base = (f"{self.path}:{self.line}:{self.col}: {self.rule}: "
                f"{self.message} [{self.scope}]")
        if self.chain:
            base += f" [via {self.chain_text()}]"
        return base

    def explain(self) -> str:
        """Multi-line chain trace: one resolvable file:line per hop."""
        if not self.chain:
            return f"    at {self.path}:{self.line} in {self.scope}"
        lines = []
        for hop, (path, line) in zip(self.chain, self.chain_sites):
            lines.append(f"    {path}:{line}: {hop}")
        lines.append(f"    sink: {self.detail}")
        return "\n".join(lines)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["chain"] = list(self.chain)
        d["chain_sites"] = [list(s) for s in self.chain_sites]
        d["fingerprint"] = self.fingerprint
        return d
