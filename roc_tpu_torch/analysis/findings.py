"""Finding and the baseline ratchet shared by every lint level
(``roc_tpu/analysis/findings.py``).

A finding's *fingerprint* is its identity for baseline matching:
``rule|unit|key`` with a rule-chosen ``key`` that stays stable across
line-number drift and re-runs.  The baseline
(``roc_tpu_torch/analysis/lint_baseline.json``) is ratchet-only:
:func:`shrink_baseline` can drop entries that no longer fire, never add.
A new finding is fixed, or accepted at the call site with an explanatory
``# roc-lint: ok=<rule>`` pragma.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional, Set, Tuple


@dataclass
class Finding:
    """One lint hit.  ``unit`` locates the artifact: a repo-relative
    source path for the AST rules, ``concurrency:lock-graph`` or
    ``model:<name>`` for the whole-tree ones.  ``key`` overrides the
    fingerprint tail (defaults to ``msg``: rules whose messages embed
    varying numbers must pass a stable key)."""

    rule: str
    unit: str
    msg: str
    line: Optional[int] = None
    key: Optional[str] = None
    detail: Dict[str, Any] = field(default_factory=dict)

    @property
    def fingerprint(self) -> str:
        return f"{self.rule}|{self.unit}|{self.key or self.msg}"

    def render(self) -> str:
        loc = f"{self.unit}:{self.line}" if self.line else self.unit
        return f"{loc}: [{self.rule}] {self.msg}"


def dedupe(findings: Iterable[Finding]) -> List[Finding]:
    """Drop findings with duplicate fingerprints, keeping the first
    occurrence's order."""
    seen: Set[str] = set()
    out: List[Finding] = []
    for f in findings:
        if f.fingerprint not in seen:
            seen.add(f.fingerprint)
            out.append(f)
    return out


def load_baseline(path: str) -> Set[str]:
    """Fingerprint set from a baseline file; a missing file is an empty
    baseline (the ratchet starts at zero)."""
    if not os.path.exists(path):
        return set()
    with open(path) as f:
        return set(json.load(f).get("findings", []))


def save_baseline(path: str, fingerprints: Iterable[str]) -> None:
    data = {"version": 1, "findings": sorted(set(fingerprints))}
    with open(path, "w") as f:
        json.dump(data, f, indent=2)
        f.write("\n")


def _rule_of(fingerprint: str) -> str:
    return fingerprint.split("|", 1)[0]


def split_findings(findings: List[Finding], baseline: Set[str],
                   active_rules: Optional[Set[str]] = None
                   ) -> Tuple[List[Finding], List[Finding], Set[str]]:
    """``(new, baselined, stale)``: findings not covered by the baseline,
    findings the baseline tolerates, and baseline entries that no longer
    fire (candidates for the shrink ratchet).

    ``active_rules`` names the rules that ran: baseline entries of other
    rules are never reported stale — a ``--select`` run must not declare
    findings it never looked for as gone."""
    new = [f for f in findings if f.fingerprint not in baseline]
    old = [f for f in findings if f.fingerprint in baseline]
    stale = baseline - {f.fingerprint for f in findings}
    if active_rules is not None:
        stale = {fp for fp in stale if _rule_of(fp) in active_rules}
    return new, old, stale


def shrink_baseline(path: str, findings: List[Finding],
                    active_rules: Optional[Set[str]] = None) -> Set[str]:
    """Ratchet-only update: rewrite ``path`` without the entries that
    stopped firing; new findings are never absorbed.  Entries of rules
    outside ``active_rules`` are kept: a selective run only ratchets
    what it measured.  Returns the fingerprints written."""
    baseline = load_baseline(path)
    current = {f.fingerprint for f in findings}
    kept = {fp for fp in baseline
            if fp in current
            or (active_rules is not None
                and _rule_of(fp) not in active_rules)}
    save_baseline(path, kept)
    return kept
