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


def _load_raw(path: str) -> Dict[str, Any]:
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return json.load(f)


def load_baseline(path: str) -> Set[str]:
    """Fingerprint set from a baseline file; a missing file is an empty
    baseline (the ratchet starts at zero)."""
    return set(_load_raw(path).get("findings", []))


# the ratcheted numeric sections of the baseline file, each a
# ``{config: bound}`` map with one shrink-only rule: a bound can start
# (an absent key) and shrink, never grow.  ``program_budget``: the
# compile-explosion program counts; ``replication_budget``: the sharding
# audit's replicated bytes per step (analysis/sharding_lint.py).
BUDGET_SECTIONS = ("program_budget", "replication_budget")


def load_budget(path: str, section: str) -> Dict[str, int]:
    """One budget section (:data:`BUDGET_SECTIONS`) of the baseline file;
    a missing file or section is no bound yet."""
    return {str(k): int(v) for k, v in
            _load_raw(path).get(section, {}).items()}


def save_baseline(path: str, fingerprints: Iterable[str],
                  budgets: Optional[Dict[str, Dict[str, int]]] = None
                  ) -> None:
    """Write the baseline; a budget section not passed in ``budgets``
    keeps the file's."""
    sections = dict(budgets or {})
    for name in BUDGET_SECTIONS:
        if name not in sections:
            sections[name] = load_budget(path, name)
    data: Dict[str, Any] = {"version": 1,
                            "findings": sorted(set(fingerprints))}
    for name in BUDGET_SECTIONS:
        if sections.get(name):
            data[name] = {k: int(sections[name][k])
                          for k in sorted(sections[name])}
    with open(path, "w") as f:
        json.dump(data, f, indent=2)
        f.write("\n")


def shrink_budget(path: str, section: str, counts: Dict[str, int],
                  known: Optional[Set[str]] = None) -> Dict[str, int]:
    """Ratchet-only update of one budget section: each config measured
    this run gets ``min(stored, measured)`` (a bound can start and
    shrink, never grow); configs not measured keep theirs; with
    ``known`` (every rig name) the bounds of rigs that no longer exist
    are dropped.  Returns the section written."""
    budget = load_budget(path, section)
    if known is not None:
        budget = {k: v for k, v in budget.items() if k in known}
    for cfg, n in counts.items():
        budget[cfg] = min(budget.get(cfg, int(n)), int(n))
    save_baseline(path, load_baseline(path), budgets={section: budget})
    return budget


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
