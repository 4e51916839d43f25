"""Run every lint level — the engine behind ``python -m
roc_tpu_torch.analysis`` (``roc_tpu/analysis/driver.py``, without the
trace levels: the port has no jaxprs, HLO or XLA programs to read).

Findings are emitted as ``analysis``-category events (the JSONL artifact
and a machine-readable trail) besides being returned.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

from ..obs.events import emit
from .ast_lint import RULES as AST_RULES, run_ast_lint
from .concurrency_lint import (CONCURRENCY_RULES, TreeModel,
                               audit_concurrency)
from .findings import Finding, dedupe
from .protocol_lint import PROTOCOL_RULES, audit_protocol

# --select aliases: a level's name stands for all of its rules
GROUPS = {"concurrency": CONCURRENCY_RULES, "protocol": PROTOCOL_RULES}


def all_rule_names() -> List[str]:
    return ([r.name for r in AST_RULES] + list(CONCURRENCY_RULES)
            + list(PROTOCOL_RULES))


def analyze(root: str, select: Optional[List[str]] = None,
            extras: Optional[Dict[str, Any]] = None) -> List[Finding]:
    """The AST, concurrency and protocol levels over ``root`` (each only
    when ``select`` names one of its rules, all by default).  Every
    finding is also emitted as an ``analysis`` event.  ``extras``, when
    a dict, receives the levels' surfaces under ``'concurrency'`` and
    ``'protocol'``."""
    t0 = time.perf_counter()
    findings = run_ast_lint(root, select=select)
    # the two whole-tree levels share one parse of the tree
    tm: Optional[TreeModel] = None
    if select is None or any(s in CONCURRENCY_RULES for s in select):
        tm = TreeModel(root)
        findings.extend(audit_concurrency(root, select=select,
                                          extras=extras, tree_model=tm))
    if select is None or any(s in PROTOCOL_RULES for s in select):
        findings.extend(audit_protocol(
            root, select=select, extras=extras,
            tree_model=tm if tm is not None else TreeModel(root)))
    findings = dedupe(findings)
    for f in findings:
        emit("analysis", f.render(), console=False, rule=f.rule,
             unit=f.unit, line=f.line, fingerprint=f.fingerprint)
    emit("analysis",
         f"roc-lint: {len(findings)} finding(s) in "
         f"{time.perf_counter() - t0:.1f}s", console=False,
         count=len(findings),
         rules=sorted({f.rule for f in findings}))
    return findings
