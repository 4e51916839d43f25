"""``python -m roc_tpu_torch.analysis`` — roc-lint over the port
(``roc_tpu/analysis/__main__.py``).

Exit code 0 means the tree is clean modulo the baseline; any unbaselined
finding exits 1.  Stdout is the product: one ``unit:line: [rule]
message`` line per finding, then a summary.

Usage:
    python -m roc_tpu_torch.analysis [--strict]          # every level
    python -m roc_tpu_torch.analysis --select stdout-print   # one rule
    python -m roc_tpu_torch.analysis --select concurrency    # a level
    python -m roc_tpu_torch.analysis --select protocol
    python -m roc_tpu_torch.analysis --update-baseline   # shrink ratchet
    python -m roc_tpu_torch.analysis --json              # one JSON object

``--json`` prints one JSON object on stdout: the findings, the baseline
split and the concurrency and protocol surfaces (which
``python -m roc_tpu_torch.report --concurrency/--protocol FILE``
renders).

The baseline (``roc_tpu_torch/analysis/lint_baseline.json``) is
ratchet-only: ``--update-baseline`` rewrites it as the intersection of
its entries and the findings that still fire — it can only shrink.  New
findings are fixed at the source or accepted with an explanatory
``# roc-lint: ok=<rule>`` pragma, never absorbed.  ``--strict`` also
fails on stale baseline entries, forcing the shrink to be committed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

BASELINE = os.path.join("roc_tpu_torch", "analysis", "lint_baseline.json")


def _default_root() -> str:
    """The cwd when it holds a roc_tpu_torch/ tree, else the checkout this
    module was imported from."""
    if os.path.isdir(os.path.join(os.getcwd(), "roc_tpu_torch")):
        return os.getcwd()
    return os.path.abspath(
        os.path.join(os.path.dirname(__file__), "..", ".."))


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m roc_tpu_torch.analysis",
        description="roc-lint over the port: AST, concurrency and "
                    "protocol levels, ratcheted via " + BASELINE)
    p.add_argument("--root", default=None,
                   help="repo root to lint (default: cwd when it has a "
                        "roc_tpu_torch/ tree, else this checkout)")
    p.add_argument("--select", default=None,
                   help="comma-separated rule names (default: all); "
                        "'concurrency' and 'protocol' expand to every "
                        "rule of that level")
    p.add_argument("--baseline", default=None,
                   help="baseline path (default: <root>/" + BASELINE + ")")
    p.add_argument("--update-baseline", action="store_true",
                   help="shrink-only rewrite of the baseline (drops "
                        "entries that no longer fire)")
    p.add_argument("--strict", action="store_true",
                   help="also fail on stale baseline entries (the "
                        "ratchet's shrink must be committed)")
    p.add_argument("--list-rules", action="store_true",
                   help="print rule names and exit")
    p.add_argument("--json", action="store_true",
                   help="machine-readable output: one JSON object on "
                        "stdout")
    args = p.parse_args(argv)

    from .driver import GROUPS, all_rule_names, analyze
    from .findings import load_baseline, shrink_baseline, split_findings

    if args.list_rules:
        for name in all_rule_names():
            print(name)
        return 0
    select = ([s.strip() for s in args.select.split(",") if s.strip()]
              if args.select else None)
    if select:
        select = [r for s in select for r in GROUPS.get(s, (s,))]
        bad = sorted(set(select) - set(all_rule_names()))
        if bad:
            print(f"unknown rule(s): {', '.join(bad)}; see --list-rules")
            return 2

    root = args.root or _default_root()
    baseline_path = args.baseline or os.path.join(root, BASELINE)
    extras: dict = {}
    findings = analyze(root, select=select, extras=extras)
    # stale-entry accounting and the shrink are scoped to the rules that
    # ran: a --select run must not declare other rules' entries gone
    active = set(select) if select else set(all_rule_names())
    baseline = load_baseline(baseline_path)
    dropped = 0
    if args.update_baseline:
        # shrink first, then split against the file as this run leaves it
        kept = shrink_baseline(baseline_path, findings,
                               active_rules=active)
        dropped = len(baseline) - len(kept)
        baseline = load_baseline(baseline_path)
    new, old, stale = split_findings(findings, baseline,
                                     active_rules=active)

    if args.json:
        payload = {
            "findings": [
                {"rule": f.rule, "unit": f.unit, "line": f.line,
                 "msg": f.msg, "fingerprint": f.fingerprint,
                 "baselined": f.fingerprint in baseline,
                 "detail": f.detail}
                for f in new + old],
            "stale": sorted(stale),
            "concurrency_surface": extras.get("concurrency"),
            "protocol_surface": extras.get("protocol"),
            "summary": {"new": len(new), "baselined": len(old),
                        "stale": len(stale)},
        }
        print(json.dumps(payload, indent=2))
        return 1 if new or (stale and args.strict) else 0

    for f in new:
        print(f.render())
    for f in old:
        print(f"{f.render()}  [baselined]")
    if args.update_baseline:
        print(f"baseline: kept {len(baseline)}, dropped {dropped} stale "
              f"entr{'y' if dropped == 1 else 'ies'} ({baseline_path})")
    elif stale:
        verb = "FAIL" if args.strict else "note"
        print(f"{verb}: {len(stale)} stale baseline entr"
              f"{'y' if len(stale) == 1 else 'ies'} no longer fire(s) — "
              f"run --update-baseline to ratchet down:")
        for fp in sorted(stale):
            print(f"  {fp}")
    print(f"roc-lint: {len(new)} new, {len(old)} baselined, "
          f"{len(stale)} stale")
    if new:
        return 1
    if stale and args.strict:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
