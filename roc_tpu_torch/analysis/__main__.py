"""``python -m roc_tpu_torch.analysis`` — roc-lint over the port
(``roc_tpu/analysis/__main__.py``).

Exit code 0 means the tree is clean modulo the baseline; any unbaselined
finding exits 1.  Stdout is the product: one ``unit:line: [rule]
message`` line per finding, then a summary.

Usage:
    python -m roc_tpu_torch.analysis [--strict]          # every level
    python -m roc_tpu_torch.analysis --no-trace          # host levels only
    python -m roc_tpu_torch.analysis --select stdout-print   # one rule
    python -m roc_tpu_torch.analysis --select concurrency    # a level
    python -m roc_tpu_torch.analysis --select protocol
    python -m roc_tpu_torch.analysis --select programspace   # trace levels
    python -m roc_tpu_torch.analysis --select collectives
    python -m roc_tpu_torch.analysis --select sharding
    python -m roc_tpu_torch.analysis --select jaxpr-f32-upcast,hlo-large-copy
    python -m roc_tpu_torch.analysis --device-kind "NVIDIA H100 80GB HBM3"
    python -m roc_tpu_torch.analysis --update-baseline   # shrink ratchet
    python -m roc_tpu_torch.analysis --json              # one JSON object

The trace levels (analysis/driver.py: the program space, the collectives,
the partition's balance, the recorded steps' jaxpr and HLO rules, the
sharding audit) build the port on the CPU rig, as the JAX package's run
on its CPU rig: the lint is a gate before any card time, and its program
counts and ledgers are the CPU rig's.  ``--device-kind`` names a
card whose routes and kernel instances the program space lists (the
H100's row, say); on the card the enumeration of a live run is
``python -m roc_tpu_torch.prewarm``'s.

``--json`` prints one JSON object on stdout: the findings, the baseline
split, the program spaces (``program_space``: per rig its programs,
slots, kernel instances, keys and budget), the sharding reports
(``sharding``: per rig its replication ledger, budget and mesh shapes,
and the live 2x2 mesh's sites) and the concurrency and protocol surfaces
(which ``python -m roc_tpu_torch.report --concurrency/--protocol/
--sharding FILE`` renders).

The baseline (``roc_tpu_torch/analysis/lint_baseline.json``) is
ratchet-only: ``--update-baseline`` rewrites it as the intersection of
its entries and the findings that still fire, and each rig's
``program_budget`` and ``replication_budget`` as the smaller of its bound
and its measurement — it can only shrink.  New findings are fixed at the source or accepted
with an explanatory ``# roc-lint: ok=<rule>`` pragma, never absorbed.
``--strict`` also fails on stale baseline entries and on budget debt (a
bound above its measurement, a measured rig with no bound, a bound for a
rig that no longer exists), forcing the shrink to be committed.
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
        description="roc-lint over the port: AST, concurrency, protocol, "
                    "program-space, collective, jaxpr, HLO and sharding "
                    "levels, ratcheted via " + BASELINE)
    p.add_argument("--root", default=None,
                   help="repo root to lint (default: cwd when it has a "
                        "roc_tpu_torch/ tree, else this checkout)")
    p.add_argument("--select", default=None,
                   help="comma-separated rule names (default: all); "
                        "'concurrency', 'protocol', 'programspace', "
                        "'collectives' and 'sharding' expand to every "
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
    p.add_argument("--no-trace", action="store_true",
                   help="skip the trace levels (the program space, the "
                        "collectives, the partition's balance, the "
                        "recorded steps' jaxpr and HLO rules, the "
                        "sharding audit): the host levels alone, no "
                        "torch")
    p.add_argument("--device-kind", default=None,
                   help="list the program space's kernel instances for "
                        "this card (torch.cuda.get_device_name, e.g. "
                        "'NVIDIA H100 80GB HBM3'; its row of core/ell.py "
                        "CARD_ROWS resolves 'auto'); default: the CPU "
                        "rig's, none")
    args = p.parse_args(argv)

    from .driver import GROUPS, all_rule_names, analyze, is_trace_rule
    from .findings import (BUDGET_SECTIONS, load_baseline, load_budget,
                           shrink_baseline, shrink_budget, split_findings)

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

    trace = not args.no_trace
    root = args.root or _default_root()
    baseline_path = args.baseline or os.path.join(root, BASELINE)
    extras: dict = {}
    findings = analyze(root, select=select, extras=extras, trace=trace,
                       program_budget=load_budget(baseline_path,
                                                  "program_budget"),
                       device_kind=args.device_kind,
                       replication_budget=load_budget(
                           baseline_path, "replication_budget"))
    reports = extras.get("programspace", [])
    sharding = extras.get("sharding", [])
    # stale-entry accounting and the shrink are scoped to the rules that
    # ran: a --select or --no-trace run must not declare other rules'
    # entries gone
    active = set(select) if select else set(all_rule_names())
    if not trace:
        active = {r for r in active if not is_trace_rule(r)}
    # each budget section: the reports that measure it, the measured
    # field, and the rules whose run measures it
    measured = {
        "program_budget": (reports, "programs",
                           {"compile-explosion", "cache-key-drift"}),
        "replication_budget": (sharding, "replicated_bytes",
                               {"replication-budget"}),
    }
    ran = [name for name in BUDGET_SECTIONS
           if trace and (select is None or measured[name][2] & active)]
    rig_names: set = set()
    if ran:
        from .programspace import rig_configs
        rig_names = set(rig_configs())

    def orphans() -> List[str]:
        # bounds of rigs that no longer exist (not merely unhosted here)
        # would disarm the tripwire silently
        out = set()
        for name in ran:
            out |= set(load_budget(baseline_path, name)) - rig_names
        return sorted(out)

    baseline = load_baseline(baseline_path)
    dropped = 0
    if args.update_baseline:
        # shrink first (the findings and the budget), then split against
        # the file as this run leaves it
        kept = shrink_baseline(baseline_path, findings,
                               active_rules=active)
        dropped = len(baseline) - len(kept)
        for name in ran:
            reps, field, _ = measured[name]
            budget = shrink_budget(
                baseline_path, name, {r["config"]: r[field] for r in reps},
                known=rig_names)
            for rep in reps:
                rep["budget"] = budget.get(rep["config"])
                if rep["budget"] is not None:
                    rep["delta"] = rep[field] - rep["budget"]
        baseline = load_baseline(baseline_path)
    new, old, stale = split_findings(findings, baseline,
                                     active_rules=active)
    # budget slack: a measurement below its bound must be committed, or a
    # later growth hides in the slack; a measured rig with no bound is the
    # limiting case (the tripwire is disarmed)
    budgeted = reports + sharding
    slack = [r for r in budgeted
             if r.get("delta") is not None and r["delta"] < 0]
    unbounded = [r for r in budgeted if r.get("budget") is None]
    budget_stale = orphans()
    debt = bool(stale or slack or unbounded or budget_stale)

    if args.json:
        payload = {
            "findings": [
                {"rule": f.rule, "unit": f.unit, "line": f.line,
                 "msg": f.msg, "fingerprint": f.fingerprint,
                 "baselined": f.fingerprint in baseline,
                 "detail": f.detail}
                for f in new + old],
            "stale": sorted(stale),
            "budget_stale": budget_stale,
            "program_space": reports,
            "sharding": sharding,
            "collectives": extras.get("collectives"),
            "concurrency_surface": extras.get("concurrency"),
            "protocol_surface": extras.get("protocol"),
            "summary": {"new": len(new), "baselined": len(old),
                        "stale": len(stale), "budget_slack": len(slack),
                        "budget_stale": len(budget_stale),
                        "budget_unbounded": len(unbounded)},
        }
        print(json.dumps(payload, indent=2))
        return 1 if new or (debt and args.strict) else 0

    for f in new:
        print(f.render())
    for f in old:
        print(f"{f.render()}  [baselined]")
    for rep in reports:
        b, delta = rep.get("budget"), rep.get("delta")
        d_txt = ("no baseline — run --update-baseline" if b is None
                 else f"baseline {b}, delta {delta:+d}")
        print(f"program budget {rep['config']}: {rep['programs']} "
              f"programs, {len(rep['instances'])} kernel instances "
              f"({d_txt})")
    for rep in sharding:
        b, delta = rep.get("budget"), rep.get("delta")
        d_txt = ("no baseline — run --update-baseline" if b is None
                 else f"baseline {b}, delta {delta:+d}")
        print(f"replication budget {rep['config']}: "
              f"{rep['replicated_bytes']} replicated B/step ({d_txt})")
    verb = "FAIL" if args.strict else "note"
    if args.update_baseline:
        print(f"baseline: kept {len(baseline)}, dropped {dropped} stale "
              f"entr{'y' if dropped == 1 else 'ies'} ({baseline_path})")
    else:
        if stale:
            print(f"{verb}: {len(stale)} stale baseline entr"
                  f"{'y' if len(stale) == 1 else 'ies'} no longer "
                  f"fire(s) — run --update-baseline to ratchet down:")
            for fp in sorted(stale):
                print(f"  {fp}")
        if slack:
            print(f"{verb}: {len(slack)} budget(s) above the "
                  f"measurement — run --update-baseline to ratchet "
                  f"down:")
            for rep in slack:
                got = rep.get("programs", rep.get("replicated_bytes"))
                print(f"  {rep['config']}: {got} measured < "
                      f"{rep['budget']} baselined")
        if budget_stale:
            print(f"{verb}: {len(budget_stale)} budget entr"
                  f"{'y' if len(budget_stale) == 1 else 'ies'} for unknown "
                  f"rig config(s) — run --update-baseline to drop:")
            for cfg in budget_stale:
                print(f"  {cfg}")
        if unbounded and args.strict:
            print(f"FAIL: {len(unbounded)} measured config(s) have no "
                  f"program_budget or replication_budget bound — run "
                  f"--update-baseline to initialize:")
            for rep in unbounded:
                got = rep.get("programs", rep.get("replicated_bytes"))
                print(f"  {rep['config']}: {got} measured")
    print(f"roc-lint: {len(new)} new, {len(old)} baselined, "
          f"{len(stale)} stale")
    if new:
        return 1
    if debt and args.strict:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
