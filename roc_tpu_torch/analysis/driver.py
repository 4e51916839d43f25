"""Run every lint level — the engine behind ``python -m
roc_tpu_torch.analysis`` (``roc_tpu/analysis/driver.py``).

The host levels (AST, concurrency, protocol) read the tree and import no
torch.  The trace levels build the port on the CPU rig (the JAX
package's synthetic rig, analysis/programspace.py ``_V``.. ``_H``) and
import torch lazily:

- the program space (:mod:`programspace`): each rig's programs, the
  compile-explosion budget and the cache-key drift; the single-rank rigs
  are built in this process, the partitioned ones on their ranks;
- the collectives (:mod:`collective_lint`): one train step and one eval
  step per rank recorded on :data:`~collective_lint.TRACE_RANKS` gloo
  ranks (the 1-D gather and ring halos at P = 4, the 2x2 mesh), and the
  ring tables against the partition's halo stats;
- [partition-imbalance]: the 1-D run's split, max/mean edges past
  :data:`IMBALANCE_THRESHOLD` (the JAX package's 1.5).

The ranks of the partitioned rigs and of the collectives are one
``run_ranks`` call.  Findings are emitted as ``analysis`` events besides
being returned.  The JAX package's jaxpr, HLO and sharding levels read
XLA programs and sharding annotations, which the port does not have.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

from ..obs.events import emit
from .ast_lint import RULES as AST_RULES, run_ast_lint
from .collective_lint import COLLECTIVE_RULES
from .concurrency_lint import (CONCURRENCY_RULES, TreeModel,
                               audit_concurrency)
from .findings import Finding, dedupe
from .programspace import PROGRAMSPACE_RULES
from .protocol_lint import PROTOCOL_RULES, audit_protocol

# trace rules that are not a collective rule of a recorded unit: the
# ring tables against the split, and the split's balance
EXTRA_TRACE_RULES = ("partition-imbalance", "collective-ring-halo")
COLLECTIVE_LEVEL = tuple(COLLECTIVE_RULES) + ("collective-ring-halo",)
TRACE_RULES = (PROGRAMSPACE_RULES + tuple(COLLECTIVE_RULES)
               + EXTRA_TRACE_RULES)

# --select aliases: a level's name stands for all of its rules
GROUPS = {"concurrency": CONCURRENCY_RULES, "protocol": PROTOCOL_RULES,
          "programspace": PROGRAMSPACE_RULES,
          "collectives": COLLECTIVE_LEVEL}

# a max/mean edge imbalance past this across the parts means the slowest
# part gates every step by half over the mean (the JAX package's value)
IMBALANCE_THRESHOLD = 1.5


def all_rule_names() -> List[str]:
    return ([r.name for r in AST_RULES] + list(CONCURRENCY_RULES)
            + list(PROTOCOL_RULES) + list(EXTRA_TRACE_RULES)
            + list(COLLECTIVE_RULES) + list(PROGRAMSPACE_RULES))


def is_trace_rule(name: str) -> bool:
    """True for the rules of the trace levels (they build the port)."""
    return name in TRACE_RULES


def check_partition_imbalance(unit: str, real_edges,
                              num_parts: Optional[int] = None,
                              threshold: float = IMBALANCE_THRESHOLD
                              ) -> List[Finding]:
    """[partition-imbalance] the split's max/mean real edges over
    ``threshold`` on two or more parts: the slowest part gates every step
    and every ring hop."""
    import numpy as np
    real_edges = np.asarray(real_edges, dtype=np.float64)
    if num_parts is None:
        num_parts = int(real_edges.shape[0])
    if num_parts < 2 or real_edges.size == 0:
        return []
    mean = float(real_edges.sum()) / num_parts
    if mean <= 0:
        return []
    ratio = float(real_edges.max()) / mean
    if ratio <= threshold:
        return []
    return [Finding(
        "partition-imbalance", unit,
        f"edge imbalance max/mean {ratio:.2f} > {threshold} across "
        f"{num_parts} parts — the slowest part gates every step (use "
        f"--partition cost / --rebalance, or reorder the vertex ids)",
        key=f"parts={num_parts}",
        detail={"ratio": round(ratio, 4), "threshold": threshold})]


def _wants(select: Optional[List[str]], rules) -> bool:
    return select is None or any(s in rules for s in select)


def build_trace_findings(select: Optional[List[str]] = None,
                         program_budget: Optional[Dict[str, int]] = None,
                         extras: Optional[Dict[str, Any]] = None,
                         device_kind: Optional[str] = None
                         ) -> List[Finding]:
    """The trace levels on the CPU rig (module docstring); the program
    spaces with the instances of ``device_kind`` (None: the CPU's)."""
    from .collective_lint import (TRACE_RANKS, TRACE_RUNS, check_ring_halo,
                                  run_collective_lint, trace_rank_job,
                                  units_of)
    from .programspace import (ProgramEntry, ProgramSpace,
                               audit_program_space, hosted_rigs,
                               rig_configs)
    want_ps = _wants(select, PROGRAMSPACE_RULES)
    want_coll = _wants(select, COLLECTIVE_RULES)
    want_imb = _wants(select, ("partition-imbalance",))
    dist_rigs = []
    if want_ps:
        dist_rigs = [n for n in hosted_rigs("cpu")
                     if rig_configs()[n].parts > 1]
    runs = [u for u, _, _ in TRACE_RUNS
            if want_coll or (want_imb and u == "dist_gather_p4")]
    results: List[Dict[str, Any]] = []
    if dist_rigs or runs:
        from ..parallel.distributed import run_ranks
        results = run_ranks(trace_rank_job, TRACE_RANKS, rigs=dist_rigs,
                            runs=runs, device_kind=device_kind)
    findings: List[Finding] = []
    if want_ps:
        spaces = []
        for name, sp in (results[0]["spaces"] if results else {}).items():
            spaces.append(ProgramSpace(
                config=name,
                entries=[ProgramEntry(**e) for e in sp["entries"]],
                node_multiple=sp["node_multiple"],
                edge_multiple=sp["edge_multiple"],
                resolved=sp["resolved"], device_kind=device_kind))
        findings.extend(audit_program_space(
            select=select, program_budget=program_budget, extras=extras,
            spaces=spaces, device="cpu", device_kind=device_kind))
    if want_coll and results:
        units = units_of(results)
        findings.extend(run_collective_lint(units, select=select))
        if extras is not None:
            extras["collectives"] = [
                {"unit": u.name, "ranks": len(u.seqs),
                 "calls": len(next(iter(u.seqs.values()), [])),
                 "axes": u.axis_sizes} for u in units]
    if _wants(select, ("collective-ring-halo",)):
        from ..core.partition import partition_graph
        from ..parallel.ring import build_ring_tables
        from .programspace import build_rig_dataset
        pg = partition_graph(build_rig_dataset().graph, TRACE_RANKS)
        findings.extend(check_ring_halo("collective:ring_tables", pg,
                                        build_ring_tables(pg)))
    if want_imb and results and "real_edges" in results[0]:
        findings.extend(check_partition_imbalance(
            "partition:dist_trainer", results[0]["real_edges"]))
    return findings


def analyze(root: str, select: Optional[List[str]] = None,
            extras: Optional[Dict[str, Any]] = None, trace: bool = True,
            program_budget: Optional[Dict[str, int]] = None,
            device_kind: Optional[str] = None) -> List[Finding]:
    """The host levels over ``root`` and, with ``trace``, the trace
    levels (each only when ``select`` names one of its rules, all by
    default).  Every finding is also emitted as an ``analysis`` event.
    ``extras``, when a dict, receives the levels' surfaces under
    ``'concurrency'``, ``'protocol'``, ``'programspace'`` and
    ``'collectives'``.  ``program_budget``: the compile-explosion bounds
    (None: none recorded)."""
    t0 = time.perf_counter()
    findings = run_ast_lint(root, select=None if select is None else [
        s for s in select if s not in TRACE_RULES])
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
    if trace and _wants(select, TRACE_RULES):
        findings.extend(build_trace_findings(
            select=select, program_budget=program_budget, extras=extras,
            device_kind=device_kind))
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
