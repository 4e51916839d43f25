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
  :data:`IMBALANCE_THRESHOLD` (the JAX package's 1.5);
- the recorded programs (:mod:`jaxpr_lint`, :mod:`hlo_lint`): the JAX
  package's seven units in its configuration, the GCN ``[_F, _H, _C]``
  at dropout 0.5, symmetric, fp32 weights and bf16 compute, on the
  kernel route (the kernels' plain versions on the CPU, each one opaque
  entry), recorded by analysis/step_trace.py in place of its jaxprs:
  ``train_step`` and ``eval_step`` (the programspace candidates' ``run``),
  ``model_graph`` (``model.loss_fn``), ``tail_grad`` and
  ``apply_update`` (the ``features='host'`` trainer's tail and
  ``adam_update``), and ``dist_train_step``/``dist_eval_step`` recorded
  on the ranks of the 1-D gather run; the HLO rules on the recorded
  ``train_step``;
- the sharding audit (:mod:`sharding_lint`): every rig's modeled
  replication ledger (no ranks) and the live rules on the 2x2 mesh's
  recorded ranks.

The ranks of the partitioned rigs, of the collectives and of the
recorded distributed steps are one ``run_ranks`` call.  Findings are
emitted as ``analysis`` events besides being returned.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..obs.events import emit
from .ast_lint import RULES as AST_RULES, run_ast_lint
from .collective_lint import COLLECTIVE_RULES
from .concurrency_lint import (CONCURRENCY_RULES, TreeModel,
                               audit_concurrency)
from .findings import Finding, dedupe
from .jaxpr_lint import JAXPR_RULES
from .programspace import PROGRAMSPACE_RULES
from .protocol_lint import PROTOCOL_RULES, audit_protocol
from .sharding_lint import SHARDING_RULES

HLO_RULES = ("hlo-large-copy", "hlo-bytes-model")

# trace rules that are not a collective rule of a recorded unit: the
# ring tables against the split, and the split's balance
EXTRA_TRACE_RULES = ("partition-imbalance", "collective-ring-halo")
COLLECTIVE_LEVEL = tuple(COLLECTIVE_RULES) + ("collective-ring-halo",)
TRACE_RULES = (PROGRAMSPACE_RULES + tuple(COLLECTIVE_RULES)
               + EXTRA_TRACE_RULES + tuple(JAXPR_RULES) + HLO_RULES
               + SHARDING_RULES)

# the JAX package's AST rules whose constructs (``jax.jit``, Pallas's
# ``interpret=``) the port has not, by the port's rules that guard their
# invariants (analysis/ast_lint.py): names that select the same
# invariant in both packages
JAX_ALIASES = {"bare-jit": ("unobserved-step",),
               "pallas-interpret": ("kernel-fallback",)}

# --select aliases: a level's name stands for all of its rules
GROUPS = {"concurrency": CONCURRENCY_RULES, "protocol": PROTOCOL_RULES,
          "programspace": PROGRAMSPACE_RULES,
          "collectives": COLLECTIVE_LEVEL, "sharding": SHARDING_RULES,
          **JAX_ALIASES}

# the recorded 1-D run whose ranks give the distributed jaxpr units
DIST_UNIT_RUN = "dist_gather_p4"

# a max/mean edge imbalance past this across the parts means the slowest
# part gates every step by half over the mean (the JAX package's value)
IMBALANCE_THRESHOLD = 1.5


def all_rule_names() -> List[str]:
    """Every rule's name, the JAX package's AST names the port's rules
    stand for (:data:`JAX_ALIASES`) too."""
    return ([r.name for r in AST_RULES] + list(JAX_ALIASES)
            + list(CONCURRENCY_RULES) + list(PROTOCOL_RULES)
            + list(JAXPR_RULES) + list(HLO_RULES)
            + list(EXTRA_TRACE_RULES) + list(COLLECTIVE_RULES)
            + list(PROGRAMSPACE_RULES) + list(SHARDING_RULES))


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


def step_units(hlo: bool = False) -> Tuple[List[Any], List[Finding]]:
    """The single-device jaxpr units (module docstring), recorded on the
    CPU, and with ``hlo`` the HLO rules' findings on the recorded
    ``train_step``."""
    from ..models.gcn import build_gcn
    from ..train.optimizer import adam_update
    from ..train.trainer import (TrainConfig, Trainer, cast_floats,
                                 resolve_dtypes)
    from .hlo_lint import check_bytes_model, check_large_copy
    from .jaxpr_lint import StepUnit
    from .programspace import (_C, _F, _H, _V, build_rig_dataset,
                               candidate_programs)
    from .step_trace import record
    f32, bf16 = resolve_dtypes("mixed")
    ds = build_rig_dataset()

    def trainer(**kw):
        cfg = TrainConfig(verbose=False, symmetric=True, aggr_impl="cuda",
                          dropout_rate=0.5, dtype=f32, compute_dtype=bf16,
                          **kw)
        return Trainer(build_gcn([_F, _H, _C], dropout_rate=0.5), ds, cfg,
                       device="cpu")

    tr = trainer()
    ctx: Dict[str, Any] = dict(
        compute_dtype="bfloat16", num_nodes=_V, vf_elems=_V * _F,
        halo="gather", donate_min_bytes=max(
            v.numel() * v.element_size() for v in tr.params.values()))
    traces: Dict[str, Any] = {}
    for c in candidate_programs(tr):
        def rec(fn, slot=c.slot):
            traces[slot] = record(fn, args_of=lambda: tr.step_args(slot))
            return traces[slot].result
        c.run(record=rec)
    units = [StepUnit("train_step", traces["train_step"], donate=(0, 1),
                      **ctx),
             StepUnit("eval_step", traces["eval_step"], **ctx),
             StepUnit("model_graph", record(
                 lambda: tr.model.loss_fn(
                     cast_floats(tr.params, tr.compute), tr.feats,
                     tr.labels, tr.mask, tr.gctx, generator=tr.generator,
                     train=True)), **ctx)]
    # the host-feature tier's device-resident tail and the update
    st = trainer(features="host")
    w0 = st.params[st._head_param]
    y = st.feats_host.new_zeros((st.feats_host.shape[0], w0.shape[1]))
    names = [k for k in st.params if k != st._head_param]
    units.append(StepUnit("tail_grad", record(st._tail_grad, y, names),
                          **ctx))
    grads = {k: v.detach().new_zeros(v.shape) for k, v in st.params.items()}
    opt = st.opt_state
    units.append(StepUnit("apply_update", record(
        adam_update, st.params, grads, opt, 0.01, st.adam_cfg,
        args_of=lambda: (st.params, (opt.m, opt.v), grads)),
        donate=(0, 1), **ctx))
    found: List[Finding] = []
    if hlo:
        t = traces["train_step"]
        found += check_large_copy("hlo:train_step", t, _V * _F)
        found += check_bytes_model("hlo:train_step", t.bytes_total,
                                   tr.modeled_bytes)
    return units, found


def dist_units(results: Sequence[Dict[str, Any]]) -> List[Any]:
    """The distributed jaxpr units: each rank's recorded steps of
    :data:`DIST_UNIT_RUN` (the per-rank activation scale V/P * F)."""
    from .collective_lint import TRACE_RUNS
    from .jaxpr_lint import StepUnit
    from .programspace import _F, _V
    parts = {u: p for u, p, _ in TRACE_RUNS}[DIST_UNIT_RUN]
    units = []
    for res in results:
        got = res.get("traces", {}).get(DIST_UNIT_RUN)
        if not got:
            continue
        params = [leaf for leaf in got["train_step"].leaves
                  if leaf.arg == 0]
        ctx = dict(compute_dtype="bfloat16", num_nodes=_V,
                   vf_elems=(_V * _F) // parts, halo="gather",
                   mesh_parts=parts, donate_min_bytes=max(
                       leaf.meta.nbytes for leaf in params))
        units.append(StepUnit("dist_train_step", got["train_step"],
                              donate=(0, 1), **ctx))
        units.append(StepUnit("dist_eval_step", got["eval_step"], **ctx))
    return units


def build_trace_findings(select: Optional[List[str]] = None,
                         program_budget: Optional[Dict[str, int]] = None,
                         extras: Optional[Dict[str, Any]] = None,
                         device_kind: Optional[str] = None,
                         replication_budget: Optional[Dict[str, int]] = None
                         ) -> List[Finding]:
    """The trace levels on the CPU rig (module docstring); the program
    spaces with the instances of ``device_kind`` (None: the CPU's)."""
    from .collective_lint import (TRACE_RANKS, TRACE_RUNS, check_ring_halo,
                                  run_collective_lint, trace_rank_job,
                                  units_of)
    from .programspace import (ProgramEntry, ProgramSpace,
                               audit_program_space, hosted_rigs,
                               rig_configs)
    from .sharding_lint import LIVE_RUN
    want_ps = _wants(select, PROGRAMSPACE_RULES)
    want_coll = _wants(select, COLLECTIVE_RULES)
    want_imb = _wants(select, ("partition-imbalance",))
    want_jaxpr = _wants(select, JAXPR_RULES)
    want_hlo = _wants(select, HLO_RULES)
    want_sh = _wants(select, SHARDING_RULES)
    live = want_sh and _wants(select, SHARDING_RULES[1:])
    dist_rigs = []
    if want_ps:
        dist_rigs = [n for n in hosted_rigs("cpu")
                     if rig_configs()[n].parts > 1]
    recorded = ([DIST_UNIT_RUN] if want_jaxpr else []) + \
        ([LIVE_RUN] if live else [])
    runs = [u for u, _, _ in TRACE_RUNS
            if want_coll or u in recorded
            or (want_imb and u == "dist_gather_p4")]
    results: List[Dict[str, Any]] = []
    if dist_rigs or runs:
        from ..parallel.distributed import run_ranks
        results = run_ranks(trace_rank_job, TRACE_RANKS, rigs=dist_rigs,
                            runs=runs, device_kind=device_kind,
                            recorded=recorded)
    findings: List[Finding] = []
    if want_jaxpr or want_hlo:
        from .jaxpr_lint import run_jaxpr_lint
        units, hlo_found = step_units(hlo=want_hlo)
        if want_jaxpr:
            findings.extend(run_jaxpr_lint(units + dist_units(results),
                                           select=select))
        findings.extend(f for f in hlo_found
                        if select is None or f.rule in select)
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
    if want_sh:
        from .sharding_lint import audit_sharding
        findings.extend(audit_sharding(
            select=select, replication_budget=replication_budget,
            extras=extras, results=results))
    return findings


def analyze(root: str, select: Optional[List[str]] = None,
            extras: Optional[Dict[str, Any]] = None, trace: bool = True,
            program_budget: Optional[Dict[str, int]] = None,
            device_kind: Optional[str] = None,
            replication_budget: Optional[Dict[str, int]] = None
            ) -> List[Finding]:
    """The host levels over ``root`` and, with ``trace``, the trace
    levels (each only when ``select`` names one of its rules, all by
    default).  Every finding is also emitted as an ``analysis`` event.
    ``extras``, when a dict, receives the levels' surfaces under
    ``'concurrency'``, ``'protocol'``, ``'programspace'``,
    ``'collectives'`` and ``'sharding'``.  ``program_budget`` and
    ``replication_budget``: the compile-explosion and replication bounds
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
            device_kind=device_kind,
            replication_budget=replication_budget))
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
