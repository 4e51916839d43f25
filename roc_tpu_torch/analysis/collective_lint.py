"""The collective lint (``roc_tpu/analysis/collective_lint.py``): the
ranks' ``torch.distributed`` calls, held to the rules a lockstep program
needs.

The JAX package reads its collectives from the jaxprs of its SPMD steps.
The port's go through one choke point, parallel/distributed.py
``Collectives``; ``record_collectives`` records each call of a process
(kind, group, shape, dtype, ring peer), and :func:`trace_rank_job`
records one train step and one eval step per rank on the CPU rig.  A
:class:`CollectiveUnit` holds every rank's sequence of one such run.
None of these defects raises where it is made; each hangs a rank or
sums the wrong rows at P >= 2:

- [collective-conditional] every rank issues the same sequence (kind,
  group, shape, dtype, and a ring shift's permutation): a rank that
  skips or adds a collective waits on the others forever, or pairs its
  sum with another's gather (the JAX package's conditional rule: there
  the branches of a ``cond``, here the ranks);
- [collective-ppermute-cycle] each ring shift forms one cycle over its
  whole group (parallel/ring.py ``ring_hop_perm``): two cycles rotate
  two halves apart, a partial cover leaves ranks waiting on sends that
  never come;
- [collective-axis-name] each collective names a group of the mesh the
  run built (``parts``, and ``model`` on the ``(parts, model)`` mesh;
  on the 1-D mesh the world is the parts axis): a call over the whole
  world on a 2-D mesh mixes the model ranks' copies into a sum;
- [collective-ring-halo] the ring tables' send/receive row counts
  (:func:`ring_table_halo_counts`) equal the partition's halo stats
  (core/costmodel.py ``partition_halo_stats``): two derivations of the
  same exchange.

Findings carry the JAX package's rule names and keys, the collectives by
its primitive names (an all-reduce is ``psum``, a ring shift
``ppermute``), so one crafted defect gives one finding in both packages.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .findings import Finding

# the JAX primitive each recorded kind stands for
PRIMITIVE = {"all_gather": "all_gather", "reduce_scatter": "reduce_scatter",
             "ring_shift": "ppermute", "broadcast": "pbroadcast"}


def primitive(call: Dict[str, Any]) -> str:
    if call["kind"] == "all_reduce":
        return "pmax" if call.get("op") == "max" else "psum"
    return PRIMITIVE.get(call["kind"], call["kind"])


@dataclass
class CollectiveUnit:
    """One recorded distributed run: ``seqs`` maps each global rank to
    its calls in order (parallel/distributed.py ``record_collectives``
    records); ``axis_sizes`` is the mesh the run built (group name ->
    size)."""

    name: str
    seqs: Dict[int, List[Dict[str, Any]]]
    axis_sizes: Dict[str, int] = field(default_factory=dict)

    @property
    def unit(self) -> str:
        return f"collective:{self.name}"


def _cycle_problem(perm: List[Tuple[int, int]],
                   size: int) -> Optional[str]:
    """None when ``perm`` is one cycle over {0..size-1}; else the
    defect (the JAX package's wording)."""
    srcs = [s for s, _ in perm]
    dsts = [d for _, d in perm]
    members = set(range(size))
    if set(srcs) != members or set(dsts) != members:
        missing = sorted(members - set(srcs) - set(dsts))
        return (f"covers {len(set(srcs) | set(dsts))}/{size} members"
                + (f" (missing {missing})" if missing else
                   " asymmetrically"))
    if len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts):
        return "duplicate senders/receivers"
    nxt = dict(perm)
    seen, cur = 1, nxt[0]
    while cur != 0 and seen <= size:
        cur = nxt[cur]
        seen += 1
    if seen != size:
        return f"{_n_cycles(nxt, size)} disjoint cycles"
    return None


def _n_cycles(nxt: Dict[int, int], size: int) -> int:
    left, n = set(range(size)), 0
    while left:
        n += 1
        cur = start = left.pop()
        while nxt[cur] != start:
            cur = nxt[cur]
            left.discard(cur)
    return n


def ring_perms(u: CollectiveUnit) -> List[Tuple[str, int,
                                               List[Tuple[int, int]]]]:
    """The permutation of each ring shift: the k-th ring shift of every
    rank of one group instance, as ``(group, size, [(rank, to)])`` in
    group ranks."""
    by: Dict[Tuple[Tuple[int, ...], int], List[Dict[str, Any]]] = {}
    for _, seq in sorted(u.seqs.items()):
        k_of: Dict[Tuple[int, ...], int] = {}
        for c in seq:
            if c["kind"] != "ring_shift":
                continue
            members = tuple(c["members"])
            k = k_of.get(members, 0)
            k_of[members] = k + 1
            by.setdefault((members, k), []).append(c)
    out = []
    for (members, _), calls in sorted(by.items()):
        out.append((calls[0]["group"], len(members),
                    sorted((int(c["rank"]), int(c["to"])) for c in calls)))
    return out


def check_ppermute_cycle(u: CollectiveUnit) -> List[Finding]:
    """[collective-ppermute-cycle] see the module docstring.  Any single
    cycle over the group passes (a reversed ring too)."""
    out: List[Finding] = []
    seen = set()
    for group, size, perm in ring_perms(u):
        problem = _cycle_problem(perm, size)
        if problem and (group, problem) not in seen:
            seen.add((group, problem))
            out.append(Finding(
                "collective-ppermute-cycle", u.unit,
                f"ring shift over {group} (size {size}) is not a single "
                f"full cycle: {problem} — this hangs or drops parts at "
                f"P>=2 (the named schedule is parallel/ring.py "
                f"ring_hop_perm)",
                key=f"ppermute|{group}|{problem}"))
    return out


def check_axis_names(u: CollectiveUnit) -> List[Finding]:
    """[collective-axis-name] see the module docstring."""
    out: List[Finding] = []
    known = set(u.axis_sizes)
    seen = set()
    for _, seq in sorted(u.seqs.items()):
        for c in seq:
            prim = primitive(c)
            if c["group"] in known or (prim, c["group"]) in seen:
                continue
            seen.add((prim, c["group"]))
            out.append(Finding(
                "collective-axis-name", u.unit,
                f"{prim} over group {c['group']!r}, which the run's mesh "
                f"does not define (axes: {sorted(known)}) — a collective "
                f"over the wrong ranks",
                key=f"axis|{prim}|{c['group']}"))
    return out


def _signature(seq: Sequence[Dict[str, Any]]) -> Tuple:
    """One rank's lockstep schedule: per call its primitive, group,
    operand and, for a ring shift, the group's permutation its shift
    implies (every rank of a ring shares it)."""
    sig = []
    for c in seq:
        perm = ()
        if c["kind"] == "ring_shift":
            n = int(c["size"])
            perm = tuple((i, (i + int(c["shift"])) % n) for i in range(n))
        sig.append((primitive(c), (c["group"],),
                    f"{c['dtype']}{list(c['shape'])}", perm))
    return tuple(sig)


def check_conditional_collective(u: CollectiveUnit) -> List[Finding]:
    """[collective-conditional] see the module docstring: the ranks'
    distinct schedules, in rank order."""
    sigs: List[Tuple] = []
    for _, seq in sorted(u.seqs.items()):
        s = _signature(seq)
        if s not in sigs:
            sigs.append(s)
    if len(sigs) <= 1:
        return []
    detail = " vs ".join(
        "[" + ", ".join(f"{p}@{'/'.join(n)}" + (f"{list(pm)}" if pm else "")
                        for p, n, _, pm in s) + "]" for s in sigs)
    return [Finding(
        "collective-conditional", u.unit,
        f"the ranks issue different collective sequences ({detail[:400]}) "
        f"— a rank waits on a collective the others never issue, a "
        f"deadlock of the lockstep program at P>=2",
        key=f"cond|{detail[:80]}")]


COLLECTIVE_RULES = {
    "collective-ppermute-cycle": check_ppermute_cycle,
    "collective-axis-name": check_axis_names,
    "collective-conditional": check_conditional_collective,
}


def run_collective_lint(units: Sequence[CollectiveUnit],
                        select: Optional[List[str]] = None
                        ) -> List[Finding]:
    findings: List[Finding] = []
    for unit in units:
        for name, rule in COLLECTIVE_RULES.items():
            if select is not None and name not in select:
                continue
            findings.extend(rule(unit))
    return findings


# ------------------------------------------- ring-table consistency

def ring_table_halo_counts(pg, rt) -> Tuple[np.ndarray, np.ndarray]:
    """(send_in [P], send_out [P]) from the ring tables alone: per part,
    the distinct external source rows its pairs gather, and the distinct
    local rows other parts' pairs reference.  Held to
    core/costmodel.py ``partition_halo_stats`` by
    :func:`check_ring_halo`."""
    P = pg.num_parts
    recv = np.zeros(P, dtype=np.int64)
    sent: List[set] = [set() for _ in range(P)]
    for p in range(P):
        gathered = set()
        for s in range(P):
            src = np.asarray(rt.src[p, s], dtype=np.int64)
            real = np.unique(src[src < pg.part_nodes])
            if s != p:
                gathered.update((s, int(v)) for v in real)
                sent[s].update(int(v) for v in real)
        recv[p] = len(gathered)
    send = np.array([len(s) for s in sent], dtype=np.int64)
    return recv, send


def check_ring_halo(unit: str, pg, rt) -> List[Finding]:
    """[collective-ring-halo] see the module docstring."""
    from ..core.costmodel import partition_halo_stats
    halo_in, halo_out = partition_halo_stats(pg)
    recv, send = ring_table_halo_counts(pg, rt)
    out: List[Finding] = []
    for p in range(pg.num_parts):
        if int(recv[p]) != int(halo_in[p]):
            out.append(Finding(
                "collective-ring-halo", unit,
                f"part {p}: ring tables gather {int(recv[p])} distinct "
                f"external rows but the partition plan's halo-in is "
                f"{int(halo_in[p])} — the hop schedule and the split "
                f"disagree about what must be exchanged",
                key=f"halo-in|part={p}",
                detail={"table": int(recv[p]), "plan": int(halo_in[p])}))
        if int(send[p]) != int(halo_out[p]):
            out.append(Finding(
                "collective-ring-halo", unit,
                f"part {p}: ring tables reference {int(send[p])} distinct "
                f"rows of this part from other parts but the plan's "
                f"halo-out is {int(halo_out[p])}",
                key=f"halo-out|part={p}",
                detail={"table": int(send[p]), "plan": int(halo_out[p])}))
    return out


# ------------------------------------------------- the recorded runs

# the runs the trace records on TRACE_RANKS CPU ranks: (unit, parts,
# config fields); the GCN at the rig's widths on the kernel route (its
# plain versions on the CPU), fp32 weights and bf16 compute (the JAX
# package's lint configuration)
TRACE_RANKS = 4
TRACE_RUNS = (
    ("dist_gather_p4", 4, {"halo": "gather"}),
    ("dist_ring_p4", 4, {"halo": "ring"}),
    ("mesh_2x2", 2, {"halo": "gather", "mesh": "2x2"}),
)


def _axes(parts: int, fields: Dict[str, Any]) -> Dict[str, int]:
    from ..parallel import MODEL_AXIS, PARTS_AXIS
    mesh = fields.get("mesh", "auto")
    model = 1 if mesh == "auto" else int(str(mesh).split("x")[1])
    return ({PARTS_AXIS: parts} if model == 1
            else {PARTS_AXIS: parts, MODEL_AXIS: model})


def trace_rank_job(rigs: Sequence[str] = (), runs: Sequence[str] = (),
                   device_kind: Optional[str] = None,
                   recorded: Sequence[str] = ()) -> Dict[str, Any]:
    """One rank of the trace stage (analysis/driver.py runs
    :data:`TRACE_RANKS` of them on the CPU over gloo): the program spaces
    of the partitioned rigs ``rigs`` (on the rig's first ranks; the
    others take no part but the group's creation) and the collectives of
    one train step and one eval step of each run of :data:`TRACE_RUNS`
    named in ``runs``, and the edge counts of the 1-D gather run's split
    (the partition-imbalance rule's).  The rigs' instances are those of
    ``device_kind`` (None: the CPU's).  Of each run named in
    ``recorded`` the two steps are recorded too (analysis/step_trace.py;
    the eval step's device work, ``eval_sums``): the 1-D gather run's
    recordings are returned under ``traces`` (the jaxpr lint's
    distributed units), the 2x2 mesh's read on the rank under
    ``sharding`` (analysis/sharding_lint.py ``rank_sharding``)."""
    from ..models.gcn import build_gcn
    from ..parallel.distributed import (DistributedTrainer, new_group,
                                        record_collectives, world_rank)
    from ..train.trainer import TrainConfig, resolve_dtypes
    from .programspace import (_C, _F, _H, build_rig_dataset,
                               build_rig_trainer, rig_configs,
                               rig_required_devices, space_of)
    from .sharding_lint import LIVE_RUN, rank_sharding
    from .step_trace import record
    rank = world_rank()
    ds = build_rig_dataset()
    f32, bf16 = resolve_dtypes("mixed")
    out: Dict[str, Any] = {"rank": rank, "spaces": {}, "collectives": {},
                           "traces": {}, "sharding": {}}
    for name in rigs:
        spec = rig_configs()[name]
        members = list(range(rig_required_devices(spec)))
        group = new_group(members)
        if rank not in members:
            continue
        tr = build_rig_trainer(spec, ds, "cpu", device_kind=device_kind,
                               group=group)
        sp = space_of(spec, tr, device_kind)
        out["spaces"][name] = {
            "entries": [e.__dict__ for e in sp.entries],
            "node_multiple": sp.node_multiple,
            "edge_multiple": sp.edge_multiple,
            "resolved": sp.resolved}
    for unit, parts, fields in TRACE_RUNS:
        if unit not in runs:
            continue
        cfg = TrainConfig(verbose=False, symmetric=True, aggr_impl="cuda",
                          dropout_rate=0.5, dtype=f32, compute_dtype=bf16,
                          **fields)
        tr = DistributedTrainer(build_gcn([_F, _H, _C], dropout_rate=0.5),
                                ds, parts, cfg, device="cpu")
        with record_collectives() as rec:
            if unit in recorded:
                traces = {
                    "train_step": record(
                        tr.step, cfg.learning_rate,
                        args_of=lambda: tr.step_args("train_step")),
                    "eval_step": record(tr.eval_sums)}
            else:
                tr.step(cfg.learning_rate)
                tr.eval_sums()
        out["collectives"][unit] = {"calls": list(rec),
                                    "axes": _axes(parts, fields)}
        if unit in recorded and unit == LIVE_RUN:
            out["sharding"][unit] = rank_sharding(tr, traces)
        elif unit in recorded:
            for t in traces.values():
                t.result = None     # sent to the parent: shapes only
            out["traces"][unit] = traces
        if unit == "dist_gather_p4":
            out["real_edges"] = [int(e) for e in tr.plan.real_edges]
    return out


def units_of(results: Sequence[Dict[str, Any]]) -> List[CollectiveUnit]:
    """The :class:`CollectiveUnit` of each recorded run, from the ranks'
    :func:`trace_rank_job` results."""
    units: Dict[str, CollectiveUnit] = {}
    for res in results:
        for name, rec in res["collectives"].items():
            u = units.setdefault(name, CollectiveUnit(
                name, {}, dict(rec["axes"])))
            u.seqs[int(res["rank"])] = rec["calls"]
    return [units[n] for n, _, _ in TRACE_RUNS if n in units]
