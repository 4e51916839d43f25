"""The sharding and replication audit (``roc_tpu/analysis/sharding_lint.py``).

The JAX package seeds mesh-axis specs on a program's inputs and
propagates them abstractly through its jaxpr, on a simulated mesh.  The
port has a real ``(parts, model)`` mesh (parallel/distributed.py
``DistributedTrainer`` with ``mesh='PxM'``): its audit reads real rank
tensors and leaf shapes, and propagates nothing.  Three products:

- the **replication ledger** (:func:`ledger_entries`, :func:`union_ledger`,
  :func:`replicated_bytes`, the JAX package's functions): for every
  buffer of a config's step programs of at least 1 KiB (params, Adam
  moments, the data rows, the graph tables; the programs' arguments with
  their ``roles``, analysis/programspace.py ``Candidate``) the mesh axes
  it is split over and replicated over, and its bytes per rank, on the
  canonical ``(2, 4)`` mesh.  Each rig's ledger is modeled from its
  leaves alone, so all five rigs are audited as in the JAX package
  without ranks: a single-rank rig from its built trainer or predictor
  (whose recorded programs, analysis/step_trace.py, give the activation
  rows: the JAX package's ``activation_entries`` over the recording's
  large outputs), a partitioned rig from its part-0 tables stacked over
  its parts (the JAX package's stacked layout);
- the rules, ratcheted by ``roc_tpu_torch/analysis/lint_baseline.json``:

  - ``replication-budget``: a rig's replicated bytes past its
    ``replication_budget`` bound (shrink-only, like ``program_budget``),
    and the ledger's bytes per rank past 4x the memory model's estimate
    (key ``plan-excess``);
  - on the live 2x2 mesh (analysis/collective_lint.py ``TRACE_RUNS``'
    ``mesh_2x2``, recorded on each rank, :func:`rank_sharding`):
    ``full-width-materialization``, an op whose output has a
    model-sharded leaf's whole shape where its input held a slice (the
    per-step gather of the weights, ``DistributedTrainer._full_params``);
    ``sharding-mismatch``, a buffer whole over ``model`` sliced back to
    a rank's slice within the step (``_local_grads``);
    ``donation-under-sharding``, a donated leaf whose rank-local shape
    after the step differs from its shape before;

- the **mesh-portability report**: per rig the memory model's bytes per
  rank at every ``(parts, model)`` shape of eight devices
  (core/memory.py ``per_axis_plan_bytes``), the live 2x2 recording's
  sites, and one ``sharding`` event per rig with the JAX package's
  fields; ``python -m roc_tpu_torch.report --sharding`` renders them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Iterable, List, Optional, Sequence, Set, Tuple

from ..parallel import (MODEL_AXIS, PARTS_AXIS, candidate_mesh_shapes,
                        model_shard_spec)
from .findings import Finding
from .step_trace import ITEMSIZE, dtype_name

SHARDING_RULES = ("replication-budget", "full-width-materialization",
                  "sharding-mismatch", "donation-under-sharding")

# the mesh the replication ratchet is measured on (the JAX package's)
CANONICAL_SHAPE = (2, 4)

# ledger-vs-plan excess factor (the JAX package's)
PLAN_EXCESS_FACTOR = 4.0

# buffers below this never enter the ledger
LEDGER_MIN_BYTES = 1024

# the recorded mesh run whose ranks the live rules read
LIVE_RUN = "mesh_2x2"

Spec = Tuple[Optional[str], ...]


@dataclass
class Site:
    """One place where a model-axis split dies (``full-width``) or a
    whole buffer is sliced back (``reshard``), on a rank's recording."""

    kind: str
    op: str
    shape: Tuple[int, ...]
    dtype: str
    lost: Tuple[str, ...]
    layer: int
    src: str

    @property
    def elems(self) -> int:
        n = 1
        for d in self.shape:
            n *= int(d)
        return n

    def bytes(self) -> int:
        return self.elems * ITEMSIZE.get(self.dtype, 4)

    @property
    def key(self) -> str:
        return (f"{self.kind}|{self.op}|{self.dtype}"
                f"{list(self.shape)}|{','.join(self.lost)}")

    def record(self, shapes: Sequence[Tuple[int, int]],
               has_vertex_dim: bool) -> Dict[str, Any]:
        """The report's form, with the bytes per rank of the tensor at
        each candidate mesh shape (only a vertex split divides it)."""
        per_shape = {}
        for p, m in shapes:
            div = p if has_vertex_dim else 1
            per_shape[f"{p}x{m}"] = self.bytes() // max(div, 1)
        return {"kind": self.kind, "op": self.op,
                "shape": list(self.shape), "dtype": self.dtype,
                "lost": list(self.lost), "layer": self.layer,
                "src": self.src, "bytes": self.bytes(),
                "per_device_bytes": per_shape}


@dataclass
class RigDims:
    """Which sizes mean the vertex axis and which the feature axis of a
    rig (the JAX package's)."""

    vertex_sizes: Set[int]
    feat_sizes: Set[int]
    parts_traced: int = 1
    scale_elems: int = 1


def dims_of(V: int, C: int, params: Iterable[Any], parts: int = 1,
            part_nodes: int = 0, host_rows: int = 0) -> RigDims:
    """:class:`RigDims` from the dataset's V and C, the parameter leaves
    and, on a partitioned rig, its part rows (the JAX package's
    ``rig_dims``: the class width stays out of the feature sizes)."""
    vs = {V, V + 1}
    if parts > 1:
        vs.update({int(part_nodes), int(parts * part_nodes),
                   int(parts * part_nodes + 1)})
    if host_rows:
        vs.add(int(host_rows))
    feats: Set[int] = set()
    for leaf in params:
        shape = getattr(leaf, "shape", ())
        if len(shape) >= 1:
            feats.update(int(d) for d in shape)
    feats -= {C}
    feats = {d for d in feats if d >= 8}
    F = max(feats) if feats else 1
    return RigDims(vertex_sizes=vs, feat_sizes=feats, parts_traced=parts,
                   scale_elems=max(V * F // 8, 1))


def rig_dims(tr, ds) -> RigDims:
    """:class:`RigDims` of a built trainer (or predictor) and dataset."""
    from ..obs.compile_watch import tree_leaves
    plan = getattr(tr, "plan", None)
    parts = int(plan.num_parts) if plan is not None else 1
    fh = getattr(tr, "feats_host", None)
    return dims_of(int(ds.graph.num_nodes), int(ds.num_classes),
                   tree_leaves(tr.params), parts,
                   getattr(plan, "part_nodes", 0),
                   int(fh.shape[0]) if fh is not None else 0)


def seed_leaf(shape: Tuple[int, ...], role: str, dims: RigDims,
              model_axis: bool) -> Spec:
    """The mesh-axis seed of one buffer (the JAX package's): the stacked
    leading dim of a partitioned rig's data and tables over ``parts``;
    with ``model_axis`` the last feature-sized dim of a buffer over
    ``model``."""
    spec: List[Optional[str]] = [None] * len(shape)
    if (dims.parts_traced > 1 and role in ("data", "tables")
            and shape and int(shape[0]) == dims.parts_traced):
        spec[0] = PARTS_AXIS
    if model_axis:
        for d in range(len(shape) - 1, -1, -1):
            if spec[d] is None and int(shape[d]) in dims.feat_sizes:
                spec[d] = MODEL_AXIS
                break
    return tuple(spec)


def _leaf_roles(cand) -> List[Tuple[Any, str]]:
    """``(leaf, role)`` per flattened argument leaf."""
    from ..obs.compile_watch import tree_leaves
    out: List[Tuple[Any, str]] = []
    roles = cand.roles or ("other",) * len(cand.args)
    for arg, role in zip(cand.args, roles):
        for leaf in tree_leaves(arg):
            out.append((leaf, role))
    return out


def _leaf_bytes(leaf) -> int:
    n = 1
    for d in tuple(getattr(leaf, "shape", ())):
        n *= int(d)
    return n * ITEMSIZE.get(dtype_name(getattr(leaf, "dtype", "float32")),
                            4)


def ledger_entries(cand, dims: RigDims,
                   shape: Tuple[int, int]) -> List[Dict[str, Any]]:
    """The replication ledger of one candidate program on one
    ``(parts, model)`` shape (the JAX package's): the vertex axis split
    over ``parts``; params, Adam moments and the streamed handoff split
    over ``model`` where a dim divides; graph data and tables replicated
    over ``model``.  Largest first."""
    parts, model = int(shape[0]), int(shape[1])
    out: List[Dict[str, Any]] = []
    for leaf, role in _leaf_roles(cand):
        lshape = tuple(int(d) for d in getattr(leaf, "shape", ()))
        nbytes = _leaf_bytes(leaf)
        if nbytes < LEDGER_MIN_BYTES:
            continue
        has_vertex = (any(d in dims.vertex_sizes for d in lshape)
                      or (dims.parts_traced > 1 and lshape
                          and lshape[0] == dims.parts_traced))
        split, replicated = [], []
        div = 1
        if parts > 1:
            if has_vertex and role in ("data", "tables"):
                split.append(PARTS_AXIS)
                div *= parts
            else:
                replicated.append(PARTS_AXIS)
        if model > 1:
            mspec = (model_shard_spec(lshape, model)
                     if role in ("params", "opt_state", "stream")
                     else None)
            if mspec is not None:
                split.append(MODEL_AXIS)
                div *= model
            else:
                replicated.append(MODEL_AXIS)
        out.append({
            "role": role,
            "shape": list(lshape),
            "dtype": dtype_name(getattr(leaf, "dtype", "?")),
            "bytes": nbytes,
            "split": split,
            "replicated": replicated,
            "per_device_bytes": nbytes // div,
        })
    out.sort(key=lambda e: (-e["bytes"], e["role"], str(e["shape"])))
    return out


def activation_entries(acts: Dict[Tuple, int], dims: RigDims,
                       shape: Tuple[int, int]) -> List[Dict[str, Any]]:
    """Ledger rows of the large intermediates (the JAX package's):
    ``acts`` maps ``(shape, dtype, spec, per_rank)`` to its count; a
    per-rank tensor (``per_rank``) or one with a vertex dim is split over
    ``parts``, every one replicated over ``model``."""
    parts, model = int(shape[0]), int(shape[1])
    out: List[Dict[str, Any]] = []
    for (tshape, dtype, _spec, in_sm), count in acts.items():
        n = 1
        for d in tshape:
            n *= int(d)
        nbytes = n * ITEMSIZE.get(dtype, 4)
        if nbytes < LEDGER_MIN_BYTES:
            continue
        has_vertex = any(d in dims.vertex_sizes for d in tshape)
        split, replicated = [], []
        div = 1
        if parts > 1:
            if in_sm or has_vertex:
                split.append(PARTS_AXIS)
                div *= parts
            else:
                replicated.append(PARTS_AXIS)
        if model > 1:
            replicated.append(MODEL_AXIS)
        out.append({
            "role": "activations", "shape": list(tshape),
            "dtype": dtype, "bytes": nbytes, "count": count,
            "split": split, "replicated": replicated,
            "per_device_bytes": nbytes // div,
        })
    return out


def acts_of(traces: Iterable[Any], dims: RigDims,
            per_rank: bool = False) -> Dict[Tuple, int]:
    """The activation census of recorded programs
    (analysis/step_trace.py ``StepTrace.large`` at ``dims.scale_elems``),
    in :func:`activation_entries`' keys."""
    acts: Dict[Tuple, int] = {}
    for t in traces:
        for (shape, dtype), n in t.large(dims.scale_elems).items():
            k = (shape, dtype, (None,) * len(shape), per_rank)
            acts[k] = acts.get(k, 0) + n
    return acts


def union_ledger(per_cand: List[List[Dict[str, Any]]]
                 ) -> List[Dict[str, Any]]:
    """One ledger for a step lifecycle: distinct ``(role, shape, dtype,
    split, replicated)`` rows counted once, largest first (the JAX
    package's)."""
    seen: Set[Tuple] = set()
    out: List[Dict[str, Any]] = []
    for entries in per_cand:
        for e in entries:
            key = (e["role"], tuple(e["shape"]), e["dtype"],
                   tuple(e["split"]), tuple(e["replicated"]))
            if key in seen:
                continue
            seen.add(key)
            out.append(e)
    out.sort(key=lambda e: (-e["bytes"], e["role"], str(e["shape"])))
    return out


def replicated_bytes(entries: List[Dict[str, Any]]) -> int:
    """The ratchet quantity: the bytes per rank of every ledger row
    replicated over at least one axis of size > 1."""
    return sum(e["per_device_bytes"] for e in entries
               if e["replicated"])


# ------------------------------------------------------------- rules

def check_replication_budget(config: str, measured: int,
                             budget: Optional[int]) -> List[Finding]:
    """[replication-budget] replicated bytes on the canonical mesh past
    the baselined bound (None: no bound recorded yet)."""
    if budget is None or measured <= budget:
        return []
    return [Finding(
        "replication-budget", f"sharding:{config}",
        f"{measured} replicated bytes/step on the "
        f"{CANONICAL_SHAPE[0]}x{CANONICAL_SHAPE[1]} candidate mesh "
        f"exceed the baselined bound {budget} — a new replicated "
        f"buffer entered this config; shard it (or ratchet "
        f"deliberately by hand-editing replication_budget)",
        key="over-budget",
        detail={"replicated_bytes": measured, "budget": budget})]


def check_plan_excess(config: str, ledger_per_device: int,
                      plan_bytes: Optional[int],
                      factor: float = PLAN_EXCESS_FACTOR
                      ) -> List[Finding]:
    """[replication-budget] (key ``plan-excess``) the ledger's bytes per
    rank past ``factor`` x the memory model's estimate."""
    if not plan_bytes or ledger_per_device <= factor * plan_bytes:
        return []
    return [Finding(
        "replication-budget", f"sharding:{config}",
        f"ledger per-device bytes {ledger_per_device} exceed "
        f"{factor:g}x the core/memory.py plan estimate "
        f"({plan_bytes} B) — the step's resident buffers blew past "
        f"the plan",
        key="plan-excess",
        detail={"ledger_per_device": ledger_per_device,
                "plan_bytes": plan_bytes, "factor": factor})]


def findings_from_sites(config: str, slot: str,
                        sites: List[Site]) -> List[Finding]:
    """Sites to findings: ``reshard`` -> sharding-mismatch, the others ->
    full-width-materialization (the JAX package's wording)."""
    out: List[Finding] = []
    unit = f"sharding:{config}:{slot}"
    for s in sites:
        if s.kind == "reshard":
            out.append(Finding(
                "sharding-mismatch", unit,
                f"{s.op} forces an implicit reshard of "
                f"{s.dtype}{list(s.shape)} (axes {', '.join(s.lost)} "
                f"disagree) on the hot path"
                + (f" [{s.src}]" if s.src else ""),
                key=s.key))
        else:
            out.append(Finding(
                "full-width-materialization", unit,
                f"{s.op} loses the {'/'.join(s.lost)} split of "
                f"{s.dtype}{list(s.shape)} (layer {s.layer}) — the "
                f"output re-gathers to full width"
                + (f" [{s.src}]" if s.src else ""),
                key=s.key))
    return out


def live_sites(trace, local: Dict[str, Tuple[int, ...]],
               full: Dict[str, Tuple[int, ...]]) -> List[Site]:
    """The sites of one rank's recording on the ``(parts, model)`` mesh.
    ``local``/``full``: each model-sharded leaf's rank-local and whole
    shape.  A site's ``layer`` counts the matmuls before it.  A tensor
    is *sliced* when it derives from an input of a
    sharded leaf's local shape (the rank's slices) through ops that
    never made a whole leaf; an op with a sliced input and an output of
    a whole leaf's shape is a ``full-width`` site (its output is whole
    from there on); an op taking such a whole tensor (or one derived
    from it) of a whole leaf's shape to a local one is a ``reshard``
    site."""
    local_shapes = {tuple(v) for v in local.values()}
    full_shapes = {tuple(v) for v in full.values()}
    sliced: Set[Tuple[int, int]] = set()
    whole: Set[Tuple[int, int]] = set()
    sites: List[Site] = []
    seen: Set[str] = set()
    layer = 0

    def note(kind, e, meta):
        s = Site(kind=kind, op=e.name, shape=tuple(meta.shape),
                 dtype=meta.dtype, lost=(MODEL_AXIS,), layer=layer, src="")
        if s.key not in seen:
            seen.add(s.key)
            sites.append(s)

    for i, e in enumerate(trace.entries):
        if e.name in ("mm", "addmm", "matmul"):
            layer += 1      # the matmuls before a site: its layer
        srcs = list(e.src)
        in_sliced = any(
            (s is None and tuple(m.shape) in local_shapes
             and m.dtype.startswith(("float", "bfloat")))
            or (s is not None and s in sliced)
            for s, m in zip(srcs, e.ins))
        in_whole = [m for s, m in zip(srcs, e.ins)
                    if s is not None and s in whole]
        for k, m in enumerate(e.outs):
            shp = tuple(m.shape)
            if in_sliced and shp in full_shapes and not e.kernel:
                note("full-width", e, m)
                whole.add((i, k))
            elif in_sliced:
                sliced.add((i, k))
            elif in_whole:
                if shp in local_shapes and any(
                        tuple(w.shape) in full_shapes for w in in_whole):
                    big = next(w for w in in_whole
                               if tuple(w.shape) in full_shapes)
                    note("reshard", e, big)
                else:
                    whole.add((i, k))
        # an op writing in place makes its first argument what it wrote
        if e.inplace and srcs and srcs[0] is not None and in_sliced:
            sliced.add(srcs[0])
    return sites


def check_donation(config: str, slot: str, trace,
                   donate: Sequence[int]) -> List[Finding]:
    """[donation-under-sharding] a donated leaf of a rank whose local
    shape after the step is not its shape before."""
    out: List[Finding] = []
    for leaf in trace.leaves:
        if leaf.arg not in donate or leaf.meta.nbytes < LEDGER_MIN_BYTES:
            continue
        if tuple(leaf.after_shape) == tuple(leaf.meta.shape):
            continue
        out.append(Finding(
            "donation-under-sharding", f"sharding:{config}:{slot}",
            f"donated arg {leaf.arg} ({leaf.meta.render()}) is "
            f"{leaf.meta.dtype}{list(leaf.after_shape)} after the step — "
            f"the rank's slice was replaced by another shape, so the "
            f"update does not land in place under sharding",
            key=f"donate|{leaf.arg}|{leaf.meta.render()}"))
    return out


# ---------------------------------------------------------- the ranks

def rank_sharding(tr, traces: Dict[str, Any]) -> Dict[str, Any]:
    """What one rank of the live mesh run reports (analysis/
    collective_lint.py ``trace_rank_job``): per recorded slot its sites
    and its donation findings' fields, and the rank's live ledger beside
    the modeled one (:func:`rank_ledgers`)."""
    from ..train.trainer import STEP_DONATE
    sh = getattr(tr, "sharding", None)
    full = dict(sh.full_shapes) if sh is not None else {}
    local = {k: tuple(v.shape) for k, v in tr.params.items()
             if sh is not None and sh.dims[k] is not None}
    full = {k: full[k] for k in local}
    out: Dict[str, Any] = {"slots": {}}
    for slot, t in traces.items():
        sites = live_sites(t, local, full)
        don = check_donation(LIVE_RUN, slot, t, STEP_DONATE.get(slot, ()))
        out["slots"][slot] = {
            "sites": [s.__dict__ for s in sites],
            "donation": [(f.key, f.msg) for f in don]}
    live, modeled = rank_ledgers(tr)
    out["ledger"], out["modeled"] = live, modeled
    return out


class _Leaf:
    """A buffer's shape and dtype, where the ledger needs no tensor (a
    leaf to obs/compile_watch.py ``tree_leaves``, as a tensor is)."""

    __slots__ = ("shape", "dtype")

    def __init__(self, shape: Tuple[int, ...], dtype: str):
        self.shape, self.dtype = tuple(shape), dtype


def rank_ledgers(tr) -> Tuple[List[Dict[str, Any]],
                              List[Dict[str, Any]]]:
    """A partitioned trainer rank's ledger rows (role, shape, dtype,
    bytes, split, replicated, per_device_bytes) as it holds them, and
    the modeled ledger (:func:`ledger_entries`) of the same buffers at
    the rank's ``(parts, model)`` shape, from their whole shapes (its
    params' and moments' unsliced, its data stacked over the parts)."""
    from .programspace import Candidate, candidate_programs
    mesh = tr.mesh
    P, M = int(mesh.parts), int(mesh.model)
    sh = getattr(tr, "sharding", None)
    dims = dims_of(int(tr._fp_dataset["V"]), 0,
                   [_Leaf(tuple(v), "float32")
                    for v in (sh.full_shapes.values() if sh is not None
                              else [tuple(p.shape)
                                    for p in tr.params.values()])],
                   P, tr.plan.part_nodes)
    full_of = {}
    if sh is not None:
        for k, v in tr.params.items():
            full_of[id(v)] = sh.full_shapes[k]
        for d in (tr.opt_state.m, tr.opt_state.v):
            for k, v in d.items():
                full_of[id(v)] = sh.full_shapes[k]
    live_rows: List[List[Dict[str, Any]]] = []
    modeled: List[Any] = []
    for cand in candidate_programs(tr, device_kind=None):
        rows = []
        whole_args = []
        for leaf, role in _leaf_roles(cand):
            shape = tuple(int(d) for d in leaf.shape)
            dt = dtype_name(leaf.dtype)
            nbytes = _leaf_bytes(leaf)
            whole = full_of.get(id(leaf))
            if role in ("params", "opt_state"):
                whole_args.append((_Leaf(tuple(whole or shape), dt), role))
            else:
                whole_args.append((_Leaf((P,) + shape, dt), role))
            if nbytes < LEDGER_MIN_BYTES:
                continue
            split, replicated = [], []
            if P > 1:
                (split if role in ("data", "tables") else
                 replicated).append(PARTS_AXIS)
            if M > 1:
                (split if whole is not None and tuple(whole) != shape
                 else replicated).append(MODEL_AXIS)
            factor = 1
            if PARTS_AXIS in split:
                factor *= P
            if MODEL_AXIS in split:
                factor *= M
            rows.append({"role": role, "shape": list(shape), "dtype": dt,
                         "bytes": nbytes * factor, "split": split,
                         "replicated": replicated,
                         "per_device_bytes": nbytes})
        live_rows.append(rows)
        modeled.append(Candidate(
            slot=cand.slot, args=tuple(a for a, _ in whole_args),
            roles=tuple(r for _, r in whole_args)))
    return (union_ledger(live_rows),
            union_ledger([ledger_entries(c, dims, (P, M))
                          for c in modeled]))



# -------------------------------------------------------- rig audit

def _record_candidates(cands) -> List[Any]:
    """Each candidate's program recorded once (a trainer's slot through
    its restoring ``run``, a predictor's bucket dispatch)."""
    from .step_trace import record
    traces = []
    for c in cands:
        if c.slot in ("train_step", "eval_step"):
            got: List[Any] = []
            c.run(record=lambda fn: got.append(record(fn)))
            traces.extend(got)
        else:
            traces.append(record(c.run))
    return traces


def _stacked_candidates(spec, ds) -> Tuple[List[Any], RigDims, Any, Any]:
    """A partitioned rig's step programs from its leaves alone: the
    model's whole params and Adam moments, the part-0 tables of its
    resolved route stacked over its parts (the JAX package's layout),
    with its dims, resolved config and layer dims; no ranks."""
    from ..core.partition import partition_plan
    from ..parallel.distributed import shard_dataset
    from ..train.trainer import (compute_dtype_of, initial_params,
                                 layout_options)
    from .programspace import Candidate, resolved_rig_config
    model, cfg = resolved_rig_config(spec, ds, "cpu")
    P = max(spec.parts, 1)
    plan = partition_plan(ds.graph.row_ptr, P)
    d = shard_dataset(ds, plan, 0, "cpu", dtype=compute_dtype_of(cfg),
                      aggr_impl=cfg.aggr_impl, halo=cfg.halo,
                      fuse=model.num_fused_aggregates() > 0,
                      **layout_options(cfg))
    params = initial_params(model, cfg)

    def stack(t):
        return _Leaf((P,) + tuple(int(s) for s in t.shape),
                     dtype_name(t.dtype))

    from ..obs.compile_watch import tree_leaves
    tables = tuple(stack(t) for t in tree_leaves(
        (d.in_degree, d.context_tables())))
    rows = (stack(d.feats), stack(d.labels), stack(d.mask))
    whole = {k: _Leaf(tuple(v.shape), "float32") for k, v in params.items()}
    moments = ({k: v for k, v in whole.items()},
               {k: v for k, v in whole.items()})
    cands = [
        Candidate(slot="dist_train_step",
                  args=(whole, moments) + rows + (tables,),
                  roles=("params", "opt_state", "data", "data", "data",
                         "tables")),
        Candidate(slot="dist_eval_step", args=(whole,) + rows + (tables,),
                  roles=("params", "data", "data", "data", "tables"))]
    dims = dims_of(int(ds.graph.num_nodes), int(ds.num_classes),
                   params.values(), P, plan.part_nodes)
    return cands, dims, cfg, model


def _layer_dims(params, ds) -> List[int]:
    """The plan model's layer dims from the parameter matrices (the JAX
    package's ``_layer_dims_of``)."""
    C, F = int(ds.num_classes), int(ds.in_dim)
    mats = [tuple(int(d) for d in getattr(p, "shape", ()))
            for p in params]
    mats = [m for m in mats if len(m) == 2]
    hiddens = sorted({s[1] for s in mats} - {C, F})
    return [F] + hiddens + [C]


def mesh_shapes(ds, layer_dims: List[int], cfg) -> List[Dict[str, Any]]:
    """The memory model's bytes per rank at every ``(parts, model)``
    shape of eight devices (core/memory.py ``per_axis_plan_bytes``)."""
    from ..core.memory import per_axis_plan_bytes
    shapes = []
    for p, m in candidate_mesh_shapes():
        ax = per_axis_plan_bytes(
            int(ds.graph.num_nodes), int(ds.graph.num_edges), layer_dims,
            parts=p, model=m, halo=getattr(cfg, "halo", "gather"),
            features=getattr(cfg, "features", "hbm"),
            remat=bool(getattr(cfg, "remat", False)))
        shapes.append({"parts": p, "model": m,
                       "per_device_bytes": ax["total"]["per_device"],
                       "components": {
                           k: {"per_device": v["per_device"],
                               "replicated": v.get("replicated", [])}
                           for k, v in ax.items() if k != "total"}})
    return shapes


def audit_rig(name: str, spec, ds, budget: Optional[int],
              select: Optional[List[str]],
              sites: Sequence[Dict[str, Any]] = ()
              ) -> Tuple[List[Finding], Dict[str, Any]]:
    """One rig: its modeled ledger on the canonical mesh and at its own
    shape, the budget and plan-excess checks, the portability report."""
    from .programspace import build_rig_trainer, candidate_programs
    if spec.parts > 1:
        cands, dims, cfg, model = _stacked_candidates(spec, ds)
        from ..train.trainer import modeled_step_bytes
        acts: Dict[Tuple, int] = {}
        plan_bytes = modeled_step_bytes(model, ds, cfg, num_parts=spec.parts)
        params = [leaf for leaf, role in _leaf_roles(cands[0])
                  if role == "params"]
    else:
        tr = build_rig_trainer(spec, ds, "cpu")
        cands = candidate_programs(tr, device_kind=None)
        dims = rig_dims(tr, ds)
        acts = acts_of(_record_candidates(cands), dims)
        cfg = getattr(tr, "config", spec.config())
        plan_bytes = getattr(tr, "modeled_bytes", None)
        from ..obs.compile_watch import tree_leaves
        params = tree_leaves(tr.params)
    entries = union_ledger(
        [ledger_entries(c, dims, CANONICAL_SHAPE) for c in cands]
        + [activation_entries(acts, dims, CANONICAL_SHAPE)])
    measured = replicated_bytes(entries)
    live_shape = (dims.parts_traced, 1)
    live_entries = union_ledger(
        [ledger_entries(c, dims, live_shape) for c in cands]
        + [activation_entries(acts, dims, live_shape)])
    ledger_per_device = sum(e["per_device_bytes"] for e in live_entries)
    findings: List[Finding] = []
    if select is None or "replication-budget" in select:
        findings.extend(check_replication_budget(name, measured, budget))
        findings.extend(check_plan_excess(name, ledger_per_device,
                                          plan_bytes))
    report = {
        "config": name,
        "parts": dims.parts_traced,
        "canonical_shape": list(CANONICAL_SHAPE),
        "replicated_bytes": measured,
        "budget": budget,
        "ledger_per_device_bytes": ledger_per_device,
        "plan_bytes": plan_bytes,
        "ledger": entries[:16],
        "slots": [{"slot": c.slot} for c in cands],
        "sites": list(sites),
        "full_width_sites": len(sites),
        "mesh_shapes": mesh_shapes(ds, _layer_dims(params, ds), cfg),
    }
    if budget is not None:
        report["delta"] = measured - budget
    return findings, report


def live_findings(results: Sequence[Dict[str, Any]],
                  select: Optional[List[str]] = None
                  ) -> Tuple[List[Finding], List[Dict[str, Any]]]:
    """The live rules over the ranks' :func:`rank_sharding` reports of
    :data:`LIVE_RUN`, and the sites as the report renders them."""
    findings: List[Finding] = []
    records: List[Dict[str, Any]] = []
    seen: Set[str] = set()
    for res in results:
        rep = res.get("sharding", {}).get(LIVE_RUN)
        if rep is None:
            continue
        for slot, got in rep["slots"].items():
            sites = [Site(**{**s, "shape": tuple(s["shape"]),
                             "lost": tuple(s["lost"])})
                     for s in got["sites"]]
            fs = findings_from_sites(LIVE_RUN, slot, sites)
            fs += [Finding("donation-under-sharding",
                           f"sharding:{LIVE_RUN}:{slot}", msg, key=key)
                   for key, msg in got["donation"]]
            findings.extend(f for f in fs
                            if select is None or f.rule in select)
            for s in sites:
                if s.key not in seen:
                    seen.add(s.key)
                    records.append({**s.record(candidate_mesh_shapes(),
                                               has_vertex_dim=False),
                                    "slot": slot})
    return findings, records


def audit_sharding(select: Optional[List[str]] = None,
                   replication_budget: Optional[Dict[str, int]] = None,
                   extras: Optional[Dict[str, Any]] = None,
                   results: Sequence[Dict[str, Any]] = ()
                   ) -> List[Finding]:
    """The level: every rig of analysis/programspace.py (no ranks), and
    the live rules over ``results`` (the trace stage's ranks).  One
    ``sharding`` event a rig; with ``extras`` the reports under
    ``extras['sharding']``."""
    from ..obs.events import emit
    from .programspace import build_rig_dataset, rig_configs
    budget = replication_budget or {}
    findings, sites = live_findings(results, select)
    ds = build_rig_dataset()
    for name, spec in rig_configs().items():
        fs, report = audit_rig(name, spec, ds, budget.get(name), select,
                               sites)
        findings.extend(fs)
        emit("sharding",
             f"sharding audit {name}: {report['replicated_bytes']} "
             f"replicated B/step on "
             f"{CANONICAL_SHAPE[0]}x{CANONICAL_SHAPE[1]} (baseline "
             f"{report['budget']}), {report['full_width_sites']} "
             f"full-width site(s) on the live 2x2 mesh", console=False,
             **{k: v for k, v in report.items()
                if k not in ("ledger", "slots", "mesh_shapes", "sites")},
             sites=report["sites"], mesh_shapes=report["mesh_shapes"])
        if extras is not None:
            extras.setdefault("sharding", []).append(report)
    return findings
