"""The program space of the port (``roc_tpu/analysis/programspace.py``):
every program a config runs, enumerated without running it.

In the JAX package a program is an XLA executable, keyed by its slot and
its arguments' avals.  The port compiles no step: its one compiled thing
is the kernel library (kernels/_build.py), and a step's first call pays
the CUDA start of the kernel instances it launches.  So here a program is
**a step slot together with the kernel instances it launches**, an
instance being the kernel, its dtype, F and ``slice_cols``
(``ell_aggregate[bf16]@256/64``; kernels/_build.py ``instance_name``).
Its key is obs/compile_watch.py ``program_key_of``:
``slot|instances|leaf sigs|donate=``, the same function
:class:`~roc_tpu_torch.obs.compile_watch.ObservedStep` applies to what a
slot's first call launched, so the enumeration can be held to a live run.

The instances come from a walk of the resolved op list
(:func:`kernel_instances`): which graph ops the step runs forward (and,
in a train step, backward), on which route, at which width and dtype.
The route follows the resolution of a named device kind
(train/trainer.py ``resolve_config``, the card rows of core/ell.py): by
default the device the enumeration runs on, whose instances on the CPU
are none (the plain versions run); ``device_kind`` names a card, e.g.
the H100's row, on the CPU.

- :class:`RigSpec` and the five rigs of the JAX package
  (:func:`rig_configs`: ``gin_flat8``, ``sgc_stream``, ``sgc_serve``,
  ``sgc_serve_q8``, ``gin_mesh2d``) at its rig sizes; a rig of more ranks
  than the host runs (:func:`host_ranks`) is skipped;
- :class:`Candidate` and :func:`candidate_programs` for a ``Trainer``
  (its streamed head too), a ``DistributedTrainer`` (one rank's slots)
  and a serving ``Predictor`` (its ``serve_candidates``): one list with
  two consumers, the keys here and the warmer (utils/prewarm.py), which
  runs each candidate's step once;
- :func:`enumerate_programs` -> :class:`ProgramSpace`;
- the rules: [compile-explosion] (more programs than the rig's
  ``program_budget`` in roc_tpu_torch/analysis/lint_baseline.json,
  shrink-only) and [cache-key-drift] (two observed slots whose keys
  differ only by dims that snap to the same node or edge multiple,
  core/partition.py ``NODE_MULTIPLE``/``EDGE_MULTIPLE``: an unquantized
  shape leaked past the splitter);
- :func:`audit_program_space`, the level analysis/driver.py runs.

Nothing here imports torch at module level (core/partition.py is numpy);
the rig builds do, lazily.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from ..core.partition import EDGE_MULTIPLE, NODE_MULTIPLE, _round_up
from .findings import Finding

# the rig's scale: the JAX package's synthetic-rig dims, one place
_V, _DEG, _F, _C, _H = 256, 6, 48, 6, 24

# the ranks a CPU host runs for a rig (the port's CPU tests spawn at most
# four gloo ranks); on the card, one rank a card
RIG_CPU_RANKS = 4

PROGRAMSPACE_RULES = ("compile-explosion", "cache-key-drift")


@dataclass(frozen=True)
class ProgramEntry:
    """One program of a config.  ``observed`` marks the slots that run
    through ``ObservedStep`` (the live-parity set); a serve bucket is a
    request shape, counted in the budget but exempt from the drift
    rule."""

    slot: str
    key: str
    leaves: Tuple[Tuple[str, Tuple[int, ...], str], ...]
    observed: bool
    instances: Tuple[str, ...] = ()

    @property
    def digest(self) -> str:
        return hashlib.sha1(self.key.encode()).hexdigest()[:12]


@dataclass
class ProgramSpace:
    """The enumerated programs of one rig config."""

    config: str
    entries: List[ProgramEntry]
    node_multiple: int = NODE_MULTIPLE
    edge_multiple: int = EDGE_MULTIPLE
    resolved: Dict[str, Any] = field(default_factory=dict)
    device_kind: Optional[str] = None

    @property
    def program_count(self) -> int:
        return len(self.entries)

    def observed_keys(self) -> set:
        return {e.key for e in self.entries if e.observed}

    def instances(self) -> List[str]:
        """Every kernel instance the config's programs launch, sorted."""
        return sorted({i for e in self.entries for i in e.instances})

    def report(self, budget: Optional[int] = None) -> Dict[str, Any]:
        """The ``programspace`` event body, the report's row and the
        ``--json`` payload's."""
        rep: Dict[str, Any] = {
            "config": self.config,
            "programs": self.program_count,
            "observed_programs": len(self.observed_keys()),
            "instances": self.instances(),
            "slots": [e.slot for e in self.entries],
            "digests": [e.digest for e in self.entries],
            "device_kind": self.device_kind,
            "budget": budget,
        }
        if budget is not None:
            rep["delta"] = self.program_count - budget
        return rep


@dataclass
class RigSpec:
    """One audited rig: a model factory, a TrainConfig factory and the
    partitions (factories: each build starts from a pristine config).
    ``serve`` names a serving backend instead of a trainer (the rig is
    then a ``Predictor`` of the same resolve pass, whose programs are its
    buckets); ``quant`` its table encoding (serve/quant.py)."""

    name: str
    model: Callable[[], Any]
    config: Callable[[], Any]
    parts: int = 1
    serve: Optional[str] = None
    quant: str = "off"


def _rig_specs() -> Dict[str, RigSpec]:
    """The JAX package's five rigs, its configurations in the port's
    names ('segment' where the JAX config takes its default route)."""
    from ..models.gin import build_gin
    from ..models.sgc import build_sgc
    from ..train.trainer import TrainConfig, resolve_dtypes

    f32, bf16 = resolve_dtypes("mixed")
    return {
        # GIN on the flat-sum layout on two partitions: the quantized
        # partition shapes are in its keys
        "gin_flat8": RigSpec(
            name="gin_flat8",
            model=lambda: build_gin([_F, _H, _C], dropout_rate=0.5),
            config=lambda: TrainConfig(
                verbose=False, symmetric=True, aggr_impl="flat_sum",
                dtype=f32, compute_dtype=bf16),
            parts=2),
        # SGC with host-streamed features (the propagation prefix runs at
        # build; the step is the streamed head and the tail)
        "sgc_stream": RigSpec(
            name="sgc_stream",
            model=lambda: build_sgc([_F, _C], k=2, dropout_rate=0.5),
            config=lambda: TrainConfig(
                verbose=False, symmetric=True, features="host",
                aggr_impl="segment", dtype=f32, compute_dtype=bf16),
            parts=1),
        # the serving tier: the SGC precomputed predictor, one program a
        # bucket
        "sgc_serve": RigSpec(
            name="sgc_serve",
            model=lambda: build_sgc([_F, _C], k=2, dropout_rate=0.5),
            config=lambda: TrainConfig(
                verbose=False, symmetric=True, aggr_impl="segment",
                dtype=f32),
            parts=1, serve="precomputed"),
        # the same under int8 tables: other args, other programs
        "sgc_serve_q8": RigSpec(
            name="sgc_serve_q8",
            model=lambda: build_sgc([_F, _C], k=2, dropout_rate=0.5),
            config=lambda: TrainConfig(
                verbose=False, symmetric=True, aggr_impl="segment",
                dtype=f32),
            parts=1, serve="precomputed", quant="int8"),
        # gin_flat8 on the (parts, model) mesh 2x4: eight ranks
        "gin_mesh2d": RigSpec(
            name="gin_mesh2d",
            model=lambda: build_gin([_F, _H, _C], dropout_rate=0.5),
            config=lambda: TrainConfig(
                verbose=False, symmetric=True, aggr_impl="flat_sum",
                mesh="2x4", dtype=f32, compute_dtype=bf16),
            parts=2),
    }


RIG_CONFIGS: Dict[str, RigSpec] = {}


def rig_configs() -> Dict[str, RigSpec]:
    """Built at first use, so importing this module imports no torch."""
    if not RIG_CONFIGS:
        RIG_CONFIGS.update(_rig_specs())
    return RIG_CONFIGS


def rig_required_devices(spec: RigSpec) -> int:
    """The ranks ``spec`` runs: ``parts * model`` of its mesh
    (train/trainer.py ``resolve_mesh``)."""
    from ..train.trainer import resolve_mesh
    parts = max(spec.parts, 1)
    _, model = resolve_mesh(spec.config(), num_parts=parts)
    return parts * model


def host_ranks(device="cpu") -> int:
    """The ranks this host runs for a rig on ``device``: one a card on
    the card (NCCL takes one rank a card), :data:`RIG_CPU_RANKS` on the
    CPU."""
    from ..train.trainer import resolve_device
    from ..utils.prewarm import cuda_device_count
    if resolve_device(device).type == "cuda":
        return cuda_device_count()
    return RIG_CPU_RANKS


def build_rig_dataset():
    from ..core.graph import synthetic_dataset
    return synthetic_dataset(num_nodes=_V, avg_degree=_DEG, in_dim=_F,
                             num_classes=_C, seed=0)


def resolved_rig_config(spec: RigSpec, dataset, device="cpu",
                        device_kind: Optional[str] = None):
    """``(model, config)`` of ``spec`` through the trainers' resolve pass,
    the routes of ``device_kind`` (None: the kind of ``device``)."""
    from ..train.trainer import resolve_config
    return resolve_config(spec.model(), dataset, spec.config(),
                          device=device, num_parts=max(spec.parts, 1),
                          device_kind=device_kind)


def build_rig_trainer(spec: RigSpec, dataset=None, device="cpu",
                      device_kind: Optional[str] = None, group=None):
    """The trainer (or, for a serve rig, the Predictor) a run of ``spec``
    builds on ``device``, its config resolved for ``device_kind`` first.
    A partitioned rig is one rank's ``DistributedTrainer``: the caller
    is a rank of a process group of the rig's ranks (``group``, None the
    default)."""
    ds = dataset if dataset is not None else build_rig_dataset()
    model, cfg = resolved_rig_config(spec, ds, device, device_kind)
    if spec.serve:
        from ..serve.export import build_predictor
        return build_predictor(model, ds, cfg, backend=spec.serve,
                               quant=spec.quant, device=device)
    if spec.parts > 1:
        from ..parallel.distributed import DistributedTrainer
        return DistributedTrainer(model, ds, spec.parts, cfg,
                                  device=device, group=group)
    from ..train.trainer import Trainer
    return Trainer(model, ds, cfg, device=device)


def _assert_resolve_idempotent(spec: RigSpec, dataset, device="cpu",
                               device_kind: Optional[str] = None) -> None:
    """Re-resolving a resolved config changes nothing, so the enumerated
    set does not depend on how often the pass ran."""
    from ..train.trainer import resolve_config
    model1, cfg1 = resolved_rig_config(spec, dataset, device, device_kind)
    model2, cfg2 = resolve_config(model1, dataset, cfg1, device=device,
                                  num_parts=max(spec.parts, 1),
                                  device_kind=device_kind)
    if cfg1 != cfg2:
        raise AssertionError(f"resolve_config is not idempotent for rig "
                             f"{spec.name!r}: {cfg1} != {cfg2}")
    if model2 is not model1:
        raise AssertionError(f"resolve_config re-rewrote an already-"
                             f"resolved model for rig {spec.name!r}")


# ------------------------------------------------------ kernel instances

_PARAM_KINDS = ("linear", "gat", "scale_add")


def kernel_instances(model, aggr_impl: str, halo: str, compute_dtype,
                     train: bool, device_kind: Optional[str],
                     input_grad: bool = False) -> Tuple[str, ...]:
    """The kernel instances one step of ``model``'s op list launches on a
    card of ``device_kind`` (none for None, the CPU): forward, and with
    ``train`` the backward of every graph op whose input carries a
    gradient (``input_grad``: the model's input does, the streamed
    tail's).  Per graph op (models/builder.py ``GraphContext``):

    - a SUM or AVG ``scatter_gather``: the route's sum, forward and (its
      symmetric backward) on the cotangent: K4 ``ell_aggregate`` on
      'cuda', K3's pre-pass ``csr_row_ptr`` and K3 ``csr_spmm`` on
      'cuda_csr', K3 at each hop on the ring halo of either;
    - a ``fused_aggregate``: K1 ``indegree_norm``, the sum, K2
      ``scale_act``; its backward the same with the masked K1 after a
      relu;
    - MAX, MIN, attention and every other route: no kernel.

    Each at the op's width F in the compute dtype, the sums at the
    wrappers' default ``slice_cols`` for (F, dtype)."""
    if device_kind is None or aggr_impl not in ("cuda", "cuda_csr"):
        return ()
    from ..kernels import _build, ell_spmm, spmm
    ops = model._ops
    grad = [False] * len(ops)
    grad[0] = bool(train and input_grad)
    out = set()

    def name(kernel, F):
        S = 0
        if kernel == "ell_aggregate":
            S = ell_spmm.default_slice_cols(F, compute_dtype)
        elif kernel == "csr_spmm":
            S = spmm.default_slice_cols(F, compute_dtype)
        return _build.instance_name(kernel, compute_dtype, F, S)

    def sums(F):
        if halo == "ring":
            return {name("csr_spmm", F)}
        if aggr_impl == "cuda":
            return {name("ell_aggregate", F)}
        return {"csr_row_ptr", name("csr_spmm", F)}

    for i, op in enumerate(ops[1:], start=1):
        grad[i] = bool(train and (any(grad[j] for j in op.inputs)
                                  or op.kind in _PARAM_KINDS))
        if not op.inputs:
            continue
        F = ops[op.inputs[0]].dim
        back = train and grad[op.inputs[0]]
        if op.kind == "scatter_gather" and \
                op.attrs.get("aggr", "sum") in ("sum", "avg"):
            out |= sums(F)
        elif op.kind == "fused_aggregate":
            out |= sums(F) | {name("indegree_norm", F),
                              name("scale_act", F)}
            if back:
                relu = op.attrs.get("activation", "none") == "relu"
                out.add(name("indegree_norm_masked" if relu
                              else "indegree_norm", F))
    return tuple(sorted(out))


def step_instances(tr, slot: str,
                   device_kind: Optional[str] = None) -> Tuple[str, ...]:
    """:func:`kernel_instances` of a trainer's step slot ('train_step',
    'eval_step') on ``device_kind``: the streamed tail's op list under
    ``features='host'`` (the head is a plain product)."""
    from ..train.trainer import compute_dtype_of
    streamed = getattr(tr, "_head", None) is not None
    model = tr._tail_model if streamed else tr.model
    cfg = tr.config
    return kernel_instances(model, tr.gctx.aggr_impl, cfg.halo,
                            compute_dtype_of(cfg), slot == "train_step",
                            device_kind, input_grad=streamed)


@dataclass
class Candidate:
    """One program of a trainer's or a predictor's lifecycle: its slot,
    the tensors it reads (``args``, what its key renders), the positions
    it rewrites (``donate``), the kernel instances it launches
    (``instances``, :func:`kernel_instances`) and ``run``, which runs the
    step once at its real shapes and leaves the trainer as it was
    (utils/prewarm.py drives it; a trainer's takes ``record=``, which
    runs the step's device work, utils/prewarm.py
    ``run_step_restoring``).  ``roles``: a label per argument for the
    sharding ledger (analysis/sharding_lint.py: 'params', 'opt_state',
    'data', 'tables', 'stream', 'other'; the JAX package's).  One
    extraction, three consumers: the keys here, the warmer and the
    ledger, so the enumerated, the warmed and the audited sets cannot
    drift."""

    slot: str
    args: tuple
    donate: Tuple[int, ...] = ()
    observed: bool = True
    instances: Tuple[str, ...] = ()
    run: Optional[Callable[..., Any]] = None
    roles: Tuple[str, ...] = ()

    @property
    def key(self) -> str:
        from ..obs.compile_watch import program_key_of
        return program_key_of(self.slot, self.instances, self.args,
                              self.donate)


def candidate_programs(tr, device_kind: Optional[str] = None
                       ) -> List[Candidate]:
    """The programs of a trainer's train + eval lifecycle
    (``run_epoch_loop``; ``predict`` runs the eval forward), or of a
    predictor's buckets.  ``device_kind``: whose instances (default: the
    kind of the device ``tr`` is on; the CPU's are none)."""
    if device_kind is None:
        from ..train.trainer import card_kind
        device_kind = card_kind(tr.device)
    if hasattr(tr, "serve_candidates"):
        return list(tr.serve_candidates(device_kind=device_kind))
    from ..train.trainer import STEP_DONATE
    from ..utils.prewarm import run_step_restoring
    cands = []
    rows = ("data", "data", "data", "tables")
    for slot, roles in (("train_step", ("params", "opt_state") + rows),
                        ("eval_step", ("params",) + rows)):
        cands.append(Candidate(
            slot=slot, args=tr.step_args(slot), donate=STEP_DONATE[slot],
            instances=step_instances(tr, slot, device_kind),
            run=(lambda record=None, s=slot:
                 run_step_restoring(tr, s, record)),
            roles=roles))
    return cands


def _entry(c: Candidate) -> ProgramEntry:
    from ..obs.compile_watch import leaf_struct, tree_leaves
    return ProgramEntry(slot=c.slot, key=c.key,
                        leaves=tuple(leaf_struct(v)
                                     for v in tree_leaves(c.args)),
                        observed=c.observed, instances=tuple(c.instances))


def resolved_of(spec: RigSpec, tr) -> Dict[str, Any]:
    """The resolved fields the JAX package's enumeration records."""
    cfg = tr.config
    return {"aggr_impl": cfg.aggr_impl, "halo": cfg.halo,
            "features": cfg.features, "remat": cfg.remat,
            "partition": cfg.partition, "parts": spec.parts}


def space_of(spec: RigSpec, tr, device_kind: Optional[str],
             cands: Optional[Sequence[Candidate]] = None) -> ProgramSpace:
    """The :class:`ProgramSpace` of a built rig (``cands``: its
    candidates, enumerated already)."""
    if cands is None:
        cands = candidate_programs(tr, device_kind)
    nm, em = NODE_MULTIPLE, EDGE_MULTIPLE
    plan = getattr(tr, "plan", None)
    if spec.parts > 1 and plan is not None:
        nm = getattr(plan, "node_multiple", nm)
        em = getattr(plan, "edge_multiple", em)
    space = ProgramSpace(config=spec.name,
                         entries=[_entry(c) for c in cands],
                         node_multiple=nm, edge_multiple=em,
                         resolved=resolved_of(spec, tr),
                         device_kind=device_kind)
    _check_distinct(space)
    return space


def enumerate_programs(spec: RigSpec, dataset=None, trainer=None,
                       device="cpu", device_kind: Optional[str] = None
                       ) -> ProgramSpace:
    """The programs a train + eval (or serve) lifecycle of ``spec``
    runs, on ``device`` with the routes and instances of ``device_kind``
    (None: ``device``'s).  A partitioned rig needs the caller to be one
    of its ranks (its keys are the rank's; the quantized plan shapes make
    them every rank's)."""
    from ..train.trainer import card_kind, resolve_device
    device = resolve_device(device)
    if device_kind is None:
        device_kind = card_kind(device)
    ds = dataset if dataset is not None else build_rig_dataset()
    _assert_resolve_idempotent(spec, ds, device, device_kind)
    tr = trainer if trainer is not None else build_rig_trainer(
        spec, ds, device, device_kind)
    return space_of(spec, tr, device_kind)


def _check_distinct(space: ProgramSpace) -> None:
    keys = [e.key for e in space.entries]
    if len(set(keys)) != len(keys):
        dup = sorted(k for k in set(keys) if keys.count(k) > 1)
        raise AssertionError(
            f"program-space enumeration for {space.config!r} produced "
            f"duplicate keys: {dup[:2]} — two slots would run the same "
            f"program; the enumeration (or a slot) is wrong")


# --------------------------------------------------------------- rules

def check_compile_explosion(space: ProgramSpace,
                            budget: Optional[int]) -> List[Finding]:
    """[compile-explosion] more programs than the baselined bound
    (``program_budget``, shrink-only); None: no bound recorded yet."""
    if budget is None or space.program_count <= budget:
        return []
    return [Finding(
        "compile-explosion", f"programspace:{space.config}",
        f"{space.program_count} distinct programs exceed the baselined "
        f"bound {budget} ({len(space.instances())} kernel instances) — a "
        f"new step slot or kernel instance entered this config; "
        f"consolidate it or ratchet deliberately by hand-editing "
        f"program_budget",
        key="over-budget",
        detail={"programs": space.program_count, "budget": budget,
                "slots": [e.slot for e in space.entries]})]


def _drift_dims(a: ProgramEntry, b: ProgramEntry, nm: int,
                em: int) -> Optional[List[Tuple[int, int]]]:
    """The differing dims when ``a`` and ``b`` differ ONLY by dims that
    snap to the same node or edge multiple; None when they differ
    structurally or not at all."""
    if len(a.leaves) != len(b.leaves):
        return None
    diffs: List[Tuple[int, int]] = []
    for (d1, s1, sp1), (d2, s2, sp2) in zip(a.leaves, b.leaves):
        if d1 != d2 or sp1 != sp2 or len(s1) != len(s2):
            return None
        for x, y in zip(s1, s2):
            if x == y:
                continue
            node_tie = _round_up(x, nm) == _round_up(y, nm)
            # two dims already on the node grid in one edge window are
            # no leak: nothing is left to quantize
            edge_tie = (_round_up(x, em) == _round_up(y, em)
                        and not (x % nm == 0 and y % nm == 0))
            if node_tie or edge_tie:
                diffs.append((x, y))
            else:
                return None
    return diffs or None


def check_cache_key_drift(space: ProgramSpace) -> List[Finding]:
    """[cache-key-drift] see the module docstring; the unobserved
    programs (serve buckets, request shapes) are exempt."""
    out: List[Finding] = []
    es = [e for e in space.entries if e.observed]
    for i in range(len(es)):
        for j in range(i + 1, len(es)):
            diffs = _drift_dims(es[i], es[j], space.node_multiple,
                                space.edge_multiple)
            if diffs is None:
                continue
            ex = ", ".join(f"{x} vs {y}" for x, y in diffs[:3])
            out.append(Finding(
                "cache-key-drift", f"programspace:{space.config}",
                f"program keys of {es[i].slot!r} and {es[j].slot!r} "
                f"differ only by unquantized dimensions ({ex}) that snap "
                f"to the same node/edge multiple ({space.node_multiple}/"
                f"{space.edge_multiple}) — an unquantized shape leaked "
                f"into one slot; route it through core/partition.py "
                f"quantize_plan_shapes",
                key=f"drift|{es[i].slot}|{es[j].slot}"))
    return out


# --------------------------------------------------------------- stage

def hosted_rigs(device="cpu") -> List[str]:
    """The rig names whose ranks the host runs on ``device``
    (:func:`host_ranks`)."""
    cap = host_ranks(device)
    return [name for name, spec in rig_configs().items()
            if rig_required_devices(spec) <= cap]


def audit_program_space(select: Optional[List[str]] = None,
                        program_budget: Optional[Dict[str, int]] = None,
                        extras: Optional[Dict[str, Any]] = None,
                        spaces: Sequence[ProgramSpace] = (),
                        device="cpu", device_kind: Optional[str] = None
                        ) -> List[Finding]:
    """The level over every rig the host runs: the single-rank rigs built
    here, the partitioned ones' ``spaces`` as their ranks enumerated them
    (analysis/driver.py runs the ranks).  One ``programspace`` event a
    rig; with ``extras`` the report records (with the keys) under
    ``extras['programspace']``."""
    from ..obs.events import emit
    ds = build_rig_dataset()
    got = [enumerate_programs(rig_configs()[n], dataset=ds, device=device,
                              device_kind=device_kind)
           for n in hosted_rigs(device) if rig_configs()[n].parts == 1]
    got += list(spaces)
    order = list(rig_configs())
    got.sort(key=lambda sp: order.index(sp.config))
    budget = program_budget or {}
    findings: List[Finding] = []
    for space in got:
        rep = space.report(budget=budget.get(space.config))
        rep["keys"] = [e.key for e in space.entries]
        emit("programspace",
             f"program space {space.config}: {rep['programs']} programs, "
             f"{len(rep['instances'])} kernel instances (baseline "
             f"{rep['budget']})", console=False,
             **{k: v for k, v in rep.items() if k != "keys"})
        if extras is not None:
            extras.setdefault("programspace", []).append(rep)
        if select is None or "compile-explosion" in select:
            findings.extend(check_compile_explosion(
                space, budget.get(space.config)))
        if select is None or "cache-key-drift" in select:
            findings.extend(check_cache_key_drift(space))
    return findings
