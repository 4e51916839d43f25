"""Single-device training (``roc_tpu/train/trainer.py``): the config, the
fuse rule, the graph context, :class:`Trainer` and the reference's epoch
loop (``gnn.cc:99-111``): per epoch staircase lr decay, forward,
backward, Adam update; every ``eval_every`` epochs an inference pass
printing train loss and train/val/test accuracy in the reference's
format (``softmax_kernel.cu:141-152``).

The memory tier is the JAX package's single-device one: features on the
device ('hbm') or in host memory, streamed through the first layer
(``features='host'``, core/streaming.py ``StreamedHead``; the SGC shape
first runs its propagation prefix with every stage on the host),
rematerialisation (``remat``, ``remat_policy``), and the memory autopilot
(``memory='auto'``, core/memory.py) that picks among them by the
device's memory.  The ``(parts, model)`` mesh is the partitioned
trainer's (``TrainConfig.mesh``, parallel/distributed.py), one device
taking 'auto' and '1x1' only.  The epoch loop carries the resilience
hooks (resilience/inject.py drill sites, the first step's heartbeat, the
preemption check) and the run telemetry: the profiler trace
(``profile_dir``), the metrics log (``metrics_path``), the loop's
metrics registry, the span laps flushed as ``timeline`` events, and the
throughput fields from the first-step observer's FLOP count
(obs/compile_watch.py); the trainer emits the run manifest
(obs/manifest.py) and carries the state a checkpoint needs besides
weights and Adam state (utils/checkpoint.py): the dataset's identity and
the dropout generator's state.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import time
import weakref
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.ell import (CARD_ROWS, FLAT_SUM_MIN_EDGES, JAX_ROUTE,
                        default_section_rows, ell_from_graph,
                        flat_sum_from_graph, jax_auto_impl,
                        port_attention_route, port_route,
                        sectioned_from_graph)
from ..core.graph import Dataset, check_symmetric
from ..core.partition import padded_edge_list
from ..models.builder import (AGGR_IMPLS, AGGREGATE_KINDS, EDGE_IMPLS,
                              ELL_IMPLS, KERNEL_IMPLS, REMAT_POLICIES,
                              GraphContext, Model)
from ..obs.events import emit
from ..ops.loss import perf_metrics, summarize_metrics
from ..ops import blockdense as bd
from ..ops.norm import inv_sqrt_degree, inv_sqrt_degree_np
from .optimizer import AdamConfig, adam_init, adam_update, decayed_lr


@dataclass
class TrainConfig:
    """The ported subset of the JAX package's ``TrainConfig`` (the
    reference's ``Config`` struct and CLI defaults, ``gnn.h:105-113``,
    ``gnn.cc:30-41``).

    aggr_impl: 'cuda' (the hand-written ELL kernels, the JAX package's
      'pallas'), 'cuda_csr' (the hand-written CSR kernel K3, its
      'pallas_csr'), the plain 'ell' / 'segment', the chunked edge-list
      sums 'blocked' / 'scan', the large-graph
      layouts 'sectioned' / 'flat_sum' / 'bdense' (and 'attn_flat8',
      which the resolver gives attention models), or 'auto'
      (:func:`resolve_auto_impl_probed`).
    chunk: edge-list padding multiple of the edge routes.
    aggr_fuse: 'auto' | 'on' | 'off', see :func:`resolve_fuse`.
    symmetric: None = check the graph; False differentiates the plain
      routes exactly and is refused by the kernel routes.
    dropout_rate: recorded for the CLI; the model carries its own rate.
    dtype: the params' and Adam state's dtype (fp32 master weights in
      the mixed mode); compute_dtype: when set (bf16, the mixed mode),
      features, activations and the aggregation run in it while params
      stay in ``dtype`` and are cast inside the step (gradients flow
      back through the cast as fp32; the loss is reduced in fp32,
      ops/loss.py; no loss scaling).  :func:`resolve_dtypes` maps the
      mode names to the two fields.
    async_save: 'auto' | 'on' | 'off' (or a bool), the recovery
      rotation's saver mode, see :func:`resolve_async_save`.
    fault: one drill fault to arm, ``site:epoch[:proc]``
      (resilience/inject.py); None arms none (``ROC_TPU_FAULT`` is the
      out-of-band switch).
    sect_sub_w, sect_u16: the sectioned tables' sub-row width and uint16
      ids (sections then hold 65,535 rows); bdense_min_fill,
      bdense_a_budget, bdense_group: the block-dense plan's least edges
      a dense tile, A-table byte cap (None: none) and blocks a product
      (ops/blockdense.py).  The JAX package's fields and defaults.
    The memory policy (core/memory.py), the JAX package's fields and
    defaults:
    features: 'hbm' keeps the input features on the device; 'host' keeps
      them in host memory and streams the first layer (dropout ->
      linear), forward and weight gradient, through the device in row
      blocks (core/streaming.py ``StreamedHead``); it needs a streamable
      head (``Model.streamable_head`` or ``streamable_agg_head``).
    prefetch: the staging pool's depth under ``features='host'``
      (:func:`resolve_prefetch`): 'auto' is 1, double-buffered; 0 stages
      synchronously (the same bits).
    remat: recompute activations in the backward instead of saving them;
      remat_policy: 'save_aggregates' keeps the graph ops' outputs and
      recomputes the dense ops between them, 'full' recomputes
      everything (:func:`remat_policy`).
    memory: 'manual' takes halo/features/remat as given; 'auto' runs
      :func:`apply_memory_autopilot` and takes the first plan that fits
      ``hbm_bytes`` (None: the device's memory,
      core/memory.py ``detect_hbm_bytes``).
    The partitioned trainer's fields (parallel/distributed.py), the JAX
    package's:
    halo: 'gather' (every rank all-gathers every part's rows before each
      aggregation) or 'ring' (parallel/ring.py: one part's rows rotate
      around the ranks, O(V/P) rows held); one part runs 'gather'.
    ring_overlap: the ring's transfer runs under the hop's sum (the same
      bits either way).
    partition: 'greedy' (the reference's edge sweep), 'cost' (the
      cost-balanced minimax split, core/costmodel.py) or 'auto', which is
      'cost' (:func:`resolve_partition`).
    rebalance: at each eval, refit the cost model to the measured epoch
      time and repartition when the predicted gain of the largest part's
      cost passes ``rebalance_gain``, at most ``rebalance_max`` times a
      run (full-batch training does not depend on the split).
    mesh: 'auto' (every rank on the parts axis, the 1-D run) or 'PxM'
      (:func:`resolve_mesh`): the ``(parts, model)`` mesh of P * M ranks,
      where each part's M model ranks keep the params and Adam moments
      sharded at rest (parallel/distributed.py ``DistributedTrainer``).
      The single-device :class:`Trainer` takes 'auto' and '1x1' only.
    head_chunk: the classification head's row block
      (:func:`resolve_head_chunk`): 'auto' takes ``HEAD_CHUNK_ROWS`` once
      the trainer's rows (a part's on a partitioned run) reach
      ``HEAD_CHUNK_AUTO_MIN_ROWS``, an int >= 0 is the block (0: one
      product).  The same values either way up to fp32 rounding of the
      weight gradient (ops/dense.py ``linear_chunked``).
    Telemetry (utils/profiling.py), the JAX package's fields:
    profile_dir: a profiler trace of every ``train()`` call into this
      directory, with the loop's phases as named ranges (None: off).
    metrics_path: the eval records appended here as JSONL (None: kept in
      memory only, ``Trainer.metrics_log``).
    """
    learning_rate: float = 0.01
    weight_decay: float = 0.05
    dropout_rate: float = 0.5
    decay_rate: float = 1.0
    decay_steps: int = 100
    epochs: int = 200
    seed: int = 1
    eval_every: int = 5
    verbose: bool = True
    aggr_impl: str = "cuda"
    chunk: int = 512
    aggr_fuse: str = "auto"
    symmetric: Optional[bool] = None
    dtype: torch.dtype = torch.float32
    compute_dtype: Optional[torch.dtype] = None
    async_save: Any = "auto"
    fault: Optional[str] = None
    sect_sub_w: int = 8
    sect_u16: bool = False
    bdense_min_fill: int = 64
    bdense_a_budget: Optional[int] = 2 << 30
    bdense_group: int = 1
    remat: bool = False
    remat_policy: str = "save_aggregates"
    features: str = "hbm"
    memory: str = "manual"
    hbm_bytes: Optional[int] = None
    prefetch: Any = "auto"
    halo: str = "gather"
    ring_overlap: bool = True
    partition: str = "auto"
    rebalance: bool = False
    rebalance_gain: float = 0.10
    rebalance_max: int = 2
    mesh: Any = "auto"
    head_chunk: Any = "auto"
    profile_dir: Optional[str] = None
    metrics_path: Optional[str] = None


# the TrainConfig fields that shape the layouts' tables
LAYOUT_FIELDS = ("sect_sub_w", "sect_u16", "bdense_min_fill",
                 "bdense_a_budget", "bdense_group")


def layout_options(config: TrainConfig) -> Dict[str, Any]:
    """The layout fields of ``config``, as :func:`make_graph_context`
    takes them: a trainer and a predictor of one config build the same
    tables."""
    return {k: getattr(config, k) for k in LAYOUT_FIELDS}


def resolve_async_save(config: TrainConfig) -> bool:
    """``TrainConfig.async_save`` -> the saver mode of the recovery
    rotation (the CLI's ``--async-save`` goes through this too).  'auto'
    is on for a world of one and off otherwise, as in the JAX package
    (rank 0 alone writes, so async would be safe with more ranks, but the
    choice follows the reference); 'on'/'off' and bools are literal."""
    v = config.async_save
    if isinstance(v, bool):
        return v
    if v == "on":
        return True
    if v == "off":
        return False
    if v == "auto":
        import torch.distributed as dist
        return not (dist.is_available() and dist.is_initialized()
                    and dist.get_world_size() > 1)
    raise ValueError(f"unknown async_save {v!r}; expected 'auto', "
                     "'on', or 'off'")


def resolve_partition(config: TrainConfig) -> str:
    """``TrainConfig.partition`` -> the split method: 'auto' is 'cost'
    (its cold-start weights are the quantized edge-balance prior, so the
    searched split is never worse than the greedy sweep under the model),
    as in the JAX package; unknown values raise.  The CLI's
    ``--partition`` goes through this too."""
    p = config.partition
    if p == "auto":
        return "cost"
    if p in ("greedy", "cost"):
        return p
    raise ValueError(f"unknown partition {p!r}; expected 'greedy', "
                     "'cost', or 'auto'")


def resolve_mesh(config: TrainConfig, num_parts: Optional[int] = None,
                 num_devices: Optional[int] = None) -> Tuple[int, int]:
    """``TrainConfig.mesh`` -> the ``(parts, model)`` shape, the JAX
    package's vocabulary and checks: 'auto' (or None) is ``(num_parts or
    1, 1)``; 'PxM' names both axes; a ``(p, m)`` pair is taken as it is.
    An explicit P must equal ``num_parts`` when given (the parts axis is
    the partition count), and ``p * m`` must fit ``num_devices`` (here
    the ranks) when given.  The CLI's ``--mesh`` goes through this too."""
    v = config.mesh
    if v in (None, "auto"):
        p, m = (int(num_parts) if num_parts else 1), 1
    else:
        if isinstance(v, str):
            try:
                ps, ms = v.lower().split("x")
                p, m = int(ps), int(ms)
            except ValueError:
                raise ValueError(
                    f"unknown mesh {v!r}; expected 'auto' or 'PxM' "
                    "(e.g. '2x4')") from None
        else:
            try:
                p, m = (int(v[0]), int(v[1]))
            except (TypeError, ValueError, IndexError):
                raise ValueError(
                    f"unknown mesh {v!r}; expected 'auto', 'PxM', or "
                    "a (parts, model) pair") from None
        if p < 1 or m < 1:
            raise ValueError(f"mesh axes must be >= 1, got {p}x{m}")
        if num_parts is not None and p != int(num_parts):
            raise ValueError(
                f"mesh {p}x{m} names {p} parts but the trainer was "
                f"built with {num_parts} partitions — the parts axis "
                "IS the partition count")
    if num_devices is not None and p * m > int(num_devices):
        raise ValueError(
            f"mesh {p}x{m} needs {p * m} devices, have {num_devices}")
    return p, m


def resolve_prefetch(config: TrainConfig) -> int:
    """``TrainConfig.prefetch`` -> the staging pool's depth: 'auto' is 1
    (double-buffered: one block ahead hides the host copy and the copy
    issue, and deeper pools only add live buffers); an int >= 0 is taken
    as it is (0 stages synchronously).  The CLI's ``--prefetch`` goes
    through this too."""
    p = config.prefetch
    if p == "auto":
        return 1
    try:
        depth = int(p)
    except (TypeError, ValueError):
        raise ValueError(f"unknown prefetch {p!r}; expected 'auto' or "
                         "an int >= 0") from None
    if depth < 0:
        raise ValueError(f"prefetch must be >= 0, got {depth}")
    return depth


# The chunked head's block, the streamed head's staging block
# (core/streaming.py), and the rows from which 'auto' chunks: the JAX
# package's constants.
HEAD_CHUNK_ROWS = 65_536
HEAD_CHUNK_AUTO_MIN_ROWS = 262_144


def resolve_head_chunk(config: TrainConfig, num_rows: int) -> int:
    """``TrainConfig.head_chunk`` -> the row block the graph context
    carries (0: unchunked), the JAX package's rule (the CLI's
    ``--head-chunk`` goes through this too): 'auto' is
    :data:`HEAD_CHUNK_ROWS` from :data:`HEAD_CHUNK_AUTO_MIN_ROWS` rows
    on, else 0; an int >= 0 is taken as it is, and a block of
    ``num_rows`` or more is 0 (one block is the plain product)."""
    hc = config.head_chunk
    if hc == "auto":
        return (HEAD_CHUNK_ROWS
                if num_rows >= HEAD_CHUNK_AUTO_MIN_ROWS else 0)
    try:
        block = int(hc)
    except (TypeError, ValueError):
        raise ValueError(f"unknown head_chunk {hc!r}; expected 'auto' "
                         "or an int >= 0") from None
    if block < 0:
        raise ValueError(f"head_chunk must be >= 0, got {block}")
    return 0 if block >= num_rows else block


def remat_policy(config: TrainConfig) -> Optional[str]:
    """The ``remat`` argument of ``Model.apply`` for ``config``: None
    without remat, else ``config.remat_policy`` ('save_aggregates' or
    'full').  An unknown policy raises: a typo must not change the
    memory footprint silently."""
    if config.remat_policy not in REMAT_POLICIES:
        raise ValueError(f"unknown remat_policy {config.remat_policy!r}; "
                         f"expected one of {REMAT_POLICIES}")
    return config.remat_policy if config.remat else None


def model_layer_dims(model: Model) -> List[int]:
    """The CLI-style layer spec (in-dim, the linear ops' out-dims) of a
    built model: the shapes core/memory.py's estimate speaks."""
    return [model._ops[0].dim] + [op.dim for op in model._ops
                                  if op.kind == "linear"]


def _dtype_bytes(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def modeled_step_bytes(model: Model, dataset: Dataset, config: TrainConfig,
                       num_parts: int = 1) -> int:
    """The memory model's peak estimate for the resolved ``config``
    (core/memory.py ``estimate_plan_bytes``), for manual configs too:
    chip_smoke.py prints it beside the card's measured peak."""
    from ..core.memory import charged_table_bytes, estimate_plan_bytes
    a_tab = charged_table_bytes(
        config.aggr_impl, model.uses_attention(),
        model.uses_max_aggregation(), config.bdense_a_budget)
    return estimate_plan_bytes(
        dataset.graph.num_nodes, dataset.graph.num_edges,
        model_layer_dims(model), num_parts=num_parts,
        dtype_bytes=_dtype_bytes(compute_dtype_of(config)),
        halo=config.halo if num_parts > 1 else "gather",
        features=config.features, remat=config.remat,
        remat_policy=config.remat_policy, extra_table_bytes=a_tab)


def apply_memory_autopilot(model: Model, dataset: Dataset,
                           config: TrainConfig, num_parts: int = 1,
                           device=None) -> TrainConfig:
    """``memory='auto'`` resolved into concrete halo/features/remat by
    core/memory.py ``choose_memory_plan`` over the dataset's and model's
    shapes, with the budget ``hbm_bytes`` or the memory of ``device``;
    the decision is a ``plan`` event (on the console when verbose, or
    when no plan fits).  The ring plans come in at parts > 1, as in the
    JAX package; one part keeps the configured halo.  A no-op for
    ``memory='manual'``.  Runs after 'auto' is resolved, so a
    block-dense route's A-table is charged."""
    if config.memory != "auto":
        return config
    from ..core.memory import charged_table_bytes, choose_memory_plan
    a_tab = charged_table_bytes(
        config.aggr_impl, model.uses_attention(),
        model.uses_max_aggregation(), config.bdense_a_budget)
    plan = choose_memory_plan(
        dataset.graph.num_nodes, dataset.graph.num_edges,
        model_layer_dims(model), num_parts=num_parts,
        dtype_bytes=_dtype_bytes(compute_dtype_of(config)),
        hbm_bytes=config.hbm_bytes,
        head_streamable=(model.streamable_head() is not None
                         or model.streamable_agg_head() is not None),
        remat_policy=config.remat_policy, extra_table_bytes=a_tab,
        device=device)
    # the estimate is the JAX package's model; under remat the card's
    # peak has come out above it (PERF.md §7), so say so
    note = ("; remat: an estimate, not a bound on the peak"
            if plan.remat else "")
    emit("plan", plan.echo() + note,
         console=config.verbose or not plan.fits,
         halo=plan.halo, features=plan.features, remat=plan.remat,
         fits=plan.fits, est_bytes=plan.est_bytes,
         budget_bytes=plan.budget_bytes, candidates=plan.candidates)
    return dataclasses.replace(
        config, memory="manual", features=plan.features, remat=plan.remat,
        halo=plan.halo if num_parts > 1 else config.halo)


def derived_seed(*words: int) -> int:
    """A 63-bit seed drawn from ``SeedSequence(words)``: the same words
    give the same seed in every process."""
    return int(np.random.SeedSequence(tuple(int(w) for w in words))
               .generate_state(1, np.uint64)[0] >> 1)


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller
    asks for another.  Raises when no card is present and none was
    asked for; it never falls back to the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on "
                           "the CPU")
    return torch.device("cuda")


def resolve_fuse(model: Model, config: TrainConfig) -> Model:
    """'off' leaves the model alone; 'auto'/'on' rewrite its fusable
    ``norm -> aggregate -> norm [-> relu]`` chains into fused ops.
    Returns the ORIGINAL object when nothing fused."""
    if config.aggr_fuse == "off":
        return model
    if config.aggr_fuse not in ("auto", "on"):
        raise ValueError(f"unknown aggr_fuse {config.aggr_fuse!r}; "
                         "expected 'auto', 'on', or 'off'")
    fused = model.fuse_norm_aggregate()
    if fused.num_fused_aggregates() <= model.num_fused_aggregates():
        return model
    return fused


# Past these edge counts an attention model goes to 'attn_flat8' and a
# MAX/MIN model to 'flat_sum' (the JAX package's thresholds).
ATTN_FLAT8_MIN_EDGES = 20_000_000


def card_kind(device) -> Optional[str]:
    """``torch.cuda.get_device_name`` of a CUDA ``device``; None for the
    CPU (the 'auto' rule's card rows are keyed by it)."""
    device = torch.device(device) if device is not None else None
    if device is None or device.type != "cuda":
        return None
    return torch.cuda.get_device_name(device)


def resolve_auto_impl_probed(graph, out_rows: Optional[int] = None, *,
                             device_kind: Optional[str] = None,
                             bdense_min_fill: int = 64,
                             bdense_a_budget: Optional[int] = 2 << 30,
                             bdense_group: int = 1) -> str:
    """``aggr_impl='auto'``: the JAX package's rule (core/ell.py
    ``jax_auto_impl``: the sectioned window, then 'flat_sum' past
    ``FLAT_SUM_MIN_EDGES``) with its block-dense structure probe (inside
    the window, from ``BDENSE_AUTO_MIN_EDGES`` edges: 'bdense' when the
    census puts ``BDENSE_AUTO_MIN_FRAC`` of the edges on dense tiles;
    native planners only; skipped for a graph without columns, a
    DataSource's ``RowGraph``), then the card's row (core/ell.py
    ``port_route``).  ``out_rows`` is a part's output rows on a
    partitioned run (the window's upper bound reads it; None: every
    row).  Emits a ``resolve`` event with the JAX rule's answer
    (``jax_resolves``) beside the port's."""
    jax_impl = jax_auto_impl(graph.num_nodes, out_rows=out_rows,
                             num_edges=graph.num_edges)
    fields: Dict[str, Any] = {}
    if jax_impl == "sectioned" and \
            graph.num_edges >= bd.BDENSE_AUTO_MIN_EDGES and \
            getattr(graph, "col_idx", None) is None:
        # a DataSource's RowGraph holds no columns: the JAX package skips
        # the probe the same way on a multi-process run
        fields["probe"] = "skipped: no columns held"
    elif jax_impl == "sectioned" and \
            graph.num_edges >= bd.BDENSE_AUTO_MIN_EDGES:
        frac = bd.probe_dense_frac(
            graph.row_ptr, graph.col_idx, graph.num_nodes,
            min_fill=bdense_min_fill, a_budget_bytes=bdense_a_budget,
            group=bdense_group)
        if frac is not None:
            fields["dense_frac"] = round(frac, 4)
            if frac >= bd.BDENSE_AUTO_MIN_FRAC:
                jax_impl = "bdense"
    impl = port_route(jax_impl, device_kind)
    row = CARD_ROWS.get(device_kind) if device_kind else None
    why = (f"; the JAX rule takes {jax_impl!r}, and on {device_kind} "
           f"{impl!r} won the race ({row.source})"
           if row is not None and impl != port_route(jax_impl) else "")
    emit("resolve", f"aggr_impl='auto' -> {impl!r} (V={graph.num_nodes:,}, "
         f"E={graph.num_edges:,}{why})", requested="auto", resolved=impl,
         jax_resolves=jax_impl, device_kind=device_kind, **fields)
    return impl


def resolve_auto_impl_early(model: Model, config: TrainConfig, graph,
                            device_kind: Optional[str] = None,
                            out_rows: Optional[int] = None
                            ) -> TrainConfig:
    """'auto' resolved for a model of sums; attention and MAX/MIN models
    are left to :func:`resolve_attention_impl`, as in the JAX package.
    ``out_rows``: a part's output rows on a partitioned run."""
    if config.aggr_impl != "auto" or model.uses_attention() \
            or model.uses_max_aggregation():
        return config
    if graph is None:
        raise ValueError("aggr_impl='auto' needs the dataset")
    return dataclasses.replace(config, aggr_impl=resolve_auto_impl_probed(
        graph, out_rows=out_rows, device_kind=device_kind,
        bdense_min_fill=config.bdense_min_fill,
        bdense_a_budget=config.bdense_a_budget,
        bdense_group=config.bdense_group))


def resolve_attention_impl(model: Model, config: TrainConfig,
                           dataset: Optional[Dataset] = None,
                           device_kind: Optional[str] = None
                           ) -> TrainConfig:
    """The JAX package's model-driven route rule on the port's routes
    ('cuda' plays its 'pallas', 'cuda_csr' its 'pallas_csr').  An
    attention model needs the ELL or the flat tables and a MAX/MIN model
    a route with a max form; 'ell' and 'cuda' keep either at any size,
    'segment' and 'flat_sum' keep a MAX/MIN model.  Otherwise, with
    ``dataset`` past the edge thresholds an attention model goes to
    'attn_flat8' and a MAX/MIN model to 'flat_sum', and below them to
    'ell', each with a ``resolve`` event naming the JAX rule's answer
    (``jax_resolves``).  An 'auto' request takes the port's counterpart
    of that answer: 'cuda' for 'ell', and for an attention model the
    attention entry of the row of ``device_kind``
    (core/ell.py ``port_attention_route``).  'attn_flat8' on a model
    without attention raises, and so does an attention or MAX/MIN model
    on the ring halo (the JAX package's message)."""
    why = ("attention" if model.uses_attention()
           else "MAX/MIN aggregation" if model.uses_max_aggregation()
           else None)
    if config.aggr_impl == "attn_flat8" and why != "attention":
        raise NotImplementedError(
            "aggr_impl='attn_flat8' is the attention-only layout; this "
            f"model uses {why or 'sum aggregation'}")
    if why is None:
        return config
    if config.halo == "ring":
        raise NotImplementedError(
            f"{why} models are not supported with halo='ring' (the "
            "ring accumulator is additive; the whole neighborhood is "
            "needed per row); use halo='gather'")
    if config.aggr_impl in ("ell", "cuda", "attn_flat8"):
        return config
    if why != "attention" and config.aggr_impl in ("segment", "flat_sum"):
        return config
    flat, limit = (("attn_flat8", ATTN_FLAT8_MIN_EDGES) if why == "attention"
                   else ("flat_sum", FLAT_SUM_MIN_EDGES))
    E = None if dataset is None else int(dataset.graph.num_edges)
    past = E is not None and E >= limit
    jax_to = flat if past else "ell"
    to = jax_to
    if config.aggr_impl == "auto":
        to = (port_attention_route(jax_to, device_kind)
              if why == "attention" else JAX_ROUTE.get(jax_to, jax_to))
    reason = (f"{why} at E={E:,}: the flat layout" if past
              else f"{why} model needs the ELL tables")
    row = CARD_ROWS.get(device_kind) if device_kind else None
    if row is not None and why == "attention" and \
            to != JAX_ROUTE.get(jax_to, jax_to):
        reason += (f"; the JAX rule takes {jax_to!r}, and on "
                   f"{device_kind} {to!r} won the race "
                   f"({row.attention_source})")
    emit("resolve", f"aggr_impl={config.aggr_impl!r} -> {to!r} ({reason})",
         requested=config.aggr_impl, resolved=to, why=why,
         jax_resolves=jax_to, device_kind=device_kind)
    return dataclasses.replace(config, aggr_impl=to)


def resolve_config(model: Model, dataset: Optional[Dataset],
                   config: TrainConfig, device=None, num_parts: int = 1
                   ) -> Tuple[Model, TrainConfig]:
    """THE resolve pass, in the JAX package's order: the fuse rewrite
    (:func:`resolve_fuse`), 'auto' (:func:`resolve_auto_impl_early`, by
    the card ``device`` is, None the CPU, and a part's rows at
    ``num_parts`` > 1), the memory autopilot
    (:func:`apply_memory_autopilot`, over ``num_parts`` parts and the
    memory of ``device``), then the model-driven route
    (:func:`resolve_attention_impl`).  One part runs the halo 'gather',
    whatever the config asks (no rank to rotate to).  ``Trainer`` and
    ``serve/export.build_predictor`` both run it, so a predictor serves
    the model and route a trainer would train.  Idempotent: a resolved
    pair comes back unchanged.  Returns ``(model, config)``."""
    from ..models.builder import HALOS
    if config.halo not in HALOS:
        raise ValueError(f"unknown halo {config.halo!r}; expected one of "
                         f"{HALOS}")
    if num_parts == 1 and config.halo != "gather":
        config = dataclasses.replace(config, halo="gather")
    model = resolve_fuse(model, config)
    out_rows = (-(-dataset.graph.num_nodes // num_parts)
                if num_parts > 1 and dataset is not None else None)
    config = resolve_auto_impl_early(
        model, config, dataset.graph if dataset is not None else None,
        device_kind=card_kind(device), out_rows=out_rows)
    if config.memory == "auto":
        if dataset is None:
            raise ValueError("memory='auto' needs the dataset")
        config = apply_memory_autopilot(model, dataset, config,
                                        num_parts=num_parts, device=device)
    elif config.memory != "manual":
        raise ValueError(f"unknown memory {config.memory!r}; expected "
                         "'auto' or 'manual'")
    return model, resolve_attention_impl(model, config, dataset,
                                         device_kind=card_kind(device))


def resolve_symmetric(dataset, symmetric: Optional[bool]) -> bool:
    """``symmetric`` as given, or the graph's exact check for None.  A
    ``DataSource`` (core/source.py) holds no columns to check: it needs
    ``symmetric`` stated."""
    if symmetric is None:
        if not isinstance(dataset, Dataset):
            raise ValueError(
                "a DataSource needs TrainConfig.symmetric stated: checking "
                "the graph's symmetry reads every column")
        return check_symmetric(dataset.graph)
    return bool(symmetric)


DTYPE_MODES = ("float32", "bfloat16", "mixed")


def resolve_dtypes(name: str):
    """Dtype-mode name (the CLI's ``--dtype``) -> ``(dtype,
    compute_dtype)``, the JAX package's mapping: 'float32' is fp32
    throughout, 'bfloat16' bf16 throughout (params too; the Adam moments
    stay fp32), 'mixed' fp32 params with bf16 compute."""
    if name == "float32":
        return torch.float32, None
    if name == "bfloat16":
        return torch.bfloat16, None
    if name == "mixed":
        return torch.float32, torch.bfloat16
    raise ValueError(f"unknown dtype mode {name!r}; expected "
                     "'float32', 'bfloat16', or 'mixed'")


def compute_dtype_of(config: TrainConfig) -> torch.dtype:
    """``compute_dtype`` when set (mixed precision), else ``dtype``."""
    return (config.compute_dtype if config.compute_dtype is not None
            else config.dtype)


def cast_floats(params: Dict[str, torch.Tensor],
                dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """Floating-point entries cast to ``dtype``; others pass through."""
    return {k: (v.to(dtype) if v.is_floating_point() else v)
            for k, v in params.items()}


def make_graph_context(dataset: Dataset, aggr_impl: str = "cuda",
                       symmetric: Optional[bool] = None,
                       device=None, chunk: int = 512,
                       **layout: Any) -> GraphContext:
    """Single-device GraphContext on ``device`` (the card unless
    ``device`` says otherwise), with the tables of ``aggr_impl`` alone
    (no route uploads another's: at Reddit scale the edge list alone is
    ~0.9 GB of int32).  ``layout``: :func:`graph_context`'s keywords."""
    return graph_context(dataset.graph, aggr_impl,
                         resolve_symmetric(dataset, symmetric),
                         device=device, chunk=chunk, **layout)


def graph_context(g, aggr_impl: str = "cuda", symmetric: bool = True,
                  device=None, chunk: int = 512, fuse: bool = False,
                  sect_sub_w: int = 8, sect_u16: bool = False,
                  bdense_min_fill: int = 64,
                  bdense_a_budget: Optional[int] = 2 << 30,
                  bdense_group: int = 1) -> GraphContext:
    """:func:`make_graph_context` of a bare ``core/graph.Graph`` whose
    symmetry the caller states (for a caller with a graph and no
    dataset, as chip_smoke.py's races).

    The ELL routes get the degree-bucketed tables, the edge routes the
    edge list padded to a ``chunk`` multiple, 'sectioned' the sectioned
    tables (``sect_sub_w``, ``sect_u16``), 'flat_sum' and 'attn_flat8'
    the flat tables, 'bdense' a u4-packed block plan (``bdense_*``,
    ops/blockdense.py ``plan_blocks_packed``; a ``plan`` event reports
    it) with its residual in sectioned tables.  ``fuse`` bakes the fused
    normalization into the layouts' tables (weight tables, tile
    scales), for a model with fused aggregations."""
    if aggr_impl not in AGGR_IMPLS:
        raise ValueError(f"aggr_impl {aggr_impl!r} is not a route; "
                         f"expected one of {AGGR_IMPLS} ('auto' is "
                         "resolved by resolve_config)")
    device = resolve_device(device)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    in_degree = dev(g.in_degree)
    V = g.num_nodes
    d_np = inv_sqrt_degree_np(g.in_degree) if fuse else None

    def sectioned(row_ptr, col_idx):
        sect = sectioned_from_graph(
            row_ptr, col_idx, V, section_rows=default_section_rows(sect_u16),
            sub_w=sect_sub_w)
        if sect_u16:
            sect = sect.with_idx_dtype(np.uint16)
        return dict(sect_idx=tuple(dev(a) for a in sect.idx),
                    sect_sub_dst=tuple(dev(a) for a in sect.sub_dst),
                    sect_meta=sect.meta,
                    sect_w=tuple(dev(w) for w in sect.weight_tables(
                        d_np, d_np)) if fuse else ())

    tables: Dict[str, Any] = {}
    if aggr_impl in EDGE_IMPLS:
        src, dst = padded_edge_list(g, multiple=chunk)
        tables = dict(edge_src=dev(src), edge_dst=dev(dst), chunk=chunk)
    elif aggr_impl in ELL_IMPLS:
        table = ell_from_graph(g.row_ptr, g.col_idx, V)
        tables = dict(ell_idx=tuple(dev(a[0]) for a in table.idx),
                      ell_row_pos=dev(table.row_pos[0]),
                      ell_row_id=tuple(dev(a[0]) for a in table.row_id),
                      ell_edges=tuple(int(np.count_nonzero(a[0] != V))
                                      for a in table.idx))
    elif aggr_impl == "sectioned":
        tables = sectioned(g.row_ptr, g.col_idx)
    elif aggr_impl in ("flat_sum", "attn_flat8"):
        flat = flat_sum_from_graph(g.row_ptr, g.col_idx, V)
        tables = dict(flat8_idx=dev(flat.idx[0]),
                      flat8_dst=dev(flat.sub_dst[0]))
        if fuse and aggr_impl == "flat_sum":
            tables["flat8_w"] = dev(flat.weight_tables(d_np, d_np)[0])
    else:
        plan = bd.plan_blocks_packed(g.row_ptr, g.col_idx, V,
                                     min_fill=bdense_min_fill,
                                     a_budget_bytes=bdense_a_budget,
                                     group=bdense_group)
        occ = plan.occupancy()
        packed = plan.a_blocks.shape[-1] == bd.BLOCK // 2
        emit("plan", f"bdense plan: {occ['n_blocks']} blocks of min_fill "
             f"{bdense_min_fill}, fill {occ['mean_fill']}, dense "
             f"{occ['dense_frac']:.1%} (the residual via sectioned"
             f"{', A u4-packed' if packed else ''})", packed=packed, **occ)
        if plan.n_blocks:
            tables = dict(bd_a=dev(plan.a_blocks), bd_src=dev(plan.src_blk),
                          bd_dst=dev(plan.dst_blk), bd_vpad=plan.vpad,
                          bd_group=bdense_group)
        if fuse:
            d_pad = np.zeros(plan.vpad, np.float32)
            d_pad[:V] = d_np
            tables["bd_scale"] = (dev(d_pad), dev(d_pad))
        if plan.res_col.shape[0]:
            tables.update(sectioned(plan.res_row_ptr, plan.res_col))
    return GraphContext(
        in_degree=in_degree, inv_sqrt_deg=inv_sqrt_degree(in_degree),
        num_rows=V, aggr_impl=aggr_impl, symmetric=bool(symmetric),
        **tables)


class Trainer:
    """Owns the parameters, the optimizer state and the step.

    ``params`` (optional) are the starting weights, copied onto the
    device (e.g. carried from the JAX package with convert.py); without
    them Glorot weights are drawn from a generator seeded with
    ``config.seed``, which also draws every dropout mask.  ``device``
    is the card unless the caller passes another (``'cpu'``).

    A subclass that holds one part of the graph (parallel/distributed.py
    ``DistributedTrainer``) overrides :meth:`_num_parts`, :meth:`_place`,
    :meth:`_reduce` and :meth:`predict`; the step, the epoch loop and the
    eval are shared.

    Under ``features='host'`` (:meth:`_place_host`) the features stay in
    host memory (``feats_host``, in the compute dtype, pinned on the
    card; ``feats`` is None) and a step is :meth:`_streamed_loss_and_grads`:
    the streamed head's forward, the device-resident tail's loss and
    gradients (its remat too), and the streamed weight gradient.  Block
    b's dropout seed is ``derived_seed(step_seed, b)``, the step's seed
    derived from the seed, the rank, the epoch and the dropout
    generator's state at the step's start (:meth:`_step_seed`): a resumed
    run redraws a step's masks from the checkpoint, and a retry, which
    reseeds the generator, draws new ones.
    ``spans_ms`` collects the host wall time of each part of a streamed
    step (``head_forward``, ``tail_grad``, ``head_wgrad``, ``update``)
    until :meth:`pipeline_fields` reads it."""

    # whether the trainer builds from a DataSource (core/source.py): the
    # partitioned one does; this one holds the whole graph
    _takes_source = False
    # whether __init__ emits the run manifest; the partitioned trainer
    # emits it once its split is known
    _manifest_in_init = True

    def __init__(self, model: Model, dataset: Dataset,
                 config: TrainConfig = TrainConfig(),
                 params: Optional[Dict[str, torch.Tensor]] = None,
                 device=None):
        if not self._takes_source and not isinstance(dataset, Dataset):
            raise TypeError(
                f"{type(self).__name__} holds the whole graph: pass a "
                "Dataset (a DataSource stands in on DistributedTrainer)")
        self._check_mesh(config)
        self.device = resolve_device(device)
        model, config = resolve_config(model, dataset, config,
                                       device=self.device,
                                       num_parts=self._num_parts())
        if config.features == "host" and self._num_parts() > 1:
            raise NotImplementedError(
                "features='host' streaming is single-device only; the "
                "distributed >HBM mechanism is halo='ring' (the "
                "autopilot picks it automatically for parts > 1)")
        if config.features not in ("hbm", "host"):
            raise ValueError(f"unknown features {config.features!r}; "
                             "expected 'hbm' or 'host'")
        remat_policy(config)
        self.model = model
        self.config = config
        self.compute = compute_dtype_of(config)
        self.epoch = 0
        # the dataset's identity, in the checkpoint's strict fingerprint
        # (utils/checkpoint.trainer_fingerprint)
        self._fp_dataset = {"V": int(dataset.graph.num_nodes),
                            "E": int(dataset.graph.num_edges)}
        self.modeled_bytes = modeled_step_bytes(model, dataset, config,
                                                num_parts=self._num_parts())
        symmetric = resolve_symmetric(dataset, config.symmetric)
        if not symmetric and config.aggr_impl in KERNEL_IMPLS:
            raise NotImplementedError(
                f"aggr_impl={config.aggr_impl!r} trains by the symmetric "
                "trick only and this graph is not symmetric; use 'ell' "
                "or 'segment'")
        self._head = None
        self.feats_host = None
        self.spans_ms: Dict[str, List[float]] = {}
        if config.features == "host":
            self._place_host(dataset, symmetric)
        else:
            self._place(dataset, symmetric)
        self.generator = torch.Generator(device=self.device).manual_seed(
            config.seed)
        if params is None:
            params = model.init_params(self.generator, dtype=config.dtype,
                                       device=self.device)
        else:
            params = {k: v.detach().to(self.device, config.dtype).clone()
                      .requires_grad_(True) for k, v in params.items()}
        self.params: Dict[str, torch.Tensor] = dict(params)
        self.opt_state = adam_init(self.params)
        self.adam_cfg = AdamConfig(weight_decay=config.weight_decay)
        self.num_edges = int(dataset.graph.num_edges)
        # the objective of every step, as 0-d device tensors (no sync)
        self.losses: List[torch.Tensor] = []
        self._stepped = False
        # the first step's ms (run_epoch_loop), kept for a caller whose
        # first train() call ends before an eval
        self.first_step_ms: Optional[float] = None
        # the step slots the epoch loop calls, with first-step telemetry:
        # late-bound (a subclass's or a test's step is the one run) through
        # a weak proxy, so no cycle keeps a dropped trainer's device memory
        # alive until the collector runs
        from ..obs.compile_watch import ObservedStep
        from ..utils.profiling import EpochTimer, MetricsLog
        me = weakref.proxy(self)
        self._train_step = ObservedStep(
            lambda lr: me.step(lr), name="train_step",
            device=self.device, modeled_bytes=self.modeled_bytes,
            verbose=config.verbose)
        self._eval_step = ObservedStep(lambda: me.evaluate(),
                                       name="eval_step", device=self.device,
                                       verbose=config.verbose)
        # annotate: the loop's phases as named ranges in the trace of
        # profile_dir
        self.timer = EpochTimer(annotate=bool(config.profile_dir))
        self.metrics_log = MetricsLog(config.metrics_path)
        if self._manifest_in_init:
            self._emit_manifest(dataset)

    def _num_parts(self) -> int:
        """The partitions of this run: 1 on one device."""
        return 1

    def _emit_manifest(self, dataset, **extra: Any) -> None:
        """The run manifest (obs/manifest.py) of the resolved config and
        model, with the memory model's ``modeled_step_bytes`` and
        ``extra``."""
        from ..obs.manifest import run_manifest
        run_manifest(config=self.config, dataset=dataset, model=self.model,
                     num_parts=self._num_parts(),
                     extra={"modeled_step_bytes": self.modeled_bytes,
                            **extra},
                     console=self.config.verbose, device=self.device)

    def _check_mesh(self, config: TrainConfig) -> None:
        """One device hosts no model axis: 'auto' and '1x1' only.  (The
        JAX package places '1xM' over M local devices; here the ranked
        path does that.)"""
        _, m = resolve_mesh(config, num_parts=1)
        if m > 1:
            raise NotImplementedError(
                f"mesh={config.mesh!r}: the single-device Trainer hosts "
                "no model axis; run DistributedTrainer with num_parts=1 "
                f"on {m} ranks (torchrun --nproc-per-node {m} -m "
                f"roc_tpu_torch.train.cli --parts 1 --mesh 1x{m})")

    def _full_params(self) -> Dict[str, torch.Tensor]:
        """The whole weights the model computes with: ``params`` itself
        here; a trainer that keeps them sharded gathers them."""
        return self.params

    def _local_grads(self, grads: Dict[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
        """The gradients of the weights this trainer updates: all of them
        here; a trainer that keeps the weights sharded slices them."""
        return grads

    def _place(self, dataset: Dataset, symmetric: bool) -> None:
        """Put the rows this trainer computes on the device: ``feats``
        (in the compute dtype), ``labels``, ``mask`` and the graph
        context ``gctx``; here the whole graph."""
        self.feats = torch.as_tensor(dataset.features,
                                     dtype=self.compute).to(self.device)
        self.labels = torch.from_numpy(dataset.labels).to(self.device)
        self.mask = torch.from_numpy(dataset.mask).to(self.device)
        self.gctx = make_graph_context(
            dataset, self.config.aggr_impl, symmetric=symmetric,
            device=self.device, chunk=self.config.chunk,
            fuse=self.model.num_fused_aggregates() > 0,
            **layout_options(self.config))
        self.gctx.head_chunk = resolve_head_chunk(self.config,
                                                  self.gctx.num_rows)

    def _place_host(self, dataset: Dataset, symmetric: bool) -> None:
        """``features='host'``: split the model at its streamable head
        (``Model.streamable_head``, else ``streamable_agg_head``, whose
        propagation prefix runs here once through core/streaming.py
        ``stream_prefix_to_host``), keep the features (or the prefix's
        output) in host memory in the compute dtype, pinned on the card,
        and put the labels, the mask and the tail's graph context on the
        device; a tail with no graph op gets a context with no tables."""
        from ..core.streaming import StreamedHead, stream_prefix_to_host
        cfg = self.config
        head = self.model.streamable_head()
        prefix_ops = None
        if head is None:
            agg = self.model.streamable_agg_head()
            if agg is None:
                raise NotImplementedError(
                    "features='host' needs a streamable model head (input "
                    "-> dropout -> linear, Model.streamable_head) or an "
                    "aggregation-prefix head (norm/aggregate chain -> "
                    "dropout -> linear, Model.streamable_agg_head); this "
                    "model's first layer reads the raw features elsewhere: "
                    "use features='hbm'")
            prefix_ops, rate, self._head_param, self._tail_model = agg
        else:
            rate, self._head_param, self._tail_model = head
        depth = resolve_prefetch(cfg)
        self._head = StreamedHead(rate, prefetch=depth, device=self.device)
        feats = dataset.features
        if prefix_ops is not None:
            feats = stream_prefix_to_host(dataset.graph, prefix_ops, feats,
                                          prefetch=depth, device=self.device)
        host = torch.as_tensor(np.asarray(feats)).to(self.compute)
        self.feats_host = (host.pin_memory() if self.device.type == "cuda"
                           else host.contiguous())
        self.feats = None
        self.labels = torch.from_numpy(dataset.labels).to(self.device)
        self.mask = torch.from_numpy(dataset.mask).to(self.device)
        if any(op.kind in AGGREGATE_KINDS for op in self._tail_model._ops):
            self.gctx = make_graph_context(
                dataset, cfg.aggr_impl, symmetric=symmetric,
                device=self.device, chunk=cfg.chunk,
                fuse=self._tail_model.num_fused_aggregates() > 0,
                **layout_options(cfg))
        else:
            # the whole graph part ran in the prefix: no O(E) tables
            in_degree = torch.from_numpy(dataset.graph.in_degree).to(
                self.device)
            self.gctx = GraphContext(
                in_degree=in_degree, inv_sqrt_deg=inv_sqrt_degree(in_degree),
                num_rows=dataset.graph.num_nodes, aggr_impl="segment",
                symmetric=symmetric)
        self.gctx.head_chunk = resolve_head_chunk(cfg, self.gctx.num_rows)

    def _reduce(self, tensors: List[torch.Tensor]) -> List[torch.Tensor]:
        """The sums over every trainer of a run: ``tensors`` themselves
        on one device."""
        return tensors

    @contextlib.contextmanager
    def _span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.spans_ms.setdefault(name, []).append(
                (time.perf_counter() - t0) * 1e3)

    def loss_and_grads(self) -> Tuple[torch.Tensor,
                                      Dict[str, torch.Tensor]]:
        """The objective (summed masked CE) and its gradients at the
        current weights, summed by :meth:`_reduce`: one forward and
        backward through the model (dropout draws from ``generator``;
        with ``remat`` the activations are recomputed in the backward,
        ``Model.apply``)."""
        if self._head is not None:
            return self._streamed_loss_and_grads()
        names = list(self.params)
        full = self._full_params()
        loss, _ = self.model.loss_fn(cast_floats(full, self.compute),
                                     self.feats, self.labels, self.mask,
                                     self.gctx, generator=self.generator,
                                     train=True,
                                     remat=remat_policy(self.config))
        grads = torch.autograd.grad(loss, [full[k] for k in names])
        *grads, loss = self._reduce([*grads, loss.detach()])
        return loss, dict(zip(names, grads))

    def _step_seed(self) -> int:
        """The streamed head's seed for this step: ``derived_seed`` of the
        seed, the rank, the epoch and a digest of the dropout generator's
        state (a host read for a CUDA generator too: no device sync)."""
        digest = hashlib.blake2b(self.generator.get_state().numpy()
                                 .tobytes(), digest_size=16).digest()
        return derived_seed(self.config.seed, getattr(self, "rank", 0),
                            self.epoch,
                            *np.frombuffer(digest, dtype=np.uint32))

    def _streamed_loss_and_grads(self) -> Tuple[torch.Tensor,
                                                Dict[str, torch.Tensor]]:
        """The streamed step's objective and gradients: the head's forward
        from host features (its masks from the step's seed), the tail's
        loss and its gradients with respect to its weights and the
        projected activations ``Y`` (the tail's dropout draws from
        ``generator``), then the head's weight gradient from ``dY``."""
        hp = self._head_param
        seed = self._step_seed()
        with self._span("head_forward"):
            w0 = self.params[hp].detach().to(self.compute)
            y = self._head.forward(w0, self.feats_host, seed, True)
        with self._span("tail_grad"):
            y.requires_grad_(True)
            names = [k for k in self.params if k != hp]
            loss, _ = self._tail_model.loss_fn(
                cast_floats(self.params, self.compute), y, self.labels,
                self.mask, self.gctx, generator=self.generator, train=True,
                remat=remat_policy(self.config))
            *gs, gy = torch.autograd.grad(
                loss, [self.params[k] for k in names] + [y],
                allow_unused=True)
        with self._span("head_wgrad"):
            gw = self._head.wgrad(self.feats_host, gy, seed, True).to(
                self.params[hp].dtype)
        got = dict(zip(names, gs))
        got[hp] = gw
        grads = [got[k] if got[k] is not None
                 else torch.zeros_like(self.params[k]) for k in self.params]
        *grads, loss = self._reduce([*grads, loss.detach()])
        return loss, dict(zip(self.params, grads))

    def step(self, lr: float) -> torch.Tensor:
        """One training step at learning rate ``lr``: forward, backward,
        Adam update.  Returns the objective (summed masked CE) before the
        update, on the device."""
        loss, grads = self.loss_and_grads()
        with self._span("update") if self._head is not None \
                else contextlib.nullcontext():
            self.params, self.opt_state = adam_update(
                self.params, self._local_grads(grads), self.opt_state, lr,
                self.adam_cfg)
        self.losses.append(loss)
        return loss

    def pipeline_fields(self) -> Dict[str, Any]:
        """The streamed tier's metrics since the last call, folded into
        each eval record by :func:`run_epoch_loop` (empty without a
        streamed head): ``prefetch_depth``, the staging pool's
        ``h2d_wait_p50_ms`` (the consumer's median stall a block),
        ``h2d_stage_p50_ms`` and ``overlap_frac`` (the share of staging
        hidden under compute, as the host sees it: on the card a stage
        only issues its copy, so this says nothing of the copies' overlap
        on the device; 0 for ``prefetch=0`` by construction), on
        the card the copies' ``h2d_gbps`` (bytes over their device time),
        and each span's median ``spans_p50_ms``.  Also a ``pipeline``
        event."""
        if self._head is None:
            return {}
        stats = self._head.pool.take_stats()
        spans, self.spans_ms = self.spans_ms, {}
        if not stats["n"]:
            return {}
        out: Dict[str, Any] = {
            "prefetch_depth": int(stats["depth"]),
            "h2d_wait_p50_ms": stats["wait_p50_ms"],
            "h2d_stage_p50_ms": stats["stage_p50_ms"]}
        if stats["overlap_frac"] is not None:
            out["overlap_frac"] = stats["overlap_frac"]
        if stats.get("h2d_gbps") is not None:
            out["h2d_gbps"] = stats["h2d_gbps"]
        out["spans_p50_ms"] = {k: float(np.median(v))
                               for k, v in spans.items()}
        emit("pipeline", f"h2d: {stats['n']} blocks, wait p50 "
             f"{out['h2d_wait_p50_ms']:.2f} ms, overlap_frac "
             f"{out.get('overlap_frac', 0.0)}", console=False, **out)
        return out

    def train(self, epochs: Optional[int] = None) -> List[Dict[str, float]]:
        """Run ``epochs`` more epochs (``config.epochs`` by default); the
        epoch counter persists across calls, so lr decay and the eval
        cadence continue."""
        return run_epoch_loop(self, epochs, self._train_step,
                              self._eval_step)

    def sync(self) -> None:
        """Block until every launched step has finished."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- the checkpoint's view of the trainer (utils/checkpoint.py)

    def rng_states(self) -> np.ndarray:
        """The dropout generators' states, one uint8 row per rank
        (``torch.Generator.get_state()``); here one row."""
        return self.generator.get_state().numpy()[None].copy()

    def restore_rng(self, states: Optional[np.ndarray]) -> None:
        """Set this rank's dropout generator from a checkpoint's states
        (:meth:`rng_states`).  Where they hold no row for this rank, or a
        row of another generator (a JAX checkpoint, whose PRNG key cannot
        drive torch's dropout; one saved on another device type), the
        generator is reseeded from the seed and the restored epoch
        (:meth:`reseed`) and a ``resilience`` event says so."""
        rank = getattr(self, "rank", 0)
        n = self.generator.get_state().numel()
        if states is not None and states.ndim == 2 and \
                rank < states.shape[0] and states.shape[1] == n:
            self.generator.set_state(torch.from_numpy(
                np.ascontiguousarray(states[rank], dtype=np.uint8)))
            return
        self.reseed(self.epoch)
        emit("resilience",
             f"checkpoint holds no dropout generator state for rank "
             f"{rank} (a JAX checkpoint, or one saved on another device "
             f"or rank count): reseeded from seed {self.config.seed} and "
             f"epoch {self.epoch}", kind="rng_reseed", epoch=self.epoch,
             rank=rank)

    def reseed(self, *words: int) -> None:
        """Seed the dropout generator with :func:`derived_seed`
        ``(config.seed, rank, *words)``."""
        self.generator.manual_seed(derived_seed(
            self.config.seed, getattr(self, "rank", 0), *words))

    def agree(self, value: Optional[int]) -> Optional[int]:
        """Rank 0's ``value`` on every rank of the run: ``value`` itself
        on one device."""
        return value

    @torch.no_grad()
    def _logits(self) -> torch.Tensor:
        """Inference-mode logits of this trainer's rows (through the
        streamed head in eval mode under ``features='host'``)."""
        params = cast_floats(self._full_params(), self.compute)
        if self._head is not None:
            y = self._head.forward(params[self._head_param],
                                   self.feats_host, None, False)
            return self._tail_model.apply(params, y, self.gctx, train=False)
        return self.model.apply(params, self.feats, self.gctx, train=False)

    def predict(self, node_ids=None) -> torch.Tensor:
        """Inference-mode logits ``[V, C]`` on the device, or the rows
        ``node_ids`` of them."""
        logits = self._logits()
        if node_ids is None:
            return logits
        ids = torch.as_tensor(node_ids, dtype=torch.long).reshape(-1)
        V = logits.shape[0]
        if ids.numel() and (int(ids.min()) < 0 or int(ids.max()) >= V):
            raise ValueError(f"node ids out of range [0, {V})")
        return logits.index_select(0, ids.to(logits.device))

    def evaluate(self) -> Dict[str, float]:
        """The reference's inference pass: the metric sums, summed by
        :meth:`_reduce`, as :func:`summarize_metrics` gives them, fetched
        in one device sync."""
        m = perf_metrics(self._logits(), self.labels, self.mask)
        keys = list(m)
        return summarize_metrics(dict(zip(keys,
                                          self._reduce([m[k]
                                                        for k in keys]))))


def run_epoch_loop(tr: Trainer, epochs: Optional[int], do_step,
                   do_eval) -> List[Dict[str, float]]:
    """The reference epoch loop (``gnn.cc:99-111``): staircase lr decay,
    one step per epoch, an eval every ``eval_every`` epochs (on
    ``epoch % eval_every == eval_every - 1``, so each eval closes a full
    burst of steps), each printed with :func:`format_metrics` when
    ``config.verbose``.

    Timing: steps are launched without waiting; the loop synchronises
    before each eval, so ``epoch_ms`` is the steps' wall clock over the
    steps since the last eval, and ``eval_ms`` is the eval pass on its
    own.  The first step of a trainer (cold kernels, allocator and
    library handles, and the observer's count, obs/compile_watch.py) is
    synchronised and reported apart, as ``first_step_ms`` on the first
    eval's record (the JAX loop's ``compile_ms``); ``epoch_ms`` counts
    steady steps only, and is None when an eval follows the first step
    with no steady step between.  Each eval record is also emitted as an
    ``epoch`` event (off the console).

    Telemetry, as the JAX loop has it: the loop runs inside
    ``trace(config.profile_dir)`` (utils/profiling.py), with the first
    step, each steady step and each eval in ``first_step``/``train``/
    ``eval`` ranges when ``tr.timer.annotate`` is on; a ``timeline``
    ``clock_sync`` event at the first step's barrier; the timer's laps
    (the first step's as its warmup lap) and span laps
    (``first_step``, the steady burst as one ``train`` lap, ``eval``),
    flushed as one ``timeline`` ``spans`` event an eval and once more at
    the end; the loop's registry ``tr.reg`` (``MetricsRegistry('train')``:
    ``step_ewma_ms``, an EWMA of the steady ``epoch_ms`` with alpha 0.2,
    also on the record; ``straggler_ratio``; ``h2d_wait_p50_ms``; the
    ``epoch_ms`` histogram); :func:`throughput_fields` on each record with
    steady steps; ``tr.metrics_log`` (``config.metrics_path``) takes each
    record and is closed when the loop ends, on an exception too, after
    which a ``phase spans`` ``epoch`` event summarises the spans.

    Resilience hooks, where the JAX loop has them: the loop notes each
    epoch for the fault sites (``inject.note_epoch``), and after each
    epoch's step has been launched runs the epoch-boundary drill sites
    (``inject.epoch_hooks``) and the preemption check
    (``preempt.raise_if_preempted``); the first step's barrier runs
    inside a ``first_compile`` heartbeat (obs/heartbeat.py) with the
    ``stall_compile`` site (``inject.maybe_stall``), so with
    ``ROC_TPU_STALL_TIMEOUT_S`` set a first step that hangs becomes a
    StallFailure.  Each eval record carries :meth:`Trainer.pipeline_fields`
    (the streamed tier's staging metrics) and, on a trainer that has
    them (parallel/distributed.py), ``straggler_fields``; after each eval
    record the loop calls its ``maybe_rebalance``, which may repartition
    between epochs."""
    from ..obs.heartbeat import Heartbeat
    from ..obs.metrics_registry import MetricsRegistry
    from ..resilience import inject, preempt
    from ..utils.profiling import trace
    cfg = tr.config
    if cfg.fault:
        inject.arm(cfg.fault)
    epochs = cfg.epochs if epochs is None else epochs
    history: List[Dict[str, float]] = []
    reg = getattr(tr, "reg", None)
    if reg is None:
        reg = tr.reg = MetricsRegistry("train")
    g_step = reg.gauge("step_ewma_ms", ewma_alpha=0.2)
    g_strag = reg.gauge("straggler_ratio")
    g_h2d = reg.gauge("h2d_wait_p50_ms")
    h_epoch = reg.histogram("epoch_ms")
    timer = tr.timer
    e_last = tr.epoch
    first_ms: Optional[float] = None
    try:
        with trace(cfg.profile_dir):
            # the profiler's start is not the first step's time
            t_last = time.perf_counter()
            for _ in range(epochs):
                epoch = tr.epoch
                inject.note_epoch(epoch)
                lr = float(decayed_lr(cfg.learning_rate, epoch,
                                      cfg.decay_rate, cfg.decay_steps))
                with timer.phase("train" if tr._stepped else "first_step"):
                    do_step(lr)
                if not tr._stepped:
                    with Heartbeat("first_compile"):
                        inject.maybe_stall()
                        tr.sync()
                    now = time.perf_counter()
                    first_ms = tr.first_step_ms = (now - t_last) * 1e3
                    # the epoch timer's laps: one per eval, flushed to the
                    # timeline
                    # roc-lint: ok=metric-adhoc
                    timer.laps_ms.append(first_ms)
                    timer.note_span("first_step", first_ms)
                    # the clock-sync handshake on the barrier just crossed
                    # (every rank passes the first step's collectives
                    # within a step of the others)
                    emit("timeline", f"clock_sync: first-step barrier "
                         f"crossed (epoch {epoch})", console=False,
                         kind="clock_sync", epoch=epoch,
                         first_step_ms=round(first_ms, 1))
                    t_last, e_last = now, epoch + 1
                    tr._stepped = True
                if epoch % cfg.eval_every == cfg.eval_every - 1:
                    tr.sync()
                    now = time.perf_counter()
                    mono_now = time.monotonic()
                    with timer.phase("eval"):
                        m = do_eval()
                    t_eval_end = time.perf_counter()
                    span = epoch + 1 - e_last
                    m["epoch"] = epoch
                    m["epoch_ms"] = ((now - t_last) * 1e3 / span
                                     if span > 0 else None)
                    m["eval_ms"] = (t_eval_end - now) * 1e3
                    if span > 0:
                        burst_ms = (now - t_last) * 1e3
                        # the epoch timer's laps: one per eval, flushed to
                        # the timeline
                        # roc-lint: ok=metric-adhoc
                        timer.laps_ms.append(m["epoch_ms"])
                        timer.spans_ms.setdefault("train", []).append(
                            m["epoch_ms"])
                        # the steady burst as one timeline span (its steps
                        # have no host-visible boundaries)
                        timer.timeline.append(
                            ("train", mono_now - burst_ms / 1e3, burst_ms))
                    timer.note_span("eval", m["eval_ms"])
                    if first_ms is not None:
                        m["first_step_ms"] = first_ms
                        first_ms = None
                    if span > 0:
                        m.update(throughput_fields(tr, m["epoch_ms"]))
                    m.update(tr.pipeline_fields())
                    straggler = getattr(tr, "straggler_fields", None)
                    if straggler is not None:
                        m.update(straggler(m))
                    # only steady laps feed the EWMA
                    if span > 0 and m.get("epoch_ms"):
                        h_epoch.record(m["epoch_ms"])
                        g_step.set(m["epoch_ms"])
                        if g_step.ewma is not None:
                            m["step_ewma_ms"] = round(g_step.ewma, 2)
                    if m.get("straggler_ratio") is not None:
                        g_strag.set(m["straggler_ratio"])
                    if m.get("h2d_wait_p50_ms") is not None:
                        g_h2d.set(m["h2d_wait_p50_ms"])
                    t_last, e_last = t_eval_end, epoch + 1
                    history.append(m)
                    tr.metrics_log.log(m)
                    _flush_spans(timer, f"to epoch {epoch}", epoch=epoch)
                    emit("epoch", f"epoch {epoch}: train_loss "
                         f"{m['train_loss']}", console=False, **m)
                    if cfg.verbose:
                        print(format_metrics(epoch, m), flush=True)
                    rebalance = getattr(tr, "maybe_rebalance", None)
                    if rebalance is not None and rebalance(m):
                        # the rebuild is not an epoch's time
                        t_last = time.perf_counter()
                tr.epoch += 1
                inject.epoch_hooks(tr, epoch)
                preempt.raise_if_preempted(epoch)
    finally:
        # bound descriptors across many trainers, on exceptions too; the
        # log reopens in append mode if train() is called again
        tr.metrics_log.close()
        # the laps since the last eval's flush (a run dying between evals
        # keeps them)
        _flush_spans(timer, "(final)")
        if timer.spans_ms:
            spans = timer.span_summary()
            emit("epoch", "phase spans " + " ".join(
                f"{k}:n={v['n']},p50={v['p50_ms']:.1f}ms"
                for k, v in spans.items()),
                console=False, spans=spans, laps=timer.summary())
    return history


def _flush_spans(timer, what: str, **fields: Any) -> None:
    """The timer's span laps as one ``timeline`` ``spans`` event."""
    tl = timer.take_timeline()
    if tl:
        emit("timeline", f"spans: {len(tl)} laps {what}", console=False,
             kind="spans", spans=[[n, round(t0, 6), round(ms, 3)]
                                  for n, t0, ms in tl], **fields)


def throughput_fields(tr: Trainer, epoch_ms: Optional[float]
                      ) -> Dict[str, float]:
    """Edges a second, and with the first-step observer's FLOP count of
    the train step (``tr._train_step.cost``; on a partitioned run, this
    rank's) TFLOP/s and the MFU against the card's peak
    (obs/compile_watch.py ``peak_flops_per_s``; no ``mfu`` on the CPU or
    a card without a row), for one steady epoch lap."""
    from ..obs.compile_watch import peak_flops_per_s
    out: Dict[str, float] = {}
    if not epoch_ms or epoch_ms <= 0:
        return out
    s = epoch_ms / 1e3
    out["edges_per_s"] = round(tr.num_edges / s, 1)
    cost = getattr(getattr(tr, "_train_step", None), "cost", None)
    flops = (cost or {}).get("flops")
    if flops:
        out["tflops_per_s"] = round(flops / s / 1e12, 4)
        kind = card_kind(tr.device)
        peak = peak_flops_per_s(kind) if kind else None
        if peak:
            out["mfu"] = round(flops / s / peak, 4)
    return out


def format_metrics(epoch: int, m: Dict[str, float]) -> str:
    """The reference's infer-mode print line (``softmax_kernel.cu:146``)."""
    return ("[INFER][%d] train_loss: %.4f  train_accuracy: %.2f%%(%d/%d)  "
            "val_accuracy: %.2f%%(%d/%d)  test_accuracy: %.2f%%(%d/%d)"
            % (epoch, m["train_loss"],
               m["train_acc"] * 100.0, m["train_correct"], m["train_cnt"],
               m["val_acc"] * 100.0, m["val_correct"], m["val_cnt"],
               m["test_acc"] * 100.0, m["test_correct"], m["test_cnt"]))
