"""Partitioned full-graph training over ``torch.distributed``
(``roc_tpu/parallel/distributed.py``).

The reference's distribution stack, one rank per partition:

- **Graph partition parallelism** (``gnn.cc:471-530``, vertex-range
  index launches): rank p holds partition p of an edge-balanced
  vertex-range split (core/partition.py), padded to the shapes every
  rank shares: its rows of the features, labels and mask, and the
  tables of its rows' in-edges.
- **Halo exchange** (the whole-region feature requirement,
  ``scattergather.cc:70-72``): an all-gather of every rank's
  ``[part_nodes, F]`` block into ``[P * part_nodes, F]`` in padded part
  order, before each aggregation; edge sources are remapped to those
  padded coordinates when the tables are built.
- **Gradient reduction** (per-partition weight-gradient replicas summed,
  ``optimizer_kernel.cu:88-94``): an all-reduce sum of the local
  gradients, after which every rank runs the same Adam update on the
  same replicated weights.
- **Metrics reduction** (``softmax_kernel.cu:41-79``): an all-reduce sum
  of the ``perf_metrics`` sums.

The aggregation on every rank runs the same routes as one device
(models/builder.py): on 'cuda' K1 -> K4 -> K2, on 'cuda_csr' K1 -> K3 ->
K2, with K3/K4 reading ``R = P * part_nodes`` gathered rows and writing
``part_nodes`` rows.

Ported subset: ``halo='gather'`` on one host; the ring halo, the
multi-host loader, the cost-model split and online rebalancing, and the
``(parts, model)`` mesh are not ported.  A torch rank holds no other
part's rows, so :class:`ShardedData` is one part.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
import traceback
from dataclasses import dataclass
from datetime import timedelta
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..core.ell import ell_from_padded_parts
from ..core.graph import MASK_NONE, Dataset
from ..core.partition import (PartitionedGraph, PartitionPlan,
                              partition_col, partition_plan)
from ..models.builder import ELL_IMPLS, AGGR_IMPLS, GraphContext, Model
from ..ops.norm import inv_sqrt_degree
from ..train.trainer import TrainConfig, Trainer

HALOS = ("gather",)

# torch.distributed's one-tensor all-gather: ``all_gather_single`` where
# the installed torch has it (the name that replaces the deprecated one),
# else ``all_gather_into_tensor``; the same collective
_all_gather_single = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor


# ---------------------------------------------------------------- layout


def remap_col_to_padded(plan, col: np.ndarray) -> np.ndarray:
    """Remap one part's column array from global vertex ids to *padded
    row coordinates* (the rows of the all-gathered feature matrix):
    global id g living in part p maps to ``p * part_nodes + (g -
    node_offset[p])``; the dummy source maps to ``num_parts *
    part_nodes``."""
    offsets = np.asarray([l for l, _ in plan.bounds] + [plan.num_nodes],
                         dtype=np.int64)
    col = np.asarray(col, dtype=np.int64)
    dummy = plan.num_parts * plan.part_nodes
    out = np.full(col.shape, dummy, dtype=np.int64)
    real = col < plan.num_nodes
    g = col[real]
    p = np.searchsorted(offsets[1:plan.num_parts + 1], g, side="right")
    out[real] = p * plan.part_nodes + (g - offsets[p])
    if not ((out <= dummy).all() and (out >= 0).all()):
        raise ValueError("column ids outside [0, num_nodes]")
    return out.astype(np.int32)


def remap_to_padded(pg: PartitionedGraph) -> np.ndarray:
    """All-parts form of :func:`remap_col_to_padded` (``[P, E_p]``)."""
    return remap_col_to_padded(pg, pg.part_col_idx)


def _part_rows(arr: np.ndarray, plan: PartitionPlan, p: int,
               fill=0) -> np.ndarray:
    """Part ``p``'s padded rows ``[part_nodes, ...]`` of a global
    per-node array ``[V, ...]``; padding rows get ``fill``."""
    out = np.full((plan.part_nodes,) + arr.shape[1:], fill, dtype=arr.dtype)
    l, r = plan.bounds[p]
    if r >= l:
        out[:r - l + 1] = arr[l:r + 1]
    return out


def pad_nodes(arr: np.ndarray, pg: PartitionPlan,
              fill: float = 0) -> np.ndarray:
    """Scatter a global per-node array ``[V, ...]`` into the stacked
    padded layout ``[P, part_nodes, ...]``; padding rows get ``fill``."""
    return np.stack([_part_rows(arr, pg, p, fill)
                     for p in range(pg.num_parts)])


def unpad_nodes(arr: np.ndarray, pg: PartitionPlan) -> np.ndarray:
    """Inverse of :func:`pad_nodes`: ``[P, part_nodes, ...] -> [V,
    ...]``."""
    parts = []
    for p in range(pg.num_parts):
        l, r = pg.bounds[p]
        if r >= l:
            parts.append(arr[p, :r - l + 1])
    return np.concatenate(parts, axis=0)


def padded_rows_of(plan: PartitionPlan, node_ids) -> np.ndarray:
    """Original vertex ids -> rows of the concatenated padded parts
    (``[P * part_nodes]`` order): part p holds global range
    ``bounds[p]`` from local row 0."""
    ids = np.asarray(node_ids, dtype=np.int64).ravel()
    if ids.size and (ids.min() < 0 or ids.max() >= plan.num_nodes):
        raise ValueError(f"node ids out of range [0, {plan.num_nodes})")
    offs = np.asarray(plan.node_offset, dtype=np.int64)
    part = np.searchsorted(offs, ids, side="right") - 1
    return part * plan.part_nodes + ids - offs[part]


# ----------------------------------------------------------- collectives


class _AllGather(torch.autograd.Function):
    """The halo gather, differentiable: the transpose of an all-gather
    is a reduce-scatter, which sums every rank's cotangent of the
    gathered rows and leaves each rank its own rows (JAX's
    ``all_gather`` transpose)."""

    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        return comm.all_gather(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.reduce_scatter(g), None


class Collectives:
    """This rank's collectives over a ``torch.distributed`` process group
    (``group``; None is the default group), in PyTorch's idiom where the
    JAX package has a mesh and ``shard_map``: the halo all-gather and
    its transpose, the reduce-scatter; the all-reduce sum and the
    broadcast of the initial weights.

    The backend is the group's: ``nccl`` on the card, ``gloo`` on the
    CPU, or ``gloo`` on the card where the caller asked for it (ranks
    sharing one card, which NCCL refuses; gloo takes the CUDA tensors
    and moves them through the host itself).  Every collective runs at
    world size 1 as at any other, with no elision, so a one-rank run
    times them."""

    def __init__(self, group=None):
        if not dist.is_initialized():
            raise RuntimeError("torch.distributed is not initialised: call "
                               "torch.distributed.init_process_group first")
        self.group = group
        self.rank = dist.get_rank(group)
        self.world_size = dist.get_world_size(group)
        self.backend = str(dist.get_backend(group))

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """``[n, ...]`` from every rank -> ``[world_size * n, ...]``, rank
        order."""
        x = x.contiguous()
        out = x.new_empty((self.world_size * x.shape[0],) + x.shape[1:])
        _all_gather_single(out, x, group=self.group)
        return out

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """:meth:`all_gather`, differentiable (the halo hook of
        GraphContext)."""
        return _AllGather.apply(x, self)

    def reduce_scatter(self, x: torch.Tensor) -> torch.Tensor:
        """``[world_size * n, ...]`` summed over the ranks, block ``rank``
        of it ``[n, ...]`` on each rank (the transpose of
        :meth:`all_gather`)."""
        x = x.contiguous()
        out = x.new_empty((x.shape[0] // self.world_size,) + x.shape[1:])
        dist.reduce_scatter_tensor(out, x, op=dist.ReduceOp.SUM,
                                   group=self.group)
        return out

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """Sum over the ranks, in place; returns ``x``."""
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=self.group)
        return x

    def broadcast(self, x: torch.Tensor) -> torch.Tensor:
        """The group's rank 0's ``x`` on every rank, in place; returns
        ``x``."""
        dist.broadcast(x, group=self.group, group_src=0)
        return x


def _flat(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """One fp32 buffer of every tensor's elements, in order."""
    return torch.cat([t.detach().reshape(-1).to(torch.float32)
                      for t in tensors])


def _unflat(buf: torch.Tensor, like: Sequence[torch.Tensor]
            ) -> List[torch.Tensor]:
    out, i = [], 0
    for t in like:
        out.append(buf[i:i + t.numel()].view(t.shape).to(t.dtype))
        i += t.numel()
    return out


# ------------------------------------------------------------- the shard


@dataclass
class ShardedData:
    """One rank's part, on its device.

    feats: ``[part_nodes, F]`` in the compute dtype; labels, mask,
      in_degree: ``[part_nodes]`` (padding rows: label 0, MASK_NONE,
      degree 0).
    ELL routes: ``ell_idx`` int32 ``[rows_b, width_b]`` per bucket in
      gathered coordinates (dummy ``P * part_nodes``), ``ell_row_id``
      ``[rows_b]`` (read by 'cuda'), ``ell_row_pos`` ``[part_nodes]``
      (read by 'ell').
    Edge routes: ``edge_src`` int32 ``[part_edges]`` in gathered
      coordinates (dummy ``P * part_nodes``), ``edge_dst`` the local
      destination rows, sorted (padding edges on the first padded row).
    """
    feats: torch.Tensor
    labels: torch.Tensor
    mask: torch.Tensor
    in_degree: torch.Tensor
    ell_idx: Tuple[torch.Tensor, ...] = ()
    ell_row_pos: Optional[torch.Tensor] = None
    ell_row_id: Tuple[torch.Tensor, ...] = ()
    edge_src: Optional[torch.Tensor] = None
    edge_dst: Optional[torch.Tensor] = None


def shard_dataset(dataset: Dataset, plan: PartitionPlan, rank: int,
                  device, dtype: torch.dtype = torch.float32,
                  aggr_impl: str = "cuda",
                  halo: str = "gather") -> ShardedData:
    """Build part ``rank`` of ``plan`` on ``device``, with the tables of
    ``aggr_impl`` only.  Only this part's columns are read and remapped
    (``partition_col``); its ELL buckets are padded for this part alone,
    so their row counts may be smaller than the all-parts table's
    (``ell_from_padded_parts`` over every part), with the same sums."""
    if halo not in HALOS:
        raise NotImplementedError(f"halo={halo!r} is not ported; the port "
                                  f"runs {HALOS}")
    if aggr_impl not in AGGR_IMPLS:
        raise ValueError(f"aggr_impl {aggr_impl!r} is not ported; "
                         f"expected one of {AGGR_IMPLS}")
    g = dataset.graph
    pn = plan.part_nodes
    dummy = plan.num_parts * pn

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    col = remap_col_to_padded(plan, partition_col(
        plan, lambda e0, e1: g.col_idx[e0:e1], rank))
    tables: Dict[str, Any] = {}
    if aggr_impl in ELL_IMPLS:
        t = ell_from_padded_parts(plan.part_row_ptr[rank:rank + 1],
                                  col[None], plan.real_nodes[rank:rank + 1],
                                  pn, dummy=dummy)
        tables = dict(ell_idx=tuple(dev(a[0]) for a in t.idx),
                      ell_row_pos=dev(t.row_pos[0]),
                      ell_row_id=tuple(dev(a[0]) for a in t.row_id))
    else:
        edge_dst = np.repeat(np.arange(pn, dtype=np.int32),
                             np.diff(plan.part_row_ptr[rank]))
        tables = dict(edge_src=dev(col), edge_dst=dev(edge_dst))
    return ShardedData(
        feats=torch.as_tensor(_part_rows(dataset.features, plan, rank),
                              dtype=dtype).to(device),
        labels=dev(_part_rows(dataset.labels, plan, rank)),
        mask=dev(_part_rows(dataset.mask, plan, rank, fill=MASK_NONE)),
        in_degree=dev(plan.part_in_degree[rank]),
        **tables)


# ------------------------------------------------------------ the trainer


def rank_seed(seed: int, rank: int) -> int:
    """The seed of rank ``rank``'s dropout generator: ``seed`` itself on
    rank 0 (so one rank draws what :class:`Trainer` draws), a
    ``SeedSequence((seed, rank))`` draw on the others."""
    if rank == 0:
        return int(seed)
    return int(np.random.SeedSequence((int(seed), int(rank)))
               .generate_state(1, np.uint64)[0] >> 1)


class DistributedTrainer(Trainer):
    """The reference epoch loop (``gnn.cc:99-111``) with one partition
    per rank of a ``torch.distributed`` process group (``group``; None
    is the default group), whose world size must be ``num_parts``.
    Every rank constructs it and calls each method together: the step,
    ``evaluate`` and ``predict`` run collectives.

    It is :class:`Trainer` on this rank's part: :meth:`_place` builds the
    part and its graph context with the halo gather, :meth:`_reduce` is
    an all-reduce sum, :meth:`predict` gathers every part's logits; the
    step, the epoch loop and the eval are Trainer's.

    - Weights: ``params``, or Glorot weights drawn as :class:`Trainer`
      draws them (a generator seeded with ``config.seed``), then
      broadcast from rank 0; so both trainers start from the same
      weights at the same seed.
    - Dropout: each rank draws its masks from its own generator on its
      device, seeded with :func:`rank_seed` (``config.seed`` and the
      rank).  This stands where the JAX package folds the partition index
      into the step key; the draws differ from JAX's.
    - A step: the part's summed masked CE and its gradients, one
      all-reduce sum of the gradients and the objective (one fp32
      buffer), then the same Adam update on every rank.
    - ``evaluate`` all-reduces the ``perf_metrics`` sums in one
      collective; the ``[INFER]`` line prints on rank 0 only.
    - ``predict`` all-gathers the logits into original vertex order.
    - Checkpoints (utils/checkpoint.py): every rank calls the save and
      rank 0 writes (the weights and Adam state are replicated); the
      generators' states are all-gathered so each rank's row is saved;
      the fingerprint's elastic half records ``num_parts`` and the
      plan's part shapes, so a checkpoint written at P parts restores at
      any P.  The recovery rotation's ``restore_latest`` picks the epoch
      on rank 0 and broadcasts it (:meth:`agree`).

    ``device`` is the card unless the caller passes another (``'cpu'``);
    on the card it is this rank's card (``cuda:<local rank>``, chosen by
    the caller)."""

    def __init__(self, model: Model, dataset: Dataset, num_parts: int,
                 config: TrainConfig = TrainConfig(),
                 params: Optional[Dict[str, torch.Tensor]] = None,
                 device=None, group=None):
        self.comm = Collectives(group)
        if self.comm.world_size != num_parts:
            raise ValueError(f"num_parts={num_parts} but the process group "
                             f"has {self.comm.world_size} ranks (one "
                             f"partition per rank)")
        self.rank = self.comm.rank
        super().__init__(model, dataset, dataclasses.replace(
            config, verbose=config.verbose and self.rank == 0),
            params=params, device=device)
        names = list(self.params)
        with torch.no_grad():
            flat = self.comm.broadcast(_flat([self.params[k]
                                              for k in names]))
            for k, v in zip(names, _unflat(flat, [self.params[k]
                                                  for k in names])):
                self.params[k].copy_(v)
        # rank 0 goes on drawing from Trainer's generator
        if self.rank != 0:
            self.generator = torch.Generator(device=self.device).manual_seed(
                rank_seed(config.seed, self.rank))

    def _place(self, dataset: Dataset, symmetric: bool) -> None:
        """This rank's part of the edge-balanced plan (``plan``, ``data``)
        and its graph context, whose aggregations read the halo
        all-gather of every part's rows."""
        cfg = self.config
        self.plan = partition_plan(dataset.graph.row_ptr, self.comm.world_size,
                                   edge_multiple=cfg.chunk)
        self.data = d = shard_dataset(dataset, self.plan, self.rank,
                                      self.device, dtype=self.compute,
                                      aggr_impl=cfg.aggr_impl)
        self.feats, self.labels, self.mask = d.feats, d.labels, d.mask
        self.gctx = GraphContext(
            in_degree=d.in_degree, inv_sqrt_deg=inv_sqrt_degree(d.in_degree),
            num_rows=self.plan.part_nodes, ell_idx=d.ell_idx,
            ell_row_pos=d.ell_row_pos, ell_row_id=d.ell_row_id,
            aggr_impl=cfg.aggr_impl, symmetric=symmetric,
            edge_src=d.edge_src, edge_dst=d.edge_dst, chunk=cfg.chunk,
            gather_features=self.comm.gather,
            gathered_rows=self.plan.padded_num_nodes)

    def _reduce(self, tensors: List[torch.Tensor]) -> List[torch.Tensor]:
        """Every rank's ``tensors`` summed, in one all-reduce of one fp32
        buffer."""
        return _unflat(self.comm.all_reduce(_flat(tensors)), tensors)

    def rng_states(self) -> np.ndarray:
        """Every rank's dropout generator state, ``[P, n]`` uint8, in rank
        order (one all-gather; every rank calls it)."""
        mine = self.generator.get_state().to(self.device)
        return self.comm.all_gather(mine[None]).cpu().numpy()

    def agree(self, value: Optional[int]) -> Optional[int]:
        """Rank 0's ``value`` (an epoch, or None) on every rank: one
        broadcast."""
        t = torch.tensor([-1 if value is None else int(value)],
                         dtype=torch.int64, device=self.device)
        v = int(self.comm.broadcast(t).item())
        return None if v < 0 else v

    @torch.no_grad()
    def predict(self, node_ids=None) -> torch.Tensor:
        """Inference-mode logits ``[V, C]`` in original vertex order, or
        the rows ``node_ids`` of them, on every rank: one all-gather of
        the parts' logits."""
        full = self.comm.all_gather(self._logits())
        ids = np.arange(self.plan.num_nodes) if node_ids is None \
            else node_ids
        rows = torch.from_numpy(padded_rows_of(self.plan, ids))
        return full.index_select(0, rows.to(full.device))


# ------------------------------------------------------- ranks on one host


def _rank_main(rank: int, world_size: int, backend: str, init_method: str,
               timeout_s: float, job: Callable, kwargs: dict, queue) -> None:
    try:
        dist.init_process_group(backend, init_method=init_method,
                                world_size=world_size, rank=rank,
                                timeout=timedelta(seconds=timeout_s))
        try:
            queue.put((rank, True, job(**kwargs)))
        finally:
            dist.destroy_process_group()
    except BaseException:
        queue.put((rank, False, traceback.format_exc()))
        raise


def run_ranks(job: Callable, world_size: int, backend: str = "gloo",
              timeout_s: float = 600.0, **kwargs) -> List[Any]:
    """Run ``job(**kwargs)`` on ``world_size`` fresh processes of this
    host, each a rank of a new default process group (``backend``, a file
    store in a temporary directory), and return their results by rank.
    The processes are spawned (``torch.multiprocessing``, 'spawn'), so a
    caller that has initialised CUDA can start them, and they import
    only what unpickling ``job`` and ``kwargs`` imports.  Raises if a rank
    raised, with its traceback; every process is joined or killed before
    it returns."""
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        init = "file://" + os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main,
                             args=(r, world_size, backend, init, timeout_s,
                                   job, kwargs, queue))
                 for r in range(world_size)]
        for p in procs:
            p.start()
        results: Dict[int, Tuple[bool, Any]] = {}
        try:
            for _ in procs:
                rank, ok, value = queue.get(timeout=timeout_s)
                results[rank] = (ok, value)
                if not ok:
                    break
        finally:
            for p in procs:
                p.join(timeout=30 if len(results) == world_size else 1)
                if p.is_alive():
                    p.kill()
                    p.join()
    failed = [f"rank {r}:\n{v}" for r, (ok, v) in sorted(results.items())
              if not ok]
    if failed or len(results) < world_size:
        raise RuntimeError("a rank failed:\n" + "\n".join(failed))
    return [results[r][1] for r in range(world_size)]


def train_job(runs: Sequence[dict], device=None) -> List[dict]:
    """One rank's part of partitioned training runs, for
    :func:`run_ranks`: for each run ``dict(model=, dataset=, config=,
    params=None, epochs=None, node_ids=None, grads=False,
    checkpoint=None)`` a
    :class:`DistributedTrainer` over the default group (world size ==
    parts) on ``device``, the card unless the caller passes another
    (``'cpu'``).  Returns,
    per run, numpy arrays: ``history`` (the eval records), ``losses``
    (each step's objective), ``params`` after training, ``logits``
    (:meth:`~DistributedTrainer.predict`), ``rows`` (``predict(node_ids)``,
    given ``node_ids``), the plan's ``bounds`` and, given ``grads``,
    ``grads``: the all-reduced gradients before the first step (dropout
    0 draws nothing).  Given ``checkpoint``, the state after training is
    saved there (utils/checkpoint.py ``checkpoint_trainer``)."""
    out = []
    for run in runs:
        tr = DistributedTrainer(run["model"], run["dataset"],
                                dist.get_world_size(), run["config"],
                                params=run.get("params"), device=device)
        rec: Dict[str, Any] = {"bounds": tr.plan.bounds}
        if run.get("grads"):
            _, grads = tr.loss_and_grads()
            rec["grads"] = {k: v.float().cpu().numpy()
                            for k, v in grads.items()}
        rec["history"] = tr.train(run.get("epochs"))
        if run.get("checkpoint"):
            from ..utils.checkpoint import checkpoint_trainer
            checkpoint_trainer(tr, run["checkpoint"])
        rec["losses"] = torch.stack(tr.losses).double().cpu().numpy()
        rec["params"] = {k: v.detach().float().cpu().numpy()
                         for k, v in tr.params.items()}
        rec["logits"] = tr.predict().float().cpu().numpy()
        if run.get("node_ids") is not None:
            rec["rows"] = tr.predict(run["node_ids"]).float().cpu().numpy()
        out.append(rec)
    return out
