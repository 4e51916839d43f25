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
- **The ring halo** (``halo='ring'``, parallel/ring.py): instead of the
  all-gather, one part's rows rotate around the ranks, point to point,
  while each rank sums the edges from the part it holds; O(V/P) rows a
  rank.  The memory autopilot picks it at P > 1 when the gather does not
  fit.
- **Cost-model partitioning** (core/costmodel.py, the reference's
  headline idea): the split minimises the modeled cost of the largest
  part (``partition='cost'``, the default through 'auto'), and with
  ``rebalance`` the model is refit to measured epoch times at each eval
  and the graph repartitioned between epochs when the predicted gain
  passes a threshold (:meth:`DistributedTrainer.maybe_rebalance`).

The aggregation on every rank runs the same routes as one device
(models/builder.py): on 'cuda' K1 -> K4 -> K2, on 'cuda_csr' K1 -> K3 ->
K2, with K3/K4 reading ``R = P * part_nodes`` gathered rows and writing
``part_nodes`` rows; the layouts ('sectioned', 'flat_sum', 'bdense',
'attn_flat8') index the gathered rows too, and 'auto' resolves with a
part's rows (train/trainer.py ``resolve_config``).  On the ring, K1 -> K3
at each hop -> K2 on the kernel routes.

The step is :class:`Trainer`'s, rematerialisation (``remat``) included.
``features='host'`` is single-device, as in the JAX package.  A torch
rank holds no other part's rows, so :class:`ShardedData` is one part;
where the JAX package pads every part to one shape, a rank agrees on the
shapes it must share with one collective (the ring's ``pair_edges``, the
sectioned chunk plans, the block-dense A-table's packing).  A rank may
build its part from a ``DataSource`` (core/source.py; parallel/
multihost.py ``shard_dataset_local``) and so never hold the whole graph,
and the ``(parts, model)`` mesh keeps the params and Adam moments
sharded over a part's model ranks at rest (:class:`DistributedTrainer`).
The mesh's model ranks each run their part's whole 1-D step: the hidden
width is not split across them (the JAX package's GSPMD may split it on
its gather path).
"""

from __future__ import annotations

import contextlib
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

from ..core.ell import (default_section_rows, ell_from_padded_parts,
                        flat_sum_from_padded_parts,
                        sectioned_from_padded_parts)
from ..core.graph import MASK_NONE
from ..core.partition import (PartitionedGraph, PartitionPlan,
                              partition_col, partition_plan,
                              plan_from_bounds)
from ..models.builder import (AGGR_IMPLS, EDGE_IMPLS, ELL_IMPLS, HALOS,
                              KERNEL_IMPLS, GraphContext, Model)
from ..obs.events import emit
from ..ops.norm import inv_sqrt_degree, inv_sqrt_degree_np
from ..train.trainer import (TrainConfig, Trainer, layout_options,
                             resolve_head_chunk, resolve_mesh,
                             resolve_partition)

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
    col = np.asarray(col)
    dummy = plan.num_parts * plan.part_nodes
    if col.size and (int(col.min()) < 0 or int(col.max()) > plan.num_nodes):
        raise ValueError("column ids outside [0, num_nodes]")
    # per source id (and the dummy id num_nodes), the shift to its padded
    # row: an id of part p moves by p * part_nodes - node_offset[p]
    offsets = np.asarray([l for l, _ in plan.bounds] + [plan.num_nodes],
                         dtype=np.int64)
    p = np.searchsorted(offsets[1:plan.num_parts + 1],
                        np.arange(plan.num_nodes, dtype=np.int64),
                        side="right")
    shift = np.append(p * plan.part_nodes - offsets[p],
                      dummy - plan.num_nodes).astype(np.int32)
    out = col.astype(np.int32, copy=False) + shift[col]
    if out.size and (int(out.min()) < 0 or int(out.max()) > dummy):
        raise ValueError("column ids outside [0, num_nodes]")
    return out


def remap_to_padded(pg: PartitionedGraph) -> np.ndarray:
    """All-parts form of :func:`remap_col_to_padded` (``[P, E_p]``)."""
    return remap_col_to_padded(pg, pg.part_col_idx)


def _part_rows(get: Callable[[int, int], np.ndarray], plan: PartitionPlan,
               p: int, fill, dtype, extra: Tuple[int, ...] = ()
               ) -> np.ndarray:
    """Part ``p``'s padded rows ``[part_nodes, *extra]`` of a per-node
    field, its real rows read as ``get(lo, hi)`` (a slice of a global
    array, or a DataSource's accessor); padding rows get ``fill``."""
    out = np.full((plan.part_nodes,) + tuple(extra), fill, dtype=dtype)
    l, r = plan.bounds[p]
    if r >= l:
        out[:r - l + 1] = get(l, r + 1)
    return out


def pad_nodes(arr: np.ndarray, pg: PartitionPlan,
              fill: float = 0) -> np.ndarray:
    """Scatter a global per-node array ``[V, ...]`` into the stacked
    padded layout ``[P, part_nodes, ...]``; padding rows get ``fill``."""
    return np.stack([_part_rows(lambda lo, hi: arr[lo:hi], pg, p, fill,
                                arr.dtype, arr.shape[1:])
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


# the collective lint's recorder (analysis/collective_lint.py): while a
# list is set (:func:`record_collectives`), every Collectives call of this
# process appends one record to it
_recording: Optional[List[Dict[str, Any]]] = None


@contextlib.contextmanager
def record_collectives():
    """Record every :class:`Collectives` call of this process inside the
    block, in order: ``kind`` ('all_gather', 'reduce_scatter',
    'all_reduce', 'broadcast', 'ring_shift'), ``op`` (the reduction),
    ``group`` (the group's name: 'world', 'parts', 'model'), ``members``
    (its global ranks), ``rank`` and ``size`` in it, the operand's
    ``shape`` and ``dtype``, and for a ring shift its peers ``to`` and
    ``frm`` and its ``shift`` (group ranks).  Yields the list."""
    global _recording
    prev, _recording = _recording, []
    try:
        yield _recording
    finally:
        _recording = prev


def world_rank() -> int:
    """This process's rank in the default process group."""
    return dist.get_rank()


def new_group(ranks: Sequence[int]):
    """A process group of ``ranks`` (global ranks); every rank of the
    default group calls it, members or not."""
    return dist.new_group(list(ranks))


class Collectives:
    """This rank's collectives over a ``torch.distributed`` process group
    (``group``; None is the default group), in PyTorch's idiom where the
    JAX package has a mesh and ``shard_map``: the halo all-gather and
    its transpose, the reduce-scatter; the ring's point-to-point shift;
    the all-reduce (sum, or the max a rank agrees on shapes with) and
    the broadcast of the initial weights.

    The backend is the group's: ``nccl`` on the card, ``gloo`` on the
    CPU, or ``gloo`` on the card where the caller asked for it (ranks
    sharing one card, which NCCL refuses; gloo takes the CUDA tensors of
    a collective and moves them through the host itself, and
    :meth:`ring_shift` stages its own).  Every collective runs at
    world size 1 as at any other, with no elision, so a one-rank run
    times them."""

    def __init__(self, group=None, name: str = "world"):
        if not dist.is_initialized():
            raise RuntimeError("torch.distributed is not initialised: call "
                               "torch.distributed.init_process_group first")
        self.group = group
        # the mesh axis the group is (the collective lint's vocabulary):
        # 'parts', 'model', or 'world' for the whole default group
        self.name = name
        self.rank = dist.get_rank(group)
        self.world_size = dist.get_world_size(group)
        self.backend = str(dist.get_backend(group))

    def _note(self, kind: str, x: torch.Tensor, **extra: Any) -> None:
        """One record for :func:`record_collectives`, when it records."""
        if _recording is None:
            return
        members = (list(range(dist.get_world_size())) if self.group is None
                   else list(dist.get_process_group_ranks(self.group)))
        _recording.append({"kind": kind, "group": self.name,
                           "members": members, "rank": self.rank,
                           "size": self.world_size,
                           "shape": list(x.shape),
                           "dtype": str(x.dtype).replace("torch.", ""),
                           **extra})

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """``[n, ...]`` from every rank -> ``[world_size * n, ...]``, rank
        order."""
        x = x.contiguous()
        self._note("all_gather", x)
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
        self._note("reduce_scatter", x, op="sum")
        out = x.new_empty((x.shape[0] // self.world_size,) + x.shape[1:])
        dist.reduce_scatter_tensor(out, x, op=dist.ReduceOp.SUM,
                                   group=self.group)
        return out

    def all_reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """Sum (or ``op='max'``) over the ranks, in place; returns ``x``."""
        self._note("all_reduce", x, op="max" if op == "max" else "sum")
        dist.all_reduce(x, op=dist.ReduceOp.MAX if op == "max"
                        else dist.ReduceOp.SUM, group=self.group)
        return x

    def _host_device(self) -> torch.device:
        """Where a host value crosses: the CPU on gloo, this rank's card
        on NCCL."""
        if self.backend == "gloo":
            return torch.device("cpu")
        return torch.device("cuda", torch.cuda.current_device())

    def agree_max(self, v: np.ndarray) -> np.ndarray:
        """The elementwise max of an int64 vector over the ranks (one
        all-reduce): how a rank agrees with the others on a shape every
        part's tables share."""
        t = torch.from_numpy(np.ascontiguousarray(v, dtype=np.int64))
        return self.all_reduce(t.to(self._host_device()), "max").cpu() \
            .numpy()

    def broadcast_float(self, value: Optional[float]) -> Optional[float]:
        """Rank 0's ``value`` (a float or None) on every rank."""
        t = torch.tensor([np.nan if value is None else float(value)],
                         dtype=torch.float64, device=self._host_device())
        v = float(self.broadcast(t).item())
        return None if np.isnan(v) else v

    def _peer(self, group_rank: int) -> int:
        return group_rank if self.group is None else \
            dist.get_global_rank(self.group, group_rank)

    def ring_shift(self, x: torch.Tensor, shift: int = 1) -> "_Shift":
        """Start sending ``x`` to rank ``rank + shift`` and receiving the
        same shape from rank ``rank - shift`` (mod the world size), point
        to point (``batch_isend_irecv``); ``.wait()`` on the result
        returns what arrived.  On NCCL the card's tensors move device to
        device.  Gloo's send and receive take host memory, so a tensor on
        the card goes through pinned host buffers: copied down before the
        send, copied up after the receive (gloo stages its collectives the
        same way)."""
        n = self.world_size
        to, frm = self._peer((self.rank + shift) % n), \
            self._peer((self.rank - shift) % n)
        x = x.contiguous()
        self._note("ring_shift", x, to=(self.rank + shift) % n,
                   frm=(self.rank - shift) % n, shift=int(shift) % n)
        up = None
        if self.backend == "gloo" and x.is_cuda:
            up = x.device
            send = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            send.copy_(x)
            recv = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        else:
            send, recv = x, torch.empty_like(x)
        works = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, send, to, self.group),
            dist.P2POp(dist.irecv, recv, frm, self.group)])
        return _Shift(works, send, recv, up)

    def broadcast(self, x: torch.Tensor) -> torch.Tensor:
        """The group's rank 0's ``x`` on every rank, in place; returns
        ``x``."""
        self._note("broadcast", x)
        dist.broadcast(x, group=self.group, group_src=0)
        return x


class _Shift:
    """A started :meth:`Collectives.ring_shift` (it holds the send buffer
    until the transfer ends)."""

    def __init__(self, works, send, recv, up):
        self.works, self._send, self.recv, self.up = works, send, recv, up

    def wait(self) -> torch.Tensor:
        for w in self.works:
            w.wait()
        self._send = None
        if self.up is not None:
            return self.recv.to(self.up, non_blocking=True)
        return self.recv


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
      ``[rows_b]`` (read by K4 on 'cuda', padding rows ``part_nodes``)
      and ``ell_row_pos`` ``[part_nodes]`` (read by the plain sum); both
      routes carry both, since the MAX and the attention of either read
      ``row_pos`` and attention reads ``row_id``; ``ell_edges`` the real
      ids of each bucket (host ints, K4's work tally).
    Edge routes: ``edge_src`` int32 ``[part_edges]`` in gathered
      coordinates (dummy ``P * part_nodes``), ``edge_dst`` the local
      destination rows, sorted (padding edges on the first padded row).
    Layouts (the rank's row of the JAX package's stacked tables, in
      gathered coordinates): ``sect_*`` the sectioned tables ('sectioned',
      and 'bdense''s residual), ``flat8_*`` the flat ones ('flat_sum',
      'attn_flat8'), ``bd_*`` the rectangular block-dense plan (dst rows
      ``part_nodes``, source tiles over the gathered rows) with
      ``bd_occupancy`` its plan's record; ``*_w`` and ``bd_scale`` the
      baked fused weights.
    The ring (``halo='ring'``; no other table is built): ``ring_src``,
    ``ring_dst`` int32 ``[S, pair_edges]`` (no ``ring_dst`` on the
    kernel routes, whose K3 reads the row ranges alone), ``ring_row_ptr``
    int64 ``[S, part_nodes + 1]``, ``ring_real`` each pair's real edges
    (host),
    ``ring_w`` the baked fused weights (plain routes), ``pair_edges`` and
    ``ring_padding_ratio`` (padded slots over real edges, every part).
    ``halo_read``: bool ``[V]`` (host), the rows outside the part that
    its edges read (core/costmodel.py ``part_halo_read``), the part's
    share of the split's quality record.
    """
    feats: torch.Tensor
    labels: torch.Tensor
    mask: torch.Tensor
    in_degree: torch.Tensor
    ell_idx: Tuple[torch.Tensor, ...] = ()
    ell_row_pos: Optional[torch.Tensor] = None
    ell_row_id: Tuple[torch.Tensor, ...] = ()
    ell_edges: Tuple[int, ...] = ()
    edge_src: Optional[torch.Tensor] = None
    edge_dst: Optional[torch.Tensor] = None
    sect_idx: Tuple[torch.Tensor, ...] = ()
    sect_sub_dst: Tuple[torch.Tensor, ...] = ()
    sect_meta: Tuple[Tuple[int, int], ...] = ()
    sect_w: Tuple[torch.Tensor, ...] = ()
    flat8_idx: Optional[torch.Tensor] = None
    flat8_dst: Optional[torch.Tensor] = None
    flat8_w: Optional[torch.Tensor] = None
    bd_a: Optional[torch.Tensor] = None
    bd_src: Optional[torch.Tensor] = None
    bd_dst: Optional[torch.Tensor] = None
    bd_vpad: int = 0
    bd_src_vpad: int = 0
    bd_group: int = 1
    bd_scale: Tuple[torch.Tensor, ...] = ()
    bd_occupancy: Optional[dict] = None
    ring_src: Optional[torch.Tensor] = None
    ring_dst: Optional[torch.Tensor] = None
    ring_row_ptr: Optional[torch.Tensor] = None
    ring_real: Optional[np.ndarray] = None
    ring_w: Optional[torch.Tensor] = None
    pair_edges: int = 0
    ring_padding_ratio: Optional[float] = None
    halo_read: Optional[np.ndarray] = None

    def context_tables(self) -> Dict[str, Any]:
        """The GraphContext keywords of these tables."""
        names = ("ell_idx", "ell_row_pos", "ell_row_id", "ell_edges",
                 "edge_src", "edge_dst", "sect_idx", "sect_sub_dst",
                 "sect_meta",
                 "sect_w", "flat8_idx", "flat8_dst", "flat8_w", "bd_a",
                 "bd_src", "bd_dst", "bd_vpad", "bd_src_vpad", "bd_group",
                 "bd_scale", "ring_src", "ring_dst", "ring_row_ptr",
                 "ring_w")
        return {k: getattr(self, k) for k in names}


def _sectioned(ptr, col, real_nodes, plan, dev, sect_sub_w, sect_u16,
               fuse_d, agree_max):
    """This rank's sectioned tables over the gathered rows: its row of
    ``sectioned_from_padded_parts`` over every part (``agree_max`` gives
    it the shared chunk plan), ids narrowed to uint16 on ``sect_u16``,
    with the baked fused weights given ``fuse_d = (d_dst [1, part_nodes],
    d_src [P * part_nodes])``."""
    sect = sectioned_from_padded_parts(
        ptr[None], col[None], np.asarray([real_nodes]), plan.part_nodes,
        src_rows=plan.padded_num_nodes,
        section_rows=default_section_rows(sect_u16), sub_w=sect_sub_w,
        agree_max=agree_max)
    if sect_u16:
        sect = sect.with_idx_dtype(np.uint16)
    out = dict(sect_idx=tuple(dev(a[0]) for a in sect.idx),
               sect_sub_dst=tuple(dev(a[0]) for a in sect.sub_dst),
               sect_meta=sect.meta)
    if fuse_d is not None:
        out["sect_w"] = tuple(dev(w[0]) for w in
                              sect.weight_tables(*fuse_d))
    return out


def _bdense(ptr, col, plan, dev, min_fill, a_budget, group, fuse_d,
            agree_max):
    """This rank's block-dense plan over the rectangular tile space
    (``part_nodes`` dst rows, ``P * part_nodes`` gathered source rows), the
    JAX package's u4 rule decided across the ranks with one collective
    (plan against twice the budget; pack when every rank's plan packs,
    else plan again at the budget when a rank is over it), and the
    plan's record.  Returns ``(tables, residual row_ptr, residual
    col)``."""
    from ..ops.blockdense import U4_MAX, pack_a_u4, plan_blocks
    src_rows = plan.padded_num_nodes

    def mk(budget):
        return plan_blocks(ptr, col, plan.part_nodes, min_fill=min_fill,
                           a_budget_bytes=budget, num_cols=src_rows,
                           group=group)

    pl = mk(a_budget * 2 if a_budget is not None else None)
    unpackable = bool(pl.n_blocks and int(pl.a_blocks.max()) > U4_MAX)
    over = a_budget is not None and pl.a_blocks.nbytes > a_budget
    flags = np.array([unpackable, over], dtype=np.int64)
    if agree_max is not None:
        flags = agree_max(flags)
    if not flags[0]:
        pl = pack_a_u4(pl)
    elif flags[1]:
        pl = mk(a_budget)
    tables: Dict[str, Any] = dict(bd_occupancy=pl.occupancy(),
                                  bd_group=group)
    if pl.n_blocks:
        tables.update(bd_a=dev(pl.a_blocks), bd_src=dev(pl.src_blk),
                      bd_dst=dev(pl.dst_blk), bd_vpad=pl.vpad,
                      bd_src_vpad=pl.src_vpad)
    if fuse_d is not None:
        dd = np.zeros(pl.vpad, np.float32)
        dd[:plan.part_nodes] = fuse_d[0][0]
        ds = np.zeros(pl.src_vpad, np.float32)
        ds[:src_rows] = fuse_d[1]
        tables.update(bd_scale=(dev(dd), dev(ds)), bd_vpad=pl.vpad,
                      bd_src_vpad=pl.src_vpad)
    return tables, pl.res_row_ptr, pl.res_col


def shard_dataset(dataset, plan: PartitionPlan, rank: int,
                  device, dtype: torch.dtype = torch.float32,
                  aggr_impl: str = "cuda", halo: str = "gather",
                  fuse: bool = False, agree_max=None,
                  sect_sub_w: int = 8, sect_u16: bool = False,
                  bdense_min_fill: int = 64,
                  bdense_a_budget: Optional[int] = 2 << 30,
                  bdense_group: int = 1) -> ShardedData:
    """Build part ``rank`` of ``plan`` on ``device``, with the tables of
    ``aggr_impl`` only, or the ring's alone for ``halo='ring'``.
    ``dataset`` is a :class:`Dataset` or any ``DataSource``
    (core/source.py; a ``FileSource`` reads the reference's files): only
    this part's rows and columns are read (``partition_col``), besides
    the O(V) row pointer the plan came from.

    Its ELL buckets are padded for this part alone, so their row counts
    may be smaller than the all-parts table's (``ell_from_padded_parts``
    over every part), with the same sums.  The layouts and the ring need
    shapes that every part shares: ``agree_max`` (``Collectives.
    agree_max``, one collective each; None for a world of one) gives the
    rank its row of the JAX package's stacked tables.  ``fuse`` bakes the
    fused normalization into the layouts' tables and, on the plain
    routes, the ring's (``ring_w``); the layout keywords are
    ``TrainConfig``'s.  On the kernel routes the ring uploads no
    ``ring_dst``: K3 reads each pair's row ranges (``ring_row_ptr``)."""
    from ..core.source import as_source
    if aggr_impl not in AGGR_IMPLS:
        raise ValueError(f"aggr_impl {aggr_impl!r} is not a route; "
                         f"expected one of {AGGR_IMPLS} ('auto' is "
                         "resolved by resolve_config)")
    if halo not in HALOS:
        raise ValueError(f"unknown halo {halo!r}; expected one of {HALOS}")
    src = as_source(dataset)
    pn = plan.part_nodes
    dummy = plan.padded_num_nodes

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    from ..core.costmodel import part_halo_read
    col_global = partition_col(plan, src.col_slice, rank)
    tables: Dict[str, Any] = dict(
        halo_read=part_halo_read(plan, rank, col_global))
    fuse_d = None
    if fuse:
        d_parts = inv_sqrt_degree_np(plan.part_in_degree)
        fuse_d = (d_parts[rank:rank + 1], d_parts.reshape(-1))
    if halo == "ring":
        from .ring import ring_part_tables, ring_weight_part
        rt = ring_part_tables(plan, rank, col_global, agree_max)
        kernel = aggr_impl in KERNEL_IMPLS
        tables.update(ring_src=dev(rt["src"]),
                      ring_dst=None if kernel else dev(rt["dst"]),
                      ring_row_ptr=dev(rt["row_ptr"]), ring_real=rt["real"],
                      pair_edges=rt["pair_edges"],
                      ring_padding_ratio=rt["padding_ratio"])
        if fuse and not kernel:
            tables["ring_w"] = dev(ring_weight_part(
                plan, rank, rt["src"], rt["dst"],
                inv_sqrt_degree_np(
                    np.diff(src.row_ptr()).astype(np.int32))))
    else:
        col = remap_col_to_padded(plan, col_global)
        ptr = plan.part_row_ptr[rank]
        n_real = int(plan.real_nodes[rank])
        if aggr_impl in ELL_IMPLS:
            t = ell_from_padded_parts(ptr[None], col[None],
                                      plan.real_nodes[rank:rank + 1], pn,
                                      dummy=dummy)
            tables.update(ell_idx=tuple(dev(a[0]) for a in t.idx),
                          ell_row_pos=dev(t.row_pos[0]),
                          ell_row_id=tuple(dev(a[0]) for a in t.row_id),
                          ell_edges=tuple(int(np.count_nonzero(a[0] != dummy))
                                          for a in t.idx))
        elif aggr_impl == "sectioned":
            tables.update(_sectioned(ptr, col, n_real, plan, dev,
                                     sect_sub_w, sect_u16, fuse_d,
                                     agree_max))
        elif aggr_impl in ("flat_sum", "attn_flat8"):
            flat = flat_sum_from_padded_parts(
                ptr[None], col[None], plan.real_nodes[rank:rank + 1], pn,
                src_rows=dummy, agree_max=agree_max)
            tables.update(flat8_idx=dev(flat.idx[0][0]),
                          flat8_dst=dev(flat.sub_dst[0][0]))
            if fuse_d is not None and aggr_impl == "flat_sum":
                tables["flat8_w"] = dev(flat.weight_tables(*fuse_d)[0][0])
        elif aggr_impl == "bdense":
            from ..core.ell import clean_part_ptr
            cptr = clean_part_ptr(ptr, n_real, pn)
            bd_tables, res_ptr, res_col = _bdense(
                cptr, col[:int(cptr[-1])], plan, dev, bdense_min_fill,
                bdense_a_budget, bdense_group, fuse_d, agree_max)
            tables.update(bd_tables)
            tables.update(_sectioned(res_ptr, res_col, n_real, plan, dev,
                                     sect_sub_w, sect_u16, fuse_d,
                                     agree_max))
        else:
            edge_dst = np.repeat(np.arange(pn, dtype=np.int32),
                                 np.diff(ptr))
            tables.update(edge_src=dev(col), edge_dst=dev(edge_dst))
    return ShardedData(
        feats=torch.as_tensor(_part_rows(src.features, plan, rank, 0,
                                         np.float32, (src.in_dim,)),
                              dtype=dtype).to(device),
        labels=dev(_part_rows(src.labels, plan, rank, 0, np.int32)),
        mask=dev(_part_rows(src.mask, plan, rank, MASK_NONE, np.int32)),
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
    is the default group), whose world size must be ``num_parts``, or
    ``P * M`` on the ``(parts, model)`` mesh (``config.mesh='PxM'``, P
    the ``num_parts``).  Every rank constructs it and calls each method
    together: the step, ``evaluate`` and ``predict`` run collectives.

    It is :class:`Trainer` on this rank's part: :meth:`_place` builds the
    part and its graph context with the halo (the gather, or the ring),
    :meth:`_reduce` is an all-reduce sum, :meth:`predict` gathers every
    part's logits; the step, the epoch loop and the eval are Trainer's.

    - The split: ``config.partition`` (:func:`~roc_tpu_torch.train.
      trainer.resolve_partition`; 'auto' is the cost model's) with the
      cost model's search weights; a ``costmodel`` event records its
      quality (:meth:`_emit_partition_stats`; each rank counts its own
      part's halo, one collective joins them) and the run manifest
      carries it (``partition``, obs/manifest.py; each rank emits its
      own, stamped with its rank), and each eval record
      carries the predicted straggler (:meth:`straggler_fields`).  With
      ``config.rebalance``, :meth:`maybe_rebalance` refits the model at
      each eval and repartitions (:meth:`_repartition`); rank 0's
      measured time decides, broadcast to every rank, so every rank
      decides alike.
    - The ring (``config.halo='ring'``): a ``plan`` event gives P,
      ``pair_edges``, ``padding_ratio`` and the overlap, as the JAX
      package's does.
    - Partition-local data (the JAX package's ``data=``/``pg=``):
      ``dataset`` may be a ``DataSource`` (core/source.py, e.g. a
      ``FileSource`` over the reference's files) instead of a Dataset.
      The trainer then reads of it only what a rank needs: the counts,
      the O(V) row pointer (the split, and the rebalancer's searches) and
      its own part's rows and columns (parallel/multihost.py
      ``shard_dataset_local``), so no rank holds the whole graph;
      ``config.symmetric`` must be stated (checking it reads every
      column) and 'auto' skips the block-dense probe.  ``data`` injects
      this rank's tables built by the caller (``shard_dataset_local``)
      from ``plan``, which must come with them; the tables must be those
      of the resolved ``aggr_impl`` and halo, and ``rebalance`` cannot
      rebuild them (each raises, as the JAX package's trainer does).

    - Weights: ``params``, or Glorot weights drawn as :class:`Trainer`
      draws them (a generator seeded with ``config.seed``), then
      broadcast from the part group's first rank; so both trainers start
      from the same weights at the same seed.
    - Dropout: each rank draws its masks from its own generator on its
      device, seeded with :func:`rank_seed` (``config.seed`` and the
      part index).  This stands where the JAX package folds the partition
      index into the step key; the draws differ from JAX's.
    - A step: the part's summed masked CE and its gradients (under
      ``remat`` with the activations recomputed in the backward), one
      all-reduce sum of the gradients and the objective (one fp32
      buffer), then the same Adam update on every rank.
    - The ``(parts, model)`` mesh (``config.mesh='PxM'``,
      :class:`~roc_tpu_torch.parallel.RankMesh`): rank ``p * M + m``
      holds part p.  Every rank creates the parts groups ``{p * M + m}``
      (one per m) and the model groups ``{p * M, ..., p * M + M - 1}``
      (one per p), in that order.  At rest a rank keeps, of every param
      and Adam moment, its slice along ``parallel.model_shard_spec``'s
      dimension (a leaf that no dimension divides stays whole).  A step
      gathers the whole params in the model group (one flat all-gather),
      runs the 1-D step of its part over its parts group (the halo, the
      ring and the gradient all-reduce in the 1-D order), and updates its
      slice alone (Adam is elementwise).  Dropout is seeded by the part,
      so a P x M run draws what the 1-D run of P parts draws, and the
      metrics and logits reduce over the parts group.
    - ``evaluate`` all-reduces the ``perf_metrics`` sums in one
      collective; the ``[INFER]`` line prints on rank 0 only.
    - ``predict`` all-gathers the logits into original vertex order.
    - Checkpoints (utils/checkpoint.py): every rank calls the save; rank
      0 writes whole leaves (on the 1-D mesh, every leaf: the weights and
      Adam state are replicated) and, on a 2-D mesh, the ranks of part
      0's model row each write their slices, committed with an
      un-commit barrier and a commit barrier over a gloo group made at
      setup for them alone (the saver thread never shares a group with
      the step).  The generators' states are all-gathered so each part's
      row is saved; the fingerprint's elastic half records ``num_parts``,
      the plan's part shapes and the mesh, so a checkpoint written at
      one (P, M) restores at any other.  The recovery rotation's
      ``restore_latest`` picks the epoch on rank 0 and broadcasts it
      (:meth:`agree`).

    ``device`` is the card unless the caller passes another (``'cpu'``);
    on the card it is this rank's card (``cuda:<local rank>``, chosen by
    the caller)."""

    _takes_source = True
    _manifest_in_init = False

    def __init__(self, model: Model, dataset, num_parts: int,
                 config: TrainConfig = TrainConfig(),
                 params: Optional[Dict[str, torch.Tensor]] = None,
                 device=None, group=None,
                 data: Optional[ShardedData] = None,
                 plan: Optional[PartitionPlan] = None):
        from . import RankMesh
        _, M = resolve_mesh(config, num_parts=num_parts)
        # on the 1-D mesh the whole group is the parts axis
        self.world_comm = Collectives(group,
                                      name="parts" if M == 1 else "world")
        self.global_rank = self.world_comm.rank
        if self.world_comm.world_size != num_parts * M:
            raise ValueError(
                f"num_parts={num_parts} but the process group has "
                f"{self.world_comm.world_size} ranks (one partition per "
                f"rank" + (f", x {M} model ranks: mesh {config.mesh!r}"
                           if M > 1 else "") + ")")
        self.mesh = RankMesh(num_parts, M)
        self.sharding = None
        self._ckpt_group = None
        if M > 1:
            if group is not None:
                raise ValueError("the (parts, model) mesh runs over the "
                                 "default process group (group=None)")
            parts_groups = [dist.new_group(self.mesh.parts_group(m))
                            for m in range(M)]
            model_groups = [dist.new_group(self.mesh.model_group(p))
                            for p in range(num_parts)]
            # the checkpoint barriers' own group (the async saver's
            # thread must never share a group with the step's collectives)
            self._ckpt_group = dist.new_group(backend="gloo")
            m = self.mesh.model_index(self.global_rank)
            part = self.mesh.part_of(self.global_rank)
            self.comm = Collectives(parts_groups[m], name="parts")
            self.model_comm = Collectives(model_groups[part], name="model")
        else:
            self.comm = self.world_comm
            self.model_comm = None
        # the part index (the parts group's rank): the split's part, the
        # dropout seed and the checkpoint generator row are the part's
        self.rank = self.comm.rank
        if data is not None and plan is None:
            raise ValueError(
                "pass plan= alongside data= (the SAME PartitionPlan the "
                "tables were built from)")
        if plan is not None and plan.num_parts != num_parts:
            raise ValueError(f"injected plan has {plan.num_parts} parts, "
                             f"the trainer was asked for {num_parts}")
        if data is not None and config.rebalance:
            raise ValueError(
                "rebalance=True requires the trainer-owned data build; "
                "injected data= cannot be repartitioned")
        self._injected = (data, plan)
        super().__init__(model, dataset, dataclasses.replace(
            config, verbose=config.verbose and self.global_rank == 0),
            params=params, device=device)
        self._injected = (None, None)
        names = list(self.params)
        with torch.no_grad():
            flat = self.comm.broadcast(_flat([self.params[k]
                                              for k in names]))
            for k, v in zip(names, _unflat(flat, [self.params[k]
                                                  for k in names])):
                self.params[k].copy_(v)
        if M > 1:
            self._shard_at_rest()
        # part 0 goes on drawing from Trainer's generator
        if self.rank != 0:
            self.generator = torch.Generator(device=self.device).manual_seed(
                rank_seed(config.seed, self.rank))
        cfg = self.config
        if cfg.halo == "ring":
            d = self.data
            ratio = d.ring_padding_ratio
            route = ("K3 at each hop" if cfg.aggr_impl in KERNEL_IMPLS
                     else "plain hop sums")
            emit("plan", f"halo=ring: P={self.plan.num_parts} "
                 f"pair_edges={d.pair_edges} padding_ratio={ratio:.2f} "
                 f"overlap={'on' if cfg.ring_overlap else 'off'} "
                 f"(aggr_impl={cfg.aggr_impl!r}: {route}; the ring tables "
                 f"drive the aggregation)", console=cfg.verbose,
                 num_parts=self.plan.num_parts, pair_edges=d.pair_edges,
                 padding_ratio=ratio, ring_overlap=bool(cfg.ring_overlap))
        self._partition_stats = self._emit_partition_stats()
        # the manifest once the split is known, with its quality record;
        # its proc (and every later event's) is this process's rank
        self._emit_manifest(dataset, partition=self._partition_stats)

    def _num_parts(self) -> int:
        return self.mesh.parts

    def _check_mesh(self, config: TrainConfig) -> None:
        """Checked in ``__init__`` (the mesh is this trainer's)."""

    # -- the (parts, model) mesh

    def _shard_at_rest(self) -> None:
        """Keep this rank's slice of every param and Adam moment
        (:class:`~roc_tpu_torch.parallel.ModelSharding`)."""
        from . import ModelSharding
        sh = self.sharding = ModelSharding(
            rank=self.global_rank, part=self.rank,
            m=self.model_comm.rank, model=self.mesh.model,
            full_shapes={k: tuple(v.shape) for k, v in self.params.items()})
        with torch.no_grad():
            self.params = {k: sh.local(k, v).clone().requires_grad_(
                v.requires_grad) for k, v in self.params.items()}
            st = self.opt_state
            self.opt_state = st._replace(
                m={k: sh.local(k, v).clone() for k, v in st.m.items()},
                v={k: sh.local(k, v).clone() for k, v in st.v.items()})

    def _full_params(self) -> Dict[str, torch.Tensor]:
        """The whole params: on the 2-D mesh the model group's slices
        joined (one flat all-gather of the sharded leaves; the whole
        leaves as they are), each a leaf tensor that autograd can
        differentiate; ``params`` itself on the 1-D mesh."""
        sh = self.sharding
        if sh is None:
            return self.params
        names = [k for k in self.params if sh.dims[k] is not None]
        mine = [self.params[k] for k in names]
        full = dict(self.params)
        if names:
            M = self.mesh.model
            buf = self.model_comm.all_gather(_flat(mine)).view(M, -1)
            pieces = [_unflat(buf[m], mine) for m in range(M)]
            for i, k in enumerate(names):
                full[k] = torch.cat([pieces[m][i] for m in range(M)],
                                    dim=sh.dims[k]).requires_grad_(True)
        return full

    def _local_grads(self, grads: Dict[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
        """The whole gradients' slices of this rank (2-D mesh)."""
        sh = self.sharding
        if sh is None:
            return grads
        return {k: sh.local(k, g) for k, g in grads.items()}

    def _place(self, dataset, symmetric: bool) -> None:
        """This rank's part of the split (``plan``, ``data``) and its graph
        context: the method of ``config.partition`` under the cost model's
        cold-start weights (or the injected ``plan``), the tables of the
        resolved route and halo (or the injected ``data``)."""
        from ..core.costmodel import PartitionCostModel
        from ..core.source import as_source
        cfg = self.config
        self._source = as_source(dataset)
        self._symmetric = symmetric
        self._partition_method = resolve_partition(cfg)
        # the φ columns only this workload pays (attention's softmax pass,
        # the flat layouts' sub-rows)
        self._phi_flags = dict(
            attn_edges=bool(self.model.uses_attention()),
            flat8=cfg.aggr_impl in ("attn_flat8", "flat_sum"))
        self._costmodel = PartitionCostModel(node_multiple=8,
                                             edge_multiple=cfg.chunk)
        self._rebalances = 0
        self._phi_cache = None
        data, plan = self._injected
        if plan is None:
            plan = partition_plan(
                self._source.row_ptr(), self.mesh.parts, node_multiple=8,
                edge_multiple=cfg.chunk, method=self._partition_method,
                cost_weights=self._costmodel.search_weights(
                    **self._phi_flags))
        if data is not None:
            self._check_injected(data, plan)
        self._build(plan, data)

    def _check_injected(self, data: ShardedData, plan: PartitionPlan
                        ) -> None:
        """Refuse injected tables that are not the resolved config's (the
        JAX package's checks), here and not mid-step."""
        cfg = self.config
        if tuple(data.feats.shape[:1]) != (plan.part_nodes,):
            raise ValueError(
                f"injected data has {data.feats.shape[0]} rows but the "
                f"plan's parts have {plan.part_nodes}")
        if cfg.halo == "ring":
            if data.ring_src is None:
                raise ValueError(
                    "injected data has no ring tables but the resolved "
                    "config wants halo='ring' (build it with "
                    "shard_dataset_local(..., halo='ring') or pass "
                    "memory/halo explicitly)")
            return
        if data.ring_src is not None:
            raise ValueError(
                "injected data carries the ring's tables but the resolved "
                f"halo is {cfg.halo!r} — build it with the same halo")
        impl = cfg.aggr_impl
        missing = (
            (impl in ELL_IMPLS and not data.ell_idx) or
            (impl in ("sectioned", "bdense") and not data.sect_meta) or
            (impl in ("flat_sum", "attn_flat8") and data.flat8_idx is None)
            or (impl == "bdense" and data.bd_occupancy is None) or
            (impl not in ELL_IMPLS and impl not in (
                "sectioned", "bdense", "flat_sum", "attn_flat8")
             and data.edge_src is None))
        if missing:
            raise ValueError(
                f"injected data has no tables of the resolved aggr_impl "
                f"{impl!r} — build it with the same aggr_impl (note: "
                f"'auto' resolves by the graph's size, and attention and "
                f"MAX models route by their own rule)")
        if impl in EDGE_IMPLS and data.edge_src.shape[-1] != \
                plan.part_edges:
            # a flat-edge route would sum whatever edges the arrays hold
            raise ValueError(
                f"injected data carries edge stubs (shape "
                f"{tuple(data.edge_src.shape)}) but the resolved aggr_impl "
                f"{impl!r} reads the flat edge arrays — build the data "
                f"with the same aggr_impl")
        if impl == "bdense" and data.bd_group != cfg.bdense_group:
            raise ValueError(
                f"injected data was built with bdense_group="
                f"{data.bd_group} but the config wants bdense_group="
                f"{cfg.bdense_group}")

    def _build(self, plan: PartitionPlan,
               data: Optional[ShardedData] = None) -> None:
        """Build this rank's part of ``plan`` (``plan``, ``data``, ``feats``,
        ``labels``, ``mask``) and its graph context: at init (``data``
        given: those tables) and after a repartition, ring tables
        included."""
        cfg = self.config
        agree = self.comm.agree_max if self.comm.world_size > 1 else None
        d = data if data is not None else shard_dataset(
            self._source, plan, self.rank, self.device, dtype=self.compute,
            aggr_impl=cfg.aggr_impl, halo=cfg.halo,
            fuse=self.model.num_fused_aggregates() > 0, agree_max=agree,
            **layout_options(cfg))
        self.plan, self.data = plan, d
        self.feats, self.labels, self.mask = d.feats, d.labels, d.mask
        self._bd_occupancy: Tuple[dict, ...] = ()
        if d.bd_occupancy is not None:
            self._bd_occupancy = self._bdense_record(d.bd_occupancy)
        self.gctx = GraphContext(
            in_degree=d.in_degree, inv_sqrt_deg=inv_sqrt_degree(d.in_degree),
            num_rows=plan.part_nodes, aggr_impl=cfg.aggr_impl,
            symmetric=self._symmetric, chunk=cfg.chunk,
            gather_features=self.comm.gather,
            gathered_rows=plan.padded_num_nodes, halo=cfg.halo,
            ring_comm=self.comm if cfg.halo == "ring" else None,
            ring_overlap=cfg.ring_overlap,
            head_chunk=resolve_head_chunk(cfg, plan.part_nodes),
            **d.context_tables())

    def _bdense_record(self, occ: dict) -> Tuple[dict, ...]:
        """Every part's block count (one collective), with this part's
        plan as a ``plan`` event, and the JAX package's echo when no part
        has a dense tile."""
        P = self.comm.world_size
        mine = np.zeros(P, dtype=np.int64)
        mine[self.rank] = occ["n_blocks"]
        blocks = self.comm.agree_max(mine) if P > 1 else mine
        cfg = self.config
        emit("plan", f"bdense part {self.rank}: {occ['n_blocks']} blocks, "
             f"dense_frac={occ['dense_frac']}, mean_fill="
             f"{occ['mean_fill']}", console=cfg.verbose, part=self.rank,
             **occ)
        if not blocks.any():
            emit("plan", "bdense: no [128,128] tile reaches min_fill="
                 f"{cfg.bdense_min_fill} on any partition — running the "
                 "pure sectioned residual")
        return tuple({"n_blocks": int(n)} for n in blocks)

    # -- the cost model (core/costmodel.py)

    def _phi(self) -> np.ndarray:
        """The current split's feature matrix, computed once a split: each
        rank counts its own part's halo (``ShardedData.halo_read``) and
        one collective joins them, so the same on every rank, and no rank
        reads another part's columns."""
        if self._phi_cache is None:
            from ..core.costmodel import halo_stats_ranked, phi_matrix
            read = self.data.halo_read
            if read is None:
                # injected tables built without the record: this part's
                # columns, read once more
                from ..core.costmodel import part_halo_read
                read = part_halo_read(self.plan, self.rank, partition_col(
                    self.plan, self._source.col_slice, self.rank))
            halo = halo_stats_ranked(
                self.plan, self.rank, read,
                self.comm.agree_max if self.comm.world_size > 1 else None)
            self._phi_cache = phi_matrix(
                self.plan, bd_occupancy=self._bd_occupancy, halo=halo,
                **self._phi_flags)
        return self._phi_cache

    def _emit_partition_stats(self) -> dict:
        """The split's quality record (core/costmodel.py
        ``partition_static_stats``) as a ``costmodel`` event; returns it."""
        from ..core.costmodel import partition_static_stats
        stats = partition_static_stats(self.plan, phi=self._phi())
        emit("costmodel",
             f"partition={self._partition_method}: "
             f"P={stats['num_parts']} "
             f"part_nodes={stats['part_nodes']} "
             f"part_edges={stats['part_edges']} "
             f"edge imbalance (max/mean) {stats['edge_imbalance']:.2f} "
             f"node {stats['node_imbalance']:.2f}",
             console=self.config.verbose,
             method=self._partition_method, **stats)
        return stats

    def straggler_fields(self, m: Dict[str, Any]) -> Dict[str, Any]:
        """The part the cost model predicts slowest for an eval record's
        measured epoch, and its predicted cost over the mean
        (``straggler_part``, ``straggler_ratio``); a ``costmodel``
        straggler event with every part's predicted cost.  Empty for a
        record with no steady epoch time."""
        t = m.get("epoch_ms")
        if not t:
            return {}
        pred = self._costmodel.predict(self._phi())
        p = int(np.argmax(pred))
        mean = float(np.mean(pred))
        ratio = round(float(pred[p]) / mean, 4) if mean > 0 else None
        out: Dict[str, Any] = {"straggler_part": p,
                               "straggler_ratio": ratio}
        emit("costmodel",
             f"straggler: epoch {m.get('epoch')} lap {t:.1f} ms -> "
             f"part {p} (predicted {ratio}x the {self.plan.num_parts}-"
             f"shard mean)", console=False, kind="straggler",
             epoch=m.get("epoch"), measured_ms=float(t),
             num_parts=self.plan.num_parts,
             predicted_cost=[round(float(c), 3) for c in pred], **out)
        return out

    def maybe_rebalance(self, m: Dict[str, Any]) -> bool:
        """The epoch-boundary rebalancing hook (train/trainer.py
        ``run_epoch_loop`` calls it after each eval record, on every
        rank): attribute rank 0's measured epoch time to the part the
        model predicts slowest (winner takes all; broadcast, so every
        rank fits the same model), search a split under the refit
        weights, and repartition when the predicted gain of the largest
        part's cost passes ``rebalance_gain`` (at most ``rebalance_max``
        times).  Returns True when it repartitioned."""
        cfg = self.config
        if not cfg.rebalance or self._rebalances >= cfg.rebalance_max:
            return False
        from ..core.costmodel import bounds_max_cost, cost_balanced_bounds
        # rank 0's time on every rank of the world (the model replicas of
        # a part repartition alike)
        t = self.world_comm.broadcast_float(m.get("epoch_ms") or None)
        if t:
            phi = self._phi()
            p_star = int(np.argmax(self._costmodel.predict(phi)))
            self._costmodel.observe(phi[p_star], float(t))
            emit("costmodel",
                 f"observe: epoch {m.get('epoch')} lap {t:.1f} ms "
                 f"attributed to part {p_star}", console=False,
                 part=p_star, epoch_ms=float(t),
                 n_obs=self._costmodel.n_obs)
        wn, we = self._costmodel.search_weights(**self._phi_flags)
        row_ptr = self._source.row_ptr()
        nm, em = self.plan.node_multiple, self.plan.edge_multiple
        cur = bounds_max_cost(row_ptr, self.plan.bounds, wn, we, nm, em)
        new_bounds = cost_balanced_bounds(
            row_ptr, self.plan.num_parts, node_multiple=nm,
            edge_multiple=em, weights=(wn, we))
        new = bounds_max_cost(row_ptr, new_bounds, wn, we, nm, em)
        gain = 1.0 - new / cur if cur > 0 else 0.0
        same = [tuple(b) for b in new_bounds] == \
            [tuple(b) for b in self.plan.bounds]
        if same or gain <= cfg.rebalance_gain:
            emit("costmodel",
                 f"rebalance: predicted max-shard gain {gain:.1%} "
                 f"<= threshold {cfg.rebalance_gain:.0%} — keeping "
                 f"the current split", console=False,
                 gain=round(gain, 4), threshold=cfg.rebalance_gain)
            return False
        self._repartition(new_bounds, gain=gain)
        return True

    def _repartition(self, bounds, gain: Optional[float] = None) -> None:
        """Rebuild this rank's part for ``bounds`` (the plan, the tables,
        ring tables included, and the graph context) and go on: the
        weights and Adam state are replicated and full-batch training
        does not depend on the split."""
        old_edges = self.plan.part_edges
        self._build(plan_from_bounds(
            self._source.row_ptr(), [tuple(b) for b in bounds],
            self.plan.num_parts, node_multiple=self.plan.node_multiple,
            edge_multiple=self.plan.edge_multiple))
        self._phi_cache = None
        self._rebalances += 1
        self._partition_stats = self._emit_partition_stats()
        emit("costmodel",
             f"repartition #{self._rebalances}: predicted max-shard "
             f"gain {'?' if gain is None else format(gain, '.1%')}, "
             f"part_edges {old_edges} -> {self.plan.part_edges}",
             rebalance=self._rebalances,
             gain=None if gain is None else round(gain, 4),
             part_edges=self.plan.part_edges,
             part_nodes=self.plan.part_nodes)

    def _reduce(self, tensors: List[torch.Tensor]) -> List[torch.Tensor]:
        """Every rank's ``tensors`` summed, in one all-reduce of one fp32
        buffer."""
        return _unflat(self.comm.all_reduce(_flat(tensors)), tensors)

    def rng_states(self) -> np.ndarray:
        """Every part's dropout generator state, ``[P, n]`` uint8, in part
        order (one all-gather over the parts group; every rank calls
        it)."""
        mine = self.generator.get_state().to(self.device)
        return self.comm.all_gather(mine[None]).cpu().numpy()

    def agree(self, value: Optional[int]) -> Optional[int]:
        """Rank 0's ``value`` (an epoch, or None) on every rank of the
        world: one broadcast."""
        t = torch.tensor([-1 if value is None else int(value)],
                         dtype=torch.int64, device=self.device)
        v = int(self.world_comm.broadcast(t).item())
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
    # the ranks share the host's cores: each takes its share of intra-op
    # threads (with every rank at the host's count, a CPU index_add_ of a
    # few hundred rows took ~200 ms instead of ~0.03)
    cores = len(os.sched_getaffinity(0)) if hasattr(os, "sched_getaffinity") \
        else (os.cpu_count() or 1)
    torch.set_num_threads(max(1, cores // world_size))
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
