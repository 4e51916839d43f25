"""Model builder and graph context (``roc_tpu/models/builder.py``): every
op kind of the JAX model zoo, forward and backward.

The builder API records a static op list, as the reference's ``Model``
class does (``gnn.h:162-203``); :meth:`Model.apply` interprets it
eagerly and autograd differentiates it.  Graph access goes through
:class:`GraphContext`, which holds the graph on the model's device and
runs one of ten routes.  Four are two layouts times plain or
hand-written:

- ``aggr_impl='ell'``: the plain PyTorch ELL sum (ops/aggregate.py);
- ``aggr_impl='cuda'``: the hand-written ELL kernels — K4 for the sum,
  and in the fused chain K1 (pre-scale) -> K4 -> K2 (scale and
  activation), kernels/graphnorm.py.  The JAX package's 'pallas';
- ``aggr_impl='segment'``: the plain edge-list sum (ops/aggregate.py);
- ``aggr_impl='cuda_csr'``: the hand-written CSR kernel K3
  (kernels/spmm.py), fused as K1 -> K3 -> K2.  The JAX package's
  'pallas_csr'.

Two more take the padded edge list: ``aggr_impl='blocked'`` and
``'scan'``, the JAX package's chunked edge-list sums as plain PyTorch ops
(ops/aggregate.py ``aggregate_blocked``, ``aggregate_scan``), whose
transient is bounded by a run of chunks.

Four are the large-graph layouts, plain PyTorch ops as in the JAX
package (core/ell.py, ops/aggregate.py, ops/blockdense.py):

- ``aggr_impl='sectioned'``: source-sectioned width-8 sub-rows;
- ``aggr_impl='flat_sum'``: the same tables with one section, whose sum
  and MAX (``aggregate_flat_max``) read global ids;
- ``aggr_impl='bdense'``: dense ``[128, 128]`` adjacency tiles as batched
  products, the residual edges through the sectioned sum;
- ``aggr_impl='attn_flat8'``: the flat tables for attention alone
  (ops/attention.py ``gat_aggregate_flat8``).

Their fused form reads the normalization baked into the tables on the
host (the sectioned and flat weight tables, the block-dense tile scales)
when the context holds them, and scales before and after the sum
otherwise.

The kernel wrappers dispatch by the tensors' device: on the CPU the
kernel routes run the kernels' plain versions.  Every route runs in the
activations' dtype (fp32, or bf16 in the mixed and bfloat16 modes): the
kernel routes launch the kernels' bf16 instances on bf16 activations,
forward and backward alike (the cotangent of a bf16 activation is bf16),
with no fp32 copy of ``[V, F]``.

The backward of both aggregations is the reference's symmetric trick
(``scattergather_kernel.cu:160-170``, ``roc_tpu/models/builder.py:221-
244, 327-347``): for a symmetric graph ``A^T = A`` and ``S^T = S``, so
the gradient is the forward rerun on the cotangent, through the same
kernels.  ``symmetric=False`` differentiates the plain routes by
autograd (exact for any graph) and raises on the kernel routes.

The classification head (the last linear op) runs in row blocks of
``head_chunk`` rows when the context sets it (ops/dense.py
``linear_chunked``; ``TrainConfig.head_chunk``).

AVG is the sum (the same symmetric backward) over ``max(deg, 1)`` cast to
the activations' dtype, as in the JAX package (in bf16 a degree above
256 rounds: 493 becomes 492).  MAX, MIN (``-max(-x)``) and GAT attention
are plain PyTorch ops on every route (ops/aggregate.py, ops/attention.py),
differentiated by autograd; MAX runs on the ELL tables ('ell', 'cuda'),
the edge list ('segment') or the flat tables ('flat_sum'), attention on
the ELL tables or the flat tables ('attn_flat8'), and the trainers'
resolver (train/trainer.py ``resolve_attention_impl``) moves a
model that needs them off the other routes.

On a rank of a partitioned run (parallel/distributed.py) the context
holds the rank's own rows: ``num_rows`` output rows, tables indexing the
``gathered_rows`` rows of the halo gather.  The rerun on the cotangent
gathers the cotangent, which is the shard-level form of the same
identity: rank p's rows of ``S^T g`` are ``S_p gather(g)`` when
``S^T = S``.  With ``halo='ring'`` the context holds the ring's tables
instead and every sum is parallel/ring.py ``ring_aggregate``: K3 at each
hop on the kernel routes (the fused chain K1 -> the ring's K3 hops -> K2,
the masked K1 in its backward), K3's plain version on 'ell' and
'segment' (their fused form reads the baked ring weights).  MAX, MIN and
attention have no ring form.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..ops import dense
from ..ops.aggregate import (aggregate_blocked, aggregate_ell,
                             aggregate_ell_max, aggregate_ell_sect,
                             aggregate_flat_max, aggregate_flat_sum,
                             aggregate_scan, aggregate_segment,
                             aggregate_segment_max)
from ..ops.attention import (gat_aggregate_ell, gat_aggregate_flat8,
                             resolve_dh_chunk)
from ..ops.blockdense import aggregate_block_dense
from ..ops.dense import AC_MODE_ELU, AC_MODE_NONE, AC_MODE_RELU, \
    AC_MODE_SIGMOID
from ..ops.loss import masked_softmax_cross_entropy
from ..ops.norm import indegree_norm

# the reference's AggrType (gnn.h:75-80), all four built here as in the
# JAX package
AGGR_SUM = "sum"
AGGR_AVG = "avg"
AGGR_MAX = "max"
AGGR_MIN = "min"

ELL_IMPLS = ("ell", "cuda")
EDGE_IMPLS = ("segment", "blocked", "scan", "cuda_csr")
KERNEL_IMPLS = ("cuda", "cuda_csr")
LAYOUT_IMPLS = ("sectioned", "flat_sum", "bdense", "attn_flat8")
AGGR_IMPLS = ELL_IMPLS + EDGE_IMPLS + LAYOUT_IMPLS
# the halo exchanges of a partitioned run (parallel/distributed.py)
HALOS = ("gather", "ring")
# the graph ops whose outputs remat='save_aggregates' keeps (the ops the
# JAX package tags with its checkpoint name 'aggregate')
AGGREGATE_KINDS = ("scatter_gather", "fused_aggregate", "gat")
REMAT_POLICIES = ("save_aggregates", "full")


def remat_call(fn: Callable, generator: Optional[torch.Generator], *args):
    """``fn(*args)`` under ``torch.utils.checkpoint`` (non-reentrant): its
    activations are not saved but recomputed in the backward.  Dropout
    draws from ``generator``, which the checkpoint's own RNG handling
    does not see (it saves the default generators only), so the
    recompute replays it: it sets ``generator`` to its state before the
    forward ran ``fn``, recomputes (drawing the same masks) and puts back
    the state it found, so the draws after the step are the ones a run
    without remat makes."""
    state: Dict[str, torch.Tensor] = {}

    def run(*a):
        if generator is None:
            return fn(*a)
        if "start" not in state:
            state["start"] = generator.get_state()
            return fn(*a)
        now = generator.get_state()
        generator.set_state(state["start"])
        try:
            return fn(*a)
        finally:
            generator.set_state(now)

    from torch.utils.checkpoint import checkpoint
    return checkpoint(run, *args, use_reentrant=False,
                      preserve_rng_state=False)


def _identity(x: torch.Tensor) -> torch.Tensor:
    return x


class _SymmetricSum(torch.autograd.Function):
    """``A @ x`` whose backward is ``A @ g`` (the forward on the
    cotangent)."""

    @staticmethod
    def forward(ctx, x, gctx):
        ctx.gctx = gctx
        return gctx._sum_fwd(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.gctx._sum_fwd(g.contiguous()), None


class _SymmetricFused(torch.autograd.Function):
    """``act(S x)``, ``S = D^-1/2 A D^-1/2``.  The relu is nonlinear, so
    it is not part of the symmetric operator: the backward runs ``S`` with
    no activation on the cotangent selected by ``y > 0`` (relu's gradient,
    a select as in JAX: 0 at 0, and 0 where ``y <= 0`` whatever the
    cotangent holds there, NaN and inf included); on the kernel routes
    the select is part of K1, masked K1 -> K3/K4 -> K2('none')."""

    @staticmethod
    def forward(ctx, x, gctx, act):
        ctx.gctx = gctx
        y = gctx._fused_sum_fwd(x, act)
        if act == AC_MODE_RELU:
            ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        # ctx.saved_tensors read once: under a checkpoint each read
        # unpacks (recomputes) the saved tensor, and a second is refused
        saved = ctx.saved_tensors
        y = saved[0] if saved else None
        return ctx.gctx._fused_sum_fwd(g.contiguous(), relu_out=y), None, \
            None


@dataclass
class GraphContext:
    """The graph as one device, or one rank, sees it, for the forward
    and backward.

    in_degree: int32 [num_rows] in-degrees; inv_sqrt_deg: their fp32
      ``deg^-1/2`` (ops/norm.py), computed once.
    ELL routes ('ell', 'cuda'; empty otherwise):
    ell_idx: int32 ``[rows_b, width_b]`` per bucket, dummy == gathered_rows.
    ell_row_pos: int32 [num_rows] slot of each row in the concatenated
      bucket outputs (read by the 'ell' route).
    ell_row_id: int32 [rows_b] per bucket, the output row of each
      bucket row (read by the 'cuda' route).
    Edge routes ('segment', 'blocked', 'scan', 'cuda_csr'; None
    otherwise):
    edge_src/edge_dst: int32 [Ep] padded edge list sorted by destination
      (core/partition.py), ``Ep`` a multiple of ``chunk``, dummy source
      == gathered_rows.
    The halo (parallel/distributed.py):
    gather_features: ``[num_rows, F]`` -> ``[gathered_rows, F]``, the
      rows every table indexes: the identity on one device, the process
      group's all-gather in padded part order on a rank of a partitioned
      run (differentiable there, for ``symmetric=False``).
    gathered_rows: the gathered row count R, the id of the dummy source
      the kernels skip and the plain routes' appended zero row; None
      means ``num_rows`` (one device).
    The layouts (core/ell.py SectionedEll, ops/blockdense.py BlockPlan):
    sect_idx / sect_sub_dst: per section ``[n_chunks, seg_rows, sub_w]``
      ids (int32 or uint16) and ``[n_chunks, seg_rows]`` output rows,
      ``sect_meta`` their ``(start, size)`` ('sectioned'; 'bdense''s
      residual); ``sect_w`` the baked fused weights, shaped like the ids.
    flat8_idx / flat8_dst: the flat tables ('flat_sum', 'attn_flat8'),
      ``flat8_w`` their baked weights ('flat_sum').
    bd_a / bd_src / bd_dst: the block-dense A-tables (uint8, or u4-packed
      ``[..., 64]``) and tile ids, ``bd_vpad`` the padded rows,
      ``bd_src_vpad`` the padded source rows (0: ``bd_vpad``; a
      partitioned plan's source tiles span the gathered rows),
      ``bd_group`` the blocks a product sums; ``bd_scale`` the fused
      normalization's ``(d_dst [bd_vpad], d_src [bd_src_vpad])``.
    The ring halo (``halo='ring'``, parallel/ring.py; the gather tables
    are then unused):
    ring_src / ring_dst: int32 ``[S, pair_edges]`` this rank's pair edge
      lists; ring_row_ptr: int64 ``[S, num_rows + 1]`` their row ranges
      over the real edges (K3's); ring_w: fp32 ``[S, pair_edges]`` the
      baked fused weights (plain routes), or None; ring_comm: the
      rank's ``Collectives``; ring_overlap: transfer under the hop's sum.
    head_chunk: the classification head's row block (0: one product;
      train/trainer.py ``resolve_head_chunk``).
    """

    in_degree: torch.Tensor
    inv_sqrt_deg: torch.Tensor
    num_rows: int
    ell_idx: Tuple[torch.Tensor, ...] = ()
    ell_row_pos: Optional[torch.Tensor] = None
    ell_row_id: Tuple[torch.Tensor, ...] = ()
    aggr_impl: str = "cuda"
    symmetric: bool = True
    edge_src: Optional[torch.Tensor] = None
    edge_dst: Optional[torch.Tensor] = None
    chunk: int = 512
    gather_features: Callable[[torch.Tensor], torch.Tensor] = _identity
    gathered_rows: Optional[int] = None
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
    halo: str = "gather"
    ring_src: Optional[torch.Tensor] = None
    ring_dst: Optional[torch.Tensor] = None
    ring_row_ptr: Optional[torch.Tensor] = None
    ring_w: Optional[torch.Tensor] = None
    ring_comm: Any = None
    ring_overlap: bool = True
    head_chunk: int = 0

    def __post_init__(self):
        if self.aggr_impl not in AGGR_IMPLS:
            raise ValueError(f"unknown aggr_impl {self.aggr_impl!r}; "
                             f"expected one of {AGGR_IMPLS}")
        if self.halo not in HALOS:
            raise ValueError(f"unknown halo {self.halo!r}; expected one of "
                             f"{HALOS}")
        if self.halo == "ring" and (self.ring_src is None
                                    or self.ring_comm is None):
            raise ValueError("halo='ring' needs the ring tables and the "
                             "rank's collectives")
        if self.gathered_rows is None:
            self.gathered_rows = self.num_rows

    def _ring_sum(self, x: torch.Tensor, baked: bool = False
                  ) -> torch.Tensor:
        """The ring's neighbour sum of this rank's rows (parallel/ring.py);
        ``baked`` weighs each edge by the fused normalization."""
        from ..parallel.ring import ring_aggregate
        return ring_aggregate(x, self.ring_src, self.ring_dst,
                              self.ring_comm, row_ptr=self.ring_row_ptr,
                              weights=self.ring_w if baked else None,
                              kernel=self.aggr_impl in KERNEL_IMPLS,
                              overlap=self.ring_overlap)

    def _refuse_ring(self, what: str) -> None:
        if self.halo == "ring":
            raise NotImplementedError(
                f"{what} is not supported with halo='ring' (the ring "
                "accumulator is additive; the whole neighborhood is "
                "needed per row); use halo='gather'")

    def _gathered(self, x: torch.Tensor) -> torch.Tensor:
        """The halo exchange: ``[gathered_rows, F]``."""
        full = self.gather_features(x)
        if full.shape[0] != self.gathered_rows:
            raise ValueError(f"the halo gave {full.shape[0]} rows, the "
                             f"tables index {self.gathered_rows}")
        return full

    def _gathered_with_zero(self, x: torch.Tensor) -> torch.Tensor:
        """Halo exchange + the appended zero row the dummy id reads."""
        full = self._gathered(x)
        return torch.cat([full, full.new_zeros((1, full.shape[1]))], dim=0)

    def _sum_fwd(self, x: torch.Tensor) -> torch.Tensor:
        """``A @ gather(x)``, or the ring's sum."""
        if self.halo == "ring":
            return self._ring_sum(x)
        if self.aggr_impl == "cuda":
            from ..kernels.ell_spmm import ell_aggregate
            return ell_aggregate(self._gathered(x), self.ell_idx,
                                 self.ell_row_id, self.num_rows)
        if self.aggr_impl == "cuda_csr":
            from ..kernels.spmm import csr_spmm
            return csr_spmm(self._gathered(x), self.edge_src,
                            self.edge_dst, self.num_rows, chunk=self.chunk)
        if self.aggr_impl == "segment":
            return aggregate_segment(self._gathered_with_zero(x),
                                     self.edge_src, self.edge_dst,
                                     self.num_rows)
        if self.aggr_impl in ("blocked", "scan"):
            fn = (aggregate_blocked if self.aggr_impl == "blocked"
                  else aggregate_scan)
            return fn(self._gathered_with_zero(x), self.edge_src,
                      self.edge_dst, self.num_rows, chunk=self.chunk)
        if self.aggr_impl in LAYOUT_IMPLS:
            return self._layout_sum(self._gathered_with_zero(x))
        return aggregate_ell(self._gathered_with_zero(x), self.ell_idx,
                             self.ell_row_pos, self.num_rows)

    def _layout_sum(self, full: torch.Tensor,
                    baked: bool = False) -> torch.Tensor:
        """``A @ full`` on a layout route; ``baked`` reads the fused
        normalization from the tables (``S @ full``)."""
        if self.aggr_impl == "flat_sum":
            return aggregate_flat_sum(full, self.flat8_idx, self.flat8_dst,
                                      self.num_rows,
                                      flat_w=self.flat8_w if baked else None)
        if self.aggr_impl not in ("sectioned", "bdense"):
            raise NotImplementedError(
                f"aggr_impl={self.aggr_impl!r} is the attention-only "
                "layout; it has no sum")
        # the dense tiles' fp32 sums and the residual's are added before
        # the one rounding to the activations' dtype
        dense = None
        if self.bd_a is not None:
            scales = self.bd_scale if baked else (None, None)
            dense = aggregate_block_dense(
                full, self.bd_a, self.bd_src, self.bd_dst, self.num_rows,
                self.bd_vpad, out_dtype=torch.promote_types(
                    full.dtype, torch.float32),
                src_vpad=self.bd_src_vpad,
                group=self.bd_group, scale_dst=scales[0],
                scale_src=scales[1])
        if self.sect_idx:
            return aggregate_ell_sect(full, self.sect_idx, self.sect_sub_dst,
                                      self.sect_meta, self.num_rows,
                                      sect_w=self.sect_w if baked else None,
                                      partial=dense)
        if dense is not None:
            return dense.to(full.dtype)
        return full.new_zeros((self.num_rows, full.shape[1]))

    def _fused_sum_fwd(self, x: torch.Tensor, act: str = AC_MODE_NONE,
                       relu_out: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
        """``act(D^-1/2 A D^-1/2 x')``, ``x' = where(relu_out > 0, x, 0)``
        given ``relu_out`` (a relu's output, like ``x``), else ``x``.  The
        kernel routes run K1 (masked given ``relu_out``) on the local
        rows, the halo gather, then K4 (or K3) -> K2 with the activation
        in K2's epilogue; the plain routes select, scale before and after
        the plain sum and apply the activation after."""
        d = self.inv_sqrt_deg
        if self.aggr_impl in KERNEL_IMPLS:
            from ..kernels.graphnorm import (indegree_norm as norm_kernel,
                                             scale_act)
            return scale_act(self._sum_fwd(norm_kernel(
                x, self.in_degree, relu_out=relu_out)), d, act=act)
        if relu_out is not None:
            x = torch.where(relu_out > 0, x, 0)
        if self._baked() and self.halo == "ring":
            return dense.activation(self._ring_sum(x, baked=True), act)
        if self._baked():
            return dense.activation(
                self._layout_sum(self._gathered_with_zero(x), baked=True),
                act)
        d = d.to(x.dtype)[:, None]
        return dense.activation(self._sum_fwd(x * d) * d, act)

    def _baked(self) -> bool:
        """True when the tables carry the fused normalization."""
        if self.halo == "ring":
            return self.ring_w is not None
        if self.aggr_impl == "flat_sum":
            return self.flat8_w is not None
        if self.aggr_impl == "sectioned":
            return bool(self.sect_w)
        if self.aggr_impl == "bdense":
            return bool(self.bd_scale)
        return False

    def _check_differentiable(self, x: torch.Tensor) -> None:
        if (not self.symmetric and self.aggr_impl in KERNEL_IMPLS
                and torch.is_grad_enabled() and x.requires_grad):
            raise NotImplementedError(
                f"aggr_impl={self.aggr_impl!r} differentiates by the "
                "symmetric trick only; a graph that is not symmetric "
                "trains on a plain route ('ell' or 'segment')")

    def aggregate_sum(self, x: torch.Tensor) -> torch.Tensor:
        """``A @ x``; the backward reruns it on the cotangent when the
        graph is symmetric."""
        self._check_differentiable(x)
        if not self.symmetric:
            return self._sum_fwd(x)
        return _SymmetricSum.apply(x, self)

    def aggregate(self, x: torch.Tensor, aggr: str = AGGR_SUM
                  ) -> torch.Tensor:
        """The neighbour SUM, AVG (sum over ``max(deg, 1)`` in ``x``'s
        dtype), MAX or MIN of ``x``."""
        if aggr == AGGR_SUM:
            return self.aggregate_sum(x)
        if aggr == AGGR_AVG:
            s = self.aggregate_sum(x)
            deg = self.in_degree.to(s.dtype).clamp_min(1.0)
            return s / deg[:, None]
        if aggr == AGGR_MAX:
            return self._max_fwd(x)
        if aggr == AGGR_MIN:
            return -self._max_fwd(-x)
        raise ValueError(f"unknown aggregator: {aggr}")

    def _max_fwd(self, x: torch.Tensor) -> torch.Tensor:
        """Neighbour max over the gathered rows; rows with no neighbour
        give 0.  The ELL routes ('ell', 'cuda') run the plain ELL max on
        their tables, 'segment' the plain edge-list max, 'flat_sum' the
        flat max; the other routes have no max form and raise with the
        JAX package's message; so does the ring."""
        self._refuse_ring("AGGR_MAX")
        full = self._gathered_with_zero(x)
        if self.aggr_impl in ELL_IMPLS:
            out = aggregate_ell_max(full, self.ell_idx, self.ell_row_pos,
                                    self.num_rows)
        elif self.aggr_impl == "segment":
            out = aggregate_segment_max(full, self.edge_src, self.edge_dst,
                                        self.num_rows)
        elif self.aggr_impl == "flat_sum":
            out = aggregate_flat_max(full, self.flat8_idx, self.flat8_dst,
                                     self.num_rows)
        else:
            # every chunked-sum route: falling through to the segment max
            # would materialize the [E, F] per-edge matrix
            raise NotImplementedError(
                f"AGGR_MAX has no {self.aggr_impl!r} implementation; "
                "use aggr_impl='ell' (big graphs; sectioned carries "
                "no ELL tables and its additive carry can't max) or "
                "'segment' — the segment path materializes the full "
                "[E, F] per-edge matrix")
        return torch.where(torch.isfinite(out), out, 0.0)

    def gat_attention(self, x: torch.Tensor, a_src: torch.Tensor,
                      a_dst: torch.Tensor, neg_slope: float = 0.2
                      ) -> torch.Tensor:
        """Additive attention over each row's neighbours
        (ops/attention.py), K heads for ``a_src``/``a_dst`` of shape
        ``[K, dh]`` (``[dh]`` is one head).  Needs the ELL tables (routes
        'ell' and 'cuda') or the flat tables ('attn_flat8')."""
        self._refuse_ring("attention")
        flat8 = self.aggr_impl == "attn_flat8" and self.flat8_idx is not None
        if not flat8 and (self.aggr_impl not in ELL_IMPLS
                          or not self.ell_idx):
            raise NotImplementedError(
                f"attention needs the ELL tables (aggr_impl 'ell' or "
                f"'cuda') or the flat8 layout ('attn_flat8'), got "
                f"{self.aggr_impl!r}")
        if a_src.dim() == 1:
            a_src, a_dst = a_src[None, :], a_dst[None, :]
        K, dh = a_src.shape
        full = self._gathered_with_zero(x)
        s_full = torch.einsum("gkd,kd->gk", full.reshape(-1, K, dh),
                              a_src.to(full.dtype))
        d = torch.einsum("vkd,kd->vk", x.reshape(x.shape[0], K, dh),
                         a_dst.to(x.dtype))
        d_local = torch.cat([d, d.new_zeros((1, K))], dim=0)
        if flat8:
            return gat_aggregate_flat8(
                full, s_full, d_local, self.flat8_idx, self.flat8_dst,
                self.num_rows, neg_slope=neg_slope,
                dh_chunk=resolve_dh_chunk(self.num_rows, K, dh))
        return gat_aggregate_ell(full, s_full, d_local, self.ell_idx,
                                 self.ell_row_id, self.ell_row_pos,
                                 self.num_rows, neg_slope=neg_slope)

    def aggregate_fused(self, x: torch.Tensor,
                        act: str = AC_MODE_NONE) -> torch.Tensor:
        """Fused ``act(S x)`` with ``S = D^-1/2 A D^-1/2``; ``S`` is
        symmetric whenever ``A`` is, so the backward reruns it on the
        (relu-masked) cotangent."""
        if act not in (AC_MODE_NONE, AC_MODE_RELU):
            raise ValueError(f"fused aggregation takes act none|relu, "
                             f"got {act!r}")
        self._check_differentiable(x)
        if not self.symmetric:
            return self._fused_sum_fwd(x, act)
        return _SymmetricFused.apply(x, self, act)


@dataclass(frozen=True)
class TensorHandle:
    """Symbolic tensor produced by builder calls."""
    idx: int
    dim: int


def _same_dims(kind: str, a: "TensorHandle", b: "TensorHandle") -> None:
    if a.dim != b.dim:
        raise ValueError(f"{kind}: dims {a.dim} and {b.dim} differ")


@dataclass
class _Op:
    kind: str
    inputs: Tuple[int, ...]
    dim: int
    param: Optional[str] = None        # param key for linear ops
    attrs: Dict[str, Any] = field(default_factory=dict)


class Model(nn.Module):
    """Builder + interpreter (see module docstring).  ``params`` holds
    the weights under the JAX package's names: one ``[in, out]`` matrix
    per linear op (``linear_<n>``), a 0-d scalar per ``scale_add``
    (``eps_<n>``) and two ``[heads, dh]`` attention weights per gat op
    (``gat_<n>_src``, ``gat_<n>_dst``).

    :meth:`apply` here is the JAX package's interpreter, ``apply(params,
    feats, gctx, ...)``, not ``nn.Module.apply(fn)``."""

    def __init__(self, in_dim: int):
        super().__init__()
        self._ops: List[_Op] = [_Op("input", (), in_dim)]
        self._n_linear = 0
        self._n_gat = 0
        self._n_eps = 0
        self._loss_op: Optional[int] = None
        self.params = nn.ParameterDict()

    def uses_attention(self) -> bool:
        """True when the op list holds a gat op (it needs the ELL
        tables)."""
        return any(op.kind == "gat" for op in self._ops)

    def uses_max_aggregation(self) -> bool:
        """True when a scatter_gather op is MAX or MIN (no form on the
        chunked-sum routes 'blocked', 'scan', 'cuda_csr' and the
        sectioned layouts)."""
        return any(op.kind == "scatter_gather"
                   and op.attrs.get("aggr") in (AGGR_MAX, AGGR_MIN)
                   for op in self._ops)

    def num_fused_aggregates(self) -> int:
        return sum(op.kind == "fused_aggregate" for op in self._ops)

    def fuse_norm_aggregate(self) -> "Model":
        """Rewrite every ``indegree_norm -> scatter_gather(SUM) ->
        indegree_norm [-> relu]`` chain whose intermediates have no other
        consumer (and carry no loss marker) into ONE ``fused_aggregate``
        op computing ``[relu](D^-1/2 A D^-1/2 x)``.  Returns a NEW model
        that shares this one's parameters (the chain has none)."""
        ops = self._ops
        n = len(ops)
        consumers = [0] * n
        for op in ops:
            for i in op.inputs:
                consumers[i] += 1
        loss = self._loss_op
        chains: Dict[int, Tuple[int, str]] = {}
        i = 1
        while i + 2 < n:
            o0, o1, o2 = ops[i], ops[i + 1], ops[i + 2]
            ok = (o0.kind == "indegree_norm"
                  and o1.kind == "scatter_gather"
                  and o1.inputs == (i,)
                  and o1.attrs.get("aggr", AGGR_SUM) == AGGR_SUM
                  and o2.kind == "indegree_norm"
                  and o2.inputs == (i + 1,)
                  and consumers[i] == 1 and consumers[i + 1] == 1
                  and loss not in (i, i + 1))
            if not ok:
                i += 1
                continue
            end, act = i + 2, AC_MODE_NONE
            if (end + 1 < n and ops[end + 1].kind == "activation"
                    and ops[end + 1].attrs.get("mode") == AC_MODE_RELU
                    and ops[end + 1].inputs == (end,)
                    and consumers[end] == 1 and loss != end):
                end += 1
                act = AC_MODE_RELU
            chains[i] = (end, act)
            i = end + 1
        fused = Model(in_dim=ops[0].dim)
        fused._n_linear = self._n_linear
        fused._n_gat = self._n_gat
        fused._n_eps = self._n_eps
        for name, p in self.params.items():
            fused.params[name] = p
        new_ops = [ops[0]]
        remap = {0: 0}
        skip_until = 0
        for i in range(1, n):
            if i in chains:
                end, act = chains[i]
                new_ops.append(_Op(
                    "fused_aggregate", (remap[ops[i].inputs[0]],),
                    ops[i].dim,
                    attrs={"aggr": AGGR_SUM, "activation": act}))
                for k in range(i, end + 1):
                    remap[k] = len(new_ops) - 1
                skip_until = end
                continue
            if i <= skip_until:
                continue
            op = ops[i]
            new_ops.append(_Op(op.kind, tuple(remap[k] for k in op.inputs),
                               op.dim, op.param, dict(op.attrs)))
            remap[i] = len(new_ops) - 1
        fused._ops = new_ops
        fused._loss_op = remap[loss] if loss is not None else None
        return fused

    # ---- builder API (names match the reference) ----

    def input(self) -> TensorHandle:
        return TensorHandle(0, self._ops[0].dim)

    def dropout(self, t: TensorHandle, rate: float = 0.5) -> TensorHandle:
        return self._append("dropout", (t.idx,), t.dim, attrs={"rate": rate})

    def linear(self, t: TensorHandle, out_dim: int,
               activation: str = AC_MODE_NONE) -> TensorHandle:
        name = f"linear_{self._n_linear}"
        self._n_linear += 1
        return self._append("linear", (t.idx,), out_dim, param=name,
                            attrs={"activation": activation,
                                   "in_dim": t.dim})

    def indegree_norm(self, t: TensorHandle) -> TensorHandle:
        return self._append("indegree_norm", (t.idx,), t.dim)

    def scatter_gather(self, t: TensorHandle,
                       aggr: str = AGGR_SUM) -> TensorHandle:
        return self._append("scatter_gather", (t.idx,), t.dim,
                            attrs={"aggr": aggr})

    def gat_attention(self, t: TensorHandle, neg_slope: float = 0.2,
                      heads: int = 1) -> TensorHandle:
        """Attention-weighted neighbour aggregation; ``heads`` splits the
        feature axis into independent heads whose outputs concatenate.
        Adds the ``[heads, dim/heads]`` weights ``gat_<n>_src`` and
        ``gat_<n>_dst``."""
        if heads < 1:
            raise ValueError(f"gat_attention: heads must be >= 1, got "
                             f"{heads}")
        if t.dim % heads:
            raise ValueError(f"gat_attention: dim {t.dim} not divisible "
                             f"by heads {heads}")
        name = f"gat_{self._n_gat}"
        self._n_gat += 1
        return self._append("gat", (t.idx,), t.dim, param=name,
                            attrs={"neg_slope": neg_slope, "heads": heads})

    def relu(self, t: TensorHandle) -> TensorHandle:
        return self._append("activation", (t.idx,), t.dim,
                            attrs={"mode": AC_MODE_RELU})

    def sigmoid(self, t: TensorHandle) -> TensorHandle:
        return self._append("activation", (t.idx,), t.dim,
                            attrs={"mode": AC_MODE_SIGMOID})

    def elu(self, t: TensorHandle) -> TensorHandle:
        return self._append("activation", (t.idx,), t.dim,
                            attrs={"mode": AC_MODE_ELU})

    def add(self, a: TensorHandle, b: TensorHandle) -> TensorHandle:
        _same_dims("add", a, b)
        return self._append("add", (a.idx, b.idx), a.dim)

    def scale_add(self, a: TensorHandle, b: TensorHandle) -> TensorHandle:
        """``a + eps * b`` with a learnable 0-d ``eps_<n>``, zero at
        init (GIN's learnable epsilon, models/gin.py)."""
        _same_dims("scale_add", a, b)
        name = f"eps_{self._n_eps}"
        self._n_eps += 1
        return self._append("scale_add", (a.idx, b.idx), a.dim, param=name)

    def mul(self, a: TensorHandle, b: TensorHandle) -> TensorHandle:
        _same_dims("mul", a, b)
        return self._append("mul", (a.idx, b.idx), a.dim)

    def lerp(self, a: TensorHandle, b: TensorHandle,
             alpha: float) -> TensorHandle:
        """``(1 - alpha) * a + alpha * b`` with a fixed ``alpha`` (APPNP's
        teleport, GCNII's residuals), in that form: ``torch.lerp``'s
        ``a + alpha * (b - a)`` rounds otherwise."""
        _same_dims("lerp", a, b)
        return self._append("lerp", (a.idx, b.idx), a.dim,
                            attrs={"alpha": float(alpha)})

    def softmax_cross_entropy(self, t: TensorHandle) -> TensorHandle:
        """Marks ``t`` as the logits :meth:`loss_fn` takes the loss of."""
        self._loss_op = t.idx
        return t

    def _append(self, kind: str, inputs: Tuple[int, ...], dim: int,
                param: Optional[str] = None,
                attrs: Optional[Dict[str, Any]] = None) -> TensorHandle:
        self._ops.append(_Op(kind, inputs, dim, param, attrs or {}))
        return TensorHandle(len(self._ops) - 1, dim)

    # ---- streaming support ----

    def streamable_head(self):
        """``(dropout_rate, linear_param, tail_model)`` when the op list
        starts ``input -> dropout -> linear`` (no activation on the
        linear) and nothing later reads the first two tensors: the shape
        the host-feature tier (core/streaming.py ``StreamedHead``) splits
        off.  ``tail_model`` runs the ops after the linear on the
        projected ``[V, H]`` activations and shares this model's param
        names.  None for any other head (GIN aggregates raw features; a
        deep GCN's residual reads the dropout output twice)."""
        ops = self._ops
        if len(ops) < 4:
            return None
        if not (ops[1].kind == "dropout" and ops[1].inputs == (0,)):
            return None
        if not (ops[2].kind == "linear" and ops[2].inputs == (1,)):
            return None
        if ops[2].attrs.get("activation", AC_MODE_NONE) != AC_MODE_NONE:
            # the streamed head computes a plain projection: a fused
            # activation would be dropped, and its gradient with it
            return None
        for op in ops[3:]:
            if any(i < 2 for i in op.inputs):
                return None
        if self._loss_op is not None and self._loss_op < 3:
            return None
        return ops[1].attrs["rate"], ops[2].param, self._split_tail(2)

    def _split_tail(self, head_out: int) -> "Model":
        """The model of the ops after ``head_out``, whose output becomes
        the tail's input 0 (later indices shift down with the loss
        marker); it shares this model's param names.  One remap for
        :meth:`streamable_head`, :meth:`streamable_agg_head` and
        :meth:`precompute_split`."""
        ops = self._ops
        tail = Model(in_dim=ops[head_out].dim)
        for op in ops[head_out + 1:]:
            tail._ops.append(_Op(
                op.kind, tuple(0 if i == head_out else i - head_out
                               for i in op.inputs),
                op.dim, op.param, dict(op.attrs)))
        tail._loss_op = (self._loss_op - head_out
                         if self._loss_op is not None else None)
        return tail

    def _prefix_end(self) -> int:
        """One past the parameter-free propagation prefix from the input
        (``indegree_norm``, SUM/AVG ``scatter_gather``,
        ``fused_aggregate``), or 1 when it holds no aggregation."""
        ops = self._ops
        i = 1
        while i < len(ops) and ops[i].inputs == (i - 1,) and (
                ops[i].kind in ("indegree_norm", "fused_aggregate")
                or (ops[i].kind == "scatter_gather"
                    and ops[i].attrs.get("aggr", AGGR_SUM)
                    in (AGGR_SUM, AGGR_AVG))):
            i += 1
        if not any(op.kind in ("scatter_gather", "fused_aggregate")
                   for op in ops[1:i]):
            return 1
        return i

    def streamable_agg_head(self):
        """``(prefix_ops, dropout_rate, linear_param, tail_model)`` when
        the op list starts with a parameter-free propagation prefix
        followed by the ``dropout -> linear`` head, with nothing later
        reading the tensors before the head: the SGC shape, whose prefix
        the host tier evaluates once with every stage on the host
        (core/streaming.py ``stream_prefix_to_host``) before epochs
        stream only the head.  None otherwise (no aggregation prefix:
        :meth:`streamable_head` covers that)."""
        ops = self._ops
        i = self._prefix_end()
        if i == 1 or i + 1 >= len(ops):
            return None
        if not (ops[i].kind == "dropout" and ops[i].inputs == (i - 1,)):
            return None
        if not (ops[i + 1].kind == "linear" and ops[i + 1].inputs == (i,)):
            return None
        if ops[i + 1].attrs.get("activation", AC_MODE_NONE) != AC_MODE_NONE:
            return None
        head_out = i + 1
        for op in ops[head_out + 1:]:
            if any(j < head_out for j in op.inputs):
                return None
        # the loss on the head output is fine (the classic SGC: the head
        # linear is the classifier, the tail only takes the loss)
        if self._loss_op is not None and self._loss_op < head_out:
            return None
        return (list(ops[1:i]), ops[i].attrs["rate"], ops[i + 1].param,
                self._split_tail(head_out))

    # ---- serving support ----

    GRAPH_OP_KINDS = ("scatter_gather", "fused_aggregate", "gat",
                      "indegree_norm")

    def precompute_split(self):
        """``(prefix_ops, head_model)`` when the op list is a
        parameter-free propagation prefix (``indegree_norm``,
        ``scatter_gather`` SUM/AVG, ``fused_aggregate``: the vocabulary
        core/streaming.py ``stream_prefix_to_host`` runs) followed by a
        purely dense remainder (the SGC shape the precomputed serving
        backend caches); None otherwise, as for the GCN.  The head
        shares this model's param names."""
        ops = self._ops
        i = self._prefix_end()
        if i == 1 or i >= len(ops):
            return None
        for op in ops[i:]:
            if op.kind in self.GRAPH_OP_KINDS or any(
                    j < i - 1 for j in op.inputs):
                return None
        if self._loss_op is not None and self._loss_op < i - 1:
            return None
        return list(ops[1:i]), self._split_tail(i - 1)

    def to_spec(self) -> Dict[str, Any]:
        """JSON-serialisable description of the built op list, the JAX
        package's format (``in_dim``, ``ops``, ``loss_op``,
        ``counters``): the serving manifest carries it, and a spec
        written by either package builds the same op list in the other
        (:meth:`from_spec`)."""
        return {
            "in_dim": self._ops[0].dim,
            "ops": [{"kind": op.kind, "inputs": list(op.inputs),
                     "dim": op.dim, "param": op.param,
                     "attrs": dict(op.attrs)}
                    for op in self._ops[1:]],
            "loss_op": self._loss_op,
            "counters": [self._n_linear, self._n_gat, self._n_eps],
        }

    @classmethod
    def from_spec(cls, spec: Dict[str, Any]) -> "Model":
        """Inverse of :meth:`to_spec`."""
        model = cls(in_dim=int(spec["in_dim"]))
        for op in spec["ops"]:
            model._ops.append(_Op(op["kind"], tuple(op["inputs"]),
                                  int(op["dim"]), op.get("param"),
                                  dict(op.get("attrs") or {})))
        model._loss_op = spec.get("loss_op")
        c = spec.get("counters") or [0, 0, 0]
        model._n_linear, model._n_gat, model._n_eps = (
            int(c[0]), int(c[1]), int(c[2]))
        return model

    # ---- params ----

    def init_params(self, generator: torch.Generator,
                    dtype: torch.dtype = torch.float32,
                    device="cpu") -> Dict[str, torch.Tensor]:
        """The JAX package's initialisers, in op order, drawn from
        ``generator`` (on ``device``): Glorot-uniform ``U(-s, s)``,
        ``s = sqrt(6/(in+out))`` (``initializer_kernel.cu:38-48``), for
        every linear weight; 0 for every ``scale_add`` eps (GIN-0); and
        for a gat op, per head, Glorot over the ``[2*dh] -> 1``
        projection the two ``[heads, dh]`` weights split
        (``s = sqrt(6/(2*dh+1))``), src then dst.  Stores them in
        :attr:`params` as trainable leaves and returns them as a plain
        dict.  The numbers differ from the JAX package's for the same
        seed; tests carry weights across with roc_tpu_torch/convert.py."""
        def uniform(name, shape, s):
            w = torch.empty(shape, dtype=dtype, device=device)
            self.params[name] = nn.Parameter(
                w.uniform_(-s, s, generator=generator))

        for op in self._ops:
            if op.kind == "linear":
                in_dim = op.attrs["in_dim"]
                uniform(op.param, (in_dim, op.dim),
                        float(np.sqrt(6.0 / (in_dim + op.dim))))
            elif op.kind == "scale_add":
                self.params[op.param] = nn.Parameter(
                    torch.zeros((), dtype=dtype, device=device))
            elif op.kind == "gat":
                heads = op.attrs.get("heads", 1)
                dh = op.dim // heads
                for suffix in ("src", "dst"):
                    uniform(f"{op.param}_{suffix}", (heads, dh),
                            float(np.sqrt(6.0 / (2 * dh + 1))))
        return dict(self.params.items())

    # ---- interpreter ----

    def _eval_op(self, i: int, vals: List[Optional[torch.Tensor]],
                 params: Dict[str, torch.Tensor], gctx: GraphContext,
                 generator: Optional[torch.Generator], train: bool) -> None:
        """``vals[i]``: op ``i`` on the values it reads."""
        op = self._ops[i]
        x = vals[op.inputs[0]] if op.inputs else None
        if op.kind == "dropout":
            vals[i] = dense.dropout(x, op.attrs["rate"], generator, train)
        elif op.kind == "linear":
            if gctx is not None and gctx.head_chunk \
                    and i == self._head_index() \
                    and x.shape[0] > gctx.head_chunk:
                vals[i] = dense.linear_chunked(
                    x, params[op.param], op.attrs["activation"],
                    gctx.head_chunk)
            else:
                vals[i] = dense.linear(x, params[op.param],
                                       op.attrs["activation"])
        elif op.kind == "indegree_norm":
            vals[i] = indegree_norm(x, gctx.in_degree)
        elif op.kind == "scatter_gather":
            vals[i] = gctx.aggregate(x, op.attrs["aggr"])
        elif op.kind == "fused_aggregate":
            vals[i] = gctx.aggregate_fused(
                x, op.attrs.get("activation", AC_MODE_NONE))
        elif op.kind == "activation":
            vals[i] = dense.activation(x, op.attrs["mode"])
        elif op.kind == "gat":
            vals[i] = gctx.gat_attention(
                x, params[f"{op.param}_src"], params[f"{op.param}_dst"],
                neg_slope=op.attrs["neg_slope"])
        elif op.kind == "add":
            vals[i] = vals[op.inputs[0]] + vals[op.inputs[1]]
        elif op.kind == "scale_add":
            eps = params[op.param].to(x.dtype)
            vals[i] = x + eps * vals[op.inputs[1]]
        elif op.kind == "mul":
            vals[i] = x * vals[op.inputs[1]]
        elif op.kind == "lerp":
            al = op.attrs["alpha"]
            vals[i] = (1.0 - al) * x + al * vals[op.inputs[1]]
        else:
            raise ValueError(f"unknown op kind {op.kind}")

    def _head_index(self) -> int:
        """The output head: the last linear op (the classifier of every
        family; the loss may sit on a later op), -1 without one."""
        return max((i for i, op in enumerate(self._ops)
                    if op.kind == "linear"), default=-1)

    def _out_index(self) -> int:
        return self._loss_op if self._loss_op is not None \
            else len(self._ops) - 1

    def _remat_segments(self, policy: str) -> List[Tuple[int, int, bool]]:
        """The op ranges ``[i, j)`` of ``remat=policy``, each with whether
        it runs under a checkpoint.  'save_aggregates': each run of dense
        ops between graph ops (:data:`AGGREGATE_KINDS`) is checkpointed,
        and the graph ops run outside, so their outputs are kept and
        never recomputed (the kernels are calls inside autograd
        Functions, which a checkpoint policy cannot name; the op list
        says where they are).  'full': a segment starts at each graph op
        and runs to the next, all checkpointed, so only the segments'
        inputs (a layer's input and what later ops read) are kept and the
        backward recomputes one layer at a time."""
        ops = self._ops
        n = len(ops)
        if policy == "full":
            starts = [1] + [k for k in range(2, n)
                            if ops[k].kind in AGGREGATE_KINDS]
            return [(i, j, True) for i, j in zip(starts, starts[1:] + [n])]
        segs: List[Tuple[int, int, bool]] = []
        i = 1
        while i < n:
            if ops[i].kind in AGGREGATE_KINDS:
                segs.append((i, i + 1, False))
                i += 1
                continue
            j = i
            while j < n and ops[j].kind not in AGGREGATE_KINDS:
                j += 1
            segs.append((i, j, True))
            i = j
        return segs

    def _apply_remat(self, params, feats, gctx, generator, train,
                     policy: str) -> torch.Tensor:
        """The op list over :meth:`_remat_segments`: each checkpointed
        segment goes through :func:`remat_call`, with the values it reads
        from earlier ops as its inputs and the values later ops (or the
        output) read as its outputs."""
        ops = self._ops
        n = len(ops)
        out_idx = self._out_index()
        vals: List[Optional[torch.Tensor]] = [None] * n
        vals[0] = feats
        for i, j, ckpt in self._remat_segments(policy):
            if not ckpt:
                for m in range(i, j):
                    self._eval_op(m, vals, params, gctx, generator, train)
                continue
            ins = sorted({k for op in ops[i:j] for k in op.inputs if k < i})
            outs = [k for k in range(i, j) if k == out_idx or any(
                k in ops[m].inputs for m in range(j, n))]

            def run(*xs, i=i, j=j, ins=ins, outs=outs):
                local: List[Optional[torch.Tensor]] = [None] * n
                for k, x in zip(ins, xs):
                    local[k] = x
                for m in range(i, j):
                    self._eval_op(m, local, params, gctx, generator, train)
                return tuple(local[k] for k in outs)

            for k, v in zip(outs, remat_call(run, generator,
                                             *[vals[k] for k in ins])):
                vals[k] = v
        return vals[out_idx]

    def apply(self, params: Dict[str, torch.Tensor], feats: torch.Tensor,
              gctx: GraphContext, generator: Optional[torch.Generator] = None,
              train: bool = True, remat: Optional[str] = None
              ) -> torch.Tensor:
        """Run the recorded op list; returns the logits tensor.  In
        training each dropout op draws its own mask from ``generator``,
        in op order, once per call.  ``remat`` (None, 'full',
        'save_aggregates'; :data:`REMAT_POLICIES`) recomputes activations
        in the backward instead of saving them: 'full' all but each
        layer's input, 'save_aggregates' all but the graph ops' outputs
        (:meth:`_remat_segments`).  Either gives the same values and
        gradients, the same dropout masks included."""
        if (train and generator is None and
                any(op.kind == "dropout" and op.attrs["rate"] > 0
                    for op in self._ops)):
            raise ValueError("a torch.Generator is required in train mode "
                             "for models with dropout; pass generator= or "
                             "use train=False")
        if remat is not None and remat not in REMAT_POLICIES:
            raise ValueError(f"unknown remat policy {remat!r}; expected "
                             f"one of {REMAT_POLICIES}")
        if remat is not None:
            return self._apply_remat(params, feats, gctx, generator, train,
                                     remat)
        vals: List[Optional[torch.Tensor]] = [None] * len(self._ops)
        vals[0] = feats
        for i in range(1, len(self._ops)):
            self._eval_op(i, vals, params, gctx, generator, train)
        return vals[self._out_index()]

    def loss_fn(self, params: Dict[str, torch.Tensor], feats: torch.Tensor,
                labels: torch.Tensor, mask: torch.Tensor, gctx: GraphContext,
                generator: Optional[torch.Generator] = None,
                train: bool = True, remat: Optional[str] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(summed masked CE, logits): the objective whose gradient is the
        reference's ``softmax - onehot`` on train rows
        (``softmax_kernel.cu:19-33``).  ``remat`` as :meth:`apply` (the
        loss, over ``[V, classes]``, keeps what it saves)."""
        logits = self.apply(params, feats, gctx, generator=generator,
                            train=train, remat=remat)
        return masked_softmax_cross_entropy(logits, labels, mask), logits
