"""Graph attention aggregation (GAT) on the degree-bucketed ELL layout
(``roc_tpu/ops/attention.py gat_aggregate_ell``)::

    e_ij   = LeakyReLU(a_src . h_j + a_dst . h_i)   for j in N(i)
    alpha  = softmax_j(e_ij)
    out_i  = sum_j alpha_ij h_j

per head, the heads' outputs concatenated.  Every row's neighbourhood
lies in one bucket row, so the edge softmax is a masked reduction over
the bucket's width axis.  The JAX package computes it with XLA ops
outside any Pallas kernel; here it is plain PyTorch ops on every route,
differentiated by autograd (attention is nonlinear, so the symmetric
trick of the sums does not apply).

Numerics follow the JAX function: the scores, their max, the exponents
and the softmax run in fp32 whatever the activations' dtype (in float64
for float64 activations), and alpha is cast back to it; LeakyReLU is
``where(e >= 0, e, neg_slope * e)``, slope 1 at 0 as ``jax.nn.leaky_relu``
(``F.leaky_relu``'s backward takes ``neg_slope`` there); a row of padding
alone has max ``-inf``, which the ``isfinite`` guard replaces by 0 so the
exponents are 0 and not NaN, and the denominator is clamped at 1e-20.

The gathers are row-segmented under ``budget_elems``, counting ``F + 3K``
elements per (row, width) slot (the feature gather plus three fp32 score
tensors).  A segmented bucket recomputes each segment in the backward
(``torch.utils.checkpoint``, the JAX function's ``jax.checkpoint`` on its
scan body): otherwise autograd keeps every segment's ``[rows, W, F]``
gather, about 4.8 GB a layer at ogbn-arxiv's 4.7 M edges and F = 256.
The default budget, :data:`ATTN_BUDGET_ELEMS`, is 8x the JAX package's
2^24; a row's result does not depend on its segment, so the budget
changes memory and launch counts, not values.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch.utils.checkpoint import checkpoint

from .aggregate import rows

# 2^27 elements a segment (512 MiB of fp32 gather).  At the JAX package's
# 2^24 a GAT step at ogbn-arxiv's shape ran ~118 checkpointed segments
# and ~10^4 eager launches: 964 ms of wall for 116 ms of device time on
# the H100 (88 % idle, chip_smoke.py phase 12, PERF.md).
ATTN_BUDGET_ELEMS = 1 << 27


def _score_dtype(dtype: torch.dtype) -> torch.dtype:
    """fp32 for fp32 and bf16 activations, float64 for float64."""
    return torch.promote_types(dtype, torch.float32)


def gat_aggregate_ell(full: torch.Tensor, s_full: torch.Tensor,
                      d_local: torch.Tensor, ell_idx: Sequence[torch.Tensor],
                      ell_row_id: Sequence[torch.Tensor],
                      ell_row_pos: torch.Tensor, num_rows: int,
                      neg_slope: float = 0.2,
                      budget_elems: int = ATTN_BUDGET_ELEMS
                      ) -> torch.Tensor:
    """Attention-weighted neighbour sum over the ELL buckets, K heads.

    full: ``[G+1, K*dh]`` gathered features with a trailing zero row (the
      dummy id ``G``); the feature axis is the K head slices of width dh.
    s_full: ``[G+1, K]`` per-source logits ``a_src^k . h_j^k`` (the dummy
      slot last; its value is never used).
    d_local: ``[num_rows + 1, K]`` per-destination logits with a trailing
      slot that padding bucket rows (``row_id == num_rows``) read.
    ell_idx / ell_row_id / ell_row_pos: core/ell.py's tables.
    Rows with no neighbour return 0.  Returns ``[num_rows, K*dh]`` in
    ``full.dtype``."""
    F = full.shape[1]
    K = s_full.shape[1]
    if F % K:
        raise ValueError(f"feature width {F} is not a multiple of the "
                         f"{K} heads")
    unit = F + 3 * K
    dummy = full.shape[0] - 1
    sdt = _score_dtype(full.dtype)

    def seg_out(idx, rid):
        e = (rows(s_full, idx).to(sdt)
             + d_local.index_select(0, rid).to(sdt)[:, None, :])  # [r,w,K]
        e = torch.where(e >= 0, e, neg_slope * e)
        valid = (idx != dummy)[:, :, None]
        e = torch.where(valid, e, float("-inf"))
        m = e.amax(dim=1, keepdim=True)
        m = torch.where(torch.isfinite(m), m, 0.0)
        w = torch.where(valid, torch.exp(e - m), 0.0)
        den = w.sum(dim=1, keepdim=True).clamp_min(1e-20)
        alpha = (w / den).to(full.dtype)
        g = rows(full, idx).reshape(*idx.shape, K, F // K)
        return torch.einsum("rwk,rwkd->rkd", alpha, g).reshape(
            idx.shape[0], F)

    outs = []
    for idx, rid in zip(ell_idx, ell_row_id):
        R, W = idx.shape
        if R * W * unit <= budget_elems:
            outs.append(seg_out(idx, rid))
            continue
        segs = -(-R * W * unit // budget_elems)
        seg_rows = -(-R // segs)
        for r0 in range(0, R, seg_rows):
            i, r = idx[r0:r0 + seg_rows], rid[r0:r0 + seg_rows]
            outs.append(checkpoint(seg_out, i, r, use_reentrant=False)
                        if torch.is_grad_enabled() else seg_out(i, r))
    outs.append(full.new_zeros((1, F)))
    return torch.cat(outs, dim=0).index_select(0, ell_row_pos)[:num_rows]
