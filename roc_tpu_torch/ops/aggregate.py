"""Plain degree-bucketed ELL neighbour sum (``roc_tpu/ops/aggregate.py
aggregate_ell``): per width bucket, gather ``feats[idx]`` and sum the
width axis; then inverse-permute the concatenated bucket outputs back
to row order.  This is the route ``aggr_impl='ell'`` runs, and the
reference the CUDA kernel of kernels/ell_spmm.py is held to.

A bucket whose gathered block would exceed ``budget_elems`` scalars is
summed in row segments.  Without them the transient is the whole
``[rows, width, F]`` gather: at Reddit scale (E ~ 115M, F = 256) that is
over 100 GB.
"""

from __future__ import annotations

from typing import Sequence

import torch

# 2**24 scalars = 64 MiB of fp32 per gathered segment, the JAX
# package's default
DEFAULT_BUDGET_ELEMS = 1 << 24


def ell_bucket_sum(feats: torch.Tensor, idx: torch.Tensor,
                   budget_elems: int = DEFAULT_BUDGET_ELEMS
                   ) -> torch.Tensor:
    """``feats[idx].sum(1)`` for one bucket ``idx [rows, width]``, in row
    segments of at most ``budget_elems`` gathered scalars."""
    R, W = idx.shape
    F = feats.shape[1]
    seg_rows = max(1, budget_elems // max(W * F, 1))
    if seg_rows >= R:
        return feats[idx].sum(dim=1)
    out = torch.empty((R, F), dtype=feats.dtype, device=feats.device)
    for r0 in range(0, R, seg_rows):
        out[r0:r0 + seg_rows] = feats[idx[r0:r0 + seg_rows]].sum(dim=1)
    return out


def aggregate_ell(feats: torch.Tensor, ell_idx: Sequence[torch.Tensor],
                  ell_row_pos: torch.Tensor, num_rows: int,
                  budget_elems: int = DEFAULT_BUDGET_ELEMS
                  ) -> torch.Tensor:
    """feats: [R+1, F] gathered features with a trailing zero row (the
    dummy id R points at it).  ell_idx: int32 ``[rows_b, width_b]`` per
    bucket.  ell_row_pos: int32 [num_rows] slot of each output row in
    the concatenated bucket outputs (zero slot == total bucket rows)."""
    F = feats.shape[1]
    outs = [ell_bucket_sum(feats, idx, budget_elems) for idx in ell_idx]
    outs.append(torch.zeros((1, F), dtype=feats.dtype, device=feats.device))
    cat = torch.cat(outs, dim=0)
    return cat.index_select(0, ell_row_pos)[:num_rows]
