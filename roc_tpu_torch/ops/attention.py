"""Graph attention aggregation (GAT) on the degree-bucketed ELL layout
(``roc_tpu/ops/attention.py gat_aggregate_ell``) and on the flat
width-8 sub-row layout (``gat_aggregate_flat8``, route 'attn_flat8',
below)::

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

from typing import Optional, Sequence

import torch
from torch.utils.checkpoint import checkpoint

from .aggregate import _steps, rows

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


def resolve_dh_chunk(num_rows: int, heads: int, dh: int,
                     carry_budget: int = 768 << 20) -> Optional[int]:
    """Per-head feature width of one numerator pass of
    :func:`gat_aggregate_flat8`, the JAX package's rule: the numerator
    ``[num_rows+1, heads*dh]`` fp32 is sized against twice itself (the
    forward and its cotangent live together in training) within
    ``carry_budget``; None when the whole width fits."""
    bytes_per_dh = (num_rows + 1) * heads * 4
    train_budget = carry_budget // 2
    if bytes_per_dh * dh <= train_budget:
        return None
    return max(1, min(dh, train_budget // bytes_per_dh))


def _flat8_scores(s_full, d_local, idx, dst, dummy, neg_slope, sdt):
    """Masked scores ``[m, W, K]`` of sub-rows ``idx [m, W]`` into rows
    ``dst [m]``, and their validity."""
    e = (rows(s_full, idx).to(sdt)
         + d_local.index_select(0, dst).to(sdt)[:, None, :])
    e = torch.where(e >= 0, e, neg_slope * e)
    valid = (idx != dummy)[:, :, None]
    return torch.where(valid, e, float("-inf")), valid


def _flat8_weights(s_full, d_local, rowmax, idx, dst, dummy, neg_slope,
                   sdt):
    e, valid = _flat8_scores(s_full, d_local, idx, dst, dummy, neg_slope,
                             sdt)
    return torch.where(valid, torch.exp(e - rowmax.index_select(0, dst)
                                        [:, None, :]), 0.0)


def _flat8_den(s_full, d_local, rowmax, idx, dst, dummy, neg_slope, sdt):
    return _flat8_weights(s_full, d_local, rowmax, idx, dst, dummy,
                          neg_slope, sdt).sum(dim=1)


def _flat8_num(s_full, d_local, rowmax, feats, idx, dst, dummy, neg_slope,
               sdt, with_den):
    """The numerator parts ``[m, K*dc]`` (fp32, float64 for float64) of
    the sub-rows, and with ``with_den`` their weight sums ``[m, K]``."""
    w = _flat8_weights(s_full, d_local, rowmax, idx, dst, dummy, neg_slope,
                       sdt)
    K = w.shape[2]
    acc = torch.promote_types(feats.dtype, torch.float32)
    g = rows(feats, idx).reshape(*idx.shape, K, -1)
    part = torch.einsum("swk,swkd->skd", w.to(feats.dtype).to(acc),
                        g.to(acc)).reshape(idx.shape[0], -1)
    return (part, w.sum(dim=1)) if with_den else (part,)


def gat_aggregate_flat8(full: torch.Tensor, s_full: torch.Tensor,
                        d_local: torch.Tensor, f8_idx: torch.Tensor,
                        f8_dst: torch.Tensor, num_rows: int,
                        neg_slope: float = 0.2,
                        dh_chunk: Optional[int] = None,
                        budget_elems: int = ATTN_BUDGET_ELEMS
                        ) -> torch.Tensor:
    """Attention over the flat width-8 sub-row layout (core/ell.py
    ``flat_sum_from_graph``), the numerics of :func:`gat_aggregate_ell`
    with the edge softmax split across a row's sub-rows:

    pass 1: each row's score maximum, a scatter-max over its sub-rows,
      with no gradient (the softmax does not depend on the shift);
    pass 2: ``w = exp(e - rowmax)`` masked; the numerator (w-weighted
      feature sums, fp32) and the denominator ``index_add_`` per row;
      ``out = num / max(den, 1e-20)``.

    ``dh_chunk`` (:func:`resolve_dh_chunk`) splits each head's features
    into slices of that width, one numerator pass each after a pass of
    the denominator alone, so the numerator buffer is
    ``[num_rows+1, K*dh_chunk]``.  Sub-rows go in runs of consecutive
    chunks under ``budget_elems`` (the pass's gathered width plus ``3K``
    elements a slot); under
    autograd each run is recomputed in the backward
    (``torch.utils.checkpoint``, the JAX function's ``jax.checkpoint``).

    full ``[G+1, K*dh]`` with the dummy row G last; s_full ``[G+1, K]``;
    d_local ``[num_rows+1, K]`` (chunk padding reads its last slot);
    f8_idx ``[n_chunks, seg, 8]``, f8_dst ``[n_chunks, seg]``."""
    F = full.shape[1]
    K = s_full.shape[1]
    if F % K:
        raise ValueError(f"feature width {F} is not a multiple of the "
                         f"{K} heads")
    dh = F // K
    dummy = full.shape[0] - 1
    sdt = _score_dtype(full.dtype)
    n, seg, W = f8_idx.shape

    def steps(width):
        """Runs of chunks whose sub-rows gather ``width`` elements a slot
        besides the three score tensors, within ``budget_elems``."""
        return _steps(n, seg * W * (width + 3 * K), budget_elems)

    def tables(c0, c1):
        return (f8_idx[c0:c1].reshape(-1, W).to(torch.int32),
                f8_dst[c0:c1].reshape(-1).to(torch.int64))

    with torch.no_grad():
        rowmax = torch.full((num_rows + 1, K), float("-inf"), dtype=sdt,
                            device=full.device)
        for c0, c1 in steps(0):
            idx, dst = tables(c0, c1)
            e, _ = _flat8_scores(s_full, d_local, idx, dst, dummy,
                                 neg_slope, sdt)
            rowmax.scatter_reduce_(0, dst[:, None].expand(-1, K),
                                   e.amax(dim=1), "amax", include_self=True)
        rowmax = torch.where(torch.isfinite(rowmax), rowmax, 0.0)

    grad = torch.is_grad_enabled() and (full.requires_grad
                                        or s_full.requires_grad
                                        or d_local.requires_grad)

    def run(fn, *args):
        return checkpoint(fn, *args, use_reentrant=False) if grad \
            else fn(*args)

    acc = torch.promote_types(full.dtype, torch.float32)
    den = torch.zeros((num_rows + 1, K), dtype=sdt, device=full.device)
    slices = ([(0, dh)] if dh_chunk is None or dh_chunk >= dh else
              [(lo, min(dh_chunk, dh - lo)) for lo in range(0, dh, dh_chunk)])
    fused = len(slices) == 1
    if not fused:
        for c0, c1 in steps(0):
            idx, dst = tables(c0, c1)
            den.index_add_(0, dst, run(_flat8_den, s_full, d_local, rowmax,
                                       idx, dst, dummy, neg_slope, sdt))
    outs = []
    for lo, dc in slices:
        feats = full if fused else full.reshape(-1, K, dh)[:, :, lo:lo + dc] \
            .reshape(full.shape[0], K * dc)
        num = torch.zeros((num_rows + 1, K * dc), dtype=acc,
                          device=full.device)
        for c0, c1 in steps(K * dc):
            idx, dst = tables(c0, c1)
            got = run(_flat8_num, s_full, d_local, rowmax, feats, idx, dst,
                      dummy, neg_slope, sdt, fused)
            num.index_add_(0, dst, got[0])
            if fused:
                den.index_add_(0, dst, got[1])
        outs.append(num)
    den = den[:num_rows].clamp_min(1e-20)
    return torch.cat([(num[:num_rows].reshape(num_rows, K, -1)
                       / den[:, :, None]).to(full.dtype) for num in outs],
                     dim=2).reshape(num_rows, F)
