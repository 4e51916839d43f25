"""Plain neighbour sums and maxima (``roc_tpu/ops/aggregate.py``).  The
sums are the routes the hand-written kernels are held to:

- :func:`aggregate_ell`, the degree-bucketed ELL sum (route 'ell',
  kernel K4 in kernels/ell_spmm.py): per width bucket, gather
  ``feats[idx]`` and sum the width axis; then inverse-permute the
  concatenated bucket outputs back to row order.
- :func:`aggregate_segment`, the edge-list sum (route 'segment', kernel
  K3 in kernels/spmm.py): gather ``feats[src]`` and ``index_add_`` it
  into the destination rows.

Both work in pieces of at most ``budget_elems`` gathered scalars (row
segments of a bucket, chunks of edges).  Without them the transient is
the whole gather: at Reddit scale (E ~ 112M, F = 256) over 100 GB.

Both sum in fp32: a reduced-precision input (bf16) is widened, summed in
fp32 and rounded once to its dtype, as the JAX package's ``aggregate_ell``
and the hand-written kernels do (a bf16 ``sum`` or ``index_add_`` would
round while it accumulates).  fp32 inputs are summed as they are.

The neighbour maxima (:func:`aggregate_ell_max`, :func:`aggregate_segment_max`;
MIN is ``-max(-x)`` at the call site) are plain ops on every route: the
JAX package computes them with XLA ops outside any Pallas kernel.  They
mask the padding/dummy sources to ``-inf`` and differentiate by autograd
with the JAX package's tie rule, the gradient split evenly among the
tied maxima (``amax`` and ``scatter_reduce('amax')`` do so; ``max(dim)``
would route it all to one index).  Rows with no real neighbour come out
``-inf`` here; the caller maps them to 0.
"""

from __future__ import annotations

from typing import Sequence

import torch

# 2**24 scalars = 64 MiB of fp32 per gathered segment, the JAX
# package's default
DEFAULT_BUDGET_ELEMS = 1 << 24


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """The accumulator of a sum over ``dtype``: fp32 for bf16."""
    return torch.float32 if dtype == torch.bfloat16 else dtype


def ell_bucket_sum(feats: torch.Tensor, idx: torch.Tensor,
                   budget_elems: int = DEFAULT_BUDGET_ELEMS
                   ) -> torch.Tensor:
    """``feats[idx].sum(1)`` for one bucket ``idx [rows, width]``, in row
    segments of at most ``budget_elems`` gathered scalars; a bf16 sum is
    taken in fp32 and rounded once."""
    R, W = idx.shape
    F = feats.shape[1]
    acc = _acc_dtype(feats.dtype)

    def rowsum(i):
        return feats[i].sum(dim=1, dtype=acc).to(feats.dtype)

    seg_rows = max(1, budget_elems // max(W * F, 1))
    if seg_rows >= R:
        return rowsum(idx)
    out = torch.empty((R, F), dtype=feats.dtype, device=feats.device)
    for r0 in range(0, R, seg_rows):
        out[r0:r0 + seg_rows] = rowsum(idx[r0:r0 + seg_rows])
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


def aggregate_segment(feats: torch.Tensor, edge_src: torch.Tensor,
                      edge_dst: torch.Tensor, num_rows: int,
                      budget_elems: int = DEFAULT_BUDGET_ELEMS
                      ) -> torch.Tensor:
    """``out[d] = sum over edges (s, d) of feats[s]``.

    feats: [R(+1), F] (a trailing zero row for padding edges to read).
    edge_src/edge_dst: int [E], any order.  Returns [num_rows, F].
    Edges go in chunks of at most ``budget_elems // F`` gathered rows,
    each added into the output in place (differentiable by autograd);
    a bf16 input is added into an fp32 output, rounded once at the end."""
    F = feats.shape[1]
    acc = _acc_dtype(feats.dtype)
    out = feats.new_zeros((num_rows, F), dtype=acc)
    step = max(1, budget_elems // max(F, 1))
    for e0 in range(0, edge_src.shape[0], step):
        out.index_add_(0, edge_dst[e0:e0 + step].long(),
                       feats[edge_src[e0:e0 + step].long()].to(acc))
    return out.to(feats.dtype)


def rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx]`` for an index table ``idx [r, w]``, as ``index_select``:
    its backward is an ``index_add_`` (atomic adds on the card), where
    advanced indexing's backward sorts the ids and accumulates each
    repeated one serially (seconds a step at ogbn-arxiv's shape on the
    H100, where a source repeats ~28 times)."""
    return x.index_select(0, idx.reshape(-1)).reshape(*idx.shape,
                                                      *x.shape[1:])


def aggregate_ell_max(feats: torch.Tensor, ell_idx: Sequence[torch.Tensor],
                      ell_row_pos: torch.Tensor, num_rows: int,
                      budget_elems: int = DEFAULT_BUDGET_ELEMS
                      ) -> torch.Tensor:
    """ELL neighbour MAX, the JAX function's contract: ``feats [R+1, F]``
    with the dummy id ``R`` masked to ``-inf`` (not read as its zero
    row), per bucket a masked ``amax`` over the width axis in row
    segments of at most ``budget_elems`` gathered scalars (a row's whole
    neighbourhood stays in one segment, so ties split as in one max),
    then ``ell_row_pos`` back to row order; degree-0 rows read a
    trailing ``-inf`` slot."""
    F = feats.shape[1]
    dummy = feats.shape[0] - 1
    neg = torch.tensor(float("-inf"), dtype=feats.dtype,
                       device=feats.device)

    def seg_max(i):
        g = rows(feats, i)                             # [r, W, F]
        return torch.where((i != dummy)[:, :, None], g, neg).amax(dim=1)

    outs = []
    for idx in ell_idx:
        R, W = idx.shape
        seg_rows = max(1, budget_elems // max(W * F, 1))
        outs.extend(seg_max(idx[r0:r0 + seg_rows])
                    for r0 in range(0, R, seg_rows))
    outs.append(feats.new_full((1, F), float("-inf")))
    return torch.cat(outs, dim=0).index_select(0, ell_row_pos)[:num_rows]


def aggregate_segment_max(feats: torch.Tensor, edge_src: torch.Tensor,
                          edge_dst: torch.Tensor, num_rows: int
                          ) -> torch.Tensor:
    """Edge-list neighbour MAX (the JAX ``segment`` branch of
    ``_max_fwd``): gather ``feats[src]``, mask the dummy id ``R`` to
    ``-inf`` and scatter-max into a ``-inf`` output (an output holding 0
    would count as a tie of a zero maximum).  Like the JAX route it
    materialises the ``[E, F]`` gather in one piece: splitting it would
    change how a tie across two pieces shares the gradient."""
    F = feats.shape[1]
    dummy = feats.shape[0] - 1
    src = edge_src.long()
    g = torch.where((src != dummy)[:, None], feats.index_select(0, src),
                    torch.tensor(float("-inf"), dtype=feats.dtype,
                                 device=feats.device))
    out = feats.new_full((num_rows, F), float("-inf"))
    return out.scatter_reduce(0, edge_dst.long()[:, None].expand(-1, F), g,
                              "amax", include_self=False)


IMPLS = ("segment", "cuda_csr")


def aggregate(feats: torch.Tensor, edge_src: torch.Tensor,
              edge_dst: torch.Tensor, num_rows: int,
              impl: str = "segment", chunk: int = 512) -> torch.Tensor:
    """The edge-list dispatcher (``roc_tpu/ops/aggregate.py aggregate``)
    over the ported impls: 'segment' (plain) or 'cuda_csr' (kernel K3,
    the JAX package's 'pallas_csr').  ``feats`` is ``[R+1, F]`` with a
    trailing zero row, as there; edges are sorted by destination and
    padded to a ``chunk`` multiple for 'cuda_csr'.  The sums agree to
    fp32 rounding (another summation order)."""
    if impl == "segment":
        return aggregate_segment(feats, edge_src, edge_dst, num_rows)
    if impl == "cuda_csr":
        from ..kernels.spmm import csr_spmm
        # K3 skips the dummy id instead of reading the zero row
        return csr_spmm(feats[:-1], edge_src, edge_dst, num_rows,
                        chunk=chunk)
    raise ValueError(f"aggregate impl {impl!r} is not ported; expected "
                     f"one of {IMPLS}")
