"""Degree-bucketed ELL neighbour sum, K4 (``roc_tpu/kernels/ell_spmm.py
ell_aggregate_pallas``).

:func:`ell_aggregate` launches one CUDA kernel per bucket
(csrc/ell_spmm.cu) for a tensor on the card, and runs
:func:`ell_aggregate_plain` for a tensor on the CPU; there is no
fallback from one to the other.  ``ell_aggregate.launches`` counts
kernel launches (``launches_by_dtype`` by dtype).

The contract differs from the JAX function's in one respect: ``feats``
carries no appended zero row.  Ids equal to ``feats.shape[0]`` (the
table's dummy) add nothing, and each bucket row is written to its
output row ``row_id`` (core/ell.py ``EllTable.row_id``) instead of
through a concatenate-and-permute, which saves one ``[V+1, F]`` copy
per layer.  Rows of degree 0 come out 0, as before.

``feats`` is float32 or bfloat16 (the kernel's ``_f32`` or ``_bf16``
instance; any other dtype is refused on the card).  The kernel walks
the columns in slices of ``slice_cols`` (slicing.py: 16, 32, 64, 128, or
0 for unsliced; by default the race's choice for F and the dtype, see
:func:`default_slice_cols`).  It sums a row's neighbours in a fixed
order in fp32 registers and rounds once to ``feats.dtype``, so each
instance gives the same bits on every launch; the instances' orders
differ from each other and from the plain version's fp32 ``torch.sum``,
so they agree to fp32 rounding (``rtol=1e-5, atol=1e-5 * max|row|``) in
fp32, and in bf16 to one bf16 ulp of the row's magnitude (two fp32 sums
a few fp32 ulps apart round to the same bf16 value or to neighbours).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..ops.aggregate import DEFAULT_BUDGET_ELEMS, ell_bucket_sum
from . import _build, slicing


def _check(feats: torch.Tensor, ell_idx: Sequence[torch.Tensor],
           ell_row_id: Sequence[torch.Tensor]) -> None:
    if feats.dim() != 2:
        raise ValueError(f"ell_aggregate: feats must be [R, F], got "
                         f"{tuple(feats.shape)}")
    if len(ell_idx) != len(ell_row_id):
        raise ValueError("ell_aggregate: one row_id array per bucket")
    for idx, rid in zip(ell_idx, ell_row_id):
        if idx.dim() != 2 or rid.dim() != 1 or rid.shape[0] != idx.shape[0]:
            raise ValueError(
                f"ell_aggregate: bucket idx [rows, width] and row_id "
                f"[rows] expected, got {tuple(idx.shape)} and "
                f"{tuple(rid.shape)}")
        if idx.device != feats.device or rid.device != feats.device:
            raise ValueError("ell_aggregate: tables and feats on different "
                             "devices")


# K4's F = 256 winner per dtype (slicing.py)
_WIDE = {torch.float32: 32, torch.bfloat16: 64}


def default_slice_cols(F: int, dtype: torch.dtype = torch.float32) -> int:
    """K4's slice width for F columns of ``dtype`` (slicing.py):
    unsliced up to ``slicing.NARROW_F``, the dtype's F = 256 winner
    above.  In fp32 the race in chip_smoke.py (PERF.md) puts 32 and 64
    level at F = 256, both 2x the unsliced schedule, except that 64,
    whose slice (V * 256 bytes) is larger than the 50 MB L2, sometimes
    runs ~8 % slower; 32 does not.  In bf16 the race's winner is 64,
    the bytes of fp32's 32, tied with 128 (PERF.md)."""
    return slicing.default_slice_cols(F, wide=_WIDE.get(dtype, 32))


def ell_aggregate_plain(feats: torch.Tensor,
                        ell_idx: Sequence[torch.Tensor],
                        ell_row_id: Sequence[torch.Tensor], num_rows: int,
                        budget_elems: int = DEFAULT_BUDGET_ELEMS
                        ) -> torch.Tensor:
    """K4's plain version: append the zero row the dummy id reads, sum
    each bucket (ops/aggregate.py, row-segmented), scatter the bucket
    rows to their output rows (padding rows land in a discarded slot)."""
    F = feats.shape[1]
    full = torch.cat([feats, feats.new_zeros((1, F))], dim=0)
    out = feats.new_zeros((num_rows + 1, F))
    for idx, rid in zip(ell_idx, ell_row_id):
        sums = ell_bucket_sum(full, idx, budget_elems)
        out.index_copy_(0, rid.clamp(max=num_rows).long(), sums)
    return out[:num_rows]


def ell_aggregate(feats: torch.Tensor, ell_idx: Sequence[torch.Tensor],
                  ell_row_id: Sequence[torch.Tensor], num_rows: int,
                  slice_cols: Optional[int] = None,
                  edges: Optional[Sequence[int]] = None) -> torch.Tensor:
    """``out[v] = sum(feats[ids of v])`` over the ELL buckets.

    feats: float32 or bfloat16 [R, F], no zero row (the dummy id is R).
    ell_idx: int32 ``[rows_b, width_b]`` per bucket.
    ell_row_id: int32 ``[rows_b]`` per bucket, the output row of each
    bucket row (padding rows carry ``num_rows``).
    slice_cols: the kernel's column slice width, one of
    ``slicing.SLICE_COLS``; None takes :func:`default_slice_cols`.  The
    plain version on the CPU has no slices and ignores it.
    edges: the real ids of each bucket (not the dummy), for the work
    tally (``_build.kernel_ops``); None counts every slot.
    Returns [num_rows, F] in ``feats.dtype``."""
    _check(feats, ell_idx, ell_row_id)
    S = slicing.resolve("ell_aggregate", slice_cols,
                        default_slice_cols(feats.shape[1], feats.dtype))
    with _build.kernel_region(ell_aggregate, (feats, ell_idx, ell_row_id),
                              feats.dtype, feats.shape[1], S) as region:
        if feats.device.type == "cpu":
            region.out = out = ell_aggregate_plain(feats, ell_idx,
                                                   ell_row_id, num_rows)
            return out
        for t in (*ell_idx, *ell_row_id):
            if t.dtype != torch.int32 or not t.is_contiguous():
                raise TypeError("ell_aggregate: tables must be contiguous "
                                "int32")
        if not feats.is_contiguous():
            raise TypeError("ell_aggregate: the CUDA kernel takes "
                            "contiguous feats")
        fn = _build.entry("ell_aggregate", feats.dtype)
        R, F = feats.shape
        region.out = out = feats.new_zeros((num_rows, F))
        stream = _build.stream_ptr(feats.device)
        with _build.named("ell_aggregate"):
            for b, (idx, rid) in enumerate(zip(ell_idx, ell_row_id)):
                rows, width = idx.shape
                _build.check("ell_aggregate", fn(
                    feats.data_ptr(), idx.data_ptr(), rid.data_ptr(),
                    out.data_ptr(), rows, width, R, num_rows, F, S, stream))
                region.launch(_build.kernel_ops(
                    "ell_aggregate", rows,
                    rows * width if edges is None else edges[b], F))
    return out


_build.zero_launches(ell_aggregate)
