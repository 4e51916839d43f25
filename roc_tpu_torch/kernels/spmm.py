"""CSR neighbour sum over a destination-sorted edge list, K3
(``roc_tpu/kernels/spmm.py csr_spmm_pallas``).

:func:`csr_spmm` runs two CUDA kernels (csrc/spmm.cu) for a tensor on
the card: the pre-pass :func:`csr_row_ptr`, which finds each row's edge
range once per call (``row_ptr[v]``, the first edge whose ``edge_dst``
is at least v, one thread per row), and the main pass, a warp per
(destination row, column slice) summing that range.  For a tensor on the
CPU it runs :func:`csr_spmm_plain`; there is no fallback from one to the
other.  ``csr_spmm.launches`` counts main-pass launches, one per call;
the pre-pass counts its own in ``csr_row_ptr.launches``.

The arguments are the JAX function's ``(feats, edge_src, edge_dst,
num_rows, chunk)`` with one difference, as for K4: ``feats`` carries no
appended zero row.  Source ids equal to ``feats.shape[0]`` (the padding
edges' dummy) add nothing, and rows with no edges come out 0.  The edge
count must be a ``chunk`` multiple, the JAX contract; the kernel itself
does not need it.

A caller that sums the same edges many times may pass the row ranges
once, built on the host (``row_ptr``, int64 ``[num_rows + 1]``): the
pre-pass is then skipped, and rows past the ranges' last edge, padding
included, are never read.  The ring halo (parallel/ring.py) does so for
each of its pairs, whose padding would otherwise all fall in the last
row's range; it then passes no ``edge_dst`` at all (the kernel never
reads it, and the plain version rebuilds it from the ranges,
:func:`dst_from_row_ptr`).

``feats`` is float32 or bfloat16 (the main pass's ``_f32`` or ``_bf16``
instance; any other dtype is refused on the card; the pre-pass does not
depend on it).  The main pass walks the columns in slices of
``slice_cols`` (slicing.py: 16, 32, 64, 128, or 0 for unsliced; by
default the race's choice for F and the dtype, see
:func:`default_slice_cols`).  It sums a row's edges in a fixed order in
fp32 registers and rounds once to ``feats.dtype``, so each instance
gives the same bits on every launch; the instances' orders differ from
each other and from the plain version's fp32 ``index_add_``, so they
agree to fp32 rounding (``rtol=1e-5, atol=1e-5 * max|row|``) in fp32,
and in bf16 to one bf16 ulp of the row's magnitude.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.aggregate import DEFAULT_BUDGET_ELEMS, aggregate_segment
from . import _build, slicing


def _check(feats: torch.Tensor, edge_src: torch.Tensor,
           edge_dst: Optional[torch.Tensor], chunk: int) -> None:
    if feats.dim() != 2:
        raise ValueError(f"csr_spmm: feats must be [R, F], got "
                         f"{tuple(feats.shape)}")
    if edge_dst is None:
        edge_dst = edge_src
    if (edge_src.dim() != 1 or edge_dst.dim() != 1
            or edge_src.shape != edge_dst.shape):
        raise ValueError(f"csr_spmm: edge_src and edge_dst must be [E], "
                         f"got {tuple(edge_src.shape)} and "
                         f"{tuple(edge_dst.shape)}")
    if chunk < 1 or edge_src.shape[0] % chunk:
        raise ValueError(f"csr_spmm: pad edges to a chunk multiple "
                         f"({edge_src.shape[0]} edges, chunk {chunk})")
    if edge_src.device != feats.device or edge_dst.device != feats.device:
        raise ValueError("csr_spmm: edges and feats on different devices")


def csr_spmm_plain(feats: torch.Tensor, edge_src: torch.Tensor,
                   edge_dst: torch.Tensor, num_rows: int,
                   budget_elems: int = DEFAULT_BUDGET_ELEMS) -> torch.Tensor:
    """K3's plain version: append the zero row the dummy id reads, then
    the chunked gather + ``index_add_`` of ops/aggregate.py."""
    full = torch.cat([feats, feats.new_zeros((1, feats.shape[1]))], dim=0)
    return aggregate_segment(full, edge_src, edge_dst, num_rows,
                             budget_elems)


# K3's F = 256 winner per dtype (slicing.py)
_WIDE = {torch.float32: 64, torch.bfloat16: 128}


def default_slice_cols(F: int, dtype: torch.dtype = torch.float32) -> int:
    """K3's slice width for F columns of ``dtype`` (slicing.py):
    unsliced up to ``slicing.NARROW_F``, the dtype's F = 256 winner
    above: in fp32 64, the fastest instance of the race in chip_smoke.py
    at F = 256 (PERF.md), 2x the unsliced schedule; in bf16 128, the
    bytes of fp32's 64 and the bf16 race's winner (PERF.md)."""
    return slicing.default_slice_cols(F, wide=_WIDE.get(dtype, 64))


def dst_from_row_ptr(row_ptr: torch.Tensor, num_edges: int
                     ) -> torch.Tensor:
    """The dst-sorted ``edge_dst`` (int32 ``[num_edges]``) whose row
    ranges are ``row_ptr``: edge e of row v's range gets v, and the edges
    past the last range (padding) the last row, as the tables lay them
    out."""
    n = row_ptr.shape[0] - 1
    out = torch.full((num_edges,), max(n - 1, 0), dtype=torch.int32,
                     device=row_ptr.device)
    # the CPU path's plain version only: a host tensor
    # roc-lint: ok=host-sync-hot-path
    end = int(row_ptr[-1])
    out[:end] = torch.repeat_interleave(
        torch.arange(n, dtype=torch.int32, device=row_ptr.device),
        torch.diff(row_ptr))
    return out


def csr_row_ptr_plain(edge_dst: torch.Tensor, num_rows: int
                      ) -> torch.Tensor:
    """The pre-pass's plain version: ``row_ptr[v]``, the first edge with
    ``edge_dst >= v``, for v in [0, num_rows], int64."""
    keys = torch.arange(num_rows + 1, dtype=edge_dst.dtype,
                        device=edge_dst.device)
    return torch.searchsorted(edge_dst, keys)


def csr_row_ptr(edge_dst: torch.Tensor, num_rows: int) -> torch.Tensor:
    """Each row's edge range in the dst-sorted ``edge_dst`` (int32 [Ep]):
    int64 ``[num_rows + 1]``, ``row_ptr[v]`` the first edge with
    ``edge_dst >= v`` (so padding edges on the last row end that row's
    range at ``Ep``).  One CUDA launch, a thread per row, for a tensor on
    the card; the plain version for one on the CPU."""
    if edge_dst.dim() != 1:
        raise ValueError(f"csr_row_ptr: edge_dst must be [E], got "
                         f"{tuple(edge_dst.shape)}")
    with _build.kernel_region(csr_row_ptr, (edge_dst,)) as region:
        if edge_dst.device.type == "cpu":
            region.out = row_ptr = csr_row_ptr_plain(edge_dst, num_rows)
            return row_ptr
        if edge_dst.dtype != torch.int32 or not edge_dst.is_contiguous():
            raise TypeError("csr_row_ptr: edge_dst must be contiguous "
                            "int32")
        region.out = row_ptr = torch.empty(num_rows + 1, dtype=torch.int64,
                                           device=edge_dst.device)
        _build.check("csr_row_ptr", _build.library().roc_csr_row_ptr(
            edge_dst.data_ptr(), row_ptr.data_ptr(), edge_dst.shape[0],
            num_rows, _build.stream_ptr(edge_dst.device)))
        region.launch()
    return row_ptr


csr_row_ptr.launches = 0


def csr_spmm(feats: torch.Tensor, edge_src: torch.Tensor,
             edge_dst: Optional[torch.Tensor], num_rows: int,
             chunk: int = 512,
             slice_cols: Optional[int] = None,
             row_ptr: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``out[v] = sum(feats[src] for edges (src, v))``.

    feats: float32 or bfloat16 [R, F], no zero row (the dummy id is R).
    edge_src/edge_dst: int32 [Ep], sorted by ``edge_dst``, ``Ep`` a
    multiple of ``chunk``; ``edge_dst`` may be None when ``row_ptr`` is
    given.
    slice_cols: the main pass's column slice width, one of
    ``slicing.SLICE_COLS``; None takes :func:`default_slice_cols`.  The
    plain version on the CPU has no slices and ignores it.
    row_ptr: int64 ``[num_rows + 1]`` row ranges into the edges, built by
    the caller (the pre-pass is skipped; edges outside the ranges are not
    read); None runs the pre-pass :func:`csr_row_ptr`.  The plain
    version sums every edge, so ranges that leave out only padding edges
    give its result.
    The work tally (``_build.kernel_ops``) counts every slot of
    ``edge_src``, padding included.
    Returns [num_rows, F] in ``feats.dtype``."""
    _check(feats, edge_src, edge_dst, chunk)
    if edge_dst is None and row_ptr is None:
        raise ValueError("csr_spmm: pass edge_dst or row_ptr")
    if row_ptr is not None and (row_ptr.shape != (num_rows + 1,)
                                or row_ptr.device != feats.device):
        raise ValueError(f"csr_spmm: row_ptr must be [{num_rows + 1}] on "
                         f"{feats.device}, got {tuple(row_ptr.shape)} on "
                         f"{row_ptr.device}")
    S = slicing.resolve("csr_spmm", slice_cols,
                        default_slice_cols(feats.shape[1], feats.dtype))
    if feats.device.type == "cpu":
        if row_ptr is None:
            # the pre-pass the card runs, tallied and recorded as its
            # call (its plain version is not needed here)
            with _build.kernel_region(csr_row_ptr, (edge_dst,)) as region:
                region.out = ((num_rows + 1,), torch.int64, "cpu")
        with _build.kernel_region(csr_spmm, (feats, edge_src, edge_dst,
                                             row_ptr), feats.dtype,
                                  feats.shape[1], S) as region:
            if edge_dst is None:
                edge_dst = dst_from_row_ptr(row_ptr, edge_src.shape[0])
            region.out = out = csr_spmm_plain(feats, edge_src, edge_dst,
                                              num_rows)
        return out
    for t in (edge_src, edge_dst if edge_dst is not None else edge_src):
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise TypeError("csr_spmm: edge arrays must be contiguous int32")
    if not feats.is_contiguous():
        raise TypeError("csr_spmm: the CUDA kernel takes contiguous feats")
    fn = _build.entry("csr_spmm", feats.dtype)
    R, F = feats.shape
    if row_ptr is None:
        row_ptr = csr_row_ptr(edge_dst, num_rows)
    elif row_ptr.dtype != torch.int64 or not row_ptr.is_contiguous():
        raise TypeError("csr_spmm: row_ptr must be contiguous int64")
    with _build.kernel_region(csr_spmm, (feats, edge_src, row_ptr),
                              feats.dtype, F, S) as region:
        region.out = out = torch.empty((num_rows, F), dtype=feats.dtype,
                                       device=feats.device)
        with _build.named("csr_spmm"):
            _build.check("csr_spmm", fn(
                feats.data_ptr(), edge_src.data_ptr(), row_ptr.data_ptr(),
                out.data_ptr(), R, num_rows, F, S,
                _build.stream_ptr(feats.device)))
        region.launch(_build.kernel_ops("csr_spmm", num_rows,
                                        edge_src.shape[0], F))
    return out


_build.zero_launches(csr_spmm)
