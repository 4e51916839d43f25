"""CSR neighbour sum over a destination-sorted edge list, K3
(``roc_tpu/kernels/spmm.py csr_spmm_pallas``).

:func:`csr_spmm` launches one CUDA kernel (csrc/spmm.cu: a warp per
destination row, its edge range found by binary search in ``edge_dst``)
for a tensor on the card, and runs :func:`csr_spmm_plain` for a tensor
on the CPU; there is no fallback from one to the other.
``csr_spmm.launches`` counts kernel launches.

The arguments are the JAX function's ``(feats, edge_src, edge_dst,
num_rows, chunk)`` with one difference, as for K4: ``feats`` carries no
appended zero row.  Source ids equal to ``feats.shape[0]`` (the padding
edges' dummy) add nothing, and rows with no edges come out 0.  The edge
count must be a ``chunk`` multiple, the JAX contract; the kernel itself
does not need it.

The kernel sums a row's edges in edge order in fp32 registers; the plain
version adds chunks with ``index_add_``, whose order differs, so the two
agree to fp32 rounding (``rtol=1e-5, atol=1e-5 * max|row|``), not bit
for bit.
"""

from __future__ import annotations

import torch

from ..ops.aggregate import DEFAULT_BUDGET_ELEMS, aggregate_segment
from . import _build


def _check(feats: torch.Tensor, edge_src: torch.Tensor,
           edge_dst: torch.Tensor, chunk: int) -> None:
    if feats.dim() != 2:
        raise ValueError(f"csr_spmm: feats must be [R, F], got "
                         f"{tuple(feats.shape)}")
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


def csr_spmm(feats: torch.Tensor, edge_src: torch.Tensor,
             edge_dst: torch.Tensor, num_rows: int,
             chunk: int = 512) -> torch.Tensor:
    """``out[v] = sum(feats[src] for edges (src, v))``.

    feats: float [R, F], no zero row (the dummy id is R).
    edge_src/edge_dst: int32 [Ep], sorted by ``edge_dst``, ``Ep`` a
    multiple of ``chunk``.
    Returns [num_rows, F]."""
    _check(feats, edge_src, edge_dst, chunk)
    if feats.device.type == "cpu":
        return csr_spmm_plain(feats, edge_src, edge_dst, num_rows)
    for t in (edge_src, edge_dst):
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise TypeError("csr_spmm: edge arrays must be contiguous int32")
    if feats.dtype != torch.float32 or not feats.is_contiguous():
        raise TypeError(f"csr_spmm: the CUDA kernel takes contiguous "
                        f"float32 feats, got {feats.dtype}")
    R, F = feats.shape
    out = torch.empty((num_rows, F), dtype=feats.dtype, device=feats.device)
    lib = _build.library()
    _build.check("csr_spmm", lib.roc_csr_spmm_f32(
        feats.data_ptr(), edge_src.data_ptr(), edge_dst.data_ptr(),
        out.data_ptr(), edge_src.shape[0], R, num_rows, F,
        _build.stream_ptr(feats.device)))
    csr_spmm.launches += 1
    return out


csr_spmm.launches = 0
