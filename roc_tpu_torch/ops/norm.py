"""In-degree normalization (the reference's InDegreeNorm / GraphNorm op,
``graphnorm_kernel.cu:45-55``): ``out[v,:] = in[v,:] / sqrt(deg(v))``.
Applied before and after the neighbour sum it gives the symmetric GCN
normalization ``D^-1/2 A D^-1/2``.

``d = 1/sqrt(max(deg, 1))`` is computed as a correctly rounded divide of
a correctly rounded square root, on the host and on the card alike, so
the plain path, the CUDA kernels (kernels/graphnorm.py) and
:func:`inv_sqrt_degree_np` give the same fp32 bits.  Zero-degree
(padding) rows map to 0.
"""

from __future__ import annotations

import numpy as np
import torch


def inv_sqrt_degree(in_degree: torch.Tensor) -> torch.Tensor:
    """fp32 ``deg^-1/2`` with zero-degree rows mapped to 0."""
    deg = in_degree.to(torch.float32)
    return torch.where(deg > 0, 1.0 / torch.sqrt(deg.clamp(min=1.0)),
                       torch.zeros_like(deg))


def inv_sqrt_degree_np(in_degree: np.ndarray) -> np.ndarray:
    """Host-side :func:`inv_sqrt_degree` (fp32), the same numbers."""
    deg = np.asarray(in_degree, dtype=np.float32)
    return np.where(deg > 0, 1.0 / np.sqrt(np.maximum(deg, 1.0)),
                    0.0).astype(np.float32)


def indegree_norm(x: torch.Tensor, in_degree: torch.Tensor) -> torch.Tensor:
    """x: [V, F]; in_degree: int32 [V].  Returns ``x / sqrt(deg)`` per
    row, the plain form the unfused model path runs (the hand-written
    kernel is kernels/graphnorm.py ``indegree_norm``)."""
    return x * inv_sqrt_degree(in_degree)[:, None].to(x.dtype)
