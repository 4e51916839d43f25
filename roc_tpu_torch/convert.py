"""Carrying weights and settings between the JAX package and this one.

Weights keep the JAX layout (``linear_k`` is ``[in, out]``, the layer
computes ``x @ W``), so a conversion is a copy, never a transpose.  The
arguments are numpy arrays (or anything ``np.asarray`` takes, such as a
JAX array), so this module imports no JAX.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

# The hand-written ELL route is 'pallas' in the JAX package, 'cuda' here;
# the hand-written CSR route is 'pallas_csr' there, 'cuda_csr' here.
AGGR_IMPL_FROM_JAX = {"pallas": "cuda", "ell": "ell",
                      "pallas_csr": "cuda_csr", "segment": "segment"}
AGGR_IMPL_TO_JAX = {v: k for k, v in AGGR_IMPL_FROM_JAX.items()}


def params_from_jax(params: Dict[str, np.ndarray],
                    device="cpu") -> Dict[str, torch.Tensor]:
    """JAX-package parameters -> tensors on ``device``, same names and
    layout, same values."""
    return {k: torch.from_numpy(np.array(v, copy=True)).to(device)
            for k, v in params.items()}


def params_to_jax(params: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The inverse of :func:`params_from_jax`: host numpy arrays."""
    return {k: v.detach().cpu().numpy().copy() for k, v in params.items()}


def aggr_impl_from_jax(impl: str) -> str:
    if impl not in AGGR_IMPL_FROM_JAX:
        raise ValueError(f"JAX aggr_impl {impl!r} has no ported route; "
                         f"ported: {sorted(AGGR_IMPL_FROM_JAX)}")
    return AGGR_IMPL_FROM_JAX[impl]


def aggr_impl_to_jax(impl: str) -> str:
    if impl not in AGGR_IMPL_TO_JAX:
        raise ValueError(f"unknown aggr_impl {impl!r}; expected one of "
                         f"{sorted(AGGR_IMPL_TO_JAX)}")
    return AGGR_IMPL_TO_JAX[impl]
