"""Carrying weights and settings between the JAX package and this one.

Weights keep the JAX layout (``linear_k`` is ``[in, out]``, the layer
computes ``x @ W``), so a conversion is a copy, never a transpose.  The
arguments are numpy arrays (or anything ``np.asarray`` takes, such as a
JAX array), so this module imports no JAX.

bf16 crosses with its bits: numpy has no bf16 of its own, so a JAX bf16
array is a numpy array of the dtype named ``bfloat16`` (registered by
the JAX package's dependencies), read here through a 16-bit integer view;
the way back views a bf16 tensor's bits as that dtype, which must be
registered in the process (it is wherever JAX has been imported).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

# The hand-written ELL route is 'pallas' in the JAX package, 'cuda' here;
# the hand-written CSR route is 'pallas_csr' there, 'cuda_csr' here; the
# edge-list sums and the large-graph layouts keep their names.
AGGR_IMPL_FROM_JAX = {"pallas": "cuda", "ell": "ell",
                      "pallas_csr": "cuda_csr", "segment": "segment",
                      "blocked": "blocked", "scan": "scan",
                      "sectioned": "sectioned", "flat_sum": "flat_sum",
                      "bdense": "bdense", "attn_flat8": "attn_flat8"}
AGGR_IMPL_TO_JAX = {v: k for k, v in AGGR_IMPL_FROM_JAX.items()}


BF16 = "bfloat16"


def _from_numpy(a: np.ndarray) -> torch.Tensor:
    if a.dtype.name == BF16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        try:
            bf16 = np.dtype(BF16)
        except TypeError as e:
            raise TypeError("a bf16 tensor needs a numpy bfloat16 dtype, "
                            "which importing JAX registers") from e
        return t.view(torch.int16).numpy().copy().view(bf16)
    return t.numpy().copy()


def params_from_jax(params: Dict[str, np.ndarray],
                    device="cpu") -> Dict[str, torch.Tensor]:
    """JAX-package parameters -> tensors on ``device``, same names and
    layout, same values (bf16 the same bits)."""
    return {k: _from_numpy(np.asarray(v)).to(device)
            for k, v in params.items()}


def params_to_jax(params: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The inverse of :func:`params_from_jax`: host numpy arrays (bf16
    as numpy's registered ``bfloat16`` dtype, the same bits)."""
    return {k: _to_numpy(v) for k, v in params.items()}


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
