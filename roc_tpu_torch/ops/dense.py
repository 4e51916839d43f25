"""Dense ops: linear (whole or in row blocks), activations, dropout and
the element-wise add and multiply (``roc_tpu/ops/dense.py``).

- Activations: none, relu, sigmoid and elu (alpha 1, as ``jax.nn.elu``;
  both take slope 1 at 0 in the backward, the negative branch's).

- Linear is ``y = x @ W`` with no bias and ``W`` laid out ``[in, out]``
  as in the JAX package (so weights cross between the packages
  untransposed, roc_tpu_torch/convert.py).  fp32 products run in full
  fp32: :func:`set_fp32_matmul_precision` switches TF32 off, the
  counterpart of the JAX package's ``Precision.HIGHEST``.  bf16 products
  (``x`` and ``W`` in bf16, the mixed and bfloat16 modes) accumulate in
  fp32 and round once to bf16, the counterpart of its
  ``preferred_element_type=float32`` then ``astype(x.dtype)``: the same
  function switches off cuBLAS's reduced-precision bf16 reduction.
- Dropout is inverted dropout with scale ``1/(1-rate)`` in training and
  the identity at inference, in ``x.dtype``; its mask is drawn from an
  explicit ``torch.Generator``.
"""

from __future__ import annotations

from typing import Optional

import torch

AC_MODE_NONE = "none"
AC_MODE_RELU = "relu"
AC_MODE_SIGMOID = "sigmoid"
# beyond the reference's ActiMode set, for the GAT family (models/gat.py)
AC_MODE_ELU = "elu"

_ACTIVATIONS = {
    AC_MODE_NONE: lambda x: x,
    AC_MODE_RELU: torch.relu,
    AC_MODE_SIGMOID: torch.sigmoid,
    AC_MODE_ELU: torch.nn.functional.elu,
}


def set_fp32_matmul_precision() -> None:
    """Full-fp32 matrix products on the card: no TF32 in matmuls or
    convolutions, and bf16 products reduced in fp32 (cuBLAS may
    otherwise reduce split-K partial sums in bf16).  PyTorch's defaults
    already say so for fp32 matmuls; the port states them rather than
    relying on them."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def linear(x: torch.Tensor, w: torch.Tensor,
           activation: str = AC_MODE_NONE) -> torch.Tensor:
    """x: [V, in] @ w: [in, out], with an optional activation, in the
    inputs' dtype (fp32 accumulation in bf16, see the module doc)."""
    return _ACTIVATIONS[activation](torch.matmul(x, w))


def linear_chunked(x: torch.Tensor, w: torch.Tensor,
                   activation: str = AC_MODE_NONE,
                   block: int = 65536) -> torch.Tensor:
    """:func:`linear` over ``block``-row blocks of ``x``, concatenated:
    the chunked output head (``TrainConfig.head_chunk``, the JAX
    package's ``linear_chunked``).  Each output row is the same dot
    product over the whole ``in`` axis as :func:`linear`'s; the weight
    gradient sums the row blocks' products, another fp32 order.  One
    block or fewer is :func:`linear` itself."""
    if x.shape[0] <= block:
        return linear(x, w, activation)
    return torch.cat([linear(xb, w, activation)
                      for xb in torch.split(x, block, dim=0)], dim=0)


def activation(x: torch.Tensor, mode: str) -> torch.Tensor:
    return _ACTIVATIONS[mode](x)


def element_add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a + b


def element_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a * b


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator], train: bool
            ) -> torch.Tensor:
    """Inverted dropout; the identity when not training or rate == 0.
    Training needs ``generator`` (on ``x``'s device)."""
    if not train or rate <= 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in training needs a torch.Generator")
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))
