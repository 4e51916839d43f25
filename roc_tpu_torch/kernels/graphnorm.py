"""Row-scale kernels of the GCN normalization chain
(``roc_tpu/kernels/graphnorm.py``).  The fused chain
(models/builder.py ``GraphContext._fused_sum_fwd``) is K1 -> the
neighbour sum (K4, kernels/ell_spmm.py, or K3, kernels/spmm.py) -> K2.

- :func:`indegree_norm` (K1): ``x * d[:, None]`` with
  ``d = inv_sqrt_degree(in_degree)``, the pre-scale of the fused chain;
  given ``relu_out=y``, its masked form ``where(y > 0, x, 0) * d[:, None]``
  (one kernel, the relu backward's pre-scale of the cotangent; a select,
  as ``jax.nn.relu``'s VJP is, so a NaN or inf in ``x`` where ``y <= 0``
  gives 0).
- :func:`scale_act` (K2): ``act(x * scale[:, None])``, its epilogue.

Each kernel wrapper takes its plain PyTorch version for a tensor on the
CPU and launches the CUDA kernel (csrc/graphnorm.cu) for a tensor on the
card; there is no fallback from one to the other.  ``x`` is float32 or
bfloat16 (the kernel's ``_f32`` or ``_bf16`` instance; any other dtype
is refused on the card); the math is fp32 in both, rounded once to
``x.dtype``.  ``launches`` on each wrapper counts kernel launches and
``launches_by_dtype`` splits them by dtype, so a run can show the path
went through the kernel of its dtype; ``indegree_norm.masked_launches``
counts the masked form's launches apart (they are in the other two
counts too).  Both kernels compute what their plain versions compute,
in the same fp32 operations and the same one rounding: the results are
bit-equal (0 ulp) in either dtype, at every F and alignment.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..ops.norm import inv_sqrt_degree
from . import _build

ACTS = ("none", "relu")


def _check_rows(x: torch.Tensor, vec: torch.Tensor, name: str) -> None:
    if x.dim() != 2 or vec.dim() != 1 or vec.shape[0] != x.shape[0]:
        raise ValueError(f"{name}: x must be [V, F] and the row vector "
                         f"[V]; got {tuple(x.shape)} and "
                         f"{tuple(vec.shape)}")
    if vec.device != x.device:
        raise ValueError(f"{name}: x on {x.device}, row vector on "
                         f"{vec.device}")


def _check_cuda(name: str, x: torch.Tensor, *ints: torch.Tensor,
                floats: Sequence[torch.Tensor] = (),
                same: Sequence[torch.Tensor] = ()):
    """Checks the card's inputs (``same``: tensors like ``x``, checked by
    the caller); returns the entry point for ``x.dtype`` (TypeError for a
    dtype with no instance)."""
    for t in ints:
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: index/degree tensors must be int32, "
                            f"got {t.dtype}")
    for t in floats:
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: scale must be float32, got {t.dtype}")
    for t in (x, *ints, *floats, *same):
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    return _build.entry(name, x.dtype)


def indegree_norm_plain(x: torch.Tensor, in_degree: torch.Tensor,
                        relu_out: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """K1's plain version: fp32 math, cast back to ``x.dtype``; with
    ``relu_out``, of ``torch.where(relu_out > 0, x, 0)``."""
    if relu_out is not None:
        x = torch.where(relu_out > 0, x, 0)
    d = inv_sqrt_degree(in_degree)
    return (x.to(torch.float32) * d[:, None]).to(x.dtype)


def indegree_norm(x: torch.Tensor, in_degree: torch.Tensor,
                  relu_out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K1: ``x * rsqrt(max(deg, 1))[:, None]``, 0 where ``deg == 0``.
    x: float32 or bfloat16 [V, F]; in_degree: int32 [V].  ``relu_out``:
    a relu's output ``y`` like ``x`` (shape, dtype, device); then K1 of
    ``where(y > 0, x, 0)`` (the masked kernel)."""
    _check_rows(x, in_degree, "indegree_norm")
    if relu_out is not None and (relu_out.shape != x.shape
                                 or relu_out.dtype != x.dtype
                                 or relu_out.device != x.device):
        raise ValueError(f"indegree_norm: relu_out must be like x "
                         f"{tuple(x.shape)} {x.dtype} on {x.device}; got "
                         f"{tuple(relu_out.shape)} {relu_out.dtype} on "
                         f"{relu_out.device}")
    if x.device.type == "cpu":
        return indegree_norm_plain(x, in_degree, relu_out)
    if relu_out is None:
        fn = _check_cuda("indegree_norm", x, in_degree)
        inputs = (x.data_ptr(), in_degree.data_ptr())
    else:
        fn = _check_cuda("indegree_norm_masked", x, in_degree,
                         same=(relu_out,))
        inputs = (x.data_ptr(), relu_out.data_ptr(), in_degree.data_ptr())
    out = torch.empty_like(x)
    with _build.named("indegree_norm"):
        _build.check("indegree_norm", fn(
            *inputs, out.data_ptr(), x.shape[0], x.shape[1],
            _build.stream_ptr(x.device)))
    _build.launched(indegree_norm, x.dtype, _build.kernel_ops(
        "indegree_norm", x.shape[0], 0, x.shape[1]))
    if relu_out is not None:
        indegree_norm.masked_launches += 1
    return out


def scale_act_plain(x: torch.Tensor, scale: torch.Tensor,
                    act: str = "none") -> torch.Tensor:
    """K2's plain version: ``act(x * scale[:, None])`` in fp32, cast
    back to ``x.dtype``."""
    y = x.to(torch.float32) * scale.to(torch.float32)[:, None]
    if act == "relu":
        y = torch.relu(y)
    return y.to(x.dtype)


def scale_act(x: torch.Tensor, scale: torch.Tensor,
              act: str = "none") -> torch.Tensor:
    """K2: ``act(x * scale[:, None])``; ``act`` is 'none' or 'relu'.
    x: float32 or bfloat16 [V, F]; scale: float32 [V]."""
    if act not in ACTS:
        raise ValueError(f"unknown act {act!r}; expected 'none'|'relu'")
    _check_rows(x, scale, "scale_act")
    if x.device.type == "cpu":
        return scale_act_plain(x, scale, act)
    fn = _check_cuda("scale_act", x, floats=(scale,))
    out = torch.empty_like(x)
    with _build.named("scale_act"):
        _build.check("scale_act", fn(
            x.data_ptr(), scale.data_ptr(), out.data_ptr(), x.shape[0],
            x.shape[1], int(act == "relu"), _build.stream_ptr(x.device)))
    _build.launched(scale_act, x.dtype, _build.kernel_ops(
        "scale_act", x.shape[0], 0, x.shape[1]))
    return out


_build.zero_launches(indegree_norm, scale_act)
indegree_norm.masked_launches = 0
