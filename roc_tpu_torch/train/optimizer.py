"""Adam with the reference's semantics (``roc_tpu/train/optimizer.py``;
``optimizer.h:34-50``, ``optimizer_kernel.cu:43-103``):

- before each update ``beta1_t *= beta1; beta2_t *= beta2;
  alpha_t = lr * sqrt(1 - beta2_t) / (1 - beta1_t)``;
- per parameter ``gt = grad + weight_decay * W`` (L2-coupled, on
  parameters with ``ndim > 0`` only), the ``m``/``v`` moving averages,
  then ``W -= alpha_t * mt / (sqrt(vt) + eps)``.

``torch.optim.Adam`` puts ``eps`` after its bias correction, which gives
other numbers, so this is written out as plain functions on tensors.
The step scalars (``beta1_t``, ``beta2_t``, ``alpha_t``, the decayed lr)
are host float32 values computed in the JAX package's fp32 order: the
update launches no extra device work for them and never syncs.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch


class AdamState(NamedTuple):
    step: int
    beta1_t: np.float32        # beta1 ** step
    beta2_t: np.float32
    m: Dict[str, torch.Tensor]
    v: Dict[str, torch.Tensor]


@dataclass(frozen=True)
class AdamConfig:
    # defaults mirror AdamOptimizer's constructor (optimizer.h:36-38)
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8
    weight_decay: float = 0.0


def adam_init(params: Dict[str, torch.Tensor]) -> AdamState:
    zeros = {k: torch.zeros_like(p, dtype=torch.float32,
                                 requires_grad=False)
             for k, p in params.items()}
    return AdamState(step=0, beta1_t=np.float32(1.0),
                     beta2_t=np.float32(1.0), m=zeros,
                     v={k: z.clone() for k, z in zeros.items()})


@torch.no_grad()
def adam_update(params: Dict[str, torch.Tensor],
                grads: Dict[str, torch.Tensor], state: AdamState,
                lr: float, cfg: AdamConfig
                ) -> Tuple[Dict[str, torch.Tensor], AdamState]:
    """One optimizer step.  ``lr`` is the (decayed) base alpha; the bias
    correction is applied here.  Updates the parameter and moment
    tensors in place (so a parameter stays the same leaf tensor) and
    returns ``(params, new_state)``."""
    f32 = np.float32
    beta1_t = f32(state.beta1_t * f32(cfg.beta1))
    beta2_t = f32(state.beta2_t * f32(cfg.beta2))
    alpha_t = float(f32(lr) * np.sqrt(f32(1.0) - beta2_t)
                    / (f32(1.0) - beta1_t))
    for k, w in params.items():
        m, v = state.m[k], state.v[k]
        w32 = w.to(torch.float32)
        # L2-coupled decay on weight matrices only; 0-d params (GIN's
        # learnable eps) are exempt, as in the JAX package
        wd = cfg.weight_decay if w.dim() > 0 else 0.0
        gt = grads[k].to(torch.float32) + wd * w32
        mt = cfg.beta1 * m + (1.0 - cfg.beta1) * gt
        vt = cfg.beta2 * v + (1.0 - cfg.beta2) * gt * gt
        w.copy_(w32 - alpha_t * mt / (torch.sqrt(vt) + cfg.epsilon))
        m.copy_(mt)
        v.copy_(vt)
    return params, AdamState(step=state.step + 1, beta1_t=beta1_t,
                             beta2_t=beta2_t, m=state.m, v=state.v)


def decayed_lr(base_lr: float, epoch: int, decay_rate: float,
               decay_steps: int) -> np.float32:
    """Staircase decay: ``alpha`` times ``decay_rate`` every
    ``decay_steps`` epochs (``gnn.cc:100-101``), in fp32."""
    k = np.float32(epoch // max(decay_steps, 1))
    return np.float32(base_lr) * np.power(np.float32(decay_rate), k)
