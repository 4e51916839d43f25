"""GCNII, deep GCN by initial residual and identity mapping
(``roc_tpu/models/gcn2.py``; Chen et al., ICML'20).  Per layer l::

    P_l = S H_{l-1}
    M_l = (1 - alpha) P_l + alpha H_0
    H_l = relu((1 - beta_l) M_l + beta_l M_l W_l),  beta_l = log(lam/l + 1)

with ``S = D^-1/2 A D^-1/2`` (a fused K1 -> K4/K3 -> K2 chain on the kernel
routes) and both combines the builder's fixed-scalar ``lerp``.
``layers`` is ``F-H-...-H-C``: one GCNII layer per hidden entry, all of
width H (the initial residual adds H_0 into every layer).
"""

from __future__ import annotations

import math
from typing import Sequence

from ..ops.dense import AC_MODE_NONE
from .builder import Model


def build_gcn2(layers: Sequence[int], alpha: float = 0.1,
               lam: float = 0.5,
               dropout_rate: float = 0.5) -> Model:
    if len(layers) < 3:
        raise ValueError(
            "GCNII needs at least one hidden layer (F-H-C); for a "
            "propagation-free linear model use --model sgc")
    hidden = layers[1]
    if any(h != hidden for h in layers[1:-1]):
        raise ValueError(
            f"GCNII hidden widths must all match (the initial "
            f"residual adds H_0 into every layer), got {layers[1:-1]}")
    if not 0.0 <= alpha <= 1.0:
        raise ValueError(f"alpha must be in [0, 1], got {alpha}")
    if lam <= 0.0:
        raise ValueError(f"lam must be > 0, got {lam}")
    model = Model(in_dim=layers[0])
    t = model.input()
    t = model.dropout(t, dropout_rate)
    t = model.linear(t, hidden, AC_MODE_NONE)
    t = model.relu(t)
    h0 = t
    n_layers = len(layers) - 2
    for l in range(1, n_layers + 1):
        beta = math.log(lam / l + 1.0)
        t = model.dropout(t, dropout_rate)
        t = model.indegree_norm(t)
        t = model.scatter_gather(t)
        t = model.indegree_norm(t)
        t = model.lerp(t, h0, alpha)          # initial residual
        w = model.linear(t, hidden, AC_MODE_NONE)
        t = model.lerp(t, w, beta)            # identity mapping
        t = model.relu(t)
    t = model.dropout(t, dropout_rate)
    t = model.linear(t, layers[-1], AC_MODE_NONE)
    model.softmax_cross_entropy(t)
    return model
