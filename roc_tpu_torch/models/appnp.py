"""APPNP, predict then propagate (``roc_tpu/models/appnp.py``; Gasteiger
et al., ICLR'19)::

    H = MLP(X);  Z_0 = H;  Z_{k+1} = (1 - alpha) * S Z_k + alpha * H

with ``S = D^-1/2 A D^-1/2`` (a fused K1 -> K4/K3 -> K2 chain per hop on
the kernel routes) and a fixed teleport ``alpha`` (the builder's
``lerp``).  ``layers``: input width, the MLP's ReLU-separated hidden
widths, classes.
"""

from __future__ import annotations

from typing import Sequence

from ..ops.dense import AC_MODE_NONE
from .builder import Model


def build_appnp(layers: Sequence[int], k: int = 10,
                alpha: float = 0.1,
                dropout_rate: float = 0.5) -> Model:
    if not 0.0 <= alpha <= 1.0:
        raise ValueError(f"alpha must be in [0, 1], got {alpha}")
    if k < 1:
        raise ValueError(
            f"k must be >= 1 (k=0 is a bare MLP with no propagation "
            f"— surely not what an APPNP user asked for), got {k}")
    model = Model(in_dim=layers[0])
    t = model.input()
    n = len(layers)
    for i in range(1, n):
        t = model.dropout(t, dropout_rate)
        t = model.linear(t, layers[i], AC_MODE_NONE)
        if i != n - 1:
            t = model.relu(t)
    h = t
    for _ in range(k):
        t = model.indegree_norm(t)
        t = model.scatter_gather(t)
        t = model.indegree_norm(t)
        t = model.lerp(t, h, alpha)
    model.softmax_cross_entropy(t)
    return model
