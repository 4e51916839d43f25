"""SGC, Simple Graph Convolution (``roc_tpu/models/sgc.py``; Wu et al.,
ICML'19): ``logits = S^k X W`` with ``S = D^-1/2 A D^-1/2``, the k hops on
the raw features (each a fused K1 -> K4/K3 -> K2 chain on the kernel
routes, with no backward: the features need no gradient), then the
linear classifier.  Entries of ``layers`` between the first (input
width) and the last (classes) add ReLU-separated linears after the
propagation.
"""

from __future__ import annotations

from typing import Sequence

from ..ops.dense import AC_MODE_NONE
from .builder import Model


def build_sgc(layers: Sequence[int], k: int = 2,
              dropout_rate: float = 0.0) -> Model:
    if k < 1:
        raise ValueError(
            f"k must be >= 1 (k=0 is a propagation-free linear model "
            f"— surely not what an SGC user asked for), got {k}")
    model = Model(in_dim=layers[0])
    t = model.input()
    for _ in range(k):
        t = model.indegree_norm(t)
        t = model.scatter_gather(t)
        t = model.indegree_norm(t)
    n = len(layers)
    for i in range(1, n):
        t = model.dropout(t, dropout_rate)
        t = model.linear(t, layers[i], AC_MODE_NONE)
        if i != n - 1:
            t = model.relu(t)
    model.softmax_cross_entropy(t)
    return model
