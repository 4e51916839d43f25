"""GAT, graph attention networks (``roc_tpu/models/gat.py``; Velickovic
et al., ICLR'18).  Per layer::

    t = dropout(t); t = linear(t, layers[i]); t = gat_attention(t)
    if not last: t = elu(t)

The edge softmax runs on the ELL tables (ops/attention.py); the trainers
move an attention model off the edge-list routes
(train/trainer.py ``resolve_attention_impl``).
"""

from __future__ import annotations

from typing import Sequence

from ..ops.dense import AC_MODE_NONE
from .builder import Model


def build_gat(layers: Sequence[int], dropout_rate: float = 0.5,
              neg_slope: float = 0.2, heads: int = 1) -> Model:
    """``heads`` applies to the hidden layers (multi-head concat; each
    hidden width must divide by it); the output layer is single-head."""
    model = Model(in_dim=layers[0])
    t = model.input()
    n = len(layers)
    for i in range(1, n):
        last = i == n - 1
        t = model.dropout(t, dropout_rate)
        t = model.linear(t, layers[i], AC_MODE_NONE)
        t = model.gat_attention(t, neg_slope=neg_slope,
                                heads=1 if last else heads)
        if not last:
            t = model.elu(t)
    model.softmax_cross_entropy(t)
    return model
