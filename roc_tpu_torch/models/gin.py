"""GIN, sum aggregation + MLP (``roc_tpu/models/gin.py``).  Per layer::

    h = MLP(x + sum_{u in N(v)} x_u),   MLP = linear -> ReLU -> linear

The graphs carry self edges, so the explicit ``x +`` is a second self
contribution.  ``learn_eps=True`` makes the self weight learnable: on a
self-edged graph ``(1+eps) x + sum_{u != v} x_u == agg + eps * x``, the
builder's ``scale_add`` with a zero-initialised 0-d ``eps``.  The first
layer's sum reads the input features, which need no gradient, so its
backward never runs.
"""

from __future__ import annotations

from typing import Sequence

from ..ops.dense import AC_MODE_NONE, AC_MODE_RELU
from .builder import AGGR_SUM, Model


def build_gin(layers: Sequence[int], dropout_rate: float = 0.5,
              mlp_hidden: int = 0, learn_eps: bool = False) -> Model:
    """``mlp_hidden == 0`` sizes each MLP's hidden width ``max(in, out)``
    of its layer, never the bare class count (a biasless ReLU hidden that
    narrow can die for a whole class)."""
    model = Model(in_dim=layers[0])
    t = model.input()
    n = len(layers)
    for i in range(1, n):
        t = model.dropout(t, dropout_rate)
        agg = model.scatter_gather(t, aggr=AGGR_SUM)
        if learn_eps:
            t = model.scale_add(agg, t)
        else:
            t = model.add(t, agg)
        hidden = mlp_hidden or max(layers[i], layers[i - 1])
        t = model.linear(t, hidden, AC_MODE_RELU)
        t = model.linear(t, layers[i], AC_MODE_NONE)
        if i != n - 1:
            t = model.relu(t)
    model.softmax_cross_entropy(t)
    return model
