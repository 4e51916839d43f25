"""GCN model family: the reference driver's layer stack
(``roc_tpu/models/gcn.py``, ``gnn.cc:75-92``).  For each layer::

    t = dropout(t, rate); t = linear(t, layers[i])
    t = indegree_norm(t); t = scatter_gather(t); t = indegree_norm(t)
    if not last: t = relu(t)
    if len(layers) > 3: t = add(t, linear(input, t.dim))   # residual

``layers`` follows the reference CLI's ``-layers 602-256-41``: layers[0]
is the input feature width, layers[-1] the class count.
"""

from __future__ import annotations

from typing import Sequence

from ..ops.dense import AC_MODE_NONE
from .builder import Model


def build_gcn(layers: Sequence[int], dropout_rate: float = 0.5) -> Model:
    model = Model(in_dim=layers[0])
    t = model.input()
    n = len(layers)
    for i in range(1, n):
        t = model.dropout(t, dropout_rate)
        res = t
        t = model.linear(t, layers[i], AC_MODE_NONE)
        t = model.indegree_norm(t)
        t = model.scatter_gather(t)
        t = model.indegree_norm(t)
        if i != n - 1:
            t = model.relu(t)
        if n > 3:
            res = model.linear(res, t.dim, AC_MODE_NONE)
            t = model.add(t, res)
    model.softmax_cross_entropy(t)
    return model
