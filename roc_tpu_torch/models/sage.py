"""GraphSAGE model family (``roc_tpu/models/sage.py``).  Per layer::

    h = W_self . x + W_neigh . mean_{u in N(v)} x_u

(concat-then-linear as the sum of two linears), ReLU between layers.
``use_norm=True`` replaces the mean with the symmetric GraphNorm form
``D^-1/2 A D^-1/2`` (indegree_norm, SUM, indegree_norm: the fused K1 ->
K4/K3 -> K2 chain on the kernel routes); ``aggregator='pool'`` is
Hamilton et al.'s max-pooling aggregator: a learned ReLU projection,
then the neighbourhood MAX.
"""

from __future__ import annotations

from typing import Sequence

from ..ops.dense import AC_MODE_NONE, AC_MODE_RELU
from .builder import AGGR_AVG, AGGR_MAX, AGGR_SUM, Model


def build_sage(layers: Sequence[int], dropout_rate: float = 0.5,
               use_norm: bool = False,
               aggregator: str = "mean") -> Model:
    """``aggregator``: 'mean' or 'pool'; ``use_norm`` applies to 'mean'
    only."""
    if aggregator not in ("mean", "pool"):
        raise ValueError(f"unknown SAGE aggregator {aggregator!r}; "
                         "expected 'mean' or 'pool'")
    if aggregator == "pool" and use_norm:
        raise ValueError("use_norm applies to the mean aggregator "
                         "(GraphNorm replaces the mean, not the pool)")
    model = Model(in_dim=layers[0])
    t = model.input()
    n = len(layers)
    for i in range(1, n):
        t = model.dropout(t, dropout_rate)
        self_proj = model.linear(t, layers[i], AC_MODE_NONE)
        neigh = t
        if aggregator == "pool":
            neigh = model.linear(neigh, layers[i], AC_MODE_RELU)
            neigh = model.scatter_gather(neigh, aggr=AGGR_MAX)
        elif use_norm:
            neigh = model.indegree_norm(neigh)
            neigh = model.scatter_gather(neigh, aggr=AGGR_SUM)
            neigh = model.indegree_norm(neigh)
        else:
            neigh = model.scatter_gather(neigh, aggr=AGGR_AVG)
        neigh_proj = model.linear(neigh, layers[i], AC_MODE_NONE)
        t = model.add(self_proj, neigh_proj)
        if i != n - 1:
            t = model.relu(t)
    model.softmax_cross_entropy(t)
    return model
