"""The parameter-free propagation prefix, evaluated once with every
stage kept on the host (``roc_tpu/core/streaming.py
stream_prefix_to_host``): the SGC-style precompute ``S^k X`` the serving
tier's precomputed backend caches (serve/propagation.py).

Only this function of the JAX module is ported.  The JAX walk stages
feature blocks through host RAM so a graph larger than device memory
exports the way it trains (``StagingPool``, ``aggregate_to_host``, the
tile plans); here the whole ``[V, F]`` stage lives on the device while
its op runs, and the blocked walk waits for the out-of-core tier
(ROADMAP item 6).
"""

from __future__ import annotations

import numpy as np
import torch


def stream_prefix_to_host(graph, prefix_ops, feats_host: np.ndarray,
                          aggr_impl: str = "cuda", device=None,
                          chunk: int = 512, gctx=None,
                          capture=None) -> np.ndarray:
    """Evaluate a parameter-free norm/aggregation prefix (the dict
    descriptors serve/propagation.py ``prefix_descriptors`` makes of
    ``Model.precompute_split``'s op list) over the whole graph
    in fp32 and return the last stage as an fp32 host array.

    Each op runs on ``device`` (the card unless the caller passes
    another) through the graph context of route ``aggr_impl`` (built
    here unless ``gctx`` is given), the same ops the model's forward
    runs: ``indegree_norm`` the plain row scale, ``scatter_gather``
    SUM/AVG the route's neighbour sum (AVG over ``max(deg, 1)``), and
    ``fused_aggregate`` ``[relu](D^-1/2 A D^-1/2 x)``, on 'cuda' K1 ->
    K4 -> K2.  ``capture`` (anything with ``.append``) receives each
    post-op stage as an exclusively owned fp32 host array."""
    from ..models.builder import AGGR_AVG, AGGR_SUM
    from ..ops.norm import indegree_norm
    if gctx is None:
        from ..train.trainer import graph_context
        # forward only: the symmetry flag picks a backward, and none runs
        gctx = graph_context(graph, aggr_impl, symmetric=False,
                             device=device, chunk=chunk)
    dev = gctx.in_degree.device
    x = torch.from_numpy(np.asarray(feats_host, dtype=np.float32)).to(dev)
    out = None
    with torch.inference_mode():
        for op in prefix_ops:
            kind = op["kind"]
            if kind == "indegree_norm":
                x = indegree_norm(x, gctx.in_degree)
            elif kind == "scatter_gather":
                aggr = op.get("aggr", AGGR_SUM)
                if aggr not in (AGGR_SUM, AGGR_AVG):
                    raise NotImplementedError(
                        f"{aggr} aggregation in a precompute prefix")
                x = gctx.aggregate(x, aggr)
            elif kind == "fused_aggregate":
                x = gctx.aggregate_fused(x, op.get("activation", "none"))
            else:
                raise NotImplementedError(kind)
            # a fresh host copy of every stage: the device tensor goes on
            # to the next op, the host array belongs to the sink alone
            out = x.cpu().numpy() if dev.type != "cpu" else x.numpy().copy()
            if capture is not None:
                capture.append(out)
    if out is None:
        out = np.asarray(feats_host, dtype=np.float32).copy()
    return out
