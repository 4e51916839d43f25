"""Rank jobs for the port's partitioned tests (tests/test_torch_ring.py,
tests/test_torch_costmodel.py, tests/test_torch_layouts_parts.py).

``run_ranks`` spawns fresh processes that unpickle the job by its module
name, so the jobs live here, in a module that imports the port alone:
the ranks never import JAX.
"""

from typing import Any, Dict, List, Sequence

import numpy as np
import torch
import torch.distributed as dist

from roc_tpu_torch.obs.events import get_bus
from roc_tpu_torch.parallel.distributed import DistributedTrainer


class _Sink(list):
    """The bus's records, through a sink of its own."""
    write = list.append


def job(runs: Sequence[dict], device="cpu") -> List[Dict[str, Any]]:
    """Per run ``dict(model=, dataset=, config=, params=None, epochs=None,
    force=(), grads=False)``: a DistributedTrainer over the default group;
    ``force`` feeds each ms to ``maybe_rebalance`` as a made-up eval
    record before training (its answers in ``forced``).  Returns numpy
    records: the bounds before and after, ``rebalances``, the losses, the
    weights, the logits, the ring tables' host numbers, ``grads`` (the
    all-reduced gradients before the first step) when asked, the
    ``plan``/``costmodel`` events of the run, and ``launches``: each
    kernel wrapper's launches during training (counted from 0)."""
    from roc_tpu_torch.kernels import _build, ell_spmm, graphnorm, spmm
    kernels = (graphnorm.indegree_norm, graphnorm.scale_act, spmm.csr_spmm,
               spmm.csr_row_ptr, ell_spmm.ell_aggregate)
    out = []
    for run in runs:
        sink = _Sink()
        get_bus().add_sink(sink)
        try:
            tr = DistributedTrainer(run["model"], run["dataset"],
                                    dist.get_world_size(), run["config"],
                                    params=run.get("params"), device=device)
            rec: Dict[str, Any] = {
                "bounds": [tuple(map(int, b)) for b in tr.plan.bounds],
                "config": {k: getattr(tr.config, k) for k in (
                    "aggr_impl", "halo", "features", "remat", "memory")}}
            if run.get("grads"):
                _, grads = tr.loss_and_grads()
                rec["grads"] = {k: v.float().cpu().numpy()
                                for k, v in grads.items()}
            rec["forced"] = [tr.maybe_rebalance({"epoch_ms": ms,
                                                 "epoch": -1})
                             for ms in run.get("force", ())]
            _build.zero_launches(*kernels)
            graphnorm.indegree_norm.masked_launches = 0
            rec["history"] = tr.train(run.get("epochs"))
            rec["launches"] = {k.__name__: k.launches for k in kernels}
            rec["launches"]["indegree_norm_masked"] = \
                graphnorm.indegree_norm.masked_launches
        finally:
            get_bus().sinks.remove(sink)
        d = tr.data
        rec.update(
            final_bounds=[tuple(map(int, b)) for b in tr.plan.bounds],
            rebalances=tr._rebalances,
            losses=torch.stack(tr.losses).double().cpu().numpy(),
            params={k: v.detach().float().cpu().numpy()
                    for k, v in tr.params.items()},
            logits=tr.predict().float().cpu().numpy(),
            events=[{k: v for k, v in e.items()
                     if k not in ("t", "mono", "host")}
                    for e in sink if e["cat"] in ("plan", "costmodel")])
        if d.ring_src is not None:
            rec["ring"] = dict(src=d.ring_src.cpu().numpy(),
                               dst=d.ring_dst.cpu().numpy(),
                               row_ptr=d.ring_row_ptr.cpu().numpy(),
                               real=np.asarray(d.ring_real),
                               pair_edges=d.pair_edges,
                               padding_ratio=d.ring_padding_ratio,
                               baked=d.ring_w is not None)
        out.append(rec)
    return out
