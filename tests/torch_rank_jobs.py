"""Rank jobs for the port's partitioned tests (tests/test_torch_ring.py,
tests/test_torch_costmodel.py, tests/test_torch_layouts_parts.py,
tests/test_torch_multihost.py, tests/test_torch_mesh2d.py).

``run_ranks`` spawns fresh processes that unpickle the job by its module
name, so the jobs live here, in a module that imports the port alone:
the ranks never import JAX.
"""

import dataclasses
import os
import time
from typing import Any, Dict, List, Sequence

import numpy as np
import torch
import torch.distributed as dist

from roc_tpu_torch.kernels import spmm
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
            # the kernel routes upload no ring_dst (K3 reads the row
            # ranges): the dst table their ranges encode
            row_ptr = d.ring_row_ptr.cpu().numpy()
            rec["ring"] = dict(src=d.ring_src.cpu().numpy(),
                               dst=(d.ring_dst.cpu().numpy()
                                    if d.ring_dst is not None else
                                    np.stack([spmm.dst_from_row_ptr(
                                        torch.from_numpy(rp),
                                        d.pair_edges).numpy()
                                        for rp in row_ptr])),
                               dst_uploaded=d.ring_dst is not None,
                               row_ptr=row_ptr,
                               real=np.asarray(d.ring_real),
                               pair_edges=d.pair_edges,
                               padding_ratio=d.ring_padding_ratio,
                               baked=d.ring_w is not None)
        out.append(rec)
    return out


# ----------------------------------------------- partition-local loading


def _table_fields(d) -> Dict[str, Any]:
    """A ShardedData's tensors and host fields as numpy, by name (the
    tuples flattened as name.i)."""
    out: Dict[str, Any] = {}
    for f in dataclasses.fields(d):
        v = getattr(d, f.name)
        if isinstance(v, torch.Tensor):
            out[f.name] = v.cpu().numpy()
        elif isinstance(v, tuple) and v and isinstance(v[0], torch.Tensor):
            for i, t in enumerate(v):
                out[f"{f.name}.{i}"] = t.cpu().numpy()
        elif v is not None and f.name != "bd_occupancy":
            out[f.name] = np.asarray(v) if isinstance(v, (np.ndarray, tuple)) \
                else v
    return out


def _same_tables(a, b) -> List[str]:
    """The fields where two ShardedData differ (empty: bit-equal)."""
    fa, fb = _table_fields(a), _table_fields(b)
    bad = sorted(set(fa) ^ set(fb))
    for k in set(fa) & set(fb):
        x, y = fa[k], fb[k]
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            x, y = np.asarray(x), np.asarray(y)
            if x.shape != y.shape or x.dtype != y.dtype or \
                    not np.array_equal(x, y):
                bad.append(k)
        elif x != y:
            bad.append(k)
    return bad


class _Spy:
    """Every core/graph.py ``_read_slice`` call of a block, as ``(file,
    byte offset, bytes)``."""

    def __init__(self):
        from roc_tpu_torch.core import graph as tgraph
        self.graph, self.reads = tgraph, []

    def __enter__(self):
        real = self.real = self.graph._read_slice

        def spy(f, offset, count, dtype):
            self.reads.append((os.path.basename(f.name), int(offset),
                               int(count) * np.dtype(dtype).itemsize))
            return real(f, offset, count, dtype)
        self.graph._read_slice = spy
        return self

    def __exit__(self, *exc):
        self.graph._read_slice = self.real


def local_job(prefix: str, in_dim: int, num_classes: int,
              variants: Sequence[dict], method: str = "greedy",
              chunk: int = 64) -> Dict[str, Any]:
    """One rank of the shard_dataset_local checks: for each variant
    ``dict(aggr_impl=, halo=, fuse=False)`` this rank's tables from a
    FileSource over ``prefix`` (shard_dataset_local) against
    shard_dataset's from the whole Dataset loaded from the same files;
    returns the differing fields per variant, the FileSource build's
    reads (``_Spy``), the plan's bounds, edge ranges and part shapes."""
    from roc_tpu_torch.core.graph import load_dataset
    from roc_tpu_torch.core.partition import partition_plan
    from roc_tpu_torch.core.source import FileSource
    from roc_tpu_torch.parallel.distributed import Collectives, shard_dataset
    from roc_tpu_torch.parallel.multihost import (process_local_parts,
                                                  shard_dataset_local)
    from roc_tpu_torch.parallel import RankMesh
    P = dist.get_world_size()
    rank = process_local_parts(RankMesh(P, 1))[0]
    src = FileSource(prefix, in_dim, num_classes)
    plan = partition_plan(src.row_ptr(), P, node_multiple=8,
                          edge_multiple=chunk, method=method)
    ds = load_dataset(prefix, in_dim, num_classes)
    agree = Collectives().agree_max
    rec: Dict[str, Any] = {"diff": {}, "reads": {},
                           "bounds": [tuple(map(int, b))
                                      for b in plan.bounds],
                           "edge_range": plan.edge_range(rank),
                           "part": rank}
    for v in variants:
        tag = f"{v['aggr_impl']}/{v['halo']}"
        with _Spy() as spy:
            got = shard_dataset_local(src, plan, rank, device="cpu", **v)
        want = shard_dataset(ds, plan, rank, "cpu", agree_max=agree, **v)
        rec["diff"][tag] = _same_tables(got, want)
        rec["reads"][tag] = spy.reads
    return rec


def source_train_job(prefix: str, in_dim: int, num_classes: int,
                     runs: Sequence[dict], chunk: int = 64
                     ) -> List[Dict[str, Any]]:
    """One rank of partitioned runs from a FileSource over ``prefix``.
    Per run ``dict(model=, config=, epochs=, params=None, inject=True)``:
    with ``inject`` the plan the JAX package's multi-host path builds
    (greedy, node multiple 8), this rank's tables from
    shard_dataset_local and a DistributedTrainer given them
    (``data=``/``plan=``); without, a DistributedTrainer that builds
    them from the source itself.  Returns per run the eval records'
    train_loss, the whole params, the logits, the bounds and the
    source's reads (``_Spy``) through the trainer's construction and
    its epochs."""
    from roc_tpu_torch.core.partition import partition_plan
    from roc_tpu_torch.core.source import FileSource
    from roc_tpu_torch.parallel.multihost import shard_dataset_local
    P = dist.get_world_size()
    out = []
    for run in runs:
        model, config = run["model"], run["config"]
        with _Spy() as spy:
            src = FileSource(prefix, in_dim, num_classes)
            kw = {}
            if run.get("inject", True):
                plan = partition_plan(src.row_ptr(), P, node_multiple=8,
                                      edge_multiple=chunk)
                kw = dict(plan=plan, data=shard_dataset_local(
                    src, plan, dist.get_rank(), device="cpu",
                    aggr_impl=config.aggr_impl, halo=config.halo))
            tr = DistributedTrainer(model, src, P, config, device="cpu",
                                    params=run.get("params"), **kw)
            hist = tr.train(run.get("epochs"))
        out.append(dict(
            train_loss=np.asarray([m["train_loss"] for m in hist]),
            params={k: v.detach().float().numpy()
                    for k, v in tr._full_params().items()},
            logits=tr.predict().float().numpy(),
            bounds=[tuple(map(int, b)) for b in tr.plan.bounds],
            edge_range=tr.plan.edge_range(tr.rank), part=tr.rank,
            reads=spy.reads))
    return out


# ------------------------------------------------- the (parts, model) mesh


def mesh_job(runs: Sequence[dict], device="cpu") -> List[Dict[str, Any]]:
    """One rank of the mesh checks.  Per run ``dict(model=, dataset=,
    config=, parts=, epochs=, params=None, save=None, restore=None,
    more=0, force=())``: a DistributedTrainer of ``parts`` parts on the config's
    mesh, over the whole world when ``parts * M`` is its size, else over
    consecutive subgroups of ``parts * M`` ranks (every rank runs its
    subgroup's copy; the 1-D references).  ``restore``: a checkpoint
    restored before training; ``force``: each ms fed to
    ``maybe_rebalance`` as a made-up eval record before training (its
    answers in ``forced``); ``save``: one written after ``epochs`` (its
    stats returned), after which ``more`` epochs run.  Returns per
    run the objectives (``losses``), the eval records' ``train_loss``,
    the whole params, the at-rest shapes of the params and moments, the
    logits and each kernel wrapper's launches during training."""
    from roc_tpu_torch.kernels import _build, ell_spmm, graphnorm, spmm
    from roc_tpu_torch.train.trainer import resolve_mesh
    kernels = (graphnorm.indegree_norm, graphnorm.scale_act, spmm.csr_spmm,
               spmm.csr_row_ptr, ell_spmm.ell_aggregate)
    from roc_tpu_torch.utils.checkpoint import (checkpoint_trainer,
                                                restore_trainer)
    world, me = dist.get_world_size(), dist.get_rank()
    out = []
    for run in runs:
        P = run["parts"]
        _, M = resolve_mesh(run["config"], num_parts=P)
        n = P * M
        group = None
        if n < world:
            groups = [dist.new_group(list(range(i, i + n)))
                      for i in range(0, world, n)]
            group = groups[me // n]
        tr = DistributedTrainer(run["model"], run["dataset"], P,
                                run["config"], params=run.get("params"),
                                device=device, group=group)
        rec: Dict[str, Any] = {}
        if run.get("restore"):
            restore_trainer(tr, run["restore"])
            rec["restored_epoch"] = tr.epoch
        rec["forced"] = [tr.maybe_rebalance({"epoch_ms": ms, "epoch": -1})
                         for ms in run.get("force", ())]
        _build.zero_launches(*kernels)
        graphnorm.indegree_norm.masked_launches = 0
        hist = tr.train(run.get("epochs"))
        rec["launches"] = {k.__name__: k.launches for k in kernels}
        rec["launches"]["indegree_norm_masked"] = \
            graphnorm.indegree_norm.masked_launches
        if run.get("save"):
            rec["save"] = checkpoint_trainer(tr, run["save"])
            rec["saved_params"] = {k: v.detach().float().cpu().numpy()
                                   for k, v in tr._full_params().items()}
            hist += tr.train(run.get("more", 0))
        rec.update(
            train_loss=np.asarray([m["train_loss"] for m in hist]),
            losses=np.asarray([float(x) for x in tr.losses]),
            params={k: v.detach().float().cpu().numpy()
                    for k, v in tr._full_params().items()},
            rest={k: tuple(v.shape) for k, v in tr.params.items()},
            rest_m={k: tuple(v.shape) for k, v in tr.opt_state.m.items()},
            rest_v={k: tuple(v.shape) for k, v in tr.opt_state.v.items()},
            logits=tr.predict().float().cpu().numpy(),
            bounds=[tuple(map(int, b)) for b in tr.plan.bounds],
            part=tr.rank, model_index=(tr.model_comm.rank
                                       if tr.model_comm is not None else 0))
        out.append(rec)
    return out


def commit_kill_job(model, dataset, config, prefix: str) -> None:
    """A two-writer save (mesh 1x2) at epoch 1, committed; then the save
    at epoch 2 with rank 1 killed between its shard's rename and the
    commit barrier (``kill_in_async_save:2:1``, the commit window).  Rank
    0 waits at the barrier until the caller's timeout kills it."""
    from roc_tpu_torch.resilience import inject
    from roc_tpu_torch.utils.checkpoint import checkpoint_trainer
    tr = DistributedTrainer(model, dataset, 1, config, device="cpu")
    tr.train(1)
    checkpoint_trainer(tr, f"{prefix}.1")
    tr.train(1)
    inject.arm("kill_in_async_save:2:1")
    checkpoint_trainer(tr, f"{prefix}.2")


def async_rotation_job(model, dataset, config, prefix: str, saves: int,
                       delay_s: float) -> Dict[str, Any]:
    """One rank of the async rotation on mesh 1x2 (two writers): a save
    after each of ``saves`` epochs, rank 1's saver sleeping ``delay_s``
    after each of its writes, so saves are submitted faster than they
    commit and the two savers free up at different times; then the
    flush, the saver's counters, the committed epochs with each
    manifest's epoch, and the newest checkpoint restored into a fresh
    trainer; last, a commit barrier whose tags differ by rank."""
    from roc_tpu_torch.parallel.multihost import checkpoint_commit_barrier
    from roc_tpu_torch.resilience.recovery import CheckpointRotation
    from roc_tpu_torch.utils import checkpoint as ck
    rank = dist.get_rank()
    real = ck.write_snapshot

    def slow(path, snap):
        stats = real(path, snap)
        if rank == 1:
            time.sleep(delay_s)
        return stats
    tr = DistributedTrainer(model, dataset, 1, config, device="cpu")
    rot = CheckpointRotation(prefix, keep=saves, async_save=True)
    ck.write_snapshot = slow
    try:
        for _ in range(saves):
            tr.train(1)
            rot.save(tr)
        rot.flush()
    finally:
        ck.write_snapshot = real
    stats = rot.save_stats()
    rot.drain()
    fresh = DistributedTrainer(model, dataset, 1, config, device="cpu")
    restored = rot.restore_latest(fresh)
    try:
        checkpoint_commit_barrier(f"ck:{rank}", tr._ckpt_group)
        mismatch = None
    except RuntimeError as e:
        mismatch = str(e)
    return dict(superseded=stats["superseded"], saved=stats["saved"],
                existing=rot.existing(),
                manifest_epochs=[ck.read_manifest(rot.path(ep))["epoch"]
                                 for ep in rot.existing()],
                shards=[len(ck.read_manifest(rot.path(ep))["shards"])
                        for ep in rot.existing()],
                restored=restored, epoch=tr.epoch,
                same=all(torch.equal(fresh.params[k], tr.params[k])
                         for k in tr.params),
                mismatch=mismatch)


# ------------------------------------------------------------- telemetry


def telemetry_job(model, dataset, config, ev_dir: str) -> Dict[str, Any]:
    """One rank of a partitioned run with its telemetry: its events to
    ``ev_dir/ev_p<rank>.jsonl`` (a JSONL sink of its own), the eval
    records to ``config.metrics_path`` (every rank appends to the one
    path).  Returns the rank's eval count and objectives."""
    from roc_tpu_torch.obs.events import JsonlSink
    sink = JsonlSink(os.path.join(ev_dir, f"ev_p{dist.get_rank()}.jsonl"))
    get_bus().add_sink(sink)
    try:
        tr = DistributedTrainer(model, dataset, dist.get_world_size(),
                                config, device="cpu")
        hist = tr.train()
    finally:
        get_bus().sinks.remove(sink)
        sink.close()
    return {"evals": len(hist),
            "losses": torch.stack(tr.losses).double().numpy()}
