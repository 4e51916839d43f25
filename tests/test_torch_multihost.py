"""The port's partition-local loading (parallel/multihost.py
``shard_dataset_local`` from a core/source.py ``FileSource``) and the
partitioned trainer's ``data=``/``plan=`` and DataSource paths, on the
CPU, against the port's whole-Dataset build and the JAX package's
multi-host path.

The port's ranks are spawned gloo processes running
``tests/torch_rank_jobs.py`` (the port alone); the JAX package runs in
the pytest process on its virtual CPU devices.  Tables are compared bit
for bit; training is held to the tolerances stated below.
"""

import numpy as np
import pytest

import torch.distributed as dist

from roc_tpu.core import graph as jgraph
from roc_tpu.core.partition import materialize_plan as j_materialize
from roc_tpu.core.partition import partition_plan as j_partition_plan
from roc_tpu.core.source import FileSource as JFileSource
from roc_tpu.models.gcn import build_gcn as j_build_gcn
from roc_tpu.parallel.distributed import DistributedTrainer as JDist
from roc_tpu.parallel.distributed import make_mesh
from roc_tpu.parallel.multihost import shard_dataset_local as j_local
from roc_tpu.train.trainer import TrainConfig as JTrainConfig
from roc_tpu_torch import convert
from roc_tpu_torch.core import graph as tgraph
from roc_tpu_torch.core.partition import partition_plan
from roc_tpu_torch.core.source import FileSource
from roc_tpu_torch.models.gcn import build_gcn
from roc_tpu_torch.parallel import RankMesh
from roc_tpu_torch.parallel import multihost
from roc_tpu_torch.parallel.distributed import DistributedTrainer, run_ranks
from roc_tpu_torch.train.trainer import TrainConfig

import torch_rank_jobs

V, F, C = 300, 7, 4
LAYERS = [F, 16, C]
EPOCHS = 4
# training from the files against the JAX package's multi-host path: the
# eval records' train_loss within 1e-5 (4 epochs of fp32 sums in another
# order), the weights within tests/test_torch_distributed.py's rtol 2e-4,
# atol 2e-5 (Adam moves a weight by ~lr whatever its gradient's size)
LOSS_RTOL = 1e-5
PARAM_TOL = dict(rtol=2e-4, atol=2e-5)
# every table shard_dataset builds, as (aggr_impl, halo, fuse)
VARIANTS = [("cuda", "gather", False), ("ell", "gather", True),
            ("segment", "gather", False), ("sectioned", "gather", True),
            ("flat_sum", "gather", True), ("bdense", "gather", False),
            ("cuda", "ring", False), ("ell", "ring", True)]


@pytest.fixture(scope="module")
def disk(tmp_path_factory):
    """A symmetric synthetic dataset with self edges (dense enough for
    block-dense tiles) in the reference layout (.feats.bin, no CSV), and
    both packages' in-memory copies."""
    tds = tgraph.synthetic_dataset(V, 16, in_dim=F, num_classes=C, seed=9)
    prefix = str(tmp_path_factory.mktemp("ds") / "syn")
    tgraph.save_dataset(tds, prefix, csv=False)
    return tds, jgraph.load_dataset(prefix, F, C), prefix


@pytest.mark.parametrize("P", [2, 4])
def test_shard_dataset_local_bit_equal_and_local_reads(disk, P):
    """P gloo ranks: each rank's tables from a FileSource equal
    shard_dataset's from the whole Dataset bit for bit, for every
    aggr_impl and halo; the build reads the O(V) row offsets once (the
    source's row pointer) and otherwise only the part's column bytes and
    feature rows."""
    _, _, prefix = disk
    variants = [dict(aggr_impl=a, halo=h, fuse=f) for a, h, f in VARIANTS]
    res = run_ranks(torch_rank_jobs.local_job, P, prefix=prefix, in_dim=F,
                    num_classes=C, variants=variants)
    col_base = 12 + V * 8
    for rec in res:
        assert {k: v for k, v in rec["diff"].items() if v} == {}
        l, r = rec["bounds"][rec["part"]]
        e0, e1 = rec["edge_range"]
        for tag, reads in rec["reads"].items():
            cols = [x for x in reads if x[0].endswith(".lux")]
            feats = [x for x in reads if x[0].endswith(".feats.bin")]
            assert len(cols) == len(feats) == 1, (tag, reads)
            (_, off, n), = cols
            assert col_base + e0 * 4 <= off and off + n <= col_base + e1 * 4
            (_, off, n), = feats
            assert l * F * 4 <= off and off + n <= (r + 1) * F * 4


def test_training_from_files_matches_jax_multihost(disk):
    """Two gloo ranks train from the FileSource: with tables injected
    from shard_dataset_local (data=/plan=, on 'cuda' and on the ring) and
    with the trainer building them from the source, against the JAX
    package's DistributedTrainer given data=shard_dataset_local(
    FileSource) at the same plan (its 'ell'/'segment' ring, the same
    sums; its pg= materialized, as its trainer's split record reads every
    part's columns); the source-built run equals the injected one bit for
    bit.  Through each trainer's construction and epochs a rank reads no
    column byte and no feature row outside its part."""
    _, jds, prefix = disk
    P = 2
    jsrc = JFileSource(prefix, F, C)
    pg = j_partition_plan(jsrc.row_ptr(), P, node_multiple=8,
                          edge_multiple=64)
    # the JAX trainer's split-quality pass reads every part's columns
    # from its pg (a PartitionPlan has none): the same plan, materialized
    jpg = j_materialize(jds.graph, pg)
    mesh = make_mesh(P)
    refs = {}
    for halo, jimpl in (("gather", "ell"), ("ring", "segment")):
        cfg = JTrainConfig(aggr_impl=jimpl, halo=halo, dropout_rate=0.0,
                           verbose=False, epochs=EPOCHS, eval_every=1,
                           weight_decay=1e-3, learning_rate=0.01, chunk=64,
                           symmetric=True)
        tr = JDist(j_build_gcn(LAYERS, dropout_rate=0.0), jds, P, cfg,
                   mesh=mesh, pg=jpg, data=j_local(
                       jsrc, pg, mesh, aggr_impl=jimpl, halo=halo))
        p0 = {k: np.asarray(v) for k, v in tr.params.items()}
        refs[halo] = (p0, [m["train_loss"] for m in tr.train()],
                      {k: np.asarray(v) for k, v in tr.params.items()})

    def run(halo, inject=True):
        return dict(model=build_gcn(LAYERS, dropout_rate=0.0),
                    params=convert.params_from_jax(refs[halo][0]),
                    epochs=EPOCHS, inject=inject, config=TrainConfig(
                        aggr_impl="cuda", halo=halo, dropout_rate=0.0,
                        verbose=False, eval_every=1, weight_decay=1e-3,
                        learning_rate=0.01, chunk=64, symmetric=True,
                        partition="greedy"))

    res = run_ranks(torch_rank_jobs.source_train_job, P, prefix=prefix,
                    in_dim=F, num_classes=C,
                    runs=[run("gather"), run("ring"),
                          run("gather", inject=False)])
    for rank_runs in res:
        for rec, halo in zip(rank_runs, ("gather", "ring")):
            assert rec["bounds"] == [tuple(map(int, b)) for b in pg.bounds]
            _, jloss, jparams = refs[halo]
            np.testing.assert_allclose(rec["train_loss"], jloss,
                                       rtol=LOSS_RTOL, atol=0)
            for k in jparams:
                np.testing.assert_allclose(rec["params"][k], jparams[k],
                                           **PARAM_TOL)
        for rec in rank_runs:
            l, r = rec["bounds"][rec["part"]]
            e0, e1 = rec["edge_range"]
            cols = [(off, n) for name, off, n in rec["reads"]
                    if name.endswith(".lux") and off >= 12 + V * 8]
            feats = [(off, n) for name, off, n in rec["reads"]
                     if name.endswith(".feats.bin")]
            assert cols and feats, rec["reads"]
            for off, n in cols:
                assert 12 + V * 8 + e0 * 4 <= off
                assert off + n <= 12 + V * 8 + e1 * 4
            for off, n in feats:
                assert l * F * 4 <= off and off + n <= (r + 1) * F * 4
        own, injected = rank_runs[2], rank_runs[0]
        np.testing.assert_array_equal(own["train_loss"],
                                      injected["train_loss"])
        np.testing.assert_array_equal(own["logits"], injected["logits"])


@pytest.fixture
def world_of_one(tmp_path):
    """This process as a world of one gloo rank (a file store)."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_injected_data_errors(disk, world_of_one):
    """The JAX package's refusals: data= without plan=, rebalance with
    injected data, tables of another route or halo, and a source whose
    symmetry is not stated."""
    _, _, prefix = disk
    src = FileSource(prefix, F, C)
    plan = partition_plan(src.row_ptr(), 1, node_multiple=8,
                          edge_multiple=64)

    def cfg(**kw):
        return TrainConfig(**dict(dict(aggr_impl="cuda", symmetric=True,
                                       verbose=False, chunk=64), **kw))

    model = build_gcn(LAYERS)
    data = multihost.shard_dataset_local(src, plan, 0, device="cpu",
                                         aggr_impl="cuda")
    with pytest.raises(ValueError, match="plan="):
        DistributedTrainer(model, src, 1, cfg(), device="cpu", data=data)
    with pytest.raises(ValueError, match="rebalance"):
        DistributedTrainer(model, src, 1, cfg(rebalance=True), device="cpu",
                           data=data, plan=plan)
    with pytest.raises(ValueError, match="sectioned"):
        DistributedTrainer(model, src, 1, cfg(aggr_impl="sectioned"),
                           device="cpu", data=data, plan=plan)
    ring = multihost.shard_dataset_local(src, plan, 0, device="cpu",
                                         halo="ring")
    with pytest.raises(ValueError, match="ring"):
        DistributedTrainer(model, src, 1, cfg(), device="cpu", data=ring,
                           plan=plan)
    with pytest.raises(ValueError, match="symmetric"):
        DistributedTrainer(model, src, 1, cfg(symmetric=None), device="cpu",
                           data=data, plan=plan)
    tr = DistributedTrainer(model, src, 1, cfg(), device="cpu", data=data,
                            plan=plan)
    assert tr.data is data and tr.plan is plan
    tr.train(1)


def test_launcher_glue(monkeypatch, world_of_one):
    """init_distributed is a no-op with the group up or without a
    launcher's environment; process_local_parts is the parts-major
    ``rank // M``; the commit barrier passes at world size 1."""
    assert multihost.init_distributed() is False
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    assert multihost.init_distributed() is False
    mesh = RankMesh(2, 2)
    assert [multihost.process_local_parts(mesh, r)[0]
            for r in range(4)] == [0, 0, 1, 1]
    assert multihost.process_local_parts(RankMesh(1, 1)) == [0]
    multihost.checkpoint_commit_barrier("t")
