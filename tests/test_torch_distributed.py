"""The port's partitioned training (parallel/distributed.py) against the
JAX package's DistributedTrainer and the port's own Trainer, on the CPU.

The JAX package runs in the pytest process, on its 8 virtual CPU
devices.  The port's ranks are processes spawned on a function of the
port package (``run_ranks(train_job, ...)``), each a rank of a ``gloo``
group; they never import JAX.  Weights cross with convert.py; dropout is
0 wherever two runs are compared.  Every tolerance is stated with its
reason.
"""

import os
import re
import subprocess
import sys

import numpy as np
import pytest

import torch
import torch.distributed as dist

from roc_tpu.core import graph as jgraph
from roc_tpu.core.partition import partition_graph as j_partition_graph
from roc_tpu.models.gcn import build_gcn as j_build_gcn
from roc_tpu.parallel.distributed import DistributedTrainer as JDist
from roc_tpu.parallel.distributed import make_mesh
from roc_tpu.parallel.distributed import shard_dataset as j_shard_dataset
from roc_tpu.train.trainer import TrainConfig as JTrainConfig
from roc_tpu.train.trainer import resolve_dtypes as j_resolve_dtypes
from roc_tpu_torch import convert
from roc_tpu_torch.core import graph as tgraph
from roc_tpu_torch.core.ell import ell_from_padded_parts
from roc_tpu_torch.core.partition import partition_graph, partition_plan
from roc_tpu_torch.models.gcn import build_gcn
from roc_tpu_torch.ops.aggregate import aggregate_ell
from roc_tpu_torch.parallel.distributed import (DistributedTrainer,
                                                remap_to_padded, run_ranks,
                                                shard_dataset, train_job)
from roc_tpu_torch.train.trainer import TrainConfig, Trainer, resolve_dtypes

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# JAX's own fixture for its distributed tests (tests/test_distributed.py)
LAYERS = [12, 16, 3]
EPOCHS = 8
# fp32: the JAX test's tolerance for a partitioned run against one device
# (Adam moves a weight by ~lr whatever its gradient's size, so a
# near-zero gradient amplifies rounding); the printed train loss curve
# as tests/test_torch_train.py holds it (fp32 sums in another order over
# the steps)
PARAM_TOL = dict(rtol=2e-4, atol=2e-5)
CURVE_RTOL = 1e-4
# mixed: tests/test_torch_bf16.py's tolerances, bf16 activations rounded
# at other places: the train loss within rel 2e-3, the logits within
# 3e-2 of max|logit| (~4 bf16 ulps at that magnitude)
MIXED_CURVE_RTOL = 2e-3
LOGIT_TOL = 3e-2


def _datasets():
    return (jgraph.synthetic_dataset(96, 7, in_dim=12, num_classes=3,
                                     seed=11),
            tgraph.synthetic_dataset(96, 7, in_dim=12, num_classes=3,
                                     seed=11))


def _config(impl, mode="float32", **kw):
    dtype, compute = resolve_dtypes(mode)
    kw = dict(dict(dropout_rate=0.0, eval_every=1, symmetric=True,
                   chunk=64), **kw)
    return TrainConfig(aggr_impl=impl, verbose=False, epochs=EPOCHS,
                       weight_decay=1e-3, learning_rate=0.01, dtype=dtype,
                       compute_dtype=compute, **kw)


def _jax_run(jds, P, jimpl, mode):
    """JAX DistributedTrainer at P parts, dropout 0, an eval every epoch:
    its starting weights, eval history, final weights, logits and
    bounds."""
    dtype, compute = j_resolve_dtypes(mode)
    tr = JDist(j_build_gcn(LAYERS, dropout_rate=0.0), jds, P,
               JTrainConfig(aggr_impl=jimpl, dropout_rate=0.0, verbose=False,
                            epochs=EPOCHS, weight_decay=1e-3,
                            learning_rate=0.01, eval_every=1,
                            symmetric=True, chunk=64, dtype=dtype,
                            compute_dtype=compute))
    p0 = {k: np.asarray(v) for k, v in tr.params.items()}
    hist = tr.train()
    return (p0, hist, {k: np.asarray(v, np.float32)
                       for k, v in tr.params.items()},
            np.asarray(tr.predict()).astype(np.float32),
            [tuple(map(int, b)) for b in tr.pg.bounds])


def _trainer_run(tds, impl, mode, p0):
    """The port's single-device Trainer from the same weights."""
    tr = Trainer(build_gcn(LAYERS, dropout_rate=0.0), tds,
                 _config(impl, mode), params=convert.params_from_jax(p0),
                 device="cpu")
    hist = tr.train()
    return (hist, torch.stack(tr.losses).double().numpy(),
            {k: v.detach().float().numpy() for k, v in tr.params.items()},
            tr.predict().float().numpy())


def _check_curve(hist, want, rtol):
    assert [m["epoch"] for m in hist] == list(range(EPOCHS))
    np.testing.assert_allclose([m["train_loss"] for m in hist],
                               [m["train_loss"] for m in want], rtol=rtol)
    for k in ("train_cnt", "val_cnt", "test_cnt"):
        assert [m[k] for m in hist] == [m[k] for m in want]


def _directed_datasets():
    """A graph that is not symmetric (tests/test_torch_train.py's)."""
    rng = np.random.RandomState(11)
    V = 90
    src, dst = rng.randint(0, V, 500), rng.randint(0, V, 500)
    g = tgraph.add_self_edges(tgraph.from_edge_list(src, dst, V))
    assert not tgraph.check_symmetric(g)
    feats = rng.randn(V, LAYERS[0]).astype(np.float32)
    labels = rng.randint(0, LAYERS[-1], V).astype(np.int32)
    mask = rng.randint(0, 4, V).astype(np.int32)
    return tgraph.Dataset(g, feats, labels, mask, LAYERS[-1])


# (port route, JAX route, dtype mode) per part count: the port's kernel
# routes (their plain versions on the CPU) against JAX 'pallas' (interpret
# mode) and 'segment' (JAX 'pallas_csr' does not run on the CPU)
CASES = {2: [("cuda", "pallas", "float32"), ("cuda_csr", "segment",
                                             "float32"),
             ("cuda", "pallas", "mixed")],
         4: [("cuda", "pallas", "float32"), ("cuda_csr", "segment",
                                             "float32")]}


@pytest.mark.parametrize("P", sorted(CASES))
def test_partitioned_training_matches_jax_and_trainer(P):
    """P gloo ranks, 8 epochs from the JAX run's weights: the eval curve,
    counts, final weights and logits against JAX DistributedTrainer at
    the same P and against the port's Trainer; predict(node_ids) in
    original vertex order; every rank ends with the same weights.  At
    P = 2 also 'segment' on a graph that is not symmetric: the gradient
    through the differentiable halo gather against single-device
    autograd."""
    jds, tds = _datasets()
    ids = np.array([95, 0, 47, 48, 3, 95])
    runs, refs = [], []
    for impl, jimpl, mode in CASES[P]:
        jax_ref = _jax_run(jds, P, jimpl, mode)
        refs.append((mode, jax_ref, _trainer_run(tds, impl, mode,
                                                 jax_ref[0])))
        runs.append(dict(model=build_gcn(LAYERS, dropout_rate=0.0),
                         dataset=tds, config=_config(impl, mode),
                         params=convert.params_from_jax(jax_ref[0]),
                         node_ids=ids))
    directed = _directed_datasets()
    p_dir = build_gcn(LAYERS).init_params(torch.Generator().manual_seed(5))
    p_dir = {k: v.detach().clone() for k, v in p_dir.items()}
    if P == 2:
        runs.append(dict(model=build_gcn(LAYERS, dropout_rate=0.0),
                         dataset=directed,
                         config=_config("segment", symmetric=False),
                         params=p_dir, epochs=1, grads=True))
    results = run_ranks(train_job, P, runs=runs, device="cpu")
    for rank_runs in results[1:]:
        for a, b in zip(rank_runs, results[0]):
            for k in a["params"]:
                np.testing.assert_array_equal(a["params"][k],
                                              b["params"][k])
    for r, (mode, (_, jhist, jparams, jlogits, jbounds),
            (thist, tlosses, tparams, tlogits)) in zip(results[0], refs):
        # the JAX trainer's split (its default, 'auto', is the cost model's)
        assert r["bounds"] == jbounds
        if mode == "float32":
            _check_curve(r["history"], jhist, CURVE_RTOL)
            _check_curve(r["history"], thist, CURVE_RTOL)
            np.testing.assert_allclose(r["losses"], tlosses, rtol=1e-5)
            for k in jparams:
                np.testing.assert_allclose(r["params"][k], jparams[k],
                                           **PARAM_TOL)
                np.testing.assert_allclose(r["params"][k], tparams[k],
                                           **PARAM_TOL)
            logit_tol = dict(rtol=0, atol=1e-4 * np.abs(jlogits).max())
        else:
            _check_curve(r["history"], jhist, MIXED_CURVE_RTOL)
            _check_curve(r["history"], thist, MIXED_CURVE_RTOL)
            logit_tol = dict(rtol=0, atol=LOGIT_TOL * np.abs(jlogits).max())
        assert r["history"][-1]["train_loss"] < r["history"][0]["train_loss"]
        np.testing.assert_allclose(r["logits"], jlogits, **logit_tol)
        np.testing.assert_allclose(r["logits"], tlogits, **logit_tol)
        np.testing.assert_array_equal(r["rows"], r["logits"][ids])
    if P == 2:
        r = results[0][-1]
        tr = Trainer(build_gcn(LAYERS, dropout_rate=0.0), directed,
                     _config("segment", symmetric=False), params=p_dir,
                     device="cpu")
        names = list(tr.params)
        loss, _ = tr.model.loss_fn(tr.params, tr.feats, tr.labels, tr.mask,
                                   tr.gctx, train=True)
        want = torch.autograd.grad(loss, [tr.params[k] for k in names])
        for k, g in zip(names, want):
            g = g.numpy()
            np.testing.assert_allclose(r["grads"][k], g, rtol=1e-5,
                                       atol=1e-5 * np.abs(g).max())


@pytest.mark.parametrize("P", [2, 3])
@pytest.mark.parametrize("impl", ["segment", "ell"])
def test_shard_dataset_matches_all_parts_tables(P, impl):
    """Each rank's part (built from its own columns only) against the JAX
    package's all-parts upload: rows, degrees and edge arrays bit-equal;
    the rank's ELL buckets (padded for its part alone) give the same sums
    as the all-parts table's row of that part."""
    jds, tds = _datasets()
    jpg = j_partition_graph(jds.graph, P, edge_multiple=64)
    jd = j_shard_dataset(jds, jpg, make_mesh(P), aggr_impl="segment")
    tpg = partition_graph(tds.graph, P, edge_multiple=64)
    plan = partition_plan(tds.graph.row_ptr, P, edge_multiple=64)
    cols = remap_to_padded(tpg)
    table = ell_from_padded_parts(tpg.part_row_ptr, cols, tpg.real_nodes,
                                  tpg.part_nodes, dummy=P * tpg.part_nodes)
    x = torch.from_numpy(np.random.RandomState(P).randn(
        P * tpg.part_nodes + 1, 5).astype(np.float32))
    x[-1] = 0
    for p in range(P):
        d = shard_dataset(tds, plan, p, "cpu", aggr_impl=impl)
        for name in ("feats", "labels", "mask", "in_degree"):
            np.testing.assert_array_equal(getattr(d, name).numpy(),
                                          np.asarray(getattr(jd, name))[p])
        if impl == "segment":
            assert d.ell_idx == () and d.edge_src.dtype == torch.int32
            np.testing.assert_array_equal(d.edge_src.numpy(),
                                          np.asarray(jd.edge_src)[p])
            np.testing.assert_array_equal(d.edge_dst.numpy(),
                                          np.asarray(jd.edge_dst)[p])
        else:
            assert d.edge_src is None
            want = aggregate_ell(x, [torch.from_numpy(a[p])
                                     for a in table.idx],
                                 torch.from_numpy(table.row_pos[p]),
                                 tpg.part_nodes)
            got = aggregate_ell(x, d.ell_idx, d.ell_row_pos, tpg.part_nodes)
            assert torch.equal(got, want)


@pytest.fixture
def world_of_one(tmp_path):
    """This process as a world of one gloo rank (a file store in
    tmp_path), torn down after the test."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("impl", ["cuda", "cuda_csr"])
def test_world_size_one_equals_trainer(world_of_one, impl):
    """In process, one gloo rank (every collective still runs): with
    dropout 0.5 and no weights given, DistributedTrainer draws Trainer's
    weights and masks, so the run is Trainer's bit for bit: objectives,
    eval records, weights, logits.  chunk = 2 divides E = 614, so the
    plan adds no padding edge, hence no padding row: the part is the
    graph, and the masks have the graph's shape."""
    _, tds = _datasets()
    cfg = _config(impl, dropout_rate=0.5, eval_every=4, chunk=2)
    a = Trainer(build_gcn(LAYERS, dropout_rate=0.5), tds, cfg, device="cpu")
    b = DistributedTrainer(build_gcn(LAYERS, dropout_rate=0.5), tds, 1, cfg,
                           device="cpu")
    assert b.plan.part_nodes == 96 and b.gctx.gathered_rows == 96
    ha, hb = a.train(), b.train()
    assert torch.equal(torch.stack(a.losses), torch.stack(b.losses))
    # the timings (and the rates and EWMA made of them), and the cost
    # model's straggler fields of the partitioned trainer's records
    drop = ("epoch_ms", "eval_ms", "first_step_ms", "edges_per_s",
            "tflops_per_s", "step_ewma_ms", "straggler_part",
            "straggler_ratio")
    assert [{k: v for k, v in m.items() if k not in drop} for m in ha] == \
        [{k: v for k, v in m.items() if k not in drop} for m in hb]
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k])
    assert torch.equal(a.predict(), b.predict())
    assert torch.equal(a.predict([7, 0, 95]), b.predict([7, 0, 95]))


def test_trainer_contract(world_of_one, monkeypatch):
    """The card unless asked for the CPU, and no fallback (the trainer
    and the spawned ranks' job alike); one part per rank; the kernel
    routes refuse a graph that is not symmetric; a halo that is not
    'gather' or 'ring' is refused."""
    _, tds = _datasets()
    model = build_gcn(LAYERS)
    with pytest.raises(ValueError, match="one partition per rank"):
        DistributedTrainer(model, tds, 2, _config("cuda"), device="cpu")
    with pytest.raises(NotImplementedError, match="symmetric"):
        DistributedTrainer(model, _directed_datasets(), 1,
                           _config("cuda", symmetric=None), device="cpu")
    with pytest.raises(ValueError, match="halo"):
        shard_dataset(tds, partition_plan(tds.graph.row_ptr, 1), 0, "cpu",
                      halo="rings")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DistributedTrainer(model, tds, 1, _config("cuda"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_job([dict(model=model, dataset=tds, config=_config("cuda"))])


_INFER = re.compile(r"^\[INFER\]\[(\d+)\] train_loss: (\d+\.\d{4})  ")


def test_cli_parts_through_torchrun(capsys):
    """``torchrun --nproc-per-node 2 -m roc_tpu_torch.train.cli --parts 2
    --cpu``: rank 0 alone prints the [INFER] lines, and with dropout 0
    they show the single-device CLI's train loss (to its printed 4
    decimals, within 1e-4) and accuracies; --parts without the launcher's
    ranks is refused."""
    from roc_tpu_torch.train import cli
    flags = ["--cpu", "-layers", "16-16-4", "-e", "10", "--eval-every",
             "5", "-dropout", "0.0"]
    assert cli.main(flags) == 0
    single = [ln for ln in capsys.readouterr().out.splitlines()
              if ln.startswith("[INFER]")]
    env = dict(os.environ, PYTHONPATH=_REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    r = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "roc_tpu_torch.train.cli",
         "--parts", "2", *flags], capture_output=True, text=True,
        timeout=300, cwd=_REPO, env=env)
    assert r.returncode == 0, r.stderr[-3000:]
    lines = [ln for ln in r.stdout.splitlines() if ln.startswith("[INFER]")]
    assert len(lines) == len(single) == 2, r.stdout
    for got, want in zip(lines, single):
        g, w = _INFER.match(got), _INFER.match(want)
        assert g.group(1) == w.group(1)
        assert abs(float(g.group(2)) - float(w.group(2))) <= 1e-4 * max(
            1.0, float(w.group(2))) + 1e-4
        assert got.split("train_accuracy")[1] == \
            want.split("train_accuracy")[1]
    assert cli.main(["--parts", "2", *flags]) == 2
