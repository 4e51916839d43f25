"""The port's training slice against the JAX package, on the CPU.

Inputs come from numpy seeds; JAX weights cross with
roc_tpu_torch/convert.py; every tolerance is stated with its reason.  On
the CPU the kernel routes ('cuda', 'cuda_csr') run the kernels' plain
versions; the CUDA kernels are held to those on the card by
tests/test_torch_cuda.py.
"""

import os
import re
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from roc_tpu.core import graph as jgraph
from roc_tpu.core.partition import padded_edge_list as j_padded_edge_list
from roc_tpu.kernels.spmm import csr_spmm_pallas
from roc_tpu.models.gcn import build_gcn as j_build_gcn
from roc_tpu.ops import loss as jloss
from roc_tpu.ops.aggregate import aggregate_segment as j_aggregate_segment
from roc_tpu.ops.norm import indegree_norm as j_indegree_norm
from roc_tpu.train import optimizer as jopt
from roc_tpu.train.trainer import TrainConfig as JTrainConfig
from roc_tpu.train.trainer import Trainer as JTrainer
from roc_tpu.train.trainer import format_metrics as j_format_metrics
from roc_tpu.train.trainer import make_graph_context as j_make_graph_context
from roc_tpu_torch import convert
from roc_tpu_torch.core import graph as tgraph
from roc_tpu_torch.core.partition import padded_edge_list
from roc_tpu_torch.kernels.spmm import csr_spmm, csr_spmm_plain
from roc_tpu_torch.models.gcn import build_gcn
from roc_tpu_torch.ops import loss as tloss
from roc_tpu_torch.ops.aggregate import aggregate, aggregate_segment
from roc_tpu_torch.ops.norm import indegree_norm
from roc_tpu_torch.train import optimizer as topt
from roc_tpu_torch.train.trainer import (TrainConfig, Trainer,
                                         format_metrics,
                                         make_graph_context)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAYERS = [24, 16, 5]


def _datasets(V=200, deg=6, seed=0):
    """The same dataset in both packages (bit-equal,
    tests/test_torch_data.py)."""
    return (jgraph.synthetic_dataset(V, deg, in_dim=LAYERS[0],
                                     num_classes=LAYERS[-1], seed=seed),
            tgraph.synthetic_dataset(V, deg, in_dim=LAYERS[0],
                                     num_classes=LAYERS[-1], seed=seed))


def _sum_tol(want):
    """Neighbour sums in another fp32 order: rtol 1e-5, atol 1e-5 *
    max|row|."""
    return dict(rtol=1e-5, atol=1e-5 * float(np.abs(want).max()))


# ---------------------------------------------------------------- loss


def _logits_case(V=97, C=5, seed=0):
    rng = np.random.RandomState(seed)
    logits = (rng.randn(V, C) * 3).astype(np.float32)
    labels = rng.randint(0, C, V).astype(np.int32)
    mask = rng.randint(0, 4, V).astype(np.int32)      # MASK_NONE..TEST
    return logits, labels, mask


def test_loss_and_metrics_match_jax():
    """The summed train CE and the metric sums: fp32 reductions in
    another order, rtol 1e-6; counts and the summary exactly."""
    logits, labels, mask = _logits_case()
    want = float(jloss.masked_softmax_cross_entropy(
        jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(mask)))
    t = [torch.from_numpy(a) for a in (logits, labels, mask)]
    got = float(tloss.masked_softmax_cross_entropy(*t))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    jm = jax.device_get(jloss.perf_metrics(*map(jnp.asarray,
                                                (logits, labels, mask))))
    tm = tloss.perf_metrics(*t)
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-6)
    js, ts = jloss.summarize_metrics(jm), tloss.summarize_metrics(tm)
    assert set(js) == set(ts)
    for k in js:
        np.testing.assert_allclose(ts[k], js[k], rtol=1e-6)
    assert format_metrics(3, ts) == j_format_metrics(3, ts)


def test_loss_gradient_is_softmax_minus_onehot_on_train_rows():
    logits, labels, mask = _logits_case(seed=1)
    x = torch.from_numpy(logits).requires_grad_(True)
    loss = tloss.masked_softmax_cross_entropy(
        x, torch.from_numpy(labels), torch.from_numpy(mask))
    (g,) = torch.autograd.grad(loss, x)
    p = torch.softmax(torch.from_numpy(logits), -1)
    want = (p - torch.nn.functional.one_hot(
        torch.from_numpy(labels).long(), 5)) * torch.from_numpy(
        (mask == tgraph.MASK_TRAIN).astype(np.float32))[:, None]
    torch.testing.assert_close(g, want, rtol=1e-6, atol=1e-7)


# ----------------------------------------------------------- optimizer


def test_adam_update_five_steps_matches_jax():
    """Five steps with weight decay over a matrix, a vector and a 0-d
    param (exempt from the decay): fp32 elementwise math in the same
    order, so params and moments agree to a few ulp (rtol 1e-6)."""
    rng = np.random.RandomState(0)
    shapes = {"w": (4, 3), "b": (5,), "eps": ()}
    p0 = {k: np.asarray(rng.randn(*s), np.float32)
          for k, s in shapes.items()}
    cfg_j = jopt.AdamConfig(weight_decay=0.05)
    cfg_t = topt.AdamConfig(weight_decay=0.05)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    tp = convert.params_from_jax(p0)
    js, ts = jopt.adam_init(jp), topt.adam_init(tp)
    for epoch in range(5):
        g = {k: np.asarray(rng.randn(*s), np.float32)
             for k, s in shapes.items()}
        lr_j = jopt.decayed_lr(0.01, jnp.asarray(epoch), 0.97, 2)
        lr_t = topt.decayed_lr(0.01, epoch, 0.97, 2)
        np.testing.assert_allclose(float(lr_t), float(lr_j), rtol=1e-6)
        jp, js = jopt.adam_update(jp, {k: jnp.asarray(v)
                                       for k, v in g.items()},
                                  js, lr_j, cfg_j)
        tp, ts = topt.adam_update(tp, convert.params_from_jax(g), ts,
                                  float(lr_t), cfg_t)
        for k in shapes:
            for a, b in ((tp[k], jp[k]), (ts.m[k], js.m[k]),
                         (ts.v[k], js.v[k])):
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           rtol=1e-6, atol=1e-9)
    assert ts.step == int(js.step) == 5
    np.testing.assert_allclose(ts.beta1_t, float(js.beta1_t), rtol=1e-7)


def test_weight_decay_exempts_0d_params():
    """With a zero gradient only the decay moves a param: a matrix
    moves, a 0-d param does not."""
    p = {"w": torch.ones(2, 2), "eps": torch.tensor(1.0)}
    g = {k: torch.zeros_like(v) for k, v in p.items()}
    p, _ = topt.adam_update(p, g, topt.adam_init(p), 0.01,
                            topt.AdamConfig(weight_decay=0.1))
    assert float(p["eps"]) == 1.0
    assert (p["w"] < 1.0).all()


@pytest.mark.parametrize("rate,steps", [(0.97, 100), (0.5, 3), (1.0, 1)])
def test_decayed_lr_matches_jax(rate, steps):
    """Staircase decay in fp32; pow may round differently: rtol 1e-6."""
    for epoch in (0, 1, 2, 3, 99, 100, 101, 250, 2999):
        want = float(jopt.decayed_lr(0.01, jnp.asarray(epoch), rate, steps))
        got = float(topt.decayed_lr(0.01, epoch, rate, steps))
        np.testing.assert_allclose(got, want, rtol=1e-6)


# ---------------------------------------------------------------- data


@pytest.mark.parametrize("multiple", [64, 512, 1024])
def test_padded_edge_list_bit_equal(multiple):
    jds, tds = _datasets(301, 7, seed=2)
    js, jd = j_padded_edge_list(jds.graph, multiple=multiple)
    ts, td = padded_edge_list(tds.graph, multiple=multiple)
    for a, b in ((ts, js), (td, jd)):
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)
    assert ts.size % multiple == 0
    assert (np.diff(td) >= 0).all()


@pytest.mark.parametrize("feats_bin", [True, False])
def test_load_dataset_bit_equal(tmp_path, feats_bin):
    """Files written by the JAX package's save_dataset load to the same
    arrays in both packages; without a .feats.bin the port parses the
    CSV and caches the .bin beside it."""
    jds, _ = _datasets(150, 5, seed=4)
    prefix = str(tmp_path / "ds")
    jgraph.save_dataset(jds, prefix, csv=True, feats_bin=feats_bin)
    got = tgraph.load_dataset(prefix, LAYERS[0], LAYERS[-1])
    assert os.path.exists(prefix + ".feats.bin")
    want = jgraph.load_dataset(prefix, LAYERS[0], LAYERS[-1])
    for name in ("row_ptr", "col_idx"):
        a, b = getattr(got.graph, name), getattr(want.graph, name)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for name in ("features", "labels", "mask"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert got.name == want.name == "ds"
    assert tgraph.load_lux_header(prefix + ".add_self_edge.lux") == (
        150, jds.graph.num_edges)


# ------------------------------------------------------------------ K3


def _hub_graph():
    """30 rows with self edges, a hub row of over 100 edges spanning
    chunks of 64, 100 random edges: padded to 4 chunks of 64."""
    rng = np.random.RandomState(5)
    V = 30
    src = np.concatenate([rng.randint(0, V, 100), rng.randint(0, V, 100)])
    dst = np.concatenate([np.full(100, 7), rng.randint(0, V, 100)])
    g = tgraph.add_self_edges(tgraph.from_edge_list(src, dst, V))
    assert 192 < g.num_edges <= 256 and g.in_degree[7] > 100
    return g


def test_csr_spmm_plain_matches_pallas_interpret():
    """K3's plain version (what the wrapper runs on the CPU) against the
    JAX package's csr_spmm_pallas in interpret mode, 4 chunks of 64."""
    g = _hub_graph()
    V, F = g.num_nodes, 12
    src, dst = padded_edge_list(g, multiple=64)
    assert src.size == 256
    feats = np.zeros((V + 1, F), np.float32)
    feats[:V] = np.random.RandomState(6).randn(V, F)
    want = np.asarray(csr_spmm_pallas(jnp.asarray(feats), jnp.asarray(src),
                                      jnp.asarray(dst), V, chunk=64,
                                      interpret=True))
    got = csr_spmm(torch.from_numpy(feats[:V]), torch.from_numpy(src),
                   torch.from_numpy(dst), V, chunk=64)
    np.testing.assert_allclose(got.numpy(), want, **_sum_tol(want))


@pytest.mark.parametrize("budget", [1 << 24, 1000])
def test_csr_spmm_plain_matches_jax_segment(budget):
    """A larger graph (with a degree-0 row), and edge chunks forced by a
    tiny budget: K3's plain version and the 'segment' sum against the
    JAX package's aggregate_segment."""
    g = tgraph.synthetic_graph(2000, 10, seed=3, power_law=True)
    keep = g.edge_dst() != 5
    g = tgraph.from_edge_list(g.col_idx[keep], g.edge_dst()[keep], 2000)
    V, F = g.num_nodes, 16
    src, dst = padded_edge_list(g, multiple=512)
    feats = np.zeros((V + 1, F), np.float32)
    feats[:V] = np.random.RandomState(7).randn(V, F)
    want = np.asarray(j_aggregate_segment(jnp.asarray(feats),
                                          jnp.asarray(src),
                                          jnp.asarray(dst), V))
    ts, td = torch.from_numpy(src), torch.from_numpy(dst)
    got = csr_spmm_plain(torch.from_numpy(feats[:V]), ts, td, V,
                         budget_elems=budget)
    np.testing.assert_allclose(got.numpy(), want, **_sum_tol(want))
    assert not got[5].any()
    seg = aggregate_segment(torch.from_numpy(feats), ts, td, V,
                            budget_elems=budget)
    np.testing.assert_allclose(seg.numpy(), want, **_sum_tol(want))


def test_convert_maps_the_edge_routes():
    assert convert.aggr_impl_from_jax("pallas_csr") == "cuda_csr"
    assert convert.aggr_impl_to_jax("cuda_csr") == "pallas_csr"
    assert convert.aggr_impl_from_jax("segment") == "segment"
    assert convert.aggr_impl_from_jax("scan") == "scan"
    with pytest.raises(ValueError):
        convert.aggr_impl_from_jax("tiled")


def test_edge_list_dispatcher_and_k3_contract():
    """aggregate(impl=) takes the JAX contract (a trailing zero row) for
    every ported impl; K3 keeps the JAX function's chunk assertion."""
    g = _hub_graph()
    V = g.num_nodes
    src, dst = (torch.from_numpy(a) for a in padded_edge_list(g, 64))
    feats = torch.zeros(V + 1, 6)
    feats[:V] = torch.from_numpy(np.random.RandomState(8).randn(V, 6)
                                 .astype(np.float32))
    a = aggregate(feats, src, dst, V, impl="segment")
    b = aggregate(feats, src, dst, V, impl="cuda_csr", chunk=64)
    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    for impl in ("blocked", "scan"):
        torch.testing.assert_close(
            aggregate(feats, src, dst, V, impl=impl, chunk=64), a,
            rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="not ported"):
        aggregate(feats, src, dst, V, impl="pallas")
    with pytest.raises(ValueError, match="chunk multiple"):
        csr_spmm(feats[:V], src[:-1], dst[:-1], V, chunk=64)
    n = csr_spmm.launches
    csr_spmm(feats[:V], src, dst, V, chunk=64)
    assert csr_spmm.launches == n          # the CPU runs the plain version


# ------------------------------------------------- aggregation gradients


def _grad_case(jimpl, port_impl, fuse, relu):
    jds, tds = _datasets(120, 6, seed=9)
    V, F = tds.graph.num_nodes, 8
    rng = np.random.RandomState(10)
    x = rng.randn(V, F).astype(np.float32)
    w = rng.randn(V, F).astype(np.float32)
    jg = j_make_graph_context(jds, jimpl, chunk=64, symmetric=True)

    def jf(xx):
        if fuse:
            y = jg.aggregate_fused(xx)
        else:
            y = j_indegree_norm(jg.aggregate_sum(
                j_indegree_norm(xx, jg.in_degree)), jg.in_degree)
        if relu:
            y = jax.nn.relu(y)
        return jnp.sum(y * jnp.asarray(w)), y

    (_, jy), jgrad = jax.value_and_grad(jf, has_aux=True)(jnp.asarray(x))
    tg = make_graph_context(tds, port_impl, symmetric=True, device="cpu",
                            chunk=64)
    tx = torch.from_numpy(x).requires_grad_(True)
    if fuse:
        ty = tg.aggregate_fused(tx, "relu" if relu else "none")
    else:
        ty = indegree_norm(tg.aggregate(indegree_norm(tx, tg.in_degree)),
                           tg.in_degree)
        if relu:
            ty = torch.relu(ty)
    (tgrad,) = torch.autograd.grad((ty * torch.from_numpy(w)).sum(), tx)
    return np.asarray(jy), np.asarray(jgrad), ty.detach().numpy(), \
        tgrad.numpy()


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("fuse", [True, False])
@pytest.mark.parametrize("jimpl,port_impls", [
    ("pallas", ("cuda", "ell")), ("scan", ("cuda_csr", "segment"))])
def test_aggregation_gradients_match_jax_grad(jimpl, port_impls, fuse, relu):
    """The symmetric backward of every port route (autograd.Functions)
    against jax.grad through the JAX GraphContext ('pallas' in interpret
    mode for the ELL routes, 'scan' for the edge routes), fused and
    unfused, with and without relu: outputs and gradients to fp32
    neighbour-sum rounding (rtol 1e-5, atol 1e-5 * max)."""
    for impl in port_impls:
        jy, jgrad, ty, tgrad = _grad_case(jimpl, impl, fuse, relu)
        np.testing.assert_allclose(ty, jy, **_sum_tol(jy))
        np.testing.assert_allclose(tgrad, jgrad, **_sum_tol(jgrad))


def _directed_datasets():
    """A graph that is not symmetric, in both packages."""
    rng = np.random.RandomState(11)
    V = 90
    src, dst = rng.randint(0, V, 500), rng.randint(0, V, 500)
    tg = tgraph.add_self_edges(tgraph.from_edge_list(src, dst, V))
    jg = jgraph.Graph(row_ptr=tg.row_ptr.copy(), col_idx=tg.col_idx.copy())
    assert not tgraph.check_symmetric(tg)
    feats = rng.randn(V, LAYERS[0]).astype(np.float32)
    labels = rng.randint(0, LAYERS[-1], V).astype(np.int32)
    mask = rng.randint(0, 4, V).astype(np.int32)
    return (jgraph.Dataset(jg, feats, labels, mask, LAYERS[-1]),
            tgraph.Dataset(tg, feats, labels, mask, LAYERS[-1]))


@pytest.mark.parametrize("impl", ["ell", "segment"])
def test_directed_graph_exact_gradients_on_plain_routes(impl):
    """symmetric=False: the plain routes differentiate by autograd, the
    exact transpose, as jax.grad does for the JAX package."""
    jds, tds = _directed_datasets()
    V, F = tds.graph.num_nodes, 6
    rng = np.random.RandomState(12)
    x = rng.randn(V, F).astype(np.float32)
    w = rng.randn(V, F).astype(np.float32)
    jg = j_make_graph_context(jds, impl, chunk=64, symmetric=False)
    jgrad = jax.grad(lambda xx: jnp.sum(jax.nn.relu(
        jg.aggregate_fused(xx)) * w))(jnp.asarray(x))
    tg = make_graph_context(tds, impl, device="cpu", chunk=64)
    assert tg.symmetric is False
    tx = torch.from_numpy(x).requires_grad_(True)
    (tgrad,) = torch.autograd.grad(
        (tg.aggregate_fused(tx, "relu") * torch.from_numpy(w)).sum(), tx)
    jgrad = np.asarray(jgrad)
    np.testing.assert_allclose(tgrad.numpy(), jgrad, **_sum_tol(jgrad))


@pytest.mark.parametrize("impl", ["cuda", "cuda_csr"])
def test_symmetric_false_raises_on_kernel_routes(impl):
    """The kernel routes differentiate by the symmetric trick only."""
    _, tds = _directed_datasets()
    tg = make_graph_context(tds, impl, device="cpu", chunk=64)
    x = torch.ones(tds.graph.num_nodes, 4, requires_grad=True)
    with pytest.raises(NotImplementedError, match="symmetric"):
        tg.aggregate_fused(x)
    with pytest.raises(NotImplementedError, match="symmetric"):
        tg.aggregate(x)
    with torch.no_grad():                  # a forward alone still runs
        assert tg.aggregate(x).shape == x.shape
    with pytest.raises(NotImplementedError, match="symmetric"):
        Trainer(build_gcn(LAYERS), tds, TrainConfig(aggr_impl=impl),
                device="cpu")


# ------------------------------------------------------------- training


def _jax_run(jds, jimpl, epochs, fuse="auto"):
    """The JAX trainer, dropout 0, an eval every epoch: returns its
    starting weights, its eval history and its final weights."""
    jtr = JTrainer(j_build_gcn(LAYERS, dropout_rate=0.0), jds,
                   JTrainConfig(aggr_impl=jimpl, aggr_fuse=fuse,
                                epochs=epochs, eval_every=1,
                                verbose=False, symmetric=True, chunk=64))
    p0 = {k: np.asarray(v) for k, v in jtr.params.items()}
    hist = jtr.train()
    return p0, hist, {k: np.asarray(v) for k, v in jtr.params.items()}


@pytest.fixture(scope="module")
def jax_runs():
    jds, tds = _datasets()
    return tds, {impl: _jax_run(jds, impl, 20) for impl in ("ell", "scan")}


def _port_run(tds, impl, p0, epochs, fuse="auto"):
    tr = Trainer(build_gcn(LAYERS, dropout_rate=0.0), tds,
                 TrainConfig(aggr_impl=impl, aggr_fuse=fuse, epochs=epochs,
                             eval_every=1, verbose=False, symmetric=True,
                             chunk=64),
                 params=convert.params_from_jax(p0), device="cpu")
    hist = tr.train()
    return hist, convert.params_to_jax(tr.params)


# The loss curve: the printed train loss (sum over ~100 train rows of
# 1 - p_true, from ~80 down) after each step; rtol 1e-4 leaves room for
# fp32 sums in another order, compounded over 20 Adam steps.  Weights:
# rtol 2e-4, atol 1e-5, as tests/test_kernels.py holds routes across
# implementations (Adam moves a weight by ~lr per step whatever the
# gradient's size, so a near-zero gradient amplifies rounding).
CURVE_RTOL = 1e-4
PARAM_TOL = dict(rtol=2e-4, atol=1e-5)


def _check_run(hist, params, jhist, jparams):
    assert [m["epoch"] for m in hist] == [m["epoch"] for m in jhist]
    np.testing.assert_allclose([m["train_loss"] for m in hist],
                               [m["train_loss"] for m in jhist],
                               rtol=CURVE_RTOL)
    for k in ("train_cnt", "val_cnt", "test_cnt"):
        assert [m[k] for m in hist] == [m[k] for m in jhist]
    for k in jparams:
        np.testing.assert_allclose(params[k], jparams[k], **PARAM_TOL)


@pytest.mark.parametrize("jimpl,impl", [("ell", "cuda"), ("ell", "ell"),
                                        ("scan", "cuda_csr"),
                                        ("scan", "segment")])
def test_twenty_epoch_curve_matches_jax_trainer(jax_runs, jimpl, impl):
    """20 epochs, dropout 0, from the JAX trainer's own Glorot weights:
    the ELL routes against the JAX 'ell' trainer, the edge routes
    against its 'scan' trainer (the same semantics as 'pallas_csr',
    which does not run on the CPU through the trainer)."""
    tds, runs = jax_runs
    p0, jhist, jparams = runs[jimpl]
    hist, params = _port_run(tds, impl, p0, 20)
    assert len(hist) == 20
    _check_run(hist, params, jhist, jparams)
    assert hist[-1]["train_loss"] < hist[0]["train_loss"]


def test_cuda_route_matches_jax_pallas_trainer():
    """The port's kernel route against the JAX trainer on its hand-
    written route ('pallas', interpret mode), 10 epochs, unfused."""
    jds, tds = _datasets()
    p0, jhist, jparams = _jax_run(jds, "pallas", 10, fuse="off")
    hist, params = _port_run(tds, "cuda", p0, 10, fuse="off")
    _check_run(hist, params, jhist, jparams)


def test_dropout_training_repeats_from_a_seed():
    """With dropout the masks come from the trainer's generator: the same
    seed gives the same losses bit for bit, another seed other ones, and
    the model learns."""
    _, tds = _datasets()

    def run(seed):
        tr = Trainer(build_gcn(LAYERS, dropout_rate=0.5), tds,
                     TrainConfig(aggr_impl="cuda", seed=seed, epochs=10,
                                 verbose=False),
                     device="cpu")
        hist = tr.train()
        return torch.stack(tr.losses), hist

    a, ha = run(3)
    b, _ = run(3)
    c, _ = run(4)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    assert a.shape == (10,) and torch.isfinite(a).all()
    assert ha[-1]["train_loss"] < ha[0]["train_loss"]
    assert ha[0]["first_step_ms"] > 0 and ha[0]["epoch_ms"] > 0


def test_trainer_needs_a_card_or_cpu(monkeypatch):
    """Without a card and without device='cpu' (or --cpu) the entry
    points raise; they never fall back to the CPU."""
    from roc_tpu_torch.train import cli
    _, tds = _datasets(100, 4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(build_gcn(LAYERS), tds, TrainConfig())
    assert cli.main(["-layers", "16-16-4", "-e", "1"]) == 2
    tr = Trainer(build_gcn(LAYERS), tds, TrainConfig(), device="cpu")
    assert tr.feats.device.type == "cpu"


_INFER = re.compile(
    r"^\[INFER\]\[(\d+)\] train_loss: \d+\.\d{4}  "
    r"train_accuracy: \d+\.\d{2}%\(\d+/\d+\)  "
    r"val_accuracy: \d+\.\d{2}%\(\d+/\d+\)  "
    r"test_accuracy: \d+\.\d{2}%\(\d+/\d+\)$")


def test_cli_prints_reference_infer_lines(capsys):
    from roc_tpu_torch.train import cli
    assert cli.main(["--cpu", "-layers", "16-16-4", "-e", "10",
                     "--eval-every", "5", "-v"]) == 0
    captured = capsys.readouterr()
    lines = captured.out.splitlines()
    assert len(lines) == 2, captured.out
    assert [int(_INFER.match(ln).group(1)) for ln in lines] == [4, 9]
    # the default --impl is 'auto', as the JAX CLI's, resolved to 'cuda'
    assert "impl=auto" in captured.err
    assert "aggr_impl='auto' -> 'cuda'" in captured.err


def test_karate_gate_through_the_port_cli(tmp_path, capsys):
    """The real karate club through the product path: the port's
    converter (python -m roc_tpu_torch.convert_dataset) writes the
    reference layout, the port's CLI trains on it and must recover the
    club's split at >= 80% test accuracy."""
    from roc_tpu_torch.train import cli
    out = str(tmp_path / "d" / "karate")
    r = subprocess.run(
        [sys.executable, "-m", "roc_tpu_torch.convert_dataset",
         "--dataset", "karate", "--out", out],
        capture_output=True, text=True, timeout=300, cwd=str(tmp_path),
        env=dict(os.environ, PYTHONPATH=os.pathsep.join(
            [_REPO, os.environ.get("PYTHONPATH", "")])))
    assert r.returncode == 0, r.stderr
    assert cli.main(["--cpu", "-file", out, "-layers", "34-16-2", "-lr",
                     "0.02", "-decay", "5e-4", "-dropout", "0.0", "-e",
                     "150", "--eval-every", "150", "--impl", "ell"]) == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("[INFER]")]
    assert len(lines) == 1 and _INFER.match(lines[0]), lines
    acc = float(re.findall(r"test_accuracy:\s*([0-9.]+)%", lines[0])[0])
    assert acc >= 80.0, lines[0]
