"""The port's ring halo (parallel/ring.py, ``halo='ring'`` on
parallel/distributed.py's DistributedTrainer) against the JAX package's,
on the CPU.

The JAX package runs in the pytest process on its virtual CPU devices;
the port's ranks are spawned gloo processes running
``tests/torch_rank_jobs.py``, which imports the port alone.  Weights
cross with convert.py; dropout is 0 wherever two runs are compared.
Every tolerance is stated with its reason.
"""

import numpy as np
import pytest

import torch

from roc_tpu.core import graph as jgraph
from roc_tpu.core.partition import partition_graph as j_partition_graph
from roc_tpu.models.gat import build_gat as j_build_gat
from roc_tpu.models.gcn import build_gcn as j_build_gcn
from roc_tpu.models.sage import build_sage as j_build_sage
from roc_tpu.parallel import ring as jring
from roc_tpu.parallel.distributed import DistributedTrainer as JDist
from roc_tpu.train.trainer import TrainConfig as JTrainConfig
from roc_tpu.train.trainer import resolve_config as j_resolve_config
from roc_tpu.train.trainer import resolve_dtypes as j_resolve_dtypes
from roc_tpu_torch import convert
from roc_tpu_torch.core import graph as tgraph
from roc_tpu_torch.core import memory as mem
from roc_tpu_torch.core.partition import partition_graph, partition_plan
from roc_tpu_torch.models.gat import build_gat
from roc_tpu_torch.models.gcn import build_gcn
from roc_tpu_torch.models.sage import build_sage
from roc_tpu_torch.ops.norm import inv_sqrt_degree_np
from roc_tpu_torch.parallel import ring as tring
from roc_tpu_torch.parallel.distributed import run_ranks
from roc_tpu_torch.train.trainer import (TrainConfig, Trainer,
                                         resolve_config, resolve_dtypes)

import torch_rank_jobs

LAYERS = [12, 16, 3]
EPOCHS = 6
# fp32: tests/test_torch_distributed.py's tolerances (the sums run in
# another order: the ring adds one pair at a time)
PARAM_TOL = dict(rtol=2e-4, atol=2e-5)
CURVE_RTOL = 1e-4
# mixed: tests/test_torch_distributed.py's (bf16 activations rounded at
# other places; the ring also adds its hops' bf16 sums)
MIXED_CURVE_RTOL = 2e-3
LOGIT_TOL = 3e-2


def _graphs():
    """``synthetic_graph`` and a symmetrised ``zipf_csr`` (skewed in
    degree), each with self edges, as port and JAX graphs of the same
    arrays."""
    out = {}
    for name, g in (("synthetic", tgraph.synthetic_graph(96, 7, seed=11)),
                    ("zipf", tgraph.add_self_edges(tgraph.from_edge_list(
                        *_coo(tgraph.zipf_csr(120, 700, seed=3)), 120,
                        symmetrize=True)))):
        out[name] = (g, jgraph.Graph(row_ptr=g.row_ptr.copy(),
                                     col_idx=g.col_idx.copy()))
    return out


def _coo(g):
    return g.col_idx, np.repeat(np.arange(g.num_nodes), np.diff(g.row_ptr))


def _datasets(graph="synthetic", seed=11):
    g, jg = _graphs()[graph]
    rng = np.random.RandomState(seed)
    V = g.num_nodes
    feats = rng.randn(V, LAYERS[0]).astype(np.float32)
    labels = rng.randint(0, LAYERS[-1], V).astype(np.int32)
    mask = rng.randint(0, 4, V).astype(np.int32)
    return (jgraph.Dataset(jg, feats, labels, mask, LAYERS[-1]),
            tgraph.Dataset(g, feats, labels, mask, LAYERS[-1]))


# ------------------------------------------------------------- the tables


def _agreeing(P, build):
    """``build(rank, agree_max)`` for every rank, with ``agree_max`` the
    elementwise max over every rank's vector (as the collective gives
    it): a first pass records each rank's vector."""
    seen = {}

    def record(rank):
        def agree(v):
            seen.setdefault(rank, []).append(np.asarray(v))
            return np.asarray(v)
        return agree

    for p in range(P):
        build(p, record(p))
    calls = len(seen[0])

    def agree_for(rank):
        it = iter(range(calls))

        def agree(v):
            i = next(it)
            return np.max(np.stack([seen[q][i] for q in range(P)]), axis=0)
        return agree
    return [build(p, agree_for(p)) for p in range(P)]


@pytest.mark.parametrize("graph", ["synthetic", "zipf"])
@pytest.mark.parametrize("P", [2, 3, 4])
def test_ring_tables_bit_equal_jax(graph, P):
    """The ring tables, their padding ratio and the baked fused weights
    equal the JAX package's bit for bit; each rank's own build (its
    columns alone and the agreed pair width) is its row of them; each
    pair's row ranges end at its real edges, so K3 reads no padding."""
    g, jg = _graphs()[graph]
    tpg = partition_graph(g, P, edge_multiple=64, method="cost")
    jpg = j_partition_graph(jg, P, edge_multiple=64, method="cost")
    assert [tuple(map(int, b)) for b in tpg.bounds] == \
        [tuple(map(int, b)) for b in jpg.bounds]
    trt, jrt = tring.build_ring_tables(tpg), jring.build_ring_tables(jpg)
    np.testing.assert_array_equal(trt.src, jrt.src)
    np.testing.assert_array_equal(trt.dst, jrt.dst)
    assert trt.padding_ratio == jrt.padding_ratio
    assert tring.ring_hop_perm(P) == jring.ring_hop_perm(P)
    d = inv_sqrt_degree_np(g.in_degree)
    np.testing.assert_array_equal(tring.ring_weight_tables(tpg, trt, d),
                                  jring.ring_weight_tables(jpg, jrt, d))
    plan = partition_plan(g.row_ptr, P, edge_multiple=64, method="cost")
    parts = _agreeing(P, lambda p, agree: tring.ring_part_tables(
        plan, p, tpg.part_col_idx[p], agree))
    for p, rt in enumerate(parts):
        np.testing.assert_array_equal(rt["src"], jrt.src[p])
        np.testing.assert_array_equal(rt["dst"], jrt.dst[p])
        assert rt["pair_edges"] == jrt.pair_edges
        assert rt["padding_ratio"] == jrt.padding_ratio
        for s in range(P):
            n = rt["real"][s]
            assert rt["row_ptr"][s, -1] == n
            assert (rt["src"][s, :n] < plan.part_nodes).all()
            assert (rt["src"][s, n:] == plan.part_nodes).all()
            np.testing.assert_array_equal(np.diff(rt["row_ptr"][s]),
                                          np.bincount(rt["dst"][s, :n],
                                                      minlength=plan
                                                      .part_nodes))


def test_ring_aggregate_overlap_and_kernel_forms_agree():
    """One rank's ring sum on a world of one: K3 with the row ranges (the
    kernel form, its plain version here), K3's plain version and the
    weighted sum with unit weights all give the plain edge-list sum."""
    import torch.distributed as dist
    g, _ = _graphs()["zipf"]
    plan = partition_plan(g.row_ptr, 1, edge_multiple=64)
    col = g.col_idx
    rt = tring.ring_part_tables(plan, 0, col)
    x = torch.from_numpy(np.random.RandomState(0).randn(
        plan.part_nodes, 5).astype(np.float32))

    class One:
        rank, world_size = 0, 1

    src, dst = torch.from_numpy(rt["src"]), torch.from_numpy(rt["dst"])
    rp = torch.from_numpy(rt["row_ptr"])
    want = torch.zeros(plan.part_nodes, 5).index_add_(
        0, torch.from_numpy(np.repeat(np.arange(g.num_nodes),
                                      np.diff(g.row_ptr))),
        x[torch.from_numpy(col.astype(np.int64))])
    for kw in (dict(row_ptr=rp), dict(kernel=False),
               dict(weights=torch.ones(src.shape), overlap=False)):
        got = tring.ring_aggregate(x, src, dst, One(), **kw)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                                   atol=1e-6)
    assert not dist.is_initialized()


# ---------------------------------------------------------------- training


def _config(impl, mode="float32", **kw):
    dtype, compute = resolve_dtypes(mode)
    kw = dict(dict(dropout_rate=0.0, eval_every=1, symmetric=True,
                   chunk=64, halo="ring", epochs=EPOCHS), **kw)
    return TrainConfig(aggr_impl=impl, verbose=False, weight_decay=1e-3,
                       learning_rate=0.01, dtype=dtype,
                       compute_dtype=compute, **kw)


def _jax_ring(jds, P, mode, **kw):
    dtype, compute = j_resolve_dtypes(mode)
    tr = JDist(j_build_gcn(LAYERS, dropout_rate=0.0), jds, P,
               JTrainConfig(aggr_impl="segment", dropout_rate=0.0,
                            verbose=False, epochs=EPOCHS, weight_decay=1e-3,
                            learning_rate=0.01, eval_every=1, chunk=64,
                            halo="ring", dtype=dtype, compute_dtype=compute,
                            **dict(dict(symmetric=True), **kw)))
    p0 = {k: np.asarray(v) for k, v in tr.params.items()}
    hist = tr.train()
    return (p0, hist, {k: np.asarray(v, np.float32)
                       for k, v in tr.params.items()},
            np.asarray(tr.predict()).astype(np.float32),
            [tuple(map(int, b)) for b in tr.pg.bounds])


def _check(r, ref, mode):
    _, jhist, jparams, jlogits, jbounds = ref
    assert r["bounds"] == jbounds
    rtol = CURVE_RTOL if mode == "float32" else MIXED_CURVE_RTOL
    np.testing.assert_allclose([m["train_loss"] for m in r["history"]],
                               [m["train_loss"] for m in jhist], rtol=rtol)
    scale = np.abs(jlogits).max()
    if mode == "float32":
        for k in jparams:
            np.testing.assert_allclose(r["params"][k], jparams[k],
                                       **PARAM_TOL)
        np.testing.assert_allclose(r["logits"], jlogits, rtol=0,
                                   atol=1e-4 * scale)
    else:
        np.testing.assert_allclose(r["logits"], jlogits, rtol=0,
                                   atol=LOGIT_TOL * scale)


@pytest.mark.parametrize("P", [2, 4])
def test_ring_training_matches_jax_and_gather(P):
    """P gloo ranks, 6 epochs from the JAX run's weights: the ring on
    the kernel routes (K3's plain version per hop here) and on 'ell'
    (the baked ring weights of the fused chain, as the JAX package's
    plain ring) against JAX DistributedTrainer(halo='ring') in fp32 and
    'mixed'; against the port's gather halo on the same split; overlap
    off gives overlap on's bits; the plan event carries P, pair_edges,
    padding_ratio and the overlap.  At P = 4 also memory='auto' with the
    ring/remat plan's estimate as the budget: the JAX package's plan (the
    ring, with remat), and it trains."""
    jds, tds = _datasets()
    refs = {mode: _jax_ring(jds, P, mode) for mode in ("float32", "mixed")}
    p0 = convert.params_from_jax(refs["float32"][0])

    def run(impl, mode="float32", **kw):
        return dict(model=build_gcn(LAYERS, dropout_rate=0.0), dataset=tds,
                    config=_config(impl, mode, **kw), params=p0)

    runs = [run("cuda"), run("cuda", ring_overlap=False), run("cuda_csr"),
            run("ell"), run("cuda", "mixed"), run("cuda", halo="gather")]
    if P == 4:
        auto_run, jplan = _autopilot_run()
        runs.append(auto_run)
    res = run_ranks(torch_rank_jobs.job, P, runs=runs, device="cpu")
    ring, off, csr, ell, mixed, gather = res[0][:6]
    for r in (ring, csr, ell):
        _check(r, refs["float32"], "float32")
    _check(mixed, refs["mixed"], "mixed")
    assert ring["ring"]["baked"] is False and ell["ring"]["baked"] is True
    for k in ring["params"]:
        np.testing.assert_array_equal(off["params"][k], ring["params"][k])
        np.testing.assert_allclose(ring["params"][k], gather["params"][k],
                                   **PARAM_TOL)
    np.testing.assert_array_equal(off["losses"], ring["losses"])
    np.testing.assert_allclose(ring["losses"], gather["losses"], rtol=1e-5)
    for rank_runs in res[1:]:
        for a, b in zip(rank_runs, res[0]):
            for k in a["params"]:
                np.testing.assert_array_equal(a["params"][k],
                                              b["params"][k])
    jpg = j_partition_graph(jds.graph, P, edge_multiple=64, method="cost")
    jrt = jring.build_ring_tables(jpg)
    for rank, rank_runs in enumerate(res):
        rt = rank_runs[0]["ring"]
        np.testing.assert_array_equal(rt["src"], jrt.src[rank])
        np.testing.assert_array_equal(rt["dst"], jrt.dst[rank])
        (ev,) = [e for e in rank_runs[0]["events"]
                 if e["cat"] == "plan" and "pair_edges" in e]
        assert (ev["num_parts"], ev["pair_edges"], ev["padding_ratio"],
                ev["ring_overlap"]) == (P, jrt.pair_edges,
                                        jrt.padding_ratio, True)
        assert f"pair_edges={jrt.pair_edges}" in ev["msg"]
    assert [e for e in res[0][1]["events"] if "pair_edges" in e][0][
        "ring_overlap"] is False
    if P == 4:
        auto = res[0][6]
        assert (auto["config"]["halo"], auto["config"]["features"],
                auto["config"]["remat"]) == jplan == ("ring", "hbm", True)
        assert np.isfinite(auto["losses"]).all() and \
            len(auto["losses"]) == 3


def _directed():
    """A graph that is not symmetric (tests/test_torch_distributed.py's),
    as JAX and port datasets."""
    rng = np.random.RandomState(11)
    V = 90
    src, dst = rng.randint(0, V, 500), rng.randint(0, V, 500)
    g = tgraph.add_self_edges(tgraph.from_edge_list(src, dst, V))
    assert not tgraph.check_symmetric(g)
    feats = rng.randn(V, LAYERS[0]).astype(np.float32)
    labels = rng.randint(0, LAYERS[-1], V).astype(np.int32)
    mask = rng.randint(0, 4, V).astype(np.int32)
    jg = jgraph.Graph(row_ptr=g.row_ptr.copy(), col_idx=g.col_idx.copy())
    return (jgraph.Dataset(jg, feats, labels, mask, LAYERS[-1]),
            tgraph.Dataset(g, feats, labels, mask, LAYERS[-1]))


def _autopilot_run():
    """A memory='auto' run at P = 4 whose budget is the ring/remat plan's
    estimate (tests/test_torch_memory.py's graph: at P = 2 the model puts
    every ring plan above the gather's), and the JAX package's plan for
    it."""
    dims = [8, 64, 3]
    tds = tgraph.synthetic_dataset(64 * 64, 5, in_dim=8, num_classes=3,
                                   seed=4)
    jds = jgraph.synthetic_dataset(64 * 64, 5, in_dim=8, num_classes=3,
                                   seed=4)
    budget = mem.estimate_plan_bytes(tds.graph.num_nodes,
                                     tds.graph.num_edges, dims, num_parts=4,
                                     halo="ring", remat=True)
    _, jcfg, _ = j_resolve_config(
        j_build_gcn(dims), jds, JTrainConfig(memory="auto", hbm_bytes=budget,
                                             verbose=False), num_parts=4)
    run = dict(model=build_gcn(dims, dropout_rate=0.0), dataset=tds,
               config=_config("cuda", halo="gather", memory="auto",
                              hbm_bytes=budget, epochs=3))
    return run, (jcfg.halo, jcfg.features, jcfg.remat)


def test_ring_directed_graph():
    """At P = 2 a graph that is not symmetric trains on the ring by
    autograd (the rotation's transpose sends the cotangent back) on
    'ell' and 'segment', against JAX's ring (symmetric=False), and the
    gradients before the first step equal single-device autograd's."""
    jdir, tdir = _directed()
    ref = _jax_ring(jdir, 2, "float32", symmetric=False)
    p0 = convert.params_from_jax(ref[0])
    runs = [dict(model=build_gcn(LAYERS, dropout_rate=0.0), dataset=tdir,
                 config=_config(impl, symmetric=False), params=p0,
                 grads=True)
            for impl in ("ell", "segment")]
    res = run_ranks(torch_rank_jobs.job, 2, runs=runs, device="cpu")
    one = Trainer(build_gcn(LAYERS, dropout_rate=0.0), tdir,
                  _config("segment", symmetric=False, halo="gather"),
                  params=p0, device="cpu")
    names = list(one.params)
    loss, _ = one.model.loss_fn(one.params, one.feats, one.labels, one.mask,
                                one.gctx, train=True)
    want = dict(zip(names, torch.autograd.grad(
        loss, [one.params[k] for k in names])))
    # fp32 gradients summed in another order (per pair, then over the
    # ranks)
    for r in res[0]:
        _check(r, ref, "float32")
        for k in names:
            np.testing.assert_allclose(r["grads"][k], want[k].numpy(),
                                       rtol=1e-5, atol=1e-6)


def test_ring_refusals():
    """As in the JAX package: MAX/MIN and attention models refuse the ring
    at set-up with its message, features='host' stays single-device, the
    kernel routes refuse a graph that is not symmetric, and one part runs
    the gather whatever the config asks."""
    jds, tds = _datasets()
    for tmodel, jmodel in (
            (build_gat(LAYERS, heads=2), j_build_gat(LAYERS, heads=2)),
            (build_sage(LAYERS, aggregator="pool"),
             j_build_sage(LAYERS, aggregator="pool"))):
        with pytest.raises(NotImplementedError) as jerr:
            j_resolve_config(jmodel, jds, JTrainConfig(halo="ring",
                                                       verbose=False),
                             num_parts=2)
        with pytest.raises(NotImplementedError) as terr:
            resolve_config(tmodel, tds, _config("cuda"), device="cpu",
                           num_parts=2)
        assert str(terr.value) == str(jerr.value)

    class TwoParts(Trainer):
        def _num_parts(self):
            return 2

    with pytest.raises(NotImplementedError, match="single-device only"):
        TwoParts(build_gcn(LAYERS), tds, _config("cuda", features="host"),
                 device="cpu")
    with pytest.raises(NotImplementedError, match="symmetric"):
        TwoParts(build_gcn(LAYERS), _directed()[1],
                 _config("cuda_csr", symmetric=None), device="cpu")
    _, cfg = resolve_config(build_gcn(LAYERS), tds, _config("cuda"),
                            device="cpu")
    assert cfg.halo == "gather"
    with pytest.raises(ValueError, match="unknown halo"):
        resolve_config(build_gcn(LAYERS), tds, _config("cuda", halo="rng"),
                       device="cpu", num_parts=2)
