"""The port's serving slice against the JAX package: weights carried
across with roc_tpu_torch/convert.py, the same 24-16-5 GCN and dataset
in both, logits compared on the CPU."""

import contextlib
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

import jax
import torch

from roc_tpu.core.graph import synthetic_dataset as j_synthetic_dataset
from roc_tpu.models.gcn import build_gcn as j_build_gcn
from roc_tpu.serve.export import build_predictor as j_build_predictor
from roc_tpu.train.trainer import TrainConfig as JTrainConfig
from roc_tpu_torch import convert
from roc_tpu_torch.core.graph import synthetic_dataset
from roc_tpu_torch.models.gcn import build_gcn
from roc_tpu_torch.obs.events import get_bus
from roc_tpu_torch.serve.errors import (ServeClosed, ServeOverload,
                                        ServeTimeout)
from roc_tpu_torch.serve.export import build_predictor
from roc_tpu_torch.serve.predictor import SERVE_BUCKETS, bucket_for
from roc_tpu_torch.serve.server import Server
from roc_tpu_torch.train.trainer import TrainConfig

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAYERS = [24, 16, 5]
# logits tolerance: both packages sum neighbours in fp32 in different
# orders (and the JAX 'ell' route bakes d[dst]*d[src] into one weight
# per edge), a few fp32 roundings per logit of magnitude ~1
LOGIT_ATOL = 1e-4


@pytest.fixture(scope="module")
def rig():
    """Same dataset in both packages (bit-equal, tests/test_torch_data.py)
    and the JAX package's Glorot weights carried into the port."""
    jds = j_synthetic_dataset(300, 6, in_dim=24, num_classes=5, seed=0)
    ds = synthetic_dataset(300, 6, in_dim=24, num_classes=5, seed=0)
    jparams = j_build_gcn(LAYERS).init_params(jax.random.PRNGKey(3))
    np_params = {k: np.asarray(v) for k, v in jparams.items()}
    return jds, ds, np_params


def _port_predictor(ds, np_params, impl="cuda", fuse="auto"):
    return build_predictor(build_gcn(LAYERS), ds,
                           TrainConfig(aggr_impl=impl, aggr_fuse=fuse),
                           params=convert.params_from_jax(np_params),
                           backend="full", device="cpu")


def _jax_predictor(jds, np_params, impl, fuse):
    cfg = JTrainConfig(aggr_impl=impl, aggr_fuse=fuse, verbose=False,
                       symmetric=True)
    return j_build_predictor(j_build_gcn(LAYERS), jds, cfg,
                             params={k: jax.numpy.asarray(v)
                                     for k, v in np_params.items()},
                             backend="full")


def test_convert_round_trip(rig):
    _, _, np_params = rig
    t = convert.params_from_jax(np_params)
    assert set(t) == set(np_params)
    for k, v in np_params.items():
        assert tuple(t[k].shape) == v.shape      # [in, out], untransposed
        assert t[k].dtype == torch.float32
    back = convert.params_to_jax(t)
    for k, v in np_params.items():
        np.testing.assert_array_equal(back[k], v)
    assert convert.aggr_impl_from_jax("pallas") == "cuda"
    assert convert.aggr_impl_to_jax("cuda") == "pallas"
    assert convert.aggr_impl_from_jax("sectioned") == "sectioned"
    assert convert.aggr_impl_from_jax("blocked") == "blocked"
    with pytest.raises(ValueError):
        convert.aggr_impl_from_jax("tiled")


@pytest.mark.parametrize("fuse", ["auto", "off"])
@pytest.mark.parametrize("jax_impl", ["ell", "pallas"])
def test_full_graph_logits_match_jax(rig, jax_impl, fuse):
    """Full-graph logits of the 24-16-5 GCN: the port's route that
    stands for ``jax_impl`` (and the other port route too) against the
    JAX package's Model.apply on the same weights; 'pallas' runs in
    interpret mode on the CPU."""
    jds, ds, np_params = rig
    V = ds.graph.num_nodes
    want = _jax_predictor(jds, np_params, jax_impl, fuse).query(
        np.arange(V))
    for impl in ("cuda", "ell"):
        pred = _port_predictor(ds, np_params, impl, fuse)
        assert pred.model.num_fused_aggregates() == (2 if fuse == "auto"
                                                     else 0)
        got = pred.query(np.arange(V))
        assert got.shape == (V, 5) and np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_ATOL)


def test_query_every_bucket_matches_jax(rig):
    """Predictor.query pads to each serve bucket (pad id 0) and returns
    the JAX predictor's rows for the same ids."""
    jds, ds, np_params = rig
    jpred = _jax_predictor(jds, np_params, "ell", "auto")
    pred = _port_predictor(ds, np_params)
    rng = np.random.RandomState(4)
    sizes = (1, 5, 40, 300, 700)
    assert {bucket_for(n, SERVE_BUCKETS) for n in sizes} == set(SERVE_BUCKETS)
    for n in sizes:
        ids = rng.randint(0, ds.graph.num_nodes, size=n)
        got = pred.query(ids)
        assert got.shape == (n, 5)
        np.testing.assert_allclose(got, jpred.query(ids), rtol=0,
                                   atol=LOGIT_ATOL)
    with pytest.raises(ValueError):
        pred.query([ds.graph.num_nodes])


@pytest.fixture(scope="module")
def pred_ref(rig):
    _, ds, np_params = rig
    pred = _port_predictor(ds, np_params)
    return pred, pred.query(np.arange(ds.graph.num_nodes))


def test_server_coalescing_is_bit_exact(pred_ref):
    """Concurrent submits coalesce into shared dispatches; every result
    equals the single-caller query of the same ids bit for bit."""
    pred, ref = pred_ref
    results = []
    errors = []

    def client(seed):
        rng = np.random.RandomState(seed)
        try:
            for _ in range(6):
                ids = rng.randint(0, pred.num_nodes, size=rng.randint(1, 20))
                results.append((ids, srv.submit(ids).result(timeout=30)))
        except Exception as e:  # noqa: BLE001 - surfaced below
            errors.append(e)

    with Server(pred, max_wait_ms=2.0, name="coalesce") as srv:
        threads = [threading.Thread(target=client, args=(s,))
                   for s in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert len(results) == 24
    for ids, rows in results:
        assert rows.version == 0
        assert np.array_equal(rows, ref[ids])
        assert np.array_equal(rows, pred.query(ids))


class _SlowPredictor:
    """Delegating wrapper whose dispatch sleeps, so queue pressure is
    deterministic."""

    def __init__(self, pred, delay_s):
        self._pred = pred
        self.delay_s = delay_s

    def __getattr__(self, name):
        return getattr(self._pred, name)

    def query(self, ids, pub=None):
        time.sleep(self.delay_s)
        return self._pred.query(ids, pub=pub)


def test_deadline_gives_typed_timeout(pred_ref):
    pred, ref = pred_ref
    slow = _SlowPredictor(pred, 0.10)
    with Server(slow, max_wait_ms=0.0, name="deadline") as srv:
        srv.submit([0])
        t_wait = time.monotonic()
        while not srv._dispatching and time.monotonic() - t_wait < 2.0:
            time.sleep(0.002)
        assert srv._dispatching
        futs = [srv.submit([i], deadline_ms=30.0) for i in range(1, 9)]
        kinds = []
        for i, f in enumerate(futs, start=1):
            try:
                assert np.array_equal(f.result(timeout=10), ref[[i]])
                kinds.append("ok")
            except ServeTimeout:
                kinds.append("timeout")
    assert "timeout" in kinds, kinds


def test_saturating_burst_sheds_typed_overload(pred_ref):
    pred, ref = pred_ref
    slow = _SlowPredictor(pred, 0.05)
    ok = shed = 0
    with Server(slow, max_wait_ms=0.0, max_queue=4, name="overload") as srv:
        futs = [srv.submit([i % 50]) for i in range(60)]
        for i, f in enumerate(futs):
            try:
                assert np.array_equal(f.result(timeout=30), ref[[i % 50]])
                ok += 1
            except ServeOverload:
                shed += 1
    assert ok + shed == 60 and ok > 0 and shed > 0


def test_drain_then_closed(pred_ref):
    pred, ref = pred_ref
    srv = Server(_SlowPredictor(pred, 0.02), max_wait_ms=0.0, name="drain")
    futs = [srv.submit([i]) for i in range(6)]
    assert srv.drain(timeout=30)
    for i, f in enumerate(futs):
        assert np.array_equal(f.result(timeout=1), ref[[i]])
    with pytest.raises(ServeClosed):
        srv.submit([0]).result()
    assert not srv._thread.is_alive()
    srv.close()                       # idempotent


def test_entry_points_need_a_card_or_cpu(rig, monkeypatch):
    """Without a card and without device='cpu' the entry points raise;
    they never fall back to the CPU."""
    from roc_tpu_torch.train.trainer import make_graph_context
    _, ds, np_params = rig
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_predictor(build_gcn(LAYERS), ds, TrainConfig(),
                        backend="full")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_graph_context(ds)
    pred = _port_predictor(ds, np_params)
    assert pred.device.type == "cpu"


@pytest.mark.parametrize("impl", ["segment", "cuda_csr"])
def test_edge_route_predictor_pads_to_the_configured_chunk(rig, impl):
    """build_predictor hands config.chunk to the graph context, as the JAX
    package's does: the edge arrays are padded to a multiple of the
    configured chunk (384 here: 1,920 edges where the default 512 would
    give 2,048), and the served rows are those of the JAX predictor on
    the same route."""
    jds, ds, np_params = rig
    E = ds.graph.num_edges
    assert -(-E // 384) * 384 % 512
    pred = build_predictor(build_gcn(LAYERS), ds,
                           TrainConfig(aggr_impl=impl, chunk=384),
                           params=convert.params_from_jax(np_params),
                           backend="full", device="cpu")
    assert pred.gctx.chunk == 384
    assert pred.gctx.edge_src.numel() == pred.gctx.edge_dst.numel() == \
        -(-E // 384) * 384
    ids = np.arange(0, ds.graph.num_nodes, 7)
    jpred = _jax_predictor(jds, np_params, "segment", "auto")
    np.testing.assert_allclose(pred.query(ids), jpred.query(ids), rtol=0,
                               atol=LOGIT_ATOL)


@contextlib.contextmanager
def _events():
    """The port bus's records emitted inside the block, through a sink of
    its own (the flight ring is bounded, so it may already be full)."""
    class Sink(list):
        write = list.append

    bus, sink = get_bus(), Sink()
    bus.add_sink(sink)
    try:
        yield sink
    finally:
        bus.sinks.remove(sink)


# family -> (registry name, builder kwargs); widths 24-16-5, dropout 0
RESOLVED = {"gat": ("gat", {"heads": 1}),
            "sage_pool": ("sage", {"aggregator": "pool"})}


@pytest.mark.parametrize("impl", ["cuda_csr", "segment"])
@pytest.mark.parametrize("fam", sorted(RESOLVED))
def test_predictor_runs_the_trainers_resolve_pass(rig, fam, impl):
    """build_predictor resolves as Trainer does (fuse, then the attention
    route): a GAT (no edge-list form) or SAGE-pool (no 'cuda_csr' max)
    predictor asked for on an edge route serves the JAX predictor's
    logits for the same weights, and emits the ``resolve`` event where
    the route moved."""
    from roc_tpu.models import model_builders as j_model_builders
    from roc_tpu_torch.models import model_builders
    jds, ds, _ = rig
    name, kw = RESOLVED[fam]
    jmodel = j_model_builders()[name](LAYERS, dropout_rate=0.0, **kw)
    jparams = jmodel.init_params(jax.random.PRNGKey(5))
    jpred = j_build_predictor(
        jmodel, jds, JTrainConfig(aggr_impl=convert.aggr_impl_to_jax(impl),
                                  verbose=False, symmetric=True),
        params=jparams, backend="full")
    with _events() as recs:
        pred = build_predictor(
            model_builders()[name](LAYERS, dropout_rate=0.0, **kw), ds,
            TrainConfig(aggr_impl=impl),
            params=convert.params_from_jax(
                {k: np.asarray(v) for k, v in jparams.items()}),
            backend="full", device="cpu")
    moved = pred.config.aggr_impl != impl
    assert moved == (fam == "gat" or impl == "cuda_csr")
    assert pred.gctx.aggr_impl == pred.config.aggr_impl
    ev = [r for r in recs if r.get("cat") == "resolve"]
    assert len(ev) == int(moved)
    V = ds.graph.num_nodes
    np.testing.assert_allclose(pred.query(np.arange(V)),
                               jpred.query(np.arange(V)), rtol=1e-5,
                               atol=LOGIT_ATOL)


def _avg_prefix_model(builder_mod):
    """norm -> AVG scatter_gather -> linear, built by hand."""
    m = builder_mod.Model(in_dim=24)
    t = m.input()
    t = m.indegree_norm(t)
    t = m.scatter_gather(t, aggr=builder_mod.AGGR_AVG)
    t = m.linear(t, 5)
    m.softmax_cross_entropy(t)
    return m


def test_avg_prefix_serves_precomputed_akx_in_both_packages(rig):
    """A propagation prefix with AVG is parameter-free: 'auto' resolves
    it to precomputed/akx in both packages, and the two serve the same
    logits."""
    from roc_tpu.models import builder as jbuilder
    from roc_tpu_torch.models import builder
    from roc_tpu_torch.serve.export import resolve_backend
    from roc_tpu.serve.export import resolve_backend as j_resolve_backend
    jds, ds, _ = rig
    jm, m = _avg_prefix_model(jbuilder), _avg_prefix_model(builder)
    assert j_resolve_backend(jm, "auto") == ("precomputed", "akx")
    assert resolve_backend(m, "auto") == ("precomputed", "akx")
    jparams = jm.init_params(jax.random.PRNGKey(2))
    jpred = j_build_predictor(jm, jds, JTrainConfig(
        aggr_impl="segment", verbose=False, symmetric=True),
        params=jparams)
    pred = build_predictor(m, ds, TrainConfig(), device="cpu",
                           params=convert.params_from_jax(
                               {k: np.asarray(v)
                                for k, v in jparams.items()}))
    assert (pred.backend, pred.flavor) == ("precomputed", "akx")
    assert pred.cache.ops[1] == {"kind": "scatter_gather", "aggr": "avg"}
    ids = np.arange(ds.graph.num_nodes)
    np.testing.assert_allclose(pred.query(ids), jpred.query(ids),
                               rtol=1e-5, atol=1e-5)


def test_port_imports_no_jax():
    """Every module of roc_tpu_torch imports without JAX or roc_tpu."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import roc_tpu_torch\n"
        "for m in pkgutil.walk_packages(roc_tpu_torch.__path__, "
        "'roc_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or "
        "k.startswith('jax.') or k == 'roc_tpu' or "
        "k.startswith('roc_tpu.'))\n"
        "assert not bad, bad\n"
        "n = sum(1 for k in sys.modules if k.startswith('roc_tpu_torch'))\n"
        "assert n >= 20, n\n"
        "print('ok', n)\n")
    env = dict(os.environ, PYTHONPATH=_REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=_REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")


def test_dropout_is_identity_at_inference_and_seeded_in_training(rig):
    """Inverted dropout: identity at inference; in training it needs an
    explicit torch.Generator and the same seed gives the same mask."""
    from roc_tpu_torch.ops.dense import dropout
    _, ds, np_params = rig
    x = torch.ones(64, 32)
    assert dropout(x, 0.5, None, train=False) is x
    with pytest.raises(ValueError):
        dropout(x, 0.5, None, train=True)
    a = dropout(x, 0.5, torch.Generator().manual_seed(1), train=True)
    b = dropout(x, 0.5, torch.Generator().manual_seed(1), train=True)
    assert torch.equal(a, b)
    assert set(a.unique().tolist()) == {0.0, 2.0}
    assert 0.3 < float((a == 0).float().mean()) < 0.7
    pred = _port_predictor(ds, np_params)
    with pytest.raises(ValueError, match="Generator"):
        pred.model.apply(pred.params, pred.published().table, pred.gctx,
                         train=True)
