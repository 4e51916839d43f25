"""The port's out-of-core tier (roc_tpu_torch/core/streaming.py and the
trainer's ``features='host'`` path) against the JAX package's, on the
CPU: a counterpart of each test of tests/test_streaming.py that the tier
covers, held to the JAX functions.

Inputs come from numpy seeds; JAX weights cross with convert.py.  On the
CPU a staged block is a host copy and each tile's sum runs K3's plain
version (the CUDA path is held to it on the card by chip_smoke.py).
Tolerances: neighbour sums in another fp32 order, rtol 1e-5; matmuls
over row blocks and training over 3 Adam steps, rtol 1e-4 (Adam moves a
weight by ~lr whatever its gradient's size, so rounding in a near-zero
gradient shows).
"""

import contextlib

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from roc_tpu.core import graph as jgraph
from roc_tpu.core import streaming as jstream
from roc_tpu.models.gcn import build_gcn as j_build_gcn
from roc_tpu.models.sgc import build_sgc as j_build_sgc
from roc_tpu.serve import quant as jquant
from roc_tpu.train.trainer import TrainConfig as JTrainConfig
from roc_tpu.train.trainer import Trainer as JTrainer
from roc_tpu.utils import checkpoint as jck
from roc_tpu_torch import convert
from roc_tpu_torch.core import graph as tgraph
from roc_tpu_torch.core import streaming as ts
from roc_tpu_torch.core.partition import padded_edge_list
from roc_tpu_torch.kernels.spmm import csr_spmm_plain
from roc_tpu_torch.models.builder import Model
from roc_tpu_torch.models.gcn import build_gcn
from roc_tpu_torch.models.gin import build_gin
from roc_tpu_torch.models.sgc import build_sgc
from roc_tpu_torch.obs.events import get_bus
from roc_tpu_torch.obs.heartbeat import StallFailure
from roc_tpu_torch.ops.dense import AC_MODE_RELU
from roc_tpu_torch.resilience import inject
from roc_tpu_torch.resilience.recovery import (CheckpointRotation,
                                               train_with_recovery)
from roc_tpu_torch.serve import quant
from roc_tpu_torch.serve.propagation import PropagationCache
from roc_tpu_torch.train.trainer import (TrainConfig, Trainer,
                                         make_graph_context,
                                         resolve_prefetch)
from roc_tpu_torch.utils import checkpoint as ck

SUM_TOL = dict(rtol=1e-5, atol=1e-5)
TRAIN_TOL = dict(rtol=1e-4, atol=1e-5)
LAYERS = [12, 8, 3]


@pytest.fixture(scope="module")
def graphs():
    """The JAX test's power-law graph with self edges, in both packages."""
    return (jgraph.add_self_edges(jgraph.synthetic_graph(300, 7, seed=5,
                                                         power_law=True)),
            tgraph.add_self_edges(tgraph.synthetic_graph(300, 7, seed=5,
                                                         power_law=True)))


@pytest.fixture(autouse=True)
def _no_fault():
    inject.disarm()
    yield
    inject.disarm()


def _datasets(V, deg, in_dim, classes, seed):
    return (jgraph.synthetic_dataset(V, deg, in_dim=in_dim,
                                     num_classes=classes, seed=seed),
            tgraph.synthetic_dataset(V, deg, in_dim=in_dim,
                                     num_classes=classes, seed=seed))


def _segment_sum(g, x):
    src, dst = padded_edge_list(g, multiple=64)
    return csr_spmm_plain(torch.from_numpy(x), torch.from_numpy(src),
                          torch.from_numpy(dst), g.num_nodes).numpy()


# ------------------------------------------------------- blocks and sums


def test_streamed_linear_matches_jax():
    rng = np.random.RandomState(0)
    X = rng.randn(1000, 24).astype(np.float32)
    W = rng.randn(24, 8).astype(np.float32)
    got = ts.streamed_linear(X, torch.from_numpy(W), block_rows=128)
    want = np.asarray(jstream.streamed_linear(X, jnp.asarray(W),
                                              block_rows=128))
    np.testing.assert_allclose(got.numpy(), want, **SUM_TOL)


@pytest.mark.parametrize("block_rows,edge_chunk", [(64, 128), (97, 1 << 20)])
def test_streaming_aggregator_matches_jax(graphs, block_rows, edge_chunk):
    """Per source block, each edge chunk's sum through K3's plain version,
    against the JAX aggregator's scatter-adds."""
    jg, g = graphs
    feats = np.random.RandomState(1).randn(g.num_nodes, 9).astype(np.float32)
    got = ts.StreamingAggregator(g, block_rows=block_rows,
                                 edge_chunk=edge_chunk, device="cpu")(feats)
    want = jstream.StreamingAggregator(jg, block_rows=block_rows,
                                       edge_chunk=edge_chunk)(feats)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SUM_TOL)
    np.testing.assert_allclose(got.numpy(), _segment_sum(g, feats),
                               **SUM_TOL)


def test_streaming_aggregator_static_plan_reuse(graphs):
    """The plan is static: two calls with other features are both
    exact."""
    _, g = graphs
    agg = ts.StreamingAggregator(g, block_rows=50, device="cpu")
    for seed in (0, 1):
        feats = np.random.RandomState(seed).randn(
            g.num_nodes, 4).astype(np.float32)
        np.testing.assert_allclose(agg(feats).numpy(), _segment_sum(g, feats),
                                   **SUM_TOL)


@pytest.mark.parametrize("block_rows,edge_chunk", [(32, 64), (64, 1 << 20),
                                                   (512, 100)])
def test_aggregate_to_host_matches_jax(block_rows, edge_chunk):
    """The fully host-resident blocked sum against JAX's, with many tiles
    a dst block, ragged edge chunks and one block."""
    jds, ds = _datasets(200, 7, 9, 3, 3)
    x = np.random.RandomState(0).randn(
        ds.graph.num_nodes, 9).astype(np.float32)
    got = ts.aggregate_to_host(ds.graph, x, block_rows=block_rows,
                               edge_chunk=edge_chunk, device="cpu")
    want = jstream.aggregate_to_host(jds.graph, x, block_rows=block_rows,
                                     edge_chunk=edge_chunk)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, **SUM_TOL)


def test_tile_chunks_pad_for_k3():
    """Every chunk a tile hands K3: a 512 multiple, destination ids
    relative to its first row and sorted, the padding on the last row
    with the staged block's row count as its dummy source (the last
    source block is short)."""
    ds = tgraph.synthetic_dataset(200, 7, in_dim=4, num_classes=3, seed=3)
    tiles = ts.build_tile_plans(ds.graph, 64)
    n_edges = 0
    for d, plans in tiles.items():
        for t in plans:
            assert t.src_rows == min(64, 200 - t.src_lo)
            for src, dst, d0, rows in t.dev_chunks(50, "cpu", cache=False):
                assert src.shape[0] % ts.K3_CHUNK == 0
                assert bool((dst[1:] >= dst[:-1]).all())
                assert int(dst.max()) == rows - 1 and int(dst.min()) == 0
                real = src != t.src_rows
                assert bool((src[real] < t.src_rows).all())
                n_edges += int(real.sum())
    assert n_edges == ds.graph.num_edges


def test_prefix_walk_matches_jax_and_captures():
    """The SGC prefix (norm, sum, norm twice; and AVG, and the fused relu
    chain) through the blocked walk against JAX's walk, every captured
    stage too; a callable sink sees the same stages."""
    jds, ds = _datasets(200, 7, 9, 3, 3)
    x = np.asarray(ds.features)
    for ops in ([{"kind": "indegree_norm"}, {"kind": "scatter_gather"},
                 {"kind": "indegree_norm"}] * 2,
                [{"kind": "scatter_gather", "aggr": "avg"}],
                [{"kind": "fused_aggregate", "activation": "relu"}] * 2):
        got, jgot, called = [], [], []
        out = ts.stream_prefix_to_host(ds.graph, ops, x, block_rows=64,
                                       capture=got, device="cpu")
        ts.stream_prefix_to_host(ds.graph, ops, x, block_rows=64,
                                 capture=called.append, device="cpu")
        want = jstream.stream_prefix_to_host(jds.graph, ops, x,
                                             block_rows=64, capture=jgot)
        np.testing.assert_allclose(out, want, **SUM_TOL)
        assert len(got) == len(jgot) == len(called) == len(ops)
        for a, b, c in zip(got, jgot, called):
            np.testing.assert_allclose(a, b, **SUM_TOL)
            assert np.array_equal(a, c)


# ------------------------------------------------------------ the head


def test_streamed_head_eval_matches_jax_and_dense():
    """Eval mode (no dropout) across a block boundary: X @ W, and JAX's
    streamed head."""
    rng = np.random.RandomState(0)
    X = rng.randn(300, 24).astype(np.float32)
    W = rng.randn(24, 8).astype(np.float32)
    head = ts.StreamedHead(rate=0.5, block_rows=128, device="cpu")
    got = head.forward(torch.from_numpy(W), X, None, False).numpy()
    np.testing.assert_allclose(got, X @ W, **SUM_TOL)
    jhead = jstream.StreamedHead(rate=0.5, block_rows=128)
    np.testing.assert_allclose(
        got, np.asarray(jhead.forward(jnp.asarray(W), X, None, False)),
        **SUM_TOL)


def test_streamed_head_wgrad_matches_autograd():
    """wgrad equals autograd of the same streamed forward (the same
    per-block masks), and the masks are the ones the seed draws."""
    rng = np.random.RandomState(1)
    X = rng.randn(200, 12).astype(np.float32)
    W = torch.from_numpy(rng.randn(12, 6).astype(np.float32))
    dY = torch.from_numpy(rng.randn(200, 6).astype(np.float32))
    head = ts.StreamedHead(rate=0.4, block_rows=64, device="cpu")
    w = W.clone().requires_grad_(True)
    # the forward with autograd on: its blocks are the staged blocks
    y = head.forward(w, X, 3, True)
    (want,) = torch.autograd.grad((y * dY).sum(), w)
    got = head.wgrad(X, dY, 3, True)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **SUM_TOL)
    # another seed draws other masks
    assert not torch.equal(head.forward(W, X, 4, True), y.detach())


def test_streamed_head_bf16_blocks_accumulate_in_fp32():
    """A bf16 host copy crosses in bf16; wgrad sums the products in fp32:
    within bf16 rounding of the fp32 product of the same bf16 values."""
    rng = np.random.RandomState(2)
    X = torch.from_numpy(rng.randn(300, 16).astype(np.float32)).bfloat16()
    dY = torch.from_numpy(rng.randn(300, 4).astype(np.float32)).bfloat16()
    head = ts.StreamedHead(rate=0.0, block_rows=64, device="cpu")
    got = head.wgrad(X, dY, None, False)
    assert got.dtype == torch.float32
    want = X.float().t() @ dY.float()
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-4)
    y = head.forward(torch.ones(16, 4, dtype=torch.bfloat16), X, None, False)
    assert y.dtype == torch.bfloat16


def _streamable_cases():
    m = Model(in_dim=16)
    t = m.dropout(m.input(), 0.5)
    t = m.linear(t, 8, AC_MODE_RELU)
    m.softmax_cross_entropy(m.scatter_gather(t))
    return {"gcn": (build_gcn([16, 8, 4]), True),
            "gin": (build_gin([16, 8, 4]), False),
            "gcn_deep": (build_gcn([16, 8, 8, 8, 4]), False),
            "relu_head": (m, False)}


@pytest.mark.parametrize("case", ["gcn", "gin", "gcn_deep", "relu_head"])
def test_streamable_head_detection(case):
    """A GCN's head splits off; GIN (aggregates raw features), a deep GCN
    (its residual reads the dropout output twice) and a linear with a
    fused activation do not, as in the JAX package."""
    model, want = _streamable_cases()[case]
    assert (model.streamable_head() is not None) == want


def test_streamable_head_tail_matches_full_apply():
    """head.forward then tail.apply equals model.apply (eval mode), and
    the split and its param name are JAX's."""
    jds, ds = _datasets(120, 5, 16, 4, 0)
    model = build_gcn([16, 8, 4], dropout_rate=0.5)
    rate, pname, tail = model.streamable_head()
    jrate, jpname, jtail = j_build_gcn([16, 8, 4],
                                       dropout_rate=0.5).streamable_head()
    assert (rate, pname) == (jrate, jpname) == (0.5, "linear_0")
    assert [(o.kind, o.inputs) for o in tail._ops] == \
        [(o.kind, o.inputs) for o in jtail._ops]
    gctx = make_graph_context(ds, "segment", device="cpu")
    params = model.init_params(torch.Generator().manual_seed(0))
    with torch.no_grad():
        want = model.apply(params, torch.from_numpy(ds.features), gctx,
                           train=False)
        head = ts.StreamedHead(rate, block_rows=50, device="cpu")
        y = head.forward(params[pname], ds.features, None, False)
        got = tail.apply(params, y, gctx, train=False)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TRAIN_TOL)


def test_sgc_streamable_agg_head_detected():
    m = build_sgc([9, 3], k=2, dropout_rate=0.3)
    assert m.streamable_head() is None
    prefix, rate, param, tail = m.streamable_agg_head()
    jprefix, _, _, jtail = j_build_sgc([9, 3], k=2,
                                       dropout_rate=0.3).streamable_agg_head()
    assert [op.kind for op in prefix] == [op.kind for op in jprefix] == [
        "indegree_norm", "scatter_gather", "indegree_norm"] * 2
    assert rate == 0.3 and param == "linear_0"
    assert all(op.kind == "input" for op in tail._ops)
    assert len(tail._ops) == len(jtail._ops)
    assert build_gcn([9, 8, 3]).streamable_agg_head() is None


# ---------------------------------------------------------- the pool


def test_staging_pool_order_stats_and_errors():
    pool = ts.StagingPool(depth=2)
    got = list(pool.stream([(lambda i=i: i * 10) for i in range(7)]))
    assert got == [0, 10, 20, 30, 40, 50, 60]
    s = pool.take_stats()
    assert s["n"] == 7 and len(s["stage_ms"]) == 7
    assert pool.take_stats()["n"] == 0

    def boom():
        raise RuntimeError("stage died")
    with pytest.raises(RuntimeError, match="stage died"):
        list(ts.StagingPool(depth=1).stream([boom]))


@pytest.mark.parametrize("depth", [1, 2])
def test_staging_pool_abandoned_stream_ends_its_worker(depth):
    """A consumer that stops mid-stream (a closed generator, or an error
    in its loop body) ends the worker before it returns: no stage of the
    old stream runs once the next stream of the same pool starts."""
    import threading
    import time
    pool = ts.StagingPool(depth=depth)
    log = []

    def mk(tag, i):
        def f():
            time.sleep(0.02)
            log.append((tag, i))
            return i
        return f

    it = pool.stream([mk("a", i) for i in range(10)])
    assert next(it) == 0
    it.close()
    mark = len(log)
    with pytest.raises(RuntimeError, match="consumer"):
        for v in pool.stream([mk("b", i) for i in range(10)]):
            if v == 1:
                raise RuntimeError("consumer died")
    mark_b = len(log)
    assert list(pool.stream([mk("c", i) for i in range(4)])) == [0, 1, 2, 3]
    assert all(tag == "b" for tag, _ in log[mark:mark_b])
    assert [t for t in log[mark_b:]] == [("c", i) for i in range(4)]
    assert not any(t.name == "roc-staging" for t in threading.enumerate())


@pytest.mark.parametrize("block_rows", [16, 64, 97, 512])
def test_tile_plans_equal_jax_edge_for_edge(block_rows):
    """Each (dst block, src block) tile holds JAX's edges in JAX's order
    (the lexsorted tiles), the short last block's row count beside it."""
    ds = tgraph.synthetic_dataset(300, 7, in_dim=4, num_classes=3, seed=5)
    jds = jgraph.synthetic_dataset(300, 7, in_dim=4, num_classes=3, seed=5)
    got = ts.build_tile_plans(ds.graph, block_rows)
    want = jstream.build_tile_plans(jds.graph, block_rows)
    assert sorted(got) == sorted(want)
    for d in want:
        assert len(got[d]) == len(want[d])
        for g, w in zip(got[d], want[d]):
            assert g.src_lo == w.src_lo
            assert g.src_rows == min(block_rows, 300 - w.src_lo)
            assert g.src_local.dtype == np.int32 == g.dst_local.dtype
            np.testing.assert_array_equal(g.src_local, w.src_local)
            np.testing.assert_array_equal(g.dst_local, w.dst_local)


def test_staging_pool_caps_live_buffers_at_depth_plus_one():
    """A depth-1 pool never holds more than 2 staged blocks, across
    reuse, and the worker never runs more than ``depth`` ahead."""
    pool = ts.StagingPool(depth=1)
    for _ in range(3):
        staged, taken = [], []

        def mk(i):
            def f():
                staged.append(i)
                return i
            return f
        for v in pool.stream([mk(i) for i in range(16)]):
            taken.append(v)
            assert len(staged) <= len(taken) + pool.depth
    assert pool.max_live <= 2
    p0 = ts.StagingPool(depth=0)
    assert list(p0.stream([lambda: 1, lambda: 2])) == [1, 2]
    assert p0.max_live == 1


def test_staging_pools_under_thread_pressure():
    """16 pools streaming at once (a worker thread each: more threads
    than cores) with a 1 us switch interval: every pool yields its
    blocks in order, counts every stage and wait, and holds the live
    bound."""
    import sys
    import threading
    errors, pools = [], [ts.StagingPool(depth=1 + i % 3) for i in range(16)]

    def run(pool):
        try:
            for _ in range(5):
                got = list(pool.stream([(lambda i=i: i) for i in range(40)]))
                assert got == list(range(40))
                s = pool.take_stats()
                assert s["n"] == 40 and len(s["stage_ms"]) == 40
            assert pool.max_live <= pool.depth + 1
        except BaseException as e:  # noqa: BLE001 - reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=run, args=(p,)) for p in pools]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors


def test_streamed_head_pool_live_bound_many_blocks():
    rng = np.random.RandomState(0)
    X = rng.randn(640, 12).astype(np.float32)
    W = torch.from_numpy(rng.randn(12, 6).astype(np.float32))
    dY = torch.from_numpy(rng.randn(640, 6).astype(np.float32))
    head = ts.StreamedHead(0.3, block_rows=64, prefetch=1, device="cpu")
    for _ in range(3):
        head.forward(W, X, 1, True)
        head.wgrad(X, dY, 1, True)
    assert head.pool.max_live <= 2


@pytest.mark.parametrize("seed", [None, 3])
def test_prefetched_streaming_bitexact_vs_synchronous(seed):
    """prefetch 0, 1 and 2 give the same bits, forward and wgrad: the
    masks come from the block index, never the staging order."""
    rng = np.random.RandomState(2)
    X = rng.randn(330, 12).astype(np.float32)     # a ragged last block
    W = torch.from_numpy(rng.randn(12, 6).astype(np.float32))
    dY = torch.from_numpy(rng.randn(330, 6).astype(np.float32))
    outs = {}
    for depth in (0, 1, 2):
        head = ts.StreamedHead(0.4, block_rows=64, prefetch=depth,
                               device="cpu")
        outs[depth] = (head.forward(W, X, seed, seed is not None),
                       head.wgrad(X, dY, seed, seed is not None))
    for depth in (1, 2):
        assert torch.equal(outs[0][0], outs[depth][0])
        assert torch.equal(outs[0][1], outs[depth][1])


def test_streaming_aggregator_prefetch_bitexact(graphs):
    _, g = graphs
    feats = np.random.RandomState(4).randn(g.num_nodes, 6).astype(np.float32)
    a0 = ts.StreamingAggregator(g, block_rows=50, prefetch=0, device="cpu")
    a1 = ts.StreamingAggregator(g, block_rows=50, prefetch=1, device="cpu")
    assert torch.equal(a0(feats), a1(feats))


def test_aggregate_to_host_prefetch_matches_sync():
    ds = tgraph.synthetic_dataset(200, 7, in_dim=9, num_classes=3, seed=3)
    x = np.random.RandomState(6).randn(200, 9).astype(np.float32)
    got0 = ts.aggregate_to_host(ds.graph, x, block_rows=32, edge_chunk=64,
                                prefetch=0, device="cpu")
    got1 = ts.aggregate_to_host(ds.graph, x, block_rows=32, edge_chunk=64,
                                prefetch=1, device="cpu")
    assert np.array_equal(got0, got1)


def test_streaming_aggregator_index_tables_device_resident(graphs):
    """The index tables go to the device once, at plan build: the same
    tensors across calls."""
    _, g = graphs
    agg = ts.StreamingAggregator(g, block_rows=64, edge_chunk=128,
                                 device="cpu")
    before = [id(c[0]) for p in agg.plans
              for c in p.dev_chunks(agg.edge_chunk, "cpu")]
    feats = np.random.RandomState(5).randn(g.num_nodes, 4).astype(np.float32)
    agg(feats)
    agg(feats)
    after = [id(c[0]) for p in agg.plans
             for c in p.dev_chunks(agg.edge_chunk, "cpu")]
    assert before == after and len(before) > 0


def test_streaming_aggregator_table_budget_falls_back_transient(graphs):
    """Past the residency budget nothing is pinned on the device and the
    result is the same."""
    _, g = graphs
    feats = np.random.RandomState(8).randn(g.num_nodes, 5).astype(np.float32)
    cached = ts.StreamingAggregator(g, block_rows=64, device="cpu")
    assert cached.cache_tables
    tight = ts.StreamingAggregator(g, block_rows=64, table_cache_bytes=16,
                                   device="cpu")
    assert not tight.cache_tables
    got = tight(feats)
    assert all(not p._dev for p in tight.plans)
    assert torch.equal(got, cached(feats))


def test_resolve_prefetch():
    assert resolve_prefetch(TrainConfig()) == 1
    assert resolve_prefetch(TrainConfig(prefetch=0)) == 0
    assert resolve_prefetch(TrainConfig(prefetch="3")) == 3
    for bad in (-1, "fast"):
        with pytest.raises(ValueError):
            resolve_prefetch(TrainConfig(prefetch=bad))


def test_entry_points_take_the_card_unless_asked(monkeypatch):
    """With no card and no device the tier's entry points raise; they
    never fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ds = tgraph.synthetic_dataset(50, 4, in_dim=4, num_classes=2, seed=0)
    x = np.asarray(ds.features)
    for call in (lambda: ts.aggregate_to_host(ds.graph, x),
                 lambda: ts.stream_prefix_to_host(
                     ds.graph, [{"kind": "scatter_gather"}], x),
                 lambda: ts.StreamingAggregator(ds.graph)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


# ------------------------------------------------------ the host tier

KW = dict(learning_rate=0.05, eval_every=1 << 30, verbose=False,
          epochs=3, symmetric=True, chunk=64)


def _port(ds, model, **kw):
    return Trainer(model, ds, TrainConfig(**dict(KW, **kw)), device="cpu")


@pytest.mark.parametrize("impl", ["segment", "cuda"])
def test_host_features_training_matches_hbm_when_no_dropout(impl):
    """Dropout 0: the streamed path has no mask of its own, so 3 steps
    reach the device-resident path's weights (rtol 1e-4)."""
    _, ds = _datasets(150, 5, 12, 3, 1)
    t1 = _port(ds, build_gcn(LAYERS, dropout_rate=0.0), aggr_impl=impl)
    t2 = Trainer(build_gcn(LAYERS, dropout_rate=0.0), ds,
                 TrainConfig(**dict(KW, aggr_impl=impl, features="host")),
                 params=t1.params, device="cpu")
    t1.train()
    t2.train()
    assert t2.feats is None and t2.feats_host is not None
    for k in t1.params:
        np.testing.assert_allclose(t2.params[k].detach().numpy(),
                                   t1.params[k].detach().numpy(), **TRAIN_TOL)


@pytest.mark.parametrize("jimpl,impl", [("segment", "segment"),
                                        ("ell", "cuda")])
def test_host_tier_matches_jax_host_tier(jimpl, impl):
    """3 steps of the GCN on both packages' host tiers from the JAX
    trainer's weights, dropout 0: weights within rtol 1e-4."""
    jds, ds = _datasets(150, 5, 12, 3, 1)
    jtr = JTrainer(j_build_gcn(LAYERS, dropout_rate=0.0), jds,
                   JTrainConfig(aggr_impl=jimpl, features="host", **KW))
    p0 = {k: np.asarray(v) for k, v in jtr.params.items()}
    jtr.train()
    tr = Trainer(build_gcn(LAYERS, dropout_rate=0.0), ds,
                 TrainConfig(aggr_impl=impl, features="host", **KW),
                 params=convert.params_from_jax(p0), device="cpu")
    tr.train()
    got = convert.params_to_jax(tr.params)
    for k, v in jtr.params.items():
        np.testing.assert_allclose(got[k], np.asarray(v), **TRAIN_TOL)


def test_host_features_converges_with_dropout():
    _, ds = _datasets(200, 6, 16, 4, 2)
    tr = _port(ds, build_gcn([16, 16, 4], dropout_rate=0.3),
               features="host", epochs=60)
    tr.train()
    assert tr.evaluate()["train_acc"] > 0.6


def test_host_tier_predict_equals_hbm():
    """Eval through the streamed head equals the device-resident model's
    logits from the same weights."""
    _, ds = _datasets(150, 5, 12, 3, 1)
    a = _port(ds, build_gcn(LAYERS))
    b = Trainer(build_gcn(LAYERS), ds,
                TrainConfig(**dict(KW, features="host")), params=a.params,
                device="cpu")
    np.testing.assert_allclose(b.predict().numpy(), a.predict().numpy(),
                               **SUM_TOL)
    assert b.predict([3, 0]).shape == (2, 3)


def test_streamed_tier_epoch_records_carry_pipeline_fields():
    _, ds = _datasets(200, 5, 12, 3, 4)
    recs = {}
    for depth in (0, 1):
        tr = _port(ds, build_gcn(LAYERS, dropout_rate=0.2), features="host",
                   prefetch=depth, epochs=2, eval_every=2)
        recs[depth] = tr.train()
    for depth, hist in recs.items():
        m = hist[-1]
        assert m["prefetch_depth"] == depth
        assert "h2d_wait_p50_ms" in m and "overlap_frac" in m
        assert set(m["spans_p50_ms"]) == {"head_forward", "tail_grad",
                                          "head_wgrad", "update"}
    assert recs[0][-1]["overlap_frac"] == 0.0


def test_host_tier_prefetch_training_bitexact():
    """Training with prefetch 1 ends on prefetch 0's bits (dropout 0.5:
    the per-block masks are position-derived)."""
    _, ds = _datasets(200, 5, 12, 3, 4)
    runs = []
    for depth in (0, 1):
        tr = Trainer(build_gcn(LAYERS, dropout_rate=0.5), ds,
                     TrainConfig(**dict(KW, features="host", prefetch=depth,
                                        epochs=3)), device="cpu")
        tr.train()
        runs.append(tr.params)
    for k in runs[0]:
        assert torch.equal(runs[0][k], runs[1][k])


def test_sgc_host_tier_matches_in_hbm_and_jax():
    """The SGC's host tier (the prefix through the blocked walk, then the
    streamed head) against the device-resident SGC at init (rtol 1e-4),
    after 30 epochs (accuracy within 0.05), and against JAX's host tier
    after 3 steps from its weights (rtol 1e-4)."""
    jds, ds = _datasets(300, 6, 12, 4, 1)
    kw = dict(verbose=False, eval_every=1 << 30, learning_rate=0.2,
              symmetric=True)
    th = Trainer(build_sgc([12, 4], k=2), ds,
                 TrainConfig(features="host", **kw), device="cpu")
    td = Trainer(build_sgc([12, 4], k=2), ds, TrainConfig(**kw),
                 params=th.params, device="cpu")
    assert th.feats is None and th.gctx.edge_src is None
    np.testing.assert_allclose(th.evaluate()["train_loss"],
                               td.evaluate()["train_loss"], rtol=1e-4)
    th.train(epochs=30)
    td.train(epochs=30)
    assert abs(th.evaluate()["train_acc"] - td.evaluate()["train_acc"]) \
        <= 0.05
    assert th.evaluate()["train_acc"] > 0.9
    jtr = JTrainer(j_build_sgc([12, 4], k=2), jds,
                   JTrainConfig(features="host", epochs=3, **kw))
    p0 = {k: np.asarray(v) for k, v in jtr.params.items()}
    jtr.train()
    tr = Trainer(build_sgc([12, 4], k=2), ds,
                 TrainConfig(features="host", epochs=3, **kw),
                 params=convert.params_from_jax(p0), device="cpu")
    tr.train()
    got = convert.params_to_jax(tr.params)
    for k, v in jtr.params.items():
        np.testing.assert_allclose(got[k], np.asarray(v), **TRAIN_TOL)


def test_host_tier_refuses_an_unstreamable_model():
    _, ds = _datasets(100, 4, 12, 3, 0)
    with pytest.raises(NotImplementedError, match="streamable"):
        _port(ds, build_gin(LAYERS), features="host")


# ------------------------------------------------------------- serving


def test_quantizing_capture_matches_quantize_rows():
    """The capture sink's codes equal quantize_rows of the captured fp32
    stages (and JAX's), and keep_fp32_last keeps the last stage."""
    ds = tgraph.synthetic_dataset(200, 7, in_dim=9, num_classes=3, seed=3)
    ops = [{"kind": "fused_aggregate", "activation": "none"}] * 2
    plain = []
    ts.stream_prefix_to_host(ds.graph, ops, ds.features, block_rows=64,
                             capture=plain, device="cpu")
    for mode in ("int8", "fp8"):
        cap = quant.QuantizingCapture(mode, keep_fp32_last=True)
        ts.stream_prefix_to_host(ds.graph, ops, ds.features, block_rows=64,
                                 capture=cap, device="cpu")
        assert len(cap.stages) == len(plain)
        for (q, s), x in zip(cap.stages, plain):
            wq, ws = quant.quantize_rows(x, mode)
            assert np.array_equal(q, wq) and np.array_equal(s, ws)
        assert np.array_equal(cap.last_fp32, plain[-1])
        assert len(cap.dequantized()) == len(plain)
    with pytest.raises(ValueError, match="quantized mode"):
        quant.QuantizingCapture("off")
    jq, js = jquant.quantize_rows(plain[-1], "int8")
    q, s = quant.quantize_rows(plain[-1], "int8")
    assert np.array_equal(q, jq) and np.array_equal(s, js)


def test_quantize_rows_under_a_pinned_scale():
    x = np.random.RandomState(0).randn(20, 6).astype(np.float32)
    _, s = quant.quantize_rows(x, "int8")
    q, s2 = quant.quantize_rows(x * 0.5, "int8", scale=s)
    jq, _ = jquant.quantize_rows(x * 0.5, "int8", scale=s)
    assert s2 is s and np.array_equal(q, jq)


def test_table_only_cache_and_loaded_quant(tmp_path):
    """table_only keeps the serving table alone (and refuses to
    invalidate); a quantized file loads with its mode in loaded_quant."""
    ds = tgraph.synthetic_dataset(200, 7, in_dim=9, num_classes=3, seed=3)
    ops = [{"kind": "fused_aggregate", "activation": "none"}] * 2
    full = PropagationCache.build(ds.graph, ops, ds.features, device="cpu")
    only = PropagationCache.build(ds.graph, ops, ds.features,
                                  table_only=True, device="cpu")
    assert len(only.stages) == 1
    assert np.array_equal(only.table, full.table)
    with pytest.raises(NotImplementedError, match="table_only"):
        only.add_edges([0], [1])
    assert full.loaded_quant is None
    full.save(str(tmp_path / "q.npz"), quant="int8")
    assert PropagationCache.load(str(tmp_path / "q.npz")).loaded_quant \
        == "int8"


# ---------------------------------------------- checkpoint and drills


def _host_trainer(ds, dropout=0.5, **kw):
    return Trainer(build_gcn(LAYERS, dropout_rate=dropout), ds,
                   TrainConfig(**dict(dict(KW, features="host", eval_every=2,
                                           epochs=8), **kw)), device="cpu")


@pytest.mark.parametrize("mode", ["float32", "mixed"])
def test_host_fingerprint_is_the_jax_string(mode):
    """A host-tier trainer's fingerprint (features='host' in its elastic
    half) equals the JAX package's for the same config."""
    from roc_tpu.train.trainer import resolve_dtypes as j_resolve_dtypes
    from roc_tpu_torch.train.trainer import resolve_dtypes
    jds, ds = _datasets(150, 5, 12, 3, 1)
    jd, jc = j_resolve_dtypes(mode)
    d, c = resolve_dtypes(mode)
    jtr = JTrainer(j_build_gcn(LAYERS), jds, JTrainConfig(
        aggr_impl="segment", features="host", dtype=jd, compute_dtype=jc,
        **KW))
    tr = Trainer(build_gcn(LAYERS), ds, TrainConfig(
        aggr_impl="segment", features="host", dtype=d, compute_dtype=c,
        **KW), device="cpu")
    assert ck.trainer_fingerprint(tr) == jck.trainer_fingerprint(jtr)
    assert ck.trainer_fingerprint(tr)["elastic"]["features"] == "host"


def test_host_tier_checkpoint_resumes_bitequal(tmp_path):
    """4 epochs, a checkpoint, 4 more, against a fresh trainer restored
    from the checkpoint and run the same 4: the same bits (the per-block
    masks come from the epoch, the tail's from the saved generator)."""
    _, ds = _datasets(150, 5, 12, 3, 1)
    a = _host_trainer(ds)
    a.train(4)
    path = str(tmp_path / "ck")
    ck.checkpoint_trainer(a, path)
    a.train(4)
    b = _host_trainer(ds)
    ck.restore_trainer(b, path)
    assert b.epoch == 4
    b.train(4)
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k])
    assert torch.equal(a.predict(), b.predict())


@contextlib.contextmanager
def _events():
    """The port bus's records emitted inside the block, through a sink
    for the block (the bus's flight ring is bounded: once it is full its
    length stops growing, and a slice past it would miss them)."""
    bus = get_bus()
    out = []

    class _Sink:
        def write(self, record):
            out.append(record)

        def close(self):
            pass

    sink = _Sink()
    bus.add_sink(sink)
    try:
        yield out
    finally:
        bus.sinks.remove(sink)


def _drill(tr, root, epochs=8):
    with _events() as recs:
        hist = train_with_recovery(tr, epochs,
                                   CheckpointRotation(root, keep=3),
                                   checkpoint_every=2)
    return (hist, [r["site"] for r in recs if r.get("kind") == "fault"],
            [r["error"] for r in recs if r.get("kind") == "recovery"], recs)


def test_staging_io_drill_restores_and_retries(tmp_path):
    """staging_io:5 under train_with_recovery: one OSError from the
    staging site, one restore-and-retry, and at dropout 0 (the JAX drill's
    setting: a retry reseeds the masks) the run ends on the uninterrupted
    run's bits; at dropout 0.5 it ends finite."""
    _, ds = _datasets(150, 5, 12, 3, 1)
    clean = _host_trainer(ds, dropout=0.0)
    _drill(clean, str(tmp_path / "a"))
    assert inject.parse("staging_io:5").site == "staging_io"
    tr = _host_trainer(ds, dropout=0.0, fault="staging_io:5")
    _, fired, retried, _ = _drill(tr, str(tmp_path / "b"))
    assert fired == ["staging_io"] and retried == ["OSError"]
    for k in clean.params:
        assert torch.equal(clean.params[k], tr.params[k])
    inject.disarm()
    tr = _host_trainer(ds, fault="staging_io:5")
    hist, fired, retried, _ = _drill(tr, str(tmp_path / "c"))
    assert fired == ["staging_io"] and retried == ["OSError"]
    assert tr.epoch == 8 and np.isfinite(hist[-1]["train_loss"])


def test_stall_compile_drill_becomes_a_restart(tmp_path, monkeypatch):
    """stall_compile:0 with ROC_TPU_STALL_TIMEOUT_S: the first step's
    barrier stalls inside the first_compile heartbeat and the watchdog
    turns it into a StallFailure, which train_with_recovery cannot retry
    before its first checkpoint: it propagates (the CLI exits 75,
    restartable), and the restart, a fresh trainer on the same rotation,
    finishes."""
    monkeypatch.setenv("ROC_TPU_STALL_TIMEOUT_S", "1")
    _, ds = _datasets(150, 5, 12, 3, 1)
    root = str(tmp_path / "ck")
    tr = _host_trainer(ds, fault="stall_compile:0", epochs=4)
    with _events() as recs, \
            pytest.raises(StallFailure, match="first_compile"):
        _drill(tr, root, epochs=4)
    assert [r["site"] for r in recs if r.get("kind") == "fault"] == \
        ["stall_compile"]
    assert any(r.get("stage") == "first_compile" for r in recs)
    inject.disarm()
    again = _host_trainer(ds, epochs=4)
    hist, fired, retried, _ = _drill(again, root, epochs=4)
    assert fired == [] and retried == []
    assert again.epoch == 4 and np.isfinite(hist[-1]["train_loss"])


def test_stall_compile_alone_raises_stall_failure(monkeypatch):
    monkeypatch.setenv("ROC_TPU_STALL_TIMEOUT_S", "1")
    _, ds = _datasets(100, 4, 12, 3, 1)
    tr = _port(ds, build_gcn(LAYERS), fault="stall_compile:0")
    with pytest.raises(StallFailure, match="first_compile"):
        tr.train(1)
