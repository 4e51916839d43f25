"""The chunked edge-list routes 'blocked' and 'scan', the mean over them,
the checkpointed ELL max and the attention row of the 'auto' rule,
against the JAX package on the CPU at small sizes.

Inputs come from numpy seeds; JAX weights cross with
roc_tpu_torch/convert.py.  Each tolerance is stated where it is used.
"""

import contextlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from roc_tpu.core import graph as jgraph
from roc_tpu.core.partition import padded_edge_list as j_padded_edge_list
from roc_tpu.models.gcn import build_gcn as j_build_gcn
from roc_tpu.models.sage import build_sage as j_build_sage
from roc_tpu.ops import aggregate as jagg
from roc_tpu.ops import dense as jdense
from roc_tpu.serve import export as jexport
from roc_tpu.train.trainer import TrainConfig as JTrainConfig
from roc_tpu.train.trainer import Trainer as JTrainer
from roc_tpu.train.trainer import make_graph_context as j_make_graph_context
from roc_tpu.train.trainer import resolve_attention_impl as j_resolve
from roc_tpu_torch import convert
from roc_tpu_torch.core import ell as tell
from roc_tpu_torch.core import graph as tgraph
from roc_tpu_torch.core.partition import padded_edge_list
from roc_tpu_torch.models.builder import AGGR_MAX
from roc_tpu_torch.models.gat import build_gat
from roc_tpu_torch.models.gcn import build_gcn
from roc_tpu_torch.models.sage import build_sage
from roc_tpu_torch.obs.events import get_bus
from roc_tpu_torch.ops import aggregate as tagg
from roc_tpu_torch.ops import dense as tdense
from roc_tpu_torch.serve.export import load_predictor
from roc_tpu_torch.train.trainer import (ATTN_FLAT8_MIN_EDGES, TrainConfig,
                                         Trainer, make_graph_context,
                                         resolve_attention_impl)

LAYERS = [24, 16, 5]
CHUNK = 64
F = 12
# fp32 sums in another order than the JAX route's (its one-hot matmul,
# its XLA cumsum): rtol 1e-5, atol 1e-6
FP32 = dict(rtol=1e-5, atol=1e-6)


def _datasets(V=200, deg=6, seed=0):
    """The same dataset in both packages (bit-equal,
    tests/test_torch_data.py)."""
    return (jgraph.synthetic_dataset(V, deg, in_dim=LAYERS[0],
                                     num_classes=LAYERS[-1], seed=seed),
            tgraph.synthetic_dataset(V, deg, in_dim=LAYERS[0],
                                     num_classes=LAYERS[-1], seed=seed))


@pytest.fixture(scope="module")
def case():
    """A 300-vertex graph's padded edge list (both packages' bit-equal),
    features with the trailing zero row and a cotangent, from seeds."""
    jds, tds = _datasets(300, 9, seed=3)
    src, dst = j_padded_edge_list(jds.graph, multiple=CHUNK)
    tsrc, tdst = padded_edge_list(tds.graph, multiple=CHUNK)
    np.testing.assert_array_equal(src, tsrc)
    np.testing.assert_array_equal(dst, tdst)
    V = tds.graph.num_nodes
    rng = np.random.RandomState(4)
    x = np.zeros((V + 1, F), np.float32)
    x[:V] = rng.randn(V, F)
    g = rng.randn(V, F).astype(np.float32)
    return V, src, dst, x, g, tds.graph.in_degree


def _port(fn, x, src, dst, V, g, **kw):
    xt = torch.from_numpy(x).requires_grad_(True)
    out = fn(xt, torch.from_numpy(src), torch.from_numpy(dst), V, **kw)
    (dx,) = torch.autograd.grad(out, xt, torch.from_numpy(g))
    return out.detach().numpy(), dx.numpy()


def _jax(fn, x, g):
    out, vjp = jax.vjp(fn, jnp.asarray(x))
    return np.asarray(out), np.asarray(vjp(jnp.asarray(g))[0])


@pytest.mark.parametrize("budget", [tagg.LAYOUT_BUDGET_ELEMS, 3 * CHUNK * F])
@pytest.mark.parametrize("impl", ["blocked", "scan"])
def test_routes_match_jax_forward_and_gradient(case, impl, budget):
    """The port's route against the JAX function of its name, forward
    and ``jax.vjp``'s gradient, in one run of chunks and in runs of 3."""
    V, src, dst, x, g, _ = case
    jfn = getattr(jagg, f"aggregate_{impl}")
    want, wgrad = _jax(lambda f: jfn(f, jnp.asarray(src), jnp.asarray(dst),
                                     V, chunk=CHUNK), x, g)
    got, grad = _port(getattr(tagg, f"aggregate_{impl}"), x, src, dst, V, g,
                      chunk=CHUNK, budget_elems=budget)
    np.testing.assert_allclose(got, want, **FP32)
    np.testing.assert_allclose(grad, wgrad, **FP32)


@pytest.mark.parametrize("impl", ["segment", "blocked", "scan"])
def test_mean_matches_jax(case, impl):
    """``aggregate_mean``: the sum over ``max(deg, 1)``, forward and
    gradient, as the JAX function on the same route."""
    V, src, dst, x, g, deg = case
    want, wgrad = _jax(lambda f: jagg.aggregate_mean(
        f, jnp.asarray(src), jnp.asarray(dst), V, jnp.asarray(deg),
        impl=impl, chunk=CHUNK), x, g)
    got, grad = _port(lambda *a, **k: tagg.aggregate_mean(
        *a, torch.from_numpy(deg), **k), x, src, dst, V, g, impl=impl,
        chunk=CHUNK)
    np.testing.assert_allclose(got, want, **FP32)
    np.testing.assert_allclose(grad, wgrad, **FP32)


def _bf16_ulp(t):
    """One bf16 ulp of each element's magnitude (at least the smallest
    normal's)."""
    e = torch.floor(torch.log2(t.abs().clamp_min(2.0 ** -126)))
    return torch.pow(2.0, e - 7)


@pytest.mark.parametrize("impl", ["blocked", "scan"])
def test_bf16_within_one_ulp_of_fp32(case, impl):
    """bf16 input, summed in fp32 and rounded once: within one bf16 ulp of
    the port's fp32 sum of the same (bf16-rounded) values, the oracle
    limit (JAX's chunked sums round as they accumulate)."""
    V, src, dst, x, _, _ = case
    fn = getattr(tagg, f"aggregate_{impl}")
    xb = torch.from_numpy(x).bfloat16()
    args = (torch.from_numpy(src), torch.from_numpy(dst), V)
    got = fn(xb, *args, chunk=CHUNK)
    want = fn(xb.float(), *args, chunk=CHUNK)
    assert got.dtype == torch.bfloat16
    assert bool(((got.float() - want).abs() <= _bf16_ulp(want)).all())


def test_refuse_what_jax_refuses(case):
    """An edge count that is not a chunk multiple is refused by both
    packages' routes; the dispatcher takes both names."""
    V, src, dst, x, _, _ = case
    for impl in ("blocked", "scan"):
        with pytest.raises(AssertionError, match="chunk multiple"):
            getattr(jagg, f"aggregate_{impl}")(
                jnp.asarray(x), jnp.asarray(src[:-1]), jnp.asarray(dst[:-1]),
                V, chunk=CHUNK)
        with pytest.raises(ValueError, match="chunk multiple"):
            tagg.aggregate(torch.from_numpy(x), torch.from_numpy(src[:-1]),
                           torch.from_numpy(dst[:-1]), V, impl=impl,
                           chunk=CHUNK)


def test_max_refused_with_jax_message():
    """MAX on a chunked edge route raises NotImplementedError with the JAX
    package's message."""
    jds, tds = _datasets()
    x = np.random.RandomState(2).randn(tds.graph.num_nodes, 8).astype(
        np.float32)
    for impl in ("blocked", "scan"):
        with pytest.raises(NotImplementedError) as want:
            j_make_graph_context(jds, impl, chunk=CHUNK,
                                 symmetric=True)._max_fwd(jnp.asarray(x))
        gctx = make_graph_context(tds, impl, symmetric=True, device="cpu",
                                  chunk=CHUNK)
        with pytest.raises(NotImplementedError) as got:
            gctx.aggregate(torch.from_numpy(x), AGGR_MAX)
        assert str(got.value) == str(want.value)


# ------------------------------------------------------------- training


def _jax_run(jds, impl, epochs):
    jtr = JTrainer(j_build_gcn(LAYERS, dropout_rate=0.0), jds,
                   JTrainConfig(aggr_impl=impl, epochs=epochs, eval_every=1,
                                verbose=False, symmetric=True, chunk=CHUNK))
    p0 = {k: np.asarray(v) for k, v in jtr.params.items()}
    hist = jtr.train()
    return p0, hist, {k: np.asarray(v) for k, v in jtr.params.items()}


@pytest.mark.parametrize("impl", ["blocked", "scan"])
def test_three_step_gcn_matches_jax_trainer(impl):
    """Three epochs of the GCN (dropout 0, an eval each) on the route
    against the JAX trainer on the same route from its weights: the
    train loss within rtol 1e-4 (fp32 sums in another order, through
    Adam), the counts equal, the weights within rtol 2e-4, atol 1e-5."""
    jds, tds = _datasets()
    p0, jhist, jparams = _jax_run(jds, impl, 3)
    tr = Trainer(build_gcn(LAYERS, dropout_rate=0.0), tds,
                 TrainConfig(aggr_impl=impl, epochs=3, eval_every=1,
                             verbose=False, symmetric=True, chunk=CHUNK),
                 params=convert.params_from_jax(p0), device="cpu")
    assert tr.gctx.aggr_impl == impl and tr.gctx.edge_src is not None
    hist = tr.train()
    np.testing.assert_allclose([m["train_loss"] for m in hist],
                               [m["train_loss"] for m in jhist], rtol=1e-4)
    for k in ("train_cnt", "val_cnt", "test_cnt"):
        assert [m[k] for m in hist] == [m[k] for m in jhist]
    got = convert.params_to_jax(tr.params)
    for k in jparams:
        np.testing.assert_allclose(got[k], jparams[k], rtol=2e-4, atol=1e-5)


def test_jax_routes_map_and_resolve():
    """convert maps both JAX names to the port's; a MAX model on either
    route moves to 'ell', as in the JAX package, with one event."""
    for impl in ("blocked", "scan"):
        assert convert.aggr_impl_from_jax(impl) == impl
        assert convert.aggr_impl_to_jax(impl) == impl
        j = j_resolve(j_build_sage(LAYERS, aggregator="pool"),
                      JTrainConfig(aggr_impl=impl))
        with _events() as recs:
            t = resolve_attention_impl(build_sage(LAYERS, aggregator="pool"),
                                       TrainConfig(aggr_impl=impl))
        assert t.aggr_impl == convert.aggr_impl_from_jax(j.aggr_impl) \
            == "ell"
        assert [r["resolved"] for r in recs if r["cat"] == "resolve"] == \
            ["ell"]


@pytest.fixture
def world_of_one(tmp_path):
    """This process as a world of one gloo rank."""
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_gather_halo_trains_blocked_and_refuses_stubs(world_of_one):
    """DistributedTrainer on 'blocked' and 'scan' (one rank, the gather
    halo) takes Trainer's objectives within rtol 1e-6 (the part pads the
    edge list, so the sums may take another order), and injected data
    whose edge arrays are stubs is refused, as the JAX trainer refuses
    them."""
    from roc_tpu_torch.core.partition import partition_plan
    from roc_tpu_torch.parallel.distributed import (DistributedTrainer,
                                                    shard_dataset)
    _, tds = _datasets()
    for impl in ("blocked", "scan"):
        cfg = TrainConfig(aggr_impl=impl, epochs=2, eval_every=2,
                          verbose=False, symmetric=True, chunk=CHUNK,
                          dropout_rate=0.0)
        a = Trainer(build_gcn(LAYERS, dropout_rate=0.0), tds, cfg,
                    device="cpu")
        b = DistributedTrainer(build_gcn(LAYERS, dropout_rate=0.0), tds, 1,
                               cfg, params=a.params, device="cpu")
        assert b.gctx.aggr_impl == impl
        a.train(), b.train()
        np.testing.assert_allclose(torch.stack(b.losses).numpy(),
                                   torch.stack(a.losses).numpy(), rtol=1e-6)
    plan = partition_plan(tds.graph.row_ptr, 1, edge_multiple=CHUNK)
    data = shard_dataset(tds, plan, 0, "cpu", aggr_impl="blocked")
    data.edge_src, data.edge_dst = data.edge_src[:1], data.edge_dst[:1]
    with pytest.raises(ValueError, match="edge stubs"):
        DistributedTrainer(build_gcn(LAYERS), tds, 1, cfg, device="cpu",
                           data=data, plan=plan)


# -------------------------------------------------------------- serving


@pytest.mark.parametrize("impl", ["blocked", "scan"])
def test_jax_full_artifact_serves_on_the_route(tmp_path, impl):
    """A JAX full-backend artifact resolved to the route loads in the
    port on the same route and answers within 1e-5 of the logit scale
    of JAX's own ``load_predictor`` (fp32 sums in another order)."""
    jds, tds = _datasets()
    jm = j_build_gcn(LAYERS, dropout_rate=0.5)
    jpred = jexport.build_predictor(
        jm, jds, JTrainConfig(aggr_impl=impl, verbose=False, symmetric=True,
                              chunk=CHUNK),
        params=jm.init_params(jax.random.PRNGKey(5)), backend="full")
    art = str(tmp_path / "art")
    jexport.export_predictor(jpred, art, cache_dir=str(tmp_path / "cc"),
                             verify_warm=False)
    ids = np.arange(tds.graph.num_nodes)
    want = jexport.load_predictor(art, dataset=jds).query(ids)
    pred = load_predictor(art, dataset=tds, device="cpu")
    assert pred.config.aggr_impl == impl and pred.config.chunk == CHUNK
    got = pred.query(ids)
    assert np.abs(got - want).max() <= 1e-5 * max(1.0, np.abs(want).max())


# ------------------------------------------------------------ the head


def test_linear_chunked_matches_jax_and_linear():
    """Row blocks of ``x @ w``: values and the input gradient equal the
    port's ``linear`` (each row the same dot product), the weight
    gradient within rtol 1e-5 (block sums in another order); against
    JAX's ``linear_chunked`` rtol 1e-5, atol 1e-6."""
    rng = np.random.RandomState(6)
    x = rng.randn(300, 20).astype(np.float32)
    w = rng.randn(20, 7).astype(np.float32)
    g = rng.randn(300, 7).astype(np.float32)
    for act in ("none", "relu"):
        want, vjp = jax.vjp(lambda a, b: jdense.linear_chunked(
            a, b, act, block=64), jnp.asarray(x), jnp.asarray(w))
        jdx, jdw = vjp(jnp.asarray(g))
        res = []
        for fn in (lambda a, b: tdense.linear_chunked(a, b, act, block=64),
                   lambda a, b: tdense.linear(a, b, act)):
            xt = torch.from_numpy(x).requires_grad_(True)
            wt = torch.from_numpy(w).requires_grad_(True)
            out = fn(xt, wt)
            res.append((out, *torch.autograd.grad(out, (xt, wt),
                                                  torch.from_numpy(g))))
        (out, dx, dw), (lout, ldx, ldw) = res
        assert torch.equal(out, lout) and torch.equal(dx, ldx)
        torch.testing.assert_close(dw, ldw, rtol=1e-5, atol=1e-6)
        for a, b in ((out, want), (dx, jdx), (dw, jdw)):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                       **FP32)


# ---------------------------------------------------------- the ELL max


def test_checkpointed_ell_max_gradients_bit_equal():
    """The ELL max recomputes its segments in the backward: values and
    gradients bit-equal to the form that keeps them, with ties (integer
    features) shared as before, over many small segments."""
    _, tds = _datasets(150, 7, seed=8)
    g = tds.graph
    table = tell.ell_from_graph(g.row_ptr, g.col_idx, g.num_nodes)
    idx = [torch.from_numpy(a[0]) for a in table.idx]
    pos = torch.from_numpy(table.row_pos[0])
    rng = np.random.RandomState(9)
    x = np.zeros((g.num_nodes + 1, 6), np.float32)
    x[:-1] = rng.randint(-2, 3, (g.num_nodes, 6))
    cot = torch.from_numpy(rng.randn(g.num_nodes, 6).astype(np.float32))

    def run(ckpt):
        xt = torch.from_numpy(x).requires_grad_(True)
        with (contextlib.nullcontext() if ckpt else _no_checkpoint()):
            out = tagg.aggregate_ell_max(xt, idx, pos, g.num_nodes,
                                         budget_elems=4 * 6 * 8)
        out = torch.where(torch.isfinite(out), out, 0.0)
        return out, torch.autograd.grad(out, xt, cot)[0]

    (a, ga), (b, gb) = run(True), run(False)
    assert torch.equal(a, b) and torch.equal(ga, gb)
    assert bool((ga != ga.round()).any())         # ties split the gradient


@contextlib.contextmanager
def _no_checkpoint():
    real = tagg.checkpoint
    tagg.checkpoint = lambda fn, *a, **k: fn(*a)
    try:
        yield
    finally:
        tagg.checkpoint = real


# ------------------------------------------------ the attention card row


@contextlib.contextmanager
def _events():
    """The port bus's records emitted inside the block."""
    class Sink(list):
        write = list.append

    bus, sink = get_bus(), Sink()
    bus.add_sink(sink)
    try:
        yield sink
    finally:
        bus.sinks.remove(sink)


class _Sized:
    """A stand-in dataset with only an edge count (all the resolver
    reads)."""

    def __init__(self, num_edges):
        self.graph = type("G", (), {"num_edges": num_edges})()


H100 = "NVIDIA H100 80GB HBM3"


@pytest.mark.parametrize("E", [ATTN_FLAT8_MIN_EDGES - 1, ATTN_FLAT8_MIN_EDGES])
@pytest.mark.parametrize("kind", [None, H100])
def test_attention_card_row_resolve_event(E, kind):
    """'auto' for a GAT: the JAX rule's answer ('ell', or 'attn_flat8'
    from ATTN_FLAT8_MIN_EDGES edges) in ``jax_resolves``; the port takes
    the row's attention entry on a card with one, else the JAX answer's
    counterpart ('ell' as 'cuda'); a row that changes the answer names
    its race in the message."""
    jax_to = j_resolve(j_build_gat_like(), JTrainConfig(aggr_impl="auto"),
                       _Sized(E)).aggr_impl
    with _events() as recs:
        got = resolve_attention_impl(build_gat(LAYERS, heads=1),
                                     TrainConfig(aggr_impl="auto"),
                                     _Sized(E), device_kind=kind)
    ev = [r for r in recs if r["cat"] == "resolve"]
    assert len(ev) == 1 and ev[0]["jax_resolves"] == jax_to
    assert ev[0]["device_kind"] == kind
    assert got.aggr_impl == ev[0]["resolved"] == \
        tell.port_attention_route(jax_to, kind)
    row = tell.CARD_ROWS.get(kind)
    if kind is None:
        assert got.aggr_impl == {"ell": "cuda"}.get(jax_to, jax_to)
    else:
        assert "attn_flat8" in row.attention and row.attention_source
    if got.aggr_impl != {"ell": "cuda"}.get(jax_to, jax_to):
        assert row.attention_source in ev[0]["msg"]


def j_build_gat_like():
    from roc_tpu.models.gat import build_gat as j_build_gat
    return j_build_gat(LAYERS, heads=1)
