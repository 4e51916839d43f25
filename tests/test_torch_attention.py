"""The port's neighbour MAX/MIN and GAT attention (roc_tpu_torch/ops/
aggregate.py, ops/attention.py, models/builder.py GraphContext) against
the JAX package's forward and ``jax.vjp``, on the CPU, and GAT trained at
P = 2 against the JAX package's DistributedTrainer.

The cases hold what the two frameworks do differently by default: a
ReLU-zeroed input, so ties at the maximum (JAX splits the gradient among
them, as ``amax`` and ``scatter_reduce('amax')`` on a ``-inf`` output do;
``max(dim)`` would not), rows with no neighbour, an attention score
exactly at 0 (``jax.nn.leaky_relu`` takes slope 1 there), and the
row-segmented paths at a tiny ``budget_elems``.  Every tolerance is
stated with its reason.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from roc_tpu.core import ell as jell
from roc_tpu.core import graph as jgraph
from roc_tpu.models.gat import build_gat as j_build_gat
from roc_tpu.ops.aggregate import aggregate_ell_max as j_ell_max
from roc_tpu.ops.attention import gat_aggregate_ell as j_gat_ell
from roc_tpu.parallel.distributed import DistributedTrainer as JDist
from roc_tpu.train.trainer import TrainConfig as JTrainConfig
from roc_tpu.train.trainer import make_graph_context as j_make_gctx
from roc_tpu_torch import convert
from roc_tpu_torch.core import ell as tell
from roc_tpu_torch.core import graph as tgraph
from roc_tpu_torch.models.gat import build_gat
from roc_tpu_torch.ops.aggregate import aggregate_ell_max
from roc_tpu_torch.ops.attention import gat_aggregate_ell
from roc_tpu_torch.parallel.distributed import run_ranks, train_job
from roc_tpu_torch.train.trainer import TrainConfig, Trainer, \
    make_graph_context

V = 40
EMPTY = 7          # a row with no neighbour (no self edge either)
# MAX selects one of its inputs: the forward is exact.  Its gradient is
# the cotangent over the tie count, summed into each source over the
# rows that pick it, in another order than XLA's: rtol 1e-6, atol 1e-7.
GRAD_TOL = dict(rtol=1e-6, atol=1e-7)
# Attention: exp, a softmax and a weighted sum in fp32 in another
# reduction order: rtol 1e-5, atol 1e-6 of the values' magnitude.
ATT_RTOL = 1e-5


def _graphs():
    """The same small graph in both packages: random directed edges plus
    self edges, then the row EMPTY cut out (degree 0), and one row of
    degree 20 (a width-32 bucket beside the width-8 and 16 ones)."""
    rng = np.random.RandomState(4)
    src = np.concatenate([rng.randint(0, V, 160), rng.randint(0, V, 20),
                          np.arange(V)])
    dst = np.concatenate([rng.randint(0, V, 160), np.full(20, 3),
                          np.arange(V)])
    keep = dst != EMPTY
    gs = [mod.from_edge_list(src[keep], dst[keep], V)
          for mod in (jgraph, tgraph)]
    assert gs[1].in_degree[EMPTY] == 0
    return gs


def _datasets(F=8, C=3):
    rng = np.random.RandomState(5)
    feats = rng.randn(V, F).astype(np.float32)
    labels = rng.randint(0, C, V).astype(np.int32)
    mask = rng.randint(0, 4, V).astype(np.int32)
    jg, tg = _graphs()
    return (jgraph.Dataset(jg, feats, labels, mask, C),
            tgraph.Dataset(tg, feats, labels, mask, C))


def _tied_input(F, seed):
    """relu(randn) with whole columns of repeats: ties at 0 everywhere
    and ties at positive maxima too."""
    rng = np.random.RandomState(seed)
    x = np.maximum(rng.randn(V, F), 0).astype(np.float32)
    x[::3, 0] = 1.5
    x[1::4, 1] = x[0, 1]
    return x


def _ell(g):
    t = jell.ell_from_graph(g.row_ptr, g.col_idx, V)
    tt = tell.ell_from_graph(g.row_ptr, g.col_idx, V)
    return t, tt


# ------------------------------------------------------------- MAX/MIN


@pytest.mark.parametrize("aggr", ["max", "min"])
@pytest.mark.parametrize("route", ["ell", "cuda", "segment"])
def test_max_min_match_jax_vjp(aggr, route):
    """GraphContext.aggregate MAX/MIN on each port route against the JAX
    GraphContext on 'ell' ('segment' for the edge list): the forward
    equal, the gradient of a random cotangent within GRAD_TOL; the empty
    row 0 with no gradient."""
    jds, tds = _datasets()
    jimpl = "segment" if route == "segment" else "ell"
    jg = j_make_gctx(jds, aggr_impl=jimpl, chunk=16, symmetric=True)
    tg = make_graph_context(tds, route, symmetric=True, device="cpu",
                            chunk=16)
    x = _tied_input(8, 0)
    if aggr == "min":
        x = -x
    ct = np.random.RandomState(1).randn(V, 8).astype(np.float32)
    want, vjp = jax.vjp(jax.jit(lambda a: jg.aggregate(a, aggr)),
                        jnp.asarray(x))
    (want_g,) = vjp(jnp.asarray(ct))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = tg.aggregate(xt, aggr)
    (got_g,) = torch.autograd.grad(got, xt, torch.from_numpy(ct))
    assert np.array_equal(got.detach().numpy(), np.asarray(want))
    assert not got[EMPTY].any()
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g),
                               **GRAD_TOL)
    # the ties share: some source gets a fraction of a cotangent entry
    assert (np.asarray(want_g) != 0).sum() > 0


@pytest.mark.parametrize("budget", [1 << 24, 64])
def test_ell_max_segments_match_jax(budget):
    """aggregate_ell_max itself at the default budget and at a budget
    that splits every bucket into row segments, against the JAX function
    at the same budget: forward equal, gradient within GRAD_TOL."""
    g = _graphs()[0]
    t, tt = _ell(g)
    F = 8
    x = np.concatenate([_tied_input(F, 2), np.zeros((1, F), np.float32)])
    ct = np.random.RandomState(3).randn(V, F).astype(np.float32)
    want, vjp = jax.vjp(jax.jit(
        lambda a: j_ell_max(a, tuple(jnp.asarray(i[0]) for i in t.idx),
                            jnp.asarray(t.row_pos[0]), V,
                            budget_elems=budget)), jnp.asarray(x))
    (want_g,) = vjp(jnp.asarray(ct))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = aggregate_ell_max(xt, tuple(torch.from_numpy(i[0])
                                      for i in tt.idx),
                            torch.from_numpy(tt.row_pos[0]), V,
                            budget_elems=budget)
    (got_g,) = torch.autograd.grad(got, xt, torch.from_numpy(ct),
                                   allow_unused=True)
    assert np.array_equal(got.detach().numpy(), np.asarray(want))
    assert np.isneginf(got[EMPTY].detach().numpy()).all()
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g),
                               **GRAD_TOL)


# ----------------------------------------------------------- attention


def _att_inputs(K, dh, seed, zero_score):
    """full [V+1, K*dh] with its zero row, s_full [V+1, K], d_local
    [V+1, K]; with ``zero_score`` the destination logit of a few rows is
    the negated source logit of one of their neighbours, so that edge's
    score is exactly 0."""
    rng = np.random.RandomState(seed)
    full = rng.randn(V + 1, K * dh).astype(np.float32)
    full[V] = 0
    s = rng.randn(V + 1, K).astype(np.float32)
    d = rng.randn(V + 1, K).astype(np.float32)
    d[V] = 0
    g = _graphs()[1]
    zeros = []
    if zero_score:
        for v in (0, 3, 11):
            j = g.col_idx[g.row_ptr[v]]
            d[v] = -s[j]
            zeros.append((v, j))
    return full, s, d, zeros


@pytest.mark.parametrize("budget", [1 << 24, 100])
@pytest.mark.parametrize("K", [1, 2])
def test_attention_matches_jax_vjp(K, budget):
    """gat_aggregate_ell against the JAX function: heads 1 and 2, the
    empty row (0, no gradient), scores exactly at 0 (JAX's slope 1
    there), and at a budget that segments every bucket (the port's
    per-segment recompute against JAX's checkpointed scan).  Forward and
    the VJP into full, s_full and d_local within ATT_RTOL."""
    g = _graphs()[0]
    t, tt = _ell(g)
    full, s, d, zeros = _att_inputs(K, 4, 7 + K, zero_score=True)
    ct = np.random.RandomState(9).randn(V, K * 4).astype(np.float32)

    def jfn(a, b, c):
        return j_gat_ell(a, b, c, tuple(jnp.asarray(i[0]) for i in t.idx),
                         tuple(jnp.asarray(i[0]) for i in t.row_id),
                         jnp.asarray(t.row_pos[0]), V, budget_elems=budget)
    want, vjp = jax.vjp(jax.jit(jfn), *map(jnp.asarray, (full, s, d)))
    wants = vjp(jnp.asarray(ct))
    ins = [torch.from_numpy(a).requires_grad_(True) for a in (full, s, d)]
    got = gat_aggregate_ell(*ins, tuple(torch.from_numpy(i[0])
                                        for i in tt.idx),
                            tuple(torch.from_numpy(i[0])
                                  for i in tt.row_id),
                            torch.from_numpy(tt.row_pos[0]), V,
                            budget_elems=budget)
    gots = torch.autograd.grad(got, ins, torch.from_numpy(ct))
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=ATT_RTOL,
                               atol=1e-6 * np.abs(want).max())
    assert not got[EMPTY].detach().any()
    for a, b in zip(gots, wants):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=ATT_RTOL,
                                   atol=1e-6 * np.abs(b).max())
    for v, j in zeros:
        assert (s[j] + d[v] == 0).all()
    # a destination logit's gradient sums its row's edges: at slope 0.2
    # for the zero-score edge it would differ
    assert np.abs(gots[2].numpy()[[0, 3, 11]]).max() > 0


@pytest.mark.parametrize("route", ["ell", "cuda"])
def test_gat_op_matches_jax_graph_context(route):
    """GraphContext.gat_attention, the model op (the logits from
    a_src/a_dst, then the softmax-weighted sum), 2 heads, against the JAX
    GraphContext on 'ell': forward and gradients into x, a_src, a_dst."""
    jds, tds = _datasets()
    jg = j_make_gctx(jds, aggr_impl="ell", symmetric=True)
    tg = make_graph_context(tds, route, symmetric=True, device="cpu")
    rng = np.random.RandomState(12)
    x = rng.randn(V, 8).astype(np.float32)
    a_s, a_d = (rng.randn(2, 4).astype(np.float32) for _ in range(2))
    ct = rng.randn(V, 8).astype(np.float32)
    want, vjp = jax.vjp(jax.jit(lambda *a: jg.gat_attention(*a)),
                        *map(jnp.asarray, (x, a_s, a_d)))
    wants = vjp(jnp.asarray(ct))
    ins = [torch.from_numpy(a).requires_grad_(True) for a in (x, a_s, a_d)]
    got = tg.gat_attention(*ins)
    gots = torch.autograd.grad(got, ins, torch.from_numpy(ct))
    for a, b in zip((got.detach(), *gots), (want, *wants)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=ATT_RTOL,
                                   atol=1e-6 * np.abs(b).max())


def test_attention_refuses_the_edge_routes():
    _, tds = _datasets()
    tg = make_graph_context(tds, "cuda_csr", symmetric=True, device="cpu")
    with pytest.raises(NotImplementedError, match="ELL tables"):
        tg.gat_attention(torch.zeros(V, 4), torch.zeros(4), torch.zeros(4))
    # the JAX package's message (roc_tpu/models/builder.py _max_fwd)
    with pytest.raises(NotImplementedError, match="AGGR_MAX has no"):
        tg.aggregate(torch.zeros(V, 4), "max")


# ---------------------------------------------------------------- P = 2


def test_gat_two_heads_at_p2_matches_jax_distributed():
    """GAT with 2 heads, 6 epochs from the JAX run's weights: two gloo
    ranks of the port (the 'cuda' route, attention on each rank's ELL
    tables over the halo gather) against JAX DistributedTrainer at P = 2
    and against the port's Trainer.  The printed loss curve within rtol
    1e-4 and the logits within 1e-4 of max|logit| (fp32 sums and softmax
    in another order, compounded over the steps); every rank ends with
    the same weights."""
    layers, epochs = [12, 16, 3], 6
    jds = jgraph.synthetic_dataset(96, 7, in_dim=12, num_classes=3, seed=11)
    tds = tgraph.synthetic_dataset(96, 7, in_dim=12, num_classes=3, seed=11)
    jtr = JDist(j_build_gat(layers, dropout_rate=0.0, heads=2), jds, 2,
                JTrainConfig(aggr_impl="ell", dropout_rate=0.0,
                             verbose=False, epochs=epochs, eval_every=1,
                             symmetric=True, chunk=64))
    p0 = {k: np.asarray(v) for k, v in jtr.params.items()}
    jhist = jtr.train()
    jlogits = np.asarray(jtr.predict(), np.float32)
    cfg = TrainConfig(aggr_impl="cuda", verbose=False, epochs=epochs,
                      eval_every=1, symmetric=True, chunk=64)
    runs = [dict(model=build_gat(layers, dropout_rate=0.0, heads=2),
                 dataset=tds, config=cfg,
                 params=convert.params_from_jax(p0))]
    results = run_ranks(train_job, 2, runs=runs, device="cpu")
    tr = Trainer(build_gat(layers, dropout_rate=0.0, heads=2), tds, cfg,
                 params=convert.params_from_jax(p0), device="cpu")
    thist = tr.train()
    for k in results[0][0]["params"]:
        np.testing.assert_array_equal(results[1][0]["params"][k],
                                      results[0][0]["params"][k])
    r = results[0][0]
    for want in (jhist, thist):
        np.testing.assert_allclose([m["train_loss"] for m in r["history"]],
                                   [m["train_loss"] for m in want],
                                   rtol=1e-4)
    assert r["history"][-1]["train_loss"] < r["history"][0]["train_loss"]
    tol = 1e-4 * np.abs(jlogits).max()
    np.testing.assert_allclose(r["logits"], jlogits, rtol=0, atol=tol)
    np.testing.assert_allclose(r["logits"], tr.predict().numpy(), rtol=0,
                               atol=tol)
