"""The row-scale kernels K1 (indegree_norm, and its relu-masked form for
the fused backward) and K2 (scale_act) of the port against the JAX
package, on the CPU, where the wrappers run their plain versions.

- the masked K1's plain version against ``indegree_norm_pallas`` of
  ``jnp.where(y > 0, g, 0)`` (interpret mode), with deg-0 rows, y == 0,
  y == -0.0, NaN in y, and NaN/inf in g where y <= 0;
- K1's and K2's plain versions against the Pallas kernels at widths below
  and around a 16-byte unit (F = 1, 7, 9);
- the fused relu backward with a cotangent that holds NaN/inf where the
  relu's output is <= 0: a select, as ``jax.nn.relu``'s VJP is, so the
  gradient stays finite, against ``jax.vjp`` of the JAX package's fused
  aggregation and relu;
- the kernel routes' backward takes the masked K1 and matches the plain
  routes.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from roc_tpu.core import graph as jgraph
from roc_tpu.kernels.graphnorm import indegree_norm_pallas, scale_act_pallas
from roc_tpu.ops import dense as jdense
from roc_tpu.train.trainer import make_graph_context as j_make_graph_context
from roc_tpu_torch.core import graph as tgraph
from roc_tpu_torch.kernels import graphnorm
from roc_tpu_torch.train.trainer import make_graph_context

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _to_torch(a, dtype):
    """numpy fp32 -> torch ``dtype`` through JAX's rounding, so both
    packages see the same bf16 bits."""
    j = jnp.asarray(a, DTYPES[dtype][1])
    return torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        DTYPES[dtype][0]), j


def _bf16_ulp(a):
    """One bf16 ulp of each element's magnitude (2^-7 of its binade), 0
    for 0."""
    a = np.abs(np.asarray(a, np.float64))
    _, e = np.frexp(a)
    return np.where(a > 0, np.ldexp(1.0, e - 8), 0.0)


def _within_one_ulp(got, want, dtype):
    """K1 against ``indegree_norm_pallas``: the JAX kernel's d is
    lax.rsqrt, up to one fp32 ulp off the port's correctly rounded
    1/sqrt (ROADMAP Queue 3).  In fp32 that ulp of d carries into the
    product as a relative error of up to 2^-23, so the tolerance is
    tests/test_torch_kernels.py's rtol 2.4e-7; a bf16 element, rounded
    once from that fp32 product, may be one bf16 ulp off."""
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert np.isfinite(got).all() and np.isfinite(want).all()
    err = np.abs(got.astype(np.float64) - want)
    if dtype == "float32":
        tol = 2.4e-7 * np.abs(want)
    else:
        tol = np.maximum(_bf16_ulp(got), _bf16_ulp(want))
    assert (err <= tol).all(), float(err.max())
    assert ((got == 0) == (want == 0)).all()


def _masked_case(V, F, seed):
    """g and the relu output y [V, F] and degrees [V] with every edge
    case of the select: deg-0 rows, y == 0 and -0.0 exactly, NaN in y,
    and NaN/+inf/-inf in g only where y <= 0 (or y is NaN)."""
    rng = np.random.RandomState(seed)
    g = rng.randn(V, F).astype(np.float32)
    y = np.maximum(rng.randn(V, F), 0).astype(np.float32)
    flat = y.reshape(-1)
    pick = rng.choice(flat.size, size=min(flat.size, 3 * F), replace=False)
    flat[pick[0::3]] = -0.0
    flat[pick[1::3]] = np.nan
    flat[pick[2::3]] = -rng.rand(len(pick[2::3]))
    off = ~(y > 0)
    bad = np.array([np.nan, np.inf, -np.inf], np.float32)
    g[off] = bad[rng.randint(0, 3, int(off.sum()))]
    deg = rng.randint(0, 40, V).astype(np.int32)
    deg[:3] = 0
    return g, y, deg


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("F", [1, 3, 7, 8, 9, 41])
def test_masked_indegree_norm_plain_matches_pallas(F, dtype):
    """indegree_norm(g, deg, relu_out=y) on the CPU (the masked kernel's
    plain version) against indegree_norm_pallas(where(y > 0, g, 0), deg)
    in interpret mode, in the tensors' dtype."""
    g, y, deg = _masked_case(37, F, seed=F)
    tg, jg = _to_torch(g, dtype)
    ty, jy = _to_torch(y, dtype)
    want = indegree_norm_pallas(jnp.where(jy > 0, jg, 0), jnp.asarray(deg),
                                block=16, interpret=True)
    got = graphnorm.indegree_norm(tg, torch.from_numpy(deg), relu_out=ty)
    assert got.dtype == DTYPES[dtype][0] and want.dtype == DTYPES[dtype][1]
    _within_one_ulp(got, want, dtype)
    assert not got[:3].any()
    # the select, not a product with a 0/1 mask: finite wherever y <= 0
    assert bool(got.float().isfinite().all())
    assert torch.equal(got, graphnorm.indegree_norm_plain(
        torch.where(ty > 0, tg, 0), torch.from_numpy(deg)))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("F", [1, 7, 9])
def test_row_scale_plain_matches_pallas_at_unit_widths(F, dtype):
    """K1 and K2's plain versions against indegree_norm_pallas and
    scale_act_pallas (interpret mode) at widths below and around one
    16-byte unit: K2 bit for bit (one fp32 product, one rounding), K1
    within one ulp of the dtype (rsqrt against 1/sqrt)."""
    rng = np.random.RandomState(100 + F)
    V = 53
    x = rng.randn(V, F).astype(np.float32)
    deg = rng.randint(0, 50, V).astype(np.int32)
    deg[:2] = 0
    s = rng.rand(V).astype(np.float32)
    tx, jx = _to_torch(x, dtype)
    _within_one_ulp(graphnorm.indegree_norm(tx, torch.from_numpy(deg)),
                    indegree_norm_pallas(jx, jnp.asarray(deg), block=16,
                                         interpret=True), dtype)
    for act in ("none", "relu"):
        got = graphnorm.scale_act(tx, torch.from_numpy(s), act)
        want = scale_act_pallas(jx, jnp.asarray(s), act=act, block=16,
                                interpret=True)
        np.testing.assert_array_equal(
            got.float().numpy(), np.asarray(want.astype(jnp.float32)))


def test_masked_k1_refuses_relu_out_unlike_g():
    """relu_out must have g's shape, dtype and device."""
    g = torch.ones(6, 4)
    deg = torch.ones(6, dtype=torch.int32)
    for y in (torch.ones(6, 5), torch.ones(6, 4, dtype=torch.bfloat16),
              torch.ones(6, 4, device="meta")):
        with pytest.raises(ValueError, match="relu_out"):
            graphnorm.indegree_norm(g, deg, relu_out=y)


# ------------------------------------------- the fused relu backward

LAYERS_IN, LAYERS_OUT = 8, 5


def _datasets(V=120, deg=6, seed=9):
    """The same dataset in both packages (bit-equal,
    tests/test_torch_data.py)."""
    return (jgraph.synthetic_dataset(V, deg, in_dim=LAYERS_IN,
                                     num_classes=LAYERS_OUT, seed=seed),
            tgraph.synthetic_dataset(V, deg, in_dim=LAYERS_IN,
                                     num_classes=LAYERS_OUT, seed=seed))


def _port_relu_vjp(tds, impl, x, g):
    """The port's fused relu aggregation on ``impl`` (CPU): its output y
    and the gradient of sum(y * g) with respect to x."""
    tg = make_graph_context(tds, impl, symmetric=True, device="cpu",
                            chunk=64)
    tx = torch.from_numpy(x).requires_grad_(True)
    ty = tg.aggregate_fused(tx, "relu")
    (grad,) = torch.autograd.grad(ty, tx, torch.from_numpy(g))
    return ty.detach().numpy(), grad.numpy()


def _nonfinite_cotangent(y_a, y_b, seed):
    """A cotangent that holds NaN, +inf and -inf at every position where
    both outputs are <= 0, finite values elsewhere."""
    rng = np.random.RandomState(seed)
    g = rng.randn(*y_a.shape).astype(np.float32)
    off = (y_a <= 0) & (y_b <= 0)
    assert off.any() and (~off).any()
    bad = np.array([np.nan, np.inf, -np.inf], np.float32)
    g[off] = bad[np.arange(int(off.sum())) % 3]
    return g


def _sum_tol(want):
    """Neighbour sums in another fp32 order: rtol 1e-5, atol 1e-5 *
    max|row| (tests/test_torch_train.py)."""
    return dict(rtol=1e-5, atol=1e-5 * float(np.abs(want).max()))


@pytest.mark.parametrize("jimpl,impl", [("ell", "ell"),
                                        ("segment", "segment"),
                                        ("pallas", "cuda"),
                                        ("scan", "cuda_csr")])
def test_fused_relu_backward_selects_like_jax(jimpl, impl):
    """A cotangent with NaN/inf where relu's output is <= 0: jax.vjp of
    the JAX package's aggregate_fused + relu gives a finite gradient
    (relu's VJP is a select), and so does the port's fused backward, to
    fp32 neighbour-sum rounding.  Multiplying by a 0/1 mask instead
    spreads NaN through the neighbour sum."""
    jds, tds = _datasets()
    V = tds.graph.num_nodes
    x = np.random.RandomState(10).randn(V, LAYERS_IN).astype(np.float32)
    jg = j_make_graph_context(jds, jimpl, chunk=64, symmetric=True)

    def jf(xx):
        return jdense.activation(jg.aggregate_fused(xx), "relu")

    jy, vjp = jax.vjp(jf, jnp.asarray(x))
    jy = np.asarray(jy)
    ty, _ = _port_relu_vjp(tds, impl, x, np.zeros_like(x))
    g = _nonfinite_cotangent(jy, ty, seed=11)
    (jgrad,) = vjp(jnp.asarray(g))
    jgrad = np.asarray(jgrad)
    assert np.isfinite(jgrad).all()
    ty, tgrad = _port_relu_vjp(tds, impl, x, g)
    np.testing.assert_allclose(ty, jy, **_sum_tol(jy))
    assert np.isfinite(tgrad).all()
    np.testing.assert_allclose(tgrad, jgrad, **_sum_tol(jgrad))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("impl,plain", [("cuda", "ell"),
                                        ("cuda_csr", "segment")])
def test_kernel_route_backward_takes_masked_k1(monkeypatch, impl, plain,
                                               dtype):
    """On the CPU the kernel routes' fused relu backward goes through
    indegree_norm with relu_out (the masked K1's plain version) once per
    backward, and its forward and gradient match the plain route's, in
    fp32 and bf16 (the same selected cotangent; the sums in another
    order: fp32 rounding, and in bf16 one bf16 ulp of the magnitude)."""
    _, tds = _datasets()
    V = tds.graph.num_nodes
    tdt = DTYPES[dtype][0]
    x = np.random.RandomState(12).randn(V, LAYERS_IN).astype(np.float32)
    calls = []
    kernel = graphnorm.indegree_norm

    def spy(xx, deg, relu_out=None):
        calls.append(relu_out is not None)
        return kernel(xx, deg, relu_out=relu_out)

    monkeypatch.setattr(graphnorm, "indegree_norm", spy)
    out = {}
    for route in (impl, plain):
        tg = make_graph_context(tds, route, symmetric=True, device="cpu",
                                chunk=64)
        tx = torch.from_numpy(x).to(tdt).requires_grad_(True)
        ty = tg.aggregate_fused(tx, "relu")
        g = _nonfinite_cotangent(ty.detach().float().numpy(),
                                 ty.detach().float().numpy(), seed=13)
        (grad,) = torch.autograd.grad(ty, tx, torch.from_numpy(g).to(tdt))
        out[route] = (ty.detach().float().numpy(), grad.float().numpy())
        if route == impl:
            # the forward's K1, then the backward's masked K1
            assert calls == [False, True]
            assert grad.dtype == tdt
    (yk, gk), (yp, gp) = out[impl], out[plain]
    assert np.isfinite(gk).all() and np.isfinite(gp).all()
    if dtype == "float32":
        np.testing.assert_allclose(yk, yp, **_sum_tol(yp))
        np.testing.assert_allclose(gk, gp, **_sum_tol(gp))
    else:
        # bf16: K1 scales by the fp32 d, the plain route by d in bf16
        # (tests/test_torch_bf16.py); a few bf16 roundings apart
        for got, want in ((yk, yp), (gk, gp)):
            np.testing.assert_allclose(got, want, rtol=2 ** -6,
                                       atol=2 ** -6 * np.abs(want).max())
