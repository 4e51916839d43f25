"""The port's kernel modules against the JAX package's Pallas kernels.

On the CPU each kernel wrapper runs its plain PyTorch version; these
tests hold those plain versions to the JAX package's Pallas kernels run
in interpret mode (as tests/test_kernels.py runs them), on the same
inputs made with numpy.  The CUDA kernels themselves are held to the
plain versions on the card by tests/test_torch_cuda.py.
"""

import pathlib

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from roc_tpu.core.ell import ell_from_graph as j_ell_from_graph
from roc_tpu.core.graph import synthetic_graph
from roc_tpu.kernels.ell_spmm import ell_aggregate_pallas
from roc_tpu.kernels.graphnorm import (indegree_norm_pallas,
                                       scale_act_pallas)
from roc_tpu.ops.aggregate import aggregate_ell as j_aggregate_ell
from roc_tpu_torch.core.ell import ell_from_graph
from roc_tpu_torch.kernels import _build
from roc_tpu_torch.kernels.ell_spmm import (ell_aggregate,
                                            ell_aggregate_plain)
from roc_tpu_torch.kernels.graphnorm import indegree_norm, scale_act
from roc_tpu_torch.ops.aggregate import aggregate_ell


def _rows_and_degrees(V, F, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(V, F).astype(np.float32)
    deg = rng.randint(1, 60, size=V).astype(np.int32)
    deg[:5] = 0                       # padding rows -> zero output
    return x, deg


@pytest.mark.parametrize("V,F", [(100, 12), (37, 8), (1031, 41)])
def test_indegree_norm_plain_matches_pallas(V, F):
    """fp32 row scale: 1 ulp of tolerance (the JAX kernel's rsqrt may
    round differently from the port's correctly rounded 1/sqrt)."""
    x, deg = _rows_and_degrees(V, F, 0)
    want = np.asarray(indegree_norm_pallas(
        jnp.asarray(x), jnp.asarray(deg), block=32, interpret=True))
    got = indegree_norm(torch.from_numpy(x), torch.from_numpy(deg))
    np.testing.assert_allclose(got.numpy(), want, rtol=2.4e-7, atol=0)
    assert not got[:5].any()


@pytest.mark.parametrize("act", ["none", "relu"])
@pytest.mark.parametrize("V,F", [(100, 12), (1031, 41)])
def test_scale_act_plain_matches_pallas(act, V, F):
    """One fp32 multiply (and a max) per element: bit-equal."""
    x, _ = _rows_and_degrees(V, F, 1)
    s = np.random.RandomState(2).rand(V).astype(np.float32)
    want = np.asarray(scale_act_pallas(jnp.asarray(x), jnp.asarray(s),
                                       act=act, block=64, interpret=True))
    got = scale_act(torch.from_numpy(x), torch.from_numpy(s), act=act)
    np.testing.assert_array_equal(got.numpy(), want)
    if act == "relu":
        assert (got.numpy() >= 0).all()
    with pytest.raises(ValueError):
        scale_act(torch.from_numpy(x), torch.from_numpy(s), act="elu")


def _ell_inputs(V, deg, F, seed, power_law=True):
    g = synthetic_graph(V, deg, seed=seed, power_law=power_law)
    V = g.num_nodes
    jt = j_ell_from_graph(g.row_ptr, g.col_idx, V)
    tt = ell_from_graph(g.row_ptr, g.col_idx, V)
    feats = np.zeros((V + 1, F), dtype=np.float32)
    feats[:V] = np.random.RandomState(seed).randn(V, F)
    return g, jt, tt, feats


def _torch_tables(tt):
    return (tuple(torch.from_numpy(a[0]) for a in tt.idx),
            torch.from_numpy(tt.row_pos[0]),
            tuple(torch.from_numpy(a[0]) for a in tt.row_id))


def _tol(want):
    """K4 tolerance: the sums run in another order than XLA's width
    reduction, so fp32 agreement is rtol=1e-5, atol=1e-5 * max|row|."""
    return dict(rtol=1e-5, atol=1e-5 * float(np.abs(want).max()))


@pytest.mark.parametrize("V,deg,F", [(300, 9, 24), (203, 5, 41)])
def test_ell_aggregate_plain_matches_pallas(V, deg, F):
    """Several width buckets, row counts that are no multiple of 8."""
    g, jt, tt, feats = _ell_inputs(V, deg, F, seed=3)
    assert len(tt.widths) >= 3
    want = np.asarray(ell_aggregate_pallas(
        jnp.asarray(feats), tuple(jnp.asarray(a[0]) for a in jt.idx),
        jnp.asarray(jt.row_pos[0]), g.num_nodes, interpret=True))
    idx, _, rid = _torch_tables(tt)
    got = ell_aggregate(torch.from_numpy(feats[:-1]), idx, rid, g.num_nodes)
    np.testing.assert_allclose(got.numpy(), want, **_tol(want))


@pytest.mark.parametrize("budget", [1 << 24, 97])
def test_ell_sums_match_jax_aggregate_ell(budget):
    """K4's plain version and the plain 'ell' route (row-segmented at a
    tiny budget too) against the JAX package's aggregate_ell."""
    g, jt, tt, feats = _ell_inputs(400, 7, 16, seed=5)
    V = g.num_nodes
    want = np.asarray(j_aggregate_ell(
        jnp.asarray(feats), tuple(jnp.asarray(a[0]) for a in jt.idx),
        jnp.asarray(jt.row_pos[0]), V, budget_elems=budget))
    idx, pos, rid = _torch_tables(tt)
    k4 = ell_aggregate_plain(torch.from_numpy(feats[:-1]), idx, rid, V,
                             budget_elems=budget)
    np.testing.assert_allclose(k4.numpy(), want, **_tol(want))
    ell = aggregate_ell(torch.from_numpy(feats), idx, pos, V,
                        budget_elems=budget)
    np.testing.assert_allclose(ell.numpy(), want, **_tol(want))


def test_ell_aggregate_zero_degree_rows_and_hub():
    """Rows in no bucket come out 0; a hub row wider than 1024 sums all
    its neighbours."""
    V, F = 1100, 8
    src = np.concatenate([np.arange(V), np.arange(1100) % V])
    dst = np.concatenate([np.arange(V), np.full(1100, 3)])
    keep = ~np.isin(dst, [10, 11])
    from roc_tpu_torch.core.graph import from_edge_list
    g = from_edge_list(src[keep], dst[keep], V)
    tt = ell_from_graph(g.row_ptr, g.col_idx, V)
    assert max(tt.widths) == 2048
    x = torch.from_numpy(np.random.RandomState(0).rand(V, F)
                         .astype(np.float32))
    idx, _, rid = _torch_tables(tt)
    got = ell_aggregate(x, idx, rid, V)
    assert not got[10].any() and not got[11].any()
    np.testing.assert_allclose(got[3].numpy(),
                               (x.sum(0) + x[3]).numpy(), rtol=1e-5)


def test_fused_chain_matches_pallas_chain():
    """K1 -> K4 -> K2 (relu) on the CPU against the JAX package's
    hand-written chain (indegree_norm_pallas -> fused_ell_aggregate_
    pallas) on the same inputs."""
    from roc_tpu.kernels.graphnorm import fused_ell_aggregate_pallas
    from roc_tpu.ops.norm import inv_sqrt_degree as j_inv
    g, jt, tt, feats = _ell_inputs(150, 6, 16, seed=8)
    V = g.num_nodes
    x = feats[:-1]
    deg = g.in_degree
    pre = indegree_norm_pallas(jnp.asarray(x), jnp.asarray(deg),
                               interpret=True)
    full = jnp.concatenate([pre, jnp.zeros((1, 16), jnp.float32)])
    want = np.asarray(fused_ell_aggregate_pallas(
        full, tuple(jnp.asarray(a[0]) for a in jt.idx),
        jnp.asarray(jt.row_pos[0]), V, j_inv(jnp.asarray(deg)),
        act="relu", interpret=True))
    idx, _, rid = _torch_tables(tt)
    tdeg = torch.from_numpy(deg)
    from roc_tpu_torch.ops.norm import inv_sqrt_degree
    got = scale_act(ell_aggregate(indegree_norm(torch.from_numpy(x), tdeg),
                                  idx, rid, V),
                    inv_sqrt_degree(tdeg), act="relu")
    np.testing.assert_allclose(got.numpy(), want, **_tol(want))


def test_cpu_wrappers_count_no_launches():
    """On the CPU the wrappers run their plain versions and launch
    nothing, so the counters do not move."""
    before = (indegree_norm.launches, scale_act.launches,
              ell_aggregate.launches)
    x = torch.ones(4, 4)
    indegree_norm(x, torch.ones(4, dtype=torch.int32))
    scale_act(x, torch.ones(4))
    ell_aggregate(x, (torch.zeros((4, 8), dtype=torch.int32),),
                  (torch.arange(4, dtype=torch.int32),), 4)
    assert (indegree_norm.launches, scale_act.launches,
            ell_aggregate.launches) == before


def test_wrappers_reject_bad_shapes():
    x = torch.ones(4, 4)
    with pytest.raises(ValueError):
        indegree_norm(x, torch.ones(5, dtype=torch.int32))
    with pytest.raises(ValueError):
        scale_act(x[0], torch.ones(4))
    with pytest.raises(ValueError):
        ell_aggregate(x, (torch.zeros((4, 8), dtype=torch.int32),),
                      (torch.arange(3, dtype=torch.int32),), 4)


def test_build_compiles_every_source_for_sm90a(monkeypatch):
    """The loader builds every csrc/*.cu for sm_90a, binds every C entry
    point, and raises a clear error where there is no nvcc."""
    names = sorted(p.rsplit("/", 1)[-1] for p in _build.sources())
    assert names == ["ell_spmm.cu", "graphnorm.cu", "spmm.cu"]
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    for name in _build.SIGNATURES:
        assert any(name in pathlib.Path(p).read_text()
                   for p in _build.sources())
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda _: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()
