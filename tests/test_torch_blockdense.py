"""The port's block-dense layout (ops/blockdense.py) against the JAX
package, on the CPU: plans bit for bit, from the native host planners
and from the numpy path (min_fill, the A budget with and without group
padding, census reuse, u4 packing, saturation, the out-of-range error),
and ``aggregate_block_dense`` (u4 unpack, groups, the fused scales)
against the JAX function's forward and VJP.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from roc_tpu.core import graph as jgraph
from roc_tpu.ops import blockdense as jbd
from roc_tpu_torch import native
from roc_tpu_torch.ops import blockdense as tbd

BB = tbd.BLOCK * tbd.BLOCK


@pytest.fixture(params=["native", "numpy"])
def path(request, monkeypatch):
    if request.param == "native":
        assert native.available(), "the native host planners did not build"
    else:
        monkeypatch.setattr(native, "available", lambda: False)
    return request.param


def _planted(V=600, E=9000, seed=5, shuffle=False):
    return jgraph.planted_community_csr(V, E, community_rows=tbd.BLOCK,
                                        shuffle=shuffle, seed=seed)


def _same_plan(j, t):
    for f in ("num_rows", "vpad", "dense_edges", "total_edges", "src_vpad",
              "pad_blocks"):
        assert getattr(j, f) == getattr(t, f), f
    for f in ("a_blocks", "src_blk", "dst_blk", "res_row_ptr", "res_col"):
        a, b = getattr(j, f), getattr(t, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b)
    assert j.occupancy() == t.occupancy()


@pytest.mark.parametrize("kw", [dict(min_fill=1), dict(min_fill=30),
                                dict(min_fill=10 ** 9),
                                dict(min_fill=1, a_budget_bytes=2 * BB),
                                dict(min_fill=1, a_budget_bytes=None),
                                dict(min_fill=1, group=4),
                                dict(min_fill=1, group=3,
                                     a_budget_bytes=5 * BB),
                                dict(min_fill=1, num_cols=900)])
def test_plans_bit_equal(path, kw):
    g = _planted()
    _same_plan(jbd.plan_blocks(g.row_ptr, g.col_idx, g.num_nodes, **kw),
               tbd.plan_blocks(g.row_ptr, g.col_idx, g.num_nodes, **kw))


@pytest.mark.parametrize("group", [1, 4])
def test_packed_plans_and_census_reuse(group):
    """plan_blocks_packed (twice the budget, then u4) equals JAX's; the
    probe's census, reused, gives the plan a fresh census gives; the
    probe's fraction equals JAX's."""
    g = _planted(seed=7)
    kw = dict(min_fill=4, a_budget_bytes=3 * BB, group=group)
    frac, census = tbd.probe_dense_frac(g.row_ptr, g.col_idx, g.num_nodes,
                                        return_census=True, **kw)
    assert frac == jbd.probe_dense_frac(g.row_ptr, g.col_idx, g.num_nodes,
                                        **kw)
    want = jbd.plan_blocks_packed(g.row_ptr, g.col_idx, g.num_nodes, **kw)
    assert want.a_blocks.shape[-1] == tbd.BLOCK // 2
    _same_plan(want, tbd.plan_blocks_packed(g.row_ptr, g.col_idx,
                                            g.num_nodes, census=census,
                                            **kw))
    _same_plan(want, tbd.plan_blocks_packed(g.row_ptr, g.col_idx,
                                            g.num_nodes, **kw))


def test_saturation_and_unpackable_plans(path):
    """400 copies of one edge: 255 in the A-table, the rest residual; the
    plan does not pack to u4 and plan_blocks_packed keeps it uint8, as in
    the JAX package."""
    row_ptr = np.array([0, 400, 401, 402], dtype=np.int64)
    col = np.array([1] * 400 + [2, 0], dtype=np.int32)
    j = jbd.plan_blocks(row_ptr, col, 3, min_fill=1)
    t = tbd.plan_blocks(row_ptr, col, 3, min_fill=1)
    _same_plan(j, t)
    assert t.res_col.shape[0] == 400 - 255
    assert tbd.pack_a_u4(t) is None
    _same_plan(jbd.plan_blocks_packed(row_ptr, col, 3, min_fill=1),
               tbd.plan_blocks_packed(row_ptr, col, 3, min_fill=1))


def test_out_of_range_sources_raise(path):
    """A source outside the declared space raises on both paths (the
    native census returns its error, the numpy path checks)."""
    ptr = np.array([0, 1, 2], dtype=np.int64)
    col = np.array([0, 300], dtype=np.int32)
    with pytest.raises(ValueError):
        tbd.plan_blocks(ptr, col, 2, min_fill=1, num_cols=200)
    tbd.plan_blocks(ptr, col, 2, min_fill=1, num_cols=400)


def test_probe_needs_the_native_planners(monkeypatch):
    g = _planted()
    monkeypatch.setattr(native, "available", lambda: False)
    assert tbd.probe_dense_frac(g.row_ptr, g.col_idx, g.num_nodes) is None


def _aggregate_case(group, packed, scaled, dtype=np.float32):
    g = _planted(seed=9)
    V = g.num_nodes
    plan = jbd.plan_blocks(g.row_ptr, g.col_idx, V, min_fill=2, group=group)
    if packed:
        plan = jbd.pack_a_u4(plan)
    rng = np.random.RandomState(10)
    x = rng.randn(V + 1, 20).astype(dtype)
    x[-1] = 0
    d = np.zeros(plan.vpad, np.float32)
    d[:V] = rng.rand(V).astype(np.float32)
    return g, plan, x, (d if scaled else None)


@pytest.mark.parametrize("group,packed,scaled",
                         [(1, False, False), (1, True, True), (4, True, False),
                          (4, False, True), (3, True, True)])
def test_aggregate_block_dense_and_vjp(group, packed, scaled):
    """The dense tiles' sum against the JAX function (fp32; rtol 1e-5,
    atol 1e-5 * max|value|: fp32 products summed in another order),
    forward and VJP, at small chunks so several steps run."""
    g, plan, x, d = _aggregate_case(group, packed, scaled)
    V = g.num_nodes
    ct = np.random.RandomState(11).randn(V, 20).astype(np.float32)
    jkw = dict(group=group, chunk_blocks=2 * group)
    if scaled:
        jkw.update(scale_dst=jnp.asarray(d), scale_src=jnp.asarray(d))
    jout, vjp = jax.vjp(lambda a: jbd.aggregate_block_dense(
        a, jnp.asarray(plan.a_blocks), jnp.asarray(plan.src_blk),
        jnp.asarray(plan.dst_blk), V, plan.vpad, **jkw), jnp.asarray(x))
    jg = np.asarray(vjp(jnp.asarray(ct))[0])
    tx = torch.from_numpy(x).requires_grad_(True)
    tkw = dict(group=group, chunk_blocks=2 * group)
    if scaled:
        tkw.update(scale_dst=torch.from_numpy(d),
                   scale_src=torch.from_numpy(d))
    tout = tbd.aggregate_block_dense(
        tx, torch.from_numpy(plan.a_blocks), torch.from_numpy(plan.src_blk),
        torch.from_numpy(plan.dst_blk), V, plan.vpad, **tkw)
    tg, = torch.autograd.grad(tout, tx, torch.from_numpy(ct))
    jout = np.asarray(jout)
    np.testing.assert_allclose(tout.detach().numpy(), jout, rtol=1e-5,
                               atol=1e-5 * np.abs(jout).max())
    np.testing.assert_allclose(tg.numpy(), jg, rtol=1e-5,
                               atol=1e-5 * np.abs(jg).max())


def test_aggregate_block_dense_bf16_accumulates_in_fp32():
    """bf16 features: bf16 operands, fp32 accumulation (the JAX
    function's ``preferred_element_type``): the fp32 output equals the
    fp32 computation on the bf16 values, and a group's pad blocks add
    nothing.  Checks of the arguments raise."""
    g, plan, x, _ = _aggregate_case(2, True, False)
    V = g.num_nodes
    xb = torch.from_numpy(x).to(torch.bfloat16)
    args = (torch.from_numpy(plan.a_blocks), torch.from_numpy(plan.src_blk),
            torch.from_numpy(plan.dst_blk), V, plan.vpad)
    got = tbd.aggregate_block_dense(xb, *args, group=2)
    want = tbd.aggregate_block_dense(xb.float(), *args, group=2)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="group"):
        tbd.aggregate_block_dense(xb, *args[:2], args[2], V, plan.vpad,
                                  group=2 * plan.n_blocks + 1)
    with pytest.raises(ValueError, match="together"):
        tbd.aggregate_block_dense(xb, *args, group=2,
                                  scale_dst=torch.ones(plan.vpad))
