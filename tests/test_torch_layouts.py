"""The large-graph layouts of the port (core/ell.py sectioned and flat
tables, ops/aggregate.py sums and max, ops/attention.py flat attention)
against the JAX package, on the CPU, at small sizes.

Tables are compared bit for bit, from the native host planners
(roc_tpu_torch/native) and from the numpy path.  Sums and maxima take
the same numpy inputs from a seed in both packages; their forwards and
their VJPs (``jax.vjp`` against ``torch.autograd.grad``) are held within
the tolerance stated at each test.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from roc_tpu.core import ell as jell
from roc_tpu.core import graph as jgraph
from roc_tpu.ops import aggregate as jagg
from roc_tpu.ops import attention as jatt
from roc_tpu_torch import native
from roc_tpu_torch.core import ell as tell
from roc_tpu_torch.ops import aggregate as tagg
from roc_tpu_torch.ops import attention as tatt

F = 12


@pytest.fixture(params=["native", "numpy"])
def path(request, monkeypatch):
    """Run the port's builders natively, or with the native planners
    hidden (the numpy path)."""
    if request.param == "native":
        assert native.available(), "the native host planners did not build"
    else:
        monkeypatch.setattr(native, "available", lambda: False)
    return request.param


@pytest.mark.parametrize("gen,kw", [
    ("random_csr", dict(power_law=True)), ("random_csr", dict(power_law=False)),
    ("zipf_csr", dict(a=1.2)), ("zipf_csr", dict(shuffle=False)),
    ("planted_community_csr", dict(community_rows=64)),
    ("planted_community_csr", dict(community_rows=50, shuffle=False,
                                   src_skew=0.5, intra_frac=0.6))])
def test_generators_bit_equal(gen, kw):
    """The benchmark generators draw the JAX package's arrays, bit for
    bit, for the same seed."""
    from roc_tpu_torch.core import graph as tgraph
    a = getattr(jgraph, gen)(700, 9000, seed=5, **kw)
    b = getattr(tgraph, gen)(700, 9000, seed=5, **kw)
    for x, y in ((a.row_ptr, b.row_ptr), (a.col_idx, b.col_idx)):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    rng_a, rng_b = np.random.RandomState(3), np.random.RandomState(3)
    np.testing.assert_array_equal(
        jgraph._lognormal_degree_sequence(50, 400, rng_a),
        tgraph._lognormal_degree_sequence(50, 400, rng_b))


def _graph(V=300, E=5000, seed=1):
    return jgraph.random_csr(V, E, seed=seed)


def _same_tables(j, t):
    assert (j.num_rows, j.src_rows, j.section_rows, j.seg_rows, j.sub_w) \
        == (t.num_rows, t.src_rows, t.section_rows, t.seg_rows, t.sub_w)
    assert tuple(j.sec_starts) == t.sec_starts
    assert tuple(j.sec_sizes) == t.sec_sizes
    assert len(j.idx) == len(t.idx)
    for a, b in zip(j.idx + j.sub_dst, t.idx + t.sub_dst):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("section_rows,seg_rows,sub_w",
                         [(100, 64, 8), (65_536, 131_072, 8), (128, 50, 4),
                          (77, 32, 16)])
def test_sectioned_tables_bit_equal(path, section_rows, seg_rows, sub_w):
    """The sectioned tables, their per-section counts and the weight
    tables equal the JAX package's, bit for bit."""
    g = _graph()
    V = g.num_nodes
    args = (g.row_ptr, g.col_idx, V)
    kw = dict(section_rows=section_rows, seg_rows=seg_rows, sub_w=sub_w)
    j = jell.sectioned_from_graph(*args, **kw)
    t = tell.sectioned_from_graph(*args, **kw)
    _same_tables(j, t)
    np.testing.assert_array_equal(
        jell.section_sub_counts(*args, V, section_rows, sub_w),
        tell.section_sub_counts(*args, V, section_rows, sub_w))
    d = np.random.RandomState(2).rand(V).astype(np.float32)
    for a, b in zip(j.weight_tables(d, d), t.weight_tables(d, d)):
        np.testing.assert_array_equal(a, b)
    if section_rows < 65_536:
        _same_tables(j.with_idx_dtype(np.uint16),
                     t.with_idx_dtype(np.uint16))


def test_sectioned_plans_and_errors(path):
    """A uniform chunk plan is honoured and a too-small one raises, in
    both packages; ``sectioned_plan`` and the uint16 guard agree."""
    g = _graph()
    V = g.num_nodes
    counts = tell.section_sub_counts(g.row_ptr, g.col_idx, V, V, 100)
    seg, plan = tell.sectioned_plan(counts, seg_rows=64)
    assert (seg, plan) == jell.sectioned_plan(counts, seg_rows=64)
    big = [p + 1 for p in plan]
    _same_tables(jell.sectioned_from_graph(g.row_ptr, g.col_idx, V,
                                           section_rows=100, seg_rows=seg,
                                           chunks_plan=big),
                 tell.sectioned_from_graph(g.row_ptr, g.col_idx, V,
                                           section_rows=100, seg_rows=seg,
                                           chunks_plan=big))
    with pytest.raises(ValueError, match="planned"):
        tell.sectioned_from_graph(g.row_ptr, g.col_idx, V, section_rows=100,
                                  seg_rows=seg, chunks_plan=[0] * len(plan))
    t = tell.sectioned_from_graph(g.row_ptr, g.col_idx, V, src_rows=70_000,
                                  section_rows=70_000)
    with pytest.raises(ValueError, match="does not fit"):
        t.with_idx_dtype(np.uint16)
    assert tell.default_section_rows(True) == jell.default_section_rows(True)
    assert tell.default_section_rows() == jell.default_section_rows()


@pytest.mark.parametrize("seg_rows", [tell.FLAT_SEG_ROWS, 40])
def test_flat_tables_bit_equal(path, seg_rows):
    """The flat tables: one section over every source, global ids."""
    g = _graph()
    _same_tables(jell.flat_sum_from_graph(g.row_ptr, g.col_idx,
                                          g.num_nodes, seg_rows=seg_rows),
                 tell.flat_sum_from_graph(g.row_ptr, g.col_idx,
                                          g.num_nodes, seg_rows=seg_rows))
    assert tell.FLAT_SUM_MIN_EDGES == jell.FLAT_SUM_MIN_EDGES
    assert tell.SECTIONED_MAX_ROWS == jell.SECTIONED_MAX_ROWS


def test_native_counts_the_calls():
    """Every native entry point counts its calls (the card smoke holds
    the planners to having run)."""
    g = _graph()
    before = dict(native.calls)
    tell.sectioned_from_graph(g.row_ptr, g.col_idx, g.num_nodes,
                              section_rows=100)
    for name in ("sectioned_counts", "sectioned_fill"):
        assert native.calls[name] == before.get(name, 0) + 1


# ----------------------------------------------------------- the sums

# fp32 sums in another order: rtol 1e-5, atol 1e-5 * max|value|
def _tol(want):
    return dict(rtol=1e-5, atol=1e-5 * float(np.abs(want).max()))


def _feats(rows, seed=0, relu=False):
    x = np.random.RandomState(seed).randn(rows + 1, F).astype(np.float32)
    if relu:
        x = np.maximum(x, 0)       # ties at 0 for the max's gradient
    x[-1] = 0
    return x


def _vjp_both(jfn, tfn, x, ct):
    """Forward and VJP of the JAX function and the port's on ``x``."""
    jout, vjp = jax.vjp(jfn, jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_(True)
    tout = tfn(tx)
    tgrad, = torch.autograd.grad(tout, tx, torch.from_numpy(ct))
    return (np.asarray(jout), np.asarray(vjp(jnp.asarray(ct))[0]),
            tout.detach().numpy(), tgrad.numpy())


def _t(arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("budget", [1 << 27, 64 * 8 * F])
def test_sectioned_sum_and_vjp(weighted, budget):
    """aggregate_ell_sect (with the baked weights when ``weighted``)
    against the JAX function's forward and VJP; ``budget`` takes one
    chunk a step or every chunk at once."""
    g = _graph()
    V = g.num_nodes
    sect = jell.sectioned_from_graph(g.row_ptr, g.col_idx, V,
                                     section_rows=100, seg_rows=64)
    d = np.random.RandomState(3).rand(V).astype(np.float32)
    w = sect.weight_tables(d, d) if weighted else None
    x = _feats(V)
    ct = np.random.RandomState(4).randn(V, F).astype(np.float32)
    idx, dst, meta = sect.as_jax()
    jw = tuple(jnp.asarray(a) for a in w) if weighted else None
    res = _vjp_both(
        lambda a: jagg.aggregate_ell_sect(a, idx, dst, meta, V, sect_w=jw),
        lambda a: tagg.aggregate_ell_sect(
            a, _t(sect.idx), _t(sect.sub_dst), meta, V,
            sect_w=_t(w) if weighted else None, budget_elems=budget),
        x, ct)
    np.testing.assert_allclose(res[2], res[0], **_tol(res[0]))
    np.testing.assert_allclose(res[3], res[1], **_tol(res[1]))


def test_sectioned_split_and_uint16_sum():
    """The split form and uint16 ids give the block form's sums."""
    g = _graph()
    V = g.num_nodes
    sect = tell.sectioned_from_graph(g.row_ptr, g.col_idx, V,
                                     section_rows=100, seg_rows=64)
    x = torch.from_numpy(_feats(V))
    want = jagg.aggregate_ell_sect_split(jnp.asarray(x.numpy()),
                                         *sect_as_jax(sect), V)
    got = tagg.aggregate_ell_sect_split(x, _t(sect.idx), _t(sect.sub_dst),
                                        sect.meta, V)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **_tol(np.asarray(want)))
    s16 = sect.with_idx_dtype(np.uint16)
    u16 = tagg.aggregate_ell_sect(x, _t(s16.idx), _t(s16.sub_dst),
                                  s16.meta, V)
    blk = tagg.aggregate_ell_sect(x, _t(sect.idx), _t(sect.sub_dst),
                                  sect.meta, V)
    torch.testing.assert_close(u16, blk, rtol=0, atol=0)


def sect_as_jax(sect):
    return (tuple(jnp.asarray(a) for a in sect.idx),
            tuple(jnp.asarray(a) for a in sect.sub_dst), sect.meta)


def test_bf16_sums_round_once():
    """A bf16 sectioned or flat sum is its fp32 sum rounded once (fp32
    accumulation): within one bf16 ulp of each row's magnitude."""
    g = _graph()
    V = g.num_nodes
    sect = tell.sectioned_from_graph(g.row_ptr, g.col_idx, V,
                                     section_rows=100, seg_rows=64)
    flat = tell.flat_sum_from_graph(g.row_ptr, g.col_idx, V, seg_rows=40)
    x = torch.from_numpy(_feats(V)).to(torch.bfloat16)
    for fn in (lambda a: tagg.aggregate_ell_sect(a, _t(sect.idx),
                                                 _t(sect.sub_dst),
                                                 sect.meta, V),
               lambda a: tagg.aggregate_flat_sum(a, *_t(flat.idx),
                                                 *_t(flat.sub_dst), V)):
        got, ref = fn(x), fn(x.float())
        assert got.dtype == torch.bfloat16
        m = ref.abs().amax(dim=1, keepdim=True)
        ulp = torch.ldexp(torch.ones_like(m), torch.frexp(m)[1] - 8)
        assert bool(((got.float() - ref).abs() <= ulp).all())


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("seg_rows,budget", [(40, 1 << 27), (40, 40 * 8 * F),
                                             (8192, 1 << 27)])
def test_flat_sum_and_vjp(weighted, seg_rows, budget):
    """aggregate_flat_sum (and its baked-weight form) against JAX."""
    g = _graph()
    V = g.num_nodes
    flat = jell.flat_sum_from_graph(g.row_ptr, g.col_idx, V,
                                    seg_rows=seg_rows)
    d = np.random.RandomState(3).rand(V).astype(np.float32)
    w = flat.weight_tables(d, d)[0] if weighted else None
    x = _feats(V)
    ct = np.random.RandomState(5).randn(V, F).astype(np.float32)
    res = _vjp_both(
        lambda a: jagg.aggregate_flat_sum(
            a, jnp.asarray(flat.idx[0]), jnp.asarray(flat.sub_dst[0]), V,
            flat_w=None if w is None else jnp.asarray(w)),
        lambda a: tagg.aggregate_flat_sum(
            a, *_t(flat.idx), *_t(flat.sub_dst), V,
            flat_w=None if w is None else torch.from_numpy(w),
            budget_elems=budget),
        x, ct)
    np.testing.assert_allclose(res[2], res[0], **_tol(res[0]))
    np.testing.assert_allclose(res[3], res[1], **_tol(res[1]))


@pytest.mark.parametrize("seg_rows,budget", [(16, 1 << 27), (16, 3 * 16 * 8 * F),
                                             (16, 16 * 8 * F), (8192, 1 << 27)])
def test_flat_max_and_vjp_with_ties(seg_rows, budget):
    """aggregate_flat_max on relu'd features (ties at 0 within and across
    sub-rows and chunks) with empty rows, against the JAX function's
    forward (exact: a max) and its VJP, whose tie shares the port
    reproduces (rtol 1e-6: a share is 1/n in another fp32 order)."""
    V = 300
    g = jgraph.random_csr(V, 2400, seed=6)
    deg = np.diff(g.row_ptr)
    deg[::7] = 0                                   # rows with no neighbour
    row_ptr = np.concatenate([[0], np.cumsum(deg)])
    col = g.col_idx[:row_ptr[-1]]
    flat = jell.flat_sum_from_graph(row_ptr, col, V, seg_rows=seg_rows)
    x = _feats(V, relu=True)
    ct = np.random.RandomState(7).randn(V, F).astype(np.float32)

    def jfn(a):
        out = jagg.aggregate_flat_max(a, jnp.asarray(flat.idx[0]),
                                      jnp.asarray(flat.sub_dst[0]), V)
        return jnp.where(jnp.isfinite(out), out, 0.0)

    def tfn(a):
        out = tagg.aggregate_flat_max(a, *_t(flat.idx), *_t(flat.sub_dst),
                                      V, budget_elems=budget)
        return torch.where(torch.isfinite(out), out, 0.0)

    res = _vjp_both(jfn, tfn, x, ct)
    np.testing.assert_array_equal(res[2], res[0])
    np.testing.assert_allclose(res[3], res[1], rtol=1e-6, atol=1e-6)


# ------------------------------------------------------------ attention


@pytest.mark.parametrize("V,heads,dh", [(10, 1, 16), (1000, 4, 8),
                                        (200_000, 2, 600),
                                        (2_449_029, 1, 256)])
def test_resolve_dh_chunk_matches_jax(V, heads, dh):
    assert tatt.resolve_dh_chunk(V, heads, dh) == \
        jatt.resolve_dh_chunk(V, heads, dh)


@pytest.mark.parametrize("heads,dh_chunk,budget", [(1, None, 1 << 27),
                                                   (2, None, 40 * 8 * 40),
                                                   (2, 2, 1 << 27),
                                                   (1, 5, 3 * 40 * 8 * 40)])
def test_gat_flat8_and_vjp(heads, dh_chunk, budget):
    """gat_aggregate_flat8 against the JAX function: forward and the VJP
    of the features and both score inputs (rtol 1e-5, atol 1e-5 *
    max|value|: fp32 softmax and sums in another order)."""
    V = 300
    g = _graph(V, 3000, seed=8)
    flat = jell.flat_sum_from_graph(g.row_ptr, g.col_idx, V, seg_rows=40)
    rng = np.random.RandomState(9)
    Fh = 6 * heads
    full = rng.randn(V + 1, Fh).astype(np.float32)
    full[-1] = 0
    s = rng.randn(V + 1, heads).astype(np.float32)
    d = rng.randn(V + 1, heads).astype(np.float32)
    ct = rng.randn(V, Fh).astype(np.float32)
    fi, fd = jnp.asarray(flat.idx[0]), jnp.asarray(flat.sub_dst[0])
    jout, vjp = jax.vjp(lambda a, b, c: jatt.gat_aggregate_flat8(
        a, b, c, fi, fd, V, dh_chunk=dh_chunk), jnp.asarray(full),
        jnp.asarray(s), jnp.asarray(d))
    jg = vjp(jnp.asarray(ct))
    ins = [torch.from_numpy(a).requires_grad_(True) for a in (full, s, d)]
    tout = tatt.gat_aggregate_flat8(*ins, *_t(flat.idx), *_t(flat.sub_dst),
                                    V, dh_chunk=dh_chunk,
                                    budget_elems=budget)
    tg = torch.autograd.grad(tout, ins, torch.from_numpy(ct))
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               **_tol(np.asarray(jout)))
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                   **_tol(np.asarray(b)))


def test_gat_flat8_matches_the_ell_form():
    """The flat form and the port's ELL form give one attention (the
    same numerics, another reduction structure)."""
    V = 200
    g = _graph(V, 2000, seed=10)
    flat = tell.flat_sum_from_graph(g.row_ptr, g.col_idx, V, seg_rows=32)
    table = tell.ell_from_graph(g.row_ptr, g.col_idx, V)
    rng = np.random.RandomState(11)
    full = torch.from_numpy(_feats(V, seed=12))
    s = torch.from_numpy(rng.randn(V + 1, 2).astype(np.float32))
    d = torch.from_numpy(rng.randn(V + 1, 2).astype(np.float32))
    a = tatt.gat_aggregate_flat8(full, s, d, *_t(flat.idx),
                                 *_t(flat.sub_dst), V)
    b = tatt.gat_aggregate_ell(full, s, d, _t(a_[0] for a_ in table.idx),
                               _t(r[0] for r in table.row_id),
                               torch.from_numpy(table.row_pos[0]), V)
    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
