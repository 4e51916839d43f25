"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Marked ``cuda``; each test skips where no card is present (the
decision is made in a fixture, never at import).  This file imports
neither JAX nor the JAX package, so it runs on a machine without them:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest
"""

import numpy as np
import pytest
import torch

from roc_tpu_torch.core.ell import ell_from_graph
from roc_tpu_torch.core.graph import from_edge_list, synthetic_dataset
from roc_tpu_torch.kernels import slicing
from roc_tpu_torch.kernels.ell_spmm import ell_aggregate, ell_aggregate_plain
from roc_tpu_torch.kernels.graphnorm import (indegree_norm,
                                             indegree_norm_plain, scale_act,
                                             scale_act_plain)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from roc_tpu_torch.ops.dense import set_fp32_matmul_precision
    set_fp32_matmul_precision()
    return torch.device("cuda")


def _graph(V, avg, seed):
    """Random symmetric-ish graph with a hub wider than 1024, a row of
    degree 0 and an unaligned row count."""
    rng = np.random.RandomState(seed)
    E = V * avg
    src = np.concatenate([rng.randint(0, V, E), rng.randint(0, V, 1500)])
    dst = np.concatenate([rng.randint(0, V, E), np.full(1500, 1)])
    keep = dst != 2
    return from_edge_list(src[keep], dst[keep], V)


ROW_SCALE_FS = [1, 3, 7, 8, 9, 41, 256, 600]


def _same_bits(got, want):
    """Equal bits (a -0.0 is not a 0.0), as integers of the dtype's
    width."""
    as_int = torch.int32 if got.dtype == torch.float32 else torch.int16
    return got.dtype == want.dtype and torch.equal(got.view(as_int),
                                                   want.view(as_int))


def _row_scale_cases(dev, F, dtype):
    """K1, K2 ('none' and 'relu') and the masked K1 against their plain
    versions on the card, bit for bit, and each launched twice for the
    same bits: V = 1,003 rows (V * F a whole number of 16-byte units or
    not, as F gives), degree-0 rows; the masked K1 with NaN/inf in g
    where y <= 0, y == 0 and -0.0 exactly, NaN in y; then V = 0, inputs
    offset by 1 element and by 8 bytes from out's 16-byte phase (loads
    of one element), and K1's entry point on x and out offset alike (a
    scalar head before out's first 16-byte unit).  Returns the wrapper
    launches made, by wrapper."""
    from roc_tpu_torch.kernels import _build
    V = 1_003
    rng = np.random.RandomState(F)
    x = torch.from_numpy(rng.randn(V, F).astype(np.float32)).to(dev, dtype)
    deg = torch.from_numpy(rng.randint(0, 500, V).astype(np.int32))
    deg[:3] = 0
    deg = deg.to(dev)
    s = torch.from_numpy(rng.rand(V).astype(np.float32)).to(dev)
    y = np.maximum(rng.randn(V, F), 0).astype(np.float32).reshape(-1)
    y[0::7] = 0.0
    y[1::7] = -0.0
    y[2::11] = np.nan
    g = rng.randn(V * F).astype(np.float32)
    off = ~(y > 0)
    g[off] = np.array([np.nan, np.inf, -np.inf],
                      np.float32)[np.arange(int(off.sum())) % 3]
    y = torch.from_numpy(y.reshape(V, F)).to(dev, dtype)
    g = torch.from_numpy(g.reshape(V, F)).to(dev, dtype)

    def rows(v, a):
        return v[:a[0].shape[0]]

    cases = [(indegree_norm, lambda a: indegree_norm(a[0], rows(deg, a)),
              lambda a: indegree_norm_plain(a[0], rows(deg, a)), (x,)),
             (indegree_norm,
              lambda a: indegree_norm(a[0], rows(deg, a), relu_out=a[1]),
              lambda a: indegree_norm_plain(a[0], rows(deg, a),
                                            relu_out=a[1]),
              (g, y))]
    for act in ("none", "relu"):
        cases.append((scale_act,
                      lambda a, act=act: scale_act(a[0], rows(s, a), act),
                      lambda a, act=act: scale_act_plain(a[0], rows(s, a),
                                                         act),
                      (x,)))
    n = {indegree_norm: 0, scale_act: 0}
    for wrapper, kern, plain, args in cases:
        got = kern(args)
        assert got.dtype == dtype and got.is_contiguous()
        assert _same_bits(got, plain(args)), (wrapper.__name__, F)
        assert _same_bits(got, kern(args)), (wrapper.__name__, F)
        n[wrapper] += 2
        if len(args) == 2:
            assert bool(got.float().isfinite().all())
        # V = 0
        assert kern(tuple(a[:0] for a in args)).shape == (0, F)
        n[wrapper] += 1
        # inputs off out's 16-byte phase by 1 element and by 8 bytes
        for shift in (1, 8 // x.element_size()):
            view = tuple(a.reshape(-1)[shift:shift + (V - 4) * F]
                         .view(V - 4, F) for a in args)
            assert _same_bits(kern(view), plain(view)), (
                wrapper.__name__, F, shift)
            n[wrapper] += 1
    # the entry point on x and out offset alike: a scalar head
    fn = _build.entry("indegree_norm", dtype)
    for shift in (1, 8 // x.element_size()):
        buf = torch.empty(V * F, device=dev, dtype=dtype)
        out = buf[shift:shift + (V - 4) * F].view(V - 4, F)
        xs = x.reshape(-1)[shift:shift + (V - 4) * F].view(V - 4, F)
        _build.check("indegree_norm", fn(
            xs.data_ptr(), deg.data_ptr(), out.data_ptr(), V - 4, F,
            _build.stream_ptr(dev)))
        assert _same_bits(out, indegree_norm_plain(xs, deg[:V - 4])), (
            F, shift)
    return n


@pytest.mark.parametrize("F", ROW_SCALE_FS)
def test_row_scale_kernels_match_plain(dev, F):
    """K1, K2 and the masked K1 in fp32 are bit-equal to their plain
    versions (same fp32 ops; 0 ulp) at every width, alignment and edge
    case of :func:`_row_scale_cases`; the launches count as fp32, the
    masked ones apart too."""
    n1, n2 = indegree_norm.launches, scale_act.launches
    m = indegree_norm.masked_launches
    n = _row_scale_cases(dev, F, torch.float32)
    torch.cuda.synchronize()
    assert indegree_norm.launches == n1 + n[indegree_norm]
    assert scale_act.launches == n2 + n[scale_act]
    assert indegree_norm.masked_launches == m + 5


@pytest.mark.parametrize("F", [256, 41, 600])
def test_ell_aggregate_kernel_matches_plain(dev, F):
    """K4 against its plain version: rtol=1e-5, atol=1e-5 * max|row|
    (another summation order); degree-0 rows exactly 0."""
    g = _graph(5003, 12, seed=F)
    V = g.num_nodes
    t = ell_from_graph(g.row_ptr, g.col_idx, V)
    assert max(t.widths) >= 2048
    idx = tuple(torch.from_numpy(a[0]).to(dev) for a in t.idx)
    rid = tuple(torch.from_numpy(a[0]).to(dev) for a in t.row_id)
    x = torch.from_numpy(np.random.RandomState(0).randn(V, F)
                         .astype(np.float32)).to(dev)
    n = ell_aggregate.launches
    got = ell_aggregate(x, idx, rid, V)
    torch.cuda.synchronize()
    assert ell_aggregate.launches == n + len(idx)
    want = ell_aggregate_plain(x, idx, rid, V)
    scale = float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * scale)
    assert not got[2].any()


@pytest.mark.parametrize("F", [256, 41, 3])
def test_csr_spmm_kernel_matches_plain(dev, F):
    """K3 against its plain version over the padded edge list: rtol=1e-5,
    atol=1e-5 * max|row| (another summation order); a hub row of 1500
    edges spans several 512-edge chunks, and the degree-0 row is 0."""
    from roc_tpu_torch.core.partition import padded_edge_list
    from roc_tpu_torch.kernels.spmm import csr_spmm, csr_spmm_plain
    g = _graph(5003, 12, seed=F)
    V = g.num_nodes
    src, dst = (torch.from_numpy(a).to(dev)
                for a in padded_edge_list(g, multiple=512))
    x = torch.from_numpy(np.random.RandomState(1).randn(V, F)
                         .astype(np.float32)).to(dev)
    n = csr_spmm.launches
    got = csr_spmm(x, src, dst, V)
    torch.cuda.synchronize()
    assert csr_spmm.launches == n + 1
    want = csr_spmm_plain(x, src, dst, V)
    scale = float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * scale)
    assert not got[2].any()
    # deterministic: no atomics, the same bits every launch
    assert torch.equal(got, csr_spmm(x, src, dst, V))


SLICE_COLS = slicing.SLICE_COLS
SLICE_FS = (1, 3, 4, 36, 37, 41, 64, 256, 600)


@pytest.fixture(scope="module")
def sliced_graph():
    """The ragged graph of the slice tests, on the host: ELL tables and
    the edge list padded to 512 (built once; moved to the card by each
    test)."""
    from roc_tpu_torch.core.partition import padded_edge_list
    g = _graph(3001, 10, seed=11)
    t = ell_from_graph(g.row_ptr, g.col_idx, g.num_nodes)
    return g, t, padded_edge_list(g, multiple=512)


def _check_sliced(got, again, want, x, g):
    """Each slice instance against the plain version (rtol 1e-5, atol
    1e-5 * max|row|), the same bits on a second launch, the degree-0 row
    0 and the 1500-edge hub row against a float64 sum."""
    scale = float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * scale)
    assert torch.equal(got, again)
    assert not got[2].any()
    hub = g.col_idx[g.row_ptr[1]:g.row_ptr[2]]
    assert hub.size >= 1500
    ref = x.double().cpu().numpy()[hub].sum(0)
    np.testing.assert_allclose(got[1].cpu().numpy(), ref, rtol=1e-5,
                               atol=1e-5 * scale)


@pytest.mark.parametrize("S", SLICE_COLS)
@pytest.mark.parametrize("F", SLICE_FS)
def test_ell_aggregate_every_slice_width(dev, sliced_graph, F, S):
    """K4 at every slice width and F, aligned (float4) and not."""
    g, t, _ = sliced_graph
    V = g.num_nodes
    idx = tuple(torch.from_numpy(a[0]).to(dev) for a in t.idx)
    rid = tuple(torch.from_numpy(a[0]).to(dev) for a in t.row_id)
    x = torch.from_numpy(np.random.RandomState(F).randn(V, F)
                         .astype(np.float32)).to(dev)
    n = ell_aggregate.launches
    got = ell_aggregate(x, idx, rid, V, slice_cols=S)
    again = ell_aggregate(x, idx, rid, V, slice_cols=S)
    torch.cuda.synchronize()
    assert ell_aggregate.launches == n + 2 * len(idx)
    _check_sliced(got, again, ell_aggregate_plain(x, idx, rid, V), x, g)


@pytest.mark.parametrize("S", SLICE_COLS)
@pytest.mark.parametrize("F", SLICE_FS)
def test_csr_spmm_every_slice_width(dev, sliced_graph, F, S):
    """K3 at every slice width and F, one main pass and one pre-pass a
    call."""
    from roc_tpu_torch.kernels.spmm import (csr_row_ptr, csr_spmm,
                                            csr_spmm_plain)
    g, _, edges = sliced_graph
    V = g.num_nodes
    src, dst = (torch.from_numpy(a).to(dev) for a in edges)
    x = torch.from_numpy(np.random.RandomState(F + 1).randn(V, F)
                         .astype(np.float32)).to(dev)
    n, p = csr_spmm.launches, csr_row_ptr.launches
    got = csr_spmm(x, src, dst, V, slice_cols=S)
    again = csr_spmm(x, src, dst, V, slice_cols=S)
    torch.cuda.synchronize()
    assert (csr_spmm.launches, csr_row_ptr.launches) == (n + 2, p + 2)
    _check_sliced(got, again, csr_spmm_plain(x, src, dst, V), x, g)


@pytest.mark.parametrize("S", SLICE_COLS)
def test_unaligned_feats_take_the_scalar_path(dev, sliced_graph, S):
    """A feats view that starts 4 bytes off a 16-byte boundary at F = 256
    runs the float (not float4) path of both kernels, and agrees."""
    from roc_tpu_torch.kernels.spmm import csr_spmm, csr_spmm_plain
    g, t, edges = sliced_graph
    V, F = g.num_nodes, 256
    base = torch.from_numpy(np.random.RandomState(5).randn(V * F + 1)
                            .astype(np.float32)).to(dev)
    x = base[1:].view(V, F)
    assert x.data_ptr() % 16 and x.is_contiguous()
    idx = tuple(torch.from_numpy(a[0]).to(dev) for a in t.idx)
    rid = tuple(torch.from_numpy(a[0]).to(dev) for a in t.row_id)
    _check_sliced(ell_aggregate(x, idx, rid, V, slice_cols=S),
                  ell_aggregate(x, idx, rid, V, slice_cols=S),
                  ell_aggregate_plain(x, idx, rid, V), x, g)
    src, dst = (torch.from_numpy(a).to(dev) for a in edges)
    _check_sliced(csr_spmm(x, src, dst, V, slice_cols=S),
                  csr_spmm(x, src, dst, V, slice_cols=S),
                  csr_spmm_plain(x, src, dst, V), x, g)


def test_csr_row_ptr_prepass(dev, sliced_graph):
    """K3's pre-pass equals the graph's row_ptr, except the padded tail:
    the padding edges sit on the last row, whose range ends at Ep; and
    it equals its plain version (torch.searchsorted) on the card."""
    from roc_tpu_torch.kernels.spmm import csr_row_ptr, csr_row_ptr_plain
    g, _, (_, dst_np) = sliced_graph
    V = g.num_nodes
    dst = torch.from_numpy(dst_np).to(dev)
    assert dst.numel() > g.num_edges
    n = csr_row_ptr.launches
    got = csr_row_ptr(dst, V)
    torch.cuda.synchronize()
    assert csr_row_ptr.launches == n + 1
    want = g.row_ptr.copy()
    want[-1] = dst.numel()
    np.testing.assert_array_equal(got.cpu().numpy(), want)
    assert torch.equal(got, csr_row_ptr_plain(dst, V))


def test_default_slice_width_runs_on_the_card(dev, sliced_graph):
    """The wrappers' default is one of the compiled instances, and a
    call without the keyword equals a call with it, bit for bit."""
    from roc_tpu_torch.kernels import ell_spmm, spmm
    g, t, edges = sliced_graph
    V = g.num_nodes
    idx = tuple(torch.from_numpy(a[0]).to(dev) for a in t.idx)
    rid = tuple(torch.from_numpy(a[0]).to(dev) for a in t.row_id)
    src, dst = (torch.from_numpy(a).to(dev) for a in edges)
    for F in (41, 256):
        x = torch.randn((V, F), device=dev)
        assert torch.equal(
            ell_aggregate(x, idx, rid, V),
            ell_aggregate(x, idx, rid, V,
                          slice_cols=ell_spmm.default_slice_cols(F)))
        assert torch.equal(
            spmm.csr_spmm(x, src, dst, V),
            spmm.csr_spmm(x, src, dst, V,
                          slice_cols=spmm.default_slice_cols(F)))
    with pytest.raises(ValueError):
        ell_aggregate(x, idx, rid, V, slice_cols=8)


@pytest.mark.parametrize("impl,plain", [("cuda", "ell"),
                                        ("cuda_csr", "segment")])
def test_training_step_kernel_route_matches_plain(dev, impl, plain):
    """One training step of the 24-16-5 GCN (dropout 0) on a kernel route
    against the plain route on the card: the objective within rtol 1e-5,
    every gradient within rtol 1e-4 / atol 1e-6 * max|grad| (fp32 sums in
    another order, through forward and backward); the step launches the
    route's kernels in the backward too."""
    from roc_tpu_torch.kernels.spmm import csr_spmm
    from roc_tpu_torch.models.gcn import build_gcn
    from roc_tpu_torch.train.trainer import TrainConfig, Trainer
    ds = synthetic_dataset(3001, 20, in_dim=24, num_classes=5, seed=0)
    params = build_gcn([24, 16, 5]).init_params(
        torch.Generator(device=dev).manual_seed(0), device=dev)
    out = {}
    for route in (impl, plain):
        tr = Trainer(build_gcn([24, 16, 5], dropout_rate=0.0), ds,
                     TrainConfig(aggr_impl=route, symmetric=True),
                     params=params)
        loss, _ = tr.model.loss_fn(tr.params, tr.feats, tr.labels,
                                   tr.mask, tr.gctx)
        names = sorted(tr.params)
        grads = torch.autograd.grad(loss, [tr.params[k] for k in names])
        out[route] = (loss, dict(zip(names, grads)))
        if route == impl:
            agg = ell_aggregate if impl == "cuda" else csr_spmm
            counts = (indegree_norm.launches, scale_act.launches,
                      agg.launches)
            tr.step(0.01)
            torch.cuda.synchronize()
            # two fused layers, each run once forward and once backward
            # (on the cotangent)
            assert indegree_norm.launches - counts[0] == 4
            assert scale_act.launches - counts[1] == 4
            assert agg.launches > counts[2]
    (lk, gk), (lp, gp) = out[impl], out[plain]
    torch.testing.assert_close(lk, lp, rtol=1e-5, atol=0)
    for k in gp:
        scale = float(gp[k].abs().max())
        torch.testing.assert_close(gk[k], gp[k], rtol=1e-4,
                                   atol=1e-6 * scale)


def test_kernels_reject_what_they_do_not_take(dev):
    x = torch.ones(8, 4, device=dev, dtype=torch.float64)
    with pytest.raises(TypeError):
        indegree_norm(x, torch.ones(8, dtype=torch.int32, device=dev))
    with pytest.raises(TypeError):
        indegree_norm(x.float(), torch.ones(8, dtype=torch.int64,
                                            device=dev))
    with pytest.raises(ValueError):
        scale_act(x.float().t(), torch.ones(4, device=dev))
    # the masked K1's relu_out: like x, and contiguous
    g = torch.ones(8, 4, device=dev)
    deg = torch.ones(8, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        indegree_norm(g, deg, relu_out=g.to(torch.bfloat16))
    with pytest.raises(ValueError):
        indegree_norm(g, deg, relu_out=torch.ones(8, 8, device=dev)[:, :4])


def test_served_logits_cuda_route_match_plain_route(dev):
    """The 24-16-5 GCN served on the card: the kernel route equals the
    plain 'ell' route on the card within 1e-4, and every kernel ran."""
    from roc_tpu_torch.models.gcn import build_gcn
    from roc_tpu_torch.serve.export import build_predictor
    from roc_tpu_torch.serve.server import Server
    from roc_tpu_torch.train.trainer import TrainConfig
    ds = synthetic_dataset(3001, 20, in_dim=24, num_classes=5, seed=0)
    gen = torch.Generator(device=dev).manual_seed(0)
    model = build_gcn([24, 16, 5])
    params = model.init_params(gen, device=dev)
    preds = {impl: build_predictor(model, ds, TrainConfig(aggr_impl=impl),
                                   params=params, backend="full")
             for impl in ("cuda", "ell")}
    counts = (indegree_norm.launches, scale_act.launches,
              ell_aggregate.launches)
    ids = np.arange(ds.graph.num_nodes)
    got = preds["cuda"].query(ids)
    want = preds["ell"].query(ids)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert all(c1 > c0 for c0, c1 in zip(counts, (
        indegree_norm.launches, scale_act.launches, ell_aggregate.launches)))
    with Server(preds["cuda"], max_wait_ms=1.0) as srv:
        futs = [srv.submit(ids[i:i + 7]) for i in range(0, 70, 7)]
        for i, f in zip(range(0, 70, 7), futs):
            assert np.array_equal(f.result(timeout=60), got[i:i + 7])


# ------------------------------------------------------------------ bf16


def bf16_row_ulp(want):
    """One bf16 ulp of each row's magnitude max|row| (0 for a zero row),
    as a [rows, 1] fp32 tolerance: a bf16 sum is its fp32 sum rounded
    once, and two fp32 sums a few fp32 ulps apart (another order) round
    to the same bf16 value or to neighbours."""
    m = want.float().abs().amax(dim=1, keepdim=True)
    _, e = torch.frexp(m)
    return torch.where(m > 0, torch.ldexp(torch.ones_like(m), e - 8),
                       torch.zeros_like(m))


def _check_bf16_sum(got, again, want):
    assert got.dtype == want.dtype == torch.bfloat16
    assert torch.equal(got, again)
    err = (got.float() - want.float()).abs()
    assert bool((err <= bf16_row_ulp(want)).all()), float(err.max())


@pytest.mark.parametrize("F", ROW_SCALE_FS)
def test_row_scale_kernels_bf16_bit_equal(dev, F):
    """K1, K2 and the masked K1 in bf16 are bit-equal to their plain
    versions (fp32 math, one rounding to bf16, 0 ulp) at every width,
    alignment and edge case of :func:`_row_scale_cases`; the launches
    count as bf16."""
    n1 = dict(indegree_norm.launches_by_dtype)
    n2 = dict(scale_act.launches_by_dtype)
    n = _row_scale_cases(dev, F, torch.bfloat16)
    torch.cuda.synchronize()
    assert indegree_norm.launches_by_dtype == {
        "f32": n1["f32"], "bf16": n1["bf16"] + n[indegree_norm]}
    assert scale_act.launches_by_dtype == {
        "f32": n2["f32"], "bf16": n2["bf16"] + n[scale_act]}


@pytest.mark.parametrize("S", SLICE_COLS)
@pytest.mark.parametrize("F", [1, 8, 36, 41, 256, 600])
def test_bf16_neighbour_sums_every_slice_width(dev, sliced_graph, F, S):
    """K4 and K3 in bf16 at every slice width: within one bf16 ulp of the
    row's magnitude of their plain versions (fp32 sums rounded once), the
    same bits on two launches, the degree-0 row 0."""
    from roc_tpu_torch.kernels.spmm import csr_spmm, csr_spmm_plain
    g, t, edges = sliced_graph
    V = g.num_nodes
    idx = tuple(torch.from_numpy(a[0]).to(dev) for a in t.idx)
    rid = tuple(torch.from_numpy(a[0]).to(dev) for a in t.row_id)
    src, dst = (torch.from_numpy(a).to(dev) for a in edges)
    x = torch.from_numpy(np.random.RandomState(F + 2).randn(V, F)
                         .astype(np.float32)).to(dev, torch.bfloat16)
    n4 = ell_aggregate.launches_by_dtype["bf16"]
    n3 = csr_spmm.launches_by_dtype["bf16"]
    _check_bf16_sum(ell_aggregate(x, idx, rid, V, slice_cols=S),
                    ell_aggregate(x, idx, rid, V, slice_cols=S),
                    ell_aggregate_plain(x, idx, rid, V))
    _check_bf16_sum(csr_spmm(x, src, dst, V, slice_cols=S),
                    csr_spmm(x, src, dst, V, slice_cols=S),
                    csr_spmm_plain(x, src, dst, V))
    torch.cuda.synchronize()
    assert ell_aggregate.launches_by_dtype["bf16"] == n4 + 2 * len(idx)
    assert csr_spmm.launches_by_dtype["bf16"] == n3 + 2
    assert not ell_aggregate(x, idx, rid, V, slice_cols=S)[2].any()


@pytest.mark.parametrize("S", SLICE_COLS)
def test_bf16_unaligned_feats_take_the_element_path(dev, sliced_graph, S):
    """A bf16 feats view 2 bytes off a 16-byte boundary at F = 256 runs
    the element (not 16-byte) path of K3 and K4, and agrees."""
    from roc_tpu_torch.kernels.spmm import csr_spmm, csr_spmm_plain
    g, t, edges = sliced_graph
    V, F = g.num_nodes, 256
    base = torch.from_numpy(np.random.RandomState(6).randn(V * F + 1)
                            .astype(np.float32)).to(dev, torch.bfloat16)
    x = base[1:].view(V, F)
    assert x.data_ptr() % 16 and x.is_contiguous()
    idx = tuple(torch.from_numpy(a[0]).to(dev) for a in t.idx)
    rid = tuple(torch.from_numpy(a[0]).to(dev) for a in t.row_id)
    src, dst = (torch.from_numpy(a).to(dev) for a in edges)
    _check_bf16_sum(ell_aggregate(x, idx, rid, V, slice_cols=S),
                    ell_aggregate(x, idx, rid, V, slice_cols=S),
                    ell_aggregate_plain(x, idx, rid, V))
    _check_bf16_sum(csr_spmm(x, src, dst, V, slice_cols=S),
                    csr_spmm(x, src, dst, V, slice_cols=S),
                    csr_spmm_plain(x, src, dst, V))


def test_kernels_refuse_other_float_types(dev, sliced_graph):
    """Only float32 and bfloat16 have instances: float16 and float64 are
    refused on the card, before anything launches."""
    from roc_tpu_torch.kernels.spmm import csr_spmm
    g, t, edges = sliced_graph
    V = g.num_nodes
    idx = tuple(torch.from_numpy(a[0]).to(dev) for a in t.idx)
    rid = tuple(torch.from_numpy(a[0]).to(dev) for a in t.row_id)
    src, dst = (torch.from_numpy(a).to(dev) for a in edges)
    deg = torch.ones(V, dtype=torch.int32, device=dev)
    for dt in (torch.float16, torch.float64):
        x = torch.ones(V, 8, device=dev, dtype=dt)
        n = (indegree_norm.launches, scale_act.launches,
             ell_aggregate.launches, csr_spmm.launches)
        for call in (lambda: indegree_norm(x, deg),
                     lambda: scale_act(x, torch.ones(V, device=dev)),
                     lambda: ell_aggregate(x, idx, rid, V),
                     lambda: csr_spmm(x, src, dst, V)):
            with pytest.raises(TypeError, match="float32 or bfloat16"):
                call()
        assert n == (indegree_norm.launches, scale_act.launches,
                     ell_aggregate.launches, csr_spmm.launches)


@pytest.mark.parametrize("impl", ["cuda", "cuda_csr"])
def test_mixed_training_step_on_the_card(dev, impl):
    """One mixed-precision step of the 24-16-5 GCN (dropout 0) on a kernel
    route: the objective within rtol 1e-2 of the same route on the CPU
    (the kernels' plain versions; bf16 activations round at other places
    in cuBLAS's and the CPU's bf16 products, rel. 2^-9 each, through two
    layers); the bf16 kernels ran forward and backward, and the master
    weights and the Adam moments stay fp32."""
    from roc_tpu_torch.kernels.spmm import csr_spmm
    from roc_tpu_torch.models.gcn import build_gcn
    from roc_tpu_torch.train.trainer import (TrainConfig, Trainer,
                                             resolve_dtypes)
    ds = synthetic_dataset(3001, 20, in_dim=24, num_classes=5, seed=0)
    params = build_gcn([24, 16, 5]).init_params(
        torch.Generator().manual_seed(0))
    dtype, compute = resolve_dtypes("mixed")
    losses = {}
    for device in ("cpu", dev):
        tr = Trainer(build_gcn([24, 16, 5], dropout_rate=0.0), ds,
                     TrainConfig(aggr_impl=impl, symmetric=True, dtype=dtype,
                                 compute_dtype=compute),
                     params=params, device=device)
        assert tr.feats.dtype == torch.bfloat16
        agg = ell_aggregate if impl == "cuda" else csr_spmm
        n = (indegree_norm.launches_by_dtype["bf16"],
             scale_act.launches_by_dtype["bf16"],
             agg.launches_by_dtype["bf16"])
        losses[str(device)] = float(tr.step(0.01))
        if device != "cpu":
            torch.cuda.synchronize()
            assert indegree_norm.launches_by_dtype["bf16"] - n[0] == 4
            assert scale_act.launches_by_dtype["bf16"] - n[1] == 4
            assert agg.launches_by_dtype["bf16"] > n[2]
        assert all(p.dtype == torch.float32 for p in tr.params.values())
        assert all(m.dtype == torch.float32 for m in tr.opt_state.m.values())
    assert losses["cuda"] == pytest.approx(losses["cpu"], rel=1e-2)


def test_served_logits_mixed_cuda_route(dev):
    """The 24-16-5 GCN served in mixed on the card: the kernel route
    within 3e-2 * max|logit| of the plain 'ell' route in mixed (bf16
    activations rounded at other places: K1 scales by the fp32 d, the
    plain route by d rounded to bf16), fp32 logits out, and coalesced
    rows the same bits as rows served alone."""
    from roc_tpu_torch.models.gcn import build_gcn
    from roc_tpu_torch.serve.export import build_predictor
    from roc_tpu_torch.serve.server import Server
    from roc_tpu_torch.train.trainer import TrainConfig, resolve_dtypes
    ds = synthetic_dataset(3001, 20, in_dim=24, num_classes=5, seed=0)
    model = build_gcn([24, 16, 5])
    params = model.init_params(torch.Generator(device=dev).manual_seed(0),
                               device=dev)
    dtype, compute = resolve_dtypes("mixed")
    preds = {impl: build_predictor(
        model, ds, TrainConfig(aggr_impl=impl, dtype=dtype,
                               compute_dtype=compute),
        params=params, backend="full") for impl in ("cuda", "ell")}
    n = ell_aggregate.launches_by_dtype["bf16"]
    ids = np.arange(ds.graph.num_nodes)
    got = preds["cuda"].query(ids)
    want = preds["ell"].query(ids)
    assert got.dtype == np.float32
    assert ell_aggregate.launches_by_dtype["bf16"] > n
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=3e-2 * float(np.abs(want).max()))
    with Server(preds["cuda"], max_wait_ms=1.0) as srv:
        futs = [srv.submit(ids[i:i + 7]) for i in range(0, 70, 7)]
        for i, f in zip(range(0, 70, 7), futs):
            assert np.array_equal(f.result(timeout=60), got[i:i + 7])


# ------------------------------------------------ the padded-part layout


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("F", [256, 41])
def test_neighbour_sums_on_gathered_parts(dev, F, dtype):
    """K4 and K3 as a rank of a partitioned run calls them: R = P *
    part_nodes gathered source rows, part_nodes output rows, the dummy id
    R skipped, part-local tables (parallel/distributed.py shard_dataset).
    P = 8 on a graph whose hub takes most edges, so the sweep leaves
    empty tail parts: a part with no real row gets only padding edges and
    must come out 0.  Against the plain versions, in both dtypes (fp32
    rtol 1e-5, atol 1e-5 * max|row|; bf16 one bf16 ulp of the row's
    magnitude), each launched twice for the same bits."""
    from roc_tpu_torch.core.graph import Dataset
    from roc_tpu_torch.core.partition import partition_plan
    from roc_tpu_torch.kernels.spmm import csr_spmm, csr_spmm_plain
    from roc_tpu_torch.parallel.distributed import shard_dataset
    V, P = 2001, 8
    rng = np.random.RandomState(13)
    # self edges, every vertex into the hub 0, one random edge each
    src = np.concatenate([np.arange(V), np.arange(V), rng.randint(0, V, V)])
    dst = np.concatenate([np.arange(V), np.zeros(V, np.int64),
                          rng.randint(0, V, V)])
    g = from_edge_list(src, dst, V)
    plan = partition_plan(g.row_ptr, P, edge_multiple=512)
    assert plan.real_nodes[0] == 1 and plan.real_nodes[-1] == 0
    ds = Dataset(g, np.zeros((V, 1), np.float32), np.zeros(V, np.int32),
                 np.zeros(V, np.int32), 2)
    R, pn = P * plan.part_nodes, plan.part_nodes
    x = torch.from_numpy(np.random.RandomState(F).randn(R, F).astype(
        np.float32)).to(dev, dtype)
    for p in range(P):
        ell = shard_dataset(ds, plan, p, dev, aggr_impl="cuda")
        edges = shard_dataset(ds, plan, p, dev, aggr_impl="cuda_csr")
        for kern, plain in (
                (lambda: ell_aggregate(x, ell.ell_idx, ell.ell_row_id, pn),
                 ell_aggregate_plain(x, ell.ell_idx, ell.ell_row_id, pn)),
                (lambda: csr_spmm(x, edges.edge_src, edges.edge_dst, pn),
                 csr_spmm_plain(x, edges.edge_src, edges.edge_dst, pn))):
            got = kern()
            assert got.shape == (pn, F)
            if dtype == torch.bfloat16:
                _check_bf16_sum(got, kern(), plain)
            else:
                torch.testing.assert_close(
                    got, plain, rtol=1e-5,
                    atol=1e-5 * float(plain.abs().max()))
                assert torch.equal(got, kern())
            if plan.real_nodes[p] == 0:
                assert not got.any()


def test_world_of_one_nccl_trainer_matches_trainer(dev, tmp_path):
    """DistributedTrainer over NCCL at world size 1 (the all-gathers and
    the all-reduce still run) against Trainer on the small fixture of the
    CPU tests, on 'cuda' and 'cuda_csr': dropout 0.5 and no weights
    given, so both draw the same weights and masks (chunk 2 divides
    E = 614: no padding row, the part is the graph), 8 epochs; the
    objectives within rtol 1e-5 (the all-reduce may sum in another
    order than none) and the weights within the CPU tests' 2e-4 / 2e-5."""
    import torch.distributed as dist
    from roc_tpu_torch.models.gcn import build_gcn
    from roc_tpu_torch.parallel.distributed import DistributedTrainer
    from roc_tpu_torch.train.trainer import TrainConfig, Trainer
    ds = synthetic_dataset(96, 7, in_dim=12, num_classes=3, seed=11)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        for impl in ("cuda", "cuda_csr"):
            cfg = TrainConfig(aggr_impl=impl, dropout_rate=0.5, epochs=8,
                              eval_every=4, verbose=False, chunk=2,
                              weight_decay=1e-3, symmetric=True)
            a = Trainer(build_gcn([12, 16, 3], dropout_rate=0.5), ds, cfg)
            b = DistributedTrainer(build_gcn([12, 16, 3], dropout_rate=0.5),
                                   ds, 1, cfg)
            assert b.comm.backend == "nccl"
            ha, hb = a.train(), b.train()
            torch.testing.assert_close(torch.stack(b.losses),
                                       torch.stack(a.losses), rtol=1e-5,
                                       atol=0)
            assert [m["train_cnt"] for m in ha] == \
                [m["train_cnt"] for m in hb]
            for k in a.params:
                torch.testing.assert_close(b.params[k], a.params[k],
                                           rtol=2e-4, atol=2e-5)
            torch.testing.assert_close(b.predict(), a.predict(), rtol=0,
                                       atol=1e-4 * float(
                                           a.predict().abs().max()))
    finally:
        dist.destroy_process_group()


def test_precomputed_akx_on_the_card_matches_the_cpu(dev):
    """The 'akx' predictor of an SGC (k = 2) built on the card (its
    prefix through the blocked host walk, each tile's sum on K3) serves within 1e-4 * max|logit| of the
    same predictor built on the CPU (the kernels' plain versions) from
    the same weights; an int8 table (the card's host table, quantized
    once: a table an ulp apart could round a code the other way) gathers
    and dequantizes on the card to the CPU's values within the same
    tolerance, and the pad row of a padded bucket stays out of the
    result."""
    from roc_tpu_torch.kernels import spmm
    from roc_tpu_torch.models.sgc import build_sgc
    from roc_tpu_torch.serve.export import build_predictor
    from roc_tpu_torch.train.trainer import TrainConfig
    ds = synthetic_dataset(300, 6, in_dim=24, num_classes=5, seed=0)
    params = build_sgc([24, 5], k=2).init_params(
        torch.Generator().manual_seed(1))
    ids = np.arange(300)
    cache = None
    for quant in ("off", "int8"):
        before = spmm.csr_spmm.launches
        got = build_predictor(build_sgc([24, 5], k=2), ds, TrainConfig(),
                              params=params, quant=quant, cache=cache)
        assert got.flavor == "akx" and got.device.type == "cuda"
        assert (spmm.csr_spmm.launches > before) == (cache is None)
        want = build_predictor(build_sgc([24, 5], k=2), ds, TrainConfig(),
                               params=params, quant=quant, device="cpu",
                               cache=cache)
        cache = got.cache
        assert got.published().table.dtype == want.published().table.dtype
        a, b = got.query(ids), want.query(ids)
        assert np.abs(a - b).max() <= 1e-4 * max(1.0, np.abs(b).max())
        sub = got.query([7, 123, 250])
        assert sub.shape == (3, 5)
        assert np.abs(sub - b[[7, 123, 250]]).max() <= \
            1e-4 * max(1.0, np.abs(b).max())


# ------------------------------------------------- the out-of-core tier


def test_staging_pool_stages_through_pinned_buffers_on_a_copy_stream(dev):
    """A pageable source goes through the pinned ring, a pinned one is
    copied from directly; both on the pool's copy stream (not the
    consumer's), each block the source's rows, with the copies' bytes
    and device time in the stats."""
    from roc_tpu_torch.core.streaming import StagingPool, _stage_fns
    rng = np.random.RandomState(0)
    X = rng.randn(1000, 24).astype(np.float32)
    for depth in (0, 1, 2):
        pool = StagingPool(depth=depth, device=dev)
        ranges = [(lo, lo + 128) for lo in range(0, 1000, 128)]
        got = [b.clone() for b in pool.stream(_stage_fns(
            pool, torch.from_numpy(X), ranges))]
        assert all(b.device.type == "cuda" for b in got)
        assert torch.equal(torch.cat(got).cpu(), torch.from_numpy(X))
        st = pool.stager
        assert st.ring_copies == len(ranges) and st.direct_copies == 0
        assert all(b is None or b.is_pinned() for b in st.slots)
        assert st.stream != torch.cuda.current_stream(dev)
        stats = pool.take_stats()
        assert stats["h2d_bytes"] == X.nbytes and stats["h2d_gbps"] > 0
        assert pool.max_live <= depth + 1
    pinned = torch.from_numpy(X).pin_memory()
    pool = StagingPool(depth=1, device=dev)
    got = torch.cat([b.clone() for b in pool.stream(_stage_fns(
        pool, pinned, [(0, 500), (500, 1000)]))])
    assert pool.stager.direct_copies == 2 and torch.equal(got.cpu(), pinned)


def test_streamed_head_on_the_card_matches_the_cpu(dev):
    """Forward (eval) and wgrad on the card against the CPU's (fp32
    products in another order: rtol 1e-5); with masks, prefetch 1 gives
    prefetch 0's bits on the card."""
    from roc_tpu_torch.core.streaming import StreamedHead
    rng = np.random.RandomState(1)
    X = rng.randn(330, 24).astype(np.float32)
    W = torch.from_numpy(rng.randn(24, 8).astype(np.float32))
    dY = torch.from_numpy(rng.randn(330, 8).astype(np.float32))
    cpu = StreamedHead(0.4, block_rows=64, device="cpu")
    want = (cpu.forward(W, X, None, False), cpu.wgrad(X, dY, None, False))
    runs = {}
    for depth in (0, 1):
        head = StreamedHead(0.4, block_rows=64, prefetch=depth, device=dev)
        got = (head.forward(W.to(dev), X, None, False),
               head.wgrad(X, dY.to(dev), None, False))
        for g, w in zip(got, want):
            torch.testing.assert_close(g.cpu(), w, rtol=1e-5, atol=1e-5)
        runs[depth] = (head.forward(W.to(dev), X, 7, True),
                       head.wgrad(X, dY.to(dev), 7, True))
    assert all(torch.equal(a, b) for a, b in zip(runs[0], runs[1]))


def test_aggregate_to_host_on_the_card_runs_k3(dev):
    """The blocked walk's sums on the card (every tile chunk a K3 launch)
    against the CPU's plain version, within rtol 1e-5."""
    from roc_tpu_torch.core.streaming import aggregate_to_host
    from roc_tpu_torch.kernels import spmm
    ds = synthetic_dataset(700, 9, in_dim=24, num_classes=5, seed=2)
    x = np.random.RandomState(3).randn(700, 41).astype(np.float32)
    want = aggregate_to_host(ds.graph, x, block_rows=128, edge_chunk=1000,
                             device="cpu")
    before = spmm.csr_spmm.launches
    got = aggregate_to_host(ds.graph, x, block_rows=128, edge_chunk=1000,
                            device=dev)
    assert spmm.csr_spmm.launches > before
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))


@pytest.mark.parametrize("impl", ["cuda", "cuda_csr"])
def test_host_tier_and_remat_train_on_the_card(dev, impl):
    """On the card: the host tier's 3 steps at dropout 0 within rtol 1e-4
    of the device-resident run; remat (both policies) and prefetch 0 on
    the host tier at dropout 0.5 end on the plain runs' bits."""
    from roc_tpu_torch.models.gcn import build_gcn
    from roc_tpu_torch.train.trainer import TrainConfig, Trainer
    ds = synthetic_dataset(500, 8, in_dim=24, num_classes=5, seed=4)

    def run(dropout, **kw):
        tr = Trainer(build_gcn([24, 16, 5], dropout_rate=dropout), ds,
                     TrainConfig(aggr_impl=impl, epochs=3, verbose=False,
                                 eval_every=1 << 30, symmetric=True,
                                 chunk=64, **kw), device=dev)
        tr.train()
        return tr.params

    a, b = run(0.0), run(0.0, features="host")
    for k in a:
        torch.testing.assert_close(b[k], a[k], rtol=1e-4, atol=1e-5)
    for base, variants in (({}, [dict(remat=True),
                                 dict(remat=True, remat_policy="full")]),
                           (dict(features="host"), [dict(features="host",
                                                         prefetch=0)])):
        want = run(0.5, **base)
        for kw in variants:
            got = run(0.5, **kw)
            assert all(torch.equal(got[k], want[k]) for k in want), kw


@pytest.mark.parametrize("F", [256, 41])
def test_csr_spmm_precomputed_row_ptr_reads_no_padding(dev, F):
    """K3 with row ranges built on the host (the ring's pairs): no
    pre-pass launch, and edges past the ranges are never read.  The
    padding here sources row 0, a real row, so a kernel that read it
    would add x[0] to the last row; the result equals the plain sum of
    the real edges alone (rtol 1e-5, atol 1e-5 * max|row|)."""
    from roc_tpu_torch.kernels.spmm import (csr_row_ptr, csr_spmm,
                                            csr_spmm_plain)
    g = _graph(3001, 9, seed=F)
    V, E = g.num_nodes, g.num_edges
    pad = 5000 + (-(E + 5000)) % 8
    src_np = np.concatenate([g.col_idx, np.zeros(pad, np.int32)])
    dst_np = np.concatenate([g.edge_dst(), np.full(pad, V - 1, np.int32)])
    src, dst = (torch.from_numpy(a.astype(np.int32)).to(dev)
                for a in (src_np, dst_np))
    row_ptr = torch.from_numpy(g.row_ptr.astype(np.int64)).to(dev)
    x = torch.from_numpy(np.random.RandomState(2).randn(V, F)
                         .astype(np.float32)).to(dev)
    n, n_pre = csr_spmm.launches, csr_row_ptr.launches
    got = csr_spmm(x, src, dst, V, chunk=8, row_ptr=row_ptr)
    torch.cuda.synchronize()
    assert (csr_spmm.launches, csr_row_ptr.launches) == (n + 1, n_pre)
    want = csr_spmm_plain(x, src[:E], dst[:E], V)
    torch.testing.assert_close(got, want, rtol=1e-5,
                               atol=1e-5 * float(want.abs().max()))
    with_pad = csr_spmm(x, src, dst, V, chunk=8)
    assert not torch.allclose(with_pad[V - 1], want[V - 1])
    with pytest.raises(ValueError, match="row_ptr"):
        csr_spmm(x, src, dst, V, chunk=8, row_ptr=row_ptr[:-1])


@pytest.mark.parametrize("mode", ["float32", "mixed"])
def test_ring_hops_on_the_card_match_the_gather(dev, mode):
    """Two gloo ranks on this card (NCCL takes one rank per card; gloo
    stages each hop's buffer through pinned host memory), the GCN of the
    CPU tests on 'cuda' with halo='ring' against halo='gather' from the
    same weights, 4 epochs at dropout 0: the objectives within rtol 1e-5
    in fp32 and 2e-3 in 'mixed' (tests/test_torch_ring.py's), K3 at every
    hop (hops x aggregations: 2 x (2 forward + 2 backward + 2 eval) an
    epoch), none of its pre-passes, K1, the masked K1 and K2 around it;
    the gather's route runs K4 and no K3."""
    from roc_tpu_torch.models.gcn import build_gcn
    from roc_tpu_torch.parallel.distributed import run_ranks
    from roc_tpu_torch.train.trainer import TrainConfig, resolve_dtypes
    import torch_rank_jobs
    ds = synthetic_dataset(96, 7, in_dim=12, num_classes=3, seed=11)
    p0 = build_gcn([12, 16, 3]).init_params(torch.Generator().manual_seed(5))
    p0 = {k: v.detach().clone() for k, v in p0.items()}
    dtype, compute = resolve_dtypes(mode)
    runs = [dict(model=build_gcn([12, 16, 3], dropout_rate=0.0), dataset=ds,
                 params=p0, config=TrainConfig(
                     aggr_impl="cuda", halo=halo, dropout_rate=0.0, epochs=4,
                     eval_every=1, verbose=False, chunk=64, symmetric=True,
                     dtype=dtype, compute_dtype=compute))
            for halo in ("ring", "gather")]
    res = run_ranks(torch_rank_jobs.job, 2, runs=runs, device="cuda:0")
    rtol = 1e-5 if mode == "float32" else 2e-3
    for ring, gather in res:
        torch.testing.assert_close(torch.from_numpy(ring["losses"]),
                                   torch.from_numpy(gather["losses"]),
                                   rtol=rtol, atol=0)
        n = ring["launches"]
        assert n["csr_spmm"] == 2 * 6 * 4 and n["csr_row_ptr"] == 0
        assert n["ell_aggregate"] == 0 and n["indegree_norm_masked"] > 0
        assert n["indegree_norm"] > 0 and n["scale_act"] > 0
        assert gather["launches"]["csr_spmm"] == 0 and \
            gather["launches"]["ell_aggregate"] > 0
        rt = ring["ring"]
        for s in range(2):
            assert rt["row_ptr"][s, -1] == rt["real"][s]


@pytest.mark.parametrize("halo", ["gather", "ring"])
def test_mesh_2x2_step_on_the_card_matches_1d(dev, halo):
    """Four gloo ranks on this card: the GCN of the CPU tests on 'cuda'
    on the (parts, model) mesh 2x2 against the 1-D run of 2 parts (two
    subgroups of two ranks each running it), 3 epochs at dropout 0 from
    the same weights: the objectives within the contract's rtol 1e-5
    (bit-equal expected: the same sums in the same order), the params
    and Adam moments sharded at rest (each rank half of every leaf), and
    K1, the masked K1, K2 and K4 (gather) or K3 at every hop (ring)
    launched on every rank."""
    from roc_tpu_torch.models.gcn import build_gcn
    from roc_tpu_torch.parallel.distributed import run_ranks
    from roc_tpu_torch.train.trainer import TrainConfig
    import torch_rank_jobs
    ds = synthetic_dataset(96, 7, in_dim=12, num_classes=3, seed=11)
    p0 = build_gcn([12, 16, 3]).init_params(torch.Generator().manual_seed(5))
    p0 = {k: v.detach().clone() for k, v in p0.items()}
    runs = [dict(model=build_gcn([12, 16, 3], dropout_rate=0.0), dataset=ds,
                 params=p0, parts=2, epochs=3, config=TrainConfig(
                     aggr_impl="cuda", halo=halo, dropout_rate=0.0,
                     eval_every=1, verbose=False, chunk=64, symmetric=True,
                     mesh=mesh)) for mesh in ("2x2", "auto")]
    res = run_ranks(torch_rank_jobs.mesh_job, 4, runs=runs,
                    device="cuda:0")
    for mesh2d, oned in res:
        torch.testing.assert_close(torch.from_numpy(mesh2d["losses"]),
                                   torch.from_numpy(oned["losses"]),
                                   rtol=1e-5, atol=0)
        for k, full in mesh2d["params"].items():
            assert mesh2d["rest"][k] == mesh2d["rest_m"][k] == tuple(
                n // 2 if i == (1 if full.shape[1] % 2 == 0 else 0) else n
                for i, n in enumerate(full.shape))
        n = mesh2d["launches"]
        assert n["indegree_norm"] > 0 and n["scale_act"] > 0 and \
            n["indegree_norm_masked"] > 0
        assert (n["csr_spmm"] if halo == "ring" else n["ell_aggregate"]) > 0


@pytest.mark.parametrize("flavor", ["akx", "table"])
def test_sharded_router_on_the_card_matches_the_predictor(dev, tmp_path,
                                                          flavor):
    """A 2-replica ``Router(sharded=True)`` with its replicas on the card
    (the SGC 24-5 on 'akx', the APPNP 24-16-5 on 'table', V = 2,000, two
    table slices) against the in-process predictor that exported them:
    bit-equal on 'table' (a gather); within 1e-5 of the logit scale on
    'akx' (a replica's head GEMM runs at its sub-request's bucket)."""
    from roc_tpu_torch.models import model_builders
    from roc_tpu_torch.serve.export import build_predictor, export_predictor
    from roc_tpu_torch.serve.router import Router
    from roc_tpu_torch.train.trainer import TrainConfig
    name, kw, layers, backend = {
        "akx": ("sgc", {"k": 2}, [24, 5], "auto"),
        "table": ("appnp", {"k": 3}, [24, 16, 5], "precomputed")}[flavor]
    ds = synthetic_dataset(2000, 6, in_dim=24, num_classes=5, seed=0)
    model = model_builders()[name](layers, dropout_rate=0.5, **kw)
    pred = build_predictor(model, ds, TrainConfig(aggr_impl="cuda",
                                                  symmetric=True, seed=3),
                           device=dev, backend=backend)
    art = str(tmp_path / "art")
    man = export_predictor(pred, art, shards=2)
    seam = man["shards"]["plan"][0][1]
    rng = np.random.RandomState(5)
    batches = [rng.randint(0, 2000, size=n) for n in (1, 5, 64, 600)]
    batches.append(np.arange(seam - 6, seam + 6))
    with Router(art, n_replicas=2, sharded=True,
                replica_args=["--drain-timeout", "3"]) as router:
        for ids in batches:
            got = np.asarray(router.submit(ids).result(timeout=120))
            want = pred.query(ids)
            if flavor == "table":
                assert np.array_equal(got, want), ids.size
            else:
                err = np.abs(got - want).max()
                assert err <= 1e-5 * max(1.0, np.abs(want).max()), ids.size
        stats = router.stats()
    assert stats["n_ok"] == len(batches) and stats["gather_p50_ms"]
    assert [r["shard"] for r in stats["replicas"]] == man["shards"]["plan"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("impl", ["blocked", "scan"])
def test_chunked_edge_routes_on_the_card_match_segment(dev, impl, dtype):
    """'blocked' and 'scan' on the card against the plain 'segment' sum on
    the same inputs (fp32 sums in other orders: rtol 1e-5, atol 1e-5 of
    the largest row; bf16: both sum in fp32 and round once, within one
    bf16 ulp of the segment's fp32 sum), in one run of chunks and in
    runs of 2; the forward of each also under autograd, whose gradient
    equals the segment route's on a symmetric graph's transpose."""
    from roc_tpu_torch.core.partition import padded_edge_list
    from roc_tpu_torch.ops import aggregate as agg
    ds = synthetic_dataset(3_000, 20, in_dim=8, num_classes=3, seed=4)
    g = ds.graph
    V = g.num_nodes
    src, dst = (torch.from_numpy(a).to(dev)
                for a in padded_edge_list(g, multiple=128))
    x = torch.zeros(V + 1, 41, device=dev)
    x[:V] = torch.randn(V, 41, generator=torch.Generator(device=dev)
                        .manual_seed(3), device=dev)
    x = x.to(dtype)
    want = agg.aggregate_segment(x.float(), src, dst, V)
    fn = getattr(agg, f"aggregate_{impl}")
    for budget in (agg.LAYOUT_BUDGET_ELEMS, 2 * 128 * 41):
        got = fn(x, src, dst, V, chunk=128, budget_elems=budget)
        assert got.dtype == dtype and got.device.type == "cuda"
        if dtype == torch.float32:
            torch.testing.assert_close(
                got, want, rtol=1e-5,
                atol=1e-5 * float(want.abs().max()))
        else:
            ulp = torch.pow(2.0, torch.floor(torch.log2(
                want.abs().clamp_min(2.0 ** -126))) - 7)
            assert bool(((got.float() - want).abs() <= ulp).all())
    if dtype == torch.float32:
        xr = x.clone().requires_grad_(True)
        cot = torch.randn(V, 41, device=dev)
        (gx,) = torch.autograd.grad(fn(xr, src, dst, V, chunk=128), xr, cot)
        xs = x.clone().requires_grad_(True)
        (gs,) = torch.autograd.grad(agg.aggregate_segment(xs, src, dst, V),
                                    xs, cot)
        torch.testing.assert_close(gx, gs, rtol=1e-5,
                                   atol=1e-5 * float(gs.abs().max()))


def test_linear_chunked_on_the_card(dev):
    """The chunked head on the card: each row block's product against the
    whole product (rtol 1e-5: cuBLAS may tile another row count another
    way), the weight gradient summed by blocks within rtol 1e-5, and one
    block is the whole product."""
    from roc_tpu_torch.ops.dense import linear, linear_chunked
    gen = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn(70_001, 256, generator=gen, device=dev,
                    requires_grad=True)
    w = torch.randn(256, 41, generator=gen, device=dev, requires_grad=True)
    cot = torch.randn(70_001, 41, generator=gen, device=dev)
    outs = []
    for fn in (lambda: linear_chunked(x, w, "relu", block=16_384),
               lambda: linear(x, w, "relu")):
        y = fn()
        outs.append((y, *torch.autograd.grad(y, (x, w), cot)))
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, rtol=1e-5,
                                   atol=1e-5 * float(b.abs().max()))
    assert torch.equal(linear_chunked(x, w, block=70_001), linear(x, w))


def test_observed_first_step_on_the_card(dev):
    """The first-step observer on the card: the kernels' FLOPs of the
    first step (K1, K2 and K4 on 'cuda', each at its kernel_ops) equal
    the tally of the fused GCN's launches and join the matmuls' count;
    the peak is the allocator's, above 0; the eval slot counts the
    forward; the step's objective is the one of a trainer without the
    observer."""
    from roc_tpu_torch.kernels._build import kernel_ops
    from roc_tpu_torch.models.gcn import build_gcn
    from roc_tpu_torch.train.trainer import (TrainConfig, Trainer,
                                             run_epoch_loop)
    ds = synthetic_dataset(2_000, 12, in_dim=32, num_classes=5, seed=0)
    V, E = ds.graph.num_nodes, ds.graph.num_edges
    layers = [32, 16, 5]

    def make():
        return Trainer(build_gcn(layers, dropout_rate=0.5), ds, TrainConfig(
            aggr_impl="cuda", symmetric=True, verbose=False, epochs=2,
            eval_every=2), device=dev)
    torch.cuda.reset_peak_memory_stats(dev)
    tr = make()
    tr.train()
    c = tr._train_step.cost
    kern = sum(2 * sum(kernel_ops(k, V, E, F) for k in (
        "indegree_norm", "ell_aggregate", "scale_act")) for F in layers[1:])
    mm = [2 * V * a * b for a, b in zip(layers, layers[1:])]
    assert c["flops_kernels"] == kern > 0
    assert c["flops_counted"] == 3 * sum(mm) - mm[0]
    assert c["peak_bytes"] > 0 and c["model_actual_ratio"] > 0
    assert tr._eval_step.cost["flops_kernels"] == kern // 2
    bare = make()
    run_epoch_loop(bare, None, bare.step, bare.evaluate)
    assert torch.equal(torch.stack(tr.losses), torch.stack(bare.losses))


@pytest.mark.parametrize("impl,mode", [("cuda", "float32"),
                                       ("cuda", "mixed"),
                                       ("cuda_csr", "float32")])
def test_warm_trainer_twin_and_launched_instances(dev, tmp_path, impl,
                                                  mode):
    """utils/prewarm.py on the card: the enumerated kernel instances of
    each step slot equal the ones its warm run launched (K1, the masked
    K1, K2 and K4 or K3 at each F and slice width); the parameters and
    Adam state are bit-equal after the warm, and the next steps'
    objectives equal an unwarmed twin's bit for bit; the first live
    step's program key is the enumerated one."""
    from roc_tpu_torch.analysis.programspace import candidate_programs
    from roc_tpu_torch.models.gcn import build_gcn
    from roc_tpu_torch.train.trainer import (TrainConfig, Trainer,
                                             resolve_dtypes)
    from roc_tpu_torch.utils.prewarm import warm_trainer
    ds = synthetic_dataset(2_000, 12, in_dim=32, num_classes=5, seed=0)
    dt, cdt = resolve_dtypes(mode)

    def make():
        return Trainer(build_gcn([32, 16, 5], dropout_rate=0.5), ds,
                       TrainConfig(aggr_impl=impl, symmetric=True,
                                   verbose=False, dtype=dt,
                                   compute_dtype=cdt, eval_every=2),
                       device=dev)
    tr, twin = make(), make()
    before = {k: v.detach().clone() for k, v in tr.params.items()}
    m = {k: v.clone() for k, v in tr.opt_state.m.items()}
    rep = warm_trainer(tr)
    assert rep["failed"] == 0 and rep["instances_match"], rep["slots"]
    sfx = "bf16" if mode == "mixed" else "f32"
    train = rep["slots"][0]
    assert f"indegree_norm_masked[{sfx}]@16" in train["launched"]
    assert all(torch.equal(before[k], v) for k, v in tr.params.items())
    assert all(torch.equal(m[k], v) for k, v in tr.opt_state.m.items())
    tr.train(2)
    twin.train(2)
    assert torch.equal(torch.stack(tr.losses), torch.stack(twin.losses))
    keys = {c.slot: c.key for c in candidate_programs(twin)}
    assert twin._train_step.cost["program_key"] == keys["train_step"]
    assert twin._eval_step.cost["program_key"] == keys["eval_step"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_regions_record_one_entry_each_on_the_card(dev, dtype):
    """Each kernel wrapper's launch recorded (analysis/step_trace.py) as
    exactly one entry named by its instance, none of its own ops (the
    output's allocation included), the output the plain version's; K3
    without row ranges records its pre-pass first."""
    from roc_tpu_torch.analysis.step_trace import record
    from roc_tpu_torch.core.partition import padded_edge_list
    from roc_tpu_torch.kernels import _build
    from roc_tpu_torch.kernels.ell_spmm import default_slice_cols
    from roc_tpu_torch.kernels.spmm import csr_spmm, csr_spmm_plain
    g = _graph(1003, 6, 11)
    t = ell_from_graph(g.row_ptr, g.col_idx, g.num_nodes)
    idx = tuple(torch.from_numpy(a[0]).to(dev) for a in t.idx)
    rid = tuple(torch.from_numpy(a[0]).to(dev) for a in t.row_id)
    deg = torch.from_numpy(g.in_degree).to(dev)
    esrc, edst = (torch.from_numpy(a).to(dev)
                  for a in padded_edge_list(g, multiple=512))
    n, F = g.num_nodes, 41
    x = torch.randn(n, F, device=dev).to(dtype)
    y = torch.randn(n, F, device=dev).to(dtype)
    s = torch.rand(n, device=dev)
    S4 = slicing.resolve("ell_aggregate", None,
                         default_slice_cols(F, dtype))
    cases = [
        ([_build.instance_name("indegree_norm", dtype, F)],
         lambda: indegree_norm(x, deg),
         lambda: indegree_norm_plain(x, deg)),
        ([_build.instance_name("indegree_norm_masked", dtype, F)],
         lambda: indegree_norm(x, deg, relu_out=y),
         lambda: indegree_norm_plain(x, deg, relu_out=y)),
        ([_build.instance_name("scale_act", dtype, F)],
         lambda: scale_act(x, s, "relu"),
         lambda: scale_act_plain(x, s, "relu")),
        ([_build.instance_name("ell_aggregate", dtype, F, S4)],
         lambda: ell_aggregate(x, idx, rid, n),
         lambda: ell_aggregate_plain(x, idx, rid, n)),
        (["csr_row_ptr", None],
         lambda: csr_spmm(x, esrc, edst, n),
         lambda: csr_spmm_plain(x, esrc, edst, n)),
    ]
    for names, fn, plain in cases:
        trace = record(fn)
        torch.cuda.synchronize()
        ops = [e.op for e in trace.entries]
        if names[-1] is None:
            names = names[:-1] + [e.op[len("kernel:"):] for e in
                                  trace.entries[1:]]
            assert names[1].startswith("csr_spmm[")
        assert ops == [f"kernel:{k}" for k in names], ops
        got, want = trace.result, plain()
        if not names[-1].startswith(("ell_", "csr_")):
            assert _same_bits(got, want)
        elif dtype == torch.float32:
            scale = float(want.abs().max())
            torch.testing.assert_close(got, want, rtol=1e-5,
                                       atol=1e-5 * scale)
        else:
            _check_bf16_sum(got, got, want)
