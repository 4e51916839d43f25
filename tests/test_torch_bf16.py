"""bf16 and mixed precision in the port against the JAX package, on the
CPU.

The JAX package's three dtype modes (``resolve_dtypes``: float32,
bfloat16, mixed) and the bf16 plain versions of the kernels K1-K4, held
to the JAX package's functions on the same inputs made with numpy.  JAX
weights cross with roc_tpu_torch/convert.py, bf16 with its bits.  On the
CPU the kernel routes ('cuda', 'cuda_csr') run the kernels' plain
versions; the bf16 CUDA instances are held to those on the card by
tests/test_torch_cuda.py.  Every tolerance is stated with its reason.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from roc_tpu.core import graph as jgraph
from roc_tpu.core.ell import ell_from_graph as j_ell_from_graph
from roc_tpu.kernels.ell_spmm import ell_aggregate_pallas
from roc_tpu.kernels.graphnorm import indegree_norm_pallas, scale_act_pallas
from roc_tpu.kernels.spmm import csr_spmm_pallas
from roc_tpu.models.gcn import build_gcn as j_build_gcn
from roc_tpu.ops.aggregate import aggregate_ell as j_aggregate_ell
from roc_tpu.train.trainer import TrainConfig as JTrainConfig
from roc_tpu.train.trainer import Trainer as JTrainer
from roc_tpu.train.trainer import resolve_dtypes as j_resolve_dtypes
from roc_tpu_torch import convert
from roc_tpu_torch.core import graph as tgraph
from roc_tpu_torch.core.ell import ell_from_graph
from roc_tpu_torch.core.partition import padded_edge_list
from roc_tpu_torch.kernels import ell_spmm, graphnorm, spmm
from roc_tpu_torch.models.gcn import build_gcn
from roc_tpu_torch.ops.aggregate import aggregate_segment, ell_bucket_sum
from roc_tpu_torch.ops.norm import inv_sqrt_degree
from roc_tpu_torch.train import optimizer as topt
from roc_tpu_torch.train.trainer import (DTYPE_MODES, TrainConfig, Trainer,
                                         resolve_dtypes)

LAYERS = [24, 16, 5]
BF16 = torch.bfloat16

# The JAX package's numpy dtype per mode, for its TrainConfig
J_DTYPES = {name: j_resolve_dtypes(name) for name in DTYPE_MODES}


def _bf16_np(a):
    """A numpy fp32 array rounded to bf16, as fp32 (exact in both)."""
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _row_ulp(want):
    """One bf16 ulp of each row's magnitude max|row| (0 for a zero row):
    a bf16 sum is its fp32 sum rounded once, and two fp32 sums a few fp32
    ulps apart (another order) round to the same bf16 value or to
    neighbours."""
    m = np.abs(want).max(axis=1, keepdims=True)
    _, e = np.frexp(m)
    return np.where(m > 0, np.ldexp(1.0, e - 8), 0.0)


def _edges(V=300, seed=0):
    """Random edges, a hub row 1 of 400 extra edges, row 2 of degree 0."""
    rng = np.random.RandomState(seed)
    src = np.concatenate([rng.randint(0, V, 3000), rng.randint(0, V, 400)])
    dst = np.concatenate([rng.randint(0, V, 3000), np.full(400, 1)])
    keep = dst != 2
    return src[keep], dst[keep], V


# ----------------------------------------------------------- dtype modes


@pytest.mark.parametrize("name", DTYPE_MODES)
def test_resolve_dtypes_matches_jax(name):
    """The same three mode names map to the same (dtype, compute_dtype)
    pair in both packages."""
    jd, jc = J_DTYPES[name]
    td, tc = resolve_dtypes(name)
    assert str(td).split(".")[-1] == jnp.dtype(jd).name
    assert (tc is None) == (jc is None)
    if tc is not None:
        assert str(tc).split(".")[-1] == jnp.dtype(jc).name


@pytest.mark.parametrize("bad", ["fp16", "float16", "bf16", "fp8"])
def test_resolve_dtypes_refuses_other_names(bad):
    """No mode the JAX package lacks: both raise ValueError."""
    with pytest.raises(ValueError):
        j_resolve_dtypes(bad)
    with pytest.raises(ValueError, match="dtype mode"):
        resolve_dtypes(bad)


# ------------------------------------------------------------- convert


def test_bf16_params_cross_convert_with_the_same_bits():
    """JAX bf16 params -> port -> JAX: the same bits both ways; fp32
    params alongside stay fp32."""
    rng = np.random.RandomState(0)
    p = {"linear_0": np.asarray(jnp.asarray(rng.randn(7, 5), jnp.bfloat16)),
         "linear_1": rng.randn(5, 3).astype(np.float32)}
    t = convert.params_from_jax(p)
    assert t["linear_0"].dtype == BF16 and t["linear_1"].dtype == torch.float32
    np.testing.assert_array_equal(
        t["linear_0"].view(torch.int16).numpy(), p["linear_0"].view(np.int16))
    back = convert.params_to_jax(t)
    assert back["linear_0"].dtype == p["linear_0"].dtype
    np.testing.assert_array_equal(back["linear_0"].view(np.uint16),
                                  p["linear_0"].view(np.uint16))
    np.testing.assert_array_equal(back["linear_1"], p["linear_1"])


def test_bfloat16_jax_trainer_params_load_into_port_trainer():
    """A bfloat16-mode JAX Trainer's params load into a port Trainer with
    dtype=bfloat16 with the same bits, and its Adam moments are fp32."""
    jds = jgraph.synthetic_dataset(120, 6, in_dim=LAYERS[0],
                                   num_classes=LAYERS[-1], seed=1)
    tds = tgraph.synthetic_dataset(120, 6, in_dim=LAYERS[0],
                                   num_classes=LAYERS[-1], seed=1)
    jtr = JTrainer(j_build_gcn(LAYERS), jds,
                   JTrainConfig(aggr_impl="ell", verbose=False,
                                dtype=J_DTYPES["bfloat16"][0]))
    dtype, compute = resolve_dtypes("bfloat16")
    tr = Trainer(build_gcn(LAYERS), tds,
                 TrainConfig(aggr_impl="cuda", dtype=dtype,
                             compute_dtype=compute),
                 params=convert.params_from_jax(dict(jtr.params)),
                 device="cpu")
    for k, v in jtr.params.items():
        assert tr.params[k].dtype == BF16
        np.testing.assert_array_equal(
            tr.params[k].detach().view(torch.int16).numpy(),
            np.asarray(v).view(np.int16))
        assert tr.opt_state.m[k].dtype == torch.float32
    assert tr.feats.dtype == BF16


def test_adam_rounds_bf16_params_back_to_bf16():
    """bfloat16 mode: the update runs in fp32 against fp32 moments and
    rounds once to the param's bf16, as the JAX optimizer's astype."""
    rng = np.random.RandomState(2)
    w = torch.from_numpy(rng.randn(6, 4).astype(np.float32)).to(BF16)
    g = torch.from_numpy(rng.randn(6, 4).astype(np.float32)).to(BF16)
    params = {"w": w.clone()}
    state = topt.adam_init(params)
    cfg = topt.AdamConfig(weight_decay=1e-3)
    params, state = topt.adam_update(params, {"w": g}, state, 0.01, cfg)
    assert params["w"].dtype == BF16 and state.m["w"].dtype == torch.float32
    w32, g32 = w.float(), g.float() + 1e-3 * w.float()
    mt, vt = 0.1 * g32, 0.001 * g32 * g32
    alpha = float(np.float32(0.01) * np.sqrt(np.float32(1.0)
                                             - np.float32(0.999))
                  / (np.float32(1.0) - np.float32(0.9)))
    want = (w32 - alpha * mt / (torch.sqrt(vt) + 1e-8)).to(BF16)
    assert torch.equal(params["w"], want)


# ------------------------------------------- the kernels' plain versions


@pytest.mark.parametrize("F", [41, 16])
def test_row_scale_plain_bf16_matches_pallas(F):
    """K1 and K2's plain versions in bf16 against indegree_norm_pallas and
    scale_act_pallas in interpret mode, bf16 in and out.  All compute in
    fp32 and round once.  K2 is bit for bit (0 ulp).  K1 is bit for bit
    given the same d: the JAX kernel's d is lax.rsqrt, up to one fp32 ulp
    off the port's correctly rounded 1/sqrt (which its CUDA kernel
    repeats bit for bit), so against indegree_norm_pallas itself an
    element may round to the neighbouring bf16 value: within one bf16
    ulp of the element."""
    rng = np.random.RandomState(F)
    V = 333
    x = rng.randn(V, F).astype(np.float32)
    deg = rng.randint(0, 600, V).astype(np.int32)
    s = rng.rand(V).astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16)
    tx = torch.from_numpy(_bf16_np(x)).to(BF16)
    for act in ("none", "relu"):
        got = graphnorm.scale_act(tx, torch.from_numpy(s), act)
        want = scale_act_pallas(jx, jnp.asarray(s), act=act, interpret=True)
        assert got.dtype == BF16 and want.dtype == jnp.bfloat16
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want.astype(jnp.float32)))
    got = graphnorm.indegree_norm(tx, torch.from_numpy(deg))
    assert got.dtype == BF16
    d = inv_sqrt_degree(torch.from_numpy(deg))
    same_d = scale_act_pallas(jx, jnp.asarray(d.numpy()), interpret=True)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(same_d.astype(jnp.float32)))
    want = np.asarray(indegree_norm_pallas(jx, jnp.asarray(deg),
                                           interpret=True)
                      .astype(jnp.float32))
    err = np.abs(got.float().numpy() - want)
    assert (err <= _row_ulp(np.abs(want).reshape(-1, 1))
            .reshape(want.shape)).all()


@pytest.mark.parametrize("F", [8, 41])
def test_ell_plain_bf16_matches_jax_bit_for_bit(F):
    """K4's plain version in bf16 (an fp32 sum rounded once) against the
    JAX package's aggregate_ell in bf16 and ell_aggregate_pallas in
    interpret mode in bf16: bit for bit on this data (all three round an
    fp32 sum once; the fp32 orders happen to agree here), the degree-0
    row 0."""
    src, dst, V = _edges(seed=1)
    rng = np.random.RandomState(F)
    feats = np.zeros((V + 1, F), np.float32)
    feats[:V] = rng.rand(V, F) * 0.1 + rng.randn(V, F) * 0.05
    jf = jnp.asarray(feats, jnp.bfloat16)
    g, jg = tgraph.from_edge_list(src, dst, V), jgraph.from_edge_list(src,
                                                                      dst, V)
    jt = j_ell_from_graph(jg.row_ptr, jg.col_idx, V)
    tt = ell_from_graph(g.row_ptr, g.col_idx, V)
    jidx = tuple(jnp.asarray(a[0]) for a in jt.idx)
    jpos = jnp.asarray(jt.row_pos[0])
    got = ell_spmm.ell_aggregate(
        torch.from_numpy(_bf16_np(feats[:V])).to(BF16),
        tuple(torch.from_numpy(a[0]) for a in tt.idx),
        tuple(torch.from_numpy(a[0]) for a in tt.row_id), V)
    assert got.dtype == BF16 and not got[2].any()
    got = got.float().numpy()
    for want in (j_aggregate_ell(jf, jidx, jpos, V),
                 ell_aggregate_pallas(jf, jidx, jpos, V, interpret=True)):
        assert want.dtype == jnp.bfloat16
        np.testing.assert_array_equal(got, np.asarray(want.astype(
            jnp.float32)))


@pytest.mark.parametrize("F", [8, 36])
def test_csr_plain_bf16_within_one_ulp_of_rounded_pallas(F):
    """K3's plain version in bf16 against round_bf16(csr_spmm_pallas in
    fp32, interpret mode) on the same bf16 inputs: within one bf16 ulp of
    each row's magnitude (both an fp32 sum rounded once, in other
    orders).  csr_spmm_pallas in bf16 is no oracle: it rounds each
    512-edge chunk and adds the carries in bf16."""
    src, dst, V = _edges(seed=3)
    g = tgraph.from_edge_list(src, dst, V)
    es, ed = padded_edge_list(g, multiple=64)
    rng = np.random.RandomState(F + 1)
    feats = np.zeros((V + 1, F), np.float32)
    feats[:V] = _bf16_np(rng.randn(V, F))
    want = np.asarray(csr_spmm_pallas(jnp.asarray(feats), jnp.asarray(es),
                                      jnp.asarray(ed), V, chunk=64,
                                      interpret=True))
    want = _bf16_np(want)
    got = spmm.csr_spmm(torch.from_numpy(feats[:V]).to(BF16),
                        torch.from_numpy(es), torch.from_numpy(ed), V,
                        chunk=64)
    assert got.dtype == BF16 and not got[2].any()
    err = np.abs(got.float().numpy() - want)
    assert (err <= _row_ulp(want)).all(), err.max()


def test_plain_sums_round_once():
    """ell_bucket_sum and aggregate_segment on bf16 inputs are the fp32
    sum rounded once to bf16, exactly; fp32 inputs keep fp32."""
    src, dst, V = _edges(seed=4)
    g = tgraph.from_edge_list(src, dst, V)
    rng = np.random.RandomState(5)
    x32 = torch.from_numpy(_bf16_np(rng.rand(V + 1, 8) * 2.0))
    x32[V] = 0
    x = x32.to(BF16)
    t = ell_from_graph(g.row_ptr, g.col_idx, V)
    idx = torch.from_numpy(t.idx[-1][0]).long()     # the hub's bucket
    assert idx.shape[1] >= 400
    got = ell_bucket_sum(x, idx)
    assert got.dtype == BF16
    assert torch.equal(got, x32[idx].sum(dim=1).to(BF16))
    assert torch.equal(ell_bucket_sum(x, idx, budget_elems=100),
                       got)                         # row segments agree
    es, ed = (torch.from_numpy(a) for a in padded_edge_list(g, 64))
    want32 = torch.zeros(V, 8).index_add_(0, ed.long(), x32[es.long()])
    seg = aggregate_segment(x, es, ed, V)
    assert seg.dtype == BF16 and torch.equal(seg, want32.to(BF16))
    assert torch.equal(aggregate_segment(x, es, ed, V, budget_elems=64),
                       seg)                         # edge chunks agree
    assert aggregate_segment(x32, es, ed, V).dtype == torch.float32


# ---------------------------------------------------------- the forward


@pytest.fixture(scope="module")
def jax_predictions():
    """The JAX trainer's 'ell' route in each reduced-precision mode,
    dropout 0: its starting weights and its inference logits (fp32)."""
    jds = jgraph.synthetic_dataset(200, 6, in_dim=LAYERS[0],
                                   num_classes=LAYERS[-1], seed=0)
    out = {}
    for mode in ("mixed", "bfloat16"):
        dtype, compute = J_DTYPES[mode]
        jtr = JTrainer(j_build_gcn(LAYERS, dropout_rate=0.0), jds,
                       JTrainConfig(aggr_impl="ell", verbose=False,
                                    symmetric=True, chunk=64, dtype=dtype,
                                    compute_dtype=compute))
        out[mode] = ({k: np.asarray(v) for k, v in jtr.params.items()},
                     np.asarray(jtr.predict().astype(jnp.float32)),
                     jtr.evaluate()["train_loss"])
    return tgraph.synthetic_dataset(200, 6, in_dim=LAYERS[0],
                                    num_classes=LAYERS[-1], seed=0), out


def _port_trainer(tds, impl, mode, params, dropout=0.0, **kw):
    dtype, compute = resolve_dtypes(mode)
    return Trainer(build_gcn(LAYERS, dropout_rate=dropout), tds,
                   TrainConfig(aggr_impl=impl, verbose=False, symmetric=True,
                               chunk=64, dtype=dtype, compute_dtype=compute,
                               **kw),
                   params=convert.params_from_jax(params), device="cpu")


# The logits of the 24-16-5 GCN in bf16 against the JAX package's: bf16
# activations rounded at other places (the JAX 'ell' route bakes d_i d_j
# into bf16 edge weights, the port scales before and after the sum; rel.
# 2^-9 a rounding) through two layers and two bf16 products.  Measured
# ~1.3 % of max|logit|; 3e-2 is ~4 bf16 ulps at that magnitude.
LOGIT_TOL = 3e-2


@pytest.mark.parametrize("impl", ["ell", "segment", "cuda", "cuda_csr"])
@pytest.mark.parametrize("mode", ["mixed", "bfloat16"])
def test_forward_matches_jax_trainer_predict(jax_predictions, mode, impl):
    """The port's inference logits in 'mixed' and 'bfloat16' on every
    route against the JAX Trainer.predict on 'ell' in the same mode,
    from the same weights carried by convert.py; the logits come out in
    the compute dtype."""
    tds, out = jax_predictions
    params, jlogits, _ = out[mode]
    tr = _port_trainer(tds, impl, mode, params)
    logits = tr.predict()
    assert logits.dtype == BF16
    np.testing.assert_allclose(logits.float().numpy(), jlogits, rtol=0,
                               atol=LOGIT_TOL * float(np.abs(jlogits).max()))


def test_mixed_keeps_fp32_master_params_and_moments(jax_predictions):
    """The counterpart of the JAX test_mixed_master_params_stay_fp32:
    after 3 epochs with dropout, params and Adam moments are fp32 and
    the features bf16; in 'bfloat16' the params are bf16 and the moments
    fp32."""
    tds, out = jax_predictions
    tr = _port_trainer(tds, "cuda", "mixed", out["mixed"][0], dropout=0.5)
    tr.train(3)
    for k, p in tr.params.items():
        assert p.dtype == torch.float32 and p.requires_grad
        assert tr.opt_state.m[k].dtype == torch.float32
        assert tr.opt_state.v[k].dtype == torch.float32
    assert tr.feats.dtype == BF16
    assert all(torch.isfinite(x) for x in tr.losses)
    tr = _port_trainer(tds, "cuda", "bfloat16", out["bfloat16"][0])
    tr.train(2)
    for k, p in tr.params.items():
        assert p.dtype == BF16 and tr.opt_state.m[k].dtype == torch.float32


def test_mixed_first_loss_close_to_fp32_and_to_jax(jax_predictions):
    """Before any update: the mixed train loss within rel 0.05 of fp32
    from the same weights (the JAX test's bound), and within rel 2e-3 of
    the JAX package's mixed loss (the same bf16 roundings up to their
    places; measured ~2e-4)."""
    tds, out = jax_predictions
    params, _, jloss = out["mixed"]
    losses = {mode: _port_trainer(tds, "ell", mode, params).evaluate()
              ["train_loss"] for mode in ("float32", "mixed")}
    assert losses["mixed"] == pytest.approx(losses["float32"], rel=0.05)
    assert losses["mixed"] == pytest.approx(jloss, rel=2e-3)
    kernel_route = _port_trainer(tds, "cuda", "mixed", params).evaluate()
    assert kernel_route["train_loss"] == pytest.approx(jloss, rel=2e-3)


@pytest.mark.parametrize("impl", ["ell", "segment"])
def test_mixed_converges_like_fp32(impl):
    """The JAX test of the same name on the port: 40 epochs, dropout 0,
    the same synthetic task; mixed accuracy within 5 points of fp32."""
    ds = tgraph.synthetic_dataset(256, 8, in_dim=16, num_classes=4, seed=0)
    params = build_gcn([16, 32, 4]).init_params(
        torch.Generator().manual_seed(0))
    accs = {}
    for mode in ("float32", "mixed"):
        dtype, compute = resolve_dtypes(mode)
        tr = Trainer(build_gcn([16, 32, 4], dropout_rate=0.0), ds,
                     TrainConfig(aggr_impl=impl, verbose=False,
                                 eval_every=1 << 30, dtype=dtype,
                                 compute_dtype=compute),
                     params=params, device="cpu")
        tr.train(40)
        accs[mode] = tr.evaluate()["train_acc"]
    assert accs["float32"] > 0.9
    assert accs["mixed"] > accs["float32"] - 0.05, accs


def test_cli_trains_in_mixed(capsys):
    """--dtype mixed through the port's CLI on the CPU: the run echoes
    the mode and prints the reference's [INFER] lines; an unknown mode is
    refused by the parser."""
    from roc_tpu_torch.train import cli
    assert cli.main(["--cpu", "-layers", "16-16-4", "-e", "10",
                     "--eval-every", "5", "-v", "--dtype", "mixed"]) == 0
    captured = capsys.readouterr()
    lines = [ln for ln in captured.out.splitlines()
             if ln.startswith("[INFER]")]
    assert len(lines) == 2, captured.out
    assert "dtype=mixed" in captured.err
    with pytest.raises(SystemExit):
        cli.main(["--cpu", "--dtype", "float16"])


@pytest.mark.parametrize("mode", ["mixed", "bfloat16"])
def test_served_logits_in_reduced_precision_match_jax(jax_predictions,
                                                      mode):
    """build_predictor in 'mixed' and 'bfloat16' on the kernel route (its
    plain versions on the CPU): fp32 numpy logits within LOGIT_TOL of the
    JAX package's predictor on 'ell' in the same mode, from the same
    weights; rows coalesced by the Server are the same bits as rows
    served alone."""
    from roc_tpu.serve.export import build_predictor as j_build_predictor
    from roc_tpu_torch.serve.export import build_predictor
    from roc_tpu_torch.serve.server import Server
    tds, out = jax_predictions
    params = out[mode][0]
    jds = jgraph.synthetic_dataset(200, 6, in_dim=LAYERS[0],
                                   num_classes=LAYERS[-1], seed=0)
    jdtype, jcompute = J_DTYPES[mode]
    jpred = j_build_predictor(
        j_build_gcn(LAYERS), jds,
        JTrainConfig(aggr_impl="ell", verbose=False, symmetric=True,
                     dtype=jdtype, compute_dtype=jcompute),
        params={k: jnp.asarray(v) for k, v in params.items()},
        backend="full")
    dtype, compute = resolve_dtypes(mode)
    pred = build_predictor(build_gcn(LAYERS), tds,
                           TrainConfig(aggr_impl="cuda", dtype=dtype,
                                       compute_dtype=compute),
                           params=convert.params_from_jax(params),
                           backend="full", device="cpu")
    ids = np.arange(tds.graph.num_nodes)
    got = pred.query(ids)
    want = np.asarray(jpred.query(ids), np.float32)
    assert got.dtype == np.float32 and got.shape == (ids.size, LAYERS[-1])
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=LOGIT_TOL * float(np.abs(want).max()))
    with Server(pred, max_wait_ms=1.0) as srv:
        futs = [srv.submit(ids[i:i + 7]) for i in range(0, 70, 7)]
        for i, f in zip(range(0, 70, 7), futs):
            assert np.array_equal(f.result(timeout=60), got[i:i + 7])
