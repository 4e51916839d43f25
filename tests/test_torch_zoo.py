"""The port's model zoo (roc_tpu_torch/models/) against the JAX
package's, on the CPU: every family on every port route from the JAX
package's own initial weights, the trainers' route resolver, the CLI's
model flags, and the zoo's parameter trees through convert.py and the v3
checkpoint in both directions.

Small fixtures: V = 96, degree 6, widths 12-16-3 (GCNII at 3 layers, GAT
at 1 and 2 heads).  The JAX reference runs on its 'ell' route (and
'segment' for the MAX model); on the CPU the port's kernel routes run the
kernels' plain versions.  Dropout 0 wherever two runs are compared.
Every tolerance is stated with its reason.
"""

import contextlib
import os

import numpy as np
import pytest

import jax
import torch

from roc_tpu.core import graph as jgraph
from roc_tpu.models import model_builders as j_model_builders
from roc_tpu.train import cli as jcli
from roc_tpu.train.trainer import TrainConfig as JTrainConfig
from roc_tpu.train.trainer import Trainer as JTrainer
from roc_tpu.train.trainer import resolve_attention_impl as j_resolve
from roc_tpu.train.trainer import resolve_dtypes as j_resolve_dtypes
from roc_tpu.utils import checkpoint as jck
from roc_tpu_torch import convert
from roc_tpu_torch.core import graph as tgraph
from roc_tpu_torch.models import model_builders
from roc_tpu_torch.obs.events import get_bus
from roc_tpu_torch.train import cli
from roc_tpu_torch.train.trainer import (ATTN_FLAT8_MIN_EDGES,
                                         FLAT_SUM_MIN_EDGES, TrainConfig,
                                         Trainer, resolve_attention_impl,
                                         resolve_dtypes)
from roc_tpu_torch.utils import checkpoint as ck

# family -> (registry name, builder kwargs, layers)
FAMILIES = {
    "sage_mean": ("sage", {}, [12, 16, 3]),
    "sage_norm": ("sage", {"use_norm": True}, [12, 16, 3]),
    "sage_pool": ("sage", {"aggregator": "pool"}, [12, 16, 3]),
    "gin": ("gin", {}, [12, 16, 3]),
    "gin_eps": ("gin", {"learn_eps": True}, [12, 16, 3]),
    "sgc": ("sgc", {"k": 2}, [12, 3]),
    "appnp": ("appnp", {"k": 3}, [12, 16, 3]),
    "gcn2": ("gcn2", {}, [12, 16, 16, 16, 3]),
    "gat1": ("gat", {"heads": 1}, [12, 16, 3]),
    "gat2": ("gat", {"heads": 2}, [12, 16, 3]),
}
ROUTES = ("ell", "segment", "cuda", "cuda_csr")
MODES = ("float32", "mixed")
STEPS = 3
# Forward logits: fp32 sums in another order (and the fused chains
# scaling where JAX bakes edge weights), rtol 1e-5 with an atol of 1e-6
# of the logits' magnitude for entries near 0.  The loss curve after each
# step: rtol 1e-4 in fp32 (tests/test_torch_train.py: another summation
# order compounded over the steps) and 2e-2 in 'mixed' (bf16 activations
# rounded at other places through the layers: the port scales before and
# after a fused sum where the JAX 'ell' route bakes d_i d_j into bf16 edge
# weights, and K1's d is a correctly rounded 1/sqrt, JAX's lax.rsqrt).
# Weights after the fp32 steps: rtol 2e-4, atol 1e-5 (Adam moves a weight
# by ~lr whatever its gradient's size).
LOGIT_RTOL = 1e-5
CURVE_RTOL = {"float32": 1e-4, "mixed": 2e-2}
PARAM_TOL = dict(rtol=2e-4, atol=1e-5)


def _datasets():
    return (jgraph.synthetic_dataset(96, 6, in_dim=12, num_classes=3,
                                     seed=3),
            tgraph.synthetic_dataset(96, 6, in_dim=12, num_classes=3,
                                     seed=3))


def _build(builders, fam):
    name, kw, layers = FAMILIES[fam]
    return builders()[name](layers, dropout_rate=0.0, **kw)


def _jax_trainer(jds, fam, jimpl="ell", mode="float32", epochs=STEPS):
    dtype, compute = j_resolve_dtypes(mode)
    return JTrainer(_build(j_model_builders, fam), jds,
                    JTrainConfig(aggr_impl=jimpl, epochs=epochs,
                                 eval_every=1, verbose=False,
                                 symmetric=True, chunk=64, dtype=dtype,
                                 compute_dtype=compute))


def _port_trainer(tds, fam, impl, mode="float32", params=None,
                  epochs=STEPS):
    dtype, compute = resolve_dtypes(mode)
    return Trainer(_build(model_builders, fam), tds,
                   TrainConfig(aggr_impl=impl, epochs=epochs, eval_every=1,
                               verbose=False, symmetric=True, chunk=64,
                               dtype=dtype, compute_dtype=compute),
                   params=params, device="cpu")


@pytest.fixture(autouse=True, scope="module")
def _keep_flight_ring():
    """Leave the event bus's flight ring as this module found it.  The
    ring is bounded (256 events) and this module's trainers emit more
    than that; other modules read their own events off the ring's tail,
    which a full ring no longer grows."""
    ring = get_bus().ring
    saved = list(ring)
    yield
    ring.clear()
    ring.extend(saved)


@contextlib.contextmanager
def _events():
    """The port bus's records emitted inside the block, through a sink
    of its own (the flight ring is bounded, so it may already be full)."""
    class Sink(list):
        write = list.append

    bus, sink = get_bus(), Sink()
    bus.add_sink(sink)
    try:
        yield sink
    finally:
        bus.sinks.remove(sink)


@pytest.fixture(scope="module")
def jax_runs():
    """Per family and dtype mode, the JAX trainer on 'ell': its starting
    weights, inference logits at them, the eval history of STEPS steps
    and the weights after them (fp32 numpy).  The MAX family also on
    'segment' (JAX's segment_max)."""
    jds, tds = _datasets()
    runs = {}
    cases = [(f, "ell", m) for f in FAMILIES for m in MODES]
    cases.append(("sage_pool", "segment", "float32"))
    for fam, jimpl, mode in cases:
        jtr = _jax_trainer(jds, fam, jimpl, mode)
        p0 = {k: np.asarray(v) for k, v in jtr.params.items()}
        logits = np.asarray(jtr.predict(), np.float32)
        hist = jtr.train()
        runs[fam, jimpl, mode] = dict(
            p0=p0, logits=logits, hist=hist,
            params={k: np.asarray(v, np.float32)
                    for k, v in jtr.params.items()})
    return tds, runs


def test_registry_names_match_jax():
    assert sorted(model_builders()) == sorted(j_model_builders())


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("fam", sorted(FAMILIES))
def test_forward_logits_match_jax(jax_runs, fam, route):
    """Inference logits at the JAX package's initial weights, fp32: the
    same parameter names and shapes, the logits within LOGIT_RTOL."""
    tds, runs = jax_runs
    run = runs[fam, "ell", "float32"]
    tr = _port_trainer(tds, fam, route,
                       params=convert.params_from_jax(run["p0"]))
    assert {k: tuple(v.shape) for k, v in tr.params.items()} == \
        {k: v.shape for k, v in run["p0"].items()}
    got = tr.predict().numpy()
    want = run["logits"]
    np.testing.assert_allclose(got, want, rtol=LOGIT_RTOL,
                               atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("fam", sorted(FAMILIES))
def test_three_steps_match_jax(jax_runs, fam, mode, route):
    """STEPS Adam steps from the JAX weights, dropout 0: the printed
    train loss after each within CURVE_RTOL[mode] of the JAX trainer's,
    the counts equal, and in fp32 the weights within PARAM_TOL."""
    tds, runs = jax_runs
    run = runs[fam, "ell", mode]
    tr = _port_trainer(tds, fam, route, mode,
                       params=convert.params_from_jax(run["p0"]))
    hist = tr.train()
    assert [m["epoch"] for m in hist] == list(range(STEPS))
    np.testing.assert_allclose([m["train_loss"] for m in hist],
                               [m["train_loss"] for m in run["hist"]],
                               rtol=CURVE_RTOL[mode])
    for k in ("train_cnt", "val_cnt", "test_cnt"):
        assert [m[k] for m in hist] == [m[k] for m in run["hist"]]
    assert all(np.isfinite(torch.stack(tr.losses).float().numpy()))
    if mode == "float32":
        for k, want in run["params"].items():
            np.testing.assert_allclose(tr.params[k].detach().numpy(), want,
                                       **PARAM_TOL)


def test_segment_max_route_matches_jax_segment(jax_runs):
    """SAGE-pool on the port's 'segment' route (the edge-list max)
    against the JAX trainer on its 'segment' route (segment_max)."""
    tds, runs = jax_runs
    run = runs["sage_pool", "segment", "float32"]
    tr = _port_trainer(tds, "sage_pool", "segment",
                       params=convert.params_from_jax(run["p0"]))
    assert tr.config.aggr_impl == "segment"
    want = run["logits"]
    np.testing.assert_allclose(tr.predict().numpy(), want, rtol=LOGIT_RTOL,
                               atol=1e-6 * np.abs(want).max())
    hist = tr.train()
    np.testing.assert_allclose([m["train_loss"] for m in hist],
                               [m["train_loss"] for m in run["hist"]],
                               rtol=CURVE_RTOL["float32"])


@pytest.mark.parametrize("route", ("ell", "segment"))
def test_sage_pool_ten_steps_at_lr_001_match_jax(route):
    """SAGE-pool's training dynamics at the reference's lr 0.01 (the lr
    the card run lowers for this family alone): 10 Adam steps, dropout 0,
    from the JAX weights, at degree 28 and the zoo's width ratio
    (32-64-10), each step's train loss within CURVE_RTOL of the JAX
    trainer's on the same route."""
    jds = jgraph.synthetic_dataset(160, 28, in_dim=32, num_classes=10,
                                   seed=5)
    tds = tgraph.synthetic_dataset(160, 28, in_dim=32, num_classes=10,
                                   seed=5)
    layers = [32, 64, 10]
    jtr = JTrainer(j_model_builders()["sage"](layers, dropout_rate=0.0,
                                             aggregator="pool"), jds,
                   JTrainConfig(aggr_impl=route, epochs=10, eval_every=1,
                                verbose=False, symmetric=True,
                                learning_rate=0.01))
    p0 = {k: np.asarray(v) for k, v in jtr.params.items()}
    want = [m["train_loss"] for m in jtr.train()]
    tr = Trainer(model_builders()["sage"](layers, dropout_rate=0.0,
                                          aggregator="pool"), tds,
                 TrainConfig(aggr_impl=route, epochs=10, eval_every=1,
                             verbose=False, symmetric=True,
                             learning_rate=0.01),
                 params=convert.params_from_jax(p0), device="cpu")
    got = [m["train_loss"] for m in tr.train()]
    np.testing.assert_allclose(got, want, rtol=CURVE_RTOL["float32"])


# ------------------------------------------------------------ resolver


class _Sized:
    """A stand-in dataset with only an edge count: the resolver reads
    ``dataset.graph.num_edges`` and nothing else."""

    def __init__(self, num_edges):
        self.graph = type("G", (), {"num_edges": num_edges})()


# (family, port route, edge count) -> the port's resolved route; the
# JAX package's resolution of the same request (its route names through
# convert) is compared alongside
RESOLVE_CASES = [
    ("gat1", "cuda", None, "cuda"),
    ("gat1", "ell", None, "ell"),
    ("gat1", "cuda_csr", None, "ell"),
    ("gat1", "segment", None, "ell"),
    ("gat1", "cuda", ATTN_FLAT8_MIN_EDGES, "cuda"),
    ("gat1", "ell", ATTN_FLAT8_MIN_EDGES, "ell"),
    ("gat1", "cuda_csr", ATTN_FLAT8_MIN_EDGES, "attn_flat8"),
    ("gat1", "segment", ATTN_FLAT8_MIN_EDGES, "attn_flat8"),
    ("sage_pool", "cuda", None, "cuda"),
    ("sage_pool", "segment", None, "segment"),
    ("sage_pool", "cuda_csr", None, "ell"),
    ("sage_pool", "cuda_csr", FLAT_SUM_MIN_EDGES - 1, "ell"),
    ("sage_pool", "cuda_csr", FLAT_SUM_MIN_EDGES, "flat_sum"),
    ("sage_pool", "segment", FLAT_SUM_MIN_EDGES, "segment"),
    ("sage_pool", "cuda", FLAT_SUM_MIN_EDGES, "cuda"),
    ("sage_mean", "cuda_csr", None, "cuda_csr"),
    ("gin", "segment", FLAT_SUM_MIN_EDGES, "segment"),
]


@pytest.mark.parametrize("fam,impl,E,want", RESOLVE_CASES)
def test_resolver_follows_jax_and_says_so(fam, impl, E, want):
    """The port's resolve_attention_impl against the JAX package's on
    the same request: where JAX keeps a route the port keeps it; where
    JAX moves it to 'ell' or to a flat layout ('attn_flat8', 'flat_sum')
    the port does too, with one resolve event."""
    ds = None if E is None else _Sized(E)
    with _events() as recs:
        got = resolve_attention_impl(_build(model_builders, fam),
                                     TrainConfig(aggr_impl=impl), ds)
    jgot = j_resolve(_build(j_model_builders, fam),
                     JTrainConfig(aggr_impl=convert.aggr_impl_to_jax(impl)),
                     ds).aggr_impl
    assert got.aggr_impl == want
    ev = [r for r in recs if r.get("cat") == "resolve"]
    if want == impl:
        assert convert.aggr_impl_from_jax(jgot) == impl
        assert not ev
        return
    assert len(ev) == 1
    assert ev[0]["requested"] == impl and ev[0]["resolved"] == want
    assert convert.aggr_impl_from_jax(jgot) == want


def test_trainer_applies_the_resolver():
    """Trainer (and so DistributedTrainer, its subclass) resolves before
    it builds the tables: a GAT model on 'cuda_csr' trains on the ELL
    tables, with the event."""
    _, tds = _datasets()
    p0 = _build(j_model_builders, "gat2").init_params(jax.random.PRNGKey(1))
    with _events() as recs:
        tr = _port_trainer(tds, "gat2", "cuda_csr", epochs=1,
                           params=convert.params_from_jax(p0))
    assert tr.config.aggr_impl == "ell" and tr.gctx.aggr_impl == "ell"
    assert tr.gctx.ell_idx and tr.gctx.edge_src is None
    assert any(r.get("cat") == "resolve" for r in recs)
    assert np.isfinite(tr.train()[-1]["train_loss"])


# ----------------------------------------------------------------- CLI


@pytest.mark.parametrize("argv", [
    ["--model", "gcn"],
    ["--model", "sage"],
    ["--model", "gin", "--learn-eps"],
    ["--model", "gat", "--heads", "2"],
    ["--model", "sgc", "--hops", "3", "-layers", "16-4"],
    ["--model", "appnp", "--hops", "4", "--alpha", "0.2"],
    ["--model", "gcn2", "--alpha", "0.2", "--lam", "1.0",
     "-layers", "16-16-16-4"],
])
def test_cli_trains_each_family(argv, capsys):
    assert cli.main(["--cpu", "-e", "2", "--eval-every", "1", "-v"]
                    + argv) == 0
    out = capsys.readouterr()
    assert [ln.startswith("[INFER][") for ln in out.out.splitlines()] \
        == [True, True]
    assert f"model={argv[1]}" in out.err


@pytest.mark.parametrize("argv", [
    ["--model", "gcn", "--heads", "2"],
    ["--model", "sage", "--learn-eps"],
    ["--model", "gat", "--alpha", "0.1"],
    ["--model", "appnp", "--lam", "0.5"],
    ["--model", "gcn2", "--hops", "2"],
    ["--model", "sgc", "--hops", "0"],
    ["--model", "appnp", "--alpha", "1.5"],
    ["--model", "gcn2", "--lam", "0"],
    ["--model", "gcn2", "-layers", "16-4"],
    ["--model", "gcn2", "-layers", "16-8-16-4"],
    ["--model", "gat", "--heads", "0"],
    ["--model", "gat", "--heads", "3"],
])
def test_cli_model_flag_misuse_exits_2(argv, capsys):
    """Each misuse exits 2 with an error, as the JAX CLI does on the
    same flags, before any dataset is built."""
    assert cli.main(["--cpu", "-e", "1"] + argv) == 2
    assert "error:" in capsys.readouterr().err
    assert jcli.main(["-e", "1"] + argv) == 2


# -------------------------------------------------- weights, checkpoints


def _bits(a):
    if isinstance(a, torch.Tensor):
        a = a.detach()
        return (a.view(torch.int16) if a.dtype == torch.bfloat16
                else a).numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.itemsize == 2 and \
        a.dtype.kind not in "iu" else a


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fam", ["gin_eps", "gat2"])
def test_convert_round_trips_eps_and_gat_leaves(fam, dtype):
    """The JAX init_params tree (0-d eps leaves, [heads, dh] gat leaves)
    into the port and back: the same names, shapes and bits."""
    jdt = jax.numpy.dtype(dtype)
    jp = _build(j_model_builders, fam).init_params(jax.random.PRNGKey(0),
                                                   dtype=jdt)
    if fam == "gin_eps":
        jp = {k: (v + 0.25 if v.ndim == 0 else v) for k, v in jp.items()}
    tp = convert.params_from_jax(jp)
    leaves = {k: v.shape for k, v in jp.items() if not k.startswith("lin")}
    assert leaves == ({"eps_0": (), "eps_1": ()} if fam == "gin_eps" else
                      {"gat_0_src": (2, 8), "gat_0_dst": (2, 8),
                       "gat_1_src": (1, 3), "gat_1_dst": (1, 3)})
    back = convert.params_to_jax(tp)
    for k, v in jp.items():
        assert tuple(tp[k].shape) == v.shape
        assert str(tp[k].dtype).endswith(dtype)
        assert np.array_equal(_bits(tp[k]), _bits(v)), k
        assert back[k].dtype == np.asarray(v).dtype
        assert np.array_equal(_bits(back[k]), _bits(v)), k
    port = _build(model_builders, fam).init_params(
        torch.Generator().manual_seed(0), dtype=getattr(torch, dtype))
    assert {k: tuple(v.shape) for k, v in port.items()} == \
        {k: v.shape for k, v in jp.items()}


@pytest.mark.parametrize("fam", ["gin_eps", "gat2"])
def test_v3_checkpoints_cross_both_ways(tmp_path, fam):
    """A JAX checkpoint of the family (after 2 steps, so eps has moved)
    restores into the port bit for bit, and a port checkpoint into the
    JAX package, params and Adam state."""
    jds, tds = _datasets()
    jtr = _jax_trainer(jds, fam, epochs=2)
    jtr.train()
    jpath = str(tmp_path / "jax")
    jck.checkpoint_trainer(jtr, jpath)
    tr = _port_trainer(tds, fam, "ell")
    ck.restore_trainer(tr, jpath)
    assert tr.epoch == 2
    for k, v in jtr.params.items():
        assert np.array_equal(_bits(tr.params[k]), _bits(v)), k
        assert np.array_equal(_bits(tr.opt_state.m[k]),
                              _bits(jtr.opt_state.m[k])), k
    if fam == "gin_eps":
        assert float(tr.params["eps_0"].detach()) != 0.0
    tr.train(1)
    ppath = str(tmp_path / "port")
    ck.checkpoint_trainer(tr, ppath)
    jtr2 = _jax_trainer(jds, fam)
    jck.restore_trainer(jtr2, ppath)
    assert jtr2.epoch == 3
    for k, t in tr.params.items():
        assert np.array_equal(np.asarray(jtr2.params[k]), _bits(t)), k
        assert np.array_equal(np.asarray(jtr2.opt_state.v[k]),
                              _bits(tr.opt_state.v[k])), k
    assert os.path.isdir(ppath)
