"""The port's memory model, autopilot and rematerialisation against the
JAX package's, on the CPU.

core/memory.py is integer arithmetic: the estimates and the chosen plans
are held equal to the JAX package's over a grid of shapes, parts, dtypes,
budgets and policies.  Remat recomputes the same forward, the same
dropout masks included, so within the port it is held bit for bit to no
remat; against the JAX trainer with remat (dropout 0, 3 steps from its
weights) within rtol 1e-4 (fp32 sums in another order, through Adam).
"""

import os
import subprocess
import sys

import numpy as np
import pytest

import torch
import torch.distributed as dist

from roc_tpu.core import graph as jgraph
from roc_tpu.core import memory as jmem
from roc_tpu.models.gcn import build_gcn as j_build_gcn
from roc_tpu.models.sgc import build_sgc as j_build_sgc
from roc_tpu.train.trainer import TrainConfig as JTrainConfig
from roc_tpu.train.trainer import Trainer as JTrainer
from roc_tpu.train.trainer import resolve_config as j_resolve_config
from roc_tpu_torch import convert
from roc_tpu_torch.core import graph as tgraph
from roc_tpu_torch.core import memory as mem
from roc_tpu_torch.models.builder import AGGREGATE_KINDS, GraphContext
from roc_tpu_torch.models.gat import build_gat
from roc_tpu_torch.models.gcn import build_gcn
from roc_tpu_torch.models.gin import build_gin
from roc_tpu_torch.models.sgc import build_sgc
from roc_tpu_torch.parallel.distributed import (DistributedTrainer,
                                                shard_dataset)
from roc_tpu_torch.core.partition import partition_plan
from roc_tpu_torch.train import cli
from roc_tpu_torch.train.trainer import (TrainConfig, Trainer,
                                         model_layer_dims,
                                         modeled_step_bytes, remat_policy,
                                         resolve_config, resolve_dtypes)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAYERS = [12, 8, 3]
SHAPES = [(10_000, 100_000, [602, 256, 41]),
          (232_965, 114_848_857, [602, 256, 41]),
          (2_449_029, 123_718_280, [100, 256, 256, 47]),
          (4_000_000, 60_000_000, [8, 64, 3])]
PLAN_KW = [dict(halo="gather", features="hbm", remat=False),
           dict(halo="gather", features="host", remat=True,
                remat_policy="full"),
           dict(halo="ring", features="hbm", remat=True),
           dict(halo="gather", features="hbm", remat=False,
                extra_table_bytes=2 << 30)]


# ---------------------------------------------------------- the model


@pytest.mark.parametrize("shape", range(len(SHAPES)))
@pytest.mark.parametrize("parts", [1, 4])
@pytest.mark.parametrize("dtype_bytes", [4, 2])
@pytest.mark.parametrize("kw", range(len(PLAN_KW)))
def test_estimate_plan_bytes_equals_jax(shape, parts, dtype_bytes, kw):
    V, E, dims = SHAPES[shape]
    args = dict(num_parts=parts, dtype_bytes=dtype_bytes, **PLAN_KW[kw])
    assert mem.estimate_plan_bytes(V, E, dims, **args) == \
        jmem.estimate_plan_bytes(V, E, dims, **args)


@pytest.mark.parametrize("shape", range(len(SHAPES)))
@pytest.mark.parametrize("parts,model", [(1, 1), (4, 1), (2, 2)])
@pytest.mark.parametrize("kw", range(3))
def test_per_axis_plan_bytes_equals_jax(shape, parts, model, kw):
    V, E, dims = SHAPES[shape]
    args = dict(PLAN_KW[kw])
    assert mem.per_axis_plan_bytes(V, E, dims, parts=parts, model=model,
                                   **args) == \
        jmem.per_axis_plan_bytes(V, E, dims, parts=parts, model=model,
                                 **args)


@pytest.mark.parametrize("shape", range(len(SHAPES)))
@pytest.mark.parametrize("parts", [1, 8])
@pytest.mark.parametrize("budget", [200 << 20, 1 << 30, 6 << 30, 1 << 36])
@pytest.mark.parametrize("streamable,policy,extra",
                         [(True, "save_aggregates", 0),
                          (False, "full", 0),
                          (True, "full", 4 << 30)])
def test_choose_memory_plan_equals_jax(shape, parts, budget, streamable,
                                       policy, extra):
    """The same plan, estimate, fit and candidates for the same inputs."""
    V, E, dims = SHAPES[shape]
    kw = dict(num_parts=parts, hbm_bytes=budget, head_streamable=streamable,
              remat_policy=policy, extra_table_bytes=extra)
    got = mem.choose_memory_plan(V, E, dims, **kw)
    want = jmem.choose_memory_plan(V, E, dims, **kw)
    assert (got.halo, got.features, got.remat, got.fits, got.est_bytes,
            got.budget_bytes, got.candidates, got.reason) == \
        (want.halo, want.features, want.remat, want.fits, want.est_bytes,
         want.budget_bytes, want.candidates, want.reason)
    assert got.name == want.name and got.echo() == want.echo()


@pytest.mark.parametrize("impl,attn,mx,budget", [
    ("bdense", False, False, 2 << 30), ("bdense", True, False, 2 << 30),
    ("bdense", False, True, 2 << 30), ("bdense", False, False, None),
    ("sectioned", False, False, 2 << 30)])
def test_charged_table_bytes_equals_jax(impl, attn, mx, budget):
    assert mem.charged_table_bytes(impl, attn, mx, budget) == \
        jmem.charged_table_bytes(impl, attn, mx, budget)


def test_detect_hbm_bytes_is_the_devices_own():
    """On the CPU the budget is the host's physical memory times the
    usable share, never the JAX package's default device size."""
    host = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    assert mem.detect_hbm_bytes("cpu") == int(host * 0.85)
    assert mem.detect_hbm_bytes() == int(host * 0.85)
    assert mem.detect_hbm_bytes("cpu") != int(jmem._DEFAULT_HBM * 0.85)
    p = mem.choose_memory_plan(100, 1000, [8, 4, 2], device="cpu")
    assert p.budget_bytes == int(host * 0.85) and p.fits


def test_choose_memory_plan_tiers():
    dims = [602, 256, 41]
    p = mem.choose_memory_plan(10_000, 100_000, dims, hbm_bytes=1 << 34)
    assert (p.halo, p.features, p.remat) == ("gather", "hbm", False)
    p = mem.choose_memory_plan(500_000, 10_000_000, dims,
                               hbm_bytes=200 << 20)
    assert p.features == "host"
    p = mem.choose_memory_plan(4_000_000, 60_000_000, dims, num_parts=8,
                               hbm_bytes=1 << 30)
    assert p.halo == "ring"
    assert (mem.estimate_plan_bytes(10**6, 10**7, dims, remat=True)
            < mem.estimate_plan_bytes(10**6, 10**7, dims, remat=False))


def test_layer_dims_and_modeled_bytes_equal_jax():
    jds = jgraph.synthetic_dataset(300, 5, in_dim=16, num_classes=4, seed=3)
    ds = tgraph.synthetic_dataset(300, 5, in_dim=16, num_classes=4, seed=3)
    for jm, m in ((j_build_gcn([16, 8, 4]), build_gcn([16, 8, 4])),
                  (j_build_sgc([16, 4], k=2), build_sgc([16, 4], k=2))):
        from roc_tpu.train.trainer import model_layer_dims as j_dims
        from roc_tpu.train.trainer import modeled_step_bytes as j_bytes
        assert model_layer_dims(m) == j_dims(jm)
        for mode in ("float32", "mixed"):
            from roc_tpu.train.trainer import resolve_dtypes as j_dt
            jd, jc = j_dt(mode)
            d, c = resolve_dtypes(mode)
            for kw in (dict(), dict(features="host", remat=True)):
                assert modeled_step_bytes(m, ds, TrainConfig(
                    dtype=d, compute_dtype=c, **kw)) == j_bytes(
                    jm, jds, JTrainConfig(dtype=jd, compute_dtype=jc, **kw))


# ---------------------------------------------------------- autopilot


@pytest.mark.parametrize("budget", [1 << 34, 120_000, 60_000, 40_000,
                                    10_000])
def test_autopilot_resolves_as_jax(budget):
    """memory='auto' through both resolve passes: the same features,
    remat and plan for each budget (from gather/hbm down to a plan that
    does not fit)."""
    jds = jgraph.synthetic_dataset(300, 5, in_dim=16, num_classes=4, seed=3)
    ds = tgraph.synthetic_dataset(300, 5, in_dim=16, num_classes=4, seed=3)
    _, jcfg, _ = j_resolve_config(
        j_build_gcn([16, 8, 4]), jds,
        JTrainConfig(memory="auto", hbm_bytes=budget, verbose=False,
                     symmetric=True))
    _, cfg = resolve_config(build_gcn([16, 8, 4]), ds, TrainConfig(
        memory="auto", hbm_bytes=budget, verbose=False, symmetric=True),
        device="cpu")
    assert (cfg.memory, cfg.features, cfg.remat, cfg.halo) == \
        (jcfg.memory, jcfg.features, jcfg.remat, jcfg.halo)


def test_autopilot_trains_oversized_graph_without_flags():
    """A budget far below the gathered footprint: the plan, not the
    user, picks the host tier, and it trains."""
    ds = tgraph.synthetic_dataset(300, 5, in_dim=16, num_classes=4, seed=3)
    tr = Trainer(build_gcn([16, 8, 4], dropout_rate=0.2), ds, TrainConfig(
        learning_rate=0.05, memory="auto", hbm_bytes=40_000, epochs=3,
        eval_every=1 << 30, verbose=False, symmetric=True), device="cpu")
    assert tr.config.features == "host" and tr._head is not None
    assert tr.config.memory == "manual"
    tr.train()
    assert np.isfinite(tr.evaluate()["train_loss"])


def test_autopilot_selects_host_tier_for_sgc_over_budget():
    ds = tgraph.synthetic_dataset(4096, 6, in_dim=64, num_classes=4, seed=2)
    tr = Trainer(build_sgc([64, 4], k=1), ds, TrainConfig(
        verbose=False, eval_every=1 << 30, memory="auto",
        hbm_bytes=3 << 20), device="cpu")
    assert tr.config.features == "host" and tr.feats is None
    tr.train(epochs=2)
    assert np.isfinite(tr.evaluate()["train_loss"])


def test_autopilot_picks_each_plan_at_its_estimate():
    """Budgets from the port's own estimates: the gather/hbm estimate as
    the budget picks it, the remat estimate picks remat (below V = 65,536
    one streamed block outweighs the features, so the host plans come
    last here; chip_smoke.py picks them at Reddit's shape)."""
    ds = tgraph.synthetic_dataset(300, 5, in_dim=16, num_classes=4, seed=3)
    V, E = ds.graph.num_nodes, ds.graph.num_edges
    for remat in (False, True):
        budget = mem.estimate_plan_bytes(V, E, [16, 8, 4], remat=remat)
        tr = Trainer(build_gcn([16, 8, 4]), ds, TrainConfig(
            memory="auto", hbm_bytes=budget, epochs=2, verbose=False,
            eval_every=1 << 30, symmetric=True), device="cpu")
        assert (tr.config.features, tr.config.remat) == ("hbm", remat)
        assert tr.modeled_bytes == budget
        tr.train()


def test_distributed_refuses_host_and_an_auto_ring():
    """features='host' is single-device (JAX's words); an autopilot plan
    that picks the ring, refused before the ring was ported, now
    resolves to it as the JAX package's does, and shard_dataset builds
    the ring's tables alone."""
    ds = tgraph.synthetic_dataset(64 * 64, 5, in_dim=8, num_classes=3,
                                  seed=4)

    class TwoParts(Trainer):
        def _num_parts(self):
            return 2

    with pytest.raises(NotImplementedError, match="single-device only"):
        TwoParts(build_gcn([8, 64, 3]), ds, TrainConfig(features="host",
                                                         verbose=False),
                 device="cpu")
    plan = mem.choose_memory_plan(
        ds.graph.num_nodes, ds.graph.num_edges, [8, 64, 3], num_parts=4,
        hbm_bytes=1_500_000, head_streamable=True)
    assert plan.halo == "ring"
    _, cfg = resolve_config(build_gcn([8, 64, 3]), ds, TrainConfig(
        memory="auto", hbm_bytes=1_500_000, verbose=False,
        symmetric=True), device="cpu", num_parts=4)
    jds = jgraph.synthetic_dataset(64 * 64, 5, in_dim=8, num_classes=3,
                                   seed=4)
    _, jcfg, _ = j_resolve_config(
        j_build_gcn([8, 64, 3]), jds,
        JTrainConfig(memory="auto", hbm_bytes=1_500_000, verbose=False,
                     symmetric=True), num_parts=4)
    assert (cfg.halo, cfg.features, cfg.remat) == \
        (jcfg.halo, jcfg.features, jcfg.remat) == ("ring", "hbm",
                                                    plan.remat)
    d = shard_dataset(ds, partition_plan(ds.graph.row_ptr, 4), 0, "cpu",
                      halo=plan.halo)
    assert d.ring_src.shape[0] == 4 and d.edge_src is None \
        and not d.ell_idx


# ------------------------------------------------------------- remat


def _jax_remat_run(jds, policy, remat, impl):
    jtr = JTrainer(j_build_gcn(LAYERS, dropout_rate=0.0), jds, JTrainConfig(
        aggr_impl=impl, remat=remat, remat_policy=policy, epochs=3,
        eval_every=1 << 30, verbose=False, symmetric=True, chunk=64,
        learning_rate=0.05))
    p0 = {k: np.asarray(v) for k, v in jtr.params.items()}
    jtr.train()
    return p0, {k: np.asarray(v) for k, v in jtr.params.items()}


@pytest.mark.parametrize("policy", ["full", "save_aggregates"])
@pytest.mark.parametrize("jimpl,impl", [("segment", "segment"),
                                        ("ell", "cuda")])
def test_remat_matches_jax_remat_at_dropout_0(policy, jimpl, impl):
    """JAX's remat test setting (dropout 0): 3 steps with remat from the
    JAX trainer's weights, against the JAX trainer with remat."""
    jds = jgraph.synthetic_dataset(150, 5, in_dim=12, num_classes=3, seed=1)
    ds = tgraph.synthetic_dataset(150, 5, in_dim=12, num_classes=3, seed=1)
    p0, want = _jax_remat_run(jds, policy, True, jimpl)
    tr = Trainer(build_gcn(LAYERS, dropout_rate=0.0), ds, TrainConfig(
        aggr_impl=impl, remat=True, remat_policy=policy, epochs=3,
        eval_every=1 << 30, verbose=False, symmetric=True, chunk=64,
        learning_rate=0.05), params=convert.params_from_jax(p0),
        device="cpu")
    tr.train()
    got = convert.params_to_jax(tr.params)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-5)


def _port_run(ds, model_fn, impl, mode="float32", epochs=3, **kw):
    d, c = resolve_dtypes(mode)
    tr = Trainer(model_fn(), ds, TrainConfig(
        aggr_impl=impl, epochs=epochs, eval_every=1 << 30, verbose=False,
        symmetric=True, chunk=64, dtype=d, compute_dtype=c, **kw),
        device="cpu")
    tr.train()
    return tr


MODELS = {
    "gcn": lambda: build_gcn(LAYERS, dropout_rate=0.5),
    "gcn_deep": lambda: build_gcn([12, 8, 8, 3], dropout_rate=0.5),
    "gin": lambda: build_gin(LAYERS, dropout_rate=0.5),
    "gat": lambda: build_gat(LAYERS, dropout_rate=0.5, heads=2),
}


@pytest.mark.parametrize("policy", ["full", "save_aggregates"])
@pytest.mark.parametrize("model,impl,mode", [
    ("gcn", "cuda", "float32"), ("gcn", "segment", "float32"),
    ("gcn", "cuda_csr", "mixed"), ("gcn_deep", "cuda", "float32"),
    ("gin", "cuda", "float32"), ("gat", "ell", "float32")])
def test_remat_is_bitequal_to_no_remat_at_dropout_half(policy, model, impl,
                                                       mode):
    """Dropout 0.5 from the seed: remat replays the explicit generator, so
    3 steps end on no-remat's bits (weights and the next step's
    generator state)."""
    ds = tgraph.synthetic_dataset(150, 5, in_dim=12, num_classes=3, seed=1)
    a = _port_run(ds, MODELS[model], impl, mode)
    b = _port_run(ds, MODELS[model], impl, mode, remat=True,
                  remat_policy=policy)
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k]), k
    assert torch.equal(a.generator.get_state(), b.generator.get_state())
    assert all(torch.equal(x, y) for x, y in zip(a.losses, b.losses))


@pytest.mark.parametrize("policy,want", [(None, 4), ("save_aggregates", 4),
                                         ("full", 5)])
def test_save_aggregates_keeps_the_graph_ops(policy, want, monkeypatch):
    """A step's neighbour sums over the GCN's two aggregations: the
    forward and the symmetric backward of each without remat and under
    save_aggregates (the graph ops stay outside every checkpoint); under
    full one more, the recompute of the first layer's segment, whose
    fused relu saved its output (the last segment, a sum with nothing
    saved, is never recomputed)."""
    ds = tgraph.synthetic_dataset(150, 5, in_dim=12, num_classes=3, seed=1)
    calls = []
    orig = GraphContext._fused_sum_fwd

    def counting(self, *a, **k):
        calls.append(1)
        return orig(self, *a, **k)

    monkeypatch.setattr(GraphContext, "_fused_sum_fwd", counting)
    _port_run(ds, MODELS["gcn"], "cuda", epochs=1,
              remat=policy is not None,
              remat_policy=policy or "save_aggregates")
    model = MODELS["gcn"]().fuse_norm_aggregate()
    assert sum(op.kind in AGGREGATE_KINDS for op in model._ops) == 2
    assert len(calls) == want


def _kept_and_recomputed(tr, policy, monkeypatch):
    """One forward and backward of ``tr``'s objective under ``policy``:
    the bytes kept from the forward for the backward (the tensors the
    ops outside a checkpoint save, and the checkpoints' inputs; the
    features, weights and graph tables, resident anyway, excluded) and
    the most ops one recompute ran."""
    from roc_tpu_torch.models import builder
    resident = {t.untyped_storage().data_ptr() for t in [
        tr.feats, *tr.params.values(),
        *[v for v in vars(tr.gctx).values() if isinstance(v, torch.Tensor)]]}
    kept = {}
    ran = [0]
    recomputed = [0]

    def note(t):
        st = t.untyped_storage()
        if st.data_ptr() not in resident:
            kept[st.data_ptr()] = st.nbytes()
        return t

    orig_call, orig_eval = builder.remat_call, builder.Model._eval_op

    def counting_eval(self, *a, **k):
        ran[0] += 1
        return orig_eval(self, *a, **k)

    def noting_call(fn, generator, *args):
        for a in args:
            note(a)
        calls = [0]

        def counted(*xs):
            calls[0] += 1
            before = ran[0]
            try:
                return fn(*xs)
            finally:
                if calls[0] > 1:
                    recomputed[0] = max(recomputed[0], ran[0] - before)
        return orig_call(counted, generator, *args)

    monkeypatch.setattr(builder, "remat_call", noting_call)
    monkeypatch.setattr(builder.Model, "_eval_op", counting_eval)
    with torch.autograd.graph.saved_tensors_hooks(note, lambda t: t):
        loss, _ = tr.model.loss_fn(
            dict(tr.params), tr.feats, tr.labels, tr.mask, tr.gctx,
            generator=tr.generator, train=True, remat=policy)
    loss.backward()
    monkeypatch.undo()
    return sum(kept.values()), recomputed[0]


@pytest.mark.parametrize("impl", ["cuda", "segment"])
@pytest.mark.parametrize("model", ["gcn", "gin"])
def test_remat_keeps_less_and_recomputes_a_layer_at_a_time(model, impl,
                                                           monkeypatch):
    """Remat lowers what the forward keeps for the backward, and 'full'
    recomputes one segment (a graph op up to the next) at a time, not the
    whole forward at once, so its recompute never holds more than one
    layer's activations: 'full' keeps under half of no remat's bytes,
    and for GIN (two dense ops a layer) under 'save_aggregates' too."""
    ds = tgraph.synthetic_dataset(2000, 5, in_dim=64, num_classes=4, seed=1)
    build = {"gcn": lambda: build_gcn([64, 32, 4]),
             "gin": lambda: build_gin([64, 32, 32, 4])}[model]
    tr = Trainer(build(), ds, TrainConfig(
        aggr_impl=impl, verbose=False, symmetric=True, chunk=64),
        device="cpu")
    none, _ = _kept_and_recomputed(tr, None, monkeypatch)
    save, _ = _kept_and_recomputed(tr, "save_aggregates", monkeypatch)
    full, most = _kept_and_recomputed(tr, "full", monkeypatch)
    assert 0 < full < none / 2 and save < none
    if model == "gin":
        assert full < save
    longest = max(j - i for i, j, _ in tr.model._remat_segments("full"))
    assert most == longest < len(tr.model._ops) - 1


def test_remat_on_the_host_tier_is_bitequal():
    ds = tgraph.synthetic_dataset(150, 5, in_dim=12, num_classes=3, seed=1)
    a = _port_run(ds, MODELS["gcn"], "cuda", features="host")
    b = _port_run(ds, MODELS["gcn"], "cuda", features="host", remat=True,
                  remat_policy="full")
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k])


@pytest.mark.parametrize("impl", ["segment", "cuda"])
def test_fused_relu_backward_runs_under_a_checkpoint(impl):
    """The fused aggregation's backward reads its saved relu output once:
    under torch.utils.checkpoint each read of ctx.saved_tensors unpacks
    (recomputes) and a second read is refused.  Its gradient under a
    checkpoint equals the plain backward's bit for bit."""
    from torch.utils.checkpoint import checkpoint
    from roc_tpu_torch.train.trainer import make_graph_context
    ds = tgraph.synthetic_dataset(100, 5, in_dim=8, num_classes=3, seed=0)
    gctx = make_graph_context(ds, impl, symmetric=True, device="cpu",
                              chunk=64)
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(100, 8, generator=gen).requires_grad_(True)
    g = torch.randn(100, 8, generator=gen)
    (want,) = torch.autograd.grad(gctx.aggregate_fused(x, "relu"), x, g)
    y = checkpoint(lambda t: gctx.aggregate_fused(t, "relu"), x,
                   use_reentrant=False)
    (got,) = torch.autograd.grad(y, x, g)
    assert torch.equal(got, want)


def test_remat_policy_validation():
    assert remat_policy(TrainConfig()) is None
    assert remat_policy(TrainConfig(remat=True)) == "save_aggregates"
    assert remat_policy(TrainConfig(remat=True, remat_policy="full")) == \
        "full"
    with pytest.raises(ValueError, match="remat_policy"):
        remat_policy(TrainConfig(remat=True, remat_policy="some"))


@pytest.fixture
def world_of_one(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_partitioned_step_takes_remat(world_of_one):
    """The partitioned trainer's step is Trainer's: remat at world size
    one ends on no-remat's bits, dropout 0.5."""
    ds = tgraph.synthetic_dataset(150, 5, in_dim=12, num_classes=3, seed=1)
    runs = []
    for remat in (False, True):
        tr = DistributedTrainer(MODELS["gcn"](), ds, 1, TrainConfig(
            aggr_impl="cuda", epochs=3, eval_every=1 << 30, verbose=False,
            symmetric=True, chunk=2, remat=remat, remat_policy="full"),
            device="cpu")
        tr.train()
        runs.append(tr.params)
    for k in runs[0]:
        assert torch.equal(runs[0][k], runs[1][k])


# ---------------------------------------------------------------- CLI


@pytest.mark.parametrize("argv,want", [
    ([], ("auto", "hbm", False, "auto")),
    (["--features", "host"], ("auto", "host", False, "auto")),
    (["--remat", "--prefetch", "0"], ("auto", "hbm", True, "0")),
    (["--memory", "manual"], ("manual", "hbm", False, "auto"))])
def test_cli_memory_flags(argv, want):
    a = cli.parse_args(argv)
    assert (a.memory, a.features, a.remat, a.prefetch) == want


def _cli(*args):
    env = dict(os.environ, PYTHONPATH=_REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    return subprocess.run([sys.executable, "-m", "roc_tpu_torch.train.cli",
                           "--cpu", "-layers", "16-16-4", "-e", "5",
                           "--eval-every", "5", "-v", *args],
                          capture_output=True, text=True, env=env,
                          timeout=300)


def test_cli_auto_switches_to_manual_and_validates_prefetch():
    """--memory auto echoes the autopilot's plan; an explicit --features
    host or --remat switches it to manual (no plan); a bad --prefetch
    exits 2."""
    r = _cli()
    assert r.returncode == 0 and "memory plan:" in r.stderr
    for extra in (["--features", "host"], ["--remat"]):
        r = _cli(*extra)
        assert r.returncode == 0, r.stderr[-2000:]
        assert "memory plan:" not in r.stderr and "[INFER][4]" in r.stdout
    r = _cli("--prefetch", "-1")
    assert r.returncode == 2 and "--prefetch" in r.stderr
