"""The port's run telemetry against the JAX package's, on the CPU: the
epoch timer and the metrics log (utils/profiling.py), the profiler trace,
the run manifest (obs/manifest.py), the first-step observer and the
kernels' work tally (obs/compile_watch.py, kernels/_build.py), and the
trainer's telemetry (train/trainer.py run_epoch_loop) on the same inputs
as the JAX Trainer's.  The CPU has no peak FLOP rate, so no record here
carries ``mfu``; the port's first step is ``first_step_ms`` where the JAX
record says ``compile_ms``.
"""

import glob
import json
import os

import numpy as np
import pytest
import torch

from roc_tpu.core import graph as jgraph
from roc_tpu.models.gcn import build_gcn as j_build_gcn
from roc_tpu.obs.events import get_bus as j_get_bus
from roc_tpu.train.trainer import TrainConfig as JTrainConfig
from roc_tpu.train.trainer import Trainer as JTrainer
from roc_tpu.utils import profiling as jprof
from roc_tpu_torch.core import graph as tgraph
from roc_tpu_torch.kernels import _build
from roc_tpu_torch.models.gcn import build_gcn
from roc_tpu_torch.obs.compile_watch import ObservedStep, peak_flops_per_s
from roc_tpu_torch.obs.events import get_bus
from roc_tpu_torch.train.trainer import (TrainConfig, Trainer,
                                         run_epoch_loop)
from roc_tpu_torch.utils import profiling as tprof

LAYERS = [24, 16, 5]
# the clock tuple each MetricsLog record is stamped with
STAMPS = {"t", "mono", "host", "proc"}


def _datasets(V=120, deg=6, seed=0):
    """The same dataset in both packages (bit-equal,
    tests/test_torch_data.py)."""
    return (jgraph.synthetic_dataset(V, deg, in_dim=LAYERS[0],
                                     num_classes=LAYERS[-1], seed=seed),
            tgraph.synthetic_dataset(V, deg, in_dim=LAYERS[0],
                                     num_classes=LAYERS[-1], seed=seed))


def _last(bus, cat):
    return [r for r in bus.ring if r.get("cat") == cat][-1]


class _Sink(list):
    """The port bus's records from its attachment on (the bus's ring is
    bounded)."""
    write = list.append

    def __enter__(self):
        get_bus().add_sink(self)
        return self

    def __exit__(self, *exc):
        get_bus().sinks.remove(self)


# ------------------------------------------------------- timer and log


def test_epoch_timer_summaries_match_jax():
    """The same laps and spans through both timers: equal summaries."""
    laps = [100.0, 10.0, 12.0, 11.0, 9.5]
    spans = {"train": [10.0, 12.0, 11.0], "eval": [5.0, 7.5],
             "first_step": [100.0]}
    timers = (jprof.EpochTimer(warmup=1), tprof.EpochTimer(warmup=1))
    for t in timers:
        t.laps_ms.extend(laps)
        for name, ms in spans.items():
            for v in ms:
                t.note_span(name, v, mono_end=1000.0)
    j, p = timers
    assert p.summary() == j.summary()
    assert p.span_summary() == j.span_summary()
    assert p.take_timeline() == j.take_timeline()
    assert p.take_timeline() == []


def test_epoch_timer_span_syncs_and_annotates():
    """``span`` records a lap with a barrier resolved at exit (the CPU's
    is none) and, annotated, inside a profiler range of its name."""
    t = tprof.EpochTimer(annotate=True)
    made = {}
    with t.span("dispatch", sync_on=lambda: made["out"]):
        made["out"] = torch.ones(4) * 2
    with t.lap(sync_on=made["out"]):
        pass
    assert len(t.spans_ms["dispatch"]) == 1 and len(t.laps_ms) == 1
    assert t.take_timeline()[0][0] == "dispatch"
    tprof.sync({"a": torch.ones(2)})
    tprof.sync([])


def test_metrics_log_records_have_jax_keys(tmp_path):
    """The same records through both logs: the same keys, the clock
    tuple included, and the same values but for the stamps; the context
    manager closes the file on an exception."""
    recs = [{"epoch": 0, "train_loss": np.float32(1.5), "n": np.int64(3)},
            {"epoch": 5, "train_loss": 1.25, "name": "x"}]
    got = {}
    for tag, mod in (("jax", jprof), ("port", tprof)):
        path = str(tmp_path / f"{tag}.jsonl")
        log = mod.MetricsLog(path)
        with pytest.raises(RuntimeError):
            with log:
                for r in recs:
                    log.log(r)
                raise RuntimeError("boom")
        assert log._fh is None and log.last()["epoch"] == 5
        got[tag] = [json.loads(ln) for ln in open(path)]
    for a, b in zip(got["port"], got["jax"]):
        assert set(a) == set(b) and STAMPS <= set(a)
        assert {k: v for k, v in a.items() if k not in STAMPS} == \
            {k: v for k, v in b.items() if k not in STAMPS}


def test_trace_is_a_noop_without_dir_and_writes_on_the_cpu(tmp_path):
    """``trace(None)`` does nothing; ``trace(dir)`` writes a Chrome trace
    with the annotated ranges, and while it records (and only then: a
    bare profiler session sums device time by name, which the ranges
    would count twice) the kernel wrappers name their launches."""
    with tprof.trace(None):
        assert _build.named("ell_aggregate") is _build._NOT_TRACED
    with torch.profiler.profile():
        assert _build.named("ell_aggregate") is _build._NOT_TRACED
    d = str(tmp_path / "prof")
    with tprof.trace(d):
        with tprof.annotate("roc_probe"):
            torch.ones(8) @ torch.ones(8)
        with _build.named("ell_aggregate"):
            torch.ones(8) @ torch.ones(8)
    assert _build.named("ell_aggregate") is _build._NOT_TRACED
    (path,) = glob.glob(os.path.join(d, "*.pt.trace.json"))
    names = {e.get("name") for e in json.load(open(path))["traceEvents"]}
    assert {"roc_probe", "roc_ell_aggregate"} <= names


def test_profile_dir_arms_span_annotation_as_jax(tmp_path):
    """A trainer built with ``profile_dir`` annotates its phases, one
    without does not, in both packages."""
    jds, tds = _datasets()
    for cfg_cls, tr_cls, ds, build, kw in (
            (JTrainConfig, JTrainer, jds, j_build_gcn, {}),
            (TrainConfig, Trainer, tds, build_gcn, {"device": "cpu"})):
        on = tr_cls(build(LAYERS), ds, cfg_cls(
            verbose=False, symmetric=True, aggr_impl="ell",
            profile_dir=str(tmp_path / "p")), **kw)
        off = tr_cls(build(LAYERS), ds, cfg_cls(
            verbose=False, symmetric=True, aggr_impl="ell"), **kw)
        assert on.timer.annotate is True and off.timer.annotate is False


# ---------------------------------------------------------- the manifest


def test_run_manifest_matches_jax():
    """On a small fused GCN, the port's manifest has the JAX one's
    ``resolved``, ``dataset`` and ``model``, agrees on every config key
    both have, writes dtypes by name and stamps its proc."""
    jds, tds = _datasets()
    JTrainer(j_build_gcn(LAYERS), jds, JTrainConfig(
        verbose=False, symmetric=True, aggr_impl="ell"))
    tr = Trainer(build_gcn(LAYERS), tds, TrainConfig(
        verbose=False, symmetric=True, aggr_impl="ell"), device="cpu")
    j, p = _last(j_get_bus(), "manifest"), _last(get_bus(), "manifest")
    for key in ("resolved", "dataset", "model"):
        assert p[key] == j[key], key
    assert p["model"]["fused_aggregates"] == 2
    shared = set(p["config"]) & set(j["config"])
    assert len(shared) >= 30
    assert {k: p["config"][k] for k in shared} == \
        {k: j["config"][k] for k in shared}
    assert p["config"]["dtype"] == "float32"
    assert p["platform"] == "cpu" and p["device_kinds"] == ["cpu"]
    assert (p["process_index"], p["process_count"], p["proc"]) == (0, 1, 0)
    assert p["modeled_step_bytes"] == tr.modeled_bytes
    assert p["torch_version"] == torch.__version__ and "jax_version" in j


# ----------------------------------------- the observer and the tally


def test_kernel_ops_and_the_tally():
    """One add per edge per column for K3/K4, one multiply per element for
    K1, the masked K1 and K2; a launch adds its count to the wrapper's
    ``ops`` and to the process's tally, which zeroing leaves alone."""
    assert _build.kernel_ops("ell_aggregate", 7, 100, 41) == 4100
    assert _build.kernel_ops("csr_spmm", 7, 100, 256) == 25600
    for name in ("indegree_norm", "indegree_norm_masked", "scale_act"):
        assert _build.kernel_ops(name, 7, 100, 41) == 287
    with pytest.raises(ValueError):
        _build.kernel_ops("gemm", 1, 1, 1)

    def fake():
        pass
    _build.zero_launches(fake)
    before = _build.ops_launched()
    _build.launched(fake, torch.bfloat16, 287)
    _build.launched(fake, torch.float32, 13)
    assert (fake.launches, fake.ops, fake.launches_by_dtype) == (
        2, 300, {"f32": 1, "bf16": 1})
    _build.zero_launches(fake)
    assert fake.ops == 0 and _build.ops_launched() == before + 300


def _matmul_flops(V, dims):
    """2·M·N·K over a GCN step's matmuls: every layer's forward and
    weight gradient, and the input gradient of every layer but the
    first (the features take none)."""
    mm = [2 * V * a * b for a, b in zip(dims, dims[1:])]
    return sum(mm), 3 * sum(mm) - mm[0]


@pytest.mark.parametrize("impl", ["cuda", "ell"])
def test_first_step_flops_on_the_cpu(impl):
    """FlopCounterMode's count of a CPU step is the model's matmuls, the
    backward's under ``torch.autograd.grad`` included; the CPU launches no
    kernel, so the tally adds nothing; the eval step counts the forward;
    one ``compile`` event a slot, none after, no peak on the CPU; the
    'cuda' route's buckets hold every edge once (K4's tally)."""
    _, tds = _datasets()
    V = tds.graph.num_nodes
    tr = Trainer(build_gcn(LAYERS), tds, TrainConfig(
        verbose=False, symmetric=True, aggr_impl=impl, epochs=4,
        eval_every=2), device="cpu")
    if impl == "cuda":
        assert sum(tr.gctx.ell_edges) == tds.graph.num_edges
    with _Sink() as recs:
        tr.train()
    fwd, step = _matmul_flops(V, LAYERS)
    c = tr._train_step.cost
    assert (c["flops_counted"], c["flops_kernels"], c["flops"]) == (
        step, 0, step)
    assert c["peak_bytes"] is None and c["bytes_accessed"] is None
    assert c["first_step_s"] > 0 and c["modeled_bytes"] == tr.modeled_bytes
    assert tr._eval_step.cost["flops"] == fwd
    assert [r["name"] for r in recs if r["cat"] == "compile"] == [
        "train_step", "eval_step"]
    assert peak_flops_per_s("cpu") is None
    assert peak_flops_per_s("NVIDIA H100 80GB HBM3") == 989e12


def test_observer_degrades_but_the_step_errors_propagate(monkeypatch):
    """A counter that fails drops the observation (``degraded=True``) and
    runs the step; the step's own error propagates; after the first call
    the observer only calls."""
    calls = []

    def step(x):
        calls.append(x)
        return x + 1

    import torch.utils.flop_counter as fc

    class Broken:
        def __init__(self, **kw):
            raise RuntimeError("no counter")
    monkeypatch.setattr(fc, "FlopCounterMode", Broken)
    obs = ObservedStep(step, name="probe")
    assert obs(1) == 2 and obs(2) == 3 and calls == [1, 2]
    assert obs.cost is None
    assert _last(get_bus(), "compile")["degraded"] is True
    monkeypatch.undo()

    def boom():
        raise ValueError("the step's own")
    with pytest.raises(ValueError, match="own"):
        ObservedStep(boom, name="boom")()


def test_counter_takes_bmm_dtype_and_a_failing_formula_degrades(
        monkeypatch):
    """The counter counts ``bmm``'s ``out_dtype`` overload (the block-dense
    route's tile products on the card; torch's own formula takes its dtype
    for the output shape), here on meta tensors; a formula that fails on
    an op returns the op's output, and the observation degrades while the
    step's result stands."""
    from roc_tpu_torch.obs import compile_watch as cw
    a = torch.empty(3, 4, 5, device="meta", dtype=torch.bfloat16)
    b = torch.empty(3, 5, 6, device="meta", dtype=torch.bfloat16)
    c = cw._counter()
    with c:
        y = torch.bmm(a, b, out_dtype=torch.float32)
    assert (y.dtype, c.get_total_flops(), c.error) == (
        torch.float32, 2 * 3 * 4 * 6 * 5, None)

    def bad(*args, **kwargs):
        raise RuntimeError("formula")
    monkeypatch.setattr(cw, "_bmm_flop", bad)
    x = torch.randn(2, 3, 4)
    obs = ObservedStep(lambda: torch.bmm(x, x.transpose(1, 2)), name="bmm")
    assert torch.equal(obs(), torch.bmm(x, x.transpose(1, 2)))
    assert obs.cost is None
    rec = _last(get_bus(), "compile")
    assert rec["degraded"] is True and "formula" in rec["msg"]


# ------------------------------------------------ the trainer's telemetry


def test_cpu_run_records_match_jax_and_telemetry_changes_no_bit(tmp_path):
    """Six epochs with ``metrics_path`` and ``profile_dir``: the eval
    records' keys are the JAX Trainer's (``first_step_ms`` for its
    ``compile_ms``; no ``mfu`` on the CPU in either), in the metrics file
    too; the objectives and weights equal, bit for bit, a run of the same
    seed with the bare step slots (no observer) and no telemetry; the
    profiler trace holds the first_step/train/eval ranges; the registry,
    the clock_sync and the spans events are there."""
    jds, tds = _datasets()
    jm, tm = str(tmp_path / "j.jsonl"), str(tmp_path / "t.jsonl")
    prof = str(tmp_path / "prof")
    jtr = JTrainer(j_build_gcn(LAYERS, dropout_rate=0.5), jds, JTrainConfig(
        verbose=False, symmetric=True, aggr_impl="ell", epochs=6,
        eval_every=5, metrics_path=jm))
    jhist = jtr.train()
    with _Sink() as recs:
        on = Trainer(build_gcn(LAYERS, dropout_rate=0.5), tds, TrainConfig(
            verbose=False, symmetric=True, aggr_impl="cuda", epochs=6,
            eval_every=5, metrics_path=tm, profile_dir=prof), device="cpu")
        hist = on.train()
    off = Trainer(build_gcn(LAYERS, dropout_rate=0.5), tds, TrainConfig(
        verbose=False, symmetric=True, aggr_impl="cuda", epochs=6,
        eval_every=5), device="cpu")
    run_epoch_loop(off, None, off.step, off.evaluate)
    assert torch.equal(torch.stack(on.losses), torch.stack(off.losses))
    for k in on.params:
        assert torch.equal(on.params[k], off.params[k])
    rename = {"compile_ms": "first_step_ms"}
    want = {rename.get(k, k) for k in jhist[0]} - {"mfu"}
    assert set(hist[0]) == want and "tflops_per_s" in want
    (jrec,), (trec,) = ([json.loads(ln) for ln in open(p)]
                        for p in (jm, tm))
    assert set(trec) == {rename.get(k, k) for k in jrec} - {"mfu"}
    assert trec["step_ewma_ms"] == round(trec["epoch_ms"], 2)
    assert on.reg.get("epoch_ms").count_over() == 1
    assert on.timer.summary()["laps"] == 2
    (path,) = glob.glob(os.path.join(prof, "*.pt.trace.json"))
    names = {e.get("name") for e in json.load(open(path))["traceEvents"]}
    assert {"first_step", "train", "eval"} <= names
    kinds = [r.get("kind") for r in recs if r.get("cat") == "timeline"]
    assert kinds[:1] == ["clock_sync"] and "spans" in kinds
    (summary,) = [r for r in recs if r.get("cat") == "epoch"
                  and r.get("spans") and r["msg"].startswith("phase")][:1]
    assert set(summary["spans"]) == {"first_step", "train", "eval"}


def test_metrics_log_closed_after_an_exception(tmp_path):
    """The loop closes the metrics file when the eval dies mid-run (the
    JAX package's test, on the port)."""
    _, tds = _datasets()
    tr = Trainer(build_gcn(LAYERS), tds, TrainConfig(
        verbose=False, symmetric=True, aggr_impl="ell", eval_every=1,
        metrics_path=str(tmp_path / "m.jsonl")), device="cpu")
    tr.train(2)

    def boom():
        raise RuntimeError("eval died")
    tr.evaluate = boom
    with pytest.raises(RuntimeError):
        tr.train(2)
    assert tr.metrics_log._fh is None
    assert len(open(tmp_path / "m.jsonl").readlines()) == 2


def test_a_dropped_trainer_is_freed_without_the_collector(tmp_path):
    """Neither the step slots' observers nor the counter's or the
    profiler's first use in a process keep a trainer alive once dropped:
    its device memory goes with its last reference, not at the
    collector's next run."""
    import gc
    import weakref
    _, tds = _datasets()
    gc.collect()
    gc.disable()
    try:
        for cfg in ({}, {"profile_dir": str(tmp_path / "p")}):
            tr = Trainer(build_gcn(LAYERS), tds, TrainConfig(
                verbose=False, symmetric=True, aggr_impl="cuda",
                eval_every=2, **cfg), device="cpu")
            tr.train(4)
            ref = weakref.ref(tr)
            del tr
            assert ref() is None, cfg
    finally:
        gc.enable()
