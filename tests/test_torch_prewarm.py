"""The build cache and prewarm (roc_tpu_torch/utils/compile_cache.py,
utils/prewarm.py, prewarm.py): the warmer's accounting with the kernel
build replaced by a stub that writes its target (cold, then warm; a
failed program left out; an uncreatable directory; a corrupt library
rebuilt), a warmed trainer left bit-equal, the prewarm CLI's lines and
warm state against the analysis CLI's keys, the analysis CLI's trace
flags and program budget, and the export's warm block and key check,
with a JAX artifact still loading."""

import contextlib
import io
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from roc_tpu_torch import native
from roc_tpu_torch.analysis import programspace as ps
from roc_tpu_torch.analysis.__main__ import main as lint_main
from roc_tpu_torch.core.graph import synthetic_dataset
from roc_tpu_torch.kernels import _build
from roc_tpu_torch.models.gcn import build_gcn
from roc_tpu_torch.models.sgc import build_sgc
from roc_tpu_torch.obs.events import get_bus
from roc_tpu_torch.serve.export import (build_predictor, export_predictor,
                                        load_predictor)
from roc_tpu_torch.train.trainer import (TrainConfig, Trainer,
                                         resolve_dtypes)
from roc_tpu_torch.utils import prewarm as pw
from roc_tpu_torch.utils.compile_cache import enable_compile_cache

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _Sink(list):
    write = list.append


@pytest.fixture
def events():
    sink = _Sink()
    bus = get_bus()
    bus.add_sink(sink)
    yield sink
    bus.sinks.remove(sink)


@pytest.fixture
def stub_build(monkeypatch):
    """The kernel build as a stub that writes its target (b"good") and a
    loader that takes b"good" and refuses anything else, the warmer
    building on the CPU too; the build directories restored after."""
    built = []

    class Lib:
        pass

    def fake_build(srcs, target):
        built.append(target)
        with open(target, "wb") as f:
            f.write(b"good")

    def fake_load(target):
        with open(target, "rb") as f:
            if f.read() != b"good":
                raise OSError(f"{target}: invalid ELF header")
        return Lib()

    monkeypatch.setattr(_build, "_build", fake_build)
    monkeypatch.setattr(_build, "_load", fake_load)
    card = pw._ensure_library

    def on_any_device(device):
        # the CPU's candidates build as the card's do
        card(torch.device("cuda"))
    monkeypatch.setattr(pw, "_ensure_library", on_any_device)
    kdir, ndir = _build.BUILD_DIR, native.BUILD_DIR
    _build.reset()
    monkeypatch.setattr(_build, "rebuilt", False)
    yield built
    _build.set_build_dir(kdir)
    native.set_build_dir(ndir)
    _build.reset()


@pytest.fixture(autouse=True)
def build_dirs():
    """Each test's cache directories are its own: the build directories
    this worker had come back after it."""
    kdir, ndir = _build.BUILD_DIR, native.BUILD_DIR
    yield
    _build.set_build_dir(kdir)
    native.set_build_dir(ndir)


@pytest.fixture(scope="module")
def data():
    return synthetic_dataset(160, 6, in_dim=12, num_classes=3, seed=2)


def _trainer(ds, impl="cuda", mode="float32", dropout=0.5, features="hbm"):
    dt, cdt = resolve_dtypes(mode)
    return Trainer(build_gcn([12, 16, 3], dropout_rate=dropout), ds,
                   TrainConfig(verbose=False, aggr_impl=impl, dtype=dt,
                               compute_dtype=cdt, symmetric=True,
                               features=features), device="cpu")


# ------------------------------------------------- the accounting

def test_cold_then_warm(stub_build, data, tmp_path, events):
    d = enable_compile_cache(str(tmp_path / "cache"))
    assert d == str(tmp_path / "cache")
    assert _build.BUILD_DIR == native.BUILD_DIR == d
    cands = ps.candidate_programs(_trainer(data))
    rep = pw.warm_candidates(cands, d, config="fix")
    assert (rep["compile_cold"], rep["compile_warm_hits"],
            rep["failed"]) == (1, 1, 0)
    assert rep["slots"][0]["new_files"] == [os.path.basename(
        _build.library_path())]
    assert rep["keys"] == [c.key for c in cands]
    assert len(stub_build) == 1
    # a second process: the library is there, nothing is built
    _build.reset()
    rep2 = pw.warm_candidates(cands, d, config="fix")
    assert (rep2["compile_cold"], rep2["compile_warm_hits"]) == (0, 2)
    assert len(stub_build) == 1 and rep2["keys"] == rep["keys"]
    summ = [e for e in events if e.get("cat") == "compile"
            and e.get("summary")]
    assert [e["compile_cold"] for e in summ] == [1, 0]


def test_failed_candidate_is_left_out(stub_build, data, tmp_path):
    d = enable_compile_cache(str(tmp_path / "cache"))
    cands = ps.candidate_programs(_trainer(data))

    def boom():
        raise RuntimeError("launch failed")
    bad = ps.Candidate(slot="boom", args=(), run=boom)
    rep = pw.warm_candidates([bad] + cands, d, config="fix")
    assert rep["failed"] == 1 and rep["programs"] == 3
    assert rep["keys"] == [c.key for c in cands]
    assert "boom" not in [s["slot"] for s in rep["slots"]]


def test_uncreatable_directory_is_unavailable(stub_build, data, tmp_path,
                                              events):
    blocker = tmp_path / "file"
    blocker.write_text("x")
    assert enable_compile_cache(str(blocker / "cache")) is None
    assert any(e.get("cat") == "compile" and "private_dir" in e
               for e in events)
    rep = pw.warm_candidates(ps.candidate_programs(_trainer(data)), None,
                             config="fix")
    assert rep["cache_unavailable"] and rep["keys"] == []
    assert rep["compile_cold"] == 2 and rep["compile_warm_hits"] == 0


def test_corrupt_library_is_rebuilt(stub_build, tmp_path, events):
    d = enable_compile_cache(str(tmp_path / "cache"))
    with open(_build.library_path(), "wb") as f:
        f.write(b"truncated")
    lib = _build.library()
    assert lib is not None and _build.rebuilt
    assert stub_build == [_build.library_path()]
    with open(_build.library_path(), "rb") as f:
        assert f.read() == b"good"
    assert any(e.get("cat") == "compile" and e.get("rebuild")
               for e in events)
    assert os.path.dirname(_build.library_path()) == d


@pytest.mark.parametrize("impl,mode,features", [
    ("cuda", "float32", "hbm"), ("cuda_csr", "mixed", "hbm"),
    ("cuda", "mixed", "host")])
def test_warm_leaves_the_trainer_bit_equal(data, tmp_path, impl, mode,
                                           features):
    """Params, Adam state, dropout generator, epoch and objectives are
    bit-equal after a warm, and the next steps equal an unwarmed twin's
    bit for bit (dropout 0.5: the generator is restored)."""
    tr = _trainer(data, impl, mode, features=features)
    twin = _trainer(data, impl, mode, features=features)
    tr.train(2)
    twin.train(2)
    before = {k: v.detach().clone() for k, v in tr.params.items()}
    st = tr.opt_state
    m = {k: v.clone() for k, v in st.m.items()}
    gen = tr.generator.get_state().clone()
    rep = pw.warm_trainer(tr, cache_dir=str(tmp_path / "c"))
    assert rep["failed"] == 0 and rep["programs"] == 2
    assert all(torch.equal(before[k], v) for k, v in tr.params.items())
    assert all(torch.equal(m[k], v) for k, v in tr.opt_state.m.items())
    assert tr.opt_state.step == st.step and tr.epoch == twin.epoch
    assert torch.equal(tr.generator.get_state(), gen)
    assert len(tr.losses) == len(twin.losses)
    tr.train(2)
    twin.train(2)
    assert [float(x) for x in tr.losses] == [float(x) for x in twin.losses]
    assert all(torch.equal(tr.params[k], twin.params[k])
               for k in tr.params)


# ---------------------------------------------------------- the CLIs

def _run(*args, timeout=300):
    return subprocess.Popen([sys.executable, *args], cwd=_REPO,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True,
                            env=dict(os.environ, PYTHONPATH=_REPO))


def test_prewarm_cli_state_equals_the_analysis_keys(tmp_path):
    """``python -m roc_tpu_torch.prewarm --cpu`` prints one JSON line a
    config (the 8-rank mesh rig skipped), writes the warm state into the
    cache, runs warm the second time, and its keys per rig equal
    ``python -m roc_tpu_torch.analysis --select compile-explosion
    --json``'s."""
    cache = str(tmp_path / "cache")
    pre = _run("-m", "roc_tpu_torch.prewarm", "--cpu", "--cache-dir", cache)
    lint = _run("-m", "roc_tpu_torch.analysis", "--select",
                "compile-explosion", "--json")
    out, err = pre.communicate(timeout=300)
    assert pre.returncode == 0, err
    lines = [json.loads(x) for x in out.splitlines() if x.startswith("{")]
    assert [x["config"] for x in lines] == sorted(ps.rig_configs())
    skipped = [x["config"] for x in lines if x.get("skipped")]
    assert skipped == ["gin_mesh2d"]
    assert all(x["failed"] == 0 and x["programs"] == len(x["keys"])
               for x in lines if not x.get("skipped"))
    state = pw.load_warm_state(cache_dir=cache)
    assert set(state) == {x["config"] for x in lines
                          if not x.get("skipped")}
    lout, lerr = lint.communicate(timeout=300)
    assert lint.returncode == 0, lout + lerr
    payload = json.loads(lout)
    assert {r["config"]: sorted(r["keys"])
            for r in payload["program_space"]} == \
        {k: v["keys"] for k, v in state.items()}
    again = _run("-m", "roc_tpu_torch.prewarm", "--cpu", "--cache-dir",
                 cache, "--config", "sgc_serve", "--no-state")
    out2, err2 = again.communicate(timeout=300)
    assert again.returncode == 0, err2
    rep = json.loads(out2.splitlines()[0])
    assert rep["compile_cold"] == 0 and rep["compile_warm_hits"] == 4
    bad = _run("-m", "roc_tpu_torch.prewarm", "--cpu", "--config", "nope")
    assert bad.wait(timeout=120) == 2


def _lint(*args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = lint_main(["--root", _REPO, *args])
    return rc, buf.getvalue()


@pytest.fixture
def single_rank(monkeypatch):
    """The program-space level without ranks: the host runs one."""
    monkeypatch.setattr(ps, "RIG_CPU_RANKS", 1)


def test_lint_no_trace_runs_no_trace_level(tmp_path):
    bp = tmp_path / "b.json"
    bp.write_text(json.dumps({"version": 1, "findings": [],
                              "program_budget": {"sgc_serve": 1}}))
    rc, out = _lint("--no-trace", "--json", "--strict", "--baseline",
                    str(bp))
    payload = json.loads(out)
    assert rc == 0 and payload["program_space"] == []
    assert payload["collectives"] is None


def test_lint_program_budget_ratchet(tmp_path, single_rank):
    """Over the bound is a finding; below it, no bound, or a bound for a
    rig that no longer exists fails --strict; --update-baseline shrinks
    to the measurement and drops the orphan, never grows."""
    bp = tmp_path / "b.json"
    sel = ("--select", "programspace", "--baseline", str(bp))
    bp.write_text(json.dumps({"version": 1, "findings": [],
                              "program_budget": {"sgc_serve": 3}}))
    rc, out = _lint(*sel)
    assert rc == 1 and "[compile-explosion]" in out
    bp.write_text(json.dumps({"version": 1, "findings": [],
                              "program_budget": {"sgc_serve": 9,
                                                 "gone_rig": 2}}))
    rc, out = _lint(*sel, "--strict")
    assert rc == 1 and "9 baselined" in out and "gone_rig" in out
    assert "sgc_stream: 2 measured" in out      # unbounded
    rc, out = _lint(*sel)
    assert rc == 0
    rc, out = _lint(*sel, "--update-baseline")
    assert rc == 0
    assert json.loads(bp.read_text())["program_budget"] == \
        {"sgc_serve": 4, "sgc_serve_q8": 4, "sgc_stream": 2}
    rc, out = _lint(*sel, "--strict")
    assert rc == 0 and "delta +0" in out


def test_lint_names_a_cards_instances(single_rank):
    rc, out = _lint("--select", "cache-key-drift", "--json",
                    "--device-kind", "NVIDIA H100 80GB HBM3")
    payload = json.loads(out)
    assert rc == 0
    assert {r["device_kind"] for r in payload["program_space"]} == \
        {"NVIDIA H100 80GB HBM3"}


# ------------------------------------------------------- the export

def test_export_warm_block_and_key_check(tmp_path):
    ds = synthetic_dataset(128, 6, in_dim=12, num_classes=3, seed=0)
    pred = build_predictor(build_sgc([12, 3], k=2), ds,
                           TrainConfig(verbose=False, aggr_impl="segment",
                                       symmetric=True), device="cpu")
    art = str(tmp_path / "art")
    man = export_predictor(pred, art, cache_dir=str(tmp_path / "c"),
                           shards=2)
    assert man["program_keys"] == pred.program_keys()
    assert man["program_keys_by"] == "roc_tpu_torch"
    pre = man["prewarm"]
    assert pre["programs"] == 4 and pre["failed"] == 0
    assert pre["verified_warm_hits"] == 4
    assert man["shards"]["prewarm"]["failed"] == 0
    assert load_predictor(art, device="cpu").program_keys() == \
        man["program_keys"]
    assert load_predictor(art, device="cpu", shard=1).program_keys() == \
        man["shards"]["program_keys"]
    path = os.path.join(art, "serve_manifest.json")
    with open(path) as f:
        doc = json.load(f)
    doc["program_keys"][0] = doc["program_keys"][0].replace("int64",
                                                            "int32")
    with open(path, "w") as f:
        json.dump(doc, f)
    with pytest.raises(ValueError, match="program keys differ"):
        load_predictor(art, device="cpu")


def test_jax_artifact_keys_are_not_compared(tmp_path):
    """A JAX-written artifact's keys are XLA's: the port loads it,
    whatever they say."""
    from roc_tpu.core.graph import synthetic_dataset as j_ds
    from roc_tpu.models.sgc import build_sgc as j_sgc
    from roc_tpu.serve import export as jexport
    from roc_tpu.train.trainer import TrainConfig as JTrainConfig
    jds = j_ds(128, 6, in_dim=12, num_classes=3, seed=0)
    jm = j_sgc([12, 3], k=2)
    jpred = jexport.build_predictor(
        jm, jds, JTrainConfig(aggr_impl="segment", verbose=False,
                              symmetric=True),
        params=jm.init_params(jax.random.PRNGKey(3)))
    art = str(tmp_path / "jart")
    jexport.export_predictor(jpred, art, cache_dir=str(tmp_path / "jc"),
                             verify_warm=False)
    path = os.path.join(art, "serve_manifest.json")
    with open(path) as f:
        doc = json.load(f)
    assert "program_keys_by" not in doc and doc["program_keys"]
    doc["program_keys"] = ["not|a|port|key"]
    with open(path, "w") as f:
        json.dump(doc, f)
    pred = load_predictor(art, device="cpu")
    got = pred.query(np.arange(10))
    want = jpred.query(np.arange(10))
    assert np.abs(got - np.asarray(want)).max() <= 1e-5
