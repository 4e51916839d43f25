"""The port's regression sentinel (``roc_tpu_torch/obs/sentinel.py``)
against the JAX package's (``roc_tpu/obs/sentinel.py``), in process on the
same inputs: ``detect`` over the JAX tests' cases and seeded histories,
the round reader over every file shape, ``check_run`` and
``bench_verdict`` with their filters, ``metrics_summary`` on both
trainers' namings (a real CPU run of the port's ``MetricsLog`` among
them), and ``main`` in both modes.  The port's default history is its
own round files, never the repo's TPU rounds; the module runs as a
plain script with torch blocked.  Also: the crash flight record the
port's CLI installs (``obs/events.py install_excepthook``), against the
JAX package's hook."""

import fnmatch
import glob
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from roc_tpu.obs import sentinel as jsen
from roc_tpu_torch.obs import sentinel as tsen

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SCRIPT = os.path.join(_REPO, "roc_tpu_torch", "obs", "sentinel.py")
_BLOCK = ("import sys, runpy; sys.modules['torch'] = None; "
          "sys.argv = sys.argv[1:]; "
          "runpy.run_path(sys.argv[0], run_name='__main__')")


def test_entry_point_and_constants():
    from roc_tpu_torch import sentinel as entry
    for name in ("bench_history", "bench_verdict", "check_run", "detect",
                 "main", "metrics_summary"):
        assert getattr(entry, name) is getattr(tsen, name)
    for name in ("MAD_K", "REL_FLOOR", "SMALL_SAMPLE_FACTOR",
                 "RATE_ABS_FLOOR"):
        assert getattr(tsen, name) == getattr(jsen, name)
    assert not fnmatch.fnmatch("BENCH_r05.json", tsen.BENCH_GLOB)
    assert fnmatch.fnmatch("BENCH_torch_r01.json", tsen.BENCH_GLOB)


# ------------------------------------------------------------ detect()

# the JAX package's tests' cases (tests/test_sentinel.py)
_JAX_CASES = [
    ([], None, {}), ([], 100.0, {}), ([None, None], 100.0, {}),
    ([100.0, 102.0, 98.0, 101.0], 110.0, {}),
    ([100.0, 102.0, 98.0, 101.0], 140.0, {}),
    ([100.0, 101.0, 99.0, 100.0, 100.5], 140.0, {}),
    ([100.0, 160.0, 60.0, 140.0, 80.0], 140.0, {}),
    ([2362.64], 2362.64 * 2, {}), ([2362.64], 2362.64 * 1.3, {}),
    ([100.0, 104.0], 300.0, {}),
    ([0.60, 0.59, 0.61], 0.55, {"higher_is_better": True}),
    ([0.60, 0.59, 0.61], 0.20, {"higher_is_better": True}),
    ([0.6], 0.2, {"higher_is_better": True}),
    ([0.0] * 4, 0.3, {"allow_zero": True, "abs_floor": 0.05}),
    ([1.0] * 4, 0.5, {"higher_is_better": True, "allow_zero": True,
                      "abs_floor": 0.05}),
]


def _seeded_case(seed):
    """A history of n = seed % 10 entries (lognormal, with None, 0 and
    negative entries mixed in), a current value near its median (or
    None), and a draw of the keyword arguments."""
    rng = np.random.RandomState(seed)
    n = seed % 10
    hist = list(rng.lognormal(4.0, 0.3, size=n))
    for i in range(n):
        u = rng.rand()
        if u < 0.1:
            hist[i] = None
        elif u < 0.2:
            hist[i] = 0.0
        elif u < 0.25:
            hist[i] = -float(hist[i])
        elif u < 0.3:
            hist[i] = int(hist[i])
    current = (None if rng.rand() < 0.1
               else float(np.exp(4.0) * rng.uniform(0.3, 3.0)))
    kw = {"higher_is_better": bool(rng.rand() < 0.5)}
    if rng.rand() < 0.4:
        kw.update(allow_zero=True, abs_floor=float(rng.choice(
            [0.0, 0.05, 20.0])))
    if rng.rand() < 0.2:
        kw.update(mad_k=float(rng.choice([2.0, 3.5])),
                  rel_floor=float(rng.choice([0.1, 0.5])),
                  small_factor=float(rng.choice([1.2, 2.0])))
    return hist, current, kw


@pytest.mark.parametrize(
    "hist,current,kw",
    _JAX_CASES + [_seeded_case(s) for s in range(40)],
    ids=[f"jax{i}" for i in range(len(_JAX_CASES))]
    + [f"seed{s}" for s in range(40)])
def test_detect_equals_jax(hist, current, kw):
    want = jsen.detect(hist, current, **kw)
    got = tsen.detect(hist, current, **kw)
    assert got == want
    assert json.dumps(got) == json.dumps(want)


# ------------------------------------------------------------ the rounds

_HEADLINE = {"metric": "epoch_ms", "value": 43.21, "unit": "ms",
             "dtype": "float32", "stage": "full",
             "serve_p50_ms": 0.5, "serve_p99_ms": 1.2, "serve_qps": 900,
             "serve_shed_rate": 0.0, "serve_error_rate": 0.01,
             "serve_availability": 0.99, "serve_slo_ok": 1.0,
             "serve_table_bytes": 5280000, "serve_quant_drift": 0.011,
             "serve_shard_table_bytes": 1388772.0,
             "serve_gather_p50_ms": 450.0, "ckpt_save_ms": 40.0,
             "ckpt_block_ms": 2.0,
             "stages": {"small": {"compile_s": 3.0},
                        "full": {"compile_s": 12.5},
                        "micro": {"impls": {
                            "ell": {"ms": 5.0, "overlap_frac": 0.2},
                            "stream:prefetch": {"overlap_frac": 0.59},
                            "mesh:2d": {"mesh_epoch_ratio": 0.92}}}}}

# every file shape the reader takes: name -> file text
_ROUND_FILES = {
    "wrapper": json.dumps({"parsed": _HEADLINE, "tail": "..."}),
    "bare": json.dumps(_HEADLINE),
    "parsed_null": json.dumps({"parsed": None, "value": 7.0,
                               "unit": "ms", "dtype": "mixed"}),
    "parsed_list": json.dumps({"parsed": [1, 2], "value": 9.0,
                               "unit": "ms"}),
    "small_only": json.dumps({"value": 8.0, "unit": "ms", "stages": {
        "small": {"compile_s": 2}, "micro": {"impls": {
            "ell": {"overlap_frac": 0.3}}}}}),
    "not_ms": json.dumps({"value": 43.0, "unit": "s", "stage": "small"}),
    "null_value": json.dumps({"parsed": {"value": None, "unit": "ms"}}),
    "list_doc": json.dumps([{"value": 1.0, "unit": "ms"}]),
    "string_doc": json.dumps("BENCH"),
    "torn": '{"parsed": {"value": 4',
    "empty": "",
}


@pytest.mark.parametrize("shape", sorted(_ROUND_FILES) + ["missing"])
def test_load_bench_round_equals_jax(shape, tmp_path):
    path = tmp_path / f"BENCH_torch_r01_{shape}.json"
    if shape != "missing":
        path.write_text(_ROUND_FILES[shape])
    want = jsen.load_bench_round(str(path))
    got = tsen.load_bench_round(str(path))
    assert got == want
    assert list(got) == list(want)
    if shape == "wrapper":
        assert got["compile_s"] == 12.5 and got["overlap_frac"] == 0.59
        assert got["mesh_epoch_ratio"] == 0.92 and got["step_ms"] == 43.21


def _write_rounds(root, rows, names=("BENCH_torch_r{:02d}.json",)):
    """Headline lines ``rows`` as round files under ``root``, each under
    every name pattern in ``names``."""
    os.makedirs(root, exist_ok=True)
    for i, row in enumerate(rows):
        for name in names:
            with open(os.path.join(root, name.format(i)), "w") as f:
                json.dump(row, f)


_STEP_ROWS = [
    {"value": 43.2, "unit": "ms", "dtype": "float32", "stage": "full"},
    {"value": 24.8, "unit": "ms", "dtype": "mixed", "stage": "full"},
    {"value": 43.9, "unit": "ms", "dtype": "float32", "stage": "full"},
    {"value": 4.1, "unit": "ms", "dtype": "float32", "stage": "small"},
    {"value": 42.7, "unit": "ms", "stage": "full"},
    {"value": 25.1, "unit": "ms", "dtype": "mixed", "stage": "full",
     "stages": {"full": {"compile_s": 11.0}}},
]


def test_bench_history_equals_jax_and_skips_tpu_rounds(tmp_path):
    """The same files read by both packages' ``bench_history``; the
    port's pattern in the repo root matches none of the TPU rounds."""
    _write_rounds(str(tmp_path), [_HEADLINE] + _STEP_ROWS)
    pattern = str(tmp_path / "BENCH_torch_r*.json")
    assert tsen.bench_history(pattern) == jsen.bench_history(pattern)
    tpu = glob.glob(os.path.join(_REPO, "BENCH_r0*.json"))
    ours = tsen.bench_history(os.path.join(_REPO, tsen.BENCH_GLOB))
    assert not {r["path"] for r in ours} & {os.path.basename(p)
                                            for p in tpu}


@pytest.mark.parametrize("current", [
    {"step_ms": 44.0, "dtype": "float32"},
    {"step_ms": 80.0, "dtype": "float32"},
    {"step_ms": 44.0, "dtype": "mixed"},
    {"step_ms": 44.0},
    {"step_ms": 30.0, "compile_s": 30.0, "overlap_frac": 0.1,
     "dtype": "bfloat16"},
    {"serve_p50_ms": 0.51, "serve_p99_ms": 6.0, "serve_qps": 200.0,
     "serve_shed_rate": 0.3, "serve_error_rate": 0.0,
     "serve_availability": 0.5, "serve_slo_ok": 0.0,
     "serve_table_bytes": 2e7, "serve_quant_drift": 0.3,
     "serve_shard_table_bytes": 1388772.0, "serve_gather_p50_ms": 4500.0,
     "ckpt_save_ms": 400.0, "ckpt_block_ms": 2.1,
     "mesh_epoch_ratio": 1.9},
])
def test_check_run_equals_jax(current, tmp_path):
    """Every check over one history (the dtype filter included): the
    port's result equals JAX's."""
    _write_rounds(str(tmp_path), [_HEADLINE] * 3 + _STEP_ROWS)
    rounds = tsen.bench_history(str(tmp_path / "BENCH_torch_r*.json"))
    want = jsen.check_run(rounds, current)
    got = tsen.check_run(rounds, current)
    assert got == want
    assert list(got["checks"]) == list(want["checks"])
    assert len(got["checks"]) == 17


@pytest.mark.parametrize("value,dtype,stage,compile_s", [
    (44.0, "float32", None, None), (44.0, "float32", "full", None),
    (88.0, "float32", "full", None), (4.0, "float32", "small", None),
    (24.9, "mixed", "full", 30.0), (50.0, None, None, None),
    (30.0, "bfloat16", "full", None)])
def test_bench_verdict_equals_jax(value, dtype, stage, compile_s,
                                  tmp_path):
    """The same rounds under each package's own file name: the verdicts
    equal, with the dtype and stage filters; no history at all gives
    ``no_history`` in both."""
    empty = str(tmp_path / "empty")
    os.makedirs(empty)
    assert tsen.bench_verdict(value, dtype=dtype, bench_dir=empty) == \
        jsen.bench_verdict(value, dtype=dtype, bench_dir=empty) == \
        {"verdict": "no_history", "n_history": 0}
    _write_rounds(str(tmp_path), _STEP_ROWS, names=(
        "BENCH_torch_r{:02d}.json", "BENCH_r{:02d}.json"))
    kw = dict(dtype=dtype, compile_s=compile_s, bench_dir=str(tmp_path),
              stage=stage)
    assert tsen.bench_verdict(value, **kw) == jsen.bench_verdict(value,
                                                                 **kw)


# ------------------------------------------------ a live run's metrics

_JAX_RECORDS = [
    [{"epoch": 1, "epoch_ms": 50.0, "compile_ms": 2000.0,
      "overlap_frac": 0.5},
     {"epoch": 3, "epoch_ms": 52.0, "overlap_frac": 0.7},
     {"epoch": 5, "epoch_ms": 48.0}],
    [{"epoch": 1, "epoch_ms": 300.0, "compile_ms": 900.0},
     {"epoch": 3, "epoch_ms": 310.0}, {"epoch": 5, "epoch_ms": 310.0}],
    [{"epoch": 4, "epoch_ms": 2000.0, "compile_ms": 2000.0}],
    [{"epoch": 0, "epoch_ms": None, "compile_ms": 10.0}],
    [],
]


@pytest.mark.parametrize("i", range(len(_JAX_RECORDS)))
def test_metrics_summary_equals_jax_on_compile_ms(i):
    recs = _JAX_RECORDS[i]
    assert tsen.metrics_summary(recs) == jsen.metrics_summary(recs)


def _port_run(path, epochs=6, eval_every=2):
    """The GCN 16-16-4 on the CPU through the port's ``Trainer`` with its
    ``MetricsLog`` at ``path``."""
    from roc_tpu_torch.core.graph import synthetic_dataset
    from roc_tpu_torch.models.gcn import build_gcn
    from roc_tpu_torch.train.trainer import TrainConfig, Trainer
    ds = synthetic_dataset(120, 6, in_dim=16, num_classes=4, seed=0)
    tr = Trainer(build_gcn([16, 16, 4]), ds, TrainConfig(
        verbose=False, symmetric=True, aggr_impl="cuda", epochs=epochs,
        eval_every=eval_every, metrics_path=path), device="cpu")
    tr.train()
    return tsen._load_jsonl(path)


@pytest.fixture(scope="module")
def port_metrics(tmp_path_factory):
    root = tmp_path_factory.mktemp("port_metrics")
    path = str(root / "m.jsonl")
    return path, _port_run(path)


def test_metrics_summary_reads_the_port_trainer(port_metrics):
    """A port run (six epochs, an eval every 2): every record's
    ``epoch_ms`` is steady, the first one's ``first_step_ms`` is the
    compile lap.  JAX's reader would keep the steady median and drop the
    first step."""
    _, recs = port_metrics
    assert [r["epoch"] for r in recs] == [1, 3, 5]
    assert "first_step_ms" in recs[0] and "compile_ms" not in recs[0]
    assert all("first_step_ms" not in r for r in recs[1:])
    got = tsen.metrics_summary(recs)
    want_step = round(float(np.median([r["epoch_ms"] for r in recs])), 3)
    assert got["step_ms"] == want_step
    assert got["compile_s"] == round(recs[0]["first_step_ms"] / 1e3, 3)
    assert got["n_records"] == 3 and got["overlap_frac"] is None
    j = jsen.metrics_summary(recs)
    assert j["step_ms"] == got["step_ms"] and j["compile_s"] is None
    # one eval record: still a steady step time (the oracle limit)
    one = tsen.metrics_summary(recs[:1])
    assert one["step_ms"] == round(recs[0]["epoch_ms"], 3)


# ------------------------------------------------------------ main()

def _main(mod, argv, capsys):
    rc = mod.main(argv)
    out = capsys.readouterr().out
    return rc, out


def _both(argv, capsys, as_json=True):
    """``main(argv)`` of both packages; their exit codes and payloads
    (or text) must be equal."""
    rc_j, out_j = _main(jsen, argv, capsys)
    rc_t, out_t = _main(tsen, argv, capsys)
    assert rc_t == rc_j, (out_t, out_j)
    if as_json:
        assert json.loads(out_t) == json.loads(out_j)
        return rc_t, json.loads(out_t)
    assert out_t == out_j
    return rc_t, out_t


@pytest.mark.parametrize("history", ["fp32_then_2x", "steady", "mixed_last",
                                     "no_data"])
@pytest.mark.parametrize("as_json", [True, False])
def test_main_trajectory_equals_jax(history, as_json, tmp_path, capsys):
    rows = {"fp32_then_2x": _STEP_ROWS[:3] + [
                {"value": 88.0, "unit": "ms", "dtype": "float32",
                 "stage": "full"}],
            "steady": [_HEADLINE] * 4,
            "mixed_last": _STEP_ROWS,
            "no_data": [{"value": None}, {"unit": "ms"}]}[history]
    _write_rounds(str(tmp_path), rows)
    argv = ["--bench-glob", str(tmp_path / "BENCH_torch_r*.json")]
    rc, out = _both(argv + (["--json"] if as_json else []), capsys,
                    as_json)
    if as_json:
        want_rc = {"fp32_then_2x": 1, "steady": 0, "mixed_last": 0,
                   "no_data": 0}[history]
        assert rc == want_rc, out
        if history == "fp32_then_2x":
            assert out["regressed"] == ["step_time_ms"]
        if history == "no_data":
            assert out["verdict"] == "no_data"


@pytest.mark.parametrize("dtype", [None, "float32", "mixed"])
def test_main_metrics_mode_equals_jax(dtype, port_metrics, tmp_path,
                                      capsys):
    """``--metrics`` on the JAX naming (``compile_ms``) and on a real
    port run's file: the same exit codes and payloads; an unreadable
    file exits 2 in both."""
    path, recs = port_metrics
    step = tsen.metrics_summary(recs)["step_ms"]
    _write_rounds(str(tmp_path / "h"), [
        {"value": step, "unit": "ms", "dtype": "float32",
         "stage": "full"},
        {"value": step / 2, "unit": "ms", "dtype": "mixed",
         "stage": "full"}])
    jm = tmp_path / "jax.jsonl"
    jm.write_text("".join(json.dumps(r) + "\n"
                          for r in _JAX_RECORDS[1]) + '{"torn": \n')
    hist = ["--bench-glob", str(tmp_path / "h" / "BENCH_torch_r*.json")]
    dt = ["--dtype", dtype] if dtype else []
    rc, payload = _both(["--json", "--metrics", str(jm)] + hist + dt,
                        capsys)
    assert payload["mode"] == "metrics" and payload["current"][
        "step_ms"] == 310.0 and payload["current"]["compile_s"] == 0.9
    # the port's file: JAX's payload but for the first step, which JAX's
    # reader does not know by the port's name
    argv = ["--json", "--metrics", path] + hist + dt
    rc_j, want = _main(jsen, argv, capsys)
    rc, got = _main(tsen, argv, capsys)
    want, got = json.loads(want), json.loads(got)
    first_s = round(recs[0]["first_step_ms"] / 1e3, 3)
    assert want["current"]["compile_s"] is None
    assert got["current"]["compile_s"] == first_s
    want["current"]["compile_s"] = first_s
    want["checks"]["compile_time_s"] = jsen.detect([], first_s)
    assert got == want and rc == rc_j
    assert got["current"]["dtype"] == dtype
    assert got["checks"]["step_time_ms"]["n"] == (2 if dtype is None
                                                  else 1)
    assert rc == (1 if dtype == "mixed" else 0)
    missing = ["--metrics", str(tmp_path / "nope.jsonl")] + hist
    assert jsen.main(missing) == tsen.main(missing) == 2
    assert capsys.readouterr().err.count("cannot read") == 2


def test_default_history_is_the_ports_rounds(capsys):
    """No ``--bench-glob``: the port reads only ``BENCH_torch_r*.json`` in
    the repo root, never the TPU rounds; with none recorded, ``no_data``
    and exit 0."""
    rc, out = _main(tsen, ["--json"], capsys)
    payload = json.loads(out)
    names = set(payload.get("rounds", [])) | set(
        payload.get("history_rounds", []))
    assert not any(n.startswith("BENCH_r0") for n in names)
    if not glob.glob(os.path.join(_REPO, tsen.BENCH_GLOB)):
        assert rc == 0 and payload == {"mode": "trajectory", "ok": True,
                                       "verdict": "no_data", "rounds": []}


def test_plain_script_without_torch(port_metrics, tmp_path, capsys):
    """``python roc_tpu_torch/obs/sentinel.py`` with torch blocked from
    import: the payload and exit code of the in-process ``main``, in
    metrics mode on a port run and in trajectory mode."""
    path, recs = port_metrics
    step = tsen.metrics_summary(recs)["step_ms"]
    _write_rounds(str(tmp_path), [
        {"value": step / 2, "unit": "ms", "dtype": "float32"},
        {"value": step, "unit": "ms", "dtype": "float32"}])
    hist = ["--bench-glob", str(tmp_path / "BENCH_torch_r*.json")]
    for argv in (["--json", "--metrics", path, "--dtype", "float32"] + hist,
                 ["--json"] + hist):
        r = subprocess.run([sys.executable, "-c", _BLOCK, _SCRIPT] + argv,
                           capture_output=True, text=True, timeout=60,
                           cwd=str(tmp_path))
        rc, out = _main(tsen, argv, capsys)
        assert r.returncode == rc, r.stderr
        assert json.loads(r.stdout) == json.loads(out)


# ----------------------------------------------- the crash flight record

def _raise_under_hook(pkg, flight_dir):
    code = (f"from {pkg}.obs.events import install_excepthook, emit; "
            "install_excepthook(); install_excepthook(); "
            "emit('run', 'about to fail', console=False); "
            "raise ValueError('boom')")
    env = dict(os.environ, ROC_TPU_FLIGHT_DIR=str(flight_dir),
               JAX_PLATFORMS="cpu")
    env.pop("ROC_TPU_EVENTS", None)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, cwd=_REPO, env=env)
    dumps = glob.glob(str(flight_dir / "flightrecord_*unhandled-*.json"))
    return r, dumps


def test_excepthook_dumps_one_flight_record_as_jax(tmp_path):
    """A process that installs the hook (twice) and raises: exactly one
    ``flightrecord_*unhandled-*.json``, the traceback still on stderr,
    the events in the dump, and the name's slug and ``reason`` those of
    the JAX package's hook for the same exception."""
    got = {}
    for pkg in ("roc_tpu_torch", "roc_tpu"):
        r, dumps = _raise_under_hook(pkg, tmp_path / pkg)
        assert r.returncode == 1
        assert "Traceback" in r.stderr and "ValueError: boom" in r.stderr
        assert len(dumps) == 1, dumps
        with open(dumps[0]) as f:
            doc = json.load(f)
        assert any(e.get("msg") == "about to fail" for e in doc["events"])
        got[pkg] = (os.path.basename(dumps[0]).rsplit("_", 1)[-1],
                    doc["reason"])
    assert got["roc_tpu_torch"] == got["roc_tpu"] == (
        "unhandled-ValueError.json", "unhandled ValueError")


def test_cli_crash_leaves_a_flight_record(tmp_path):
    """``python -m roc_tpu_torch.train.cli`` on a dataset that is not
    there: the unhandled error leaves one flight record beside its
    traceback."""
    env = dict(os.environ, ROC_TPU_FLIGHT_DIR=str(tmp_path))
    env.pop("ROC_TPU_EVENTS", None)
    r = subprocess.run(
        [sys.executable, "-m", "roc_tpu_torch.train.cli", "--cpu",
         "-layers", "16-16-4", "-file", str(tmp_path / "no" / "graph")],
        capture_output=True, text=True, timeout=120, cwd=_REPO, env=env)
    assert r.returncode == 1 and "Traceback" in r.stderr, r.stderr[-2000:]
    dumps = glob.glob(str(tmp_path / "flightrecord_*unhandled-*.json"))
    assert len(dumps) == 1, r.stderr[-2000:]
    with open(dumps[0]) as f:
        assert json.load(f)["reason"].startswith("unhandled ")
