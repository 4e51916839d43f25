"""The port's run report (roc_tpu_torch/report.py) against the JAX
package's on the same artifacts, and on a port run's own files: the CLI
with ``--events --metrics --profile-dir``, a partitioned run of two gloo
ranks (one event file and one manifest a rank, one metrics file that both
append to), and ``--slo`` over a metrics-registry snapshot.
"""

import glob
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from roc_tpu import report as jreport
from roc_tpu_torch import report
from roc_tpu_torch.obs import events
from roc_tpu_torch.obs.metrics_registry import MetricsRegistry

import torch_rank_jobs

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the port's one section of its own: the first-step table, where the JAX
# report has its compile table
PORT_ONLY = {"first step (per step slot)"}


def _sections(text):
    """``{title: body}`` of a report's ``== title ==`` tables, the text
    before the first under ''."""
    head, *rest = text.split("\n== ")
    out = {"": head}
    for block in rest:
        title, _, body = block.partition(" ==\n")
        out[title] = body
    return out


def _synthetic(t0=1_700_000_000.0):
    """A JAX-package event stream of two processes and its metrics: every
    category the report reads."""
    spans = {"compile": {"n": 1, "total_ms": 900.0, "p50_ms": 900.0,
                         "p90_ms": 900.0},
             "train": {"n": 2, "total_ms": 80.0, "p50_ms": 40.0,
                       "p90_ms": 41.0}}
    part = {"real_edges": [100, 90], "padded_edges": [128, 128],
            "padded_nodes": [64, 64], "halo_in": [5, 6], "halo_out": [6, 5],
            "edge_imbalance": 1.05, "node_imbalance": 1.0, "part_nodes": 64,
            "part_edges": 128}
    ev = [
        {"cat": "manifest", "proc": 0, "host": "h", "platform": "cpu",
         "device_count": 8, "device_kinds": ["cpu"], "jax_version": "0.9",
         "git_sha": "abcdef0123456789", "partition": part,
         "dataset": {"name": "syn", "num_nodes": 128, "num_edges": 190},
         "resolved": {"aggr_impl": "ell", "halo": "gather",
                      "num_parts": 2}},
        {"cat": "resolve", "proc": 0, "host": "h",
         "msg": "aggr_impl='auto' -> 'ell'"},
        {"cat": "plan", "proc": 1, "host": "h", "msg": "memory plan: x"},
        {"cat": "compile", "proc": 0, "host": "h", "name": "train_step",
         "lower_s": 0.5, "compile_s": 1.25, "flops": 3.5e9,
         "bytes_accessed": 2.0e8, "peak_bytes": 6.0e8,
         "modeled_bytes": 5.0e8},
        {"cat": "compile", "proc": 1, "host": "h", "name": "eval_step",
         "lower_s": 0.1, "compile_s": 0.2, "flops": None},
        {"cat": "compile", "proc": 0, "host": "h", "summary": True,
         "prewarm": "gcn", "programs": 2, "compile_warm_hits": 2,
         "compile_cold": 0, "prewarm_s": 1.5},
        {"cat": "epoch", "proc": 0, "host": "h", "epoch": 4,
         "epoch_ms": 40.0, "eval_ms": 3.0, "compile_ms": 900.0,
         "edges_per_s": 4.75e6, "tflops_per_s": 0.0875, "mfu": 0.0004},
        {"cat": "pipeline", "proc": 0, "host": "h", "overlap_frac": 0.8,
         "h2d_wait_p50_ms": 1.5},
        {"cat": "costmodel", "proc": 0, "host": "h", "gain": 0.2,
         "msg": "rebalance: gain 0.20"},
        {"cat": "resilience", "proc": 1, "host": "h", "kind": "retry",
         "msg": "retry 1"},
        {"cat": "slo", "proc": 0, "host": "h", "kind": "breach",
         "slo": "p99", "component": "router", "burn": 14.4, "value": 120,
         "target": 100, "spec": "p99(request_ms) <= 100 over 60s"},
        {"cat": "stall", "proc": 1, "host": "h", "stage": "first_compile",
         "elapsed_s": 30},
        {"cat": "epoch", "proc": 0, "host": "h", "spans": spans,
         "msg": "phase spans"},
    ]
    for i, e in enumerate(ev):
        e["t"] = t0 + i
    metrics = [{"epoch": 4, "epoch_ms": 41.0, "edges_per_s": 4.6e6,
                "overlap_frac": 0.7}]
    return ev, metrics


def _render(fn, *args):
    buf = io.StringIO()
    assert fn(*args, out=buf) == 0
    return buf.getvalue()


def test_summarize_prints_the_jax_reports_sections():
    """The same synthetic events and metrics through both reports: the
    header (processes, manifest) and every section both render are equal
    line for line; the port adds only its first-step table; with no
    ``spans`` event both fall back to the records alike."""
    ev, metrics = _synthetic()
    for evs in (ev, ev[:-1]):
        j = _sections(_render(jreport.summarize, evs, metrics))
        p = _sections(_render(report.summarize, evs, metrics))
        assert set(p) - set(j) == PORT_ONLY
        for title in set(p) - PORT_ONLY:
            assert p[title] == j[title], title
    assert "proc1@h" in p[""] and "jax=0.9" in p[""]
    assert "train_step  1.75s" in p["first step (per step slot)"]


def test_first_step_table_and_spans_read_both_namings():
    """The port's ``first_step_s`` and the JAX package's
    ``lower_s``/``compile_s``; the span fallback's ``first_step_ms`` and
    ``compile_ms``; a port manifest names torch and CUDA."""
    ev = [{"cat": "manifest", "platform": "gpu", "device_count": 1,
           "device_kinds": ["NVIDIA H100 80GB HBM3"],
           "torch_version": "2.11.0", "cuda_version": "12.8",
           "resolved": {}, "dataset": {}},
          {"cat": "compile", "name": "train_step", "first_step_s": 2.5,
           "flops": 2.2e11, "flops_kernels": 6.7e10, "peak_bytes": 3 << 30,
           "modeled_bytes": 2 << 30},
          {"cat": "compile", "name": "eval_step", "lower_s": 0.25,
           "compile_s": 0.5, "flops": 7.0e10},
          {"cat": "epoch", "epoch_ms": 43.0, "first_step_ms": 2500.0},
          {"cat": "epoch", "epoch_ms": 44.0, "compile_ms": 750.0}]
    s = _sections(_render(report.summarize, ev, None))
    assert "torch=2.11.0 cuda=12.8" in s[""]
    rows = s["first step (per step slot)"].splitlines()[1:]
    assert rows[0].split()[:4] == ["train_step", "2.50s", "2.2e+11",
                                   "6.7e+10"]
    assert rows[0].split()[-1] == "1.50x"
    assert rows[1].split()[:4] == ["eval_step", "0.75s", "7e+10", "-"]
    spans = {ln.split()[0]: ln.split()[1:] for ln in
             s["phase spans (ms)"].splitlines()[1:]}
    assert spans["first_step"][0] == "1" and spans["compile"][0] == "1"
    assert spans["epoch"][:2] == ["2", "43.0"]


def test_cli_telemetry_files_and_their_report(tmp_path, capsys):
    """The CLI with --events, --metrics and --profile-dir writes the event
    log (the manifest, one first-step event a slot), the metrics records
    and a profiler trace of the traced epoch; the report renders them
    (first step, spans, throughput) and exits 0, in process and as a
    plain script that imports no torch; ``--slo`` renders a registry
    snapshot and, bare, the events' transitions."""
    from roc_tpu_torch.train import cli
    ev, m, prof = (str(tmp_path / n) for n in ("ev.jsonl", "m.jsonl",
                                                "prof"))
    try:
        assert cli.main(["--cpu", "-layers", "16-16-4", "-e", "6",
                         "--eval-every", "2", "--events", ev, "--metrics",
                         m, "--profile-dir", prof]) == 0
    finally:
        events.configure()
    recs = [json.loads(ln) for ln in open(ev)]
    (man,) = [r for r in recs if r["cat"] == "manifest"]
    assert man["resolved"]["aggr_impl"] == "cuda" and \
        man["platform"] == "cpu"
    firsts = [r["name"] for r in recs if r["cat"] == "compile"]
    assert firsts == ["train_step", "eval_step"]
    assert any(r["cat"] == "run" and r.get("path") == prof for r in recs)
    rows = [json.loads(ln) for ln in open(m)]
    assert [r["epoch"] for r in rows] == [1, 3, 5]
    # the first step ran in the CLI's first train() call, before any eval
    # (Trainer.first_step_ms keeps it)
    assert all("tflops_per_s" in r for r in rows)
    (trace,) = glob.glob(os.path.join(prof, "*.pt.trace.json"))
    names = {e.get("name") for e in json.load(open(trace))["traceEvents"]}
    assert {"train", "eval"} <= names
    capsys.readouterr()
    assert report.main([ev, "--metrics", m]) == 0
    s = _sections(capsys.readouterr().out)
    assert "train_step" in s["first step (per step slot)"]
    assert {"first_step", "train", "eval"} <= {
        ln.split()[0] for ln in s["phase spans (ms)"].splitlines()[1:]}
    assert "tflops_per_s" in s["throughput"]
    reg = MetricsRegistry("train")
    reg.gauge("step_ewma_ms", ewma_alpha=0.2).set(4.0)
    reg.histogram("epoch_ms").record(4.0)
    snap = str(tmp_path / "snap.json")
    reg.dump(snap)
    assert report.main(["--slo", snap]) == 0
    out = capsys.readouterr().out
    assert "slo dashboard: registry 'train'" in out and "step_ewma_ms" in out
    assert report.main([ev, "--slo"]) == 0
    assert "slo transitions" in capsys.readouterr().out
    code = ("import runpy, sys; sys.argv = ['report', sys.argv[1], "
            "'--metrics', sys.argv[2]]\n"
            "try:\n"
            "    runpy.run_path("
            f"{os.path.join(_REPO, 'roc_tpu_torch', 'report.py')!r}, "
            "run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    assert not e.code, e.code\n"
            "assert 'torch' not in sys.modules, 'torch imported'\n")
    r = subprocess.run([sys.executable, "-c", code, ev, m],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "== first step (per step slot) ==" in r.stdout


def test_two_ranks_write_a_manifest_each_and_one_metrics_file(tmp_path):
    """A P = 2 run as gloo ranks: each rank's event file holds one manifest
    stamped with its rank (``proc``, ``process_index``), with the split's
    quality record, and its first-step events; both ranks append their
    eval records to the one metrics path, each stamped with its
    ``proc``; the report merges the two event files by a glob."""
    from roc_tpu_torch.core.graph import synthetic_dataset
    from roc_tpu_torch.models.gcn import build_gcn
    from roc_tpu_torch.parallel.distributed import run_ranks
    from roc_tpu_torch.train.trainer import TrainConfig
    ds = synthetic_dataset(96, 6, in_dim=16, num_classes=4, seed=0)
    m = str(tmp_path / "m.jsonl")
    cfg = TrainConfig(verbose=False, symmetric=True, aggr_impl="cuda",
                      epochs=4, eval_every=2, metrics_path=m)
    res = run_ranks(torch_rank_jobs.telemetry_job, 2,
                    model=build_gcn([16, 8, 4]), dataset=ds, config=cfg,
                    ev_dir=str(tmp_path))
    assert [r["evals"] for r in res] == [2, 2]
    np.testing.assert_array_equal(res[0]["losses"], res[1]["losses"])
    for rank in (0, 1):
        recs = [json.loads(ln)
                for ln in open(tmp_path / f"ev_p{rank}.jsonl")]
        (man,) = [r for r in recs if r["cat"] == "manifest"]
        assert (man["proc"], man["process_index"],
                man["process_count"]) == (rank, rank, 2)
        assert man["resolved"]["num_parts"] == 2 and \
            man["partition"]["num_parts"] == 2
        assert all(r["proc"] == rank for r in recs)
        assert [r["name"] for r in recs if r["cat"] == "compile"] == \
            ["train_step", "eval_step"]
    rows = [json.loads(ln) for ln in open(m)]
    assert sorted((r["proc"], r["epoch"]) for r in rows) == [
        (0, 1), (0, 3), (1, 1), (1, 3)]
    buf = io.StringIO()
    evs = [r for p in sorted(glob.glob(str(tmp_path / "ev_p*.jsonl")))
           for r in report.load_jsonl(p)]
    assert report.summarize(evs, rows, out=buf) == 0
    s = _sections(buf.getvalue())
    assert "proc0@" in s[""] and "proc1@" in s[""]
    rows = s["partition load balance"].splitlines()
    assert [r.split()[0] for r in rows[1:3]] == ["0", "1"]
    assert rows[3].startswith("  imbalance max/mean")


@pytest.mark.parametrize("argv", [[], ["--slo"]])
def test_report_needs_event_files(argv, capsys):
    with pytest.raises(SystemExit):
        report.main(argv)
    assert report.main(["/nonexistent/ev.jsonl"]) == 2
