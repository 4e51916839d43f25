"""The port's timeline merger (roc_tpu_torch/obs/timeline.py) against the
JAX package's on the same records: the synthetic streams of the JAX
package's timeline tests (sync alignment, the unsynced wall fallback,
legacy records, h2d nesting, stragglers, hedged, requeued and orphan
request traces, an unknown rid), a real port fleet's event file (a
2-replica router on the CPU), two gloo ranks of the partitioned trainer,
and the CLI as a plain script without torch.
"""

import glob
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from roc_tpu.obs import timeline as jtl
from roc_tpu_torch.obs import timeline as tl

import torch_rank_jobs

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _ev(cat, t, mono, proc, host="hostA", **fields):
    return {"t": t, "mono": mono, "host": host, "proc": proc,
            "cat": cat, "msg": f"{cat} event", **fields}


def _stream(proc, mono_base, sync_wall=1000.0, host="hostA"):
    """One process's stream: a manifest, a clock_sync at ``sync_wall``
    (the processes' walls agree, their monotonic bases do not), a spans
    batch with a lap 0.5 s after the sync."""
    return [
        _ev("manifest", sync_wall - 2.0, mono_base - 2.0, proc, host=host),
        _ev("timeline", sync_wall, mono_base, proc, host=host,
            kind="clock_sync", epoch=0),
        _ev("timeline", sync_wall + 1.0, mono_base + 1.0, proc, host=host,
            kind="spans", spans=[["train", mono_base + 0.5, 400.0]]),
    ]


RID = "abc1-7"


def _request_run(hedge=False, failover=False, stray_s=None):
    """A 3-process serve run: the router (proc 0) routes RID, replica
    procs 1 and 2 run microbatch spans carrying it in their ``rids``."""
    events = [_ev("timeline", 1000.0, 100.0 + 500.0 * p, p,
                  kind="clock_sync", epoch=0) for p in range(3)]
    events.append(_ev("timeline", 1001.0, 101.0, 0, kind="spans",
                      spans=[["route_request", 100.2, 600.0,
                              {"rid": RID, "version": 3}]]))
    events.append(_ev("timeline", 1001.0, 601.0, 1, kind="spans",
                      spans=[["microbatch", 600.25, 120.0,
                              {"batch": 1, "rows": 4, "version": 3,
                               "rids": [RID]}],
                             ["microbatch", 600.05, 80.0,
                              {"batch": 0, "rows": 2, "version": 3,
                               "rids": ["other-1"]}]]))
    if hedge:
        events.append(_ev("serve", 1000.45, 100.45, 0, kind="hedge",
                          replica=2, rid=RID))
        events.append(_ev("timeline", 1001.0, 1101.0, 2, kind="spans",
                          spans=[["microbatch", 1100.5, 100.0,
                                  {"batch": 0, "rows": 4, "version": 3,
                                   "rids": [RID]}]]))
    if failover:
        events.append(_ev("serve", 1000.4, 100.4, 0, kind="failover",
                          replica=1, requeued=1, rids=[RID]))
        events.append(_ev("timeline", 1001.0, 1101.0, 2, kind="spans",
                          spans=[["microbatch", 1100.45, 150.0,
                                  {"batch": 0, "rows": 4, "version": 3,
                                   "rids": [RID]}]]))
    if stray_s is not None:
        events.append(_ev("timeline", 1003.0, 1103.0, 2, kind="spans",
                          spans=[["microbatch", 1100.0 + stray_s, 90.0,
                                  {"rids": [RID]}]]))
    return events


def _four_streams():
    return [e for p in range(4) for e in _stream(p, 100.0 + 500.0 * p)]


def _unsynced():
    return _stream(0, 100.0) + [
        _ev("manifest", 1000.5, 7.0, 1, host="hostB"),
        _ev("timeline", 1001.0, 7.5, 1, host="hostB", kind="spans",
            spans=[["train", 7.2, 100.0]])]


def _legacy():
    return [{"t": 10.0, "cat": "stall", "msg": "x", "stage": "s",
             "elapsed_s": 5.0},
            {"t": 11.0, "cat": "compile", "msg": "c",
             "name": "train_step", "lower_s": 0.5, "compile_s": 1.0}]


def _h2d():
    return [_ev("timeline", 1000.0, 50.0, 0, kind="clock_sync"),
            _ev("timeline", 1002.0, 52.0, 0, kind="spans",
                spans=[["head_forward", 50.5, 1000.0],
                       ["h2d_wait", 50.6, 20.0],
                       ["h2d_wait", 50.9, 15.0]])]


def _stragglers():
    return [_ev("timeline", 1000.0, 50.0, 0, kind="clock_sync"),
            _ev("costmodel", 1001.0, 51.0, 0, kind="straggler", epoch=3,
                straggler_part=2, straggler_ratio=1.4, measured_ms=120.0,
                num_parts=4),
            _ev("resilience", 1002.0, 52.0, 0, kind="fault",
                site="sigkill", epoch=4),
            _ev("costmodel", 1003.0, 53.0, 0, gain=0.2, rebalance=True,
                msg="rebalance"),
            _ev("slo", 1004.0, 54.0, 0, kind="breach", slo="p99",
                burn=14.4, value=120, target=100),
            _ev("stall", 1005.0, 55.0, 0, stage="first_compile",
                elapsed_s=30, beat=2)]


def _metrics():
    return [{"t": 1000.2, "mono": 100.2, "host": "hostA", "proc": 0,
             "epoch": 3, "epoch_ms": 40.0, "train_loss": 0.5},
            {"t": 1000.3, "mono": 600.3, "host": "hostA", "proc": 1,
             "epoch": None}]


CASES = {
    "sync_alignment": (_four_streams, None),
    "unsynced_wall_fallback": (_unsynced, None),
    "legacy_records": (_legacy, None),
    "h2d_nesting": (_h2d, None),
    "stragglers_and_markers": (_stragglers, None),
    "metrics_epoch_markers": (_four_streams, _metrics),
    "hedged": (lambda: _request_run(hedge=True), None),
    "requeued": (lambda: _request_run(failover=True), None),
    "orphan": (lambda: _request_run(stray_s=1.5), None),
}


def _same(a, b):
    """JSON equality: both docs serialise to the same text."""
    return json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)


@pytest.mark.parametrize("case", sorted(CASES))
def test_merge_equals_the_jax_mergers(case):
    """The same records through both mergers give JSON-equal docs, the
    clock offsets and straggler tables equal; each request trace of the
    serve runs (RID, the other request, an unknown rid) equal too."""
    make, make_metrics = CASES[case]
    events = make()
    metrics = make_metrics() if make_metrics else None
    assert tl.clock_offsets(events) == jtl.clock_offsets(events)
    assert tl.straggler_records(events) == jtl.straggler_records(events)
    doc = tl.merge_timeline(events, metrics)
    assert _same(doc, jtl.merge_timeline(events, metrics))
    for rid in (RID, "other-1", "nope-0"):
        assert _same(tl.request_trace(doc, rid),
                     jtl.request_trace(doc, rid))


def test_request_traces_read_as_the_jax_tests_say():
    """The JAX package's verdicts on the port's merger: a hedged request
    is one connected trace over three lanes without the other request's
    microbatch; a requeued one carries the failover marker; an orphan
    fragment breaks connectivity; an unknown rid is empty; four synced
    lanes start their laps together."""
    tr = tl.request_trace(tl.merge_timeline(_request_run(hedge=True)), RID)
    assert (tr["connected"], tr["n_events"], len(tr["lanes"])) == \
        (True, 4, 3)
    assert all("other-1" not in (e["args"].get("rids") or [])
               for e in tr["events"])
    tr = tl.request_trace(tl.merge_timeline(_request_run(failover=True)),
                          RID)
    marker = next(e for e in tr["events"] if e["name"] == "serve:failover")
    assert tr["connected"] and marker["args"]["replica"] == 1
    tr = tl.request_trace(tl.merge_timeline(_request_run(stray_s=1.5)), RID)
    assert (tr["n_events"], tr["connected"]) == (3, False)
    tr = tl.request_trace(tl.merge_timeline(_request_run()), "nope-0")
    assert (tr["n_events"], tr["connected"]) == (0, False)
    spans = [e for e in tl.merge_timeline(_four_streams())["traceEvents"]
             if e["ph"] == "X"]
    assert len({e["pid"] for e in spans}) == 4
    assert max(e["ts"] for e in spans) - min(e["ts"] for e in spans) < 1.0


def test_first_step_span_reads_both_namings():
    """The port's ``compile`` record (``first_step_s``) draws a
    ``first_step:<slot>`` span ending at its stamp; the JAX package's
    (``lower_s`` + ``compile_s``) its ``compile:<slot>`` span, as the
    JAX merger draws it."""
    evs = [_ev("timeline", 1000.0, 50.0, 0, kind="clock_sync"),
           _ev("compile", 1002.0, 52.0, 0, name="train_step",
               first_step_s=1.5, flops=3e9, peak_bytes=None),
           _ev("compile", 1003.0, 53.0, 0, name="eval_step",
               lower_s=0.25, compile_s=0.5, flops=1e9)]
    doc = tl.merge_timeline(evs)
    spans = {e["name"]: e for e in doc["traceEvents"] if e["ph"] == "X"}
    assert spans["first_step:train_step"]["dur"] == 1.5e6
    assert spans["first_step:train_step"]["args"] == {"flops": 3e9}
    assert spans["compile:eval_step"]["dur"] == 0.75e6
    assert spans["compile:eval_step"]["ts"] + 0.75e6 == \
        spans["first_step:train_step"]["ts"] + 1.5e6 + 1e6
    jspans = {e["name"] for e in jtl.merge_timeline(evs)["traceEvents"]
              if e["ph"] == "X"}
    assert jspans == {"compile:eval_step"}


# ------------------------------------------------- a port fleet's events

@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    """A sharded 2-replica router on the CPU with ``ROC_TPU_EVENTS`` set:
    the router process and both replicas append to one file.  Requests of
    1, 8 and 64 rows and one of 64 across the seam (over the gather
    rider cap, so split between the replicas); then a second router of
    one replica in the same process, unarmed, answers one request.
    Returns the file, the seam request's rid, the merged doc and every
    request's rid."""
    from roc_tpu_torch.core.graph import synthetic_dataset
    from roc_tpu_torch.models import model_builders
    from roc_tpu_torch.obs import events
    from roc_tpu_torch.serve.export import build_predictor, export_predictor
    from roc_tpu_torch.serve.router import Router
    from roc_tpu_torch.train.trainer import TrainConfig
    tmp = tmp_path_factory.mktemp("fleet")
    ds = synthetic_dataset(2000, 6, in_dim=24, num_classes=5, seed=0)
    model = model_builders()["sgc"]([24, 5], dropout_rate=0.5, k=2)
    pred = build_predictor(model, ds, TrainConfig(symmetric=True, seed=3),
                           device="cpu", backend="auto")
    art = str(tmp / "art")
    seam = export_predictor(pred, art, shards=2)["shards"]["plan"][0][1]
    ev = str(tmp / "ev.jsonl")
    env = dict(os.environ, ROC_TPU_EVENTS=ev)
    env.pop("ROC_TPU_FAULT", None)
    sink = events.JsonlSink(ev)
    bus = events.get_bus()
    bus.add_sink(sink)
    try:
        with Router(art, n_replicas=2, cpu=True, sharded=True, env=env,
                    replica_args=["--drain-timeout", "3"],
                    default_deadline_ms=30_000.0) as r:
            futs = [r.submit(np.arange(n)) for n in (1, 8, 64)]
            futs.append(r.submit(np.arange(seam - 32, seam + 32)))
            for fut in futs:
                fut.result(timeout=60)
    finally:
        bus.sinks.remove(sink)
        sink.close()
    env.pop("ROC_TPU_EVENTS")
    with Router(art, n_replicas=1, cpu=True, env=env,
                replica_args=["--drain-timeout", "3"]) as r:
        futs.append(r.submit([0, 1]))
        futs[-1].result(timeout=60)
    return (ev, futs[3].rid, tl.merge_timeline(tl.load_jsonl(ev)),
            [f.rid for f in futs])


def test_fleet_files_merge_as_the_jax_merger_merges_them(fleet):
    """A real fleet's file, whole lines from three processes: both
    mergers give JSON-equal docs and request traces."""
    ev, rid, doc, _ = fleet
    with open(ev) as f:
        lines = [ln for ln in f if ln.strip()]
    assert len(tl.load_jsonl(ev)) == len(lines)     # no torn line
    recs = tl.load_jsonl(ev)
    assert _same(doc, jtl.merge_timeline(recs))
    assert _same(tl.request_trace(doc, rid), jtl.request_trace(doc, rid))


def test_fleet_seam_request_joins_the_router_and_both_replicas(fleet):
    """One lane per process (the router's, proc 0, and each replica's,
    proc 1 + index); the seam request's trace is connected over all three
    lanes: the router's route_request span and a serve_batch span on each
    replica, inside the route span."""
    ev, rid, doc, _ = fleet
    procs = sorted(p["proc"] for p in doc["roc_tpu"]["processes"])
    assert procs == [0, 1, 2]
    assert all(p["aligned"] for p in doc["roc_tpu"]["processes"])
    tr = tl.request_trace(doc, rid)
    assert tr["connected"] and len(tr["lanes"]) == 3, tr
    (route,) = [e for e in tr["events"] if e["name"] == "route_request"]
    batches = [e for e in tr["events"] if e["name"] == "serve_batch"]
    assert len({e["pid"] for e in batches}) == 2
    for e in batches:
        assert route["ts_ms"] - 1.0 <= e["ts_ms"]
        assert e["ts_ms"] + e["dur_ms"] <= \
            route["ts_ms"] + route["dur_ms"] + 1.0


def test_timeline_cli_as_a_plain_script_without_torch(fleet, tmp_path):
    """``python roc_tpu_torch/obs/timeline.py`` with ``--request``, torch
    blocked from import: exit 0, the Chrome trace written, the summary
    line's request trace equal to the in-process one."""
    ev, rid, doc, _ = fleet
    out = str(tmp_path / "trace.json")
    block = ("import sys, runpy; sys.modules['torch'] = None; "
             "sys.argv = sys.argv[1:]; "
             "runpy.run_path(sys.argv[0], run_name='__main__')")
    r = subprocess.run([sys.executable, "-c", block,
                        os.path.join(_REPO, "roc_tpu_torch", "obs",
                                     "timeline.py"),
                        ev, "-o", out, "--request", rid],
                       capture_output=True, text=True, timeout=60,
                       cwd=str(tmp_path))
    assert r.returncode == 0, r.stderr
    summary = json.loads(r.stdout.strip().splitlines()[-1])
    assert summary["processes"] == 3
    assert _same(summary["request"], tl.request_trace(doc, rid))
    with open(out) as f:
        assert _same(json.load(f), doc)


def test_routers_of_one_process_mint_distinct_rids(fleet):
    """Two routers in one process: every request id distinct (the trace
    joins its lanes on it)."""
    rids = fleet[3]
    assert len(rids) == 5 and len(set(rids)) == 5
    assert len({r.split("-")[0] for r in rids}) == 1     # one process


def test_timeline_cli_refuses_a_missing_file(tmp_path, capsys):
    assert tl.main([str(tmp_path / "nope.jsonl"),
                    "-o", str(tmp_path / "t.json")]) == 2
    assert "cannot read" in capsys.readouterr().err


# -------------------------------------------- two ranks of the trainer

def test_two_gloo_ranks_merge_into_a_lane_each(tmp_path):
    """Two gloo ranks of the partitioned trainer, each with its own event
    file: the merge of both (a glob) has one lane per rank, aligned on
    the first-step clock_sync, each with its first-step and train spans,
    and the straggler rows of the ranks' evals."""
    from roc_tpu_torch.core.graph import synthetic_dataset
    from roc_tpu_torch.models.gcn import build_gcn
    from roc_tpu_torch.parallel.distributed import run_ranks
    from roc_tpu_torch.train.trainer import TrainConfig
    ds = synthetic_dataset(96, 6, in_dim=16, num_classes=4, seed=0)
    cfg = TrainConfig(verbose=False, symmetric=True, aggr_impl="cuda",
                      epochs=4, eval_every=2,
                      metrics_path=str(tmp_path / "m.jsonl"))
    res = run_ranks(torch_rank_jobs.telemetry_job, 2,
                    model=build_gcn([16, 8, 4]), dataset=ds, config=cfg,
                    ev_dir=str(tmp_path))
    assert [r["evals"] for r in res] == [2, 2]
    out = str(tmp_path / "trace.json")
    assert tl.main([str(tmp_path / "ev_p*.jsonl"), "--metrics",
                    str(tmp_path / "m.jsonl"), "-o", out]) == 0
    with open(out) as f:
        doc = json.load(f)
    meta = doc["roc_tpu"]
    assert sorted(p["proc"] for p in meta["processes"]) == [0, 1]
    assert all(p["aligned"] for p in meta["processes"])
    recs = [r for p in sorted(glob.glob(str(tmp_path / "ev_p*.jsonl")))
            for r in tl.load_jsonl(p)]
    syncs = [r for r in recs if r.get("kind") == "clock_sync"]
    assert sorted(r["proc"] for r in syncs) == [0, 1]
    for pid in (1, 2):
        names = {e["name"] for e in doc["traceEvents"]
                 if e["ph"] == "X" and e["pid"] == pid}
        assert {"first_step", "train", "first_step:train_step"} <= names
    rows = meta["straggler"]
    assert sorted((r["proc"], r["epoch"]) for r in rows) == \
        [(0, 1), (0, 3), (1, 1), (1, 3)]
    assert all(r["num_parts"] == 2 and r["part"] in (0, 1) for r in rows)
