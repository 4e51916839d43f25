"""The distributed timeline (``roc_tpu/obs/timeline.py``): merge N
per-process event and metrics JSONL streams into one Chrome-trace
(Perfetto) JSON.

Every record of the port's event bus carries the clock tuple ``(t, mono,
host, proc)`` (obs/events.py).  A partitioned trainer emits a
``clock_sync`` event at the first step's barrier, which every rank
crosses within a step of the others (train/trainer.py run_epoch_loop);
the merger pins those sync points to one instant, so the ranks' lanes
share one time axis whatever the hosts' wall clocks say.  A stream with
no ``clock_sync`` is placed by its own wall clock (``t - mono`` of its
first stamped record).

The output, which Perfetto and chrome://tracing load as they are:

- one process lane per ``(host, proc)`` stream, named ``proc<p>@<host>``;
- a ``phases`` thread with the span laps the trainers flush as
  ``timeline`` span batches (first_step / train / eval / the streamed
  head's phases) and the serve tier's ``route_request`` and
  ``serve_batch`` spans, with their request ids;
- an ``h2d`` thread with the staging pool's per-block spans;
- a ``markers`` thread with instant events: stall heartbeats, resilience
  faults and recoveries, rebalance decisions, the per-epoch straggler
  records (``costmodel`` events, kind=straggler), and the serve tier's
  failover, hedge and lifecycle markers;
- the first step of each step slot as an X span: the port's ``compile``
  events carry ``first_step_s`` (obs/compile_watch.py), the JAX
  package's ``lower_s`` + ``compile_s``; both are read.

``--request RID`` also prints one request's distributed trace
(:func:`request_trace`): the router's span, each replica microbatch that
served it and the markers that name it.

Given the same records, the output is the JAX package's merger's.  Like
``roc_tpu_torch/report.py`` this is a reader, stdlib only, importing
nothing of its package: ``python roc_tpu_torch/obs/timeline.py ...``
runs without torch; ``python -m roc_tpu_torch.timeline`` is the packaged
entry point.
"""

from __future__ import annotations

import argparse
import glob as _glob
import json
import os
import sys
from typing import Any, Dict, List, Optional, Tuple

# thread (tid) layout inside each process lane
TID_PHASES = 0
TID_H2D = 1
TID_MARKERS = 2
_TID_NAMES = {TID_PHASES: "phases", TID_H2D: "h2d",
              TID_MARKERS: "markers"}


def load_jsonl(path: str) -> List[Dict[str, Any]]:
    """Tolerant JSONL reader (the report's contract: a run killed
    mid-write leaves at most one torn tail line)."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if isinstance(rec, dict):
                out.append(rec)
    return out


def expand_paths(patterns: List[str]) -> List[str]:
    """Literal paths plus glob patterns, deduped, order-preserving —
    ``roc_tpu_torch.timeline ev_p*.jsonl`` merges a whole run's streams.
    A named-but-missing path (or a glob with zero matches) is KEPT so
    the caller's ``open()`` fails loudly: a merge that silently drops
    the dead process's stream is exactly the wrong post-mortem."""
    out: List[str] = []
    for p in patterns:
        hits = [p] if os.path.exists(p) else sorted(_glob.glob(p))
        for h in (hits or [p]):
            if h not in out:
                out.append(h)
    return out


def _proc_key(rec: Dict[str, Any]) -> Tuple[str, int]:
    """The stream identity half of the clock tuple; legacy records
    without it collapse into one lane."""
    try:
        proc = int(rec.get("proc", 0) or 0)
    except (TypeError, ValueError):
        proc = 0
    return (str(rec.get("host", "?")), proc)


def _median(vals: List[float]) -> float:
    vs = sorted(vals)
    n = len(vs)
    return vs[n // 2] if n % 2 else 0.5 * (vs[n // 2 - 1] + vs[n // 2])


def clock_offsets(events: List[Dict[str, Any]]
                  ) -> Dict[Tuple[str, int], Optional[float]]:
    """Per-process ``offset`` such that ``offset + mono`` places a
    record on the merged wall axis.

    Preferred anchor: the ``clock_sync`` handshake (all processes
    cross the first-step barrier near-simultaneously, so their sync
    points are pinned to the MEDIAN sync wall time — monotonic clocks
    then agree to barrier skew, not NTP skew).  Streams without a
    handshake fall back to wall-aligning their first stamped record;
    streams with no ``mono`` at all get None (their ``t`` is used
    directly)."""
    keys = {k: None for k in (_proc_key(r) for r in events)}
    syncs: Dict[Tuple[str, int], Dict[str, Any]] = {}
    firsts: Dict[Tuple[str, int], Dict[str, Any]] = {}
    for r in events:
        if r.get("t") is None or r.get("mono") is None:
            continue
        k = _proc_key(r)
        firsts.setdefault(k, r)
        if (r.get("cat") == "timeline"
                and r.get("kind") == "clock_sync" and k not in syncs):
            syncs[k] = r
    offsets: Dict[Tuple[str, int], Optional[float]] = dict(keys)
    ref_wall = (_median([float(s["t"]) for s in syncs.values()])
                if syncs else None)
    for k in offsets:
        if k in syncs and ref_wall is not None:
            offsets[k] = ref_wall - float(syncs[k]["mono"])
        elif k in firsts:
            r = firsts[k]
            offsets[k] = float(r["t"]) - float(r["mono"])
    return offsets


def _ts_s(rec: Dict[str, Any],
          offset: Optional[float]) -> Optional[float]:
    """A record's position on the merged wall axis (seconds)."""
    mono = rec.get("mono")
    if mono is not None and offset is not None:
        return offset + float(mono)
    t = rec.get("t")
    return float(t) if t is not None else None


def straggler_records(events: List[Dict[str, Any]]
                      ) -> List[Dict[str, Any]]:
    """The per-epoch straggler attribution table: one row per
    ``costmodel`` straggler event — which shard was (predicted)
    slowest for each measured lap, by how much over the mean."""
    out = []
    for r in events:
        if r.get("cat") == "costmodel" and r.get("kind") == "straggler":
            out.append({"epoch": r.get("epoch"),
                        "part": r.get("straggler_part"),
                        "ratio": r.get("straggler_ratio"),
                        "measured_ms": r.get("measured_ms"),
                        "proc": r.get("proc"),
                        "num_parts": r.get("num_parts")})
    out.sort(key=lambda d: (d["epoch"] is None, d["epoch"]))
    return out


def _marker(rec: Dict[str, Any]) -> Optional[Tuple[str, Dict[str, Any]]]:
    """(name, args) for records rendered as instant markers; None for
    records the merger represents some other way (or not at all)."""
    cat = rec.get("cat")
    if cat == "stall":
        return (f"stall:{rec.get('stage')}",
                {"elapsed_s": rec.get("elapsed_s"),
                 "beat": rec.get("beat")})
    if cat == "resilience":
        kind = rec.get("kind", "resilience")
        site = rec.get("site")
        return (f"{kind}:{site}" if site else str(kind),
                {"msg": rec.get("msg"), "epoch": rec.get("epoch")})
    if cat == "costmodel":
        if rec.get("kind") == "straggler":
            return (f"straggler:part{rec.get('straggler_part')}",
                    {"epoch": rec.get("epoch"),
                     "ratio": rec.get("straggler_ratio"),
                     "measured_ms": rec.get("measured_ms"),
                     "predicted_cost": rec.get("predicted_cost")})
        if "rebalance" in rec or "gain" in rec:
            return ("rebalance", {"msg": rec.get("msg"),
                                  "gain": rec.get("gain"),
                                  "recompile": rec.get("recompile")})
        return None
    if cat == "timeline" and rec.get("kind") == "clock_sync":
        return ("clock_sync", {"epoch": rec.get("epoch")})
    if cat == "serve":
        # server lifecycle markers on the serving process's lane (the
        # per-microbatch spans ride the ordinary span batches); router
        # failover/hedge markers carry the replica index, so a killed
        # replica's failover is findable on the timeline, and the
        # request id(s), so the marker joins the request's trace
        return (f"serve:{rec.get('kind', 'serve')}",
                {"msg": rec.get("msg"),
                 "n_queries": rec.get("n_queries"),
                 "rows": rec.get("rows"),
                 "replica": rec.get("replica"),
                 "requeued": rec.get("requeued"),
                 "version": rec.get("version"),
                 "rid": rec.get("rid"),
                 "rids": rec.get("rids") or None})
    if cat == "slo":
        # SLO breach/recovery transitions render as markers on the
        # emitting component's lane
        return (f"slo:{rec.get('kind', 'slo')}:{rec.get('slo')}",
                {"msg": rec.get("msg"), "spec": rec.get("spec"),
                 "burn": rec.get("burn"), "value": rec.get("value"),
                 "target": rec.get("target")})
    if cat in ("bench", "programspace", "run"):
        return (f"{cat}", {"msg": rec.get("msg")})
    return None


def merge_timeline(events: List[Dict[str, Any]],
                   metrics: Optional[List[Dict[str, Any]]] = None
                   ) -> Dict[str, Any]:
    """Merge already-loaded records into the Chrome-trace object.
    ``events`` may concatenate any number of per-process streams (the
    clock tuple identifies each record's lane); ``metrics`` records
    contribute per-eval epoch markers."""
    metrics = metrics or []
    offsets = clock_offsets(events + metrics)
    keys = sorted(offsets)
    pid_of = {k: i + 1 for i, k in enumerate(keys)}

    trace: List[Dict[str, Any]] = []
    for k in keys:
        pid = pid_of[k]
        trace.append({"ph": "M", "name": "process_name", "pid": pid,
                      "args": {"name": f"proc{k[1]}@{k[0]}"}})
        trace.append({"ph": "M", "name": "process_sort_index",
                      "pid": pid, "args": {"sort_index": k[1]}})
        for tid, tname in _TID_NAMES.items():
            trace.append({"ph": "M", "name": "thread_name", "pid": pid,
                          "tid": tid, "args": {"name": tname}})

    spans: List[Tuple[float, float, str, int, int, Dict[str, Any]]] = []
    instants: List[Tuple[float, str, int, int, Dict[str, Any]]] = []
    for rec in events:
        k = _proc_key(rec)
        off = offsets.get(k)
        pid = pid_of[k]
        ts = _ts_s(rec, off)
        if rec.get("cat") == "timeline" and rec.get("kind") == "spans":
            if off is None:
                continue    # mono-anchored batch with no alignment
            for lap in rec.get("spans") or []:
                try:
                    name, t0, ms = lap[0], float(lap[1]), float(lap[2])
                except (TypeError, ValueError, IndexError):
                    continue
                # optional 4th element: per-span args (the serving
                # tier stamps rids/batch/version there, which the
                # request traces join on); 3-element laps merge as is
                args = (lap[3] if len(lap) > 3
                        and isinstance(lap[3], dict) else {})
                tid = (TID_H2D if str(name).startswith("h2d")
                       else TID_PHASES)
                spans.append((off + t0, ms, str(name), pid, tid, args))
            continue
        if ts is None:
            continue
        if rec.get("cat") == "compile" and (
                "lower_s" in rec or "first_step_s" in rec):
            # the record is stamped when the first step (the JAX
            # package's lower + compile) has ended: the span ends there
            if "first_step_s" in rec:
                dur_ms = float(rec.get("first_step_s") or 0) * 1e3
                name = f"first_step:{rec.get('name')}"
            else:
                dur_ms = (float(rec.get("lower_s") or 0)
                          + float(rec.get("compile_s") or 0)) * 1e3
                name = f"compile:{rec.get('name')}"
            spans.append((ts - dur_ms / 1e3, dur_ms, name, pid,
                          TID_PHASES,
                          {"flops": rec.get("flops"),
                           "peak_bytes": rec.get("peak_bytes"),
                           "program_key": rec.get("program_key")}))
            continue
        mk = _marker(rec)
        if mk is not None:
            name, args = mk
            instants.append((ts, name, pid, TID_MARKERS, args))
    for rec in metrics:
        if rec.get("epoch") is None:
            continue
        ts = _ts_s(rec, offsets.get(_proc_key(rec)))
        if ts is None:
            continue
        args = {f: rec.get(f) for f in
                ("epoch_ms", "eval_ms", "train_loss", "overlap_frac",
                 "straggler_part", "straggler_ratio")
                if rec.get(f) is not None}
        instants.append((ts, f"epoch {int(rec['epoch'])}",
                         pid_of[_proc_key(rec)], TID_MARKERS, args))

    all_ts = [s[0] for s in spans] + [i[0] for i in instants]
    base = min(all_ts) if all_ts else 0.0
    for t0, ms, name, pid, tid, args in sorted(
            spans, key=lambda s: s[0]):
        trace.append({"ph": "X", "name": name, "cat": "span",
                      "ts": round((t0 - base) * 1e6, 1),
                      "dur": max(round(ms * 1e3, 1), 1.0),
                      "pid": pid, "tid": tid,
                      "args": {kk: v for kk, v in args.items()
                               if v is not None}})
    for ts, name, pid, tid, args in sorted(
            instants, key=lambda s: s[0]):
        trace.append({"ph": "i", "s": "t", "name": name,
                      "cat": "marker",
                      "ts": round((ts - base) * 1e6, 1),
                      "pid": pid, "tid": tid,
                      "args": {kk: v for kk, v in args.items()
                               if v is not None}})

    return {
        "displayTimeUnit": "ms",
        "traceEvents": trace,
        # non-standard top-level keys are preserved by Perfetto and
        # give the merged artifact a machine-readable summary (the JAX
        # package's key: a doc reads the same from either merger)
        "roc_tpu": {
            "processes": [{"pid": pid_of[k], "host": k[0],
                           "proc": k[1],
                           "aligned": offsets[k] is not None}
                          for k in keys],
            "base_wall_s": round(base, 3),
            "straggler": straggler_records(events),
        },
    }


def request_trace(doc: Dict[str, Any], rid: str) -> Dict[str, Any]:
    """One request's distributed trace, pulled from a merged doc: the
    router's ``route_request`` span, every replica microbatch span
    whose ``rids`` include it, and the hedge/failover markers carrying
    it — across however many process lanes the request touched.
    ``connected`` verifies the trace is ONE story: a router span
    exists and every other event overlaps it (small slack for
    clock-sync skew) — a hedged or failover-requeued request must
    still merge into a single connected trace, not orphaned
    fragments."""
    evs = []
    for ev in doc.get("traceEvents", []):
        if ev.get("ph") not in ("X", "i"):
            continue
        args = ev.get("args") or {}
        rids = args.get("rids")
        if args.get("rid") == rid or (
                isinstance(rids, list) and rid in rids):
            evs.append(ev)
    evs.sort(key=lambda e: e.get("ts", 0.0))
    lanes = sorted({e["pid"] for e in evs})
    routes = [e for e in evs if e.get("ph") == "X"
              and str(e.get("name", "")).startswith("route_request")]
    connected = bool(routes)
    slack_us = 50e3
    for r in routes:
        lo = r["ts"] - slack_us
        hi = r["ts"] + r.get("dur", 0.0) + slack_us
        for e in evs:
            if e is r:
                continue
            if not (lo <= e["ts"] <= hi):
                connected = False
    t0 = min((e["ts"] for e in evs), default=0.0)
    t1 = max((e["ts"] + e.get("dur", 0.0) for e in evs), default=0.0)
    return {"rid": rid,
            "n_events": len(evs),
            "lanes": lanes,
            "connected": connected,
            "span_ms": round((t1 - t0) / 1e3, 3),
            "events": [{"name": e.get("name"),
                        "ph": e.get("ph"),
                        "pid": e.get("pid"), "tid": e.get("tid"),
                        "ts_ms": round(e.get("ts", 0.0) / 1e3, 3),
                        "dur_ms": (round(e["dur"] / 1e3, 3)
                                   if e.get("dur") is not None
                                   else None),
                        "args": e.get("args") or {}}
                       for e in evs]}


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="roc_tpu_torch.timeline", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("events", nargs="+",
                    help="per-process event JSONL files (globs ok, "
                         "e.g. 'run_ev_p*.jsonl')")
    ap.add_argument("--metrics", action="append", default=[],
                    help="per-process metrics JSONL (repeatable; "
                         "globs ok)")
    ap.add_argument("-o", "--out", default="timeline_trace.json",
                    help="merged Chrome-trace/Perfetto JSON output "
                         "(default: %(default)s)")
    ap.add_argument("--request", default=None, metavar="RID",
                    help="also print the distributed trace of ONE "
                         "request id (router span, replica microbatch "
                         "spans, hedge/failover markers)")
    args = ap.parse_args(argv)

    ev_paths = expand_paths(args.events)
    if not ev_paths:
        print(f"error: no event files match {args.events}",
              file=sys.stderr)
        return 2
    events: List[Dict[str, Any]] = []
    for p in ev_paths:
        try:
            events.extend(load_jsonl(p))
        except OSError as e:
            print(f"error: cannot read {p}: {e}", file=sys.stderr)
            return 2
    metrics: List[Dict[str, Any]] = []
    for p in expand_paths(args.metrics):
        try:
            metrics.extend(load_jsonl(p))
        except OSError as e:
            print(f"error: cannot read {p}: {e}", file=sys.stderr)
            return 2

    doc = merge_timeline(events, metrics)
    with open(args.out, "w") as f:
        json.dump(doc, f)
    meta = doc["roc_tpu"]
    summary = {
        "out": args.out,
        "streams": len(ev_paths),
        "processes": len(meta["processes"]),
        "lanes": [p_["pid"] for p_ in meta["processes"]],
        "events": len(doc["traceEvents"]),
        "straggler": meta["straggler"][-8:],
    }
    if args.request:
        summary["request"] = request_trace(doc, args.request)
    # one machine-readable line: this CLI's stdout IS its product
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
