"""Run-report CLI (``roc_tpu/report.py``): summarize event and metrics
JSONL artifacts into tables.

``python -m roc_tpu_torch.report ev.jsonl [ev_p1.jsonl ...|'ev_p*.jsonl']
[--metrics m.jsonl [--metrics m2.jsonl ...]] [--slo [SNAPSHOT]]``

Accepts several event files (repeat the positional, or pass a glob): a
partitioned run may write one JSONL per rank, and the report merges them
(each record's clock tuple ``host``/``proc`` names its stream; a
"processes" header shows what was merged).

Renders, from the artifacts a run with ``--events``/``--metrics`` leaves
behind:

- the run manifest (what code, hardware and config executed);
- the first step of each step slot: its wall time, FLOPs (the kernels'
  tally apart) and the card's peak beside the memory model's bytes
  (obs/compile_watch.py; a JAX package stream's ``compile`` events read
  the same, its lower + compile time as the first step's);
- per-phase spans (first step / train / eval / the streamed head's
  phases) as p50/p90;
- throughput (edges/s, TFLOP/s, MFU where the card's peak is known);
- the streamed tier's pipeline, the partition's balance and the cost
  model's decisions, the resilience lifecycle, SLO transitions and stall
  heartbeats.

``--slo SNAPSHOT`` renders a metrics-registry snapshot
(``MetricsRegistry.dump``) as the live dashboard; a bare ``--slo`` only
the SLO transitions of the event files.  ``--concurrency FILE`` and
``--protocol FILE`` render the analysis CLI's ``--json`` payload
(``python -m roc_tpu_torch.analysis --json``): the thread model and the
wire vocabulary, model-check verdicts and transition sites; without them
the same tables come from the ``concurrency_surface``/``protocol_surface``
events of an audited run's stream.  The JAX report's ``--sharding`` and
program-space views read XLA programs the port does not have, and are
not ported.

A reader: it works on the artifacts of a dead run and imports neither
torch nor anything of its package, so it runs anywhere as a plain
script too: ``python roc_tpu_torch/report.py ev.jsonl``.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List, Optional


def load_jsonl(path: str) -> List[Dict[str, Any]]:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except ValueError:
                # a run killed mid-write leaves at most one torn tail
                # line; skip it rather than refuse the whole artifact
                continue
    return out


def _fmt_bytes(n: Optional[float]) -> str:
    if n is None:
        return "?"
    if abs(n) >= 1 << 28:
        return f"{n / 1024**3:.2f}GiB"
    if abs(n) >= 1 << 17:
        return f"{n / 1024**2:.1f}MiB"
    return f"{n / 1024:.1f}KiB"


def _pct(values: List[float], q: float) -> float:
    vs = sorted(values)
    if not vs:
        return 0.0
    idx = min(len(vs) - 1, max(0, int(round(q * (len(vs) - 1)))))
    return vs[idx]


def _rows(title: str, header: List[str],
          rows: List[List[str]], out) -> None:
    print(f"\n== {title} ==", file=out)
    if not rows:
        print("  (none)", file=out)
        return
    widths = [max(len(h), *(len(r[i]) for r in rows))
              for i, h in enumerate(header)]
    print("  " + "  ".join(h.ljust(w) for h, w in zip(header, widths)),
          file=out)
    for r in rows:
        print("  " + "  ".join(c.ljust(w) for c, w in zip(r, widths)),
              file=out)


def _stream_key(rec: Dict[str, Any]):
    try:
        proc = int(rec.get("proc", 0) or 0)
    except (TypeError, ValueError):
        proc = 0
    return (str(rec.get("host", "?")), proc)


def _first_step_s(e: Dict[str, Any]) -> float:
    """A ``compile`` event's first-step seconds: the port's
    ``first_step_s``, or the JAX package's ``lower_s + compile_s``."""
    if "first_step_s" in e:
        return float(e["first_step_s"] or 0)
    return float(e.get("lower_s", 0) or 0) + float(e.get("compile_s", 0)
                                                   or 0)


def summarize(events: List[Dict[str, Any]],
              metrics: Optional[List[Dict[str, Any]]] = None,
              out=None, concurrency: Optional[Dict[str, Any]] = None,
              protocol: Optional[Dict[str, Any]] = None) -> int:
    out = out if out is not None else sys.stdout

    # merged multi-process artifacts: say what was merged before
    # aggregating across it
    streams: Dict[Any, int] = {}
    for e in events:
        k = _stream_key(e)
        streams[k] = streams.get(k, 0) + 1
    if len(streams) > 1:
        print("processes (merged event streams):", file=out)
        for (host, proc), n in sorted(streams.items(),
                                      key=lambda kv: kv[0][1]):
            print(f"  proc{proc}@{host}: {n} events", file=out)

    manifests = [e for e in events if e.get("cat") == "manifest"]
    if manifests:
        m = manifests[-1]
        res = m.get("resolved") or {}
        ds = m.get("dataset") or {}
        runtime = (f"jax={m.get('jax_version')}" if "jax_version" in m
                   else f"torch={m.get('torch_version')} "
                        f"cuda={m.get('cuda_version')}")
        print("run manifest:", file=out)
        print(f"  platform={m.get('platform')} "
              f"devices={m.get('device_count')} "
              f"kinds={m.get('device_kinds')} "
              f"{runtime} "
              f"sha={(m.get('git_sha') or 'none')[:12]}", file=out)
        print(f"  dataset={ds.get('name')} V={ds.get('num_nodes')} "
              f"E={ds.get('num_edges')}", file=out)
        print("  resolved: " + " ".join(
            f"{k}={v}" for k, v in res.items()), file=out)
    else:
        print("run manifest: (none recorded)", file=out)

    decisions = [e for e in events
                 if e.get("cat") in ("resolve", "plan")]
    _rows("decisions (resolve/plan)", ["cat", "message"],
          [[e["cat"], str(e.get("msg", ""))[:96]] for e in decisions],
          out)

    firsts = [e for e in events if e.get("cat") == "compile"
              and ("first_step_s" in e or "lower_s" in e)]
    rows = []
    for e in firsts:
        modeled, peak = e.get("modeled_bytes"), e.get("peak_bytes")
        ratio = (f"{peak / modeled:.2f}x"
                 if peak is not None and modeled else "?")
        flops, kern = e.get("flops"), e.get("flops_kernels")
        rows.append([
            str(e.get("name")), f"{_first_step_s(e):.2f}s",
            f"{flops:.3g}" if flops is not None else "?",
            f"{kern:.3g}" if kern is not None else "-",
            _fmt_bytes(e.get("bytes_accessed")),
            _fmt_bytes(peak), _fmt_bytes(modeled), ratio])
    _rows("first step (per step slot)",
          ["step", "first_step", "flops", "kernel_flops", "bytes", "peak",
           "modeled", "actual/model"], rows, out)

    # phase spans: the trainer emits a final spans summary; fall back to
    # the per-eval epoch events / metrics records
    span_events = [e for e in events
                   if e.get("cat") == "epoch" and e.get("spans")]
    rows = []
    if span_events:
        for name, s in span_events[-1]["spans"].items():
            rows.append([name, str(s.get("n")),
                         f"{s.get('p50_ms', 0):.1f}",
                         f"{s.get('p90_ms', 0):.1f}",
                         f"{s.get('total_ms', 0):.0f}"])
    else:
        series: Dict[str, List[float]] = {}
        recs = [e for e in events if e.get("cat") == "epoch"]
        recs += metrics or []
        for e in recs:
            for k in ("epoch_ms", "eval_ms", "compile_ms", "first_step_ms"):
                if isinstance(e.get(k), (int, float)):
                    series.setdefault(k[:-3], []).append(float(e[k]))
        for name, vs in series.items():
            rows.append([name, str(len(vs)), f"{_pct(vs, 0.5):.1f}",
                         f"{_pct(vs, 0.9):.1f}", f"{sum(vs):.0f}"])
    _rows("phase spans (ms)",
          ["phase", "n", "p50", "p90", "total"], rows, out)

    thr: Dict[str, List[float]] = {}
    for e in ([x for x in events if x.get("cat") == "epoch"]
              + (metrics or [])):
        for k in ("edges_per_s", "tflops_per_s", "mfu"):
            if isinstance(e.get(k), (int, float)):
                thr.setdefault(k, []).append(float(e[k]))
    rows = [[k, f"{_pct(vs, 0.5):.4g}", f"{max(vs):.4g}"]
            for k, vs in thr.items()]
    _rows("throughput", ["metric", "p50", "max"], rows, out)

    # the streamed tier: overlap_frac = the share of host->device
    # staging hidden under compute, h2d_wait_p50_ms the un-hidden stall
    # a block
    pipe: Dict[str, List[float]] = {}
    for e in ([x for x in events
               if x.get("cat") in ("epoch", "pipeline")]
              + (metrics or [])):
        for k in ("overlap_frac", "h2d_wait_p50_ms",
                  "h2d_stage_p50_ms", "prefetch_depth",
                  "hop_compute_ms", "hop_permute_ms"):
            if isinstance(e.get(k), (int, float)):
                pipe.setdefault(k, []).append(float(e[k]))
    rows = [[k, f"{_pct(vs, 0.5):.4g}", f"{min(vs):.4g}",
             f"{max(vs):.4g}"] for k, vs in pipe.items()]
    _rows("pipeline (h2d prefetch / ring overlap)",
          ["metric", "p50", "min", "max"], rows, out)

    # the partition's balance: the manifest's split-quality record and
    # the cost model's decisions
    part = (manifests[-1].get("partition") or {}) if manifests else {}
    rows = []
    if part.get("real_edges"):
        cols = [part.get(k) or [] for k in
                ("padded_edges", "padded_nodes", "halo_in",
                 "halo_out")]
        for p, re_ in enumerate(part["real_edges"][:16]):
            rows.append([str(p), str(re_)]
                        + [str(c[p]) if p < len(c) else "?"
                           for c in cols])
        if len(part["real_edges"]) > 16:
            rows.append(["...", "", "", "", "", ""])
    _rows("partition load balance",
          ["part", "real_edges", "padded_edges", "padded_nodes",
           "halo_in", "halo_out"], rows, out)
    if part:
        print(f"  imbalance max/mean: edges "
              f"{part.get('edge_imbalance')} nodes "
              f"{part.get('node_imbalance')}  (padded shard "
              f"{part.get('part_nodes')} nodes x "
              f"{part.get('part_edges')} edges)", file=out)
    cm = [e for e in events if e.get("cat") == "costmodel"
          and ("rebalance" in e or "gain" in e)]
    _rows("cost model (rebalance decisions)", ["message"],
          [[str(e.get("msg", ""))[:110]] for e in cm], out)

    # resilience: injected drill faults, recovery retries, corrupt-
    # checkpoint fallbacks, preemptions, elastic restores
    res = [e for e in events if e.get("cat") == "resilience"]
    by_kind: Dict[str, List[Dict[str, Any]]] = {}
    for e in res:
        by_kind.setdefault(str(e.get("kind", "?")), []).append(e)
    rows = [[kind, str(len(es)), str(es[-1].get("msg", ""))[:84]]
            for kind, es in sorted(by_kind.items())]
    _rows("resilience (faults injected / recoveries)",
          ["kind", "n", "last"], rows, out)

    # the concurrency surface: the auditor's thread model — every thread,
    # sync object and signal handler per module.  Source: the
    # ``--concurrency`` payload (``python -m roc_tpu_torch.analysis
    # --select concurrency --json``), or the ``concurrency_surface``
    # analysis event an audited run leaves in its stream
    conc = concurrency
    if conc is None:
        evs = [e for e in events if e.get("cat") == "analysis"
               and e.get("kind") == "concurrency_surface"]
        if evs:
            conc = {"modules": evs[-1].get("modules") or [],
                    "totals": evs[-1].get("totals") or {}}
    summarize_concurrency(conc or {}, out)

    # the protocol surface: the wire vocabulary and the model checker's
    # verdicts.  Source: the ``--protocol`` payload, or the
    # ``protocol_surface`` event an audited run leaves in its stream
    proto = protocol
    if proto is None:
        evs = [e for e in events if e.get("kind") == "protocol_surface"]
        if evs:
            proto = {"channels": evs[-1].get("channels") or [],
                     "models": evs[-1].get("models") or [],
                     "totals": evs[-1].get("totals") or {}}
    if proto:
        summarize_protocol(proto, out)

    summarize_slo_events(events, out)

    stalls = [e for e in events if e.get("cat") == "stall"]
    by_stage: Dict[str, List[float]] = {}
    for e in stalls:
        by_stage.setdefault(str(e.get("stage")), []).append(
            float(e.get("elapsed_s", 0)))
    rows = [[st, str(len(vs)), f"{max(vs):.0f}s"]
            for st, vs in by_stage.items()]
    _rows("stalls (heartbeats)", ["stage", "beats", "max_wait"],
          rows, out)
    return 0


def summarize_concurrency(surface: Dict[str, Any], out=None) -> int:
    """Render the concurrency surface: per module, its threads (target,
    daemon), sync objects and signal handlers.  Input: the
    ``concurrency_surface`` of ``python -m roc_tpu_torch.analysis
    --select concurrency --json``, or the equivalent analysis event."""
    out = out if out is not None else sys.stdout
    rows = []
    for mod in surface.get("modules", []):
        threads = ", ".join(
            (str(t.get("target") or "?")
             + ("(daemon)" if t.get("daemon") else ""))
            for t in mod.get("threads", [])) or "-"
        locks = ", ".join(
            f"{lk.get('name')}[{lk.get('kind')}]"
            for lk in mod.get("locks", [])) or "-"
        handlers = ", ".join(str(h.get("handler") or "?")
                             for h in mod.get("handlers", [])) or "-"
        rows.append([str(mod.get("module", "?")), threads, locks,
                     handlers])
    _rows("concurrency surface (threads / sync objects / handlers)",
          ["module", "threads", "sync objects", "signal handlers"],
          rows, out)
    return 0


def summarize_protocol(surface: Dict[str, Any], out=None) -> int:
    """Render the protocol audit: the per-channel wire vocabulary (kind,
    field contract, send/handle sites, drift status), each dispatcher's
    unknown-kind rejection, the bounded model checker's per-model state
    counts and invariant verdicts (with the counterexample schedule of a
    violation), and the lifecycle/commit transition sites.  Input: the
    ``protocol_surface`` of ``python -m roc_tpu_torch.analysis --select
    protocol --json``, or the equivalent ``protocol`` event."""
    out = out if out is not None else sys.stdout
    for chan in surface.get("channels") or []:
        rows = []
        for kind, k in sorted((chan.get("kinds") or {}).items()):
            sent_at = ",".join(str(x) for x in k.get("sent_at") or [])
            if not sent_at:
                sent_at = ("(by design)" if k.get("sent") is False
                           else "-")
            rows.append([
                kind,
                ",".join(k.get("required") or []) or "?",
                ",".join(k.get("optional") or []) or "-",
                sent_at,
                ",".join(str(x) for x in k.get("handled_at") or [])
                or "-",
                str(k.get("status", "?"))])
        _rows(f"wire vocabulary: {chan.get('name')} "
              f"({chan.get('sender')} -> {chan.get('receiver')})",
              ["kind", "required", "optional", "sent@", "handled@",
               "status"], rows, out)
        rej = ", ".join(
            f"{d.get('func')}:{d.get('line')}"
            + ("" if d.get("rejects_unknown") else " [NO REJECTION]")
            for d in chan.get("dispatchers") or []) or "(none)"
        print(f"  unknown-kind rejection: {rej}", file=out)
    rows = [[str(m.get("model", "?")), str(m.get("states")),
             str(m.get("transitions")),
             "yes" if m.get("complete") else "BUDGET EXHAUSTED",
             str(len(m.get("violations") or [])),
             ", ".join(m.get("invariants") or [])]
            for m in surface.get("models") or []]
    _rows("protocol models (bounded exhaustive exploration)",
          ["model", "states", "transitions", "complete",
           "violations", "invariants"], rows, out)
    for m in surface.get("models") or []:
        for v in m.get("violations") or []:
            print(f"  VIOLATION {m.get('model')}/"
                  f"{v.get('invariant')}: {v.get('msg')}", file=out)
            sched = " -> ".join(v.get("trace") or [])
            print(f"    schedule: {sched or '<initial state>'}",
                  file=out)
    rows = [[str(s.get("machine", "?")), str(s.get("module", "?")),
             str(s.get("site", "?")), str(s.get("line") or "-"),
             "yes" if s.get("present") else "MISSING"]
            for s in surface.get("sites") or []]
    _rows("protocol transition sites",
          ["machine", "module", "site", "line", "present"], rows, out)
    return 0


def _load_surface(path: str, key: str) -> Optional[Dict[str, Any]]:
    """The ``key`` surface of an analysis ``--json`` payload (or a bare
    surface dict) at ``path``; None after printing the error when the
    file cannot be read."""
    try:
        with open(path) as f:
            payload = json.load(f)
    except (OSError, ValueError) as e:
        print(f"error: cannot read {path}: {e}", file=sys.stderr)
        return None
    surface = payload.get(key, payload) if isinstance(payload, dict) \
        else None
    return surface if isinstance(surface, dict) else {}


def summarize_slo_events(events: List[Dict[str, Any]],
                         out=None) -> int:
    """The dated SLO transition table: one row per burn-rate breach or
    recovery event (``cat=slo``), wall-clock stamped."""
    import time as _time
    out = out if out is not None else sys.stdout
    rows = []
    for e in events:
        if e.get("cat") != "slo":
            continue
        t = e.get("t")
        when = (_time.strftime("%Y-%m-%d %H:%M:%S",
                               _time.localtime(float(t)))
                if t is not None else "?")
        rows.append([when, str(e.get("kind", "?")),
                     str(e.get("slo", "?")),
                     str(e.get("component", "?")),
                     f"{float(e.get('burn', 0)):.1f}x",
                     str(e.get("value")),
                     str(e.get("target")),
                     str(e.get("spec", ""))[:48]])
    _rows("slo transitions (burn-rate alerts)",
          ["when", "kind", "slo", "component", "burn", "value",
           "target", "spec"], rows, out)
    return 0


def summarize_slo(doc: Dict[str, Any], out=None) -> int:
    """Render one metrics-registry snapshot (``MetricsRegistry.dump``,
    the Router's ``ROC_TPU_SLO_SNAPSHOT``) as the live text dashboard:
    the SLO verdict first (health and each objective's burn and value),
    then every counter, gauge and histogram with its windowed view."""
    out = out if out is not None else sys.stdout
    windows = [int(w) for w in doc.get("windows_s") or []]
    print(f"slo dashboard: registry '{doc.get('registry', '?')}'"
          + (f"  component={doc['component']}"
             if doc.get("component") else "")
          + (f"  t={doc['t']}" if doc.get("t") is not None else ""),
          file=out)
    health = doc.get("health")
    if health is not None:
        verdict = "OK" if health.get("ok") else "BREACH"
        line = f"  health: {verdict}"
        if health.get("replicas") is not None:
            line += (f"  ({health.get('replicas_alive', '?')}/"
                     f"{health['replicas']} replicas alive)")
        print(line, file=out)
        rows = []
        for ob in health.get("objectives") or []:
            state = (health.get("states") or {}).get(
                ob.get("name"), "?")
            rows.append([str(ob.get("name")),
                         str(ob.get("spec", ""))[:52],
                         state,
                         "yes" if ob.get("compliant") else "NO",
                         str(ob.get("value")),
                         str(ob.get("target")),
                         f"{float(ob.get('burn', 0)):.2f}x",
                         f"{float(ob.get('bad_frac', 0)):.4f}",
                         f"{float(ob.get('budget', 0)):.4f}"])
        _rows("objectives",
              ["name", "spec", "state", "compliant", "value",
               "target", "burn", "bad_frac", "budget"], rows, out)
    metrics = doc.get("metrics") or {}
    rows = []
    for name in sorted(metrics):
        m = metrics[name]
        if m.get("kind") == "counter":
            rows.append([name, str(m.get("total"))]
                        + [str(m.get(f"sum_{w}s", "?"))
                           for w in windows])
    _rows("counters", ["name", "total"]
          + [f"sum_{w}s" for w in windows], rows, out)
    rows = []
    for name in sorted(metrics):
        m = metrics[name]
        if m.get("kind") == "gauge":
            rows.append([name, str(m.get("value")),
                         str(m.get("ewma", "-")), str(m.get("n"))])
    _rows("gauges", ["name", "value", "ewma", "n"], rows, out)
    rows = []
    for name in sorted(metrics):
        m = metrics[name]
        if m.get("kind") == "histogram":
            row = [name, str(m.get("total")), str(m.get("mean"))]
            for w in windows:
                row += [str(m.get(f"n_{w}s", "?")),
                        str(m.get(f"p50_{w}s")),
                        str(m.get(f"p99_{w}s"))]
            rows.append(row)
    hdr = ["name", "total", "mean"]
    for w in windows:
        hdr += [f"n_{w}s", f"p50_{w}s", f"p99_{w}s"]
    _rows("histograms (ms)", hdr, rows, out)
    return 0


def _expand(patterns: List[str]) -> List[str]:
    """Literal paths plus glob patterns, deduped, order-preserving; a
    missing path or a glob without a match is kept, so the open() below
    fails loudly."""
    import glob as _glob
    import os
    out: List[str] = []
    for p in patterns:
        hits = [p] if os.path.exists(p) else sorted(_glob.glob(p))
        for h in (hits or [p]):
            if h not in out:
                out.append(h)
    return out


def _load_all(paths: List[str]) -> Optional[List[Dict[str, Any]]]:
    """The records of every file of ``paths`` (globs expanded); None
    after printing the error when one cannot be read."""
    recs: List[Dict[str, Any]] = []
    for path in _expand(paths):
        try:
            recs.extend(load_jsonl(path))
        except OSError as e:
            print(f"error: cannot read {path}: {e}", file=sys.stderr)
            return None
    return recs


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="roc_tpu_torch.report", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("events", nargs="*",
                    help="event-log JSONL file(s) (--events / "
                         "ROC_TPU_EVENTS artifacts; repeat or glob for "
                         "a run with one file per process)")
    ap.add_argument("--metrics", action="append", default=None,
                    help="training metrics JSONL (--metrics artifact) to "
                         "fold into the span/throughput tables; "
                         "repeatable")
    ap.add_argument("--concurrency", default=None, metavar="FILE",
                    help="`python -m roc_tpu_torch.analysis --select "
                         "concurrency --json` payload: renders the "
                         "concurrency-surface table (threads / locks / "
                         "signal handlers per module) from it instead of "
                         "the event stream (works without event files)")
    ap.add_argument("--protocol", default=None, metavar="FILE",
                    help="`python -m roc_tpu_torch.analysis --select "
                         "protocol --json` payload: renders the wire-"
                         "vocabulary, model-check and transition-site "
                         "tables from it (works without event files)")
    ap.add_argument("--slo", nargs="?", const="__events__",
                    default=None, metavar="SNAPSHOT",
                    help="SLO view.  With SNAPSHOT: render a metrics-"
                         "registry snapshot JSON (MetricsRegistry.dump, "
                         "the Router's ROC_TPU_SLO_SNAPSHOT) as the live "
                         "dashboard (`watch -n1 python -m "
                         "roc_tpu_torch.report --slo snap.json`).  "
                         "Without SNAPSHOT, with event files: only the "
                         "dated SLO transitions")
    args = ap.parse_args(argv)
    if args.slo is not None:
        if args.slo != "__events__":
            try:
                with open(args.slo) as f:
                    snap = json.load(f)
            except (OSError, ValueError) as e:
                print(f"error: cannot read {args.slo}: {e}",
                      file=sys.stderr)
                return 2
            summarize_slo(snap if isinstance(snap, dict) else {})
            if not args.events:
                return 0
        elif not args.events:
            ap.error("--slo without a SNAPSHOT file needs event files to "
                     "read transitions from")
        events = _load_all(args.events)
        if events is None:
            return 2
        events.sort(key=lambda e: float(e.get("t") or 0.0))
        return summarize_slo_events(events)
    surfaces: Dict[str, Optional[Dict[str, Any]]] = {}
    for name, key, path in (
            ("concurrency", "concurrency_surface", args.concurrency),
            ("protocol", "protocol_surface", args.protocol)):
        if path:
            surfaces[name] = _load_surface(path, key)
            if surfaces[name] is None:
                return 2
    if not args.events:
        if not surfaces:
            ap.error("event files required (or --slo SNAPSHOT, "
                     "--concurrency FILE, --protocol FILE)")
        if "concurrency" in surfaces:
            summarize_concurrency(surfaces["concurrency"])
        if "protocol" in surfaces:
            summarize_protocol(surfaces["protocol"])
        return 0
    events = _load_all(args.events)
    if events is None:
        return 2
    # merged streams interleave by wall clock, so "the last manifest" and
    # the span order stay meaningful (unstamped records keep file order)
    events.sort(key=lambda e: float(e.get("t") or 0.0))
    metrics = None
    if args.metrics:
        metrics = _load_all(args.metrics)
        if metrics is None:
            return 2
    return summarize(events, metrics, **surfaces)


if __name__ == "__main__":
    sys.exit(main())
