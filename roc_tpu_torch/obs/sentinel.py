"""The performance-regression sentinel (``roc_tpu/obs/sentinel.py``): a
gate over recorded bench rounds and a live run's metrics JSONL.

Given the recorded rounds (and optionally a live run's metrics file), it
flags step-time, compile-time and overlap excursions beyond noise, and
the serve and checkpoint columns the bench headline line carries, and
exits nonzero on a regression.  Detection is robust statistics with
explicit small-sample rules:

- ``n == 0`` history: ``no_history`` (nothing to regress against);
- ``n < 3``: a median but no spread estimate, so flag only past
  ``SMALL_SAMPLE_FACTOR`` times the median;
- ``n >= 3``: median + MAD, flag past
  ``median + max(MAD_K * 1.4826 * MAD, REL_FLOOR * median)``.

Step times compare like with like: rounds whose recorded dtype differs
from the current run's are left out (a ``mixed`` round is not a
``float32`` one).

Two things differ from the JAX package's sentinel:

- the history: the port's own round files, :data:`BENCH_GLOB` in the
  repo root, which the port's bench writes in the bench headline shape
  (``metric``, ``value``, ``unit``, ``dtype``, ``stage``, ``stages``).
  The repo's ``BENCH_r0*.json`` are rounds of the JAX package on a TPU
  and never match it;
- the metrics reader also takes the port trainer's naming: its first
  eval record carries ``first_step_ms`` (the first step, timed apart,
  kernel builds and first launches included) and an ``epoch_ms`` that is
  already steady, so that record stays in the steady median and its
  ``first_step_ms`` becomes ``compile_s``.  A record carrying the JAX
  trainer's ``compile_ms`` is read as the JAX package reads it.

Like ``roc_tpu_torch/obs/timeline.py`` this is a reader, stdlib only,
importing nothing of its package: ``python roc_tpu_torch/obs/sentinel.py
...`` runs without torch; ``python -m roc_tpu_torch.sentinel`` is the
packaged entry point.  ``--json`` prints one machine-readable line.
"""

from __future__ import annotations

import argparse
import glob as _glob
import json
import os
import sys
from typing import Any, Dict, List, Optional

_REPO_ROOT = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", ".."))

# the port's rounds; the JAX package's TPU rounds are BENCH_r0*.json
BENCH_GLOB = "BENCH_torch_r*.json"

# n >= 3: flag past median + max(MAD_K * sigma, REL_FLOOR * median)
MAD_K = 4.0
REL_FLOOR = 0.25
# n in {1, 2}: no spread estimate, flag only a gross excursion
SMALL_SAMPLE_FACTOR = 1.5
# rates (shed, error, availability, ...) sit at 0.0 or 1.0 in a healthy
# history, where a purely relative bound collapses: they may drift this
# far past the median (availability: below it) before the gate bites
RATE_ABS_FLOOR = 0.05


def _median(vals: List[float]) -> float:
    vs = sorted(vals)
    n = len(vs)
    return vs[n // 2] if n % 2 else 0.5 * (vs[n // 2 - 1] + vs[n // 2])


def detect(history: List[Optional[float]], current: Optional[float],
           higher_is_better: bool = False,
           mad_k: float = MAD_K, rel_floor: float = REL_FLOOR,
           small_factor: float = SMALL_SAMPLE_FACTOR,
           allow_zero: bool = False,
           abs_floor: float = 0.0) -> Dict[str, Any]:
    """One metric's verdict: ``verdict`` in {no_data, no_history, ok,
    regression} and the numbers behind it (median, bound, n, rule).

    ``allow_zero`` admits 0.0 as history (rates); ``abs_floor`` keeps
    the bound at least that far from the median (:data:`RATE_ABS_FLOOR`).
    """
    out: Dict[str, Any] = {"current": current,
                           "higher_is_better": higher_is_better}
    if current is None:
        out.update(verdict="no_data", n=0)
        return out
    hist = [float(v) for v in history
            if isinstance(v, (int, float))
            and (v > 0 or (allow_zero and v >= 0))]
    out["n"] = len(hist)
    if not hist:
        out["verdict"] = "no_history"
        return out
    med = _median(hist)
    out["median"] = round(med, 4)
    if len(hist) < 3:
        bound = (med / small_factor - abs_floor if higher_is_better
                 else med * small_factor + abs_floor)
        out["rule"] = f"small_sample_{small_factor}x"
    else:
        sigma = 1.4826 * _median([abs(v - med) for v in hist])
        slack = max(mad_k * sigma, rel_floor * med, abs_floor)
        bound = med - slack if higher_is_better else med + slack
        out["rule"] = f"median_mad_k{mad_k:g}"
        out["sigma"] = round(sigma, 4)
    out["bound"] = round(bound, 4)
    worse = (current < bound) if higher_is_better else (current > bound)
    out["verdict"] = "regression" if worse else "ok"
    return out


# ------------------------------------------------------------ the rounds

# the headline line's serve and checkpoint columns, copied as they are
_HEADLINE_COLUMNS = ("serve_p50_ms", "serve_p99_ms", "serve_qps",
                     "serve_shed_rate", "serve_error_rate",
                     "serve_availability", "serve_slo_ok",
                     "serve_table_bytes", "serve_quant_drift",
                     "serve_shard_table_bytes", "serve_gather_p50_ms",
                     "ckpt_save_ms", "ckpt_block_ms")


def load_bench_round(path: str) -> Dict[str, Any]:
    """One recorded round's comparable numbers.  Takes a wrapped round
    (``{"parsed": {...}, ...}``) or a bare headline line; a missing
    metric is None and an unreadable file a round of Nones, never an
    error."""
    out: Dict[str, Any] = {"path": os.path.basename(path),
                           "step_ms": None, "compile_s": None,
                           "overlap_frac": None,
                           **{k: None for k in _HEADLINE_COLUMNS},
                           "mesh_epoch_ratio": None,
                           "dtype": None, "stage": None}
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return out
    if not isinstance(doc, dict):
        return out
    parsed = doc.get("parsed") if isinstance(doc.get("parsed"), dict) \
        else doc
    val = parsed.get("value")
    if isinstance(val, (int, float)) and parsed.get("unit") == "ms":
        out["step_ms"] = float(val)
    for k in _HEADLINE_COLUMNS:
        if isinstance(parsed.get(k), (int, float)):
            out[k] = float(parsed[k])
    out["dtype"] = parsed.get("dtype")
    out["stage"] = parsed.get("stage")
    stages = parsed.get("stages")
    if isinstance(stages, dict):
        for name in ("full", "small"):
            st = stages.get(name)
            if isinstance(st, dict) and \
                    isinstance(st.get("compile_s"), (int, float)):
                out["compile_s"] = float(st["compile_s"])
                break
        # the micro stage's rows: the measured overlap is the
        # stream:prefetch row's, any other row's the fallback; the 2-D
        # mesh race's ratio is the mesh:2d row's
        micro = stages.get("micro")
        impls = (micro.get("impls")
                 if isinstance(micro, dict) else None)
        if isinstance(impls, dict):
            rows = [impls.get("stream:prefetch")] + list(impls.values())
            for row in rows:
                if isinstance(row, dict) and \
                        isinstance(row.get("overlap_frac"),
                                   (int, float)):
                    out["overlap_frac"] = float(row["overlap_frac"])
                    break
            mesh = impls.get("mesh:2d")
            if isinstance(mesh, dict) and \
                    isinstance(mesh.get("mesh_epoch_ratio"),
                               (int, float)):
                out["mesh_epoch_ratio"] = float(
                    mesh["mesh_epoch_ratio"])
    return out


def bench_history(pattern: str) -> List[Dict[str, Any]]:
    """Rounds matching ``pattern``, in filename (round) order."""
    return [load_bench_round(p) for p in sorted(_glob.glob(pattern))]


# ------------------------------------------------ a live run's metrics

def _load_jsonl(path: str) -> List[Dict[str, Any]]:
    """Tolerant JSONL reader (a copy of obs/timeline.py's: this module
    imports nothing of its package)."""
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


def _num(v: Any) -> bool:
    return isinstance(v, (int, float))


def metrics_summary(records: List[Dict[str, Any]]) -> Dict[str, Any]:
    """A live run's comparable numbers from its metrics JSONL: the
    median steady ``epoch_ms``, the worst first step in seconds and the
    median ``overlap_frac`` (streamed tiers only).

    A record with the JAX trainer's ``compile_ms`` folded the first step
    into its ``epoch_ms`` and stays out of the steady median; a record
    with the port trainer's ``first_step_ms`` timed it apart and stays
    in.  Either field is the first step's time."""
    steady = [float(r["epoch_ms"]) for r in records
              if _num(r.get("epoch_ms")) and r.get("compile_ms") is None]
    compiles = [float(r["compile_ms"] if _num(r.get("compile_ms"))
                      else r["first_step_ms"]) for r in records
                if _num(r.get("compile_ms"))
                or _num(r.get("first_step_ms"))]
    overlap = [float(r["overlap_frac"]) for r in records
               if _num(r.get("overlap_frac"))]
    return {
        "step_ms": round(_median(steady), 3) if steady else None,
        "compile_s": (round(max(compiles) / 1e3, 3)
                      if compiles else None),
        "overlap_frac": (round(_median(overlap), 4)
                         if overlap else None),
        "n_records": len(records),
    }


# ------------------------------------------------------------ the gate

def _lower(rounds, current, key, **kw) -> Dict[str, Any]:
    return detect([r.get(key) for r in rounds], current.get(key), **kw)


def _rate(rounds, current, key, **kw) -> Dict[str, Any]:
    return _lower(rounds, current, key, allow_zero=True,
                  abs_floor=RATE_ABS_FLOOR, **kw)


def check_run(rounds: List[Dict[str, Any]],
              current: Dict[str, Any]) -> Dict[str, Any]:
    """Hold ``current`` (step_ms, compile_s, overlap_frac, the serve and
    checkpoint columns, and an optional dtype that filters the step-time
    history) against the recorded rounds.  Returns ``{"checks": {...},
    "regressed": [...], "ok": bool, "history_rounds": [...]}``."""
    dtype = current.get("dtype")
    step_hist = [r.get("step_ms") for r in rounds
                 if dtype is None or r.get("dtype") in (None, dtype)]
    checks = {
        "step_time_ms": detect(step_hist, current.get("step_ms")),
        "compile_time_s": detect([r.get("compile_s") for r in rounds],
                                 current.get("compile_s")),
        "overlap_frac": _lower(rounds, current, "overlap_frac",
                               higher_is_better=True),
        "serve_p50_ms": _lower(rounds, current, "serve_p50_ms"),
        "serve_p99_ms": _lower(rounds, current, "serve_p99_ms"),
        "serve_qps": _lower(rounds, current, "serve_qps",
                            higher_is_better=True),
        "serve_shed_rate": _rate(rounds, current, "serve_shed_rate"),
        "serve_error_rate": _rate(rounds, current, "serve_error_rate"),
        "serve_availability": _rate(rounds, current,
                                    "serve_availability",
                                    higher_is_better=True),
        # 1.0 = the router's health green, 0.0 = an objective in breach
        "serve_slo_ok": _rate(rounds, current, "serve_slo_ok",
                              higher_is_better=True),
        # the quantized artifact's table bytes: a regression is a lost
        # shrink
        "serve_table_bytes": _lower(rounds, current, "serve_table_bytes"),
        "serve_quant_drift": _rate(rounds, current, "serve_quant_drift"),
        # one replica's slice bytes and the cross-shard gather's p50
        "serve_shard_table_bytes": _lower(rounds, current,
                                          "serve_shard_table_bytes"),
        "serve_gather_p50_ms": _lower(rounds, current,
                                      "serve_gather_p50_ms"),
        # the async save's wall and the step path's blocked time
        "ckpt_save_ms": _lower(rounds, current, "ckpt_save_ms"),
        "ckpt_block_ms": _lower(rounds, current, "ckpt_block_ms"),
        # best 2-D over 1-D epoch, near 1.0: the absolute floor keeps
        # run-to-run noise from tripping it
        "mesh_epoch_ratio": _rate(rounds, current, "mesh_epoch_ratio"),
    }
    regressed = [name for name, v in checks.items()
                 if v["verdict"] == "regression"]
    return {"checks": checks, "regressed": regressed,
            "ok": not regressed,
            "history_rounds": [r["path"] for r in rounds]}


def bench_verdict(value_ms: Optional[float],
                  dtype: Optional[str] = None,
                  compile_s: Optional[float] = None,
                  bench_dir: Optional[str] = None,
                  stage: Optional[str] = None) -> Dict[str, Any]:
    """A compact verdict for a bench headline: the live step time
    against the rounds under ``bench_dir`` (default the repo root).
    ``stage`` filters the rounds as dtype does, so a small-stage epoch
    is never scored against full-scale history."""
    pattern = os.path.join(bench_dir or _REPO_ROOT, BENCH_GLOB)
    rounds = [r for r in bench_history(pattern)
              if stage is None or r.get("stage") in (None, stage)]
    res = check_run(rounds,
                    {"step_ms": value_ms, "compile_s": compile_s,
                     "dtype": dtype})
    step = res["checks"]["step_time_ms"]
    out = {"verdict": step["verdict"], "n_history": step.get("n", 0)}
    for k in ("median", "bound", "rule"):
        if k in step:
            out[k] = step[k]
    if res["regressed"]:
        out["regressed"] = res["regressed"]
        out["verdict"] = "regression"
    return out


# the columns a trajectory-mode current round carries
_CURRENT_COLUMNS = ("step_ms", "compile_s", "overlap_frac") + \
    _HEADLINE_COLUMNS


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="roc_tpu_torch.sentinel", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--bench-glob", default=None,
                    help="round files (default: "
                         f"{BENCH_GLOB} in the repo root)")
    ap.add_argument("--metrics", default=None,
                    help="a live run's metrics JSONL: its steady "
                         "epoch_ms, first step and overlap_frac are the "
                         "CURRENT numbers, checked against every round")
    ap.add_argument("--dtype", default=None,
                    help="dtype of the current numbers (the step-time "
                         "history is filtered to matching rounds; "
                         "default: the newest round's dtype in "
                         "trajectory mode)")
    ap.add_argument("--json", action="store_true",
                    help="one machine-readable JSON line on stdout")
    args = ap.parse_args(argv)

    pattern = args.bench_glob or os.path.join(_REPO_ROOT, BENCH_GLOB)
    rounds = bench_history(pattern)
    mode = "trajectory"
    if args.metrics:
        # the metrics file is current, every round is history
        try:
            recs = _load_jsonl(args.metrics)
        except OSError as e:
            print(f"error: cannot read {args.metrics}: {e}",
                  file=sys.stderr)
            return 2
        current = metrics_summary(recs)
        current["dtype"] = args.dtype
        history = rounds
        mode = "metrics"
    else:
        # the newest round with any data is current, the ones before it
        # history
        cur_idx = None
        for i in range(len(rounds) - 1, -1, -1):
            if any(rounds[i][k] is not None
                   for k in ("step_ms", "compile_s", "overlap_frac",
                             "serve_p50_ms", "serve_qps",
                             "serve_availability")):
                cur_idx = i
                break
        if cur_idx is None:
            payload = {"mode": mode, "ok": True,
                       "verdict": "no_data",
                       "rounds": [r["path"] for r in rounds]}
            print(json.dumps(payload) if args.json else
                  f"sentinel: no measurable rounds in {pattern} — "
                  f"nothing to gate")
            return 0
        cur = rounds[cur_idx]
        current = {k: cur[k] for k in _CURRENT_COLUMNS}
        current["dtype"] = args.dtype or cur.get("dtype")
        current["round"] = cur["path"]
        history = rounds[:cur_idx]

    res = check_run(history, current)
    payload = {"mode": mode, "current": current, **res}
    if args.json:
        print(json.dumps(payload))
    else:
        print(f"sentinel ({mode}): current="
              + " ".join(f"{k}={current.get(k)}"
                         for k in ("step_ms", "compile_s",
                                   "overlap_frac", "round")
                         if current.get(k) is not None))
        for name, v in res["checks"].items():
            extra = "".join(
                f" {k}={v[k]}" for k in ("median", "bound", "n",
                                         "rule") if k in v)
            print(f"  {name}: {v['verdict']}{extra}")
        print("sentinel: "
              + ("OK — no regression beyond noise" if res["ok"] else
                 f"REGRESSION in {', '.join(res['regressed'])}"))
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
