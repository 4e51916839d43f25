"""SLO engine (``roc_tpu/obs/slo.py``): declarative objectives and
multi-window burn-rate alerting over the metrics registry.

An objective is a target on a bad-event fraction over a compliance
window W, declared in code or in the one-line grammar:

    availability(ok/requests) >= 0.999 over 60s
    p99(request_ms) <= 50ms over 60s

- availability: bad events are the requests that did not complete ok
  (``sum(total) - sum(ok)`` over the window, from two registry
  counters); the error budget is ``1 - target``;
- a latency quantile ``pQQ(hist) <= LIMITms``: bad events are the
  histogram's samples above LIMIT, the budget ``1 - QQ``.

Burn rate = (bad fraction over an alert window) / budget.  Each
objective evaluates a fast rule (burn >= 14.4 over both W/6 and W/60)
and a slow rule (burn >= 6 over both W/2 and W/12); windows floor at one
registry slice.  Breaches are edge-triggered: entering one emits a dated
``slo`` event and dumps the flight record (obs/events.py), and recovery
emits ``recovered``.  :meth:`SloEngine.verdict` is the machine-readable
health ``Router.health()`` returns; :meth:`SloEngine.tick` limits itself
to one evaluation per ``eval_interval_s``.  Stdlib only.
"""

from __future__ import annotations

import re
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

from .events import dump_flight_record, emit
from .metrics_registry import MetricsRegistry

# the SRE-workbook multi-window burn-rate pairs, scaled to the
# objective's compliance window W: (long frac of W, short frac of W,
# burn threshold)
BURN_RULES = ((1.0 / 6.0, 1.0 / 60.0, 14.4),   # fast burn
              (1.0 / 2.0, 1.0 / 12.0, 6.0))    # slow burn

_SPEC_RE = re.compile(
    r"^\s*(?:(?P<name>[\w.-]+)\s*:)?\s*"
    r"(?:availability\s*\(\s*(?P<ok>[\w.]+)\s*/\s*(?P<total>[\w.]+)"
    r"\s*\)\s*>=\s*(?P<target>[0-9.]+)"
    r"|p(?P<q>\d{2})\s*\(\s*(?P<hist>[\w.]+)\s*\)\s*<=\s*"
    r"(?P<limit>[0-9.]+)\s*ms)"
    r"\s+over\s+(?P<window>[0-9.]+)\s*s\s*$")


class Slo:
    """One declarative objective.  ``kind`` is ``availability`` or
    ``latency``; see :func:`parse_slo` for the string form."""

    def __init__(self, name: str, kind: str, window_s: float,
                 target: float,
                 ok: Optional[str] = None,
                 total: Optional[str] = None,
                 hist: Optional[str] = None,
                 q: Optional[float] = None,
                 limit_ms: Optional[float] = None):
        if kind not in ("availability", "latency"):
            raise ValueError(f"unknown SLO kind {kind!r}")
        self.name = name
        self.kind = kind
        self.window_s = float(window_s)
        self.target = float(target)
        self.ok = ok
        self.total = total
        self.hist = hist
        self.q = q
        self.limit_ms = limit_ms
        # error budget: tolerable bad-event fraction
        self.budget = (1.0 - self.target if kind == "availability"
                       else 1.0 - float(q or 0.0))
        if self.budget <= 0.0:
            raise ValueError(
                f"SLO {name!r} has zero error budget "
                f"(target {self.target}) — burn rate is undefined")

    def spec(self) -> str:
        if self.kind == "availability":
            return (f"availability({self.ok}/{self.total}) >= "
                    f"{self.target:g} over {self.window_s:g}s")
        return (f"p{int((self.q or 0) * 100)}({self.hist}) <= "
                f"{self.limit_ms:g}ms over {self.window_s:g}s")

    # ---------------------------------------------------- evaluation

    def _bad_frac(self, reg: MetricsRegistry,
                  window_s: float) -> float:
        if self.kind == "availability":
            total = reg.counter(self.total).sum_over(window_s)
            if total <= 0:
                return 0.0      # no traffic = no bad events
            ok = reg.counter(self.ok).sum_over(window_s)
            return max(0, total - ok) / total
        h = reg.histogram(self.hist)
        return h.frac_above(float(self.limit_ms), window_s)

    def _value(self, reg: MetricsRegistry) -> Optional[float]:
        """The objective's headline number over its own window —
        availability in [0, 1], or the latency quantile in ms."""
        if self.kind == "availability":
            return round(1.0 - self._bad_frac(reg, self.window_s), 6)
        v = reg.histogram(self.hist).quantile(
            float(self.q or 0.99), self.window_s)
        return round(v, 4) if v is not None else None

    def _has_traffic(self, reg: MetricsRegistry) -> bool:
        """Any lifetime events under the objective's denominator."""
        if self.kind == "availability":
            return reg.counter(self.total).sum_over(None) > 0
        return reg.histogram(self.hist).count_over(None) > 0


def parse_slo(spec: str) -> Slo:
    """Parse the one-line grammar (module docstring).  An optional
    leading ``name:`` labels the objective; otherwise the spec is its
    own name."""
    m = _SPEC_RE.match(spec)
    if not m:
        raise ValueError(
            f"cannot parse SLO spec {spec!r}; expected "
            f"'availability(ok/total) >= 0.999 over 60s' or "
            f"'p99(hist) <= 50ms over 60s'")
    g = m.groupdict()
    window_s = float(g["window"])
    if g["ok"]:
        return Slo(g["name"] or f"availability_{int(window_s)}s",
                   "availability", window_s, float(g["target"]),
                   ok=g["ok"], total=g["total"])
    q = int(g["q"]) / 100.0
    return Slo(g["name"] or f"p{g['q']}_{g['hist']}",
               "latency", window_s, q, hist=g["hist"], q=q,
               limit_ms=float(g["limit"]))


class SloEngine:
    """Continuous evaluation of objectives against a registry."""

    def __init__(self, registry: MetricsRegistry,
                 slos: Sequence[Any],
                 component: str = "serve",
                 eval_interval_s: float = 0.25,
                 flight_record: bool = True,
                 on_breach: Optional[Callable[[Dict[str, Any]], None]]
                 = None,
                 warmup_s: float = 2.0,
                 now: Callable[[], float] = time.monotonic):
        self.reg = registry
        self.slos: List[Slo] = [s if isinstance(s, Slo)
                                else parse_slo(s) for s in slos]
        self.component = component
        self.eval_interval_s = float(eval_interval_s)
        self.flight_record = flight_record
        self.on_breach = on_breach
        # availability counts a request at submit but its ok only at
        # completion, so the very first evaluations after traffic
        # starts see bad_frac ~ 1 over a tiny sample — rules may not
        # fire until traffic has flowed for warmup_s
        self.warmup_s = float(warmup_s)
        self._t_traffic: Optional[float] = None
        self._now = now
        self._lock = threading.Lock()
        self._last_eval = 0.0
        self._state: Dict[str, str] = {s.name: "ok"
                                       for s in self.slos}
        self._last_verdict: Optional[Dict[str, Any]] = None

    # ----------------------------------------------------- evaluation

    def _eval_one(self, slo: Slo) -> Dict[str, Any]:
        slice_s = self.reg.slice_s
        burns = []
        firing = False
        for long_f, short_f, thr in BURN_RULES:
            w_long = max(slice_s, slo.window_s * long_f)
            w_short = max(slice_s, slo.window_s * short_f)
            b_long = slo._bad_frac(self.reg, w_long) / slo.budget
            b_short = slo._bad_frac(self.reg, w_short) / slo.budget
            rule_fires = b_long >= thr and b_short >= thr
            firing = firing or rule_fires
            burns.append({"window_s": round(w_long, 2),
                          "short_s": round(w_short, 2),
                          "burn": round(b_long, 2),
                          "burn_short": round(b_short, 2),
                          "threshold": thr, "firing": rule_fires})
        bad_w = slo._bad_frac(self.reg, slo.window_s)
        compliant = bad_w <= slo.budget
        return {"name": slo.name, "kind": slo.kind,
                "spec": slo.spec(),
                "window_s": slo.window_s,
                "value": slo._value(self.reg),
                "target": (slo.target if slo.kind == "availability"
                           else slo.limit_ms),
                "bad_frac": round(bad_w, 6),
                "budget": round(slo.budget, 6),
                "burn": max(b["burn"] for b in burns) if burns else 0,
                "burn_rules": burns,
                "firing": firing,
                "compliant": compliant}

    def evaluate(self) -> Dict[str, Any]:
        """Evaluate every objective NOW (no rate limit): emit breach/
        recovery transitions, return the verdict."""
        objectives = [self._eval_one(s) for s in self.slos]
        now = self._now()
        with self._lock:
            if self._t_traffic is None and any(
                    s._has_traffic(self.reg) for s in self.slos):
                self._t_traffic = now
            warmed = (self._t_traffic is not None
                      and now - self._t_traffic >= self.warmup_s)
        if not warmed:
            for ob in objectives:
                if ob["firing"]:
                    ob["firing"] = False
                    ob["warmup"] = True
        transitions = []
        with self._lock:
            for ob in objectives:
                prev = self._state.get(ob["name"], "ok")
                if prev == "ok" and ob["firing"]:
                    self._state[ob["name"]] = "breach"
                    transitions.append(("breach", ob))
                elif prev == "breach" and not ob["firing"] \
                        and ob["compliant"]:
                    self._state[ob["name"]] = "ok"
                    transitions.append(("recovered", ob))
            states = dict(self._state)
        for what, ob in transitions:
            worst = max(ob["burn_rules"],
                        key=lambda b: b["burn"])
            emit("slo",
                 f"SLO {what}: {ob['spec']} — burn "
                 f"{worst['burn']:.1f}x budget over "
                 f"{worst['window_s']:.0f}s "
                 f"(value {ob['value']}, target {ob['target']})",
                 kind=what, slo=ob["name"], component=self.component,
                 spec=ob["spec"], burn=worst["burn"],
                 burn_window_s=worst["window_s"],
                 value=ob["value"], target=ob["target"],
                 bad_frac=ob["bad_frac"], budget=ob["budget"])
            if what == "breach":
                if self.flight_record:
                    dump_flight_record(
                        f"slo breach {ob['name']}")
                if self.on_breach is not None:
                    try:
                        self.on_breach(ob)
                    except Exception:  # noqa: BLE001 - alerting must
                        pass           # never take down serving
        verdict = {"ok": all(st == "ok" for st in states.values())
                   and all(ob["compliant"] for ob in objectives),
                   "states": states,
                   "objectives": objectives}
        with self._lock:
            self._last_verdict = verdict
        return verdict

    def tick(self) -> Optional[Dict[str, Any]]:
        """Rate-limited evaluate() for monitor loops: no-op (returns
        the cached verdict) within ``eval_interval_s`` of the last
        evaluation."""
        now = self._now()
        with self._lock:
            if now - self._last_eval < self.eval_interval_s:
                return self._last_verdict
            self._last_eval = now
        return self.evaluate()

    def verdict(self) -> Dict[str, Any]:
        """The machine-readable health verdict (evaluates fresh)."""
        return self.evaluate()
