"""The port's metrics registry and SLO engine against the JAX package's
(``roc_tpu/obs/metrics_registry.py``, ``roc_tpu/obs/slo.py``), on the
CPU: both packages driven through one recorded series under one fake
clock (``now=``), their readings equal exactly (the same stdlib
arithmetic in the same order).

- counters' windowed sums, gauges and their EWMA, the histograms'
  quantiles and ``frac_above``, and whole snapshots;
- ``parse_slo``: round trips and refusals;
- the burn-rate engine: breach and recovery edges, warm-up, the tick's
  rate limit, with equal verdicts;
- a breach's dated ``slo`` event and its flight record.
"""

import glob

import numpy as np
import pytest

from roc_tpu.obs import metrics_registry as jreg
from roc_tpu.obs import slo as jslo
from roc_tpu_torch.obs import events
from roc_tpu_torch.obs import metrics_registry as reg_mod
from roc_tpu_torch.obs import slo as slo_mod

T0 = 1000.0


class _Clock:
    def __init__(self, t=T0):
        self.t = t

    def __call__(self):
        return self.t


def _pair(name="router", **kw):
    clk = _Clock()
    return clk, (jreg.MetricsRegistry(name, now=clk, **kw),
                 reg_mod.MetricsRegistry(name, now=clk, **kw))


def _series(seed=0, n=400):
    """A recorded serving series: (dt seconds, requests, ok, latency ms,
    gauge value) per step, heavy-tailed latencies with a burst of slow
    requests and idle gaps that outlive the ring."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        dt = float(rng.choice([0.01, 0.2, 1.0, 7.5, 200.0],
                              p=[0.5, 0.3, 0.15, 0.045, 0.005]))
        req = int(rng.randint(0, 20))
        ok = req - int(rng.binomial(req, 0.8 if 150 <= i < 180 else 0.01))
        lat = [float(v) for v in rng.lognormal(0.5, 1.5, size=req)]
        if 150 <= i < 180:
            lat = [v * 40.0 for v in lat]
        out.append((dt, req, ok, lat, float(rng.uniform(0, 100))))
    return out


def _record(clk, regs, series, every=None):
    """Feed ``series`` to both registries; call ``every(step)`` after each
    step."""
    for step, (dt, req, ok, lat, g) in enumerate(series):
        clk.t += dt
        for r in regs:
            r.counter("requests").inc(req)
            r.counter("ok").inc(ok)
            h = r.histogram("request_ms")
            for v in lat:
                h.record(v)
            r.gauge("inflight").set(g)
            r.gauge("step_ms", ewma_alpha=0.2).set(g * 0.5)
        if every is not None:
            every(step)


# ---------------------------------------------------------------- registry

def test_registry_readings_equal_jax_over_a_recorded_series():
    clk, (j, t) = _pair()
    seen = []

    def compare(step):
        if step % 3:
            return
        for w in (None, 0.5, 1.0, 10.0, 60.0, 300.0):
            assert j.counter("requests").sum_over(w) == \
                t.counter("requests").sum_over(w)
            assert j.counter("ok").sum_over(w) == t.counter("ok").sum_over(w)
            jh, th = j.histogram("request_ms"), t.histogram("request_ms")
            assert jh.count_over(w) == th.count_over(w)
            for q in (0.0, 0.5, 0.9, 0.99, 1.0):
                assert jh.quantile(q, w) == th.quantile(q, w)
            for lim in (0.5, 5.0, 50.0, 1e4):
                assert jh.frac_above(lim, w) == th.frac_above(lim, w)
        assert j.counter("ok").rate(10.0) == t.counter("ok").rate(10.0)
        for g in ("inflight", "step_ms"):
            assert (j.gauge(g).value, j.gauge(g).ewma, j.gauge(g).n) == \
                (t.gauge(g).value, t.gauge(g).ewma, t.gauge(g).n)
        seen.append(t.histogram("request_ms").quantile(0.99, 10.0))

    _record(clk, (j, t), _series(), every=compare)
    assert any(v is None for v in seen) and any(v for v in seen)
    assert j.snapshot((10.0, 60.0)) == t.snapshot((10.0, 60.0))
    assert j.names() == t.names()
    assert j.counter("requests").total == t.counter("requests").total > 0


def test_registry_get_or_create_and_type_clash():
    _, (j, t) = _pair()
    for r in (j, t):
        c = r.counter("x")
        c.inc(3)
        assert r.counter("x") is c and r.get("x") is c
    with pytest.raises(TypeError, match="already registered"):
        t.histogram("x")
    assert t.get("nope") is None


def test_registry_dump_is_atomic_json(tmp_path):
    import json
    clk, (j, t) = _pair()
    _record(clk, (j, t), _series(seed=2, n=40))
    p = str(tmp_path / "sub" / "snap.json")
    t.dump(p, windows=(10.0,), extra={"component": "router"})
    doc = json.load(open(p))
    assert doc["component"] == "router" and "t" in doc
    doc.pop("t")
    doc.pop("component")
    assert doc == j.snapshot((10.0,))
    (tmp_path / "blocker").write_text("")
    t.dump(str(tmp_path / "blocker" / "x.json"))     # never raises


def test_histogram_buckets_equal_jax():
    clk = _Clock()
    for kw in ({}, {"lo": 0.1, "hi": 1e3, "per_decade": 8}):
        jh = jreg.Histogram("h", now=clk, **kw)
        th = reg_mod.Histogram("h", now=clk, **kw)
        assert jh.n_buckets == th.n_buckets
        for v in (0.0, 1e-9, 1e-3, 0.5, 1.0, 3.3, 1e5, 1e9):
            assert jh._bucket(v) == th._bucket(v)
        for b in range(th.n_buckets):
            assert jh.bucket_value(b) == th.bucket_value(b)
            assert jh.bucket_lo(b) == th.bucket_lo(b)


# --------------------------------------------------------------- grammar

@pytest.mark.parametrize("spec", [
    "availability(ok/requests) >= 0.999 over 60s",
    "lat99: p99(request_ms) <= 50ms over 30s",
    "p95(wire_ms) <= 12.5ms over 10s",
    "avail.2: availability(good/all) >= 0.9 over 120s"])
def test_parse_slo_equal_jax_and_round_trips(spec):
    a, b = jslo.parse_slo(spec), slo_mod.parse_slo(spec)
    fields = ("name", "kind", "window_s", "target", "ok", "total", "hist",
              "q", "limit_ms", "budget")
    assert [getattr(a, f) for f in fields] == [getattr(b, f) for f in fields]
    assert b.spec() == a.spec()
    assert slo_mod.parse_slo(b.spec()).spec() == b.spec()


@pytest.mark.parametrize("spec", [
    "p99 of latency under 50",
    "availability(ok/requests) >= 1.0 over 60s",
    "p99(request_ms) <= 50 over 60s",
    "availability(ok/requests) >= 0.9 over 60"])
def test_parse_slo_refusals_equal_jax(spec):
    with pytest.raises(ValueError):
        jslo.parse_slo(spec)
    with pytest.raises(ValueError):
        slo_mod.parse_slo(spec)


def test_slo_kind_refused():
    with pytest.raises(ValueError, match="unknown SLO kind"):
        slo_mod.Slo("x", "throughput", 60.0, 0.9)


# ------------------------------------------------------------ the engine

def _engines(clk, regs, specs, **kw):
    kw.setdefault("flight_record", False)
    kw.setdefault("warmup_s", 0.0)
    return (jslo.SloEngine(regs[0], specs, component="test", now=clk, **kw),
            slo_mod.SloEngine(regs[1], specs, component="test", now=clk,
                              **kw))


SPECS = ["availability(ok/requests) >= 0.99 over 60s",
         "lat95: p95(request_ms) <= 40ms over 30s"]


def test_burn_rate_verdicts_equal_jax_over_a_recorded_series():
    """Both engines, evaluated after every step of the series (a burst of
    failing, slow traffic in the middle), give equal verdicts: the same
    breach and recovery edges at the same steps."""
    clk, regs = _pair()
    je, te = _engines(clk, regs, SPECS, warmup_s=2.0)
    states = []

    def compare(step):
        a, b = je.evaluate(), te.evaluate()
        assert a == b, step
        states.append(tuple(sorted(b["states"].items())))

    _record(clk, regs, _series(seed=1), every=compare)
    seen = {s for st in states for s in st}
    assert ("availability_60s", "breach") in seen
    assert ("lat95", "breach") in seen
    assert states[-1] == (("availability_60s", "ok"), ("lat95", "ok"))


def test_warmup_suppresses_the_startup_edge():
    clk, regs = _pair()
    je, te = _engines(clk, regs, SPECS[:1], warmup_s=2.0)
    for r in regs:
        r.counter("requests").inc(20)
    a, b = je.evaluate(), te.evaluate()
    assert a == b and b["states"]["availability_60s"] == "ok"
    assert b["objectives"][0]["warmup"] is True
    clk.t += 3.0
    for r in regs:
        r.counter("ok").inc(20)
        r.counter("requests").inc(1000)
        r.counter("ok").inc(100)
    a, b = je.evaluate(), te.evaluate()
    assert a == b and b["states"]["availability_60s"] == "breach"


def test_tick_rate_limit_equal_jax():
    clk, regs = _pair()
    je, te = _engines(clk, regs, SPECS[:1], eval_interval_s=0.25)
    for r in regs:
        r.counter("requests").inc(10)
        r.counter("ok").inc(10)
    ja, ta = je.tick(), te.tick()
    assert ja == ta and ta["ok"] is True
    assert te.tick() is ta and je.tick() is ja      # cached
    clk.t += 0.3
    assert te.tick() is not ta


def test_breach_emits_a_dated_event_and_a_flight_record(tmp_path,
                                                       monkeypatch):
    monkeypatch.setenv("ROC_TPU_FLIGHT_DIR", str(tmp_path))
    got = []

    class _Sink:
        def write(self, rec):
            got.append(rec)

        def close(self):
            pass

    sink = _Sink()
    events.get_bus().add_sink(sink)
    breaches = []
    try:
        clk, (_, reg) = _pair()
        eng = slo_mod.SloEngine(reg, SPECS[:1], component="test", now=clk,
                                warmup_s=0.0, on_breach=breaches.append)
        reg.counter("requests").inc(1000)
        reg.counter("ok").inc(50)
        eng.evaluate()
        eng.evaluate()                      # still firing: no new edge
        clk.t += 130.0
        reg.counter("requests").inc(50)
        reg.counter("ok").inc(50)
        eng.evaluate()
    finally:
        events.get_bus().sinks.remove(sink)
    slo = [r for r in got if r.get("cat") == "slo"]
    assert [r["kind"] for r in slo] == ["breach", "recovered"]
    assert slo[0]["slo"] == "availability_60s"
    assert slo[0]["component"] == "test" and slo[0]["burn"] >= 6.0
    assert isinstance(slo[0]["t"], float)
    assert len(breaches) == 1 and breaches[0]["firing"]
    assert len(glob.glob(str(tmp_path / "flightrecord_*slo-breach*"))) == 1
