"""Streaming metrics registry (``roc_tpu/obs/metrics_registry.py``): the
serving fleet's live telemetry.

The event bus (obs/events.py) is a narrative stream of dated records; a
control loop (the SLO engine, ``Router.health()``, a dashboard) needs
current windowed rates, cheap enough to record on the request path:

- :class:`Counter` — a monotone count: ``inc()`` is O(1); reads give the
  lifetime ``total`` and ``sum_over(window_s)`` / ``rate(window_s)``;
- :class:`Gauge` — a last-write-wins scalar with an optional EWMA;
- :class:`Histogram` — sliding-window quantiles over fixed log-spaced
  buckets: ``record()`` is O(1), ``quantile(q, window_s)`` merges the
  slices covering the window; a quantile is within one bucket (a factor
  of ``10**(1/16)`` by default) of the exact value.

Windowing is a time-sliced ring: each metric keeps ``n_slices`` slices of
``slice_s`` seconds and zeroes them lazily as the clock passes them (no
thread, no timer).  A window covers between ``window_s`` and ``window_s +
slice_s``.  Every metric takes an injectable clock (``now=``), so a test
can drive it through a recorded series.  Stdlib only; thread-safe per
metric.
"""

from __future__ import annotations

import json
import math
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

# default ring geometry: 1-second slices, 128 of them — window
# queries up to ~2 minutes, which covers every SLO window the serving
# loop evaluates (scale n_slices up for longer windows)
DEFAULT_SLICE_S = 1.0
DEFAULT_N_SLICES = 128

# default histogram bucket space: log-spaced from 1 µs to 10 min
# (in ms), 16 buckets per decade — latency-shaped, but any positive
# series fits (values clamp to the edge buckets)
DEFAULT_HIST_LO = 1e-3
DEFAULT_HIST_HI = 6e5
DEFAULT_PER_DECADE = 16


class _Sliced:
    """Shared time-sliced ring: lazy rotation, no threads."""

    def __init__(self, slice_s: float, n_slices: int,
                 now: Callable[[], float]):
        self.slice_s = float(slice_s)
        self.n_slices = int(n_slices)
        self._now = now
        self._cur = int(now() // self.slice_s)
        self._lock = threading.Lock()

    def _zero_slice(self, i: int) -> None:
        raise NotImplementedError

    def _advance_locked(self) -> int:
        """Rotate the ring up to the current slice; returns it."""
        s = int(self._now() // self.slice_s)
        d = s - self._cur
        if d > 0:
            for k in range(1, min(d, self.n_slices) + 1):
                self._zero_slice((self._cur + k) % self.n_slices)
            self._cur = s
        return self._cur

    def _window_slices(self, window_s: Optional[float]) -> int:
        if window_s is None:
            return self.n_slices
        return max(1, min(self.n_slices,
                          int(math.ceil(window_s / self.slice_s))))


class Counter(_Sliced):
    """Monotone event counter with windowed reads."""

    def __init__(self, name: str, slice_s: float = DEFAULT_SLICE_S,
                 n_slices: int = DEFAULT_N_SLICES,
                 now: Callable[[], float] = time.monotonic):
        super().__init__(slice_s, n_slices, now)
        self.name = name
        self.total = 0
        self._slices = [0] * self.n_slices

    def _zero_slice(self, i: int) -> None:
        self._slices[i] = 0

    def inc(self, n: int = 1) -> None:
        with self._lock:
            cur = self._advance_locked()
            self._slices[cur % self.n_slices] += n
            self.total += n

    def sum_over(self, window_s: Optional[float] = None) -> int:
        """Events recorded in the trailing window (None = whole
        ring)."""
        k = self._window_slices(window_s)
        with self._lock:
            cur = self._advance_locked()
            return sum(self._slices[(cur - i) % self.n_slices]
                       for i in range(k))

    def rate(self, window_s: float) -> float:
        """Events/second over the trailing window."""
        return self.sum_over(window_s) / max(window_s, 1e-9)

    def snapshot(self, windows: Sequence[float]) -> Dict[str, Any]:
        return {"kind": "counter", "total": self.total,
                **{f"sum_{int(w)}s": self.sum_over(w)
                   for w in windows}}


class Gauge:
    """Last-write-wins scalar; optional EWMA smoothing."""

    def __init__(self, name: str, ewma_alpha: Optional[float] = None):
        self.name = name
        self._lock = threading.Lock()
        self._value: Optional[float] = None
        self._ewma: Optional[float] = None
        self._alpha = ewma_alpha
        self.n = 0

    def set(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self._value = v
            self.n += 1
            if self._alpha is not None:
                self._ewma = (v if self._ewma is None else
                              self._alpha * v
                              + (1.0 - self._alpha) * self._ewma)

    @property
    def value(self) -> Optional[float]:
        return self._value

    @property
    def ewma(self) -> Optional[float]:
        return self._ewma if self._alpha is not None else self._value

    def snapshot(self, windows: Sequence[float]) -> Dict[str, Any]:
        out: Dict[str, Any] = {"kind": "gauge", "value": self._value,
                               "n": self.n}
        if self._alpha is not None and self._ewma is not None:
            out["ewma"] = round(self._ewma, 6)
        return out


class Histogram(_Sliced):
    """Sliding-window quantiles over fixed log-spaced buckets."""

    def __init__(self, name: str, lo: float = DEFAULT_HIST_LO,
                 hi: float = DEFAULT_HIST_HI,
                 per_decade: int = DEFAULT_PER_DECADE,
                 slice_s: float = DEFAULT_SLICE_S,
                 n_slices: int = DEFAULT_N_SLICES,
                 now: Callable[[], float] = time.monotonic):
        super().__init__(slice_s, n_slices, now)
        self.name = name
        self.lo = float(lo)
        self.hi = float(hi)
        self.per_decade = int(per_decade)
        self._log_lo = math.log10(self.lo)
        self.n_buckets = int(math.ceil(
            (math.log10(self.hi) - self._log_lo)
            * self.per_decade)) + 1
        self._slices = [[0] * self.n_buckets
                        for _ in range(self.n_slices)]
        self._life = [0] * self.n_buckets
        self.total = 0
        self.sum = 0.0

    def _zero_slice(self, i: int) -> None:
        self._slices[i] = [0] * self.n_buckets

    def _bucket(self, v: float) -> int:
        if v <= self.lo:
            return 0
        b = int((math.log10(v) - self._log_lo) * self.per_decade)
        return min(b, self.n_buckets - 1)

    def bucket_value(self, b: int) -> float:
        """The geometric midpoint a bucket reports as its value."""
        return 10.0 ** (self._log_lo
                        + (b + 0.5) / self.per_decade)

    def bucket_lo(self, b: int) -> float:
        return 10.0 ** (self._log_lo + b / self.per_decade)

    def record(self, v: float) -> None:
        b = self._bucket(float(v))
        with self._lock:
            cur = self._advance_locked()
            self._slices[cur % self.n_slices][b] += 1
            self._life[b] += 1
            self.total += 1
            self.sum += float(v)

    def _merged(self, window_s: Optional[float]) -> List[int]:
        if window_s is None:
            with self._lock:
                return list(self._life)
        k = self._window_slices(window_s)
        with self._lock:
            cur = self._advance_locked()
            merged = [0] * self.n_buckets
            for i in range(k):
                sl = self._slices[(cur - i) % self.n_slices]
                for b, c in enumerate(sl):
                    if c:
                        merged[b] += c
            return merged

    def count_over(self, window_s: Optional[float] = None) -> int:
        return sum(self._merged(window_s))

    def quantile(self, q: float,
                 window_s: Optional[float] = None
                 ) -> Optional[float]:
        """Approximate q-quantile (geometric bucket midpoint) over
        the window; None when the window holds no samples."""
        merged = self._merged(window_s)
        n = sum(merged)
        if n == 0:
            return None
        target = q * n
        acc = 0
        for b, c in enumerate(merged):
            acc += c
            if acc >= target and c:
                return self.bucket_value(b)
        return self.bucket_value(self.n_buckets - 1)

    def frac_above(self, limit: float,
                   window_s: Optional[float] = None) -> float:
        """Fraction of windowed samples above ``limit`` — the SLO
        engine's bad-event fraction for latency objectives.  Bucket-
        resolution: a sample counts as above when its whole bucket
        sits at or above the bucket containing ``limit``'s midpoint."""
        merged = self._merged(window_s)
        n = sum(merged)
        if n == 0:
            return 0.0
        b_lim = self._bucket(float(limit))
        above = sum(c for b, c in enumerate(merged) if b > b_lim)
        return above / n

    def snapshot(self, windows: Sequence[float]) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "kind": "histogram", "total": self.total,
            "mean": (round(self.sum / self.total, 4)
                     if self.total else None)}
        for w in windows:
            n = self.count_over(w)
            out[f"n_{int(w)}s"] = n
            for q, label in ((0.50, "p50"), (0.95, "p95"),
                             (0.99, "p99")):
                v = self.quantile(q, w)
                out[f"{label}_{int(w)}s"] = (round(v, 4)
                                             if v is not None else None)
        return out


class MetricsRegistry:
    """Named factory + snapshot for a component's metrics.  Metric
    getters are get-or-create (idempotent by name), so call sites can
    resolve by name on the hot path without holding references."""

    def __init__(self, name: str = "",
                 slice_s: float = DEFAULT_SLICE_S,
                 n_slices: int = DEFAULT_N_SLICES,
                 now: Callable[[], float] = time.monotonic):
        self.name = name
        self.slice_s = float(slice_s)
        self.n_slices = int(n_slices)
        self._now = now
        self._lock = threading.Lock()
        self._metrics: Dict[str, Any] = {}

    def _get(self, name: str, factory: Callable[[], Any],
             klass: type) -> Any:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = factory()
                self._metrics[name] = m
            elif not isinstance(m, klass):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}, not {klass.__name__}")
            return m

    def counter(self, name: str) -> Counter:
        return self._get(name, lambda: Counter(
            name, self.slice_s, self.n_slices, self._now), Counter)

    def gauge(self, name: str,
              ewma_alpha: Optional[float] = None) -> Gauge:
        return self._get(name, lambda: Gauge(name, ewma_alpha), Gauge)

    def histogram(self, name: str, lo: float = DEFAULT_HIST_LO,
                  hi: float = DEFAULT_HIST_HI,
                  per_decade: int = DEFAULT_PER_DECADE) -> Histogram:
        return self._get(name, lambda: Histogram(
            name, lo, hi, per_decade, self.slice_s, self.n_slices,
            self._now), Histogram)

    def get(self, name: str) -> Optional[Any]:
        with self._lock:
            return self._metrics.get(name)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._metrics)

    def snapshot(self, windows: Sequence[float] = (10.0, 60.0)
                 ) -> Dict[str, Any]:
        """JSON-able view of every metric: lifetime totals plus the
        windowed sums/quantiles the SLO engine and dashboard read."""
        with self._lock:
            items = list(self._metrics.items())
        return {"registry": self.name,
                "windows_s": [float(w) for w in windows],
                "metrics": {n: m.snapshot(windows)
                            for n, m in items}}

    def dump(self, path: str,
             windows: Sequence[float] = (10.0, 60.0),
             extra: Optional[Dict[str, Any]] = None) -> None:
        """Atomically write the snapshot (tmp + rename) — the
        dashboard feed.
        Never raises: a telemetry write must not take down serving."""
        doc = self.snapshot(windows)
        doc["t"] = round(time.time(), 3)
        if extra:
            doc.update(extra)
        tmp = f"{path}.tmp{os.getpid()}"
        try:
            d = os.path.dirname(os.path.abspath(path))
            os.makedirs(d, exist_ok=True)
            with open(tmp, "w") as f:
                json.dump(doc, f)
            os.replace(tmp, path)
        except OSError:
            try:
                os.unlink(tmp)
            except OSError:
                pass
