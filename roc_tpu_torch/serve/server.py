"""Microbatch request queue (``roc_tpu/serve/server.py``): many
concurrent queries, one device dispatch, with deadlines, backpressure and
a clean shutdown.

``Server.submit(node_ids, deadline_ms=...) -> Future``: a dispatcher
thread takes whatever requests are queued, packs them into ONE padded,
bucketed dispatch (``Predictor.query``) and completes each caller's
future with its slice of the result.  On the full backend coalescing is
bit-exact: every row of the full-graph forward is computed the same way
whichever rows a dispatch asks for, and the kernels use no atomics, so a
row's logits are identical alone or inside a 512-row microbatch.  On the
precomputed backend's 'akx' flavor the head's matmul runs on the
bucket's rows, and a GEMM may pick another algorithm for another row
count, so a row is bit-exact within a bucket size.

An accepted request completes with its answer or fails with a typed
error of serve/errors.py:

- ``deadline_ms`` expires queued requests with ``ServeTimeout`` at
  microbatch boundaries;
- the admission queue is bounded (``max_queue``); past it ``submit``
  sheds at once with ``ServeOverload``;
- each microbatch captures ONE ``Predictor.published()`` table version;
- ``close()`` rejects late submits with ``ServeClosed``; ``drain()``
  stops admitting, finishes what was accepted, then closes (the SIGTERM
  path of a replica, serve/replica.py).

Every count goes through a metrics registry (obs/metrics_registry.py),
so :meth:`Server.stats` gives lifetime totals beside rates over the
trailing ``stats_window_s``.  The server emits a ``clock_sync`` timeline
event at start, and a ``serve_batch`` span per microbatch (its index,
rows, table version and the router-minted request ids ``rids``), flushed
as ``timeline`` events every 64 microbatches and at close.
``instrument=False`` stops the registry and the stamps.  The serve fault
sites (``resilience/inject.py serve_batch_hooks``) run between a
microbatch's version capture and its dispatch.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..obs.events import emit
from ..obs.metrics_registry import MetricsRegistry
from ..resilience import inject
from .errors import ServeClosed, ServeError, ServeOverload, ServeTimeout

# spans flush as one timeline event per this many microbatches (and at
# close): an emit per batch would put JSONL I/O on the request path
_SPAN_FLUSH_EVERY = 64

# admission-queue bound (requests, not rows)
DEFAULT_MAX_QUEUE = 1024


class ServeResult(np.ndarray):
    """The fp32 ``[n, C]`` logits plus the table ``version`` the
    request's microbatch was served under, ``queue_ms`` (admission to
    dispatch start), ``device_ms`` (the microbatch's dispatch wall),
    ``qmode``, the captured version's quantization mode (during a quant
    swap, the encoding that answered), and on a sharded predictor
    ``shard``, its owned ``(lo, hi)``, and ``gather_ms``, the
    microbatch's cross-shard gather wall (None when every id was
    owned)."""
    version: int = 0
    queue_ms: Optional[float] = None
    device_ms: Optional[float] = None
    qmode: str = "off"
    shard: Optional[Tuple[int, int]] = None
    gather_ms: Optional[float] = None


def _result(rows: np.ndarray, version: int,
            queue_ms: Optional[float] = None,
            device_ms: Optional[float] = None, qmode: str = "off",
            shard: Optional[Tuple[int, int]] = None,
            gather_ms: Optional[float] = None) -> ServeResult:
    out = rows.view(ServeResult)
    out.version = int(version)
    out.queue_ms = queue_ms
    out.device_ms = device_ms
    out.qmode = qmode
    out.shard = shard
    out.gather_ms = gather_ms
    return out


class _Req:
    """One queued request: ids, the caller's future, the absolute
    monotonic deadline (None: none), the admission stamp and the
    router-minted request id."""
    __slots__ = ("ids", "fut", "deadline_t", "t_admit", "rid")

    def __init__(self, ids: np.ndarray, fut: Future,
                 deadline_t: Optional[float], t_admit: float,
                 rid: Optional[str] = None):
        self.ids = ids
        self.fut = fut
        self.deadline_t = deadline_t
        self.t_admit = t_admit
        self.rid = rid


class Server:
    """Coalescing dispatcher over a Predictor.

    ``max_wait_ms`` bounds how long the dispatcher lingers after the
    first queued request to let concurrent submitters join the batch;
    ``max_queue`` bounds the admission queue; ``default_deadline_ms``
    applies to submits that pass none; ``registry`` takes the counts
    (a registry of the server's own when None)."""

    def __init__(self, predictor, max_wait_ms: float = 0.2,
                 name: str = "serve", max_queue: int = DEFAULT_MAX_QUEUE,
                 default_deadline_ms: Optional[float] = None,
                 registry: Optional[MetricsRegistry] = None,
                 instrument: bool = True, stats_window_s: float = 60.0):
        self.pred = predictor
        self.max_wait_s = max(0.0, float(max_wait_ms)) / 1e3
        self.name = name
        self.max_queue = int(max_queue)
        self.default_deadline_ms = default_deadline_ms
        self.stats_window_s = float(stats_window_s)
        self._lock = threading.Condition()
        self._queue: List[_Req] = []
        self._closed = False
        self._draining = False
        self._dispatching = False
        self._spans: List[Tuple[str, float, float, Dict[str, Any]]] = []
        self._obs = bool(instrument)
        self.reg = (registry if registry is not None
                    else MetricsRegistry(f"server:{name}"))
        self._c_accepted = self.reg.counter("accepted")
        self._c_shed = self.reg.counter("shed")
        self._c_timeout = self.reg.counter("timeout")
        self._c_rejected = self.reg.counter("rejected_closed")
        self._c_errors = self.reg.counter("errors")
        self._c_ok = self.reg.counter("ok")
        self._c_batches = self.reg.counter("batches")
        self._c_rows = self.reg.counter("rows")
        self._h_batch = self.reg.histogram("batch_ms")
        self._h_queue = self.reg.histogram("queue_ms")
        self._h_gather = self.reg.histogram("gather_ms")
        self._batch_seq = 0
        self._versions = set()       # table versions served
        # the timeline's lane handshake: the bus stamps wall and mono
        emit("timeline", f"clock_sync: serve server '{name}' up "
             f"(backend={predictor.backend})", console=False,
             kind="clock_sync", server=name)
        self._thread = threading.Thread(target=self._loop,
                                        name=f"serve:{name}", daemon=True)
        self._thread.start()

    # ---------------------------------------------------------- public

    def submit(self, node_ids, deadline_ms: Optional[float] = None,
               rid: Optional[str] = None) -> Future:
        """Queue a query; the future resolves to the fp32 logits (a
        :class:`ServeResult`) or to a typed serve/errors.py failure.
        ``rid``, the router-minted request id, is stamped into the span
        of the microbatch that serves it."""
        ids = np.asarray(node_ids, dtype=np.int64).ravel()
        fut: Future = Future()
        if ids.size and (ids.min() < 0 or ids.max() >= self.pred.num_nodes):
            fut.set_exception(ValueError(
                f"node ids out of range [0, {self.pred.num_nodes})"))
            return fut
        if deadline_ms is None:
            deadline_ms = self.default_deadline_ms
        now = time.monotonic()
        deadline_t = (None if deadline_ms is None
                      else now + max(0.0, deadline_ms) / 1e3)
        with self._lock:
            if self._closed or self._draining:
                if self._obs:
                    self._c_rejected.inc()
                fut.set_exception(ServeClosed(
                    f"server '{self.name}' is "
                    + ("draining" if self._draining and not self._closed
                       else "closed")))
                return fut
            if len(self._queue) >= self.max_queue:
                if self._obs:
                    self._c_shed.inc()
                fut.set_exception(ServeOverload(
                    f"admission queue full ({self.max_queue} queued) "
                    "— load shed"))
                return fut
            self._queue.append(_Req(ids, fut, deadline_t, now, rid))
            if self._obs:
                self._c_accepted.inc()
            self._lock.notify()
        return fut

    def query(self, node_ids,
              deadline_ms: Optional[float] = None) -> np.ndarray:
        """Synchronous convenience: ``submit(...).result()``."""
        return self.submit(node_ids, deadline_ms=deadline_ms).result()

    def stats(self) -> Dict[str, Any]:
        """Microbatch and robustness accounting: the ``n_*`` keys are
        lifetime totals; ``shed_rate``, ``error_rate`` and
        ``availability`` are rates over the trailing ``window_s`` (None
        when the window saw no admission); the latency quantiles come
        from the registry's log-bucket histograms (within one bucket,
        ~16 % relative, of exact)."""
        w = self.stats_window_s
        n_batches = self._c_batches.total
        w_shed = self._c_shed.sum_over(w)
        w_denom = (self._c_accepted.sum_over(w) + w_shed
                   + self._c_rejected.sum_over(w))
        w_bad = self._c_timeout.sum_over(w) + self._c_errors.sum_over(w)
        with self._lock:
            versions = sorted(self._versions)

        def rate(num: int) -> Optional[float]:
            return round(num / w_denom, 4) if w_denom > 0 else None

        def q(h, p: float) -> Optional[float]:
            v = h.quantile(p, None)
            return round(v, 4) if v is not None else None

        return {"n_queries": self._c_accepted.total,
                "n_batches": n_batches,
                "rows_per_batch": (round(self._c_rows.total / n_batches, 2)
                                   if n_batches else None),
                "batch_p50_ms": q(self._h_batch, 0.50),
                "batch_p99_ms": q(self._h_batch, 0.99),
                "queue_p50_ms": q(self._h_queue, 0.50),
                "gather_p50_ms": q(self._h_gather, 0.50),
                "n_shed": self._c_shed.total,
                "n_timeout": self._c_timeout.total,
                "n_rejected_closed": self._c_rejected.total,
                "n_errors": self._c_errors.total,
                "n_ok": self._c_ok.total,
                "window_s": w,
                "shed_rate": rate(w_shed),
                "error_rate": rate(w_bad),
                "availability": rate(self._c_ok.sum_over(w)),
                "table_versions": versions[-8:]}

    def drain(self, timeout: Optional[float] = 30.0) -> bool:
        """Stop admitting, let the dispatcher finish every accepted
        request, then close.  True when all finished within
        ``timeout``."""
        with self._lock:
            if self._closed:
                return True
            self._draining = True
            self._lock.notify_all()
            deadline = None if timeout is None else time.monotonic() + timeout
            while self._queue or self._dispatching:
                left = None if deadline is None else deadline - time.monotonic()
                if left is not None and left <= 0:
                    break
                self._lock.wait(timeout=left)
            drained = not self._queue and not self._dispatching
        emit("serve", f"server '{self.name}' drained "
             f"({'clean' if drained else 'TIMED OUT with work left'})",
             console=False, kind="drain", clean=drained)
        self.close()
        return drained

    def close(self) -> None:
        """Reject new submits and stop the dispatcher once it has served
        what was queued; anything still queued after the join timeout
        fails with ``ServeClosed``."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._lock.notify_all()
        self._thread.join(timeout=10.0)
        with self._lock:
            left, self._queue = self._queue, []
        for r in left:
            if not r.fut.done():
                r.fut.set_exception(ServeClosed(
                    f"server '{self.name}' closed before dispatch"))
        self._flush_spans(final=True)
        st = self.stats()
        emit("serve", f"server '{self.name}' closed: {st['n_queries']} "
             f"queries in {st['n_batches']} batches (p50 "
             f"{st['batch_p50_ms']} ms, shed {st['n_shed']}, timeout "
             f"{st['n_timeout']})", console=False, kind="summary", **st)

    def __enter__(self) -> "Server":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------- dispatcher

    def _expire_locked(self, now: float) -> List[_Req]:
        """Split deadline-expired requests out of the queue (lock held);
        the caller fails them outside the lock."""
        live: List[_Req] = []
        dead: List[_Req] = []
        for r in self._queue:
            (dead if r.deadline_t is not None and r.deadline_t <= now
             else live).append(r)
        self._queue = live
        return dead

    def _fail_timeouts(self, dead: List[_Req]) -> None:
        """Fail expired requests outside the server lock (a done-callback
        may re-enter ``submit``)."""
        if dead and self._obs:
            self._c_timeout.inc(len(dead))
        for r in dead:
            if not r.fut.done():
                r.fut.set_exception(ServeTimeout(
                    "deadline expired before dispatch"))

    def _take_batch(self) -> Optional[List[_Req]]:
        """Block for work; after the first request, linger up to
        ``max_wait_s`` so concurrent submitters coalesce.  Returns None
        at shutdown."""
        while True:
            with self._lock:
                while not self._queue and not self._closed:
                    self._lock.wait()
                dead = self._expire_locked(time.monotonic())
                have = bool(self._queue)
                closed = self._closed
            self._fail_timeouts(dead)
            if not have:
                if closed:
                    return None
                continue
            if self.max_wait_s > 0:
                deadline = time.monotonic() + self.max_wait_s
                cap = max(self.pred.buckets)
                while time.monotonic() < deadline:
                    with self._lock:
                        if (sum(r.ids.size for r in self._queue) >= cap
                                or self._closed or self._draining):
                            break
                    time.sleep(self.max_wait_s / 8.0)
            with self._lock:
                dead = self._expire_locked(time.monotonic())
                batch, self._queue = self._queue, []
                if batch:
                    self._dispatching = True
            self._fail_timeouts(dead)
            if batch:
                return batch

    def _loop(self) -> None:
        while True:
            batch = self._take_batch()
            if batch is None:
                return
            try:
                self._dispatch(batch)
            except Exception as e:  # noqa: BLE001 - fail the futures
                if self._obs:
                    self._c_errors.inc(len(batch))
                # the dispatch's own error rides __cause__: the replica
                # wire reads a retryable OSError through it
                exc: Exception = e
                if not isinstance(e, (ServeError, ValueError)):
                    exc = ServeError(
                        f"dispatch failed: {type(e).__name__}: {e}")
                    exc.__cause__ = e
                for r in batch:
                    if not r.fut.done():
                        r.fut.set_exception(exc)
            finally:
                with self._lock:
                    self._dispatching = False
                    self._lock.notify_all()

    def _dispatch(self, batch: List[_Req]) -> None:
        ids = (np.concatenate([r.ids for r in batch])
               if len(batch) > 1 else batch[0].ids)
        with self._lock:
            self._batch_seq += 1
            batch_no = self._batch_seq
        # one table version for the whole microbatch, captured before
        # the fault sites: table_swap_mid_query publishes right here and
        # this batch must still finish on ``pub``
        pub = self.pred.published()
        inject.serve_batch_hooks(self, batch_no)
        t0 = time.monotonic()
        rows = self.pred.query(ids, pub=pub)
        ms = (time.monotonic() - t0) * 1e3
        gms = self.pred.last_gather_ms
        shard = self.pred.shard
        if self._obs:
            self._h_batch.record(ms)
            if gms is not None:
                self._h_gather.record(gms)
            self._c_batches.inc()
            self._c_rows.inc(int(ids.size))
            self._c_ok.inc(len(batch))
            for r in batch:
                self._h_queue.record(max(0.0, (t0 - r.t_admit) * 1e3))
        args: Dict[str, Any] = {"batch": batch_no, "rows": int(ids.size),
                                "version": int(pub.version)}
        rids = sorted({r.rid for r in batch if r.rid is not None})
        if rids:
            args["rids"] = rids
        with self._lock:
            self._versions.add(int(pub.version))
            self._spans.append(("serve_batch", t0, ms, args))
            flush = len(self._spans) >= _SPAN_FLUSH_EVERY
        if flush:
            self._flush_spans()
        lo = 0
        for r in batch:
            if not r.fut.done():
                r.fut.set_result(_result(
                    rows[lo:lo + r.ids.size], pub.version,
                    queue_ms=round(max(0.0, (t0 - r.t_admit) * 1e3), 3),
                    device_ms=round(ms, 3), qmode=pub.qmode, shard=shard,
                    gather_ms=None if gms is None else round(gms, 3)))
            lo += r.ids.size

    def _flush_spans(self, final: bool = False) -> None:
        with self._lock:
            spans, self._spans = self._spans, []
        if not spans:
            return
        emit("timeline", f"spans: {len(spans)} microbatch(es)"
             + (" (final)" if final else ""), console=False, kind="spans",
             spans=[[n, round(t0, 6), round(ms, 3), args]
                    for n, t0, ms, args in spans])
