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
  stops admitting, finishes what was accepted, then closes.

The metrics registry, timeline spans and windowed stats of the JAX
server are not ported yet.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from typing import List, Optional

import numpy as np

from .errors import ServeClosed, ServeError, ServeOverload, ServeTimeout

# admission-queue bound (requests, not rows)
DEFAULT_MAX_QUEUE = 1024


class ServeResult(np.ndarray):
    """The fp32 ``[n, C]`` logits plus the table ``version`` the
    request's microbatch was served under, ``queue_ms`` (admission to
    dispatch start), ``device_ms`` (the microbatch's dispatch wall) and
    ``qmode``, the captured version's quantization mode (during a quant
    swap, the encoding that answered)."""
    version: int = 0
    queue_ms: Optional[float] = None
    device_ms: Optional[float] = None
    qmode: str = "off"


def _result(rows: np.ndarray, version: int, queue_ms: float,
            device_ms: float, qmode: str = "off") -> ServeResult:
    out = rows.view(ServeResult)
    out.version = int(version)
    out.queue_ms = queue_ms
    out.device_ms = device_ms
    out.qmode = qmode
    return out


class _Req:
    __slots__ = ("ids", "fut", "deadline_t", "t_admit")

    def __init__(self, ids: np.ndarray, fut: Future,
                 deadline_t: Optional[float], t_admit: float):
        self.ids = ids
        self.fut = fut
        self.deadline_t = deadline_t
        self.t_admit = t_admit


class Server:
    """Coalescing dispatcher over a Predictor.

    ``max_wait_ms`` bounds how long the dispatcher lingers after the
    first queued request to let concurrent submitters join the batch;
    ``max_queue`` bounds the admission queue; ``default_deadline_ms``
    applies to submits that pass none."""

    def __init__(self, predictor, max_wait_ms: float = 0.2,
                 name: str = "serve", max_queue: int = DEFAULT_MAX_QUEUE,
                 default_deadline_ms: Optional[float] = None):
        self.pred = predictor
        self.max_wait_s = max(0.0, float(max_wait_ms)) / 1e3
        self.name = name
        self.max_queue = int(max_queue)
        self.default_deadline_ms = default_deadline_ms
        self._lock = threading.Condition()
        self._queue: List[_Req] = []
        self._closed = False
        self._draining = False
        self._dispatching = False
        self._thread = threading.Thread(target=self._loop,
                                        name=f"serve:{name}", daemon=True)
        self._thread.start()

    # ---------------------------------------------------------- public

    def submit(self, node_ids,
               deadline_ms: Optional[float] = None) -> Future:
        """Queue a query; the future resolves to the fp32 logits (a
        :class:`ServeResult`) or to a typed serve/errors.py failure."""
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
                fut.set_exception(ServeClosed(
                    f"server '{self.name}' is "
                    + ("draining" if self._draining and not self._closed
                       else "closed")))
                return fut
            if len(self._queue) >= self.max_queue:
                fut.set_exception(ServeOverload(
                    f"admission queue full ({self.max_queue} queued) "
                    "— load shed"))
                return fut
            self._queue.append(_Req(ids, fut, deadline_t, now))
            self._lock.notify()
        return fut

    def query(self, node_ids,
              deadline_ms: Optional[float] = None) -> np.ndarray:
        """Synchronous convenience: ``submit(...).result()``."""
        return self.submit(node_ids, deadline_ms=deadline_ms).result()

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

    @staticmethod
    def _fail_timeouts(dead: List[_Req]) -> None:
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
        pub = self.pred.published()
        t0 = time.monotonic()
        rows = self.pred.query(ids, pub=pub)
        ms = (time.monotonic() - t0) * 1e3
        lo = 0
        for r in batch:
            if not r.fut.done():
                r.fut.set_result(_result(
                    rows[lo:lo + r.ids.size], pub.version,
                    queue_ms=round(max(0.0, (t0 - r.t_admit) * 1e3), 3),
                    device_ms=round(ms, 3), qmode=pub.qmode))
            lo += r.ids.size
