"""Asynchronous checkpoint saving (``roc_tpu/resilience/async_save.py``):
persistence off the step path.

The step path pays only the finite guard and the host snapshot
(``utils/checkpoint.snapshot_trainer``: on the card, ``non_blocking``
copies into pinned buffers, ordered before the next in-place Adam step
by the stream); the wait for those copies, the CRCs, the shard write,
the fsyncs and the manifest commit run on a dedicated saver thread while
training launches the next epochs.

- **Bounded queue, depth 1, coalescing**: at most one snapshot waits
  behind the in-flight save; a newer one supersedes it (a
  ``checkpoint``/``superseded`` event), so the saver never buffers more
  than two state copies nor blocks the step path.
- **flush()** — the emergency-save barrier: returns once the queue is
  empty and the in-flight save committed, bounded by a deadline
  (``ROC_TPU_CKPT_FLUSH_TIMEOUT_S``, else ``ROC_TPU_STALL_TIMEOUT_S``,
  else :data:`DEFAULT_FLUSH_TIMEOUT_S`); a wedged saver raises
  :class:`~roc_tpu_torch.obs.heartbeat.StallFailure`, never hangs.
- **drain()** — flush, stop, join: the shutdown path.  The thread is a
  daemon, so an abandoned saver cannot hold the process exit.
- A background failure is stored and raised on the next submit or
  flush: an async save never fails silently.

Single writer: rank 0 writes (``utils/checkpoint.py``), so coalescing
decisions, which depend on the saver's timing, never need to agree
across ranks.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional

from ..obs.events import emit
from ..obs.heartbeat import StallFailure, stall_timeout

DEFAULT_FLUSH_TIMEOUT_S = 600.0
# out-of-band override for the flush/drain deadline (the saver_stall
# drill pins it low WITHOUT arming the global heartbeat deadline)
ENV_FLUSH_TIMEOUT = "ROC_TPU_CKPT_FLUSH_TIMEOUT_S"
# keep the last few completed-save stat records (stats())
_STATS_KEEP = 8


def flush_timeout() -> float:
    """The flush/drain deadline: :data:`ENV_FLUSH_TIMEOUT` env >
    ``ROC_TPU_STALL_TIMEOUT_S`` (the global watchdog deadline) >
    :data:`DEFAULT_FLUSH_TIMEOUT_S`."""
    import os
    env = os.environ.get(ENV_FLUSH_TIMEOUT)
    if env:
        try:
            return float(env)
        except ValueError:
            # a typo'd deadline must not silently become 600 s
            emit("resilience",
                 f"ignoring non-numeric {ENV_FLUSH_TIMEOUT}={env!r} — "
                 f"using the default flush deadline",
                 kind="saver_error")
    return stall_timeout() or DEFAULT_FLUSH_TIMEOUT_S


class _Request:
    __slots__ = ("snap", "path", "t_submit", "on_commit")

    def __init__(self, snap, path: str, on_commit=None):
        self.snap = snap
        self.path = path
        self.t_submit = time.monotonic()
        self.on_commit = on_commit


class AsyncSaver:
    """The dedicated saver thread behind
    :class:`~roc_tpu_torch.resilience.recovery.CheckpointRotation`'s async
    mode.  All shared state (pending slot, busy flag, stored error,
    stat ring) lives under one condition variable; the actual CRC +
    write + commit runs with NO lock held."""

    def __init__(self, name: str = "ckpt-saver"):
        self._cond = threading.Condition()
        self._name = name
        self._pending: Optional[_Request] = None
        self._busy = False
        self._stop = False
        self._error: Optional[BaseException] = None
        self._thread: Optional[threading.Thread] = None
        self._stats: List[Dict[str, Any]] = []
        self._superseded = 0
        self._saved = 0

    # ------------------------------------------------------ lifecycle

    def _ensure_thread_locked(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._stop = False
            self._thread = threading.Thread(
                target=self._loop, name=self._name, daemon=True)
            self._thread.start()

    def submit(self, snap, path: str, on_commit=None) -> None:
        """Queue a snapshot for background save.  Raises a previously
        stored background failure (once); replaces (and reports) a
        still-queued older snapshot.  ``on_commit`` runs on the saver
        thread strictly AFTER the manifest commit (the rotation's
        keep-window prune rides it)."""
        dropped: Optional[_Request] = None
        with self._cond:
            err, self._error = self._error, None
            if err is None:
                self._ensure_thread_locked()
                if self._pending is not None:
                    dropped = self._pending
                    self._superseded += 1
                self._pending = _Request(snap, path, on_commit)
                self._cond.notify_all()
        if err is not None:
            raise err
        if dropped is not None:
            emit("checkpoint",
                 f"queued snapshot (epoch {dropped.snap.epoch}) "
                 f"superseded by epoch {snap.epoch} — queue depth 1, "
                 f"newest wins", console=False, kind="superseded",
                 epoch=dropped.snap.epoch, by=snap.epoch)

    def flush(self, timeout_s: Optional[float] = None) -> None:
        """Block until the queue is empty and no save is in flight —
        the emergency-save barrier.  Deadline-bounded: a wedged saver
        raises :class:`StallFailure` (never a silent hang), with
        heartbeat ``stall`` events dating the wait."""
        from ..obs.heartbeat import Heartbeat
        deadline = time.monotonic() + (
            timeout_s if timeout_s is not None else flush_timeout())
        # deadline_s=0: this wait has its own bounded deadline — the
        # heartbeat contributes the dated evidence trail only
        with Heartbeat("ckpt_flush", deadline_s=0):
            with self._cond:
                while self._pending is not None or self._busy:
                    left = deadline - time.monotonic()
                    if left <= 0:
                        raise StallFailure(
                            "async checkpoint saver wedged: flush() "
                            "deadline exceeded with a save still in "
                            "flight")
                    self._cond.wait(timeout=min(left, 1.0))
                err, self._error = self._error, None
        if err is not None:
            raise err

    def drain(self, timeout_s: Optional[float] = None) -> None:
        """Shutdown path: flush, then stop and join the thread.  A
        wedged saver raises the flush's StallFailure; the daemon
        thread is abandoned (it cannot hold exit hostage)."""
        try:
            self.flush(timeout_s)
        finally:
            with self._cond:
                self._stop = True
                self._cond.notify_all()
            if self._thread is not None:
                # only drain/submit touch _thread, and submits after a
                # drain re-spawn it — no concurrent mutation here
                self._thread.join(timeout=5.0)

    # ----------------------------------------------------- the thread

    def _loop(self) -> None:
        while True:
            with self._cond:
                while self._pending is None and not self._stop:
                    self._cond.wait()
                if self._stop and self._pending is None:
                    return
                req = self._pending
                self._pending = None
                self._busy = True
            try:
                self._process(req)
            except Exception as e:  # noqa: BLE001 - stored, re-raised on the next submit/flush
                with self._cond:
                    self._error = e
                emit("resilience",
                     f"async checkpoint save failed "
                     f"({type(e).__name__}: {e}) — surfacing on the "
                     f"next save/flush", kind="saver_error",
                     error=type(e).__name__, epoch=req.snap.epoch)
            finally:
                with self._cond:
                    self._busy = False
                    self._cond.notify_all()

    def _process(self, req: _Request) -> None:
        from ..utils.checkpoint import write_snapshot
        from . import inject
        # fault drill site: a wedged saver thread — flush()'s deadline
        # (not this sleep) must bound the damage
        inject.maybe_saver_stall(req.snap.epoch)
        queued_ms = (time.monotonic() - req.t_submit) * 1e3
        t0 = time.monotonic()
        stats = write_snapshot(req.path, req.snap)
        if req.on_commit is not None:
            req.on_commit()
        t1 = time.monotonic()
        stats["queued_ms"] = round(queued_ms, 3)
        stats["async_wall_ms"] = round(
            (t1 - req.t_submit) * 1e3 + req.snap.block_ms, 3)
        with self._cond:
            self._saved += 1
            self._stats.append(stats)
            del self._stats[:-_STATS_KEEP]
        # span laps in the JAX package's timeline format: the background
        # write and commit beside the training bursts
        write_ms = stats["write_ms"]
        commit_ms = stats["commit_ms"]
        emit("timeline", f"spans: ckpt save epoch {req.snap.epoch}",
             console=False, kind="spans",
             spans=[["ckpt_write", round(t0, 6), round(write_ms, 3)],
                    ["ckpt_commit", round(t0 + write_ms / 1e3, 6),
                     round(commit_ms, 3)]])
        emit("checkpoint",
             f"async save committed: epoch {req.snap.epoch} in "
             f"{stats['save_ms']:.1f} ms (step path blocked "
             f"{req.snap.block_ms:.1f} ms)", console=False,
             kind="saved", **{k: stats[k] for k in
                              ("epoch", "path", "block_ms", "write_ms",
                               "commit_ms", "save_ms", "queued_ms",
                               "async_wall_ms", "bytes", "shards")})

    # ------------------------------------------------------ inspection

    def stats(self) -> Dict[str, Any]:
        """Saver counters and the recent completed-save records."""
        with self._cond:
            return {"saved": self._saved,
                    "superseded": self._superseded,
                    "busy": self._busy,
                    "pending": self._pending is not None,
                    "saves": list(self._stats)}
