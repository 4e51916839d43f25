"""Stall watchdog (``roc_tpu/obs/heartbeat.py``): periodic "still
waiting in <stage>" events, with an optional deadline that turns a
silent hang into a raisable failure.

A :class:`Heartbeat` wraps a region that may hang (the async saver's
flush, a setup collective) and emits a ``stall`` event every
``interval_s`` from a daemon thread, so the event stream records where
the time went even when the region never returns.

**Deadline promotion**: with ``ROC_TPU_STALL_TIMEOUT_S`` set (the JAX
package's variable, so one harness arms both) or ``deadline_s`` passed,
a region that outlives the deadline is interrupted: the watchdog sends a
real SIGINT to the main thread (``pthread_kill``; a thread blocked in a
C call never sees ``interrupt_main``'s flag) and the context manager
turns the ``KeyboardInterrupt`` into a :class:`StallFailure`, which the
recovery loop (``resilience/recovery.py``) retries from the last
checkpoint.  Armed only when the guarded region runs on the main thread.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Optional

from .events import emit

# default watchdog period; bench/test harnesses tighten it via env
DEFAULT_INTERVAL_S = 30.0


class StallFailure(RuntimeError):
    """A watchdog-guarded region exceeded its stall deadline.  One of
    the recoverable failure classes (resilience/recovery.py
    RECOVERABLE): the recovery loop restores the last checkpoint and
    retries instead of dying as a silent hang."""


def heartbeat_interval(default: float = DEFAULT_INTERVAL_S) -> float:
    try:
        return float(os.environ.get("ROC_TPU_HEARTBEAT_S", default))
    except ValueError:
        return default


# the Heartbeat currently interrupting the main thread (deadline
# promotion).  interrupt_main simulates SIGINT: when the preemption
# guard (resilience/preempt.py) owns the SIGINT handler it must be
# able to tell a watchdog interrupt from a user Ctrl-C — it checks
# this flag and re-raises KeyboardInterrupt instead of going graceful.
_INTERRUPTING: Optional["Heartbeat"] = None


def stall_interrupt_pending() -> bool:
    return _INTERRUPTING is not None


def stall_timeout() -> Optional[float]:
    """The env-armed stall deadline in seconds, or None (off — the
    default: a deadline that fires during a legitimate slow region
    would be worse than the hang it guards against, so arming is an
    explicit harness decision)."""
    try:
        t = float(os.environ.get("ROC_TPU_STALL_TIMEOUT_S", 0.0))
    except ValueError:
        return None
    return t if t > 0 else None


class Heartbeat:
    """Context manager emitting ``stall`` events while the enclosed
    region runs.

    >>> with Heartbeat("ckpt_flush"):
    ...     saver.flush()

    The thread is a daemon (a wedged region killed by SIGTERM must not
    be kept alive by its own watchdog) and fires only AFTER the first
    full interval — a fast region emits nothing.  ``cancel()`` (or
    normal exit) stops it; the event count is exposed as ``fired`` for
    tests and post-mortems.  An interval <= 0 (ROC_TPU_HEARTBEAT_S=0)
    disables the periodic beats — never a zero-wait spin loop — but an
    armed deadline still runs.

    ``deadline_s`` (default: ``ROC_TPU_STALL_TIMEOUT_S``, off when
    unset) promotes the watchdog from observer to enforcer: past the
    deadline the region is interrupted and exits by raising
    :class:`StallFailure`."""

    def __init__(self, stage: str, interval_s: Optional[float] = None,
                 deadline_s: Optional[float] = None,
                 bus=None, **fields: Any):
        self.stage = stage
        self.interval_s = (heartbeat_interval() if interval_s is None
                           else float(interval_s))
        self.deadline_s = (stall_timeout() if deadline_s is None
                           else (float(deadline_s)
                                 if deadline_s > 0 else None))
        self.fired = 0
        self.deadline_hit = False
        self._fields = fields
        self._bus = bus
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._t0 = 0.0
        self._owner_is_main = False

    def _emit(self, msg: str, **fields: Any) -> None:
        if self._bus is not None:
            self._bus.emit("stall", msg, stage=self.stage, **fields)
        else:
            emit("stall", msg, stage=self.stage, **fields)

    def _wait_s(self) -> float:
        """Next watchdog wait: the beat interval, shortened so an
        armed deadline can fire on time (beats off -> deadline-only
        cadence).  Once the deadline HAS fired the cadence reverts to
        plain beats — never a sub-interval spin."""
        if self.deadline_s is None or self.deadline_hit:
            return self.interval_s
        left = max(0.1, self.deadline_s
                   - (time.monotonic() - self._t0))
        if self.interval_s <= 0:
            return left
        return min(self.interval_s, left)

    def _run(self) -> None:
        while not self._stop.wait(self._wait_s()):
            elapsed = time.monotonic() - self._t0
            if self.deadline_s is not None and not self.deadline_hit \
                    and elapsed >= self.deadline_s:
                if self._stop.is_set():
                    # region completed while we were deciding: a
                    # signal now would land OUTSIDE the with-block
                    return
                self.deadline_hit = True
                self._emit(f"stall deadline {self.deadline_s:.0f}s "
                           f"exceeded in {self.stage} (elapsed "
                           f"{elapsed:.0f}s) — interrupting",
                           elapsed_s=round(elapsed, 1),
                           deadline_s=self.deadline_s, **self._fields)
                # raise the main thread out of the hang; __exit__
                # converts the KeyboardInterrupt into StallFailure.
                # A REAL signal (pthread_kill), not interrupt_main:
                # the latter only sets a Python-level flag, which a
                # thread blocked inside a C call (time.sleep, a device
                # fetch) never reaches — the signal EINTRs the call.
                # The flag lets a SIGINT-owning preemption guard
                # route this interrupt through instead of handling
                # it as a graceful Ctrl-C.
                # crash flight recorder: the stall may still wedge the
                # process terminally (a C-blocked region that retries
                # EINTR never sees the interrupt), so the telemetry
                # window is persisted BEFORE the interrupt attempt
                from .events import dump_flight_record
                dump_flight_record(f"stall:{self.stage}")
                global _INTERRUPTING
                _INTERRUPTING = self
                import signal as _signal
                _signal.pthread_kill(threading.main_thread().ident,
                                     _signal.SIGINT)
                if self.interval_s <= 0:
                    return
                # keep beating: a C-blocked region that retries EINTR
                # internally (a collective rendezvous) never sees
                # the interrupt — the hang the deadline failed to
                # break must still leave dated evidence
                continue
            if self.interval_s > 0:
                self.fired += 1
                self._emit(f"still waiting in {self.stage}, elapsed "
                           f"{elapsed:.0f}s",
                           elapsed_s=round(elapsed, 1),
                           beat=self.fired, **self._fields)

    def start(self) -> "Heartbeat":
        self._t0 = time.monotonic()
        self._stop.clear()
        self._owner_is_main = (threading.current_thread()
                               is threading.main_thread())
        if not self._owner_is_main:
            # interrupt_main would hit the wrong victim — keep the
            # watchdog observational for worker-thread regions
            self.deadline_s = None
        if self.interval_s <= 0 and self.deadline_s is None:
            # the documented off switch: wait(0) would return
            # immediately and flood stderr + the JSONL artifact
            return self
        self._thread = threading.Thread(
            target=self._run, name=f"heartbeat:{self.stage}",
            daemon=True)
        self._thread.start()
        return self

    def _shutdown(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None

    def _clear_pending(self) -> None:
        global _INTERRUPTING
        if _INTERRUPTING is self:
            _INTERRUPTING = None

    def cancel(self) -> None:
        self._shutdown()
        self._clear_pending()

    def __enter__(self) -> "Heartbeat":
        return self.start()

    def __exit__(self, exc_type, exc, tb) -> None:
        try:
            self._shutdown()
            if self.deadline_hit and exc_type is not KeyboardInterrupt:
                # the region exited (cleanly OR with some other
                # exception) in the same instant the watchdog fired:
                # its SIGINT is already in flight — absorb it here
                # rather than letting it land at an arbitrary later
                # point, where a cleared pending-stall flag would let
                # a preemption guard misread it as a graceful Ctrl-C
                # (while the flag is still set, the guard routes it
                # through as KeyboardInterrupt)
                time.sleep(0.1)
        except KeyboardInterrupt:
            if not self.deadline_hit:
                raise   # a real Ctrl-C racing the shutdown
            # the watchdog's late interrupt landed somewhere inside
            # the shutdown/absorb window: swallowed either way — the
            # region itself already exited (an in-region interrupt
            # never reaches this try)
        finally:
            self._clear_pending()
        if self.deadline_hit and exc_type is KeyboardInterrupt:
            raise StallFailure(
                f"stalled in {self.stage}: exceeded the "
                f"{self.deadline_s:.0f}s deadline "
                f"(ROC_TPU_STALL_TIMEOUT_S)") from exc
