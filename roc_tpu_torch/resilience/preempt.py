"""Preemption handling (``roc_tpu/resilience/preempt.py``): turn
SIGTERM/SIGINT into a graceful restart.

A scheduler that reclaims a machine sends SIGTERM and grants a grace
window before SIGKILL.  An installed :class:`PreemptionGuard` records the
signal; the epoch loop finishes the in-flight step and raises
:class:`Preempted` at the next epoch boundary; the recovery layer writes
an emergency checkpoint through its rotation, and the CLI exits with
:data:`RESTARTABLE_EXIT_CODE`, the code a supervisor reads as "re-invoke
the same command", which resumes from that checkpoint.

The handler only sets flags (no locks, no emit: a signal can land inside
``emit``, whose lock is not reentrant); the ``resilience`` event comes
from the code that handles the raise.  A second signal restores the
default disposition and re-delivers itself, so a stuck teardown can
always be killed.  Only the process that receives the signal sees it:
under ``torchrun`` each rank needs its own.
"""

from __future__ import annotations

import os
import signal
import time
from typing import Dict, Optional

# module level on purpose: the handler runs in signal context, where an
# import could deadlock on the import lock
from ..obs.heartbeat import stall_interrupt_pending

# os.EX_TEMPFAIL: "temporary failure, retry later"
RESTARTABLE_EXIT_CODE = 75

DEFAULT_GRACE_S = 30.0


class Preempted(RuntimeError):
    """Raised at an epoch boundary after a preemption signal; carries
    the restartable-exit contract (never a failure of the model)."""


class PreemptionGuard:
    """Installs SIGTERM/SIGINT handlers that request a graceful stop.

    ``requested()`` flips after the first signal; the epoch loop polls
    it once per epoch, so the in-flight step completes before the stop
    is acted on.  ``grace_s`` is the window the scheduler grants,
    recorded in the resilience event."""

    def __init__(self, grace_s: float = DEFAULT_GRACE_S):
        self.grace_s = float(grace_s)
        self.requested_at: Optional[float] = None
        self.signum: Optional[int] = None
        self._prev: Dict[int, object] = {}

    def install(self) -> "PreemptionGuard":
        for sig in (signal.SIGTERM, signal.SIGINT):
            self._prev[sig] = signal.signal(sig, self._handle)
        return self

    def uninstall(self) -> None:
        for sig, prev in self._prev.items():
            signal.signal(sig, prev)
        self._prev.clear()

    def _handle(self, signum, frame) -> None:
        if signum == signal.SIGINT:
            # a Heartbeat deadline interrupts the main thread with a
            # SIGINT (obs/heartbeat.py); owning the handler must not
            # swallow it — re-raise so the guarded region's __exit__
            # turns it into StallFailure
            if stall_interrupt_pending():
                raise KeyboardInterrupt
        if self.requested_at is not None:
            # second signal: stop being graceful
            signal.signal(signum, signal.SIG_DFL)
            os.kill(os.getpid(), signum)
            return
        self.requested_at = time.monotonic()
        self.signum = int(signum)
        try:
            # os.write on a raw fd: async-signal-safe (no buffer, no lock)
            # roc-lint: ok=signal-unsafe-handler
            os.write(2, b"# preemption signal received; finishing the "
                        b"in-flight epoch step\n")
        # stderr gone mid-teardown, nobody to tell
        # roc-lint: ok=swallowed-exception
        except OSError:
            pass

    def requested(self) -> bool:
        return self.requested_at is not None


_GUARD: Optional[PreemptionGuard] = None


def install(grace_s: float = DEFAULT_GRACE_S) -> PreemptionGuard:
    """Install (or re-use) the process-wide guard."""
    global _GUARD
    if _GUARD is None:
        _GUARD = PreemptionGuard(grace_s=grace_s).install()
    else:
        _GUARD.grace_s = float(grace_s)
    return _GUARD


def reset() -> None:
    """Uninstall and forget the process guard (tests)."""
    global _GUARD
    if _GUARD is not None:
        _GUARD.uninstall()
        _GUARD = None


def guard() -> Optional[PreemptionGuard]:
    return _GUARD


def requested() -> bool:
    return _GUARD is not None and _GUARD.requested()


def raise_if_preempted(epoch: Optional[int] = None) -> None:
    """Epoch-boundary check (``run_epoch_loop``): raise
    :class:`Preempted` once a signal has been recorded, after dumping
    the flight record from normal control flow."""
    if requested():
        sig = _GUARD.signum
        name = signal.Signals(sig).name if sig is not None else "?"
        from ..obs.events import dump_flight_record
        dump_flight_record(f"preempted:{name}")
        raise Preempted(
            f"{name} received"
            + (f" (epoch {epoch} step completed)" if epoch is not None
               else "")
            + f"; grace {_GUARD.grace_s:.0f}s")
