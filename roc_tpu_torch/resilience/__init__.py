"""Preemption-safe training (``roc_tpu/resilience``), for the port's
trainers:

- **Checkpointing** — ``utils/checkpoint.py``, format v3, read and
  written by both packages: shard files under a crash-consistent
  two-phase commit, per-array CRC32s, a two-half config fingerprint,
  gather-on-restore onto any partition count.
- **Async saving** (:mod:`.async_save`) — a saver thread takes CRC,
  write and commit off the step path (queue depth 1, newest wins);
  ``flush()`` is the emergency-save barrier, ``drain()`` the shutdown.
- **Recovery** (:mod:`.recovery`) — a keep-last-k rotation with
  corrupt-checkpoint fallback, and the bounded retry loop
  ``train_with_recovery`` for numeric failures, stalls and transient
  I/O.
- **Preemption** (:mod:`.preempt`) — SIGTERM/SIGINT: finish the step,
  write an emergency checkpoint, exit 75.
- **Fault injection** (:mod:`.inject`) — one armed drill fault per
  process (``ROC_TPU_FAULT=site:epoch[:proc]``).

This ``__init__`` stays import-light (inject and preempt sit on the epoch
loop's hook path); the recovery layer loads on first use.
"""

from . import inject, preempt  # noqa: F401  (import-light)
from .preempt import Preempted, PreemptionGuard, RESTARTABLE_EXIT_CODE  # noqa: F401

_LAZY = ("NumericFailure", "RECOVERABLE", "CheckpointRotation",
         "check_finite", "check_params_finite", "train_with_recovery")


def __getattr__(name):
    if name in _LAZY:
        from . import recovery
        return getattr(recovery, name)
    if name == "AsyncSaver":
        from .async_save import AsyncSaver
        return AsyncSaver
    if name == "StallFailure":
        from ..obs.heartbeat import StallFailure
        return StallFailure
    if name in ("CheckpointCorrupt", "trainer_fingerprint"):
        from ..utils import checkpoint
        return getattr(checkpoint, name)
    raise AttributeError(f"module {__name__!r} has no attribute "
                         f"{name!r}")
