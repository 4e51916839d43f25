"""Checkpoint-restart recovery (``roc_tpu/resilience/recovery.py``): the
loop that makes faults survivable.

:func:`train_with_recovery` serves both trainers: it trains in
checkpointed rounds under a :class:`CheckpointRotation` and retries
every recoverable failure class — numeric poisoning
(:class:`NumericFailure`), watchdog-detected stalls
(:class:`~roc_tpu_torch.obs.heartbeat.StallFailure`, a wedged async
saver included) and transient I/O (``OSError``) — from the newest intact
checkpoint.  A :class:`~roc_tpu_torch.resilience.preempt.Preempted`
raise writes an emergency checkpoint through the same rotation, flushed,
and propagates, so the CLI exits restartable.  Every decision leaves a
``resilience`` event.
"""

from __future__ import annotations

import math
import os
import shutil
import sys
import time
from typing import Callable, Dict, List, Optional

import torch

from ..obs.events import emit, process_index
from ..obs.heartbeat import StallFailure
from ..utils.checkpoint import (CheckpointCorrupt, checkpoint_trainer,
                                is_committed, restore_trainer,
                                snapshot_trainer, writes)
from .preempt import Preempted


class NumericFailure(RuntimeError):
    """Raised when training metrics or parameters go NaN/Inf."""


# the failure classes the retry loop may restore and retry: numeric
# poisoning (the restored state discards it), stalls and transient I/O.
# Anything else is a bug and propagates.
RECOVERABLE = (NumericFailure, StallFailure, OSError)


def check_finite(metrics: Dict[str, float]) -> None:
    loss = metrics.get("train_loss")
    if loss is not None and not math.isfinite(loss):
        raise NumericFailure(f"non-finite train loss: {loss!r} "
                             f"at epoch {metrics.get('epoch')}")


def check_params_finite(params, opt_state=None) -> None:
    """Raise if any param or Adam-state value is NaN/Inf — the guard that
    keeps a poisoned state out of every checkpoint.

    One host sync for the whole state: an all-finite flag per floating
    leaf, stacked and reduced on the device, then a single ``.item()``
    (which waits for every launched step).  The per-leaf walk runs only
    on failure, to name the culprit."""
    named = [(f"param {k!r}", t) for k, t in params.items()]
    if opt_state is not None:
        for name, tree in (("m", opt_state.m), ("v", opt_state.v)):
            named += [(f"opt_state.{name}[{k!r}]", t)
                      for k, t in tree.items()]
        for name in ("beta1_t", "beta2_t"):
            if not math.isfinite(float(getattr(opt_state, name))):
                raise NumericFailure(f"non-finite opt_state.{name}")
    named = [(n, t) for n, t in named if t.is_floating_point()]
    if not named:
        return
    with torch.no_grad():
        if bool(torch.stack([torch.isfinite(t).all()
                             for _, t in named]).all().item()):
            return
        for name, t in named:
            if not bool(torch.isfinite(t).all()):
                raise NumericFailure(f"non-finite {name}")
    raise NumericFailure("non-finite value in the params or the Adam state")


class CheckpointRotation:
    """Keep the newest ``keep`` checkpoints of a trainer as
    ``<prefix>.<epoch>`` v3 directories (legacy ``<prefix>.<epoch>.npz``
    files are still scanned, restored and pruned).

    ``save`` runs the finite guard over params and Adam state first.
    With ``async_save=True`` the step path pays only the guard and the
    host snapshot; the write, the commit and the keep-window prune (which
    must follow the commit) run on the
    :class:`~roc_tpu_torch.resilience.async_save.AsyncSaver` thread —
    ``flush()`` is the emergency-save barrier, ``drain()`` the shutdown
    path.

    ``restore_latest`` validates every candidate in full (manifest, every
    shard's bytes, CRCs and coverage) before it touches the trainer, and
    falls back to the next-newest checkpoint when the newest is corrupt,
    with a ``corrupt_fallback`` event.  An uncommitted save (no manifest)
    is invisible to the scan.  On a partitioned trainer rank 0 scans,
    after its flush, and broadcasts the epoch it restored; every other
    rank then restores that epoch and no other."""

    def __init__(self, prefix: str, keep: int = 3,
                 async_save: bool = False):
        self.prefix = prefix
        self.keep = keep
        self.async_save = bool(async_save)
        self._saver = None
        self._sync_saves: List[Dict] = []
        self.last_block_ms: Optional[float] = None

    def path(self, epoch: int) -> str:
        return f"{self.prefix}.{epoch}"

    def path_for(self, epoch: int) -> str:
        """The artifact serving ``epoch``: the committed v3 directory
        when present, else the legacy single file (an uncommitted
        directory never shadows a legacy file of the same epoch)."""
        p = self.path(epoch)
        if is_committed(p):
            return p
        legacy = p + ".npz"
        if os.path.isfile(legacy):
            return legacy
        return p

    def existing(self) -> List[int]:
        d = os.path.dirname(self.prefix) or "."
        base = os.path.basename(self.prefix)
        out = set()
        if not os.path.isdir(d):
            return []
        for name in os.listdir(d):
            if not name.startswith(base + "."):
                continue
            mid = name[len(base) + 1:]
            if mid.isdigit():
                # only a committed directory exists to the rotation
                if is_committed(os.path.join(d, name)):
                    out.add(int(mid))
            elif mid.endswith(".npz") and mid[:-4].isdigit():
                out.add(int(mid[:-4]))
        return sorted(out)

    # ----------------------------------------------------- async saver

    def saver(self):
        """The lazily spawned background saver (async mode only)."""
        if self._saver is None:
            from .async_save import AsyncSaver
            self._saver = AsyncSaver()
        return self._saver

    def flush(self, timeout_s: Optional[float] = None) -> None:
        """Barrier: every submitted save committed (a no-op when saving
        synchronously)."""
        if self._saver is not None:
            self._saver.flush(timeout_s)

    def drain(self, timeout_s: Optional[float] = None) -> None:
        """Shutdown: flush, stop and join the saver thread."""
        if self._saver is not None:
            self._saver.drain(timeout_s)

    def save_stats(self) -> Dict:
        """Counters and the recent completed saves' records
        (``block_ms``, ``write_ms``, ``commit_ms``, ``bytes``, ...)."""
        if self._saver is None:
            return {"saved": len(self._sync_saves), "superseded": 0,
                    "saves": list(self._sync_saves[-8:])}
        return self._saver.stats()

    # ------------------------------------------------------ save/prune

    def _prune(self) -> None:
        """Drop checkpoints beyond the keep window, after a commit (in
        async mode on the saver thread): pruning ahead of an uncommitted
        save could leave no complete checkpoint.  Rank 0 only."""
        if process_index() != 0:
            return
        for old in self.existing()[:-self.keep]:
            for p in (self.path(old), self.path(old) + ".npz"):
                try:
                    if os.path.isdir(p):
                        shutil.rmtree(p)
                    elif os.path.isfile(p):
                        os.remove(p)
                # best effort: a leftover wastes disk, harms nothing, and
                # the next save retries it
                except OSError:
                    pass

    def save(self, trainer) -> str:
        """Persist the trainer's state as ``<prefix>.<epoch>``.  Sync
        mode: committed when this returns.  Async mode: only the finite
        guard and the snapshot run here (``last_block_ms``); ``flush()``
        waits for the commit."""
        p = self.path(trainer.epoch)
        if not self.async_save:
            stats = checkpoint_trainer(trainer, p)
            if stats is not None:
                self._sync_saves.append(stats)
            self._prune()
            return p
        t0 = time.perf_counter()
        check_params_finite(trainer.params, trainer.opt_state)
        snap = snapshot_trainer(trainer)
        self.last_block_ms = snap.block_ms = round(
            (time.perf_counter() - t0) * 1e3, 3)
        if writes(snap):
            self.saver().submit(snap, p, on_commit=self._prune)
        return p

    def _restore_newest(self, trainer, only_if_ahead: bool
                        ) -> Optional[int]:
        epochs = self.existing()
        if not epochs or (only_if_ahead and epochs[-1] <= trainer.epoch):
            return None
        for ep in reversed(epochs):
            if only_if_ahead and ep <= trainer.epoch:
                # the newest was ahead but corrupt, and every intact
                # fallback would rewind live progress
                return None
            path = self.path_for(ep)
            try:
                restore_trainer(trainer, path)
                return ep
            except CheckpointCorrupt as e:
                emit("resilience",
                     f"checkpoint {os.path.basename(path)} failed "
                     f"integrity validation ({e}) — falling back to "
                     f"the previous one", kind="corrupt_fallback",
                     path=path, epoch=ep)
        return None

    def restore_latest(self, trainer,
                       only_if_ahead: bool = False) -> Optional[int]:
        """Restore the newest intact checkpoint into ``trainer``; returns
        its epoch, or None if none was restored.  ``only_if_ahead``
        skips the restore when the trainer is already at or past the
        newest checkpoint (never rewind live progress)."""
        # an in-flight async save lands (or fails loudly) before the scan
        self.flush()
        rank = getattr(trainer, "global_rank", getattr(trainer, "rank", 0))
        ep = self._restore_newest(trainer, only_if_ahead) if rank == 0 \
            else None
        ep = trainer.agree(ep)
        if ep is not None and rank != 0:
            restore_trainer(trainer, self.path_for(ep))
        return ep


def train_with_recovery(trainer, target_epoch: int,
                        rotation: CheckpointRotation,
                        checkpoint_every: int = 50,
                        max_retries: int = 3,
                        on_failure: Optional[Callable[[Exception], None]]
                        = None) -> List[Dict[str, float]]:
    """Train until ``trainer.epoch == target_epoch`` in rounds of
    ``checkpoint_every`` epochs, each ending in a rotation save, with a
    bounded retry from the last good checkpoint on every
    :data:`RECOVERABLE` failure.

    It first resumes from the newest intact checkpoint, so re-invoking
    the same command after a crash continues the run (onto another
    partition count too).  On a retry the dropout generator is reseeded
    (``Trainer.reseed(epoch, retries)``: ``SeedSequence((config.seed,
    rank, epoch, retries))``, with the restored epoch and the retry
    count), as the JAX loop folds the retry count into its key: the same
    generator state would replay the same failing masks.  Preempted is
    not retried: it writes an emergency checkpoint, flushed, and
    propagates.  An async rotation is drained on the way out; a wedged
    saver surfaces as StallFailure, never a hang."""
    from . import inject
    history: List[Dict[str, float]] = []
    rotation.restore_latest(trainer, only_if_ahead=True)
    retries = 0
    try:
        while trainer.epoch < target_epoch:
            round_epochs = min(checkpoint_every,
                               target_epoch - trainer.epoch)
            try:
                hist = trainer.train(epochs=round_epochs)
                for m in hist:
                    check_finite(m)
                # the save's finite guard catches a NaN that arose after
                # the round's last eval, before the round's records join
                # the history (a refused round is replayed)
                path = rotation.save(trainer)
                history.extend(hist)
                retries = 0
                spec = inject.current()
                if spec is not None and not spec.fired:
                    # drills acting on the saved artifact need it
                    # committed; a saver-side site fires in this flush
                    rotation.flush()
                inject.maybe_corrupt_checkpoint(path, trainer.epoch)
                inject.maybe_corrupt_shard(path, trainer.epoch)
            except Preempted as e:
                saved: Optional[str]
                try:
                    saved = rotation.save(trainer)
                    rotation.flush()
                except NumericFailure:
                    saved = None
                emit("resilience",
                     f"preempted at epoch {trainer.epoch}: "
                     + (f"emergency checkpoint {os.path.basename(saved)}"
                        if saved else "state non-finite, not persisted")
                     + " — exiting restartable", kind="preempt",
                     epoch=trainer.epoch, checkpoint=saved, reason=str(e))
                raise
            except RECOVERABLE as e:
                if on_failure:
                    on_failure(e)
                retries += 1
                emit("resilience",
                     f"recovering from {type(e).__name__} at epoch "
                     f"{trainer.epoch} (retry {retries}/{max_retries}): "
                     f"{e}", kind="recovery", error=type(e).__name__,
                     epoch=trainer.epoch, retry=retries,
                     max_retries=max_retries)
                if retries > max_retries:
                    raise
                if rotation.restore_latest(trainer) is None:
                    raise
                trainer.reseed(trainer.epoch, retries)
    finally:
        # the async saver's shutdown: every accepted save committed, or a
        # loud StallFailure/OSError.  While another exception propagates,
        # a drain failure must not mask it
        propagating = sys.exc_info()[0] is not None
        try:
            rotation.drain()
        except Exception as de:  # noqa: BLE001 - see below
            if not propagating:
                raise
            emit("resilience",
                 f"saver drain failed during exception teardown: "
                 f"{type(de).__name__}: {de}", kind="saver_error",
                 error=type(de).__name__)
    return history
