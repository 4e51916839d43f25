"""Site-based fault injection (``roc_tpu/resilience/inject.py``): drill
the failure paths for real.

One fault is armed per process (``ROC_TPU_FAULT=site:epoch[:proc]``, the
JAX package's variable, or ``TrainConfig.fault``) and fires at most once
at its hook point; ``proc`` restricts it to one ``torch.distributed``
rank.  Sites:

- ``nan_grads``        write NaN into one param after the armed epoch's
                       step (the silent numeric failure);
- ``sigkill``          SIGKILL this process at the armed epoch;
- ``sigterm``          SIGTERM to this process at the armed epoch (the
                       preemption grace path);
- ``kill_in_save``     SIGKILL between the shard's tmp-file write and
                       its rename: the torn ``.npz.tmp`` must never be
                       restored;
- ``kill_in_async_save``  SIGKILL inside the two-phase-commit window —
                       shard renamed into place, manifest not yet
                       published (on the saver thread in async mode,
                       inline in sync mode); the restart must see only
                       the previous committed checkpoint;
- ``bitflip_checkpoint``  flip the first byte of the just-committed
                       manifest (legacy file: a mid-file byte), then
                       SIGKILL: the restart must fall back;
- ``shard_corrupt``    flip one byte of a committed shard, then
                       SIGKILL: the manifest-vs-shard CRC check must
                       reject it;
- ``saver_stall``      wedge the async saver thread: the flush deadline
                       must bound the damage (StallFailure, exit 75);
- ``staging_io``       an OSError from the streamed tier's staging call
                       (core/streaming.py ``_stage_block``) during the
                       armed epoch: the recovery loop restores and
                       retries;
- ``stall_compile``    the first step's barrier (run_epoch_loop, under
                       the ``first_compile`` heartbeat) sleeps far past
                       any deadline: only ``ROC_TPU_STALL_TIMEOUT_S``
                       ends it, as a StallFailure.

Serve sites: the same grammar drills the serving tier, ``epoch`` read as
the server's microbatch index (``Server._dispatch`` passes it) and
``proc`` as the replica index a router assigned (:func:`note_proc_index`;
a replica has no process group).  They fire at or past the armed index:

- ``replica_sigkill``  SIGKILL this replica mid-dispatch: the router
                       fails over its in-flight requests;
- ``replica_stall``    hang one dispatch for an hour: hedging and
                       deadlines must cover;
- ``table_swap_mid_query``  publish a real edge-append version swap
                       between a microbatch's version capture and its
                       dispatch: the batch finishes bit-exact on the
                       version it captured;
- ``serve_io``         an OSError from the dispatch site: the replica
                       reports a retryable failure, the router
                       re-dispatches.
"""

from __future__ import annotations

import os
import signal
import time
from dataclasses import dataclass
from typing import Optional

from ..obs.events import emit, process_index

ENV_VAR = "ROC_TPU_FAULT"

SITES = ("nan_grads", "sigkill", "sigterm", "kill_in_save",
         "kill_in_async_save", "shard_corrupt", "saver_stall",
         "bitflip_checkpoint", "staging_io", "stall_compile",
         "replica_sigkill", "replica_stall", "table_swap_mid_query",
         "serve_io")


@dataclass
class FaultSpec:
    """One armed fault: ``site:epoch[:proc]``; ``proc`` None fires on any
    rank."""
    site: str
    epoch: int
    proc: Optional[int] = None
    fired: bool = False

    def spec_str(self) -> str:
        s = f"{self.site}:{self.epoch}"
        return s if self.proc is None else f"{s}:{self.proc}"


_SPEC: Optional[FaultSpec] = None
_ENV_CHECKED = False
# the epoch the training loop last entered (run_epoch_loop notes it)
_EPOCH: Optional[int] = None
# a serve replica's router-assigned index, which the ``:proc`` arm
# matches in place of the rank (note_proc_index)
_PROC_OVERRIDE: Optional[int] = None


def parse(spec: str) -> FaultSpec:
    parts = spec.split(":")
    if len(parts) not in (2, 3) or parts[0] not in SITES:
        raise ValueError(
            f"bad fault spec {spec!r}; expected site:epoch[:proc] with "
            f"site in {SITES}")
    try:
        epoch = int(parts[1])
        proc = int(parts[2]) if len(parts) == 3 else None
    except ValueError:
        raise ValueError(f"bad fault spec {spec!r}: epoch/proc must "
                         "be integers") from None
    if epoch < 0 or (proc is not None and proc < 0):
        # a negative epoch could never match: a silent no-op drill
        raise ValueError(f"bad fault spec {spec!r}: epoch/proc must "
                         "be >= 0")
    return FaultSpec(site=parts[0], epoch=epoch, proc=proc)


def arm(spec: Optional[str]) -> Optional[FaultSpec]:
    """Arm a fault from its spec string.  Re-arming the identical spec
    keeps the existing record, ``fired`` included: a second ``train()``
    call must not re-fire a spent fault."""
    global _SPEC
    if not spec:
        return _SPEC
    new = parse(spec)
    if _SPEC is not None and (_SPEC.site, _SPEC.epoch, _SPEC.proc) == \
            (new.site, new.epoch, new.proc):
        return _SPEC
    _SPEC = new
    return _SPEC


def disarm() -> None:
    """Reset (tests)."""
    global _SPEC, _ENV_CHECKED, _EPOCH, _PROC_OVERRIDE
    _SPEC = None
    _ENV_CHECKED = False
    _EPOCH = None
    _PROC_OVERRIDE = None


def note_proc_index(idx: int) -> None:
    """Pin this process's identity for the ``:proc`` arm: a serve replica
    calls it with its router-assigned index (it wins over the rank)."""
    global _PROC_OVERRIDE
    _PROC_OVERRIDE = int(idx)


def current() -> Optional[FaultSpec]:
    """The armed fault, armed lazily from ``ROC_TPU_FAULT`` on first use
    (an explicit :func:`arm` wins over the environment)."""
    global _ENV_CHECKED
    if _SPEC is None and not _ENV_CHECKED:
        _ENV_CHECKED = True
        env = os.environ.get(ENV_VAR)
        if env:
            arm(env)
    return _SPEC


def note_epoch(epoch: int) -> None:
    global _EPOCH
    _EPOCH = int(epoch)


def _fire(spec: FaultSpec, detail: str, **fields) -> None:
    """Mark the fault spent and leave a resilience event before acting,
    so a SIGKILL site is attributable from the event stream alone; the
    flight record is dumped too."""
    spec.fired = True
    emit("resilience", f"fault injected: {spec.spec_str()} — {detail}",
         kind="fault", site=spec.site, epoch=spec.epoch, **fields)
    from ..obs.events import dump_flight_record
    dump_flight_record(f"fault:{spec.site}")


def _ready(site: str, epoch: Optional[int] = None, *,
           at_least: bool = False, noted: bool = False
           ) -> Optional[FaultSpec]:
    """The one readiness gate: armed, not yet spent, right site, right
    rank, and the caller's epoch equal to the armed one (``at_least``:
    at or past it; None skips the check).  ``noted`` compares the epoch
    the loop last noted instead (sites with no epoch of their own; None
    never matches, so work outside the epoch loop never spends an
    epoch-gated fault)."""
    spec = current()
    if spec is None or spec.fired or spec.site != site:
        return None
    if spec.proc is not None and spec.proc != (
            process_index() if _PROC_OVERRIDE is None else _PROC_OVERRIDE):
        return None
    if noted:
        return spec if _EPOCH == spec.epoch else None
    if epoch is None:
        return None if at_least else spec
    if epoch < spec.epoch if at_least else epoch != spec.epoch:
        return None
    return spec


def _poison_params(trainer) -> None:
    """NaN into the first element of the first floating param (sorted
    names, the JAX tree's order), in place."""
    import torch
    with torch.no_grad():
        for k in sorted(trainer.params):
            p = trainer.params[k]
            if p.is_floating_point() and p.numel():
                p.view(-1)[0] = float("nan")
                return


def epoch_hooks(trainer, epoch: int) -> None:
    """Epoch-boundary sites, called by ``run_epoch_loop`` after the
    step of ``epoch`` has been launched."""
    spec = _ready("nan_grads", epoch) or _ready("sigkill", epoch) \
        or _ready("sigterm", epoch)
    if spec is None:
        return
    if spec.site == "nan_grads":
        _fire(spec, "NaN written into one param")
        _poison_params(trainer)
    elif spec.site == "sigkill":
        _fire(spec, "SIGKILL mid-run")
        os.kill(os.getpid(), signal.SIGKILL)
    elif spec.site == "sigterm":
        _fire(spec, "SIGTERM delivered (preemption drill)")
        os.kill(os.getpid(), signal.SIGTERM)


def maybe_kill_in_save(epoch: int) -> None:
    """Between the shard's tmp write and its rename
    (utils/checkpoint._write_shard)."""
    spec = _ready("kill_in_save", int(epoch))
    if spec is not None:
        _fire(spec, "SIGKILL mid-checkpoint-write (.npz.tmp on disk)")
        os.kill(os.getpid(), signal.SIGKILL)


def maybe_kill_in_commit(epoch: int) -> None:
    """The two-phase-commit window (utils/checkpoint.write_snapshot):
    shard renamed into place, MANIFEST.json not yet published."""
    spec = _ready("kill_in_async_save", int(epoch))
    if spec is not None:
        _fire(spec, "SIGKILL between shard rename and manifest "
                    "commit (shards on disk, no manifest)")
        os.kill(os.getpid(), signal.SIGKILL)


def maybe_saver_stall(epoch: int) -> None:
    """The async saver thread (resilience/async_save.py) sleeps far past
    any sane deadline; flush()'s deadline must turn it into a
    StallFailure."""
    spec = _ready("saver_stall", int(epoch), at_least=True)
    if spec is not None:
        _fire(spec, "stalling the async saver thread")
        time.sleep(3600.0)


def _flip_byte(path: str, offset: Optional[int] = None) -> None:
    """Flip one byte in place (mid-file by default) and fsync."""
    with open(path, "r+b") as f:
        f.seek(0, os.SEEK_END)
        off = f.tell() // 2 if offset is None else offset
        f.seek(off)
        b = f.read(1)
        f.seek(off)
        f.write(bytes([b[0] ^ 0xFF]))
        f.flush()
        os.fsync(f.fileno())


def maybe_corrupt_checkpoint(path: str, epoch: int) -> None:
    """After a committed rotation save: corrupt the commit record (the
    manifest's first byte; a legacy file's middle byte), then SIGKILL."""
    spec = _ready("bitflip_checkpoint", int(epoch), at_least=True)
    if spec is None:
        return
    target, off = path, None
    if os.path.isdir(path):
        target, off = os.path.join(path, "MANIFEST.json"), 0
    _fire(spec, f"bit-flipped {os.path.basename(target)}, then "
                f"SIGKILL", path=target)
    _flip_byte(target, off)
    os.kill(os.getpid(), signal.SIGKILL)


def maybe_corrupt_shard(path: str, epoch: int) -> None:
    """After a committed rotation save: flip one byte of a shard file
    under an intact manifest, then SIGKILL."""
    spec = _ready("shard_corrupt", int(epoch), at_least=True)
    if spec is None:
        return
    target = path
    if os.path.isdir(path):
        shards = sorted(n for n in os.listdir(path)
                        if n.startswith("shard_") and n.endswith(".npz"))
        if not shards:
            return
        target = os.path.join(path, shards[0])
    _fire(spec, f"bit-flipped shard {os.path.basename(target)}, then "
                f"SIGKILL", path=target)
    _flip_byte(target)
    os.kill(os.getpid(), signal.SIGKILL)


def maybe_staging_error() -> None:
    """The streamed tier's staging site (core/streaming.py
    ``_stage_block``): an OSError during the armed epoch; the recovery
    loop treats it as a transient failure and retries."""
    spec = _ready("staging_io", noted=True)
    if spec is None:
        return
    _fire(spec, "OSError raised from the staging call site")
    raise OSError(f"injected StagingPool I/O fault ({spec.spec_str()})")


def maybe_stall() -> None:
    """The first step's barrier (run_epoch_loop, inside the
    ``first_compile`` heartbeat): sleep far past any sane deadline.  Only
    the watchdog's ``ROC_TPU_STALL_TIMEOUT_S`` ends it (obs/heartbeat.py
    interrupts the main thread and raises StallFailure)."""
    spec = _ready("stall_compile", noted=True)
    if spec is None:
        return
    _fire(spec, "stalling the first step's barrier")
    time.sleep(3600.0)


def serve_batch_hooks(server, batch_no: int) -> None:
    """The serve sites, called by ``Server._dispatch`` after the
    microbatch captured its table version and before its dispatch.
    ``batch_no`` is the server's microbatch index; the sites fire at or
    past the armed index, once."""
    spec = (_ready("replica_sigkill", batch_no, at_least=True)
            or _ready("replica_stall", batch_no, at_least=True)
            or _ready("table_swap_mid_query", batch_no, at_least=True)
            or _ready("serve_io", batch_no, at_least=True))
    if spec is None:
        return
    if spec.site == "replica_sigkill":
        _fire(spec, f"SIGKILL mid-dispatch (microbatch {batch_no})")
        os.kill(os.getpid(), signal.SIGKILL)
    elif spec.site == "replica_stall":
        _fire(spec, f"stalling dispatch of microbatch {batch_no}: "
                    f"hedging and deadlines must cover")
        time.sleep(3600.0)
    elif spec.site == "table_swap_mid_query":
        _fire(spec, f"publishing a table-version swap under microbatch "
                    f"{batch_no}'s captured version")
        try:
            # a real mutation (a self edge on node 0)
            server.pred.invalidate([0], [0])
        except NotImplementedError:
            # no mutable table (the full backend, the 'table' flavor, a
            # shard): the fault event above records the drill ran here
            emit("resilience", "table_swap_mid_query: backend has no "
                 "mutable table — swap skipped", kind="fault_noop",
                 site=spec.site)
    elif spec.site == "serve_io":
        _fire(spec, f"OSError raised from the serve dispatch site "
                    f"(microbatch {batch_no})")
        raise OSError(f"injected serve I/O fault ({spec.spec_str()})")
