"""Partition-local loading and the launcher glue of a multi-rank run
(``roc_tpu/parallel/multihost.py``, on ``torch.distributed``: a JAX
"process" is a rank here).

The reference runs multi-machine through Legion address spaces, and each
node's loader tasks read only their partitions' rows
(``load_task.cu:41-51, 201-269``).  Here:

- :func:`init_distributed` brings the default process group up from a
  launcher's environment (torchrun's ``RANK``, ``WORLD_SIZE``,
  ``MASTER_ADDR``, ``MASTER_PORT``), a no-op without one;
- :func:`process_local_parts` names the part a rank holds on the
  parts-major ``(parts, model)`` mesh (``parallel.RankMesh``);
- :func:`shard_dataset_local` builds a rank's tables from a
  ``DataSource`` (core/source.py), reading only its part's rows and
  columns besides the O(V) row pointer; the shapes every part shares are
  agreed with ``Collectives.agree_max``, one collective each;
- :func:`checkpoint_commit_barrier` is the multi-writer checkpoint's
  rendezvous (utils/checkpoint.py ``write_snapshot``).
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import List, Optional

import torch
import torch.distributed as dist

_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def init_distributed(backend: Optional[str] = None,
                     timeout_s: float = 1800.0) -> bool:
    """Initialise the default process group from the launcher's
    environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT``, as torchrun exports them; ``env://``).  A no-op,
    returning False, when the group is up already or no launcher set
    them.  ``backend``: 'nccl' when a card is present, else 'gloo', by
    default.  The event clock's process identity is pinned to the rank
    first, so the events of the set-up stamp the right rank."""
    if dist.is_initialized() or not all(k in os.environ for k in _ENV):
        return False
    rank = int(os.environ["RANK"])
    from ..obs.events import set_clock_identity
    set_clock_identity(proc=rank)
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend, init_method="env://",
                            world_size=int(os.environ["WORLD_SIZE"]),
                            rank=rank, timeout=timedelta(seconds=timeout_s))
    return True


def process_local_parts(mesh, rank: Optional[int] = None) -> List[int]:
    """The parts this rank holds on ``mesh`` (a ``parallel.RankMesh``):
    on the parts-major order ``rank = p * M + m``, ``[rank // M]``.
    ``rank``: this process's rank in the default group by default."""
    if rank is None:
        rank = dist.get_rank() if dist.is_initialized() else 0
    return [mesh.part_of(rank)]


def checkpoint_commit_barrier(tag: str, group=None) -> None:
    """The multi-writer checkpoint's rendezvous (``write_snapshot``'s
    un-commit and commit barriers) over ``group`` (a trainer's own gloo
    group for them; None is the default group), inside a
    ``ckpt_commit_barrier`` heartbeat, so a dead peer's stall is dated
    and, with ``ROC_TPU_STALL_TIMEOUT_S`` set, becomes a StallFailure.
    Every rank's ``tag`` (the checkpoint and its epoch) is all-gathered,
    and the barrier raises on every rank when they differ, as the JAX
    package's ``sync_global_devices`` does: ranks at different saves
    never pair.  A no-op at world size 1."""
    if not dist.is_initialized() or dist.get_world_size(group) == 1:
        return
    from ..obs.heartbeat import Heartbeat
    tags: List[Optional[str]] = [None] * dist.get_world_size(group)
    with Heartbeat("ckpt_commit_barrier", op=tag):
        dist.all_gather_object(tags, tag, group=group)
    if any(t != tag for t in tags):
        raise RuntimeError(
            f"checkpoint commit barrier {tag!r}: the ranks reached "
            f"different saves {tags} (every rank must write the same "
            f"epochs in the same order)")


def shard_dataset_local(source, plan, rank: int, device=None,
                        dtype: torch.dtype = torch.float32,
                        aggr_impl: str = "cuda", halo: str = "gather",
                        fuse: bool = False, group=None, **layout):
    """This rank's ``ShardedData`` (parallel/distributed.py) of part
    ``rank`` of ``plan``, built from ``source`` (a ``DataSource``, e.g. a
    ``FileSource``; a Dataset is wrapped) for every ``aggr_impl`` and
    ``halo`` that ``shard_dataset`` builds: the part's row slices and
    column range alone are read (the ring's pairs from
    ``partition_col(plan, source.col_slice, rank)``), and the tables are
    bit-equal to ``shard_dataset``'s from the in-memory Dataset.  The
    shapes every part shares are agreed with ``Collectives.agree_max``
    over ``group`` (every rank of it calls this together; the model
    replicas of a part on a 2-D mesh agree alike, a max being
    indifferent to repeats).  ``device``: the card unless the caller
    passes another (``'cpu'``).  ``fuse`` and ``layout`` as
    ``shard_dataset`` takes them (``TrainConfig``'s layout fields); a
    trainer given the result (``DistributedTrainer(data=, plan=)``)
    must resolve to the same ``aggr_impl`` and halo."""
    from ..core.source import as_source
    from ..train.trainer import resolve_device
    from .distributed import Collectives, shard_dataset
    agree = None
    if dist.is_initialized() and dist.get_world_size(group) > 1:
        agree = Collectives(group).agree_max
    return shard_dataset(as_source(source), plan, rank,
                         resolve_device(device), dtype=dtype,
                         aggr_impl=aggr_impl, halo=halo, fuse=fuse,
                         agree_max=agree, **layout)
