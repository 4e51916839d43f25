"""Multi-partition execution (``roc_tpu/parallel``): the partitioned
trainer over ``torch.distributed`` (``distributed.py``), the ring halo
(``ring.py``) and the partition-local loading and launcher glue
(``multihost.py``).

This module holds the ``(parts, model)`` mesh's shape arithmetic, the
JAX package's ``parallel/__init__.py`` functions plus the rank layout of
the port's mesh (:class:`RankMesh`).  No torch: pure arithmetic.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

# the partition axis and the feature/model axis of the (parts, model)
# mesh, by the JAX package's names (checkpoint headers record them)
PARTS_AXIS = "parts"
MODEL_AXIS = "model"


def candidate_mesh_shapes(num_devices: int = 8) -> List[Tuple[int, int]]:
    """Every ``(parts, model)`` factorization of ``num_devices``,
    parts-major (1x8, 2x4, 4x2, 8x1 for 8)."""
    return [(p, num_devices // p) for p in range(1, num_devices + 1)
            if num_devices % p == 0]


def mesh_axes(shape) -> dict:
    """``{axis name: size}`` of a ``(parts, model)`` shape."""
    parts, model = shape
    return {PARTS_AXIS: int(parts), MODEL_AXIS: int(model)}


def model_shard_spec(shape, model: int) -> Optional[tuple]:
    """Per-dimension axis names (None or :data:`MODEL_AXIS`) of one
    buffer of ``shape`` on a mesh whose model axis is ``model`` wide, or
    None when no dimension divides (the leaf stays whole).  The last
    dimension first (features are trailing in every param and moment);
    the first whose size is a positive multiple of ``model`` wins."""
    model = int(model)
    if model <= 1:
        return None
    for ax in range(len(shape) - 1, -1, -1):
        d = int(shape[ax])
        if d >= model and d % model == 0:
            return tuple([None] * ax + [MODEL_AXIS]
                         + [None] * (len(shape) - ax - 1))
    return None


def shard_dim(shape, model: int) -> Optional[int]:
    """The dimension :func:`model_shard_spec` splits, or None."""
    spec = model_shard_spec(shape, model)
    return None if spec is None else spec.index(MODEL_AXIS)


@dataclass(frozen=True)
class RankMesh:
    """The ranks of a ``(parts, model)`` mesh, parts-major as the JAX
    package's ``make_mesh`` lays out devices: rank ``r = p * model + m``
    holds part ``p = r // model`` as model index ``m = r % model``.  The
    parts group of model index m is ``{p * model + m}``; the model group
    of part p is ``{p * model, ..., p * model + model - 1}``."""
    parts: int
    model: int

    @property
    def size(self) -> int:
        return self.parts * self.model

    def part_of(self, rank: int) -> int:
        return int(rank) // self.model

    def model_index(self, rank: int) -> int:
        return int(rank) % self.model

    def parts_group(self, m: int) -> List[int]:
        return [p * self.model + m for p in range(self.parts)]

    def model_group(self, p: int) -> List[int]:
        return list(range(p * self.model, (p + 1) * self.model))


class ModelSharding:
    """How a rank of a ``(parts, model)`` mesh holds the training state
    at rest: of each param (and its Adam moments) named in
    ``full_shapes``, its slice ``m`` of ``model`` along
    :func:`shard_dim`'s dimension (``dims``, None for a whole leaf).
    ``rank`` is the global rank and ``part`` the part it computes; the
    checkpoint writers are the ranks of part 0 (utils/checkpoint.py)."""

    def __init__(self, rank: int, part: int, m: int, model: int,
                 full_shapes: dict):
        self.rank, self.part, self.m, self.model = rank, part, m, model
        self.full_shapes = {k: tuple(int(d) for d in v)
                            for k, v in full_shapes.items()}
        self.dims = {k: shard_dim(v, model)
                     for k, v in self.full_shapes.items()}

    def bounds(self, name: str) -> Optional[Tuple[int, int, int]]:
        """``(dim, lo, hi)`` of this rank's slice of ``name``, or None
        for a whole leaf."""
        d = self.dims[name]
        if d is None:
            return None
        n = self.full_shapes[name][d] // self.model
        return d, self.m * n, (self.m + 1) * n

    def local(self, name: str, full):
        """This rank's slice of the whole array ``full`` (a view)."""
        b = self.bounds(name)
        if b is None:
            return full
        d, lo, hi = b
        return full[(slice(None),) * d + (slice(lo, hi),)]

    def index(self, name: str) -> Optional[list]:
        """The slice as the checkpoint's per-dimension ``[lo, hi)``
        ranges (None for a whole leaf)."""
        b = self.bounds(name)
        if b is None:
            return None
        d, lo, hi = b
        return [[lo, hi] if i == d else [0, n]
                for i, n in enumerate(self.full_shapes[name])]
