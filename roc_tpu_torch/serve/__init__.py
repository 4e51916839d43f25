"""Serving tier: the Predictor (full-graph and precomputed backends,
sharded table slices), propagation tables, quantized tables, the export
artifact, the microbatch Server, the replica fleet behind the Router and
typed errors."""

from .errors import GatherError, ReplicaLost
from .predictor import ShardSlice

__all__ = ["GatherError", "ReplicaLost", "Router", "ShardSlice"]


def __getattr__(name):
    # the router imports serve/replica.py, which a replica runs as
    # ``-m roc_tpu_torch.serve.replica``: importing it with the package
    # would load that module twice in every replica
    if name == "Router":
        from .router import Router
        return Router
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
