"""roc_tpu_torch: the PyTorch/CUDA port of roc_tpu for an NVIDIA H100.

Module names follow the JAX package's (``core/graph.py``,
``models/builder.py``, ``serve/predictor.py``, ...).  The hand-written
CUDA kernels (``kernels/``) are built from source at first use, never on
import.  This package imports neither JAX nor ``roc_tpu``, and importing
it imports no torch: its readers (``report``, ``timeline``, ``analysis``)
run as ``python -m`` without it.
"""

_CHECKPOINT = ("checkpoint_trainer", "load_checkpoint", "restore_trainer")


def __getattr__(name):
    # the checkpoint entry points, imported (with torch) on first use
    if name in _CHECKPOINT:
        from .utils import checkpoint
        return getattr(checkpoint, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
