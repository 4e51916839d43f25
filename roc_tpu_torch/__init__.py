"""roc_tpu_torch: the PyTorch/CUDA port of roc_tpu for an NVIDIA H100.

Module names follow the JAX package's (``core/graph.py``,
``models/builder.py``, ``serve/predictor.py``, ...).  The hand-written
CUDA kernels (``kernels/``) are built from source at first use, never on
import.  This package imports neither JAX nor ``roc_tpu``.
"""
