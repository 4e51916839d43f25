"""Hand-written CUDA kernels (csrc/), built at first use by _build.py."""
