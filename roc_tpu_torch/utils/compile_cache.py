"""The build cache (``roc_tpu/utils/compile_cache.py``): where the port
keeps what it compiles.

The JAX package persists XLA's compiled programs, keyed by program,
compiler and device kind, so a process after the first skips the
compile.  The port compiles one thing: the kernel library
(kernels/_build.py, every ``csrc/*.cu`` by ``nvcc`` for ``sm_90a``, named
by a digest of its sources and flags), and beside it the native host
planners (native/, ``g++``).  Both already go to a directory and are
loaded from there when present; :func:`enable_compile_cache` points the
two at one directory that every process of a user shares, so a process
after the first loads the library instead of building it.  The CLI
(``python -m roc_tpu_torch.train.cli``) enables it by default
(``--no-compile-cache`` leaves the in-tree build directories), as the
JAX CLI does; a library user calls it before the first kernel.

``min_compile_secs`` is the JAX package's write threshold (programs that
compile faster are not persisted).  The port persists its one library
whatever its build time, so the value is taken, recorded in the run
manifest (``TrainConfig.cache_min_compile_secs``) and read by nothing.
"""

from __future__ import annotations

import os
from typing import Optional

ENV_DIR = "ROC_TPU_TORCH_CACHE_DIR"
DEFAULT_DIR = os.path.join(os.path.expanduser("~"), ".cache",
                           "roc_tpu_torch", "kernels")


def default_dir() -> str:
    """``$ROC_TPU_TORCH_CACHE_DIR``, else :data:`DEFAULT_DIR`."""
    return os.environ.get(ENV_DIR) or DEFAULT_DIR


def enable_compile_cache(cache_dir: Optional[str] = None,
                         min_compile_secs: Optional[float] = None
                         ) -> Optional[str]:
    """Point the kernel library's and the native planners' build
    directories at ``cache_dir`` (default: ``$ROC_TPU_TORCH_CACHE_DIR``,
    else ``~/.cache/roc_tpu_torch/kernels``) and return it.  When the
    directory cannot be created (a read-only HOME) a ``compile`` event
    says so and None is returned, as in the JAX package: the kernels are
    then built into a directory of this process alone (a fresh temporary
    one), and still run.  ``min_compile_secs``: see the module
    docstring."""
    from ..kernels import _build
    from .. import native
    d = cache_dir or default_dir()
    try:
        os.makedirs(d, exist_ok=True)
    except OSError as e:
        import tempfile

        from ..obs.events import emit
        own = tempfile.mkdtemp(prefix="roc_tpu_torch_kernels_")
        emit("compile", f"compile cache disabled: cannot create {d}: {e}; "
             f"this process builds its kernels in {own}", dir=d,
             private_dir=own)
        _build.set_build_dir(own)
        native.set_build_dir(own)
        return None
    _build.set_build_dir(d)
    native.set_build_dir(d)
    return os.path.abspath(d)
