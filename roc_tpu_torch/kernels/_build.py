"""Build and load the hand-written CUDA kernels.

Every ``csrc/*.cu`` is compiled by its own ``nvcc`` process for
``sm_90a`` (all started together), and the objects are linked into one
shared library with a plain C interface, loaded with ``ctypes``.  The
library goes to ``kernels/build/`` (listed in ``.gitignore``) under a
name that carries a hash of the sources and flags, so an edited source
is rebuilt and an unchanged one is loaded as it is.  Nothing is built
when the package is imported: :func:`library` builds at first use.

Each C entry point takes device pointers and the CUDA stream as
``void*``, launches on that stream, does not synchronise, and returns
``cudaGetLastError()``; :func:`check` turns a nonzero code into an
exception.  A kernel that takes features has one entry point per element
type, ``<name>_f32`` and ``<name>_bf16``: :func:`entry` picks it by the
tensor's dtype and refuses any other, and :func:`launched` counts a
launch in the wrapper's ``launches`` and ``launches_by_dtype``.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong

# The element types of the feature kernels, by the suffix of their entry
# points
DTYPE_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}

# C signatures: name -> argtypes (every entry point returns an int)
SIGNATURES = {
    # edge_dst, row_ptr, num_edges, num_rows, stream
    "roc_csr_row_ptr": (_P, _P, _L, _I, _P),
}
for _sfx in DTYPE_SUFFIX.values():
    SIGNATURES.update({
        # x, in_degree, out, rows, F, stream
        f"roc_indegree_norm_{_sfx}": (_P, _P, _P, _L, _I, _P),
        # g, relu_out, in_degree, out, rows, F, stream
        f"roc_indegree_norm_masked_{_sfx}": (_P, _P, _P, _P, _L, _I, _P),
        # x, scale, out, rows, F, relu, stream
        f"roc_scale_act_{_sfx}": (_P, _P, _P, _L, _I, _I, _P),
        # feats, idx, row_id, out, rows, width, dummy, num_rows, F,
        # slice_cols, stream
        f"roc_ell_aggregate_{_sfx}": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                      _P),
        # feats, edge_src, row_ptr, out, dummy, num_rows, F, slice_cols,
        # stream
        f"roc_csr_spmm_{_sfx}": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
    })

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_entries: Dict[Tuple[str, torch.dtype], Callable[..., int]] = {}
build_log: List[str] = []
build_seconds: Optional[float] = None


def sources() -> List[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "source on a machine with the CUDA toolkit")


def _digest(srcs: List[str]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in srcs + sorted(glob.glob(os.path.join(CSRC, "*.cuh"))):
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode())
            h.update(f.read())
    return h.hexdigest()[:16]


def _build(srcs: List[str], target: str) -> None:
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        objs = []
        for src in srcs:
            obj = os.path.join(tmp, os.path.basename(src) + ".o")
            objs.append(obj)
            cmd = [nvcc, *NVCC_FLAGS, "-c", src, "-o", obj]
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for cmd, p in procs:
            out, _ = p.communicate()
            build_log.append(" ".join(cmd) + "\n" + out)
            if p.returncode != 0:
                failed.append(out)
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        lib_tmp = os.path.join(tmp, "lib.so")
        cmd = [nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a",
               *objs, "-o", lib_tmp]
        res = subprocess.run(cmd, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
        build_log.append(" ".join(cmd) + "\n" + res.stdout)
        if res.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + res.stdout)
        os.replace(lib_tmp, target)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if its sources changed."""
    global _lib, build_seconds
    with _lock:
        if _lib is not None:
            return _lib
        srcs = sources()
        target = os.path.join(BUILD_DIR,
                              f"libroc_kernels_{_digest(srcs)}.so")
        t0 = time.perf_counter()
        if not os.path.exists(target):
            _build(srcs, target)
        build_seconds = time.perf_counter() - t0
        lib = ctypes.CDLL(target)
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.roc_error_string.argtypes = (ctypes.c_int,)
        lib.roc_error_string.restype = ctypes.c_char_p
        _lib = lib
        return lib


def check(name: str, code: int) -> None:
    """Raise if a launch reported a CUDA error."""
    if code != 0:
        what = library().roc_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA error {code} at launch: {what}")


def stream_ptr(device: torch.device) -> int:
    """PyTorch's current CUDA stream on ``device``, as an int: the raw
    handle (the call PyTorch's own generated code makes), without
    building a ``torch.cuda.Stream`` object, whose host cost is several
    times this lookup's and, for a small row-scale call, comparable to
    the kernel's device time."""
    index = device.index
    if index is None:
        index = torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(index)


def entry(name: str, dtype: torch.dtype):
    """The C entry point ``roc_<name>_<f32|bf16>`` for features of
    ``dtype``, looked up once; raises TypeError for any other dtype."""
    fn = _entries.get((name, dtype))
    if fn is None:
        if dtype not in DTYPE_SUFFIX:
            raise TypeError(f"{name}: the CUDA kernel takes float32 or "
                            f"bfloat16, got {dtype}")
        fn = getattr(library(), f"roc_{name}_{DTYPE_SUFFIX[dtype]}")
        _entries[(name, dtype)] = fn
    return fn


def zero_launches(*wrappers) -> None:
    """Set each wrapper's launch counts to 0: ``launches`` (all dtypes)
    and ``launches_by_dtype`` (``{'f32': n, 'bf16': n}``)."""
    for fn in wrappers:
        fn.launches = 0
        fn.launches_by_dtype = {s: 0 for s in DTYPE_SUFFIX.values()}


def launched(wrapper, dtype: torch.dtype) -> None:
    """Count one kernel launch of ``wrapper`` on features of ``dtype``."""
    wrapper.launches += 1
    wrapper.launches_by_dtype[DTYPE_SUFFIX[dtype]] += 1
