"""Build and load the hand-written CUDA kernels.

Every ``csrc/*.cu`` is compiled by its own ``nvcc`` process for
``sm_90a`` (all started together), and the objects are linked into one
shared library with a plain C interface, loaded with ``ctypes``.  The
library goes to ``kernels/build/`` (listed in ``.gitignore``) under a
name that carries a hash of the sources and flags, so an edited source
is rebuilt and an unchanged one is loaded as it is.  Nothing is built
when the package is imported: :func:`library` builds at first use.

The build directory is settable (:func:`set_build_dir`; the compile
cache, utils/compile_cache.py, points it at a directory shared by every
process).  A library file that exists but fails to load, or lacks an
entry point (a truncated or half-copied file), is rebuilt in place and
loaded again; a failure then raises: a kernel is never replaced by its
plain version.  The first load in a process holds a lock file in the
build directory, so processes that start together build once.

Each C entry point takes device pointers and the CUDA stream as
``void*``, launches on that stream, does not synchronise, and returns
``cudaGetLastError()``; :func:`check` turns a nonzero code into an
exception.  A kernel that takes features has one entry point per element
type, ``<name>_f32`` and ``<name>_bf16``: :func:`entry` picks it by the
tensor's dtype and refuses any other, and :func:`launched` counts a
launch in the wrapper's ``launches`` and ``launches_by_dtype`` and its
arithmetic (:func:`kernel_ops`) in the wrapper's ``ops`` and the
process's :func:`ops_launched`: the first step's FLOP count
(obs/compile_watch.py) adds it to what ``FlopCounterMode`` sees, since
a ``ctypes`` launch is no aten op.  It also records the launch's kernel instance,
``name[f32|bf16]@F/slice_cols`` (:func:`instance_name`), in a
per-process tally (:func:`instances_launched`): what a step launched, for
its program key (obs/compile_watch.py ``program_key_of``).  The plain
versions, on the CPU, record the instance they stand for apart
(:func:`instances_planned`), so a test on the CPU can hold the
program-space enumeration (analysis/programspace.py) to a route's calls.
While the port's trace records
(utils/profiling.py ``trace``, which sets :data:`trace_ranges`), a
wrapper runs its launches inside :func:`named`, so the trace names each
launch by its wrapper (K1 and K2 run one device kernel,
``row_scale_kernel``).
"""

from __future__ import annotations

import contextlib
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
DEFAULT_BUILD_DIR = os.path.join(_HERE, "build")
BUILD_DIR = DEFAULT_BUILD_DIR

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
# set when this process found a library file that did not load and
# rebuilt it
rebuilt = False


def set_build_dir(path: Optional[str] = None) -> str:
    """Build and load the library in ``path`` from now on (None: the
    default, ``kernels/build/``).  A library this process loaded already
    stays loaded; :func:`reset` drops it.  Returns the directory."""
    global BUILD_DIR
    BUILD_DIR = os.path.abspath(path) if path else DEFAULT_BUILD_DIR
    return BUILD_DIR


def reset() -> None:
    """Forget the loaded library and its entry points: the next
    :func:`library` loads (or builds) again from :data:`BUILD_DIR`."""
    global _lib
    with _lock:
        _lib = None
        _entries.clear()


def library_path() -> str:
    """Where :func:`library` looks for this checkout's library."""
    return os.path.join(BUILD_DIR, f"libroc_kernels_{_digest(sources())}.so")


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


def _elf_complete(path: str) -> bool:
    """Whether the ELF64 file at ``path`` holds every byte its headers
    name (its program segments and its section header table).  A
    truncated library is refused here, before ``dlopen``: mapping one can
    kill the process (SIGBUS on the pages past its end) instead of
    raising."""
    import struct
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        head = f.read(64)
        if len(head) < 64 or head[:4] != b"\x7fELF" or head[4] != 2:
            return False
        (phoff, shoff, _, _, phentsize, phnum, shentsize,
         shnum) = struct.unpack_from("<QQIHHHHH", head, 32)[:8]
        if shoff + shentsize * shnum > size or \
                phoff + phentsize * phnum > size:
            return False
        f.seek(phoff)
        for _ in range(phnum):
            ph = f.read(phentsize)
            if len(ph) < 56:
                return False
            p_offset, _, _, p_filesz = struct.unpack_from("<QQQQ", ph, 8)
            if p_offset + p_filesz > size:
                return False
    return True


def _load(target: str) -> ctypes.CDLL:
    if not _elf_complete(target):
        raise OSError(f"{target}: not a complete ELF shared object")
    lib = ctypes.CDLL(target)
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.roc_error_string.argtypes = (ctypes.c_int,)
    lib.roc_error_string.restype = ctypes.c_char_p
    return lib


@contextlib.contextmanager
def _file_lock(path: str):
    """An exclusive ``flock`` on ``path`` (created if need be): processes
    that load together build one at a time, and the second finds the
    first's library."""
    import fcntl
    os.makedirs(os.path.dirname(path), exist_ok=True)
    fd = os.open(path, os.O_CREAT | os.O_RDWR, 0o644)
    try:
        fcntl.flock(fd, fcntl.LOCK_EX)
        yield
    finally:
        fcntl.flock(fd, fcntl.LOCK_UN)
        os.close(fd)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if its sources changed or
    the file there does not load (then rebuilt, once; a second failure
    raises)."""
    global _lib, build_seconds, rebuilt
    with _lock:
        if _lib is not None:
            return _lib
        srcs = sources()
        # the build is what the other holders wait for
        # roc-lint: ok=blocking-under-lock
        digest = _digest(srcs)
        target = os.path.join(BUILD_DIR, f"libroc_kernels_{digest}.so")
        t0 = time.perf_counter()
        # the build is what the other holders (and processes) wait for
        # roc-lint: ok=blocking-under-lock
        with _file_lock(os.path.join(BUILD_DIR, ".lock")):
            lib = None
            if os.path.exists(target):
                try:
                    lib = _load(target)
                except (OSError, AttributeError) as e:
                    from ..obs.events import emit
                    # one event line, once a process
                    # roc-lint: ok=blocking-under-lock
                    emit("compile", f"kernel library {target} does not "
                         f"load ({type(e).__name__}: {e}); rebuilding it",
                         rebuild=True, path=target, error=str(e)[:200])
                    rebuilt = True
            if lib is None:
                # the build is what the other holders wait for
                # roc-lint: ok=blocking-under-lock
                _build(srcs, target)
                lib = _load(target)
        build_seconds = time.perf_counter() - t0
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


# the wrappers whose launch is a neighbour sum (one add per edge per
# column) and those whose launch is a row scaling (one multiply per
# element; the relu's max and the mask's select are not counted)
SUM_KERNELS = ("csr_spmm", "ell_aggregate")
ROW_KERNELS = ("indegree_norm", "indegree_norm_masked", "scale_act")


def kernel_ops(name: str, rows: int, edges: int, F: int) -> int:
    """The arithmetic of one launch of kernel ``name`` on ``F`` columns:
    ``edges * F`` for a neighbour sum (K3 ``csr_spmm``, K4
    ``ell_aggregate``; ``edges`` the ids it sums), ``rows * F`` for a row
    scaling (K1 ``indegree_norm`` and its masked form, K2 ``scale_act``).
    The operation count of chip_smoke.py's bounds and of the work tally
    (:func:`launched`)."""
    if name in SUM_KERNELS:
        return int(edges) * int(F)
    if name in ROW_KERNELS:
        return int(rows) * int(F)
    raise ValueError(f"unknown kernel {name!r}; expected one of "
                     f"{SUM_KERNELS + ROW_KERNELS}")


# kernel_ops summed over every launch of this process; never reset (a
# reader takes the difference around the work it observes)
_ops_launched = 0


def ops_launched() -> int:
    """The operations of every kernel launched in this process so far."""
    return _ops_launched


def zero_launches(*wrappers) -> None:
    """Set each wrapper's launch counts to 0: ``launches`` (all dtypes),
    ``launches_by_dtype`` (``{'f32': n, 'bf16': n}``) and ``ops`` (the
    launches' :func:`kernel_ops`).  :func:`ops_launched` and the
    instance tallies are not reset."""
    for fn in wrappers:
        fn.launches = 0
        fn.launches_by_dtype = {s: 0 for s in DTYPE_SUFFIX.values()}
        fn.ops = 0


def instance_name(kernel: str, dtype: Optional[torch.dtype] = None,
                  F: int = 0, slice_cols: int = 0) -> str:
    """One kernel instance: ``name[f32|bf16]@F/slice_cols`` for the sums
    (K3, K4), ``name[f32|bf16]@F`` for the row scalings (K1, its masked
    form, K2), ``name`` for a kernel without features (K3's row-pointer
    pre-pass)."""
    if dtype is None:
        return kernel
    tail = f"/{int(slice_cols)}" if kernel in SUM_KERNELS else ""
    return f"{kernel}[{DTYPE_SUFFIX[dtype]}]@{int(F)}{tail}"


# kernel instance -> launches in this process (never reset: a reader
# takes the difference around the work it observes), and the plain
# versions' stand-ins on the CPU
_instances: Dict[str, int] = {}
_planned: Dict[str, int] = {}


def instances_launched() -> Dict[str, int]:
    """``{instance: launches}`` of every kernel launched in this process
    so far (:func:`instance_name`)."""
    return dict(_instances)


def instances_planned() -> Dict[str, int]:
    """``{instance: calls}`` the plain versions took in this process in
    the kernels' place (a tensor on the CPU)."""
    return dict(_planned)


def instances_since(before: Dict[str, int],
                    now: Optional[Dict[str, int]] = None) -> List[str]:
    """The instances whose count grew since ``before``, sorted."""
    now = _instances if now is None else now
    return sorted(k for k, n in now.items() if n > before.get(k, 0))


def note_plain(kernel: str, dtype: Optional[torch.dtype] = None,
               F: int = 0, slice_cols: int = 0) -> None:
    """Record that a plain version ran where the card would launch
    ``kernel`` (:func:`instances_planned`); counts no launch."""
    key = instance_name(kernel, dtype if dtype in DTYPE_SUFFIX else None,
                        F, slice_cols)
    _planned[key] = _planned.get(key, 0) + 1


def launched(wrapper, dtype: torch.dtype, ops: int, F: int = 0,
             slice_cols: int = 0, kernel: Optional[str] = None) -> None:
    """Count one kernel launch of ``wrapper`` on features of ``dtype``
    doing ``ops`` operations (:func:`kernel_ops`), and its instance
    ``kernel`` (default: the wrapper's name) at ``F`` columns and
    ``slice_cols`` in :func:`instances_launched`."""
    global _ops_launched
    wrapper.launches += 1
    wrapper.launches_by_dtype[DTYPE_SUFFIX[dtype]] += 1
    wrapper.ops += ops
    _ops_launched += ops
    key = instance_name(kernel or wrapper.__name__, dtype, F, slice_cols)
    _instances[key] = _instances.get(key, 0) + 1


def launched_featureless(kernel: str) -> None:
    """Record one launch of a kernel without features (K3's row-pointer
    pre-pass) in :func:`instances_launched`."""
    _instances[kernel] = _instances.get(kernel, 0) + 1


# set by the step recorder (analysis/_dispatch.py) while it records: a
# kernel region's end hands it the region (analysis/step_trace.py)
region_sink = None
_tls = threading.local()


def in_region() -> bool:
    """Whether this thread runs inside a :func:`kernel_region`."""
    return getattr(_tls, "depth", 0) > 0


class KernelRegion:
    """One call of a kernel wrapper (:func:`kernel_region`).  It owns the
    call's tally: :meth:`launch` counts each launch (:func:`launched`,
    or :func:`launched_featureless` for a kernel without features); a
    call whose first input lies on the CPU counts, at its end, one call
    of the plain version (:func:`note_plain`).  While the step recorder
    records, the region's end hands it one entry: the instance, the
    region's inputs, the ``out`` the wrapper sets (a tensor, or
    ``(shape, dtype, device)`` for an output its plain version does not
    build) and the launches (1 for a plain call).  A region left by an
    exception counts no plain call and records nothing."""

    __slots__ = ("wrapper", "kernel", "inputs", "dtype", "F", "slice_cols",
                 "out", "launches")

    def __init__(self, wrapper, kernel, inputs, dtype, F, slice_cols):
        self.wrapper, self.kernel, self.inputs = wrapper, kernel, inputs
        self.dtype = dtype if dtype in DTYPE_SUFFIX else None
        self.F, self.slice_cols = F, slice_cols
        self.out = None
        self.launches = 0

    def launch(self, ops: int = 0) -> None:
        """Count one launch of the region's kernel doing ``ops``
        operations (:func:`kernel_ops`)."""
        if self.dtype is None:
            self.wrapper.launches += 1
            launched_featureless(self.kernel)
        else:
            launched(self.wrapper, self.dtype, ops, self.F,
                     self.slice_cols, kernel=self.kernel)
        self.launches += 1

    def __enter__(self):
        _tls.depth = getattr(_tls, "depth", 0) + 1
        return self

    def __exit__(self, kind, *exc):
        _tls.depth -= 1
        if kind is None:
            n = self.launches
            if self.inputs[0].device.type == "cpu":
                note_plain(self.kernel, self.dtype, self.F, self.slice_cols)
                n = 1
            sink = region_sink
            if sink is not None:
                sink(instance_name(self.kernel, self.dtype, self.F,
                                   self.slice_cols), self.inputs, self.out,
                     n)
        self.inputs = self.out = None
        return False


def kernel_region(wrapper, inputs, dtype: Optional[torch.dtype] = None,
                  F: int = 0, slice_cols: int = 0,
                  kernel: Optional[str] = None) -> KernelRegion:
    """The region of one call of kernel ``kernel`` (default: the
    wrapper's name), entered by its wrapper around both its plain
    version and its launch: the one place the wrapper names its
    instance (:func:`instance_name` of ``kernel``, ``dtype``, ``F``,
    ``slice_cols``).  ``inputs``: the tensors the call reads, its
    features (or, for a kernel without features, its index array)
    first.  While the step recorder records (analysis/step_trace.py),
    what runs inside is one opaque entry."""
    return KernelRegion(wrapper, kernel or wrapper.__name__, inputs, dtype,
                        F, slice_cols)


_NOT_TRACED = contextlib.nullcontext()
# set by utils/profiling.py ``trace`` while it records; other profiler
# sessions (a kernel's device time summed by name) get no ranges, whose
# device spans would count the kernels' time twice
trace_ranges = False


def named(name: str):
    """``record_function('roc_<name>')`` while :data:`trace_ranges` is
    set, else a no-op (one flag read on the launch path)."""
    if trace_ranges:
        return torch.profiler.record_function(f"roc_{name}")
    return _NOT_TRACED
