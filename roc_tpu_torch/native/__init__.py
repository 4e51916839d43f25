"""The port's native host library, in C++, loaded with ctypes: the
planners of the large-graph layouts (``rocplan.cc``: the sectioned sub-row
tables of core/ell.py, the block-dense tile census and fill of
ops/blockdense.py, the label-propagation sweep of core/reorder.py) and the
loaders of the data layer (``rocload.cc``: the ``.lux`` reader and writer,
the CSV feature parser, whole and by rows, the mask parser, the
edge-balanced split of core/partition.py, self-edge insertion and the ELL
bucket widths of core/ell.py).  They are the port's copy of the JAX
package's ``native/rocio.cc`` passes; the port neither builds nor loads
that library (nor reads its ``ROC_TPU_NATIVE`` variable): this one is
loaded by its path alone.

At first use :func:`available` builds both sources with ``g++`` into one
library in ``native/build/`` (listed in ``.gitignore``) under a name that
carries a hash of the sources and flags, so an edited source is rebuilt
(:func:`set_build_dir` moves the directory); the build
writes a temporary file and renames it, so processes that build at once
never load a half-written library.  A library whose ABI version differs
from :data:`ABI_VERSION` is refused.  When no library can be built or
loaded, :func:`available` is False, a ``resolve`` event says why, and
every caller takes its numpy path, which gives the same tables.

``calls`` counts the calls of each entry point, so a caller can show
that the native path ran.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Dict, Optional, Tuple

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCES = (os.path.join(_HERE, "rocplan.cc"),
           os.path.join(_HERE, "rocload.cc"))
DEFAULT_BUILD_DIR = os.path.join(_HERE, "build")
BUILD_DIR = DEFAULT_BUILD_DIR
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-Wextra", "-shared")
ABI_VERSION = 2
# the loaders' error codes (rocload.cc): -1 open, -2 read, -3 format,
# -4 value
_IO_ERRORS = (-1, -2)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False
calls: Dict[str, int] = {}


def set_build_dir(path: Optional[str] = None) -> str:
    """Build and load the library in ``path`` from now on (None: the
    default, ``native/build/``; the compile cache, utils/compile_cache.py,
    sets it).  A library this process loaded already stays loaded.
    Returns the directory."""
    global BUILD_DIR
    BUILD_DIR = os.path.abspath(path) if path else DEFAULT_BUILD_DIR
    return BUILD_DIR


def _i64p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _i32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _target() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for src in SOURCES:
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"librocplan_{h.hexdigest()[:16]}.so")


def _build(target: str) -> None:
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise OSError("no C++ compiler (g++) on PATH")
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        res = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, *SOURCES],
                             capture_output=True, text=True, timeout=300)
        if res.returncode != 0:
            raise OSError(f"g++ failed: {res.stderr[-2000:]}")
        os.replace(tmp, target)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _declare(lib: ctypes.CDLL) -> None:
    c = ctypes
    i64, i32p, i64p = c.c_int64, c.POINTER(c.c_int32), c.POINTER(c.c_int64)
    u8p, f32p = c.POINTER(c.c_uint8), c.POINTER(c.c_float)
    for name, res, args in (
            ("roc_lux_header", c.c_int,
             [c.c_char_p, c.POINTER(c.c_uint32), c.POINTER(c.c_uint64)]),
            ("roc_lux_read", c.c_int, [c.c_char_p, i64, i64, i64p, i32p]),
            ("roc_lux_write", c.c_int, [c.c_char_p, i64, i64, i64p, i32p]),
            ("roc_load_features_csv", c.c_int, [c.c_char_p, f32p, i64, i64]),
            ("roc_load_features_csv_rows", c.c_int,
             [c.c_char_p, f32p, i64, i64, i64]),
            ("roc_load_mask", c.c_int, [c.c_char_p, i32p, i64]),
            ("roc_edge_balanced_bounds", c.c_int, [i64p, i64, i64, i64p]),
            ("roc_add_self_edges", c.c_int64,
             [i64p, i32p, i64, i64p, i32p, i64]),
            ("roc_ell_widths", c.c_int, [i64p, i64, c.c_int32, i32p]),
            ("roc_sectioned_counts", c.c_int,
             [i64p, i32p, i64, i64, i64, i64, i64p]),
            ("roc_sectioned_fill", c.c_int,
             [i64p, i32p, i64, i64, i64, i64, i64p, i64p, i32p, i32p]),
            ("roc_block_counts", c.c_int64,
             [i64p, i32p, i64, i64, i64, i64p, i64p, i64]),
            ("roc_block_fill", c.c_int64,
             [i64p, i32p, i64, i64, i64, i64p, i64, u8p, i64p, i32p, i64]),
            ("roc_lpa_iterate", c.c_int64, [i64p, i32p, i64, i32p, i32p])):
        fn = getattr(lib, name)
        fn.restype = res
        fn.argtypes = args


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        from ..obs.events import emit
        # the build is what the other holders wait for
        # roc-lint: ok=blocking-under-lock
        target = _target()
        try:
            if not os.path.exists(target):
                # the build is what the other holders wait for
                # roc-lint: ok=blocking-under-lock
                _build(target)
            lib = ctypes.CDLL(target)
            lib.roc_abi_version.restype = ctypes.c_int
            got = int(lib.roc_abi_version())
        except (OSError, AttributeError, subprocess.SubprocessError) as e:
            # one event line, once a process
            # roc-lint: ok=blocking-under-lock
            emit("resolve", f"native host library unavailable ({e}); the "
                 "layouts are planned and the files read by their numpy "
                 "paths",
                 native=False, reason=str(e)[:300])
            return None
        if got != ABI_VERSION:
            # one event line, once a process
            # roc-lint: ok=blocking-under-lock
            emit("resolve", f"{target}: ABI v{got} != expected "
                 f"v{ABI_VERSION}; planning with numpy", native=False,
                 abi_got=got, abi_expected=ABI_VERSION)
            return None
        _declare(lib)
        _lib = lib
        return lib


def available() -> bool:
    """True when the native library is built and loaded (built at the
    first call)."""
    return _load() is not None


def _lib_for(name: str) -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError("the native host library is not available")
    calls[name] = calls.get(name, 0) + 1
    return lib


def _csr(row_ptr, col_idx) -> Tuple[np.ndarray, np.ndarray]:
    return (np.ascontiguousarray(row_ptr, dtype=np.int64),
            np.ascontiguousarray(col_idx, dtype=np.int32))


def sectioned_counts(row_ptr: np.ndarray, col_idx: np.ndarray,
                     num_rows: int, section_rows: int, n_sec: int,
                     sub_w: int = 8) -> np.ndarray:
    """Per-section width-``sub_w`` sub-row totals (the counts pass)."""
    lib = _lib_for("sectioned_counts")
    row_ptr, col_idx = _csr(row_ptr, col_idx)
    out = np.empty(n_sec, dtype=np.int64)
    rc = lib.roc_sectioned_counts(_i64p(row_ptr), _i32p(col_idx), num_rows,
                                  section_rows, n_sec, sub_w, _i64p(out))
    if rc != 0:
        raise ValueError(f"roc_sectioned_counts failed: {rc}")
    return out


def sectioned_fill(row_ptr: np.ndarray, col_idx: np.ndarray,
                   num_rows: int, section_rows: int, sec_sizes: np.ndarray,
                   slots: np.ndarray, sub_w: int = 8
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """The fill pass: ``(idx_flat [sum(slots), sub_w], sub_dst_flat
    [sum(slots)])``, the sections' regions consecutive in section
    order."""
    lib = _lib_for("sectioned_fill")
    row_ptr, col_idx = _csr(row_ptr, col_idx)
    sec_sizes = np.ascontiguousarray(sec_sizes, dtype=np.int64)
    slots = np.ascontiguousarray(slots, dtype=np.int64)
    total = int(slots.sum())
    idx_flat = np.empty((total, sub_w), dtype=np.int32)
    sub_dst = np.empty(total, dtype=np.int32)
    rc = lib.roc_sectioned_fill(
        _i64p(row_ptr), _i32p(col_idx), num_rows, section_rows,
        slots.shape[0], sub_w, _i64p(sec_sizes), _i64p(slots),
        _i32p(idx_flat), _i32p(sub_dst))
    if rc != 0:
        raise ValueError(f"roc_sectioned_fill failed: {rc}")
    return idx_flat, sub_dst


def block_counts(row_ptr: np.ndarray, col_idx: np.ndarray, num_rows: int,
                 block: int, num_cols: Optional[int] = None
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """``(keys, counts)`` of every occupied ``[block, block]`` tile, keys
    ascending (``key = dst_tile * n_src_tiles + src_tile``)."""
    lib = _lib_for("block_counts")
    if num_cols is None:
        num_cols = num_rows
    row_ptr, col_idx = _csr(row_ptr, col_idx)
    n_tiles = -(-num_rows // block)
    n_src_tiles = -(-num_cols // block)
    cap = max(1, int(min(n_tiles * n_src_tiles, col_idx.shape[0], 1 << 27)))
    while True:
        keys = np.empty(cap, dtype=np.int64)
        counts = np.empty(cap, dtype=np.int64)
        nnz = int(lib.roc_block_counts(
            _i64p(row_ptr), _i32p(col_idx), num_rows, num_cols, block,
            _i64p(keys), _i64p(counts), cap))
        if nnz < 0:
            raise ValueError(f"roc_block_counts failed: {nnz}")
        if nnz <= cap:
            return keys[:nnz].copy(), counts[:nnz].copy()
        cap = nnz


def block_fill(row_ptr: np.ndarray, col_idx: np.ndarray, num_rows: int,
               block: int, dense_keys: np.ndarray,
               num_cols: Optional[int] = None
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``(a_blocks uint8 [nblk, block, block], res_row_ptr, res_col)``:
    the selected tiles' multiplicities (saturating at 255, the excess to
    the residual) and the residual dst-major CSR of every other edge."""
    lib = _lib_for("block_fill")
    if num_cols is None:
        num_cols = num_rows
    row_ptr, col_idx = _csr(row_ptr, col_idx)
    dense_keys = np.ascontiguousarray(dense_keys, dtype=np.int64)
    nblk = dense_keys.shape[0]
    a = np.zeros((nblk, block, block), dtype=np.uint8)
    res_ptr = np.empty(num_rows + 1, dtype=np.int64)
    res_col = np.empty(col_idx.shape[0], dtype=np.int32)
    rc = int(lib.roc_block_fill(
        _i64p(row_ptr), _i32p(col_idx), num_rows, num_cols, block,
        _i64p(dense_keys), nblk,
        a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        _i64p(res_ptr), _i32p(res_col), res_col.shape[0]))
    if rc < 0:
        raise ValueError(f"roc_block_fill failed: {rc}")
    return a, res_ptr, res_col[:rc].copy()


def lpa_iterate(nbr_ptr: np.ndarray, nbr: np.ndarray, labels: np.ndarray
                ) -> Tuple[np.ndarray, int]:
    """One asynchronous label-propagation sweep in increasing vertex
    order: ``(new_labels, changed)``."""
    lib = _lib_for("lpa_iterate")
    nbr_ptr, nbr = _csr(nbr_ptr, nbr)
    labels = np.ascontiguousarray(labels, dtype=np.int32)
    out = np.empty_like(labels)
    rc = int(lib.roc_lpa_iterate(_i64p(nbr_ptr), _i32p(nbr),
                                 labels.shape[0], _i32p(labels), _i32p(out)))
    if rc < 0:
        raise ValueError(f"roc_lpa_iterate failed: {rc}")
    return out, rc


# ---------------------------------------------------------------- loaders


def _check_io(rc: int, what: str) -> None:
    """A loader's return code as the numpy path's exception: IOError for
    a file that cannot be opened or read, ValueError for a malformed
    one."""
    if rc in _IO_ERRORS:
        raise IOError(f"{what} failed: {rc}")
    if rc != 0:
        raise ValueError(f"{what} failed: malformed file ({rc})")


def lux_header(path: str) -> Tuple[int, int]:
    """``(num_nodes, num_edges)`` of a ``.lux`` file."""
    lib = _lib_for("lux_header")
    nn, ne = ctypes.c_uint32(), ctypes.c_uint64()
    _check_io(lib.roc_lux_header(path.encode(), ctypes.byref(nn),
                                 ctypes.byref(ne)), f"roc_lux_header({path})")
    return int(nn.value), int(ne.value)


def load_lux(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """``(row_ptr int64 [V+1], col_idx int32 [E])`` of a ``.lux`` file,
    its offsets checked monotone and ending at E, its ids below V."""
    V, E = lux_header(path)
    lib = _lib_for("load_lux")
    row_ptr = np.empty(V + 1, dtype=np.int64)
    col_idx = np.empty(E, dtype=np.int32)
    _check_io(lib.roc_lux_read(path.encode(), V, E, _i64p(row_ptr),
                               _i32p(col_idx)), f"roc_lux_read({path})")
    return row_ptr, col_idx


def save_lux(path: str, row_ptr: np.ndarray, col_idx: np.ndarray) -> None:
    """Write a ``.lux`` file (the inverse of :func:`load_lux`)."""
    lib = _lib_for("save_lux")
    row_ptr, col_idx = _csr(row_ptr, col_idx)
    _check_io(lib.roc_lux_write(path.encode(), row_ptr.shape[0] - 1,
                                col_idx.shape[0], _i64p(row_ptr),
                                _i32p(col_idx)), f"roc_lux_write({path})")


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def load_features_csv(path: str, rows: int, cols: int) -> np.ndarray:
    """float32 ``[rows, cols]`` from a CSV of exactly that many values."""
    lib = _lib_for("load_features_csv")
    out = np.empty((rows, cols), dtype=np.float32)
    _check_io(lib.roc_load_features_csv(path.encode(), _f32p(out), rows,
                                        cols),
              f"roc_load_features_csv({path})")
    return out


def load_features_csv_rows(path: str, row_lo: int, row_hi: int,
                           cols: int) -> np.ndarray:
    """Rows ``[row_lo, row_hi)`` of a CSV feature file: the first
    ``row_lo`` lines are skipped by counting newlines, unparsed."""
    lib = _lib_for("load_features_csv_rows")
    out = np.empty((row_hi - row_lo, cols), dtype=np.float32)
    _check_io(lib.roc_load_features_csv_rows(path.encode(), _f32p(out),
                                             row_lo, row_hi, cols),
              f"roc_load_features_csv_rows({path})")
    return out


def load_mask(path: str, n: int) -> np.ndarray:
    """int32 ``[n]`` MASK_* values from the first ``n`` lines of a
    ``.mask`` file."""
    lib = _lib_for("load_mask")
    out = np.empty(n, dtype=np.int32)
    _check_io(lib.roc_load_mask(path.encode(), _i32p(out), n),
              f"roc_load_mask({path})")
    return out


def edge_balanced_bounds(row_ptr: np.ndarray, num_parts: int) -> np.ndarray:
    """The greedy edge sweep: int64 ``[num_parts, 2]`` inclusive ranges,
    empty tail ranges ``(V, V - 1)``."""
    lib = _lib_for("edge_balanced_bounds")
    row_ptr = np.ascontiguousarray(row_ptr, dtype=np.int64)
    bounds = np.empty((num_parts, 2), dtype=np.int64)
    rc = lib.roc_edge_balanced_bounds(_i64p(row_ptr), row_ptr.shape[0] - 1,
                                      num_parts, _i64p(bounds))
    if rc != 0:
        raise ValueError(f"roc_edge_balanced_bounds failed: {rc}")
    return bounds


def add_self_edges(row_ptr: np.ndarray, col_idx: np.ndarray
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """The CSR with a self edge appended to every row that has none."""
    lib = _lib_for("add_self_edges")
    row_ptr, col_idx = _csr(row_ptr, col_idx)
    V = row_ptr.shape[0] - 1
    cap = col_idx.shape[0] + V
    new_ptr = np.empty(V + 1, dtype=np.int64)
    new_col = np.empty(cap, dtype=np.int32)
    rc = int(lib.roc_add_self_edges(_i64p(row_ptr), _i32p(col_idx), V,
                                    _i64p(new_ptr), _i32p(new_col), cap))
    if rc < 0:
        raise ValueError(f"roc_add_self_edges failed: {rc}")
    return new_ptr, new_col[:col_idx.shape[0] + rc].copy()


def ell_widths(row_ptr: np.ndarray, min_width: int = 8) -> np.ndarray:
    """Per-row power-of-two ELL bucket width (floored at ``min_width``;
    0 for an empty row), int32."""
    lib = _lib_for("ell_widths")
    row_ptr = np.ascontiguousarray(row_ptr, dtype=np.int64)
    n = row_ptr.shape[0] - 1
    out = np.empty(n, dtype=np.int32)
    rc = lib.roc_ell_widths(_i64p(row_ptr), n, min_width, _i32p(out))
    if rc != 0:
        raise ValueError(f"roc_ell_widths failed: {rc}")
    return out
