"""The host planners of the large-graph layouts, in C++ (``rocplan.cc``),
loaded with ctypes: the sectioned sub-row tables (core/ell.py), the
block-dense tile census and fill (ops/blockdense.py) and the
label-propagation sweep (core/reorder.py).  They are the port's copy of
the JAX package's ``native/rocio.cc`` planning passes; the port neither
builds nor loads that library.

At first use :func:`available` builds ``rocplan.cc`` with ``g++`` into
``native/build/`` (listed in ``.gitignore``) under a name that carries a
hash of the source and flags, so an edited source is rebuilt; the build
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
SOURCE = os.path.join(_HERE, "rocplan.cc")
BUILD_DIR = os.path.join(_HERE, "build")
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-Wextra", "-shared")
ABI_VERSION = 1

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False
calls: Dict[str, int] = {}


def _i64p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _i32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _target() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
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
        res = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, SOURCE],
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
    u8p = c.POINTER(c.c_uint8)
    for name, res, args in (
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
        target = _target()
        try:
            if not os.path.exists(target):
                _build(target)
            lib = ctypes.CDLL(target)
            lib.roc_abi_version.restype = ctypes.c_int
            got = int(lib.roc_abi_version())
        except (OSError, AttributeError, subprocess.SubprocessError) as e:
            emit("resolve", f"native host planners unavailable ({e}); the "
                 "layouts are planned by their numpy paths",
                 native=False, reason=str(e)[:300])
            return None
        if got != ABI_VERSION:
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
        raise RuntimeError("the native host planners are not available")
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
