"""Degree-bucketed ELLPACK tables for the neighbour-sum aggregation.

A numpy copy of the subset of ``roc_tpu/core/ell.py`` this package
needs; the tables are bit-equal to the JAX package's for the same graph
(tests/test_torch_data.py).

- every row is assigned to a power-of-two **width bucket** covering its
  in-degree (min width 8; a hub row of any degree gets its own wide
  bucket);
- each bucket stores a dense ``[rows, width]`` matrix of source ids;
  padding entries hold the dummy id (== the gathered row count);
- ``row_pos`` maps every output row to its slot in the concatenated
  bucket outputs (degree-0 rows point at the trailing zero slot), and
  ``row_id`` is the forward map from each bucket row to its output row
  (padding bucket rows carry ``part_nodes``).  The plain sum
  (ops/aggregate.py) reads ``row_pos``; the CUDA kernel
  (kernels/ell_spmm.py) writes each bucket row straight to its
  ``row_id``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple

import numpy as np


@dataclass
class EllTable:
    """Stacked per-partition ELL tables with uniform shapes.

    widths: bucket widths (powers of two, ascending).
    idx: one int32 ``[P, rows_b, width_b]`` array per bucket.
    row_pos: int32 ``[P, part_nodes]`` slot of each row in the
      concatenated bucket output (zero slot == total bucket rows).
    row_id: one int32 ``[P, rows_b]`` array per bucket, the output row
      of each bucket row (padding == ``part_nodes``).
    """

    widths: Tuple[int, ...]
    idx: Tuple[np.ndarray, ...]
    row_pos: np.ndarray
    row_id: Tuple[np.ndarray, ...] = ()

    @property
    def num_parts(self) -> int:
        return self.row_pos.shape[0]


def row_widths(deg: np.ndarray, min_width: int) -> np.ndarray:
    """Per-row bucket width: the smallest power of two >= degree
    (floored at ``min_width``); 0 for empty rows.  Exact integer
    comparisons against a power table, no float log2."""
    deg = np.asarray(deg)
    max_d = int(deg.max()) if deg.size else 1
    powers = [min_width]
    while powers[-1] < max_d:
        powers.append(powers[-1] * 2)
    powers = np.array(powers, dtype=np.int64)
    w = powers[np.searchsorted(powers, deg, side="left")]
    return np.where(deg > 0, w, 0).astype(np.int64)


def build_ell(local_row_ptr: np.ndarray, col_idx: np.ndarray,
              min_width: int = 8) -> dict:
    """One partition's buckets from a local CSR: ``{width: (rows,
    idx)}`` with int64 row ids and int32 ``[R_w, w]`` source ids (-1
    padding, replaced by the dummy id in :func:`stack_ell`)."""
    row_ptr = np.asarray(local_row_ptr, dtype=np.int64)
    deg = np.diff(row_ptr)
    widths = row_widths(deg, min_width)
    buckets: dict = {}
    for w in np.unique(widths[widths > 0]):
        w = int(w)
        rows = np.flatnonzero(widths == w)
        grid = np.arange(w, dtype=np.int64)[None, :]
        valid = grid < deg[rows][:, None]
        flat = row_ptr[rows][:, None] + grid
        idx = np.full((rows.shape[0], w), -1, dtype=np.int32)
        idx[valid] = col_idx[flat[valid]]
        buckets[w] = (rows, idx)
    return buckets


def _place_part(buckets: dict, widths: Tuple[int, ...],
                rows_per_width: dict, part_nodes: int,
                dummy: int) -> Tuple[list, np.ndarray, list]:
    """One partition's buckets placed into the uniform shapes:
    ``(idx_arrays, row_pos, row_id_arrays)``."""
    idx_arrays = []
    rid_arrays = []
    total_rows = sum(rows_per_width[w] for w in widths)
    row_pos = np.full(part_nodes, total_rows, dtype=np.int32)
    offset = 0
    for w in widths:
        R = rows_per_width[w]
        arr = np.full((R, w), dummy, dtype=np.int32)
        rid = np.full(R, part_nodes, dtype=np.int32)
        if w in buckets:
            rows, idx = buckets[w]
            n = rows.shape[0]
            arr[:n] = np.where(idx >= 0, idx, dummy)
            rid[:n] = rows
            row_pos[rows] = offset + np.arange(n, dtype=np.int32)
        idx_arrays.append(arr)
        rid_arrays.append(rid)
        offset += R
    return idx_arrays, row_pos, rid_arrays


def stack_ell(per_part_buckets: Sequence[dict], part_nodes: int,
              dummy: int) -> EllTable:
    """Unify the bucket structure across partitions and stack it into
    equal-shape arrays (at least one bucket, so shapes always exist)."""
    P = len(per_part_buckets)
    widths = sorted({w for b in per_part_buckets for w in b})
    rows_per_width = {
        w: max((b[w][0].shape[0] if w in b else 0
                for b in per_part_buckets), default=0)
        for w in widths}
    widths = tuple(w for w in widths if rows_per_width[w] > 0) or (8,)
    rows_per_width = {w: max(rows_per_width.get(w, 0), 1) for w in widths}
    per_part = [_place_part(b, widths, rows_per_width, part_nodes, dummy)
                for b in per_part_buckets]
    idx_arrays = tuple(np.stack([per_part[p][0][wi] for p in range(P)])
                       for wi in range(len(widths)))
    row_pos = np.stack([per_part[p][1] for p in range(P)])
    row_id = tuple(np.stack([per_part[p][2][wi] for p in range(P)])
                   for wi in range(len(widths)))
    return EllTable(widths=widths, idx=idx_arrays, row_pos=row_pos,
                    row_id=row_id)


def ell_from_padded_parts(part_row_ptr: np.ndarray,
                          part_col_idx: np.ndarray,
                          real_nodes: np.ndarray,
                          part_nodes: int, dummy: int,
                          min_width: int = 8) -> EllTable:
    """EllTable of a partitioned graph's local CSRs (core/partition.py),
    column ids already in gathered-row coordinates; padding rows and
    edges are left out by cutting each local CSR at its real row count.
    ``row_id`` is per part, ``[P, rows_b]``: a rank takes its own row."""
    per_part = []
    for p in range(part_row_ptr.shape[0]):
        n = int(real_nodes[p])
        ptr = part_row_ptr[p, :n + 1].astype(np.int64)
        per_part.append(build_ell(ptr, part_col_idx[p],
                                  min_width=min_width))
    return stack_ell(per_part, part_nodes, dummy)


def ell_from_graph(row_ptr: np.ndarray, col_idx: np.ndarray,
                   num_nodes: int, min_width: int = 8) -> EllTable:
    """Single-device EllTable (P == 1); dummy == ``num_nodes``."""
    b = build_ell(np.asarray(row_ptr), np.asarray(col_idx),
                  min_width=min_width)
    return stack_ell([b], num_nodes, dummy=num_nodes)
