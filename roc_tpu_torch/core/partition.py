"""The single-device padded edge list (``roc_tpu/core/partition.py
padded_edge_list``), the input of the edge-list aggregation routes
('segment' and the CSR kernel K3, kernels/spmm.py).

A numpy copy: the same graph gives bit-equal arrays in both packages
(tests/test_torch_train.py holds them to that).  The multi-partition
planner is not ported yet.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from .graph import Graph


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def padded_edge_list(graph: Graph, multiple: int = 1024
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """``(edge_src, edge_dst)`` int32, sorted by destination and padded
    to a multiple of ``multiple``.  Padding edges use the dummy source
    ``num_nodes`` (a zero feature row, or an id the kernel skips) and the
    last destination row, so the sum is unchanged and ``edge_dst`` stays
    sorted."""
    E = graph.num_edges
    Ep = _round_up(max(E, 1), multiple)
    src = np.full(Ep, graph.num_nodes, dtype=np.int32)
    dst = np.full(Ep, graph.num_nodes - 1, dtype=np.int32)
    src[:E] = graph.col_idx
    dst[:E] = graph.edge_dst()
    return src, dst
