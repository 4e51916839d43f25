"""Edge-balanced contiguous vertex-range partitioner
(``roc_tpu/core/partition.py``), and the single-device padded edge list.

A numpy copy: the same graph gives bit-equal arrays in both packages
(tests/test_torch_partition.py, tests/test_torch_train.py).

The reference's greedy sweep (``gnn.cc:806-829``) walks the vertices in
order, adding up in-edges, and closes a range at the vertex where the
running count passes ``cap = ceil(E / num_parts)``.  The reference asserts
that exactly ``num_parts`` ranges come out, which can fail on a skewed
graph; here a sweep that closes fewer ranges leaves empty tail parts.

On top of the ranges come *padded, equal-sized* parts, so every rank
holds the same shapes: node rows pad to the largest part rounded up to
``node_multiple``, edges to the largest edge count rounded up to
``edge_multiple``.  Padding edges read a dummy source (global id ``V``,
``P * part_nodes`` in gathered coordinates, a row that reads as zero) and
land on the part's first padded row, so they add zeros and touch no real
output row.

The sweep runs in the port's native library (native/rocload.cc) when
it is built, else vectorised in numpy; the two give the same ranges
(tests/test_torch_source.py).  Splits: the greedy one and the
cost-balanced one (``method='cost'``, core/costmodel.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

from .graph import Graph


def edge_balanced_bounds(row_ptr: np.ndarray, num_parts: int
                         ) -> List[Tuple[int, int]]:
    """Greedy edge-balanced split into ``num_parts`` contiguous inclusive
    vertex ranges ``[left, right]`` (reference ``gnn.cc:806-829``).
    Ranges may be empty (``left > right``) only in the padded tail.

    Natively when the library is built (an O(V) sweep); numpy's path
    closes a range at the first vertex whose running edge count exceeds
    the cap, i.e. at ``searchsorted(row_ptr, row_ptr[left] + cap,
    'right') - 1``: O(P log V)."""
    from .. import native
    row_ptr = np.asarray(row_ptr, dtype=np.int64)
    num_nodes = row_ptr.shape[0] - 1
    if native.available():
        return [(int(l), int(r)) for l, r in
                native.edge_balanced_bounds(row_ptr, num_parts)]
    num_edges = int(row_ptr[-1])
    cap = (num_edges + num_parts - 1) // num_parts
    bounds: List[Tuple[int, int]] = []
    left = 0
    for _ in range(num_parts - 1):
        if left >= num_nodes:
            break
        v1 = int(np.searchsorted(row_ptr, row_ptr[left] + cap,
                                 side="right"))
        if v1 > num_nodes:
            break  # the remaining edges fit under the cap
        bounds.append((left, v1 - 1))
        left = v1
    bounds.append((left, num_nodes - 1))
    while len(bounds) < num_parts:
        bounds.append((num_nodes, num_nodes - 1))
    return bounds


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


# The shape-quantization multiples: per-part padded node rows snap to
# NODE_MULTIPLE, padded edge slots to EDGE_MULTIPLE.
NODE_MULTIPLE = 8
EDGE_MULTIPLE = 128


def quantize_plan_shapes(real_nodes, real_edges,
                         node_multiple: int = NODE_MULTIPLE,
                         edge_multiple: int = EDGE_MULTIPLE
                         ) -> Tuple[int, int]:
    """``(part_nodes, part_edges)``, the padded per-part shapes of a plan
    over these per-part real counts.

    With the full-part padding-edge correction: a part whose real rows
    exactly fill ``part_nodes`` while it carries padding edges would hang
    them on its last REAL row, so one more row multiple is added whenever
    that happens."""
    real_nodes = np.asarray(real_nodes, dtype=np.int64)
    real_edges = np.asarray(real_edges, dtype=np.int64)
    part_nodes = _round_up(max(int(real_nodes.max()), 1), node_multiple)
    part_edges = _round_up(max(int(real_edges.max()), 1), edge_multiple)
    if any(int(real_nodes[p]) == part_nodes
           and int(real_edges[p]) < part_edges
           for p in range(real_nodes.shape[0])):
        part_nodes += node_multiple
    return part_nodes, part_edges


@dataclass
class PartitionPlan:
    """Partition metadata computable from ``row_ptr`` alone (O(V), no
    edge data).  A rank derives the whole plan and then builds only its
    own part's columns (:func:`partition_col`), as the reference's
    per-partition loader tasks do (``load_task.cu:201-245``).

    - ``part_row_ptr[p]`` is a *local* CSR over the part's padded rows,
      ``part_nodes + 1`` offsets into the part's padded edge slice.
      Padding edges attach to the first padded row (or the last real row
      when the part has no padded row), so edge destinations stay sorted.
    - ``node_offset[p]`` is the global id of the part's first row: global
      row ``g`` lives in part ``p`` at local row ``g - node_offset[p]``.
    """

    num_nodes: int
    num_edges: int
    num_parts: int
    part_nodes: int              # padded rows per part
    part_edges: int              # padded edges per part
    bounds: List[Tuple[int, int]]
    node_offset: np.ndarray      # int32 [P]
    real_nodes: np.ndarray       # int32 [P] unpadded row counts
    real_edges: np.ndarray       # int64 [P]
    part_row_ptr: np.ndarray     # int32 [P, part_nodes + 1] local offsets
    part_in_degree: np.ndarray   # int32 [P, part_nodes] real in-degrees
    node_multiple: int = NODE_MULTIPLE
    edge_multiple: int = EDGE_MULTIPLE

    @property
    def padded_num_nodes(self) -> int:
        """Rows across all parts (``part_nodes * num_parts``)."""
        return self.part_nodes * self.num_parts

    @property
    def dummy_src(self) -> int:
        """Global source id of the padding edges."""
        return self.num_nodes

    def edge_range(self, p: int) -> Tuple[int, int]:
        """Global ``[e0, e1)`` extent of part ``p``'s real edges (parts
        are contiguous vertex ranges, so their edges are consecutive in
        global CSR order)."""
        e0 = int(self.real_edges[:p].sum())
        return e0, e0 + int(self.real_edges[p])

    def local_to_global(self) -> np.ndarray:
        """int32 ``[P, part_nodes]`` global id of each padded local row;
        padding rows map to ``num_nodes``."""
        out = np.full((self.num_parts, self.part_nodes), self.num_nodes,
                      dtype=np.int32)
        for p in range(self.num_parts):
            n = int(self.real_nodes[p])
            out[p, :n] = np.arange(self.node_offset[p],
                                   self.node_offset[p] + n, dtype=np.int32)
        return out

    def global_pad_map(self) -> np.ndarray:
        """int32 ``[padded_num_nodes]``: the global id of each row of the
        concatenated padded parts (``num_nodes`` for padding rows)."""
        return self.local_to_global().reshape(-1)


@dataclass
class PartitionedGraph(PartitionPlan):
    """A :class:`PartitionPlan` with every part's columns:
    ``part_col_idx[p]`` holds *global* source ids, padding edges the
    dummy ``num_nodes``."""

    part_col_idx: np.ndarray = None  # int32 [P, part_edges] global src

    def __post_init__(self):
        if self.part_col_idx is None:
            raise TypeError(
                "PartitionedGraph requires part_col_idx "
                "(materialize_plan attaches it to a plan)")


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


def partition_bounds(row_ptr: np.ndarray, num_parts: int,
                     method: str = "greedy",
                     node_multiple: int = NODE_MULTIPLE,
                     edge_multiple: int = EDGE_MULTIPLE,
                     cost_weights=None) -> List[Tuple[int, int]]:
    """Split-point selection: the reference's greedy edge sweep
    (``method='greedy'``) or the cost-balanced minimax search
    (``method='cost'``, core/costmodel.py; ``cost_weights`` is the
    model's ``search_weights()``, by default the edge-balance prior).
    Unknown methods raise, so a typo never changes the split."""
    if method == "greedy":
        return edge_balanced_bounds(row_ptr, num_parts)
    if method == "cost":
        from .costmodel import cost_balanced_bounds
        return cost_balanced_bounds(row_ptr, num_parts,
                                    node_multiple=node_multiple,
                                    edge_multiple=edge_multiple,
                                    weights=cost_weights)
    raise ValueError(f"unknown partition method {method!r}; expected "
                     "'greedy' or 'cost'")


def partition_plan(row_ptr: np.ndarray, num_parts: int,
                   node_multiple: int = NODE_MULTIPLE,
                   edge_multiple: int = EDGE_MULTIPLE,
                   method: str = "greedy",
                   cost_weights=None) -> PartitionPlan:
    """Everything about the partitioning derivable from the global row
    pointers alone: bounds, padded shapes, local row CSRs, degrees."""
    row_ptr = np.asarray(row_ptr, dtype=np.int64)
    bounds = partition_bounds(row_ptr, num_parts, method=method,
                              node_multiple=node_multiple,
                              edge_multiple=edge_multiple,
                              cost_weights=cost_weights)
    return plan_from_bounds(row_ptr, bounds, num_parts,
                            node_multiple=node_multiple,
                            edge_multiple=edge_multiple)


def plan_from_bounds(row_ptr: np.ndarray, bounds: List[Tuple[int, int]],
                     num_parts: int, node_multiple: int = NODE_MULTIPLE,
                     edge_multiple: int = EDGE_MULTIPLE) -> PartitionPlan:
    """The plan metadata for explicit ``bounds``."""
    row_ptr = np.asarray(row_ptr, dtype=np.int64)
    V = row_ptr.shape[0] - 1
    E = int(row_ptr[-1])
    real_nodes = np.array([max(r - l + 1, 0) for l, r in bounds],
                          dtype=np.int32)
    real_edges = np.array(
        [int(row_ptr[r + 1] - row_ptr[l]) if r >= l else 0
         for l, r in bounds], dtype=np.int64)
    part_nodes, part_edges = quantize_plan_shapes(
        real_nodes, real_edges, node_multiple, edge_multiple)

    node_offset = np.array([l for l, _ in bounds], dtype=np.int32)
    node_offset = np.minimum(node_offset, V)  # empty tail parts
    part_row_ptr = np.zeros((num_parts, part_nodes + 1), dtype=np.int32)
    part_in_degree = np.zeros((num_parts, part_nodes), dtype=np.int32)
    for p, (l, r) in enumerate(bounds):
        if r < l:
            # empty part: every edge is padding, row 0 takes them all
            part_row_ptr[p, 1:] = part_edges
            continue
        n = r - l + 1
        e0 = int(row_ptr[l])
        part_row_ptr[p, :n + 1] = (row_ptr[l:r + 2] - e0).astype(np.int32)
        # padding edges follow the real ones on the first padded row (the
        # last real row when n == part_nodes); later rows have none, so
        # part_row_ptr[-1] == part_edges always
        part_row_ptr[p, min(n, part_nodes - 1) + 1:] = part_edges
        part_in_degree[p, :n] = np.diff(row_ptr[l:r + 2])
    return PartitionPlan(
        num_nodes=V, num_edges=E, num_parts=num_parts,
        part_nodes=part_nodes, part_edges=part_edges, bounds=bounds,
        node_offset=node_offset, real_nodes=real_nodes,
        real_edges=real_edges, part_row_ptr=part_row_ptr,
        part_in_degree=part_in_degree,
        node_multiple=node_multiple, edge_multiple=edge_multiple)


def partition_col(plan: PartitionPlan, col_slice, p: int) -> np.ndarray:
    """Part ``p``'s padded column array (int32 ``[part_edges]``, global
    source ids, padding == ``num_nodes``).  ``col_slice(e0, e1)`` returns
    the global ``col_idx[e0:e1]``, so a rank builds only its own part's
    O(E/P) edges (reference ``load_task.cu:201-245``)."""
    out = np.full(plan.part_edges, plan.num_nodes, dtype=np.int32)
    e0, e1 = plan.edge_range(p)
    if e1 > e0:
        out[:e1 - e0] = col_slice(e0, e1)
    return out


def partition_graph(graph: Graph, num_parts: int,
                    node_multiple: int = NODE_MULTIPLE,
                    edge_multiple: int = EDGE_MULTIPLE,
                    method: str = "greedy",
                    cost_weights=None) -> PartitionedGraph:
    """Partition ``graph`` into ``num_parts`` equal-shaped padded parts,
    every part's columns included."""
    plan = partition_plan(graph.row_ptr, num_parts,
                          node_multiple=node_multiple,
                          edge_multiple=edge_multiple,
                          method=method, cost_weights=cost_weights)
    return materialize_plan(graph, plan)


def materialize_plan(graph: Graph, plan: PartitionPlan
                     ) -> PartitionedGraph:
    """Attach every part's columns to a plan."""
    col_slice = lambda e0, e1: graph.col_idx[e0:e1]
    part_col_idx = np.stack([partition_col(plan, col_slice, p)
                             for p in range(plan.num_parts)])
    return PartitionedGraph(**vars(plan), part_col_idx=part_col_idx)
