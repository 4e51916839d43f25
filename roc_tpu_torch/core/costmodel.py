"""Per-partition cost model and the cost-balanced split search
(``roc_tpu/core/costmodel.py``), a numpy copy: the same inputs give the
same features, weights and bounds as the JAX package's
(tests/test_torch_costmodel.py).

The reference's headline idea (ROC, MLSys'20) is an online-learned cost
model that drives graph partitioning: balance the parts on predicted
time, not on raw edge counts, and refine the split as measurements come
in.  Here, as in the JAX package:

- :func:`phi_matrix`: one feature vector a part, ``φ(p) = (1, padded
  nodes, padded edges, halo-in rows, halo-out rows, degree p95, bdense
  live blocks, streamed blocks, attention edges, flat8 sub-rows)``.
  Padded counts, because every rank runs shapes padded to the largest
  part.
- :class:`PartitionCostModel`: ``cost(p) = w · φ(p)``, fit by ridge
  regression anchored at the edge-balance prior (no observation gives
  the prior exactly).  Only the slowest rank's time is observable, so
  each measured epoch time is attributed to the part the model predicts
  slowest (winner takes all).
- :func:`cost_balanced_bounds`: contiguous split points minimising
  ``max_p cost(p)`` by a binary search on the cap with greedy maximal
  packing; the greedy sweep (core/partition.py ``edge_balanced_bounds``)
  stays the floor, so the returned split is never worse under the model.

The epoch-boundary repartitioning that reads it lives in
parallel/distributed.py ``DistributedTrainer.maybe_rebalance``.  One
difference from the JAX package, in cost only: the halo counts of
:func:`partition_halo_stats` mark rows in a boolean mask instead of
sorting them (the same integers), and read each part's columns from the
global CSR when the plan holds none.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

# Feature order of every φ vector (the JAX package's).  ``stream_blocks``
# is 0 on the partitioned trainer (features='host' is single-device);
# ``attn_edges`` charges the padded edges again for attention models (the
# per-edge softmax pass), ``flat8_chunks`` the flat layouts' 8-wide
# sub-rows.
PHI = ("intercept", "padded_nodes", "padded_edges", "halo_in",
       "halo_out", "deg_p95", "bd_blocks", "stream_blocks",
       "attn_edges", "flat8_chunks")

# Fixed per-feature scales for the ridge solve's conditioning (not
# data-derived, so every process builds the same model).
_SCALE = np.array([1.0, 1e4, 1e5, 1e3, 1e3, 1e2, 1e2, 1e2, 1e5, 1e4])

# The cold-start prior, raw units (ms per node, per edge, ...): padded
# edge balance with a small padded-node tiebreak; attention's softmax
# pass at half the edge rate; a flat8 sub-row's fixed overhead.  It is
# the ridge anchor too, so its magnitudes are realistic, not only its
# direction.
_PRIOR_RAW = np.zeros(len(PHI))
_PRIOR_RAW[PHI.index("padded_nodes")] = 2.5e-6
_PRIOR_RAW[PHI.index("padded_edges")] = 1e-5
_PRIOR_RAW[PHI.index("attn_edges")] = 5e-6
_PRIOR_RAW[PHI.index("flat8_chunks")] = 2e-5


def _ceil_mult(x, m: int):
    """Round up to a multiple of ``m`` (elementwise)."""
    return -(-x // m) * m if m > 1 else x


class PartitionCostModel:
    """Online ridge regression ``t ≈ w · φ`` anchored at a prior: ``w =
    (λI + Φ'Φ)^-1 (λ w0 + Φ' t)``.  With no observation the weights are
    the prior; each :meth:`observe` pulls them toward the measured
    times.  The state is a d×d normal matrix and a d-vector."""

    def __init__(self, node_multiple: int = 8, edge_multiple: int = 128,
                 lam: float = 1.0):
        d = len(PHI)
        self.node_multiple = int(node_multiple)
        self.edge_multiple = int(edge_multiple)
        self._lam = float(lam)
        self._w0 = _PRIOR_RAW * _SCALE          # prior in scaled space
        self._A = lam * np.eye(d)
        self._b = lam * self._w0
        self.n_obs = 0

    def observe(self, phi_raw: np.ndarray, t_ms: float) -> None:
        """Fold one (raw φ vector, measured ms) pair into the normal
        equations."""
        x = np.asarray(phi_raw, dtype=np.float64) / _SCALE
        self._A += np.outer(x, x)
        self._b += x * float(t_ms)
        self.n_obs += 1

    def weights_raw(self) -> np.ndarray:
        """The fitted weights in raw units."""
        return np.linalg.solve(self._A, self._b) / _SCALE

    def predict(self, phi_mat_raw: np.ndarray) -> np.ndarray:
        """Predicted ms a part for a raw ``[P, d]`` φ matrix."""
        return np.asarray(phi_mat_raw, dtype=np.float64) @ \
            self.weights_raw()

    def search_weights(self, attn_edges: bool = False,
                       flat8: bool = False) -> Tuple[float, float]:
        """``(w_nodes, w_edges)`` for the split search: the fitted weights
        of the prefix-summable features clamped at 0 (the packing needs
        monotone range costs), with the attention and flat8 columns
        folded into the edge rate for workloads that run them
        (``flat8_chunks`` is per 8 edges).  A degenerate fit (both 0)
        falls back to the prior."""
        w = self.weights_raw()
        wn = max(float(w[PHI.index("padded_nodes")]), 0.0)
        we = max(float(w[PHI.index("padded_edges")]), 0.0)
        if attn_edges:
            we += max(float(w[PHI.index("attn_edges")]), 0.0)
        if flat8:
            we += max(float(w[PHI.index("flat8_chunks")]), 0.0) / 8.0
        if wn + we <= 0.0:
            wn = _PRIOR_RAW[PHI.index("padded_nodes")]
            we = _PRIOR_RAW[PHI.index("padded_edges")]
            if attn_edges:
                we += _PRIOR_RAW[PHI.index("attn_edges")]
            if flat8:
                we += _PRIOR_RAW[PHI.index("flat8_chunks")] / 8.0
        return wn, we


# ------------------------------------------------------------ split search


def range_cost(row_ptr: np.ndarray, l: int, r1: int,
               w_nodes: float, w_edges: float,
               node_multiple: int, edge_multiple: int) -> float:
    """Modeled cost of the half-open vertex range ``[l, r1)``: ``w_n *
    pad(nodes) + w_e * pad(edges)``, both counts rounded up to the
    padding multiples (the shapes a rank would hold)."""
    n = _ceil_mult(int(r1 - l), node_multiple)
    e = _ceil_mult(int(row_ptr[r1] - row_ptr[l]), edge_multiple)
    return float(w_nodes * n + w_edges * e)


def bounds_max_cost(row_ptr: np.ndarray,
                    bounds: Sequence[Tuple[int, int]],
                    w_nodes: float, w_edges: float,
                    node_multiple: int, edge_multiple: int) -> float:
    """``max_p cost(p)`` of an inclusive-bounds split under the model."""
    row_ptr = np.asarray(row_ptr, dtype=np.int64)
    return max(range_cost(row_ptr, l, r + 1, w_nodes, w_edges,
                          node_multiple, edge_multiple)
               for l, r in bounds if r >= l)


def _pack(row_ptr: np.ndarray, num_nodes: int, num_parts: int,
          cap: float, w_nodes: float, w_edges: float,
          node_multiple: int, edge_multiple: int
          ) -> Optional[List[Tuple[int, int]]]:
    """Greedy maximal packing under ``cap``: each part takes the longest
    prefix whose cost stays within it.  Inclusive bounds, empty ranges
    only in the tail; None when infeasible."""
    bounds: List[Tuple[int, int]] = []
    l = 0
    for _ in range(num_parts):
        if l >= num_nodes:
            break
        if range_cost(row_ptr, l, l + 1, w_nodes, w_edges,
                      node_multiple, edge_multiple) > cap:
            return None
        lo, hi = l + 1, num_nodes
        while lo < hi:
            mid = (lo + hi + 1) // 2
            if range_cost(row_ptr, l, mid, w_nodes, w_edges,
                          node_multiple, edge_multiple) <= cap:
                lo = mid
            else:
                hi = mid - 1
        bounds.append((l, lo - 1))
        l = lo
    if l < num_nodes:
        return None
    while len(bounds) < num_parts:
        bounds.append((num_nodes, num_nodes - 1))
    return bounds


def cost_balanced_bounds(row_ptr: np.ndarray, num_parts: int,
                         node_multiple: int = 8,
                         edge_multiple: int = 128,
                         weights: Optional[Tuple[float, float]] = None
                         ) -> List[Tuple[int, int]]:
    """The contiguous split minimising the largest quantized range cost:
    a binary search on the cap between the trivial lower bounds and the
    one-part cost, down to a quarter of the quantization step.
    ``weights`` is ``(w_nodes, w_edges)`` (:meth:`PartitionCostModel.
    search_weights`; default the prior).  The greedy sweep's bounds are
    returned where they tie or beat the search, and for degenerate
    weights."""
    from .partition import edge_balanced_bounds
    row_ptr = np.asarray(row_ptr, dtype=np.int64)
    V = row_ptr.shape[0] - 1
    E = int(row_ptr[-1])
    wn, we = weights if weights is not None else (
        _PRIOR_RAW[PHI.index("padded_nodes")],
        _PRIOR_RAW[PHI.index("padded_edges")])
    greedy = edge_balanced_bounds(row_ptr, num_parts)
    if wn <= 0 and we <= 0:
        return greedy
    if V == 0 or num_parts <= 1:
        return greedy
    max_deg = int(np.diff(row_ptr).max())
    lo = max(wn * node_multiple
             + we * _ceil_mult(max_deg, edge_multiple),
             (wn * V + we * E) / num_parts)
    hi = range_cost(row_ptr, 0, V, wn, we, node_multiple, edge_multiple)
    steps = [w * m for w, m in ((wn, node_multiple),
                                (we, edge_multiple)) if w > 0]
    tol = min(steps) / 4.0
    for _ in range(64):
        if hi - lo <= tol:
            break
        mid = (lo + hi) / 2.0
        if _pack(row_ptr, V, num_parts, mid, wn, we,
                 node_multiple, edge_multiple) is None:
            lo = mid
        else:
            hi = mid
    bounds = _pack(row_ptr, V, num_parts, hi, wn, we,
                   node_multiple, edge_multiple)
    if bounds is None:
        return greedy
    if bounds_max_cost(row_ptr, bounds, wn, we, node_multiple,
                       edge_multiple) > \
            bounds_max_cost(row_ptr, greedy, wn, we, node_multiple,
                            edge_multiple):
        return greedy
    return bounds


# --------------------------------------------------------- static features


def _part_cols(pg, p: int, col_slice: Optional[Callable]) -> np.ndarray:
    """Part ``p``'s real source ids (global): from the plan's columns, or
    ``col_slice(e0, e1)`` of the global CSR for a plan without them."""
    e = int(pg.real_edges[p])
    if col_slice is None:
        return np.asarray(pg.part_col_idx[p][:e], dtype=np.int64)
    e0, e1 = pg.edge_range(p)
    return np.asarray(col_slice(e0, e1), dtype=np.int64)


def partition_halo_stats(pg, col_slice: Optional[Callable] = None
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """``(halo_in [P], halo_out [P])``: the distinct external source rows
    each part's edges read (what the halo delivers to it), and the
    distinct rows of each part that another part reads (what it sends).
    ``col_slice`` reads the global columns for a plan without
    ``part_col_idx`` (core/partition.py ``PartitionPlan``)."""
    P = pg.num_parts
    V = pg.num_nodes
    halo_in = np.zeros(P, dtype=np.int64)
    read = np.zeros(V, dtype=bool)
    for p in range(P):
        l, r = pg.bounds[p]
        col = _part_cols(pg, p, col_slice)
        col = col[col < V]          # drop dummy sources
        outside = col[(col < l) | (col > r)] if r >= l else col
        mine = np.zeros(V, dtype=bool)
        mine[outside] = True
        halo_in[p] = int(np.count_nonzero(mine))
        read |= mine
    halo_out = np.zeros(P, dtype=np.int64)
    for p in range(P):
        l, r = pg.bounds[p]
        if r >= l:
            halo_out[p] = int(np.count_nonzero(read[l:r + 1]))
    return halo_in, halo_out


def part_halo_read(plan, p: int, col: np.ndarray) -> np.ndarray:
    """bool ``[V]``: the rows outside part ``p`` that its edges read
    (``col``: the part's global source ids, padding ``V`` included)."""
    V = plan.num_nodes
    l, r = plan.bounds[p]
    col = np.asarray(col)
    col = col[col < V]
    outside = col[(col < l) | (col > r)] if r >= l else col
    read = np.zeros(V, dtype=bool)
    read[outside] = True
    return read


def halo_stats_ranked(plan, p: int, read: np.ndarray, agree_max=None
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """:func:`partition_halo_stats` on a rank that holds part ``p``'s
    columns alone: ``read`` is its :func:`part_halo_read`, and
    ``agree_max`` (the elementwise max over the ranks, one collective of
    ``P + V`` entries; None for a world of one) joins every part's."""
    P, V = plan.num_parts, plan.num_nodes
    mine = np.zeros(P + V, dtype=np.int64)
    mine[p] = int(np.count_nonzero(read))
    mine[P:] = read
    got = mine if agree_max is None else agree_max(mine)
    halo_in = got[:P].copy()
    union = got[P:] > 0
    halo_out = np.zeros(P, dtype=np.int64)
    for q in range(P):
        l, r = plan.bounds[q]
        if r >= l:
            halo_out[q] = int(np.count_nonzero(union[l:r + 1]))
    return halo_in, halo_out


def phi_matrix(pg, bd_occupancy: Sequence[dict] = (),
               stream_blocks: int = 0, attn_edges: bool = False,
               flat8: bool = False,
               col_slice: Optional[Callable] = None,
               halo: Optional[Tuple[np.ndarray, np.ndarray]] = None
               ) -> np.ndarray:
    """``[P, len(PHI)]`` raw feature matrix of a plan.  ``bd_occupancy``
    is each part's block-dense occupancy (``n_blocks``) where the bdense
    planner ran; ``attn_edges`` charges the padded edges a second time
    (attention models); ``flat8`` fills the flat layouts' sub-row column;
    ``col_slice`` as in :func:`partition_halo_stats`; ``halo`` its
    result, given (:func:`halo_stats_ranked`), in place of the pass."""
    P = pg.num_parts
    nm = getattr(pg, "node_multiple", 8)
    em = getattr(pg, "edge_multiple", 128)
    real_n = np.asarray(pg.real_nodes, dtype=np.int64)
    real_e = np.asarray(pg.real_edges, dtype=np.int64)
    halo_in, halo_out = halo if halo is not None else \
        partition_halo_stats(pg, col_slice=col_slice)
    p95 = np.zeros(P)
    for p in range(P):
        n = int(real_n[p])
        if n:
            p95[p] = float(np.percentile(pg.part_in_degree[p, :n], 95))
    bd = np.zeros(P)
    for p, occ in enumerate(bd_occupancy):
        if p < P:
            bd[p] = float(occ.get("n_blocks", 0))
    padded_e = _ceil_mult(real_e, em).astype(np.float64)
    return np.stack([
        np.ones(P),
        _ceil_mult(real_n, nm).astype(np.float64),
        padded_e,
        halo_in.astype(np.float64),
        halo_out.astype(np.float64),
        p95,
        bd,
        np.full(P, float(stream_blocks)),
        padded_e if attn_edges else np.zeros(P),
        (_ceil_mult(real_e, 8) // 8).astype(np.float64)
        if flat8 else np.zeros(P),
    ], axis=1)


def partition_static_stats(pg, bd_occupancy: Sequence[dict] = (),
                           phi: Optional[np.ndarray] = None,
                           col_slice: Optional[Callable] = None) -> dict:
    """The split's quality record: per-part real and padded nodes and
    edges, halo rows, and the max/mean imbalance ratios.  ``phi`` reuses
    a computed :func:`phi_matrix` (its halo pass is O(E))."""
    if phi is None:
        phi = phi_matrix(pg, bd_occupancy=bd_occupancy, col_slice=col_slice)
    real_e = np.asarray(pg.real_edges, dtype=np.float64)
    real_n = np.asarray(pg.real_nodes, dtype=np.float64)

    def _imb(x):
        m = float(x.mean())
        return round(float(x.max()) / m, 4) if m > 0 else 1.0

    return {
        "num_parts": int(pg.num_parts),
        "part_nodes": int(pg.part_nodes),
        "part_edges": int(pg.part_edges),
        "real_nodes": [int(x) for x in real_n],
        "real_edges": [int(x) for x in real_e],
        "padded_nodes": [int(x) for x in phi[:, PHI.index(
            "padded_nodes")]],
        "padded_edges": [int(x) for x in phi[:, PHI.index(
            "padded_edges")]],
        "halo_in": [int(x) for x in phi[:, PHI.index("halo_in")]],
        "halo_out": [int(x) for x in phi[:, PHI.index("halo_out")]],
        "edge_imbalance": _imb(real_e),
        "node_imbalance": _imb(real_n),
    }
