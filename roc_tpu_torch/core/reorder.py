"""Vertex reordering for gather locality (``roc_tpu/core/reorder.py``).

A relabeling that gives each neighbourhood a narrow id range makes the
sectioned layout pad less (fewer (row, section) pairs, core/ell.py) and
packs edges into the ``[128, 128]`` tiles of the block-dense route
(ops/blockdense.py):

- :func:`bfs_order`: breadth-first relabeling from the highest in-degree
  seed of each component;
- :func:`lpa_order`: label-propagation communities, cluster-major;
- :func:`apply_vertex_order`: a whole Dataset permuted, so training on
  it is training on the original up to the relabeling.

Bit-equal to the JAX package's orders.  The label propagation's sweeps
run natively (roc_tpu_torch/native ``lpa_iterate``) when the host
planners are built; :func:`_lpa_sweep_numpy` replays the same vertex
order (tested equal).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from .graph import Dataset, Graph


def _undirected_csr(graph: Graph) -> Tuple[np.ndarray, np.ndarray]:
    """``(nbr_ptr, nbr int32)``: in-edges and reversed out-edges of every
    vertex, duplicates kept (they weigh the label vote)."""
    V = graph.num_nodes
    dst_all = np.repeat(np.arange(V, dtype=np.int32), np.diff(graph.row_ptr))
    src_all = np.asarray(graph.col_idx, dtype=np.int32)
    u = np.concatenate([src_all, dst_all])
    v = np.concatenate([dst_all, src_all])
    v = v[np.argsort(u, kind="stable")]
    nbr_ptr = np.zeros(V + 1, dtype=np.int64)
    np.cumsum(np.bincount(u, minlength=V), out=nbr_ptr[1:])
    return nbr_ptr, v


def bfs_order(graph: Graph) -> np.ndarray:
    """``perm[new_id] == old_id``: BFS over the undirected view, each
    component seeded at its highest in-degree vertex (seeds taken in
    decreasing degree), a frontier's new vertices in ascending id."""
    V = graph.num_nodes
    deg_in = np.diff(graph.row_ptr)
    nbr_ptr, v = _undirected_csr(graph)
    visited = np.zeros(V, dtype=bool)
    out = np.empty(V, dtype=np.int64)
    pos = 0
    for seed in np.argsort(-deg_in, kind="stable"):
        if visited[seed]:
            continue
        frontier = np.array([seed], dtype=np.int64)
        visited[seed] = True
        while frontier.size:
            out[pos:pos + frontier.size] = frontier
            pos += frontier.size
            starts = nbr_ptr[frontier]
            counts = nbr_ptr[frontier + 1] - starts
            total = int(counts.sum())
            if total == 0:
                break
            offs = np.arange(total, dtype=np.int64)
            row_start = np.repeat(np.cumsum(counts) - counts, counts)
            nxt = np.unique(v[np.repeat(starts, counts) + (offs - row_start)])
            nxt = nxt[~visited[nxt]]
            visited[nxt] = True
            frontier = nxt
    if pos != V:
        raise AssertionError(f"bfs_order placed {pos} of {V} vertices")
    return out


def lpa_labels(graph: Graph, max_iters: int = 16,
               tol_frac: float = 1e-3) -> np.ndarray:
    """int32 ``[V]`` community labels by asynchronous label propagation
    over the undirected view: each sweep visits the vertices in id
    order and gives each the most frequent label among its neighbours as
    already updated in the sweep (ties to the smallest label; isolated
    vertices keep theirs).  Stops when a sweep changes fewer than
    ``tol_frac * V`` labels, or after ``max_iters`` sweeps."""
    V = graph.num_nodes
    nbr_ptr, nbr = _undirected_csr(graph)
    labels = np.arange(V, dtype=np.int32)
    tol = max(1, int(tol_frac * V))
    from .. import native
    use_native = native.available()
    for _ in range(max_iters):
        if use_native:
            labels, changed = native.lpa_iterate(nbr_ptr, nbr, labels)
        else:
            labels, changed = _lpa_sweep_numpy(nbr_ptr, nbr, labels, V)
        if changed < tol:
            break
    return labels


def _lpa_sweep_numpy(nbr_ptr: np.ndarray, nbr: np.ndarray,
                     labels: np.ndarray, V: int) -> Tuple[np.ndarray, int]:
    """One asynchronous sweep in id order, the native sweep's semantics;
    a per-vertex loop, for small graphs and the tests."""
    out = labels.copy()
    for v in range(V):
        lo, hi = nbr_ptr[v], nbr_ptr[v + 1]
        if hi <= lo:
            continue
        vals, cnt = np.unique(out[nbr[lo:hi]], return_counts=True)
        out[v] = vals[np.argmax(cnt)]
    return out, int((out != labels).sum())


def lpa_order(graph: Graph, max_iters: int = 16) -> np.ndarray:
    """``perm[new_id] == old_id``: vertices grouped by their
    :func:`lpa_labels` community (ascending label), original id order
    within a community."""
    labels = lpa_labels(graph, max_iters=max_iters)
    return np.lexsort((np.arange(graph.num_nodes), labels))


# the CLI's --reorder passes
ORDERINGS = {"bfs": bfs_order, "lpa": lpa_order}


def single_key_fits_int64(num_nodes: int) -> bool:
    """True when the ``new_dst * V + new_src`` relabel key (at most
    ``V^2 - 1``) fits int64."""
    v = int(num_nodes)
    return v == 0 or v <= (np.iinfo(np.int64).max // v)


def apply_graph_order(graph: Graph, perm: np.ndarray) -> Graph:
    """The CSR relabeled so ``new_id = rank(old_id)`` (``perm[new_id] ==
    old_id``), every row's neighbours sorted ascending.  Raises where
    ``V^2`` overflows int64 (the single-key sort would corrupt the CSR
    silently; an int32 column layout cannot hold such a graph anyway)."""
    V = graph.num_nodes
    perm = np.asarray(perm, dtype=np.int64)
    if perm.shape != (V,):
        raise ValueError(f"perm has shape {perm.shape}, expected ({V},)")
    if not single_key_fits_int64(V):
        raise ValueError(
            f"apply_graph_order: V={V:,} exceeds the single-key int64 "
            f"relabel range (V^2 overflows) — and the int32 col_idx "
            f"Graph layout itself, which caps V below 2^31; relabel "
            f"such graphs with an int64 edge pipeline before loading")
    rank = np.empty(V, dtype=np.int64)
    rank[perm] = np.arange(V, dtype=np.int64)
    deg = np.diff(graph.row_ptr)
    new_row_ptr = np.zeros(V + 1, dtype=np.int64)
    np.cumsum(deg[perm], out=new_row_ptr[1:])
    old_dst = np.repeat(np.arange(V, dtype=np.int64), deg)
    key = rank[old_dst] * V + rank[graph.col_idx.astype(np.int64)]
    key.sort()
    return Graph(row_ptr=new_row_ptr, col_idx=(key % V).astype(np.int32))


def apply_vertex_order(dataset: Dataset, perm: np.ndarray,
                       order_name: str) -> Tuple[Dataset, np.ndarray]:
    """``(dataset relabeled by perm, perm)``: row ``i`` of the result is
    row ``perm[i]`` of the original (original-order logits are
    ``new_logits[rank]``, ``rank[perm] = arange``); ``order_name`` is
    appended to the dataset's name."""
    return Dataset(
        graph=apply_graph_order(dataset.graph, perm),
        features=np.ascontiguousarray(dataset.features[perm]),
        labels=np.ascontiguousarray(dataset.labels[perm]),
        mask=np.ascontiguousarray(dataset.mask[perm]),
        num_classes=dataset.num_classes,
        name=dataset.name + "+" + order_name), perm


def cross_section_pairs(graph: Graph, section_rows: int) -> int:
    """Distinct (destination row, source section) pairs: each costs at
    least one padded sub-row of the sectioned layout."""
    if graph.col_idx.size == 0:
        return 0
    dst = np.repeat(np.arange(graph.num_nodes, dtype=np.int64),
                    np.diff(graph.row_ptr))
    sec = graph.col_idx.astype(np.int64) // section_rows
    return int(np.unique(dst * (sec.max() + 1) + sec).shape[0])
