"""Host-side graph data: the CSR container, the dataset record and the
synthetic generators the serving path and its tests are built from.

A numpy copy of the subset of ``roc_tpu/core/graph.py`` this package
needs.  The generators draw from ``np.random.RandomState`` in the same
order as the JAX package's, so the same seed gives bit-equal arrays in
both packages (tests/test_torch_data.py holds them to that).

``Graph`` is destination-major CSR: ``row_ptr`` has length ``V+1`` with
``row_ptr[0] == 0``, and ``col_idx[row_ptr[v]:row_ptr[v+1]]`` are the
*source* ids of the edges into ``v``.  Aggregation computes
``out[v] = sum(x[col_idx[row_ptr[v]:row_ptr[v+1]]])``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

# Mask values of the reference's MaskType (gnn.h:98-103).
MASK_NONE = 0
MASK_TRAIN = 1
MASK_VAL = 2
MASK_TEST = 3


@dataclass
class Graph:
    """An in-memory CSR graph, destination-major (see module docstring)."""

    row_ptr: np.ndarray  # int64 [V+1]
    col_idx: np.ndarray  # int32 [E]

    def __post_init__(self):
        self.row_ptr = np.asarray(self.row_ptr, dtype=np.int64)
        self.col_idx = np.asarray(self.col_idx, dtype=np.int32)
        if self.row_ptr.ndim != 1 or self.col_idx.ndim != 1:
            raise ValueError("row_ptr and col_idx must be 1-D")
        if self.row_ptr[0] != 0 or self.row_ptr[-1] != self.col_idx.size:
            raise ValueError(
                f"row_ptr must run from 0 to the edge count "
                f"{self.col_idx.size}, got {self.row_ptr[0]}.."
                f"{self.row_ptr[-1]}")

    @property
    def num_nodes(self) -> int:
        return int(self.row_ptr.shape[0] - 1)

    @property
    def num_edges(self) -> int:
        return int(self.col_idx.shape[0])

    @property
    def in_degree(self) -> np.ndarray:
        """Per-destination edge counts (int32)."""
        return np.diff(self.row_ptr).astype(np.int32)

    def edge_dst(self) -> np.ndarray:
        """Per-edge destination ids (int32 [E])."""
        return np.repeat(np.arange(self.num_nodes, dtype=np.int32),
                         self.in_degree)


def check_symmetric(graph: Graph) -> bool:
    """Exact symmetry check via sorted edge-list comparison."""
    dst = graph.edge_dst().astype(np.int64)
    src = graph.col_idx.astype(np.int64)
    fwd = dst * graph.num_nodes + src
    bwd = src * graph.num_nodes + dst
    return bool(np.array_equal(np.sort(fwd), np.sort(bwd)))


def add_self_edges(graph: Graph) -> Graph:
    """Ensure every vertex has a self edge (the reference's offline
    ``.add_self_edge.lux`` preprocessing, ``gnn.cc:756``).  Existing
    self edges are kept; missing ones are inserted after the row's
    other edges."""
    V = graph.num_nodes
    dst = graph.edge_dst()
    has_self = np.zeros(V, dtype=bool)
    has_self[dst[graph.col_idx == dst]] = True
    missing = np.flatnonzero(~has_self).astype(np.int32)
    if missing.size == 0:
        return graph
    dst_all = np.concatenate([dst, missing])
    col_all = np.concatenate([graph.col_idx, missing])
    order = np.argsort(dst_all, kind="stable")
    counts = np.bincount(dst_all, minlength=V)
    row_ptr = np.zeros(V + 1, dtype=np.int64)
    np.cumsum(counts, out=row_ptr[1:])
    return Graph(row_ptr=row_ptr, col_idx=col_all[order].astype(np.int32))


def from_edge_list(src: np.ndarray, dst: np.ndarray, num_nodes: int,
                   symmetrize: bool = False) -> Graph:
    """Build a dst-major CSR graph from a COO edge list; ``symmetrize``
    adds every reverse edge and drops duplicates."""
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    if symmetrize:
        src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
        # sorted unique keys by sort + first-of-run: what np.unique
        # returns, without the hash pass numpy >= 2.3 runs first (over
        # 300 s at Reddit's 115M keys on the H100 host, measured)
        key = np.sort(dst * num_nodes + src)
        key = key[np.concatenate([[True], key[1:] != key[:-1]])]
        dst, src = key // num_nodes, key % num_nodes
    order = np.argsort(dst, kind="stable")
    src, dst = src[order], dst[order]
    counts = np.bincount(dst, minlength=num_nodes)
    row_ptr = np.zeros(num_nodes + 1, dtype=np.int64)
    np.cumsum(counts, out=row_ptr[1:])
    return Graph(row_ptr=row_ptr, col_idx=src.astype(np.int32))


@dataclass
class Dataset:
    """A fully-loaded full-graph node-classification problem."""

    graph: Graph
    features: np.ndarray  # float32 [V, in_dim]
    labels: np.ndarray    # int32 [V]
    mask: np.ndarray      # int32 [V] of MASK_* values
    num_classes: int
    name: str = "dataset"

    @property
    def in_dim(self) -> int:
        return int(self.features.shape[1])


def random_csr(num_nodes: int, num_edges: int, seed: int = 0,
               power_law: bool = True) -> Graph:
    """Benchmark-scale CSR: a degree sequence (lognormal when
    ``power_law``, else near-uniform) summing to ``num_edges`` with
    every degree >= 1, and uniform random sources.  Not symmetric."""
    if num_edges < num_nodes:
        raise ValueError("need >= 1 edge per node (self edges)")
    rng = np.random.RandomState(seed)
    if power_law:
        raw = rng.lognormal(mean=0.0, sigma=1.25, size=num_nodes)
    else:
        raw = np.ones(num_nodes) + rng.rand(num_nodes) * 0.1
    extra = num_edges - num_nodes
    deg = 1 + np.floor(raw / raw.sum() * extra).astype(np.int64)
    short = num_edges - int(deg.sum())
    if short > 0:
        np.add.at(deg, rng.randint(0, num_nodes, size=short), 1)
    row_ptr = np.zeros(num_nodes + 1, dtype=np.int64)
    np.cumsum(deg, out=row_ptr[1:])
    col_idx = rng.randint(0, num_nodes, size=num_edges, dtype=np.int64)
    return Graph(row_ptr=row_ptr, col_idx=col_idx.astype(np.int32))


def synthetic_graph(num_nodes: int, avg_degree: int, seed: int = 0,
                    power_law: bool = False) -> Graph:
    """Random symmetric graph with self edges; ``power_law`` skews the
    source endpoints toward low ids."""
    rng = np.random.RandomState(seed)
    n_rand = num_nodes * max(avg_degree - 1, 0) // 2
    if power_law and n_rand > 0:
        p = 1.0 / (np.arange(num_nodes) + 10.0)
        p /= p.sum()
        src = rng.choice(num_nodes, size=n_rand, p=p).astype(np.int64)
        dst = rng.randint(0, num_nodes, size=n_rand).astype(np.int64)
    else:
        src = rng.randint(0, num_nodes, size=n_rand).astype(np.int64)
        dst = rng.randint(0, num_nodes, size=n_rand).astype(np.int64)
    return add_self_edges(from_edge_list(src, dst, num_nodes,
                                         symmetrize=True))


def synthetic_dataset(num_nodes: int = 128, avg_degree: int = 8,
                      in_dim: int = 16, num_classes: int = 4,
                      seed: int = 0, homophily: float = 0.8,
                      name: str = "synthetic") -> Dataset:
    """Deterministic learnable fixture: a homophilous symmetric graph
    with self edges (edges mostly intra-class) and class-informative
    features (cluster means + noise)."""
    rng = np.random.RandomState(seed + 1)
    labels = rng.randint(0, num_classes, size=num_nodes).astype(np.int32)
    n_rand = num_nodes * max(avg_degree - 1, 0) // 2
    src = rng.randint(0, num_nodes, size=n_rand).astype(np.int64)
    order = np.argsort(labels, kind="stable")
    class_start = np.zeros(num_classes + 1, dtype=np.int64)
    np.cumsum(np.bincount(labels, minlength=num_classes),
              out=class_start[1:])
    src_lab = labels[src]
    sizes = np.maximum(class_start[src_lab + 1] - class_start[src_lab], 1)
    pick = class_start[src_lab] + np.minimum(
        np.floor(rng.rand(n_rand) * sizes).astype(np.int64), sizes - 1)
    same = rng.rand(n_rand) < homophily
    dst = np.where(same, order[pick],
                   rng.randint(0, num_nodes, size=n_rand))
    graph = add_self_edges(from_edge_list(src, dst, num_nodes,
                                          symmetrize=True))
    means = rng.randn(num_classes, in_dim).astype(np.float32) * 2.0
    feats = means[labels] + rng.randn(num_nodes, in_dim).astype(np.float32)
    mask = np.full(num_nodes, MASK_NONE, dtype=np.int32)
    split = rng.rand(num_nodes)
    mask[split < 0.5] = MASK_TRAIN
    mask[(split >= 0.5) & (split < 0.75)] = MASK_VAL
    mask[split >= 0.75] = MASK_TEST
    return Dataset(graph=graph, features=feats.astype(np.float32),
                   labels=labels, mask=mask, num_classes=num_classes,
                   name=name)
