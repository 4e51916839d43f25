"""Host-side graph data: the CSR container, the dataset record, the
reference on-disk layout's loaders and the synthetic generators.

A numpy copy of the subset of ``roc_tpu/core/graph.py`` this package
needs.  The generators draw from ``np.random.RandomState`` in the same
order as the JAX package's, so the same seed gives bit-equal arrays in
both packages (tests/test_torch_data.py holds them to that).  The
loaders read whole files on numpy's paths only: neither the JAX
package's native C++ parser nor its partition-local ``rows=`` reads are
ported (tests/test_torch_train.py holds the loaded arrays bit-equal).

``Graph`` is destination-major CSR: ``row_ptr`` has length ``V+1`` with
``row_ptr[0] == 0``, and ``col_idx[row_ptr[v]:row_ptr[v+1]]`` are the
*source* ids of the edges into ``v``.  Aggregation computes
``out[v] = sum(x[col_idx[row_ptr[v]:row_ptr[v+1]]])``.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass
from typing import Optional

import numpy as np

# Mask values of the reference's MaskType (gnn.h:98-103).
MASK_NONE = 0
MASK_TRAIN = 1
MASK_VAL = 2
MASK_TEST = 3

_MASK_NAMES = {"Train": MASK_TRAIN, "Val": MASK_VAL, "Test": MASK_TEST,
               "None": MASK_NONE}


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


# ---------------------------------------------------------------------------
# The reference on-disk layout (gnn.cc:756-801, load_task.cu:25-199)
# ---------------------------------------------------------------------------

def _read_slice(f, offset: int, count: int, dtype: str) -> np.ndarray:
    """Seek + read ``count`` items of ``dtype``; raises on a short read."""
    f.seek(offset)
    out = np.fromfile(f, dtype=dtype, count=count)
    if out.size != count:
        raise IOError(f"truncated read at {offset} (+{count}): "
                      f"got {out.size} items")
    return out


def load_lux_header(path: str) -> tuple:
    """(num_nodes, num_edges) from a `.lux` header without reading the
    body."""
    with open(path, "rb") as f:
        return struct.unpack("<IQ", f.read(12))


def load_lux(path: str) -> Graph:
    """Read a `.lux` binary graph: u32 num_nodes, u64 num_edges,
    num_nodes x u64 inclusive-end row offsets, num_edges x u32 source
    ids."""
    num_nodes, num_edges = load_lux_header(path)
    with open(path, "rb") as f:
        raw_rows = _read_slice(f, 12, num_nodes, "<u8")
        col_idx = _read_slice(f, 12 + 8 * num_nodes, num_edges, "<u4")
    # monotonicity checks mirror gnn.cc:798-800 (ValueError, not assert)
    if not (np.diff(raw_rows.astype(np.int64)) >= 0).all():
        raise ValueError(f"{path}: non-monotone row offsets")
    if num_nodes and raw_rows[-1] != num_edges:
        raise ValueError(f"{path}: row offsets end at {raw_rows[-1]}, "
                         f"expected {num_edges}")
    row_ptr = np.zeros(num_nodes + 1, dtype=np.int64)
    row_ptr[1:] = raw_rows.astype(np.int64)
    return Graph(row_ptr=row_ptr, col_idx=col_idx.astype(np.int32))


def load_features(prefix: str, num_nodes: int, in_dim: int) -> np.ndarray:
    """``<prefix>.feats.bin`` (float32) when present, else
    ``<prefix>.feats.csv`` (one comma-separated row per vertex), caching
    the ``.feats.bin`` beside it as ``load_task.cu:41-73`` does.  Returns
    float32 ``[num_nodes, in_dim]``."""
    bin_path = prefix + ".feats.bin"
    if os.path.exists(bin_path):
        data = np.fromfile(bin_path, dtype=np.float32,
                           count=num_nodes * in_dim)
        if data.size != num_nodes * in_dim:
            raise IOError(f"{bin_path}: truncated .feats.bin "
                          f"({data.size} of {num_nodes * in_dim} floats)")
        return data.reshape(num_nodes, in_dim)
    data = np.loadtxt(prefix + ".feats.csv", delimiter=",",
                      dtype=np.float32).reshape(num_nodes, in_dim)
    data.tofile(bin_path)
    return data


def load_labels(prefix: str, num_nodes: int, num_classes: int) -> np.ndarray:
    """``<prefix>.label``, one class index per line (``load_task.cu:118-
    123``).  Returns int32 ``[num_nodes]``."""
    labels = np.loadtxt(prefix + ".label", dtype=np.int64,
                        ndmin=1)[:num_nodes]
    if labels.shape[0] != num_nodes:
        raise ValueError(f"{prefix}.label: got {labels.shape[0]} rows, "
                         f"expected {num_nodes}")
    if not ((labels >= 0) & (labels < num_classes)).all():
        raise ValueError(f"{prefix}.label: class index outside "
                         f"[0, {num_classes})")
    return labels.astype(np.int32)


def load_mask(prefix: str, num_nodes: int) -> np.ndarray:
    """``<prefix>.mask``, "Train"/"Val"/"Test"/"None" per line
    (``load_task.cu:169-183``).  Returns int32 ``[num_nodes]`` of MASK_*
    values."""
    out = np.empty(num_nodes, dtype=np.int32)
    count = 0
    with open(prefix + ".mask") as f:
        for line in f:
            if count == num_nodes:
                break
            line = line.strip()
            if line not in _MASK_NAMES:
                raise ValueError(f"Unrecognized mask: {line!r}")
            out[count] = _MASK_NAMES[line]
            count += 1
    if count != num_nodes:
        raise ValueError(f"truncated .mask: wanted {num_nodes} rows, "
                         f"got {count}")
    return out


def load_dataset(prefix: str, in_dim: int, num_classes: int,
                 name: Optional[str] = None) -> Dataset:
    """A reference-layout dataset: ``<prefix>.add_self_edge.lux``
    (falling back to ``<prefix>.lux`` plus self-edge insertion),
    ``.feats.bin``/``.feats.csv``, ``.label``, ``.mask``."""
    lux = prefix + ".add_self_edge.lux"
    if os.path.exists(lux):
        graph = load_lux(lux)
    else:
        graph = add_self_edges(load_lux(prefix + ".lux"))
    V = graph.num_nodes
    return Dataset(graph=graph, features=load_features(prefix, V, in_dim),
                   labels=load_labels(prefix, V, num_classes),
                   mask=load_mask(prefix, V), num_classes=num_classes,
                   name=name or os.path.basename(prefix))


def random_csr(num_nodes: int, num_edges: int, seed: int = 0,
               power_law: bool = True) -> Graph:
    """Benchmark-scale CSR: a degree sequence (lognormal when
    ``power_law``, else near-uniform) summing to ``num_edges`` with
    every degree >= 1, and uniform random sources.  Not symmetric."""
    if num_edges < num_nodes:
        raise ValueError("need >= 1 edge per node (self edges)")
    rng = np.random.RandomState(seed)
    if power_law:
        deg = _lognormal_degree_sequence(num_nodes, num_edges, rng)
    else:
        raw = np.ones(num_nodes) + rng.rand(num_nodes) * 0.1
        deg = _degree_sequence(raw, num_edges, rng)
    row_ptr = np.zeros(num_nodes + 1, dtype=np.int64)
    np.cumsum(deg, out=row_ptr[1:])
    col_idx = rng.randint(0, num_nodes, size=num_edges, dtype=np.int64)
    return Graph(row_ptr=row_ptr, col_idx=col_idx.astype(np.int32))


def _degree_sequence(raw: np.ndarray, num_edges: int, rng) -> np.ndarray:
    """Degrees proportional to ``raw`` summing to ``num_edges``, every one
    >= 1; the rounding remainder goes to random vertices."""
    num_nodes = raw.shape[0]
    extra = num_edges - num_nodes
    deg = 1 + np.floor(raw / raw.sum() * extra).astype(np.int64)
    short = num_edges - int(deg.sum())
    if short > 0:
        np.add.at(deg, rng.randint(0, num_nodes, size=short), 1)
    return deg


def _lognormal_degree_sequence(num_nodes: int, num_edges: int,
                               rng) -> np.ndarray:
    """Lognormal-skewed in-degrees (sigma 1.25), as social graphs have."""
    raw = rng.lognormal(mean=0.0, sigma=1.25, size=num_nodes)
    return _degree_sequence(raw, num_edges, rng)


def zipf_csr(num_nodes: int, num_edges: int, a: float = 1.0,
             seed: int = 0, shuffle: bool = True) -> Graph:
    """Benchmark-scale CSR with Zipf in-degrees (the vertex ranked k gets
    degree proportional to ``k^-a``); ``shuffle`` scatters the ranks over
    random ids.  Uniform random sources; not symmetric."""
    if num_edges < num_nodes:
        raise ValueError("need >= 1 edge per node")
    rng = np.random.RandomState(seed)
    raw = np.arange(1, num_nodes + 1, dtype=np.float64) ** (-a)
    if shuffle:
        rng.shuffle(raw)
    deg = _degree_sequence(raw, num_edges, rng)
    row_ptr = np.zeros(num_nodes + 1, dtype=np.int64)
    np.cumsum(deg, out=row_ptr[1:])
    col_idx = rng.randint(0, num_nodes, size=num_edges, dtype=np.int64)
    return Graph(row_ptr=row_ptr, col_idx=col_idx.astype(np.int32))


def planted_community_csr(num_nodes: int, num_edges: int,
                          community_rows: int = 65_536,
                          intra_frac: float = 0.8, seed: int = 0,
                          shuffle: bool = True,
                          src_skew: float = 0.0) -> Graph:
    """Benchmark-scale dst-major CSR with planted communities: an edge's
    source lies in its destination's block of ``community_rows`` ids
    with probability ``intra_frac``, anywhere otherwise.  ``shuffle``
    relabels the vertices at random afterwards (the order a reordering
    pass, core/reorder.py, has to recover; the same seed without it is
    the oracle order); ``src_skew`` > 0 skews which member of the block
    is picked (``u^(1+src_skew)``).  Lognormal in-degrees as
    :func:`random_csr`'s; not symmetric."""
    if num_edges < num_nodes:
        raise ValueError("need >= 1 edge per node")
    rng = np.random.RandomState(seed)
    deg = _lognormal_degree_sequence(num_nodes, num_edges, rng)
    row_ptr = np.zeros(num_nodes + 1, dtype=np.int64)
    np.cumsum(deg, out=row_ptr[1:])
    dst_all = np.repeat(np.arange(num_nodes, dtype=np.int64), deg)
    com_lo = dst_all // community_rows * community_rows
    com_hi = np.minimum(com_lo + community_rows, num_nodes)
    u = rng.rand(num_edges)
    if src_skew > 0.0:
        u = u ** (1.0 + src_skew)
    local = com_lo + np.floor(u * (com_hi - com_lo)).astype(np.int64)
    del u, com_lo, com_hi
    anywhere = rng.randint(0, num_nodes, size=num_edges)
    intra = rng.rand(num_edges) < intra_frac
    col = np.where(intra, local, anywhere)
    del local, anywhere, intra
    if shuffle:
        relabel = rng.permutation(num_nodes).astype(np.int64)
        col = relabel[col]
        new_dst = relabel[dst_all]
        order = np.argsort(new_dst, kind="stable")
        col = col[order]
        row_ptr = np.zeros(num_nodes + 1, dtype=np.int64)
        np.cumsum(np.bincount(new_dst, minlength=num_nodes),
                  out=row_ptr[1:])
    return Graph(row_ptr=row_ptr, col_idx=col.astype(np.int32))


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
