"""Host-side graph data: the CSR container, the dataset record, the
reference on-disk layout's loaders and the synthetic generators.

A numpy copy of the subset of ``roc_tpu/core/graph.py`` this package
needs.  The generators draw from ``np.random.RandomState`` in the same
order as the JAX package's, so the same seed gives bit-equal arrays in
both packages (tests/test_torch_data.py holds them to that).  The
loaders read the reference's files through the port's native library
(native/rocload.cc: the ``.lux`` reader and writer, the CSV parser, the
mask parser, self-edge insertion) when it is built, else on numpy's
paths, which give the same arrays (tests/test_torch_source.py).  The
partition-local reads (:func:`load_lux_rows`, ``rows=(lo, hi)`` of the
feature, label and mask loaders) read only the requested rows' bytes,
as the reference's per-partition loader does (``load_task.cu:41-51,
201-245``); every binary slice goes through :func:`_read_slice`, called
module-qualified, so a test can spy on the byte ranges a rank reads.

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

    def has_all_self_edges(self) -> bool:
        """True iff every row holds its own id."""
        if (self.in_degree == 0).any():
            return False
        dst = self.edge_dst()
        out = np.zeros(self.num_nodes, dtype=bool)
        out[dst[self.col_idx == dst]] = True
        return bool(out.all())

    def is_symmetric(self) -> bool:
        """True iff the adjacency equals its transpose: the backward's
        reuse of the forward CSR (``scattergather_kernel.cu:160-170``)
        is right only then."""
        return check_symmetric(self)

    def transpose(self) -> "Graph":
        """The graph with every edge reversed, rows sorted by the old
        source and each row's edges in the old destination order."""
        dst = self.edge_dst()
        order = np.argsort(self.col_idx, kind="stable")
        counts = np.bincount(self.col_idx, minlength=self.num_nodes)
        row_ptr = np.zeros(self.num_nodes + 1, dtype=np.int64)
        np.cumsum(counts, out=row_ptr[1:])
        return Graph(row_ptr=row_ptr, col_idx=dst[order])


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
    other edges (natively when the library is built)."""
    from .. import native
    if native.available():
        row_ptr, col_idx = native.add_self_edges(graph.row_ptr,
                                                 graph.col_idx)
        return Graph(row_ptr=row_ptr, col_idx=col_idx)
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


# ---------------------------------------------------------------------------
# The reference on-disk layout (gnn.cc:756-801, load_task.cu:25-199)
# ---------------------------------------------------------------------------

def _read_slice(f, offset: int, count: int, dtype: str) -> np.ndarray:
    """Seek + read ``count`` items of ``dtype``; raises on a short read.
    Every partition-local binary read goes through here, so a test can
    spy on the byte ranges a rank touches."""
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


def load_lux_rows(path: str, row_lo: int, row_hi: int) -> tuple:
    """Rows ``[row_lo, row_hi)`` of a `.lux` file alone: the
    ``row_hi - row_lo + 1`` offsets that bound them and exactly their
    column bytes (the reference loader's skip to rowLeft,
    ``load_task.cu:41-51, 201-245``).  Returns ``(local_row_ptr,
    col_idx)``, ``local_row_ptr`` int64 ``[n + 1]`` rebased to 0."""
    num_nodes, num_edges = load_lux_header(path)
    if not 0 <= row_lo <= row_hi <= num_nodes:
        raise ValueError(f"bad row range [{row_lo}, {row_hi}) for "
                         f"{num_nodes} nodes")
    n = row_hi - row_lo
    header = 12
    with open(path, "rb") as f:
        # the offsets are u64 inclusive ends: row v's edges end at off[v]
        # and start at off[v - 1] (0 for v == 0)
        lo_off = 0 if row_lo == 0 else int(_read_slice(
            f, header + (row_lo - 1) * 8, 1, "<u8")[0])
        if n == 0:
            return np.zeros(1, dtype=np.int64), np.zeros(0, dtype=np.int32)
        ends = _read_slice(f, header + row_lo * 8, n, "<u8").astype(
            np.int64)
        if not ((np.diff(ends) >= 0).all() and ends[0] >= lo_off):
            raise ValueError(f"{path}: non-monotone row offsets in "
                             f"rows [{row_lo}, {row_hi})")
        col_base = header + num_nodes * 8
        e0, e1 = lo_off, int(ends[-1])
        col = _read_slice(f, col_base + e0 * 4, e1 - e0, "<u4")
    local_ptr = np.zeros(n + 1, dtype=np.int64)
    local_ptr[1:] = ends - lo_off
    return local_ptr, col.astype(np.int32)


def load_lux(path: str) -> Graph:
    """Read a `.lux` binary graph: u32 num_nodes, u64 num_edges,
    num_nodes x u64 inclusive-end row offsets, num_edges x u32 source
    ids; natively when the library is built, else with numpy."""
    from .. import native
    if native.available():
        row_ptr, col_idx = native.load_lux(path)
        return Graph(row_ptr=row_ptr, col_idx=col_idx)
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


def save_lux(graph: Graph, path: str) -> None:
    """Write the reference `.lux` format (the inverse of
    :func:`load_lux`); natively when the library is built."""
    from .. import native
    if native.available():
        native.save_lux(path, graph.row_ptr, graph.col_idx)
        return
    with open(path, "wb") as f:
        f.write(struct.pack("<IQ", graph.num_nodes, graph.num_edges))
        graph.row_ptr[1:].astype("<u8").tofile(f)
        graph.col_idx.astype("<u4").tofile(f)


def _check_rows(rows: tuple, num_nodes: int) -> tuple:
    lo, hi = (int(r) for r in rows)
    if not 0 <= lo <= hi <= num_nodes:
        raise ValueError(f"bad row range [{lo}, {hi}) for {num_nodes} "
                         "nodes")
    return lo, hi


def _iter_lines(path: str, lo: int, hi: int):
    """Lines ``[lo, hi)`` of a text file (the numpy path's line skip for
    the partition-local CSV, label and mask reads)."""
    import itertools
    with open(path) as f:
        yield from itertools.islice(f, lo, hi)


def load_features(prefix: str, num_nodes: int, in_dim: int,
                  rows: Optional[tuple] = None) -> np.ndarray:
    """``<prefix>.feats.bin`` (float32) when present, else
    ``<prefix>.feats.csv`` (one comma-separated row per vertex), caching
    the ``.feats.bin`` beside it as ``load_task.cu:41-73`` does.  Returns
    float32 ``[num_nodes, in_dim]``.

    ``rows=(lo, hi)`` reads that half-open row range alone: from the
    ``.feats.bin`` an exact byte-range read (:func:`_read_slice`), from
    the CSV the native parser's line skip to ``lo`` (numpy's path parses
    only the needed lines); no ``.feats.bin`` is cached then."""
    from .. import native
    bin_path = prefix + ".feats.bin"
    csv_path = prefix + ".feats.csv"
    if rows is not None:
        lo, hi = _check_rows(rows, num_nodes)
        if os.path.exists(bin_path):
            with open(bin_path, "rb") as f:
                data = _read_slice(f, lo * in_dim * 4, (hi - lo) * in_dim,
                                   np.float32)
            return data.reshape(hi - lo, in_dim)
        if native.available():
            return native.load_features_csv_rows(csv_path, lo, hi, in_dim)
        if hi == lo:
            return np.zeros((0, in_dim), dtype=np.float32)
        data = np.loadtxt(_iter_lines(csv_path, lo, hi), delimiter=",",
                          dtype=np.float32, ndmin=2)
        if data.shape != (hi - lo, in_dim):
            raise ValueError(f"{csv_path}: rows [{lo}, {hi}) parsed to "
                             f"{data.shape}, expected {(hi - lo, in_dim)}")
        return data
    if os.path.exists(bin_path):
        data = np.fromfile(bin_path, dtype=np.float32,
                           count=num_nodes * in_dim)
        if data.size != num_nodes * in_dim:
            raise IOError(f"{bin_path}: truncated .feats.bin "
                          f"({data.size} of {num_nodes * in_dim} floats)")
        return data.reshape(num_nodes, in_dim)
    if native.available():
        data = native.load_features_csv(csv_path, num_nodes, in_dim)
    else:
        data = np.loadtxt(csv_path, delimiter=",",
                          dtype=np.float32).reshape(num_nodes, in_dim)
    data.tofile(bin_path)
    return data


def load_labels(prefix: str, num_nodes: int, num_classes: int,
                rows: Optional[tuple] = None) -> np.ndarray:
    """``<prefix>.label``, one class index per line (``load_task.cu:118-
    123``).  Returns int32 ``[num_nodes]``, or the ``rows=(lo, hi)``
    slice (lines before ``lo`` are skipped, unparsed)."""
    if rows is not None:
        lo, hi = _check_rows(rows, num_nodes)
        labels = np.loadtxt(_iter_lines(prefix + ".label", lo, hi),
                            dtype=np.int64, ndmin=1)
        n = hi - lo
    else:
        labels = np.loadtxt(prefix + ".label", dtype=np.int64,
                            ndmin=1)[:num_nodes]
        n = num_nodes
    if labels.shape[0] != n:
        raise ValueError(f"{prefix}.label: got {labels.shape[0]} rows, "
                         f"expected {n}")
    if not ((labels >= 0) & (labels < num_classes)).all():
        raise ValueError(f"{prefix}.label: class index outside "
                         f"[0, {num_classes})")
    return labels.astype(np.int32)


def load_mask(prefix: str, num_nodes: int,
              rows: Optional[tuple] = None) -> np.ndarray:
    """``<prefix>.mask``, "Train"/"Val"/"Test"/"None" per line
    (``load_task.cu:169-183``).  Returns int32 ``[num_nodes]`` of MASK_*
    values (natively when the library is built), or the ``rows=(lo,
    hi)`` slice."""
    from .. import native
    if rows is None and native.available():
        return native.load_mask(prefix + ".mask", num_nodes)
    lo, hi = _check_rows(rows, num_nodes) if rows is not None \
        else (0, num_nodes)
    out = np.empty(hi - lo, dtype=np.int32)
    count = 0
    for i, line in enumerate(_iter_lines(prefix + ".mask", lo, hi)):
        line = line.strip()
        if line not in _MASK_NAMES:
            raise ValueError(f"Unrecognized mask: {line!r}")
        out[i] = _MASK_NAMES[line]
        count = i + 1
    if count != hi - lo:
        raise ValueError(f"truncated .mask: wanted rows [{lo}, {hi}), "
                         f"got {count}")
    return out


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


def save_dataset(ds: Dataset, prefix: str, csv: bool = True,
                 feats_bin: bool = True) -> None:
    """Write a dataset in the reference on-disk layout (what
    ``load_task.cu:25-199`` reads): ``<prefix>.add_self_edge.lux``,
    ``.feats.csv`` and/or ``.feats.bin``, ``.label``, ``.mask``.  The
    graph is written as it is: the caller gives it its self edges
    (:func:`add_self_edges`), as the file name promises."""
    save_lux(ds.graph, prefix + ".add_self_edge.lux")
    if csv:
        np.savetxt(prefix + ".feats.csv", ds.features, delimiter=",",
                   fmt="%.7g")
    if feats_bin:
        np.asarray(ds.features, dtype=np.float32).tofile(
            prefix + ".feats.bin")
    np.savetxt(prefix + ".label", ds.labels, fmt="%d")
    names = {v: k for k, v in _MASK_NAMES.items()}
    with open(prefix + ".mask", "w") as f:
        f.write("".join(names[int(m)] + "\n" for m in ds.mask))


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
