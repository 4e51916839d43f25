"""Partition-local dataset sources (``roc_tpu/core/source.py``).

The reference never loads whole tensors on every node: each partition's
loader task reads only its ``[rowLeft, rowRight]`` slice of the graph,
features, labels and mask (``load_task.cu:41-51`` skips to rowLeft;
``load_task.cu:201-245`` reads per partition).  A :class:`DataSource` is
that contract here: row-sliced accessors that a rank's
``parallel/multihost.py shard_dataset_local`` drives, so a rank holds
only its own part's O(V/P + E/P) data.

- :class:`ArraySource` wraps an in-memory :class:`Dataset` (slices are
  views): the one-process case, and what the tests hold a file against.
- :class:`FileSource` reads the reference's on-disk layout
  (``.lux``/``.feats.bin|.csv``/``.label``/``.mask``) with seek-based
  slice reads (core/graph.py's row-sliced loaders); the one global read
  it makes is the O(V) row-offset section every rank needs for the
  partition bounds.

Besides the JAX package's accessors a source gives ``graph``, the O(V)
part of the graph (:class:`RowGraph`: the counts, the row pointer and
the in-degrees), which is all a trainer reads of a dataset it does not
hold (parallel/distributed.py ``DistributedTrainer``).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import numpy as np

from . import graph as _graph
from .graph import (Dataset, load_features, load_labels, load_lux_header,
                    load_mask)


class RowGraph:
    """The O(V) part of a graph: ``row_ptr`` and what it gives (the
    counts and the in-degrees); it holds no column."""

    def __init__(self, row_ptr: np.ndarray):
        self.row_ptr = row_ptr

    @property
    def num_nodes(self) -> int:
        return int(self.row_ptr.shape[0] - 1)

    @property
    def num_edges(self) -> int:
        return int(self.row_ptr[-1])

    @property
    def in_degree(self) -> np.ndarray:
        return np.diff(self.row_ptr).astype(np.int32)


class DataSource:
    """Row-sliced access to one dataset.  Every range is half-open."""

    num_nodes: int
    num_edges: int
    in_dim: int
    num_classes: int
    name: str = "dataset"

    def row_ptr(self) -> np.ndarray:
        """The global int64 ``[V+1]`` CSR row pointer (O(V): the one
        global structure every rank reads, for the partition bounds)."""
        raise NotImplementedError

    @property
    def graph(self) -> RowGraph:
        """The counts and the row pointer as a :class:`RowGraph`."""
        return RowGraph(self.row_ptr())

    def col_slice(self, e0: int, e1: int) -> np.ndarray:
        """Global source ids of the edges ``[e0, e1)``."""
        raise NotImplementedError

    def features(self, lo: int, hi: int) -> np.ndarray:
        raise NotImplementedError

    def labels(self, lo: int, hi: int) -> np.ndarray:
        raise NotImplementedError

    def mask(self, lo: int, hi: int) -> np.ndarray:
        raise NotImplementedError


@dataclass
class ArraySource(DataSource):
    """An in-memory dataset as a row-sliced source (slices are views)."""

    dataset: Dataset

    def __post_init__(self):
        self.num_nodes = self.dataset.graph.num_nodes
        self.num_edges = self.dataset.graph.num_edges
        self.in_dim = self.dataset.in_dim
        self.num_classes = self.dataset.num_classes
        self.name = self.dataset.name

    def row_ptr(self) -> np.ndarray:
        return self.dataset.graph.row_ptr

    def col_slice(self, e0: int, e1: int) -> np.ndarray:
        return self.dataset.graph.col_idx[e0:e1]

    def features(self, lo: int, hi: int) -> np.ndarray:
        return self.dataset.features[lo:hi]

    def labels(self, lo: int, hi: int) -> np.ndarray:
        return self.dataset.labels[lo:hi]

    def mask(self, lo: int, hi: int) -> np.ndarray:
        return self.dataset.mask[lo:hi]


class FileSource(DataSource):
    """A reference-layout dataset on disk, read by seek-based slices.

    ``prefix`` as ``load_dataset`` takes it: ``<prefix>.add_self_edge.lux``
    (or ``<prefix>.lux``), ``.feats.bin``/``.feats.csv``, ``.label``,
    ``.mask``.  The `.lux` must already contain self edges for the
    partition-local path (offline preprocessing, as the reference
    assumes, ``gnn.cc:756``): inserting them here would need the whole
    graph resident.
    """

    def __init__(self, prefix: str, in_dim: int, num_classes: int):
        self.prefix = prefix
        self.in_dim = in_dim
        self.num_classes = num_classes
        self.name = os.path.basename(prefix)
        lux = prefix + ".add_self_edge.lux"
        self.lux_path = lux if os.path.exists(lux) else prefix + ".lux"
        self.num_nodes, self.num_edges = load_lux_header(self.lux_path)
        self._row_ptr: Optional[np.ndarray] = None

    def row_ptr(self) -> np.ndarray:
        if self._row_ptr is None:
            with open(self.lux_path, "rb") as f:
                # module-qualified, so a test can spy on the read
                ends = _graph._read_slice(f, 12, self.num_nodes, "<u8")
            rp = np.zeros(self.num_nodes + 1, dtype=np.int64)
            rp[1:] = ends.astype(np.int64)
            if not ((np.diff(rp) >= 0).all() and rp[-1] == self.num_edges):
                raise ValueError(f"{self.lux_path}: row offsets not "
                                 f"monotone or not ending at "
                                 f"{self.num_edges}")
            self._row_ptr = rp
        return self._row_ptr

    def col_slice(self, e0: int, e1: int) -> np.ndarray:
        base = 12 + self.num_nodes * 8
        with open(self.lux_path, "rb") as f:
            col = _graph._read_slice(f, base + e0 * 4, e1 - e0, "<u4")
        return col.astype(np.int32)

    def features(self, lo: int, hi: int) -> np.ndarray:
        return load_features(self.prefix, self.num_nodes, self.in_dim,
                             rows=(lo, hi))

    def labels(self, lo: int, hi: int) -> np.ndarray:
        return load_labels(self.prefix, self.num_nodes, self.num_classes,
                           rows=(lo, hi))

    def mask(self, lo: int, hi: int) -> np.ndarray:
        return load_mask(self.prefix, self.num_nodes, rows=(lo, hi))


def as_source(data) -> DataSource:
    """A Dataset as an :class:`ArraySource`; a DataSource as it is."""
    if isinstance(data, DataSource):
        return data
    if isinstance(data, Dataset):
        return ArraySource(data)
    raise TypeError(f"not a Dataset or DataSource: {type(data)!r}")
