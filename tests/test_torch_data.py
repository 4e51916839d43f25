"""Host data of the PyTorch port against the JAX package: the graph
generators and the ELL tables must be bit-equal for the same seed."""

import numpy as np
import pytest

import jax  # noqa: F401  (the JAX package runs on the CPU here)
import torch

from roc_tpu.core import ell as jell
from roc_tpu.core import graph as jgraph
from roc_tpu.ops.norm import inv_sqrt_degree_np as j_inv_sqrt_np
from roc_tpu_torch.core import ell as tell
from roc_tpu_torch.core import graph as tgraph
from roc_tpu_torch.ops.norm import inv_sqrt_degree, inv_sqrt_degree_np


def _same_graph(a, b):
    np.testing.assert_array_equal(a.row_ptr, b.row_ptr)
    np.testing.assert_array_equal(a.col_idx, b.col_idx)
    assert a.row_ptr.dtype == b.row_ptr.dtype
    assert a.col_idx.dtype == b.col_idx.dtype


@pytest.mark.parametrize("V,deg,seed", [(128, 8, 0), (301, 6, 3),
                                        (1000, 12, 7)])
def test_synthetic_dataset_bit_equal(V, deg, seed):
    a = jgraph.synthetic_dataset(V, deg, in_dim=12, num_classes=5,
                                 seed=seed)
    b = tgraph.synthetic_dataset(V, deg, in_dim=12, num_classes=5,
                                 seed=seed)
    _same_graph(a.graph, b.graph)
    for name in ("features", "labels", "mask"):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    assert a.num_classes == b.num_classes


@pytest.mark.parametrize("power_law", [False, True])
def test_synthetic_graph_and_random_csr_bit_equal(power_law):
    _same_graph(jgraph.synthetic_graph(257, 7, seed=2, power_law=power_law),
                tgraph.synthetic_graph(257, 7, seed=2, power_law=power_law))
    _same_graph(jgraph.random_csr(200, 1500, seed=4, power_law=power_law),
                tgraph.random_csr(200, 1500, seed=4, power_law=power_law))


def test_add_self_edges_and_edge_list_bit_equal():
    rng = np.random.RandomState(0)
    src = rng.randint(0, 90, size=400)
    dst = rng.randint(0, 90, size=400)
    for sym in (False, True):
        a = jgraph.from_edge_list(src, dst, 90, symmetrize=sym)
        b = tgraph.from_edge_list(src, dst, 90, symmetrize=sym)
        _same_graph(a, b)
        _same_graph(jgraph.add_self_edges(a), tgraph.add_self_edges(b))
        assert jgraph.check_symmetric(a) == tgraph.check_symmetric(b)


def _hub_graph():
    """V = 1203 (unaligned): row 5 is a hub of in-degree 1500 (its own
    2048-wide bucket), rows 7 and 1202 have no edges at all."""
    rng = np.random.RandomState(1)
    V = 1203
    src = [rng.randint(0, V, size=1500)]
    dst = [np.full(1500, 5)]
    others = np.setdiff1d(np.arange(V), [5, 7, 1202])
    for k in range(1, 40):
        pick = others[rng.rand(others.size) < 0.2]
        src.append(rng.randint(0, V, size=pick.size))
        dst.append(pick)
    return np.concatenate(src), np.concatenate(dst), V


@pytest.mark.parametrize("case", ["hub_zero_unaligned", "synthetic",
                                  "power_law"])
def test_ell_tables_bit_equal(case):
    if case == "hub_zero_unaligned":
        src, dst, V = _hub_graph()
        g = jgraph.from_edge_list(src, dst, V)
        assert g.in_degree[5] == 1500 and g.in_degree[7] == 0
    elif case == "synthetic":
        g = jgraph.synthetic_graph(333, 9, seed=3)
    else:
        g = jgraph.synthetic_graph(300, 9, seed=3, power_law=True)
    V = g.num_nodes
    a = jell.ell_from_graph(g.row_ptr, g.col_idx, V)
    b = tell.ell_from_graph(g.row_ptr, g.col_idx, V)
    assert a.widths == b.widths
    assert len(a.idx) == len(b.idx) == len(b.row_id)
    for x, y in zip(a.idx, b.idx):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    for x, y in zip(a.row_id, b.row_id):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(a.row_pos, b.row_pos)
    if case == "hub_zero_unaligned":
        assert max(b.widths) == 2048
        # degree-0 rows point at the trailing zero slot
        total = sum(i.shape[1] for i in b.idx)
        assert b.row_pos[0, 7] == total and b.row_pos[0, 1202] == total
    np.testing.assert_array_equal(
        jell.row_widths(g.in_degree, 8), tell.row_widths(g.in_degree, 8))


def test_inv_sqrt_degree_bit_equal():
    """fp32 deg^-1/2: the port's torch and numpy forms give the JAX
    package's host numbers bit for bit (0 for degree 0)."""
    deg = np.array([0, 1, 2, 3, 7, 64, 1000, 2**20 + 3], np.int32)
    want = j_inv_sqrt_np(deg)
    np.testing.assert_array_equal(inv_sqrt_degree_np(deg), want)
    got = inv_sqrt_degree(torch.from_numpy(deg)).numpy()
    np.testing.assert_array_equal(got, want)
