"""The port's vertex reordering (core/reorder.py) against the JAX
package, on the CPU: the bfs and lpa orders equal, the native label
propagation sweep equal to the numpy one, the relabeled graphs and
datasets equal, and the int64 guard."""

import numpy as np
import pytest

from roc_tpu.core import graph as jgraph
from roc_tpu.core import reorder as jre
from roc_tpu_torch import native
from roc_tpu_torch.core import graph as tgraph
from roc_tpu_torch.core import reorder as tre
from roc_tpu_torch.ops.blockdense import probe_dense_frac


def _graphs(seed=3, shuffle=True, V=900, E=12_000, community_rows=128):
    """The same planted-community graph in both packages (bit-equal
    generators, tests/test_torch_layouts.py)."""
    kw = dict(community_rows=community_rows, seed=seed, shuffle=shuffle)
    return (jgraph.planted_community_csr(V, E, **kw),
            tgraph.planted_community_csr(V, E, **kw))


def _same_graph(a, b):
    np.testing.assert_array_equal(a.row_ptr, b.row_ptr)
    np.testing.assert_array_equal(a.col_idx, b.col_idx)
    assert a.col_idx.dtype == b.col_idx.dtype


@pytest.mark.parametrize("order", ["bfs", "lpa"])
@pytest.mark.parametrize("planners", ["native", "numpy"])
def test_orders_and_relabeled_graphs_equal_jax(order, planners,
                                               monkeypatch):
    jg, tg = _graphs(V=400, E=4000)
    if planners == "numpy":
        monkeypatch.setattr(native, "available", lambda: False)
    perm = tre.ORDERINGS[order](tg)
    want = jre.ORDERINGS[order](jg)
    np.testing.assert_array_equal(perm, want)
    assert sorted(perm.tolist()) == list(range(tg.num_nodes))
    _same_graph(jre.apply_graph_order(jg, want),
                tre.apply_graph_order(tg, perm))
    assert tre.cross_section_pairs(tg, 64) == jre.cross_section_pairs(jg, 64)


def test_native_lpa_sweep_equals_numpy():
    """One asynchronous sweep, native and numpy, from the same labels."""
    _, tg = _graphs()
    nbr_ptr, nbr = tre._undirected_csr(tg)
    labels = np.random.RandomState(0).randint(0, 50, tg.num_nodes) \
        .astype(np.int32)
    a, na = native.lpa_iterate(nbr_ptr, nbr, labels)
    b, nb = tre._lpa_sweep_numpy(nbr_ptr, nbr, labels, tg.num_nodes)
    np.testing.assert_array_equal(a, b)
    assert na == nb


def test_apply_vertex_order_equals_jax():
    jds = jgraph.synthetic_dataset(300, 6, in_dim=5, num_classes=3, seed=2)
    tds = tgraph.synthetic_dataset(300, 6, in_dim=5, num_classes=3, seed=2)
    perm = tre.bfs_order(tds.graph)
    got, p = tre.apply_vertex_order(tds, perm, "bfs")
    want, _ = jre.apply_vertex_order(jds, perm, "bfs")
    assert p is perm and got.name == want.name
    _same_graph(want.graph, got.graph)
    for f in ("features", "labels", "mask"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))


def test_lpa_recovers_the_planted_order_for_bdense():
    """Shuffled ids hide the communities from the tile census; the lpa
    order recovers the oracle's dense fraction, bfs much less (the
    mechanism the block-dense route rides on)."""
    kw = dict(seed=4, V=16_384, E=400_000, community_rows=512)
    _, shuffled = _graphs(**kw)
    _, oracle = _graphs(shuffle=False, **kw)

    def frac(g):
        return probe_dense_frac(g.row_ptr, g.col_idx, g.num_nodes,
                                min_fill=32)

    lpa = tre.apply_graph_order(shuffled, tre.lpa_order(shuffled))
    bfs = tre.apply_graph_order(shuffled, tre.bfs_order(shuffled))
    assert frac(shuffled) < 0.5 * frac(oracle)
    assert frac(lpa) >= 0.95 * frac(oracle)
    assert frac(bfs) < frac(lpa)


def test_int64_guard_raises(monkeypatch):
    """Where ``V^2`` would overflow int64 the relabel refuses loudly."""
    _, tg = _graphs(V=100, E=400)
    assert tre.single_key_fits_int64(3_037_000_499)
    assert not tre.single_key_fits_int64(3_037_000_500)
    assert jre.single_key_fits_int64(3_037_000_500) is False
    monkeypatch.setattr(tre, "single_key_fits_int64", lambda v: False)
    with pytest.raises(ValueError, match="int64"):
        tre.apply_graph_order(tg, np.arange(tg.num_nodes))
    with pytest.raises(ValueError, match="shape"):
        tre.apply_graph_order(tg, np.arange(tg.num_nodes - 1))
