"""The port's partitioner and padded-part layout against the JAX package's
on the CPU: the numpy code must give bit-equal arrays for the same
graph (core/partition.py, core/ell.py ``ell_from_padded_parts``,
parallel/distributed.py's remap and pad helpers)."""

import numpy as np
import pytest

import jax  # noqa: F401  (the JAX package runs on the CPU here)

from roc_tpu.core import ell as jell
from roc_tpu.core import graph as jgraph
from roc_tpu.core import partition as jpart
from roc_tpu.parallel import distributed as jdist
from roc_tpu_torch.core import ell as tell
from roc_tpu_torch.core import graph as tgraph
from roc_tpu_torch.core import partition as tpart
from roc_tpu_torch.parallel import distributed as tdist


def _hub_tail():
    """One hub vertex holds 100 of 109 edges: the sweep closes the hub's
    range and then runs out of edges, so P = 8 leaves empty tail parts."""
    row_ptr = np.concatenate([[0, 100], 100 + np.arange(1, 10)])
    col = np.random.RandomState(3).randint(0, 10, 109).astype(np.int32)
    return row_ptr.astype(np.int64), col


def _full_part():
    """16 vertices, 8 of degree 5 then 8 of degree 4: at P = 2 the sweep
    splits them 8 and 8, whose real rows fill part_nodes = 8 while their
    40 and 32 edges pad to 64, the configuration the full-part
    correction adds a row multiple for."""
    row_ptr = np.concatenate([[0], np.cumsum([5] * 8 + [4] * 8)])
    col = np.random.RandomState(4).randint(0, 16, 72).astype(np.int32)
    return row_ptr.astype(np.int64), col


GRAPHS = {
    "random_csr": lambda m: m.random_csr(300, 2400, seed=1),
    "synthetic": lambda m: m.synthetic_graph(257, 7, seed=2),
    "power_law": lambda m: m.synthetic_graph(400, 9, seed=3,
                                             power_law=True),
    "hub_tail": lambda m: m.Graph(*_hub_tail()),
    "full_part": lambda m: m.Graph(*_full_part()),
}


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("P", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_partition_layout_bit_equal(graph, P):
    """Bounds, plan, materialized parts, shape quantization, the remap to
    padded coordinates, pad/unpad and the padded-part ELL tables, in
    both packages, over five graphs and five part counts."""
    jg, tg = GRAPHS[graph](jgraph), GRAPHS[graph](tgraph)
    _same(jg.col_idx, tg.col_idx)
    assert tpart.edge_balanced_bounds(tg.row_ptr, P) == \
        jpart.edge_balanced_bounds(jg.row_ptr, P)
    jpg = jpart.partition_graph(jg, P, edge_multiple=64)
    tpg = tpart.partition_graph(tg, P, edge_multiple=64)
    jv, tv = vars(jpg), vars(tpg)
    assert set(jv) == set(tv)
    for k in jv:
        if isinstance(jv[k], np.ndarray):
            _same(tv[k], jv[k])
        else:
            assert tv[k] == jv[k], k
    for p in range(P):
        assert tpg.edge_range(p) == jpg.edge_range(p)
    assert (tpg.padded_num_nodes, tpg.dummy_src) == \
        (jpg.padded_num_nodes, jpg.dummy_src)
    _same(tpg.global_pad_map(), jpg.global_pad_map())
    assert tpart.quantize_plan_shapes(tpg.real_nodes, tpg.real_edges, 8,
                                      64) == jpart.quantize_plan_shapes(
        jpg.real_nodes, jpg.real_edges, 8, 64)
    if graph == "hub_tail" and P == 8:
        assert (tpg.real_nodes == 0).sum() == 6     # empty tail parts
    if graph == "full_part" and P == 2:
        assert tpg.real_nodes.tolist() == [8, 8] and tpg.part_nodes == 16
    cols = tdist.remap_to_padded(tpg)
    _same(cols, jdist.remap_to_padded(jpg))
    rng = np.random.RandomState(P)
    V = tg.num_nodes
    feats = rng.randn(V, 5).astype(np.float32)
    mask = rng.randint(0, 4, V).astype(np.int32)
    for arr, fill in ((feats, 0), (mask, jgraph.MASK_NONE)):
        padded = tdist.pad_nodes(arr, tpg, fill=fill)
        _same(padded, jdist.pad_nodes(arr, jpg, fill=fill))
        _same(tdist.unpad_nodes(padded, tpg), jdist.unpad_nodes(padded, jpg))
        _same(tdist.unpad_nodes(padded, tpg), arr)
    dummy = P * tpg.part_nodes
    jt = jell.ell_from_padded_parts(jpg.part_row_ptr, cols, jpg.real_nodes,
                                    jpg.part_nodes, dummy=dummy)
    tt = tell.ell_from_padded_parts(tpg.part_row_ptr, cols, tpg.real_nodes,
                                    tpg.part_nodes, dummy=dummy)
    assert tt.widths == jt.widths
    _same(tt.row_pos, jt.row_pos)
    for a, b in zip(tt.idx + tt.row_id, jt.idx + jt.row_id):
        _same(a, b)
    assert tt.row_pos.shape == (P, tpg.part_nodes)


def test_plan_from_row_ptr_and_columns_by_part():
    """The plan alone (no column data) and one part's columns at a time
    give what the materialized graph holds, in both packages."""
    jg = jgraph.synthetic_graph(301, 6, seed=5)
    tg = tgraph.synthetic_graph(301, 6, seed=5)
    jplan = jpart.partition_plan(jg.row_ptr, 3, edge_multiple=128)
    tplan = tpart.partition_plan(tg.row_ptr, 3, edge_multiple=128)
    tpg = tpart.materialize_plan(tg, tplan)
    for p in range(3):
        col = tpart.partition_col(tplan, lambda a, b: tg.col_idx[a:b], p)
        _same(col, jpart.partition_col(jplan, lambda a, b: jg.col_idx[a:b],
                                       p))
        _same(col, tpg.part_col_idx[p])
        _same(tdist.remap_col_to_padded(tplan, col),
              jdist.remap_col_to_padded(jplan, col))
    _same(tplan.local_to_global(), jplan.local_to_global())


def test_split_methods():
    """'cost' is the cost model's minimax split (core/costmodel.py), the
    JAX package's bounds and not the greedy sweep's on this graph; an
    unknown method raises; a PartitionedGraph needs its columns."""
    g = tgraph.zipf_csr(300, 3000, seed=0)
    got = tpart.partition_plan(g.row_ptr, 2, method="cost").bounds
    want = jpart.partition_plan(g.row_ptr, 2, method="cost").bounds
    assert [tuple(map(int, b)) for b in got] == \
        [tuple(map(int, b)) for b in want]
    assert got != tpart.partition_plan(g.row_ptr, 2).bounds
    with pytest.raises(ValueError, match="unknown partition method"):
        tpart.partition_bounds(g.row_ptr, 2, method="greedyy")
    plan = tpart.partition_plan(g.row_ptr, 2)
    with pytest.raises(TypeError, match="part_col_idx"):
        tpart.PartitionedGraph(**vars(plan))
