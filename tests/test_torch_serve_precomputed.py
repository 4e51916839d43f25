"""The port's precomputed serving backend against the JAX package's, on
the CPU: the 'akx' and 'table' flavors, the propagation stages and their
edge-append invalidation, the model spec both ways, and the versioned
publish.

The JAX serve rig's size: V = 300, degree 6, 24 input features, 5
classes; the same dataset in both packages (bit-equal,
tests/test_torch_data.py) and the JAX package's Glorot weights carried
across with convert.py.  Both packages run the prefix on their blocked
host walk (core/streaming.py; the port's tile sums through K3's plain
version on the CPU): the same fp32 operations with the neighbour sums in
another order, so stages and logits are held within 1e-5.
"""

import json

import numpy as np
import pytest

import jax

from roc_tpu.core.graph import Graph as JGraph
from roc_tpu.core.graph import synthetic_dataset as j_synthetic_dataset
from roc_tpu.models import builder as jbuilder
from roc_tpu.models import model_builders as j_model_builders
from roc_tpu.serve.export import build_predictor as j_build_predictor
from roc_tpu.serve.propagation import PropagationCache as JCache
from roc_tpu.train.trainer import TrainConfig as JTrainConfig
from roc_tpu_torch import convert
from roc_tpu_torch.core.graph import Graph, synthetic_dataset
from roc_tpu_torch.models import builder, model_builders
from roc_tpu_torch.serve.export import build_predictor
from roc_tpu_torch.serve.propagation import (PropagationCache,
                                             logits_table_cache)
from roc_tpu_torch.serve.server import Server
from roc_tpu_torch.train.trainer import TrainConfig

V, IN, C = 300, 24, 5
TOL = 1e-5
# flavor -> (registry name, builder kwargs, layers)
FLAVORS = {"akx": ("sgc", {"k": 2}, [IN, C]),
           "table": ("appnp", {"k": 3}, [IN, 16, C])}
# the prefixes the walk takes: SUM (unfused, norm/sum/norm), AVG, and
# the fused chain with its relu
PREFIXES = {
    "sum": [{"kind": "indegree_norm"},
            {"kind": "scatter_gather", "aggr": "sum"},
            {"kind": "indegree_norm"},
            {"kind": "indegree_norm"},
            {"kind": "scatter_gather", "aggr": "sum"},
            {"kind": "indegree_norm"}],
    "avg": [{"kind": "indegree_norm"},
            {"kind": "scatter_gather", "aggr": "avg"},
            {"kind": "scatter_gather", "aggr": "avg"}],
    "fused_relu": [{"kind": "fused_aggregate", "activation": "relu"},
                   {"kind": "fused_aggregate", "activation": "none"}],
}
EDGES = ([3, 250, 17, 42], [250, 3, 42, 17])


@pytest.fixture(scope="module")
def data():
    return (j_synthetic_dataset(V, 6, in_dim=IN, num_classes=C, seed=0),
            synthetic_dataset(V, 6, in_dim=IN, num_classes=C, seed=0))


def _pair(fam):
    name, kw, layers = FLAVORS[fam]
    jm = j_model_builders()[name](layers, dropout_rate=0.5, **kw)
    m = model_builders()[name](layers, dropout_rate=0.5, **kw)
    jp = jm.init_params(jax.random.PRNGKey(7))
    return jm, m, jp, convert.params_from_jax(
        {k: np.asarray(v) for k, v in jp.items()})


def _close(got, want, tol=TOL):
    err = float(np.abs(np.asarray(got) - np.asarray(want)).max())
    assert err <= tol * max(1.0, float(np.abs(want).max())), err


@pytest.mark.parametrize("impl", ["cuda", "segment"])
@pytest.mark.parametrize("flavor", sorted(FLAVORS))
def test_flavor_logits_match_jax(data, flavor, impl):
    """'akx' (SGC k = 2, backend 'auto') and 'table' (APPNP k = 3,
    backend 'precomputed'): the port's predictor on ``impl`` serves JAX
    ``build_predictor(...).query``'s logits, on every id and on an
    odd-sized subset (a padded bucket)."""
    jds, ds = data
    jm, m, jp, tp = _pair(flavor)
    backend = "auto" if flavor == "akx" else "precomputed"
    jpred = j_build_predictor(jm, jds, JTrainConfig(
        aggr_impl="segment", verbose=False, symmetric=True), params=jp,
        backend=backend)
    pred = build_predictor(m, ds, TrainConfig(aggr_impl=impl), params=tp,
                           backend=backend, device="cpu")
    assert (pred.backend, pred.flavor) == ("precomputed", flavor)
    assert (jpred.backend, jpred.flavor) == ("precomputed", flavor)
    ids = np.arange(V)
    _close(pred.query(ids), jpred.query(ids))
    sub = [7, 123, 250]
    _close(pred.query(sub), jpred.query(sub))
    assert pred.query(sub).shape == (3, C)


def _caches(jds, ds, prefix, block_rows=65536):
    ops = PREFIXES[prefix]
    feats = np.asarray(ds.features)
    return (JCache.build(jds.graph, ops, np.asarray(jds.features)),
            PropagationCache.build(ds.graph, ops, feats,
                                   block_rows=block_rows, device="cpu"))


@pytest.mark.parametrize("prefix", sorted(PREFIXES))
def test_propagation_stages_match_jax(data, prefix):
    """Every stage of the prefix walk (SUM, AVG, the fused relu chain)
    within 1e-5 of the JAX host walk's, in one block and in blocks of 64
    rows (many tiles, each tile's sum through K3's plain version)."""
    jds, ds = data
    for block_rows in (65536, 64):
        jc, c = _caches(jds, ds, prefix, block_rows)
        assert len(c.stages) == len(jc.stages) == len(PREFIXES[prefix])
        for got, want in zip(c.stages, jc.stages):
            assert got.dtype == np.float32 and got.shape == want.shape
            _close(got, want)
        assert c.ops == jc.ops


@pytest.mark.parametrize("prefix", sorted(PREFIXES))
def test_add_edges_matches_jax_and_a_rebuild(data, prefix):
    """An edge append recomputes the same affected rows as the JAX cache,
    bit for bit, and leaves a table within 1e-5 of a rebuild on the
    mutated graph (and of JAX's after the same append)."""
    jds, ds = data
    jc, c = _caches(jds, ds, prefix)
    rows = c.add_edges(*EDGES)
    jrows = jc.add_edges(*EDGES)
    assert rows.dtype == jrows.dtype and np.array_equal(rows, jrows)
    assert rows.size < V
    assert np.array_equal(c.row_ptr, jc.row_ptr)
    assert np.array_equal(c.col_idx, jc.col_idx)
    g2 = Graph(row_ptr=c.row_ptr.copy(), col_idx=c.col_idx.copy())
    rebuilt = PropagationCache.build(g2, c.ops, np.asarray(ds.features),
                                     device="cpu")
    for got, want, ref in zip(c.stages, rebuilt.stages, jc.stages):
        _close(got, want)
        _close(got, ref)
    jrebuilt = JCache.build(JGraph(row_ptr=jc.row_ptr.copy(),
                                   col_idx=jc.col_idx.copy()),
                            jc.ops, np.asarray(jds.features))
    _close(rebuilt.table, jrebuilt.table)


def test_logits_table_cache_refuses_add_edges():
    cache = logits_table_cache(np.zeros((4, 2), np.float32))
    assert cache.num_nodes == 4 and cache.table.shape == (4, 2)
    with pytest.raises(NotImplementedError, match="re-export"):
        cache.add_edges([0], [1])


SPEC_FAMILIES = {
    "gcn": ("gcn", {}, [IN, 16, C]),
    "sgc": ("sgc", {"k": 2}, [IN, C]),
    "appnp": ("appnp", {"k": 3, "alpha": 0.2}, [IN, 16, C]),
    "gin_eps": ("gin", {"learn_eps": True}, [IN, 16, C]),
    "gat2": ("gat", {"heads": 2}, [IN, 16, C]),
    "gcn2": ("gcn2", {}, [IN, 16, 16, C]),
    "sage_pool": ("sage", {"aggregator": "pool"}, [IN, 16, C]),
}


@pytest.mark.parametrize("fam", sorted(SPEC_FAMILIES))
def test_model_spec_crosses_both_ways(fam):
    """``to_spec`` of a family built by either package equals the other
    package's (through JSON, as the manifest stores it), and
    ``from_spec`` of either spec rebuilds the same op list in the other
    package, fused or not."""
    name, kw, layers = SPEC_FAMILIES[fam]
    jm = j_model_builders()[name](layers, dropout_rate=0.5, **kw)
    m = model_builders()[name](layers, dropout_rate=0.5, **kw)
    for a, b in ((jm, m), (jm.fuse_norm_aggregate(),
                           m.fuse_norm_aggregate())):
        js = json.loads(json.dumps(a.to_spec()))
        ts = json.loads(json.dumps(b.to_spec()))
        assert ts == js
        assert json.loads(json.dumps(
            builder.Model.from_spec(js).to_spec())) == js
        assert json.loads(json.dumps(
            jbuilder.Model.from_spec(ts).to_spec())) == ts
    # the rebuilt model trains on the same param names
    rebuilt = builder.Model.from_spec(json.loads(json.dumps(m.to_spec())))
    jparams = jm.init_params(jax.random.PRNGKey(0))
    import torch
    assert set(rebuilt.init_params(torch.Generator().manual_seed(0))) == \
        set(jparams)


def test_versioned_publish_keeps_pinned_batches(data):
    """A batch pinned to version k serves k's values bit for bit after an
    invalidation (copy-on-write: the new version's table is a new
    tensor) and after a quant swap (the pinned fp32 version keeps its
    mode); the Server reports each result's version and qmode."""
    _, ds = data
    _, m, _, tp = _pair("akx")
    pred = build_predictor(m, ds, TrainConfig(), params=tp, device="cpu")
    ids = np.arange(V)
    pub0 = pred.published()
    snap0 = pub0.table.clone()
    want0 = pred.query(ids, pub=pub0)
    n = pred.invalidate(*EDGES)
    assert n > 0
    pub1 = pred.published()
    assert pub1.version == 1 and pub1.table is not pub0.table
    assert np.array_equal(pub0.table.numpy(), snap0.numpy())
    assert np.array_equal(pred.query(ids, pub=pub0), want0)
    got1 = pred.query(ids)
    assert not np.array_equal(got1, want0)
    v2 = pred.publish_quant("int8")
    pub2 = pred.published()
    assert (pub2.version, pub2.qmode, v2) == (2, "int8", 2)
    assert str(pub2.table.dtype) == "torch.int8"
    assert np.array_equal(pred.query(ids, pub=pub1), got1)
    assert np.array_equal(pred.query(ids, pub=pub0), want0)
    _close(pred.query(ids), got1, tol=0.02)
    with Server(pred, max_wait_ms=0.5) as srv:
        res = srv.query([1, 2, 3])
    assert (res.version, res.qmode) == (2, "int8")
    # an int8 version refreshes the recomputed rows' codes only
    snap2 = pub2.table.clone()
    rows = pred.invalidate([5, 77], [77, 5])
    pub3 = pred.published()
    assert pub3.qmode == "int8" and rows > 0
    assert np.array_equal(pub2.table.numpy(), snap2.numpy())
    from roc_tpu_torch.serve.quant import quantize_rows
    q, sc = quantize_rows(pred.cache.table, "int8")
    assert np.array_equal(pub3.table[:V].numpy(), q)
    assert np.array_equal(pub3.scale[:V].numpy(), sc)
