"""The partitioned layouts of the port (core/ell.py's padded-part
builders; parallel/distributed.py ``shard_dataset``'s 'sectioned',
'flat_sum', 'attn_flat8' and 'bdense' branches; 'auto' with a part's
rows) against the JAX package, on the CPU.

The builders are compared bit for bit, each rank's own build (its part
and the agreed shapes) against its row of the JAX package's stacked
tables.  Training runs as spawned gloo ranks (``tests/torch_rank_jobs.py``,
the port alone) against JAX DistributedTrainer on the same route.
"""

import numpy as np
import pytest

from roc_tpu.core import ell as jell
from roc_tpu.core import graph as jgraph
from roc_tpu.core.partition import partition_graph as j_partition_graph
from roc_tpu.models.gat import build_gat as j_build_gat
from roc_tpu.models.gcn import build_gcn as j_build_gcn
from roc_tpu.parallel.distributed import DistributedTrainer as JDist
from roc_tpu.parallel.distributed import remap_to_padded as j_remap
from roc_tpu.train.trainer import TrainConfig as JTrainConfig
from roc_tpu.train.trainer import resolve_config as j_resolve_config
from roc_tpu_torch import convert
from roc_tpu_torch.core import ell as tell
from roc_tpu_torch.core import graph as tgraph
from roc_tpu_torch.core.partition import partition_graph
from roc_tpu_torch.models.gat import build_gat
from roc_tpu_torch.models.gcn import build_gcn
from roc_tpu_torch.ops.norm import inv_sqrt_degree_np
from roc_tpu_torch.parallel.distributed import remap_to_padded, run_ranks
from roc_tpu_torch.train.trainer import (TrainConfig,
                                         resolve_auto_impl_probed,
                                         resolve_config)

import torch_rank_jobs
from test_torch_ring import _agreeing

LAYERS = [12, 16, 3]
EPOCHS = 5
H100 = "NVIDIA H100 80GB HBM3"
# tests/test_torch_distributed.py's fp32 tolerances (the layouts sum in
# another order than the JAX package's scans)
PARAM_TOL = dict(rtol=2e-4, atol=2e-5)
CURVE_RTOL = 1e-4


def _graph(name="planted"):
    """A symmetric graph with self edges whose communities give
    block-dense tiles (``planted_community_csr``, in its oracle order), or
    a random one, as port and JAX graphs of the same arrays."""
    if name == "planted":
        g0 = tgraph.planted_community_csr(400, 5000, community_rows=128,
                                          seed=2, shuffle=False)
    else:
        g0 = tgraph.random_csr(300, 2500, seed=4)
    dst = np.repeat(np.arange(g0.num_nodes), np.diff(g0.row_ptr))
    g = tgraph.add_self_edges(tgraph.from_edge_list(
        g0.col_idx, dst, g0.num_nodes, symmetrize=True))
    return g, jgraph.Graph(row_ptr=g.row_ptr.copy(), col_idx=g.col_idx.copy())


def _same(j, t):
    assert (j.num_rows, j.src_rows, j.section_rows, j.seg_rows, j.sub_w) \
        == (t.num_rows, t.src_rows, t.section_rows, t.seg_rows, t.sub_w)
    assert tuple(j.sec_starts) == t.sec_starts
    assert tuple(j.sec_sizes) == t.sec_sizes
    for a, b in zip(j.idx + j.sub_dst, t.idx + t.sub_dst):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["planted", "random"])
@pytest.mark.parametrize("P", [2, 3, 4])
def test_padded_part_builders_bit_equal_jax(name, P):
    """``clean_part_ptr``, ``sectioned_from_padded_parts`` (several
    sections, sub-row widths 8 and 4) and ``flat_sum_from_padded_parts``
    over every part equal the JAX package's bit for bit, their fused
    weight tables too; each rank's build of its own part with the agreed
    chunk plan is its row of them."""
    g, jg = _graph(name)
    tpg = partition_graph(g, P, edge_multiple=64)
    jpg = j_partition_graph(jg, P, edge_multiple=64)
    tcol, jcol = remap_to_padded(tpg), j_remap(jpg)
    np.testing.assert_array_equal(tcol, jcol)
    src_rows = P * tpg.part_nodes
    for p in range(P):
        np.testing.assert_array_equal(
            tell.clean_part_ptr(tpg.part_row_ptr[p], tpg.real_nodes[p],
                                tpg.part_nodes),
            jell.clean_part_ptr(jpg.part_row_ptr[p], jpg.real_nodes[p],
                                jpg.part_nodes))
    d = inv_sqrt_degree_np(tpg.part_in_degree)
    for kw in (dict(section_rows=64, sub_w=8), dict(section_rows=100,
                                                    seg_rows=16, sub_w=4)):
        j = jell.sectioned_from_padded_parts(
            jpg.part_row_ptr, jcol, jpg.real_nodes, jpg.part_nodes,
            src_rows=src_rows, **kw)
        t = tell.sectioned_from_padded_parts(
            tpg.part_row_ptr, tcol, tpg.real_nodes, tpg.part_nodes,
            src_rows=src_rows, **kw)
        assert len(t.idx) > 1
        _same(j, t)
        for a, b in zip(j.weight_tables(d, d.reshape(-1)),
                        t.weight_tables(d, d.reshape(-1))):
            np.testing.assert_array_equal(a, b)
        mine = _agreeing(P, lambda p, agree: tell.sectioned_from_padded_parts(
            tpg.part_row_ptr[p:p + 1], tcol[p:p + 1], tpg.real_nodes[p:p + 1],
            tpg.part_nodes, src_rows=src_rows, agree_max=agree, **kw))
        for p, part in enumerate(mine):
            assert part.seg_rows == t.seg_rows
            for a, b in zip(part.idx + part.sub_dst, t.idx + t.sub_dst):
                np.testing.assert_array_equal(a[0], b[p])
    _same(jell.flat_sum_from_padded_parts(jpg.part_row_ptr, jcol,
                                          jpg.real_nodes, jpg.part_nodes,
                                          src_rows=src_rows),
          tell.flat_sum_from_padded_parts(tpg.part_row_ptr, tcol,
                                          tpg.real_nodes, tpg.part_nodes,
                                          src_rows=src_rows))


def _datasets(name="planted", seed=0):
    g, jg = _graph(name)
    rng = np.random.RandomState(seed)
    V = g.num_nodes
    feats = rng.randn(V, LAYERS[0]).astype(np.float32)
    labels = rng.randint(0, LAYERS[-1], V).astype(np.int32)
    mask = rng.randint(0, 4, V).astype(np.int32)
    return (jgraph.Dataset(jg, feats, labels, mask, LAYERS[-1]),
            tgraph.Dataset(g, feats, labels, mask, LAYERS[-1]))


# (route, family, the layout's TrainConfig knobs): the GCN's fused chain
# reads each sum layout's baked weights; GAT 2 heads on 'attn_flat8'
CASES = [("sectioned", "gcn", dict(sect_sub_w=4, sect_u16=True)),
         ("flat_sum", "gcn", {}),
         ("bdense", "gcn", dict(bdense_min_fill=200, bdense_a_budget=None)),
         ("attn_flat8", "gat", {})]


def _models(fam):
    if fam == "gat":
        return (j_build_gat(LAYERS, heads=2, dropout_rate=0.0),
                build_gat(LAYERS, heads=2, dropout_rate=0.0))
    return (j_build_gcn(LAYERS, dropout_rate=0.0),
            build_gcn(LAYERS, dropout_rate=0.0))


def test_layout_training_at_p2_matches_jax():
    """Two gloo ranks, 5 epochs from the JAX run's weights, dropout 0, on
    each layout against JAX DistributedTrainer on the same route: the
    bounds, the train loss curve and counts, the weights and the logits
    (fp32, the layouts' summation order differs); the block-dense plan
    has dense tiles and a residual on each rank; 'auto' resolves to
    'cuda' here (the JAX rule's 'ell') and trains as 'cuda' does, bit for
    bit."""
    jds, tds = _datasets()
    refs, runs = [], []
    for impl, fam, kw in CASES:
        jm, tm = _models(fam)
        jtr = JDist(jm, jds, 2, JTrainConfig(
            aggr_impl=impl, dropout_rate=0.0, verbose=False, epochs=EPOCHS,
            eval_every=1, chunk=64, weight_decay=1e-3, **kw))
        p0 = {k: np.asarray(v) for k, v in jtr.params.items()}
        bounds = [tuple(map(int, b)) for b in jtr.pg.bounds]
        hist = jtr.train()
        refs.append((bounds, hist, {k: np.asarray(v, np.float32)
                                    for k, v in jtr.params.items()},
                     np.asarray(jtr.predict()).astype(np.float32)))
        runs.append(dict(model=tm, dataset=tds, config=TrainConfig(
            aggr_impl=impl, dropout_rate=0.0, verbose=False, epochs=EPOCHS,
            eval_every=1, chunk=64, weight_decay=1e-3, **kw),
            params=convert.params_from_jax(p0)))
    for impl in ("auto", "cuda"):
        runs.append(dict(model=build_gcn(LAYERS, dropout_rate=0.0),
                         dataset=tds, config=TrainConfig(
                             aggr_impl=impl, dropout_rate=0.0, verbose=False,
                             epochs=2, eval_every=1, chunk=64),
                         params=runs[0]["params"]))
    res = run_ranks(torch_rank_jobs.job, 2, runs=runs, device="cpu")
    for r, (impl, _, _), (bounds, hist, params, logits) in zip(res[0], CASES,
                                                               refs):
        assert r["config"]["aggr_impl"] == impl
        assert r["bounds"] == bounds
        np.testing.assert_allclose([m["train_loss"] for m in r["history"]],
                                   [m["train_loss"] for m in hist],
                                   rtol=CURVE_RTOL)
        for k in ("train_cnt", "val_cnt", "test_cnt"):
            assert [m[k] for m in r["history"]] == [m[k] for m in hist]
        for k in params:
            np.testing.assert_allclose(r["params"][k], params[k],
                                       **PARAM_TOL)
        np.testing.assert_allclose(r["logits"], logits, rtol=0,
                                   atol=1e-4 * np.abs(logits).max())
    for rank_runs in res:
        (plan,) = [e for e in rank_runs[2]["events"]
                   if e["cat"] == "plan" and e.get("part") is not None]
        assert plan["n_blocks"] > 0 and 0 < plan["dense_frac"] < 1
    auto, cuda = res[0][4:]
    assert auto["config"]["aggr_impl"] == "cuda"
    np.testing.assert_array_equal(auto["losses"], cuda["losses"])


@pytest.mark.parametrize("P", [1, 2, 4])
def test_partitioned_auto_resolves_as_jax(P):
    """'auto' with a part's rows through both resolve passes: the JAX
    rule's answer through this card's row ('ell' is the port's 'cuda'),
    inside and outside the sectioned window (its upper bound reads a
    part's rows: at V = 650,000 one part is past it and two are not); on
    the H100's row every answer is 'cuda', and the
    event names the JAX rule's."""
    for V in (300, 70_000, 650_000):
        g = tgraph.synthetic_graph(V, 2, seed=1)
        tds = tgraph.Dataset(g, np.zeros((V, 4), np.float32),
                             np.zeros(V, np.int32), np.zeros(V, np.int32), 2)
        jds = jgraph.Dataset(jgraph.Graph(row_ptr=g.row_ptr,
                                          col_idx=g.col_idx),
                             tds.features, tds.labels, tds.mask, 2)
        _, jcfg, _ = j_resolve_config(
            j_build_gcn([4, 2]), jds, JTrainConfig(aggr_impl="auto",
                                                   verbose=False),
            num_parts=P)
        _, cfg = resolve_config(build_gcn([4, 2]), tds, TrainConfig(
            aggr_impl="auto", verbose=False), device="cpu", num_parts=P)
        assert cfg.aggr_impl == tell.port_route(jcfg.aggr_impl)
        out_rows = -(-V // P) if P > 1 else None
        assert resolve_auto_impl_probed(g, out_rows=out_rows,
                                        device_kind=H100) == "cuda"
        assert tell.jax_auto_impl(V, out_rows, g.num_edges) == \
            jcfg.aggr_impl
