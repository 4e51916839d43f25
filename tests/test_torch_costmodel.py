"""The port's cost model (core/costmodel.py), its default split and its
online rebalancing (parallel/distributed.py ``maybe_rebalance``) against
the JAX package's, on the CPU.

The features, the ridge fit and the searched bounds are numpy in both
packages and equal bit for bit.  Training runs as spawned gloo ranks
(``tests/torch_rank_jobs.py``, the port alone); the JAX package's
DistributedTrainer runs in the pytest process.
"""

import numpy as np
import pytest

from roc_tpu.core import costmodel as jcm
from roc_tpu.core import graph as jgraph
from roc_tpu.core.partition import partition_graph as j_partition_graph
from roc_tpu.models.gcn import build_gcn as j_build_gcn
from roc_tpu.parallel.distributed import DistributedTrainer as JDist
from roc_tpu.train.trainer import TrainConfig as JTrainConfig
from roc_tpu_torch.core import costmodel as tcm
from roc_tpu_torch.core import graph as tgraph
from roc_tpu_torch.core.partition import partition_graph, partition_plan
from roc_tpu_torch.models.gcn import build_gcn
from roc_tpu_torch.parallel.distributed import run_ranks
from roc_tpu_torch.train import cli
from roc_tpu_torch.train.trainer import TrainConfig, resolve_partition

import torch_rank_jobs

LAYERS = [12, 16, 3]


def _graph(name):
    if name == "zipf":
        g = tgraph.zipf_csr(300, 3000, seed=0)
    else:
        g = tgraph.synthetic_graph(200, 6, seed=2)
    return g, jgraph.Graph(row_ptr=g.row_ptr.copy(), col_idx=g.col_idx.copy())


def _datasets(seed=0):
    """The skewed graph of :func:`_graph` ('zipf': not symmetric, so the
    runs take the plain 'ell' route by autograd) with features, labels and
    masks from a seed."""
    g, jg = _graph("zipf")
    rng = np.random.RandomState(seed)
    V = g.num_nodes
    feats = rng.randn(V, LAYERS[0]).astype(np.float32)
    labels = rng.randint(0, LAYERS[-1], V).astype(np.int32)
    mask = rng.randint(0, 4, V).astype(np.int32)
    return (jgraph.Dataset(jg, feats, labels, mask, LAYERS[-1]),
            tgraph.Dataset(g, feats, labels, mask, LAYERS[-1]))


@pytest.mark.parametrize("name", ["synthetic", "zipf"])
@pytest.mark.parametrize("P", [2, 3, 4])
def test_features_and_bounds_match_jax(name, P):
    """φ (from the plan's columns, and read from the global CSR for a
    plan without them), the halo counts, the split record, the searched
    bounds under the prior and under other weights, and their modeled
    costs: the JAX package's, exactly."""
    g, jg = _graph(name)
    tpg = partition_graph(g, P, edge_multiple=64)
    jpg = j_partition_graph(jg, P, edge_multiple=64)
    occ = [{"n_blocks": 3 * p} for p in range(P)]
    for kw in (dict(), dict(attn_edges=True, flat8=True)):
        want = jcm.phi_matrix(jpg, bd_occupancy=occ, **kw)
        np.testing.assert_array_equal(
            tcm.phi_matrix(tpg, bd_occupancy=occ, **kw), want)
        plan = partition_plan(g.row_ptr, P, edge_multiple=64)
        np.testing.assert_array_equal(tcm.phi_matrix(
            plan, bd_occupancy=occ, col_slice=lambda a, b: g.col_idx[a:b],
            **kw), want)
    for a, b in zip(tcm.partition_halo_stats(tpg),
                    jcm.partition_halo_stats(jpg)):
        np.testing.assert_array_equal(a, b)
    assert tcm.partition_static_stats(tpg) == \
        jcm.partition_static_stats(jpg)
    for w in (None, (4e-5, 1.4e-5), (0.0, 1e-5), (1e-3, 0.0)):
        got = tcm.cost_balanced_bounds(g.row_ptr, P, 8, 64, weights=w)
        assert [tuple(map(int, b)) for b in got] == [
            tuple(map(int, b)) for b in jcm.cost_balanced_bounds(
                jg.row_ptr, P, 8, 64, weights=w)]
        ww = w or (2.5e-6, 1e-5)
        assert tcm.bounds_max_cost(g.row_ptr, got, *ww, 8, 64) == \
            jcm.bounds_max_cost(jg.row_ptr, got, *ww, 8, 64)


def test_ridge_fit_matches_jax():
    """The online ridge model: the prior with no observation, then the
    weights, predictions and search weights after each observation,
    bit for bit."""
    g, jg = _graph("zipf")
    phi = tcm.phi_matrix(partition_graph(g, 4, edge_multiple=64),
                         attn_edges=True, flat8=True)
    t, j = tcm.PartitionCostModel(8, 64), jcm.PartitionCostModel(8, 64)
    assert t.search_weights() == j.search_weights()
    for i, ms in enumerate((3.5, 50.0, 0.2, 700.0, -5.0)):
        t.observe(phi[i % 4], ms)
        j.observe(phi[i % 4], ms)
        np.testing.assert_array_equal(t.weights_raw(), j.weights_raw())
        np.testing.assert_array_equal(t.predict(phi), j.predict(phi))
        for kw in (dict(), dict(attn_edges=True), dict(flat8=True)):
            assert t.search_weights(**kw) == j.search_weights(**kw)
    assert t.n_obs == j.n_obs == 5


def _jax_trainer(jds, P, **kw):
    return JDist(j_build_gcn(LAYERS, dropout_rate=0.0), jds, P,
                 JTrainConfig(aggr_impl="ell", dropout_rate=0.0,
                              verbose=False, epochs=4, eval_every=1,
                              chunk=64, weight_decay=1e-3, **kw))


def _config(**kw):
    return TrainConfig(aggr_impl="ell", dropout_rate=0.0, verbose=False,
                       epochs=4, eval_every=1, chunk=64, weight_decay=1e-3,
                       **kw)


# one made-up epoch time, attributed to the predicted-slowest part, moves
# the split on this graph at both P (JAX's decision below)
FORCED_MS = 500.0


@pytest.mark.parametrize("P", [2, 4])
def test_default_split_and_rebalance_match_jax(P):
    """The repair: DistributedTrainer's default split is JAX
    DistributedTrainer's ('auto' is the cost model's), not the greedy
    sweep's.  Then a forced rebalance (an epoch time of FORCED_MS fed to
    ``maybe_rebalance``, threshold 1e-9) moves to JAX's new bounds and
    stops at ``rebalance_max`` = 1 (the hysteresis cap: a second record
    is refused), and training after it leaves the weights within 1e-5 of
    the run that never repartitions (full-batch training does not
    depend on the split; fp32 sums in another order)."""
    jds, tds = _datasets()
    jtr = _jax_trainer(jds, P, rebalance=True, rebalance_gain=1e-9,
                       rebalance_max=1)
    jbounds = [tuple(map(int, b)) for b in jtr.pg.bounds]
    greedy = [tuple(map(int, b)) for b in j_partition_graph(
        jds.graph, P, edge_multiple=64).bounds]
    assert jbounds != greedy
    jstats = dict(jtr._partition_stats)
    assert jtr.maybe_rebalance({"epoch_ms": FORCED_MS, "epoch": 0})
    jnew = [tuple(map(int, b)) for b in jtr.pg.bounds]
    assert jnew != jbounds
    p0 = {k: np.asarray(v) for k, v in jtr.params.items()}
    from roc_tpu_torch import convert
    params = convert.params_from_jax(p0)
    runs = [dict(model=build_gcn(LAYERS, dropout_rate=0.0), dataset=tds,
                 config=_config(), params=params),
            dict(model=build_gcn(LAYERS, dropout_rate=0.0), dataset=tds,
                 config=_config(rebalance=True, rebalance_gain=1e-9,
                                rebalance_max=1, partition="cost"),
                 params=params, force=(FORCED_MS, FORCED_MS))]
    res = run_ranks(torch_rank_jobs.job, P, runs=runs, device="cpu")
    never, rebal = res[0]
    assert never["bounds"] == never["final_bounds"] == jbounds
    assert rebal["bounds"] == jbounds
    assert rebal["forced"] == [True, False] and rebal["rebalances"] == 1
    assert rebal["final_bounds"] == jnew
    for rank_runs in res[1:]:
        assert rank_runs[1]["final_bounds"] == jnew
    for k in never["params"]:
        np.testing.assert_allclose(rebal["params"][k], never["params"][k],
                                   rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(rebal["losses"], never["losses"], rtol=1e-5)
    (rep,) = [e for e in rebal["events"] if e["cat"] == "costmodel"
              and "rebalance" in e]
    assert (rep["rebalance"], rep["part_edges"], rep["part_nodes"]) == \
        (1, jtr.pg.part_edges, jtr.pg.part_nodes)
    # the split record of the start, the JAX trainer's
    (stats,) = [e for e in never["events"] if e["cat"] == "costmodel"
                and e.get("method") == "cost"]
    assert {k: stats[k] for k in jstats} == jstats
    # the eval records carry the predicted straggler, as JAX's do
    assert {"straggler_part", "straggler_ratio"} <= set(
        never["history"][-1])


def test_partition_option_and_cli_checks(capsys):
    """``partition`` resolves as the JAX package's ('auto' is 'cost', an
    unknown method raises); the CLI's ``--rebalance`` and ``--halo ring``
    without ``--parts`` > 1 exit 2 with the JAX CLI's reasons."""
    assert [resolve_partition(TrainConfig(partition=p))
            for p in ("auto", "cost", "greedy")] == ["cost", "cost",
                                                     "greedy"]
    with pytest.raises(ValueError, match="unknown partition"):
        resolve_partition(TrainConfig(partition="metis"))
    assert cli.main(["--cpu", "-e", "1", "--rebalance"]) == 2
    assert "--rebalance requires --parts > 1" in capsys.readouterr().err
    assert cli.main(["--cpu", "-e", "1", "--halo", "ring"]) == 2
    assert "--halo ring requires --parts > 1" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        cli.main(["--cpu", "--partition", "metis"])
