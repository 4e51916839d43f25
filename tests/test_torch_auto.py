"""The port's 'auto' route rule, its new routes end to end, and their
edges, against the JAX package on the CPU:

- ``resolve_auto_impl`` and ``resolve_config`` give the JAX package's
  answer ('ell' as the port's 'cuda') on a grid of (V, out_rows, E), the
  block-dense probe included, and a card's row is named in the event;
- three training steps of each new route (sectioned, flat_sum, bdense
  for sums; flat_sum for MAX; attn_flat8 for attention) against the JAX
  ``Trainer`` from the same weights, dropout 0;
- the CLI's ``--impl`` and ``--reorder``;
- a predictor on a layout route serves the trainer's tables and logits;
- the partitioned trainer runs the layouts and 'auto' at a world of one
  as Trainer does, and refuses 'attn_flat8' for a model without
  attention (tests/test_torch_layouts_parts.py holds them at P > 1).
"""

import json

import numpy as np
import pytest

import torch
import torch.distributed as dist

from roc_tpu.core import ell as jell
from roc_tpu.core import graph as jgraph
from roc_tpu.models import model_builders as j_model_builders
from roc_tpu.train.trainer import TrainConfig as JTrainConfig
from roc_tpu.train.trainer import Trainer as JTrainer
from roc_tpu.train.trainer import resolve_auto_impl_probed as j_probed
from roc_tpu.train.trainer import resolve_config as j_resolve_config
from roc_tpu_torch import convert
from roc_tpu_torch.core import ell as tell
from roc_tpu_torch.core import graph as tgraph
from roc_tpu_torch.models import model_builders
from roc_tpu_torch.obs.events import get_bus
from roc_tpu_torch.parallel.distributed import (DistributedTrainer,
                                                shard_dataset)
from roc_tpu_torch.core.partition import partition_plan
from roc_tpu_torch.serve.export import (build_predictor, export_predictor,
                                        load_predictor)
from roc_tpu_torch.train import cli
from roc_tpu_torch.train.trainer import (TrainConfig, Trainer,
                                         resolve_auto_impl_probed,
                                         resolve_config)

LAYERS = [10, 16, 3]

# family -> (registry name, builder kwargs)
FAMILIES = {"gcn": ("gcn", {}), "gin": ("gin", {}),
            "sage_pool": ("sage", {"aggregator": "pool"}),
            "gat": ("gat", {"heads": 2})}


def _build(builders, fam, dropout=0.0):
    name, kw = FAMILIES[fam]
    return builders()[name](LAYERS, dropout_rate=dropout, **kw)


def _datasets(V=160, deg=6, seed=0):
    return (jgraph.synthetic_dataset(V, deg, in_dim=LAYERS[0],
                                     num_classes=LAYERS[-1], seed=seed),
            tgraph.synthetic_dataset(V, deg, in_dim=LAYERS[0],
                                     num_classes=LAYERS[-1], seed=seed))


class _Events(list):
    """The port bus's records emitted inside the block, through a sink of
    its own."""
    write = list.append

    def __enter__(self):
        get_bus().add_sink(self)
        return self

    def __exit__(self, *exc):
        get_bus().sinks.remove(self)


def _jax_rule(V, out_rows, E):
    return jell.resolve_auto_impl(V, out_rows=out_rows, device_kind="cpu",
                                  num_edges=E)


@pytest.mark.parametrize("V", [1_000, 65_536, 65_537, 232_965, 600_000,
                               600_001, 2_449_029])
@pytest.mark.parametrize("out_rows", [None, 50_000, 600_000, 600_001])
@pytest.mark.parametrize("E", [None, 1_000_000, 19_999_999, 20_000_000,
                               126_000_000])
def test_auto_rule_grid_matches_jax(V, out_rows, E):
    """On the CPU, and on a card without a row, the port's rule is the
    JAX package's (its 'ell' is the port's 'cuda')."""
    want = tell.port_route(_jax_rule(V, out_rows, E))
    assert want == {"ell": "cuda"}.get(_jax_rule(V, out_rows, E),
                                       _jax_rule(V, out_rows, E))
    for kind in (None, "A card without a row"):
        assert tell.resolve_auto_impl(V, out_rows, device_kind=kind,
                                      num_edges=E) == want
    # the H100's row: K4 won every race, so every answer is 'cuda'
    assert tell.resolve_auto_impl(V, out_rows,
                                  device_kind="NVIDIA H100 80GB HBM3",
                                  num_edges=E) == "cuda"


class _Stand:
    """A dataset with a graph of given sizes and no edges to read (the
    probe runs only inside the sectioned window from 5 M edges)."""

    def __init__(self, V, E):
        g = type("G", (), {})()
        g.num_nodes, g.num_edges = V, E
        self.graph = g


# (family, V, E); sums inside the sectioned window from 5 M edges run
# the probe, which reads the edges: test_auto_probe_matches_jax
CONFIG_CASES = [(fam, V, E)
                for V, E in ((1_000, 4_000), (232_965, 4_000_000),
                             (232_965, 111_000_000), (2_449_029, 4_000_000),
                             (2_449_029, 126_000_000))
                for fam in ("gcn", "gin", "sage_pool", "gat")
                if not (fam in ("gcn", "gin") and V == 232_965
                        and E >= 5_000_000)]


@pytest.mark.parametrize("fam,V,E", CONFIG_CASES)
def test_resolve_config_auto_matches_jax(fam, V, E):
    """resolve_config with 'auto' for sums, MAX and attention: the JAX
    pass's route (through convert, 'ell' read as 'cuda' for an 'auto'
    request), and the port's fused model."""
    ds = _Stand(V, E)
    jm, jcfg, _ = j_resolve_config(_build(j_model_builders, fam), ds,
                                   JTrainConfig(aggr_impl="auto",
                                                verbose=False))
    tm, tcfg = resolve_config(_build(model_builders, fam), ds,
                              TrainConfig(aggr_impl="auto", verbose=False))
    want = {"ell": "cuda"}.get(jcfg.aggr_impl, jcfg.aggr_impl)
    assert tcfg.aggr_impl == want
    assert tm.num_fused_aggregates() == jm.num_fused_aggregates()


@pytest.fixture(scope="module")
def probe_graphs():
    """Inside the sectioned window with 5 M edges: the planted
    communities in their order (dense tiles) and shuffled (none)."""
    kw = dict(community_rows=128, seed=1)
    return {sh: tgraph.planted_community_csr(70_000, 5_000_000, shuffle=sh,
                                             **kw) for sh in (False, True)}


@pytest.mark.parametrize("shuffle,want", [(False, "bdense"),
                                          (True, "sectioned")])
def test_auto_probe_matches_jax(probe_graphs, shuffle, want):
    """The block-dense structure probe: the same census decides in both
    packages; on a card with a row the port takes the row's route and
    its event names the JAX rule's answer."""
    g = probe_graphs[shuffle]
    jimpl, _ = j_probed(g)
    assert jimpl == want
    with _Events() as recs:
        assert resolve_auto_impl_probed(g) == want
    ev = [r for r in recs if r.get("cat") == "resolve"][-1]
    assert ev["jax_resolves"] == want and ev["resolved"] == want
    row = tell.CardRow(routes={"sectioned": "cuda", "bdense": "cuda",
                               "flat_sum": "cuda"},
                       source="a test row")
    tell.CARD_ROWS["Test card"] = row
    try:
        with _Events() as recs:
            got = resolve_auto_impl_probed(g, device_kind="Test card")
    finally:
        del tell.CARD_ROWS["Test card"]
    ev = [r for r in recs if r.get("cat") == "resolve"][-1]
    assert got == "cuda" and ev["jax_resolves"] == want
    assert want in ev["msg"] and "a test row" in ev["msg"]


# ------------------------------------------------------------- training

# (family, route, fuse, config): the losses of 3 steps within rtol 1e-4
# (fp32 sums in another order), the weights within rtol 2e-4, atol 1e-5
CASES = [("gcn", "sectioned", "auto", {}),
         ("gcn", "sectioned", "off", {"sect_sub_w": 4, "sect_u16": True}),
         ("gcn", "flat_sum", "auto", {}),
         ("gcn", "flat_sum", "off", {}),
         ("gcn", "bdense", "auto", {"bdense_min_fill": 4}),
         ("gcn", "bdense", "off", {"bdense_min_fill": 4, "bdense_group": 4}),
         ("gin", "flat_sum", "auto", {}),
         ("sage_pool", "flat_sum", "auto", {}),
         ("gat", "attn_flat8", "auto", {})]


@pytest.mark.parametrize("fam,impl,fuse,extra", CASES)
def test_three_steps_match_jax_trainer(fam, impl, fuse, extra):
    jds, tds = _datasets()
    jtr = JTrainer(_build(j_model_builders, fam), jds,
                   JTrainConfig(aggr_impl=impl, aggr_fuse=fuse, epochs=3,
                                eval_every=1, verbose=False, symmetric=True,
                                **extra))
    p0 = {k: np.asarray(v) for k, v in jtr.params.items()}
    jhist = jtr.train()
    tr = Trainer(_build(model_builders, fam), tds,
                 TrainConfig(aggr_impl=impl, aggr_fuse=fuse, epochs=3,
                             eval_every=1, verbose=False, symmetric=True,
                             **extra),
                 params=convert.params_from_jax(p0), device="cpu")
    assert tr.config.aggr_impl == impl
    hist = tr.train()
    np.testing.assert_allclose([m["train_loss"] for m in hist],
                               [m["train_loss"] for m in jhist], rtol=1e-4)
    got = convert.params_to_jax(tr.params)
    for k, v in jtr.params.items():
        np.testing.assert_allclose(got[k], np.asarray(v), rtol=2e-4,
                                   atol=1e-5)
    g = tr.gctx
    if impl == "bdense":
        assert g.bd_a is not None and g.edge_src is None and not g.ell_idx
    if impl == "sectioned" and extra.get("sect_u16"):
        assert g.sect_idx[0].dtype == torch.uint16
        assert g.sect_idx[0].shape[-1] == 4


def test_layout_routes_refuse_what_they_lack():
    """MAX on 'sectioned' or 'bdense' is moved by the resolver, and raises
    when the context is built by hand; 'attn_flat8' is attention-only."""
    _, tds = _datasets()
    tr = Trainer(_build(model_builders, "sage_pool"), tds,
                 TrainConfig(aggr_impl="sectioned", verbose=False),
                 device="cpu")
    assert tr.config.aggr_impl == "ell"
    with pytest.raises(NotImplementedError, match="attention-only"):
        Trainer(_build(model_builders, "gcn"), tds,
                TrainConfig(aggr_impl="attn_flat8", verbose=False),
                device="cpu")
    gctx = Trainer(_build(model_builders, "gcn"), tds,
                   TrainConfig(aggr_impl="bdense", verbose=False),
                   device="cpu").gctx
    with pytest.raises(NotImplementedError, match="MAX"):
        gctx.aggregate(torch.zeros(tds.graph.num_nodes, 4), "max")


# ---------------------------------------------------------------- entry


@pytest.mark.parametrize("impl", ["auto", "sectioned", "flat_sum", "bdense"])
def test_cli_impl_and_reorder(tmp_path, impl):
    """The CLI trains on each new --impl, with --reorder lpa's plan event
    and 'auto''s resolve event in the event log."""
    ev = tmp_path / "ev.jsonl"
    rc = cli.main(["--cpu", "-layers", "16-8-4", "-e", "2", "--eval-every",
                   "1", "--impl", impl, "--reorder", "lpa", "--events",
                   str(ev)])
    assert rc == 0
    recs = [json.loads(line) for line in ev.read_text().splitlines()]
    assert any(r["cat"] == "plan" and r.get("reorder") == "lpa"
               for r in recs)
    if impl == "auto":
        r = [r for r in recs if r["cat"] == "resolve"
             and r.get("requested") == "auto"]
        assert r and r[0]["resolved"] == "cuda" and \
            r[0]["jax_resolves"] == "ell"
    assert [r for r in recs if r["cat"] == "epoch"]
    with pytest.raises(SystemExit):
        cli.parse_args(["--impl", "attn_flat8"])


@pytest.mark.parametrize("impl,extra", [
    ("sectioned", {"sect_sub_w": 4}),
    ("bdense", {"bdense_min_fill": 4, "bdense_group": 2}),
    ("flat_sum", {})])
def test_predictor_serves_the_trainers_tables(tmp_path, impl, extra):
    """A predictor built from a config whose layout fields are not the
    defaults builds the trainer's tables and serves its logits, live
    and loaded from its artifact."""
    _, tds = _datasets()
    cfg = TrainConfig(aggr_impl=impl, verbose=False, symmetric=True,
                      **extra)
    tr = Trainer(_build(model_builders, "gcn", dropout=0.5), tds, cfg,
                 device="cpu")
    tr.train(2)
    pred = build_predictor(_build(model_builders, "gcn", dropout=0.5), tds,
                           cfg, params=tr.params, backend="full",
                           device="cpu")
    for f in ("sect_idx", "sect_sub_dst", "sect_w", "bd_a", "bd_src",
              "bd_dst", "flat8_idx", "flat8_w"):
        a, b = getattr(pred.gctx, f), getattr(tr.gctx, f)
        if isinstance(a, tuple):
            assert len(a) == len(b) and all(torch.equal(x, y)
                                            for x, y in zip(a, b)), f
        else:
            assert (a is None and b is None) or torch.equal(a, b), f
    ids = np.arange(tds.graph.num_nodes)
    want = tr.predict().numpy()
    np.testing.assert_array_equal(pred.query(ids), want)
    export_predictor(pred, str(tmp_path / "art"))
    loaded = load_predictor(str(tmp_path / "art"), dataset=tds, device="cpu")
    for k, v in extra.items():
        assert getattr(loaded.config, k) == v
    np.testing.assert_array_equal(loaded.query(ids), want)


@pytest.fixture
def world_of_one(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("impl", ["auto", "sectioned", "flat_sum", "bdense",
                                  "attn_flat8"])
def test_partitioned_trainer_refuses_layouts(world_of_one, impl):
    """The partitioned trainer has the layouts and 'auto' now (it refused
    them before): at a world of one each resolves to Trainer's route and
    its logits equal Trainer's from the same weights within fp32 rounding
    (the rank's tables index the halo's rows in another order); what it
    still refuses is Trainer's refusal, 'attn_flat8' for a model without
    attention.  shard_dataset builds every layout's tables."""
    _, tds = _datasets()
    cfg = TrainConfig(aggr_impl=impl, verbose=False, symmetric=True)
    plan = partition_plan(tds.graph.row_ptr, 1)
    d = shard_dataset(tds, plan, 0, "cpu", aggr_impl=impl if impl != "auto"
                      else "cuda")
    assert d.feats.shape == (plan.part_nodes, LAYERS[0])
    if impl == "attn_flat8":
        assert d.flat8_idx is not None
        with pytest.raises(NotImplementedError, match="attention-only"):
            DistributedTrainer(_build(model_builders, "gcn"), tds, 1, cfg,
                               device="cpu")
        return
    model = _build(model_builders, "gcn")
    one = Trainer(model, tds, cfg, device="cpu")
    part = DistributedTrainer(model, tds, 1, cfg, params=one.params,
                              device="cpu")
    assert part.config.aggr_impl == one.config.aggr_impl
    want = one.predict()
    np.testing.assert_allclose(part.predict().numpy(), want.numpy(),
                               rtol=0, atol=1e-5 * float(want.abs().max()))
