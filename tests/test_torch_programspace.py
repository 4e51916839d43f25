"""The port's program space and collective lint against the JAX
package's (roc_tpu_torch/analysis/programspace.py, collective_lint.py):
the rules give the JAX package's (rule, key) findings on the same crafted
inputs, the ring tables' halo counts equal JAX's, the serve rigs' slots
and every rig's resolved config are JAX's, the static keys equal the
keys a live run's ObservedStep records, and the route walk lists the
kernel instances the kernel routes call."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import lax

from roc_tpu.analysis import collective_lint as jcl
from roc_tpu.analysis import programspace as jps
from roc_tpu.core.graph import synthetic_dataset as j_synthetic_dataset
from roc_tpu.core.partition import partition_graph as j_partition_graph
from roc_tpu.parallel.ring import build_ring_tables as j_build_ring_tables
from roc_tpu.parallel.ring import ring_hop_perm as j_ring_hop_perm
from roc_tpu_torch.analysis import collective_lint as cl
from roc_tpu_torch.analysis import programspace as ps
from roc_tpu_torch.analysis.driver import (COLLECTIVE_LEVEL,
                                           build_trace_findings)
from roc_tpu_torch.core.graph import synthetic_dataset
from roc_tpu_torch.core.partition import partition_graph
from roc_tpu_torch.kernels import _build
from roc_tpu_torch.models.gcn import build_gcn
from roc_tpu_torch.obs.events import get_bus
from roc_tpu_torch.parallel.ring import build_ring_tables, ring_hop_perm
from roc_tpu_torch.train.trainer import (TrainConfig, Trainer,
                                         resolve_dtypes)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H100 = "NVIDIA H100 80GB HBM3"


def _rk(findings):
    return [(f.rule, f.key) for f in findings]


# --------------------------------------------- the collective rules

def _junit(fn, *args, size=4, axes=None):
    return jcl.CollectiveUnit(
        "fix", jax.make_jaxpr(fn, axis_env=[("parts", size)])(*args),
        axes or {"parts": size})


def _call(kind, rank, size=4, group="parts", **kw):
    return {"kind": kind, "group": group, "members": list(range(size)),
            "rank": rank, "size": size, "shape": [3], "dtype": "float32",
            **kw}


def _shift(rank, to, size=4):
    return _call("ring_shift", rank, size, to=to, frm=None,
                 shift=(to - rank) % size)


def _punit(seqs, size=4, axes=None):
    return cl.CollectiveUnit("fix", seqs, axes or {"parts": size})


def _perm_unit(perm, size=4):
    seqs = {r: [] for r in range(size)}
    for s, d in perm:
        seqs[s].append(_shift(s, d, size))
    return _punit(seqs, size)


@pytest.mark.parametrize("perm", [
    [(0, 1), (1, 0), (2, 3), (3, 2)],      # two disjoint sub-rings
    [(0, 1), (1, 0)],                      # a partial cover
    [(d, s) for s, d in j_ring_hop_perm(4)],   # the reversed ring: clean
])
def test_ring_cycle_rule_matches_jax(perm):
    want = jcl.check_ppermute_cycle(_junit(
        lambda x: lax.ppermute(x, "parts", perm), jnp.ones(3)))
    got = cl.check_ppermute_cycle(_perm_unit(perm))
    assert _rk(got) == _rk(want)
    assert [f.msg.split(": ", 1)[1].split(" —")[0] for f in got] == \
        [f.msg.split(": ", 1)[1].split(" —")[0] for f in want]


@pytest.mark.parametrize("size", [2, 3, 4, 8])
def test_named_ring_schedule_is_one_cycle(size):
    assert ring_hop_perm(size) == j_ring_hop_perm(size)
    assert not cl.check_ppermute_cycle(_perm_unit(ring_hop_perm(size),
                                                  size))


def test_axis_name_rule_matches_jax():
    want = jcl.check_axis_names(jcl.CollectiveUnit(
        "fix", jax.make_jaxpr(lambda x: lax.psum(x, "model"),
                              axis_env=[("model", 2)])(jnp.ones(3)),
        {"parts": 4}))
    got = cl.check_axis_names(_punit(
        {r: [_call("all_reduce", r, group="model", op="sum")]
         for r in range(4)}))
    assert _rk(got) == _rk(want) == [("collective-axis-name",
                                      "axis|psum|model")]
    # the world on a 2-D mesh is no axis of it
    got = cl.check_axis_names(_punit(
        {r: [_call("all_gather", r, group="world")] for r in range(4)},
        axes={"parts": 2, "model": 2}))
    assert _rk(got) == [("collective-axis-name", "axis|all_gather|world")]
    assert not cl.check_axis_names(_punit(
        {r: [_call("all_reduce", r, op="sum")] for r in range(4)}))


def test_order_rule_matches_jax_conditional():
    """Ranks that skip the psum the others issue are JAX's cond whose
    branches disagree (the false branch, branches[0], first); ranks that
    agree are clean."""
    want = jcl.check_conditional_collective(_junit(
        lambda p, x: lax.cond(p, lambda v: lax.psum(v, "parts"),
                              lambda v: v * 2.0, x), True, jnp.ones(3)))
    got = cl.check_conditional_collective(_punit(
        {0: [], 1: [_call("all_reduce", 1, op="sum")],
         2: [_call("all_reduce", 2, op="sum")],
         3: [_call("all_reduce", 3, op="sum")]}))
    assert _rk(got) == _rk(want)
    assert not cl.check_conditional_collective(_punit(
        {r: [_call("all_reduce", r, op="sum")] for r in range(4)}))


def test_order_rule_matches_jax_ring_directions():
    fwd = j_ring_hop_perm(4)
    rev = [(i, (i - 1) % 4) for i in range(4)]
    want = jcl.check_conditional_collective(_junit(
        lambda p, x: lax.cond(p, lambda v: lax.ppermute(v, "parts", fwd),
                              lambda v: lax.ppermute(v, "parts", rev), x),
        True, jnp.ones(3)))
    got = cl.check_conditional_collective(_punit(
        {0: [_shift(0, 3)], 1: [_shift(1, 0)], 2: [_shift(2, 3)],
         3: [_shift(3, 0)]}))
    assert _rk(got) == _rk(want) and len(got) == 1
    assert not cl.check_conditional_collective(_perm_unit(fwd))


@pytest.mark.parametrize("parts", [2, 4])
def test_ring_halo_counts_equal_jax(parts):
    jds = j_synthetic_dataset(num_nodes=96, avg_degree=5, in_dim=8,
                              num_classes=4, seed=3)
    ds = synthetic_dataset(num_nodes=96, avg_degree=5, in_dim=8,
                           num_classes=4, seed=3)
    jpg = j_partition_graph(jds.graph, parts, node_multiple=8)
    pg = partition_graph(ds.graph, parts, node_multiple=8)
    jrt, rt = j_build_ring_tables(jpg), build_ring_tables(pg)
    for got, want in zip(cl.ring_table_halo_counts(pg, rt),
                         jcl.ring_table_halo_counts(jpg, jrt)):
        assert np.array_equal(got, want)
    assert not cl.check_ring_halo("collective:fix", pg, rt)
    # rows collapsed onto one source: both sides of the drifted pair
    src = rt.src.copy()
    ext = np.where(src[0, 1] < pg.part_nodes)[0]
    assert len(ext) > 1
    src[0, 1, ext] = src[0, 1, ext[0]]
    jsrc = jrt.src.copy()
    jsrc[0, 1, ext] = jsrc[0, 1, ext[0]]
    got = cl.check_ring_halo("collective:fix", pg, type(rt)(
        src=src, dst=rt.dst, padding_ratio=rt.padding_ratio))
    want = jcl.check_ring_halo("collective:fix", jpg, type(jrt)(
        src=jsrc, dst=jrt.dst, padding_ratio=jrt.padding_ratio))
    assert _rk(got) == _rk(want) and got


def test_recorded_runs_are_clean_and_caught_when_broken():
    """The CPU rig's recorded runs (P = 4 gather and ring, the 2x2
    mesh) pass every collective rule; a rank that drops its last
    collective, a ring rewired into two cycles and an all-reduce over
    the world on the 2-D mesh each fire."""
    extras = {}
    got = build_trace_findings(select=list(COLLECTIVE_LEVEL)
                               + ["partition-imbalance"], extras=extras)
    assert got == []
    by = {u["unit"]: u for u in extras["collectives"]}
    assert set(by) == {"dist_gather_p4", "dist_ring_p4", "mesh_2x2"}
    assert all(u["ranks"] == 4 and u["calls"] > 0 for u in by.values())
    assert by["mesh_2x2"]["axes"] == {"parts": 2, "model": 2}
    # the broken forms, on a recorded-like ring unit
    ring = {r: [_shift(r, (r + 1) % 4), _call("all_reduce", r, op="sum")]
            for r in range(4)}
    assert not cl.run_collective_lint([_punit(ring)])
    short = {**ring, 3: ring[3][:1]}
    assert _rk(cl.run_collective_lint([_punit(short)]))[0][0] == \
        "collective-conditional"
    two = {r: [_shift(r, r ^ 1), ring[r][1]] for r in range(4)}
    assert ("collective-ppermute-cycle", "ppermute|parts|2 disjoint "
            "cycles") in _rk(cl.run_collective_lint([_punit(two)]))
    world = {r: [_call("all_reduce", r, group="world", op="sum")]
             for r in range(4)}
    assert _rk(cl.check_axis_names(_punit(
        world, axes={"parts": 2, "model": 2}))) == \
        [("collective-axis-name", "axis|psum|world")]


# ------------------------------------------ the program-space rules

def _entries(slot, dims, dtype="float32", spec="-", observed=True):
    leaves = tuple((dtype, tuple(d), spec) for d in dims)
    sig = ";".join(f"{dtype}[{','.join(map(str, d))}]@{spec}"
                   for d in dims)
    return (ps.ProgramEntry(slot=slot, key=f"{slot}||{sig}|donate=",
                            leaves=leaves, observed=observed),
            jps.ProgramEntry(slot=slot, key=f"{slot}|{sig}|donate=",
                             leaves=leaves, observed=observed, eqns=10))


def _spaces(*specs, nm=8, em=128):
    es = [_entries(*s[:2], **s[2]) if len(s) > 2 else _entries(*s)
          for s in specs]
    return (ps.ProgramSpace("fix", [p for p, _ in es], nm, em),
            jps.ProgramSpace("fix", [j for _, j in es], node_multiple=nm,
                             edge_multiple=em))


@pytest.mark.parametrize("specs", [
    (("a", [(250, 48)]), ("b", [(252, 48)])),
    (("a", [(250, 48)]), ("b", [(260, 48)])),
    (("a", [(250, 48)]), ("b", [(252, 48)], {"dtype": "bfloat16"})),
    (("a", [(250, 48)]), ("b", [(252, 48)], {"spec": "parts"})),
    (("a", [(8, 48)]), ("b", [(120, 48)])),
    (("a", [(136, 48)]), ("b", [(240, 48)])),
    (("a", [(256, 48)]), ("b", [(244, 48)])),
    (("a", [(256, 48)], {"observed": False}),
     ("b", [(244, 48)], {"observed": False})),
])
def test_cache_key_drift_matches_jax(specs):
    p, j = _spaces(*specs)
    assert _rk(ps.check_cache_key_drift(p)) == \
        _rk(jps.check_cache_key_drift(j))


@pytest.mark.parametrize("budget", [2, 3, None])
def test_compile_explosion_matches_jax(budget):
    p, j = _spaces(("a", [(8, 8)]), ("b", [(16, 8)]), ("c", [(24, 8)]))
    got = ps.check_compile_explosion(p, budget)
    assert _rk(got) == _rk(jps.check_compile_explosion(j, budget))
    if got:
        assert got[0].detail["programs"] == 3
        assert got[0].detail["budget"] == budget


def test_enumeration_rejects_duplicate_keys():
    e, _ = _entries("a", [(8, 8)])
    dup = ps.ProgramEntry(slot="b", key=e.key, leaves=e.leaves,
                          observed=True)
    with pytest.raises(AssertionError, match="duplicate keys"):
        ps._check_distinct(ps.ProgramSpace("fix", [e, dup]))


def test_rig_sizes_and_grid_are_jax():
    assert (ps._V, ps._DEG, ps._F, ps._C, ps._H) == \
        (jps._V, jps._DEG, jps._F, jps._C, jps._H)
    assert (ps.NODE_MULTIPLE, ps.EDGE_MULTIPLE) == \
        (jps.NODE_MULTIPLE, jps.EDGE_MULTIPLE)
    assert list(ps.rig_configs()) == list(jps.rig_configs())
    assert {n: ps.rig_required_devices(s)
            for n, s in ps.rig_configs().items()} == \
        {n: jps.rig_required_devices(s)
         for n, s in jps.rig_configs().items()}


# ----------------------------------------------- the rigs against JAX

@pytest.fixture(scope="module")
def rig_data():
    return jps.build_rig_dataset(), ps.build_rig_dataset()


def test_resolved_configs_equal_jax(rig_data):
    """Every rig's resolved fields are the JAX package's resolve pass's,
    its route in the port's name."""
    from roc_tpu.train.trainer import resolve_config as j_resolve_config
    from roc_tpu_torch.convert import AGGR_IMPL_FROM_JAX
    jds, ds = rig_data
    for name, spec in ps.rig_configs().items():
        jspec = jps.rig_configs()[name]
        _, jc, _ = j_resolve_config(jspec.model(), jds, jspec.config(),
                                    num_parts=jspec.parts)
        _, cfg = ps.resolved_rig_config(spec, ds)
        got = ps.resolved_of(spec, type("T", (), {"config": cfg}))
        want = {"aggr_impl": AGGR_IMPL_FROM_JAX.get(jc.aggr_impl,
                                                    jc.aggr_impl),
                "halo": jc.halo, "features": jc.features,
                "remat": jc.remat, "partition": jc.partition,
                "parts": jspec.parts}
        assert got == want, name


@pytest.mark.parametrize("name", ["sgc_serve", "sgc_serve_q8"])
def test_serve_slots_equal_jax(rig_data, name):
    jds, ds = rig_data
    want = [e.slot for e in jps.enumerate_programs(
        jps.rig_configs()[name], dataset=jds).entries]
    space = ps.enumerate_programs(ps.rig_configs()[name], dataset=ds)
    assert [e.slot for e in space.entries] == want
    assert not any(e.observed for e in space.entries)


# ------------------------------------------------- static against live

class _Sink(list):
    write = list.append


def _live_keys(tr, epochs=5):
    got = sink = _Sink()
    bus = get_bus()
    bus.add_sink(sink)
    try:
        tr.train(epochs)
    finally:
        bus.sinks.remove(sink)
    return sorted(e["program_key"] for e in got
                  if e.get("cat") == "compile" and "program_key" in e)


@pytest.mark.parametrize("make", [
    "sgc_stream",
    ("gcn", "cuda", "float32"), ("gcn", "cuda_csr", "mixed"),
    ("gcn", "ell", "bfloat16")])
def test_static_keys_equal_the_live_steps(rig_data, make):
    """The enumeration's keys of a single-rank trainer equal the keys its
    ObservedStep events record in a live run (on the CPU no kernel
    launches, so both list none)."""
    _, ds = rig_data
    if make == "sgc_stream":
        spec = ps.rig_configs()[make]
        tr = ps.build_rig_trainer(spec, ds)
        space = ps.enumerate_programs(spec, dataset=ds, trainer=tr)
    else:
        _, impl, mode = make
        dt, cdt = resolve_dtypes(mode)
        spec = ps.RigSpec(
            "gcn", model=lambda: build_gcn([ps._F, ps._H, ps._C]),
            config=lambda: TrainConfig(verbose=False, symmetric=True,
                                       aggr_impl=impl, dtype=dt,
                                       compute_dtype=cdt, eval_every=5))
        tr = ps.build_rig_trainer(spec, ds)
        space = ps.enumerate_programs(spec, dataset=ds, trainer=tr)
    want = sorted(e.key for e in space.entries)
    assert _live_keys(tr) == want
    assert all("||" in k for k in want)     # the CPU launches no kernel


def _planned(fn):
    before = _build.instances_planned()
    fn()
    return _build.instances_since(before, _build.instances_planned())


@pytest.mark.parametrize("impl", ["cuda", "cuda_csr"])
@pytest.mark.parametrize("mode", ["float32", "mixed"])
@pytest.mark.parametrize("features", ["hbm", "host"])
def test_route_walk_lists_the_kernels_the_route_calls(impl, mode,
                                                      features):
    """On the H100's row, the walk's instances of a step equal the
    instances the kernel wrappers stood in for on the CPU (their plain
    versions record them), forward and backward, the masked K1 and the
    streamed tail included."""
    dt, cdt = resolve_dtypes(mode)
    ds = synthetic_dataset(200, 6, in_dim=20, num_classes=4, seed=1)
    tr = Trainer(build_gcn([20, 16, 4]), ds,
                 TrainConfig(verbose=False, aggr_impl=impl, dtype=dt,
                             compute_dtype=cdt, features=features,
                             symmetric=True), device="cpu")
    for slot, run in (("train_step", lambda: tr.step(0.01)),
                      ("eval_step", tr.evaluate)):
        want = list(ps.step_instances(tr, slot, H100))
        assert _planned(run) == want and want, slot
    assert ps.step_instances(tr, "train_step", None) == ()
    sfx = "bf16" if mode == "mixed" else "f32"
    train = ps.step_instances(tr, "train_step", H100)
    assert f"indegree_norm_masked[{sfx}]@16" in train


def test_distributed_rig_keys_are_every_ranks():
    """A partitioned rig's ranks enumerate one key set (the quantized
    plan shapes), the set analysis/driver.py's trace reports for it."""
    from roc_tpu_torch.parallel.distributed import run_ranks
    res = run_ranks(cl.trace_rank_job, 2, rigs=["gin_flat8"])
    assert res[0]["spaces"]["gin_flat8"]["resolved"]["parts"] == 2
    keys = [[e["key"] for e in r["spaces"]["gin_flat8"]["entries"]]
            for r in res]
    assert keys[0] == keys[1] and len(keys[0]) == 2
    assert keys[0][0].startswith("train_step|")


def test_no_jax_in_the_new_modules():
    code = ("import sys\n"
            "import roc_tpu_torch.prewarm, roc_tpu_torch.utils.prewarm\n"
            "import roc_tpu_torch.utils.compile_cache\n"
            "import roc_tpu_torch.analysis.programspace as p\n"
            "import roc_tpu_torch.analysis.collective_lint\n"
            "import roc_tpu_torch.analysis.driver\n"
            "p.rig_configs(); p.build_rig_dataset()\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'roc_tpu')]\n"
            "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=_REPO,
                       capture_output=True, text=True, timeout=120,
                       env=dict(os.environ, PYTHONPATH=_REPO))
    assert r.returncode == 0, r.stderr
