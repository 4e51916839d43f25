"""The port's recorded-step lint against the JAX package's jaxpr and HLO
levels (roc_tpu_torch/analysis/step_trace.py, jaxpr_lint.py,
hlo_lint.py): each rule fires with the JAX package's (rule, key) on the
same seeded defect (JAX through ``jax.make_jaxpr`` or HLO text, the port
through the recorder), the port's seven units on the mixed GCN rig raise
nothing the JAX package's single-device units do not, and a recorded CPU
step holds one opaque entry per kernel call, no upcast of the kernels'
plain versions, and the unrecorded step's objective bit for bit."""

import collections
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from roc_tpu.analysis import driver as jdriver
from roc_tpu.analysis.hlo_lint import check_bytes_model as j_bytes_model
from roc_tpu.analysis.hlo_lint import check_large_copy as j_large_copy
from roc_tpu.analysis.jaxpr_lint import JaxprUnit, run_jaxpr_lint as j_run
from roc_tpu_torch.analysis import driver
from roc_tpu_torch.analysis.hlo_lint import check_bytes_model, \
    check_large_copy
from roc_tpu_torch.analysis.jaxpr_lint import (JAXPR_RULES, StepUnit,
                                               check_host_callback,
                                               run_jaxpr_lint)
from roc_tpu_torch.analysis.programspace import (_C, _F, _H, _V,
                                                 build_rig_dataset)
from roc_tpu_torch.analysis.step_trace import record
from roc_tpu_torch.kernels import _build
from roc_tpu_torch.kernels.graphnorm import scale_act
from roc_tpu_torch.models.gcn import build_gcn
from roc_tpu_torch.parallel.distributed import Collectives
from roc_tpu_torch.train.trainer import (TrainConfig, Trainer,
                                         resolve_dtypes)


def _rk(findings):
    return sorted((f.rule, f.key) for f in findings)


def _junit(fn, *args, **ctx):
    ctx.setdefault("num_nodes", 64)
    ctx.setdefault("vf_elems", 64 * 16)
    return JaxprUnit("fix", jax.make_jaxpr(fn)(*args), **ctx)


def _punit(trace, **ctx):
    ctx.setdefault("num_nodes", 64)
    ctx.setdefault("vf_elems", 64 * 16)
    return StepUnit("fix", trace, **ctx)


def _both(rule, jfn, jargs, pfn, pargs=(), args_of=None, jctx=None,
          pctx=None):
    j = j_run([_junit(jfn, *jargs, **(jctx or {}))], select=[rule])
    p = run_jaxpr_lint([_punit(record(pfn, *pargs, args_of=args_of),
                               **(pctx or {}))], select=[rule])
    return _rk(j), _rk(p)


# ------------------------------------------------- each rule, both packages

@pytest.mark.parametrize("shape,compute,fires", [
    ((64, 16), "bfloat16", True),     # [V, F]-scale in a bf16 path
    ((64, 4), "bfloat16", False),     # class width stays sanctioned
    ((64, 16), "float32", False),     # an fp32 path never arms it
])
def test_f32_upcast_matches_jax(shape, compute, fires):
    xj = jnp.ones(shape, jnp.bfloat16)
    xt = torch.ones(shape, dtype=torch.bfloat16)
    j, p = _both("jaxpr-f32-upcast",
                 lambda a: a.astype(jnp.float32) * 2.0, (xj,),
                 lambda: xt.to(torch.float32) * 2.0,
                 jctx={"compute_dtype": compute},
                 pctx={"compute_dtype": compute})
    assert j == p
    assert bool(p) == fires
    if fires:
        assert p == [("jaxpr-f32-upcast", f"upcast|bfloat16{list(shape)}")]


def test_host_callback_matches_jax():
    """A value read back to the host inside the step: JAX's
    ``pure_callback``, the port's ``.item()`` (``_local_scalar_dense``)
    and ``nonzero`` (its output size is the data's)."""
    def jf(x):
        y = jax.pure_callback(lambda v: np.asarray(v * 2),
                              jax.ShapeDtypeStruct((), jnp.float32),
                              x.sum())
        return x * y

    xt = torch.ones(8)
    j, p = _both("jaxpr-host-callback", jf, (jnp.ones(8),),
                 lambda: xt * xt.sum().item())
    assert j == p == [("jaxpr-host-callback", "callback|pure_callback")]
    trace = record(lambda: (xt > 0).nonzero())
    assert _rk(check_host_callback(_punit(trace))) == p
    # a copy to the CPU is a sync only from a card: none on the CPU rig
    assert not check_host_callback(_punit(record(lambda: xt.cpu() + 1)))


def test_non_donated_matches_jax():
    """A donated buffer the step replaces instead of updating in place
    (JAX: an update-shaped output of an undonated argument)."""
    big_j, other_j = jnp.ones((256, 64)), jnp.ones((128, 32))
    j = j_run([_junit(jax.jit(lambda a, b: (a + 1.0, b.sum())), big_j,
                      other_j, donate_min_bytes=1024)],
              select=["jaxpr-non-donated"])
    state = {"a": torch.ones(256, 64)}
    other = torch.ones(128, 32)

    def replace():
        state["a"] = state["a"] + 1.0

    def in_place():
        state["a"].add_(1.0)

    def unit(fn):
        return _punit(record(fn, args_of=lambda: (state["a"], other)),
                      donate=(0,), donate_min_bytes=1024)

    p = run_jaxpr_lint([unit(replace)], select=["jaxpr-non-donated"])
    assert _rk(p) == [("jaxpr-non-donated",
                       "nondonated|0|float32[256, 64]")]
    # the JAX rule judges the top-level 'pjit' eqn; a JAX that names it
    # 'jit' (0.9) gives the rule nothing to judge, so its side is held
    # only where it runs
    top = jax.make_jaxpr(jax.jit(lambda a: a))(big_j).jaxpr.eqns
    if top[0].primitive.name == "pjit":
        assert _rk(j) == _rk(p)
    assert not run_jaxpr_lint([unit(in_place)],
                              select=["jaxpr-non-donated"])
    # read but never written: still a finding
    p2 = run_jaxpr_lint([unit(lambda: state["a"].sum())],
                        select=["jaxpr-non-donated"])
    assert _rk(p2) == _rk(p)


@pytest.fixture
def world_of_one(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/st",
                            rank=0, world_size=1)
    try:
        yield Collectives(None, name="parts")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("halo", ["gather", "ring"])
def test_collective_materialize_matches_jax(world_of_one, halo):
    """The JAX package's fixture: a shard_map body that gathers the
    whole [V, F] and sums it over the parts; the port's same collectives
    recorded on a world of one (the rule reads the gathered shape)."""
    from jax.sharding import Mesh, PartitionSpec as P
    from roc_tpu.parallel.distributed import _shard_map
    mesh = Mesh(np.asarray(jax.devices()), ("parts",))
    parts = len(jax.devices())

    def body(xb):
        full = jax.lax.all_gather(xb, "parts", axis=0, tiled=True)
        return jax.lax.psum(full, "parts")

    sm = _shard_map(body, mesh, P("parts"), P())
    per_dev = (64 * 16) // parts
    ctx = {"halo": halo, "vf_elems": per_dev, "mesh_parts": parts}
    j = j_run([_junit(jax.jit(sm), jnp.ones((64, 16)), **ctx)],
              select=["jaxpr-collective-materialize"])
    comm = world_of_one
    x = torch.ones(64, 16)
    trace = record(lambda: comm.all_reduce(comm.all_gather(x)))
    p = run_jaxpr_lint([_punit(trace, **ctx)],
                       select=["jaxpr-collective-materialize"])
    assert _rk(j) == _rk(p)
    assert ("jaxpr-collective-materialize", "psum|float32[64, 16]") in \
        _rk(p)
    assert len(p) == (2 if halo == "ring" else 1)


def test_recording_nests_in_the_collective_lints(world_of_one):
    """A recording inside ``record_collectives`` leaves the outer
    record every call (the trace stage records both at once)."""
    from roc_tpu_torch.parallel.distributed import record_collectives
    x = torch.ones(4, 3)
    with record_collectives() as outer:
        t = record(lambda: world_of_one.all_reduce(x.clone()))
    assert [c["kind"] for c in outer] == ["all_reduce"]
    assert t.collectives == outer


def test_int32_overflow_matches_jax():
    """``i * 70000 + i`` in int32 with node ids bounded at Reddit's V:
    both the product and the sum overflow; the iota fixture too."""
    bound = 232_965
    j, p = _both("jaxpr-int32-overflow",
                 lambda i: i * 70000 + i, (jnp.arange(256, dtype=jnp.int32),),
                 lambda i: i * 70000 + i,
                 (torch.arange(256, dtype=torch.int32),),
                 jctx={"index_bound": bound}, pctx={"index_bound": bound})
    assert j == p == [
        ("jaxpr-int32-overflow", "overflow|add|int32|int32[256]"),
        ("jaxpr-int32-overflow", "overflow|mul|int32|int32[256]")]
    j, p = _both("jaxpr-int32-overflow",
                 lambda: jax.lax.iota(jnp.int32, 1 << 16)
                 * jnp.int32(1 << 16), (),
                 lambda: torch.arange(1 << 16, dtype=torch.int32)
                 * (1 << 16))
    assert j == p and len(p) == 1
    # within range: silent in both
    j, p = _both("jaxpr-int32-overflow",
                 lambda: jax.lax.iota(jnp.int32, 1 << 16) * jnp.int32(4),
                 (), lambda: torch.arange(1 << 16, dtype=torch.int32) * 4)
    assert j == p == []
    # a narrowing cast of an overflowing int64 bound
    n = torch.arange(256, dtype=torch.int64)
    got = run_jaxpr_lint([_punit(record(lambda: (n * 10 ** 8).to(
        torch.int32)))], select=["jaxpr-int32-overflow"])
    assert _rk(got) == [("jaxpr-int32-overflow",
                         "narrow|int32|int32[256]")]


def test_large_copy_matches_jax_hlo():
    """The JAX package's HLO fixture (an un-fused transpose and copy of a
    [512, 128] f32, a fused copy and a tiny transpose left alone) and the
    port's eager counterparts: a clone, a transpose made contiguous,
    small copies silent."""
    hlo = ("ENTRY %main.1 (p0: f32[512,128]) -> f32[512,128] {\n"
           "  %big = f32[512,128]{0,1} transpose(f32[512,128]{1,0} %p0)\n"
           "  %tiny = f32[8,4]{0,1} transpose(f32[4,8]{1,0} %q)\n"
           "  ROOT %r = f32[512,128]{1,0} copy(f32[512,128]{0,1} %big)\n"
           "}\n")
    j = j_large_copy("hlo:fix", hlo, copy_min_elems=512 * 128)
    x = torch.ones(512, 128)
    y = torch.ones(128, 512)
    small = torch.ones(4, 8)
    trace = record(lambda: (x.clone(), y.t().contiguous(),
                            small.t().contiguous(),
                            torch.empty_like(x).copy_(x) * 1.0))
    p = check_large_copy("hlo:fix", trace, 512 * 128)
    assert sorted(set(_rk(p))) == sorted(_rk(j)) == [
        ("hlo-large-copy", "copy|f32[512,128]"),
        ("hlo-large-copy", "transpose|f32[512,128]")]
    # an update in place into a live buffer is no copy
    assert not check_large_copy("hlo:fix", record(lambda: x.copy_(x * 2)),
                                512 * 128)


@pytest.mark.parametrize("got,modeled", [(1e9, 1000), (3.1e4, 1000),
                                         (None, 1000), (1e9, None)])
def test_bytes_model_matches_jax(got, modeled):
    assert _rk(check_bytes_model("hlo:fix", got, modeled)) == \
        _rk(j_bytes_model("hlo:fix", got, modeled))


def test_recorded_bytes_see_a_blowup():
    """A [V, V] materialization in a step of a [V, F] model blows past
    32x the modeled bytes; the step without it does not."""
    x = torch.ones(256, 48)
    modeled = 256 * 48 * 4 * 4
    ok = record(lambda: (x * 2).sum())
    bad = record(lambda: (x @ x.t()).sum())
    assert not check_bytes_model("hlo:fix", ok.bytes_total, modeled)
    assert _rk(check_bytes_model("hlo:fix", bad.bytes_total * 40,
                                 modeled)) == [("hlo-bytes-model",
                                                "bytes-model")]


# --------------------------------------------------- the mixed GCN rig

@pytest.fixture(scope="module")
def rig_findings():
    """The JAX package's jaxpr + HLO findings of its single-device units
    (the rig's 8 virtual devices give it dist units too: left out), and
    the port's of its seven units."""
    rules = list(JAXPR_RULES) + list(driver.HLO_RULES)
    jf = jdriver.build_trace_findings(select=rules)
    jf = [f for f in jf if not f.unit.startswith("jaxpr:dist")]
    return jf, driver.build_trace_findings(select=rules)


def test_seven_units_raise_nothing_jax_does_not(rig_findings):
    jf, pf = rig_findings
    assert set(_rk(pf)) <= set(_rk(jf)), _rk(pf)
    assert pf == []


def test_seven_units_are_recorded():
    units, hlo = driver.step_units(hlo=True)
    assert [u.name for u in units] == ["train_step", "eval_step",
                                       "model_graph", "tail_grad",
                                       "apply_update"]
    assert hlo == []
    by = {u.name: u for u in units}
    # the update rewrites every param and moment in place
    donated = [leaf for leaf in by["train_step"].trace.leaves
               if leaf.arg in (0, 1)]
    assert donated and all(leaf.same and leaf.versions > 0
                           for leaf in donated)
    # the eval step is the device work alone: no host fetch in it
    assert not check_host_callback(by["eval_step"])
    assert by["train_step"].trace.kernels()


def _rig_trainer(impl):
    f32, bf16 = resolve_dtypes("mixed")
    cfg = TrainConfig(verbose=False, symmetric=True, aggr_impl=impl,
                      dropout_rate=0.5, dtype=f32, compute_dtype=bf16)
    return Trainer(build_gcn([_F, _H, _C], dropout_rate=0.5),
                   build_rig_dataset(), cfg, device="cpu")


@pytest.mark.parametrize("impl", ["cuda", "cuda_csr"])
def test_recorded_step_is_the_kernels_and_the_unrecorded_bits(impl):
    """One ``kernel:`` entry per plain-version call the kernels' tally
    counts (``instances_planned``), none of the plain versions' fp32
    upcasts in the recording, the objective of an unrecorded twin bit
    for bit, eval's too."""
    tr, twin = _rig_trainer(impl), _rig_trainer(impl)
    before = _build.instances_planned()
    trace = record(tr.step, 0.01)
    now = _build.instances_planned()
    planned = {k: n - before.get(k, 0) for k, n in now.items()
               if n > before.get(k, 0)}
    assert collections.Counter(trace.kernel_entries()) == planned
    assert trace.kernels() == _build.instances_since(before, now)
    want = {"indegree_norm", "indegree_norm_masked", "scale_act",
            "ell_aggregate" if impl == "cuda" else "csr_spmm"}
    assert {k.split("[")[0] for k in planned} >= want
    upcasts = [e for e in trace.entries
               if e.name == "_to_copy" and e.ins[0].dtype == "bfloat16"
               and e.outs[0].dtype == "float32"
               and e.ins[0].numel >= _V * _H]
    assert upcasts == []
    assert torch.equal(trace.result, twin.step(0.01))
    got = record(tr.eval_sums).result
    assert all(torch.equal(v, twin.eval_sums()[k]) for k, v in got.items())


def test_rule_names_cover_the_jax_packages():
    """Every rule name of the JAX package selects its invariant in the
    port too (the AST rules whose constructs the port lacks by alias)."""
    from roc_tpu.analysis.driver import all_rule_names as j_names
    from roc_tpu_torch.analysis.__main__ import main as lint_main
    assert set(j_names()) <= set(driver.all_rule_names())
    assert set(driver.JAX_ALIASES) == set(j_names()) - {
        r.name for r in driver.AST_RULES} - set(driver.TRACE_RULES) - set(
        driver.CONCURRENCY_RULES) - set(driver.PROTOCOL_RULES)
    assert lint_main(["--no-trace", "--select", "bare-jit,pallas-interpret",
                      "--strict"]) == 0


def test_recording_keeps_no_tensor_alive():
    refs = []

    def fn():
        t = torch.ones(1000) * 2
        refs.append(weakref.ref(t))
        return float(t.sum())

    trace = record(fn)
    assert trace.entries and refs[0]() is None


def test_a_failing_region_raises_and_records_nothing():
    """The region adds no fallback: an error inside it propagates, the
    thread leaves the region, no entry is written for it and no plain
    call counted."""
    x = torch.ones(4, 3)

    def fn():
        with _build.kernel_region(scale_act, (x,), x.dtype, 3):
            raise RuntimeError("launch failed")

    before = _build.instances_planned()
    with pytest.raises(RuntimeError, match="launch failed"):
        record(fn)
    assert not _build.in_region() and _build.region_sink is None
    assert _build.instances_planned() == before
    t = record(lambda: x * 2)
    assert [e.op for e in t.entries] == ["mul.Tensor"]
