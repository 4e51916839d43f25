"""The port's sharding and replication audit against the JAX package's
(roc_tpu_torch/analysis/sharding_lint.py): the ledger rows of every
single-rank rig equal the JAX package's ``ledger_entries`` (params, Adam
moments, features, labels, mask), the budget functions equal JAX's on
equal inputs, the live 2x2 mesh's ranks give their findings through the
trace stage's one ``run_ranks``, and ``report --sharding FILE`` renders
the audit from a ``--json`` payload or a run's ``sharding`` events."""

import json
import os
import subprocess
import sys

import pytest

from roc_tpu.analysis import programspace as jps
from roc_tpu.analysis import sharding_lint as jsl
from roc_tpu_torch.analysis import programspace as ps
from roc_tpu_torch.analysis import sharding_lint as sl
from roc_tpu_torch.analysis.driver import build_trace_findings
from roc_tpu_torch.analysis.step_trace import (LeafState, StepTrace,
                                               TensorMeta)
from roc_tpu_torch.obs.events import get_bus

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the ledger rows both packages must hold alike: the params and Adam
# moments, and the data rows of the features (or a serving table) and
# the labels and mask.  Rows that differ, by design:
# - 'tables': the graph context's tables are each package's own (the
#   port's carries the fp32 inverse-degree row too);
# - 'other': a serving request's ids, int64 in the port, int32 in JAX;
# - on 'sgc_stream' JAX's streamed step is several programs whose
#   arguments carry the tail's input ('stream' [V, C]), the head's block
#   gradient ('data' [V, C]) and the update's gradients ('data' [F, C]);
#   the port's one step makes them inside (its activation rows)
SAME_ROLES = ("params", "opt_state", "data")


def _same_rows(rows, V, F, C):
    want = {(V, F), (V + 1, F), (V,), (V + 1,)}
    return sorted(
        (e["role"], tuple(e["shape"]), e["dtype"], e["bytes"],
         tuple(e["split"]), tuple(e["replicated"]), e["per_device_bytes"])
        for e in rows if e["role"] in SAME_ROLES
        and (e["role"] != "data" or tuple(e["shape"]) in want))


@pytest.fixture(scope="module")
def datasets():
    return jps.build_rig_dataset(), ps.build_rig_dataset()


@pytest.mark.parametrize("name", ["sgc_stream", "sgc_serve",
                                  "sgc_serve_q8"])
@pytest.mark.parametrize("shape", [(2, 4), (1, 1), (8, 1)])
def test_single_rank_ledger_rows_equal_jax(datasets, name, shape):
    jds, ds = datasets
    jtr = jps.build_rig_trainer(jps.rig_configs()[name], jds)
    jdims = jsl.rig_dims(jtr, jds)
    want = jsl.union_ledger([jsl.ledger_entries(c, jdims, shape)
                             for c in jps.candidate_programs(jtr)])
    tr = ps.build_rig_trainer(ps.rig_configs()[name], ds, "cpu")
    dims = sl.rig_dims(tr, ds)
    got = sl.union_ledger([sl.ledger_entries(c, dims, shape)
                           for c in ps.candidate_programs(tr)])
    assert (dims.vertex_sizes, dims.feat_sizes, dims.scale_elems) == \
        (jdims.vertex_sizes, jdims.feat_sizes, jdims.scale_elems)
    V, F, C = ps._V, ps._F, ps._C
    assert _same_rows(got, V, F, C) == _same_rows(want, V, F, C)
    assert _same_rows(got, V, F, C)


def test_seed_leaf_equals_jax():
    for parts in (1, 2):
        d = sl.RigDims({256, 136}, {48, 24}, parts_traced=parts)
        jd = jsl.RigDims({256, 136}, {48, 24}, parts_traced=parts)
        for shape in ((2, 136, 48), (48, 24), (256,), (2, 24)):
            for role in ("data", "params", "tables"):
                for model in (False, True):
                    assert sl.seed_leaf(shape, role, d, model) == \
                        jsl.seed_leaf(shape, role, jd, model)


_ROWS = [
    {"role": "params", "shape": [48, 24], "dtype": "float32",
     "bytes": 4608, "split": ["model"], "replicated": ["parts"],
     "per_device_bytes": 1152},
    {"role": "data", "shape": [256, 48], "dtype": "bfloat16",
     "bytes": 24576, "split": ["parts"], "replicated": [],
     "per_device_bytes": 12288},
    {"role": "activations", "shape": [256, 24], "dtype": "float32",
     "bytes": 24576, "split": ["parts"], "replicated": ["model"],
     "per_device_bytes": 12288, "count": 3},
]


@pytest.mark.parametrize("measured,budget", [(1000, None), (1000, 1000),
                                             (1001, 1000), (0, 5)])
def test_budget_rules_equal_jax(measured, budget):
    def rk(fs):
        return [(f.rule, f.unit, f.key, f.detail) for f in fs]
    assert rk(sl.check_replication_budget("r", measured, budget)) == \
        rk(jsl.check_replication_budget("r", measured, budget))
    for plan in (None, 100, 250, 10 ** 6):
        assert rk(sl.check_plan_excess("r", measured, plan)) == \
            rk(jsl.check_plan_excess("r", measured, plan))


def test_ledger_functions_equal_jax():
    assert sl.replicated_bytes(_ROWS) == jsl.replicated_bytes(_ROWS)
    assert sl.union_ledger([_ROWS, _ROWS[::-1]]) == \
        jsl.union_ledger([_ROWS, _ROWS[::-1]])
    acts = {((256, 48), "float32", (None, None), False): 2,
            ((64, 48), "bfloat16", (None, None), True): 1,
            ((4, 4), "float32", (None, None), False): 1}
    dims = sl.RigDims({256}, {48})
    jdims = jsl.RigDims({256}, {48})
    for shape in ((2, 4), (1, 1), (4, 2)):
        assert sl.activation_entries(acts, dims, shape) == \
            jsl.activation_entries(acts, jdims, shape)


# ----------------------------------------------------- the live mesh

LIVE = ["full-width-materialization", "sharding-mismatch",
        "donation-under-sharding"]


@pytest.fixture(scope="module")
def live_audit():
    """The level's live rules, the 2x2 mesh's four ranks spawned by the
    trace stage's one run_ranks, and its sharding events."""
    class Sink(list):
        write = list.append

    sink = Sink()
    bus = get_bus()
    bus.add_sink(sink)
    extras = {}
    try:
        findings = build_trace_findings(select=LIVE + ["replication-budget"],
                                        extras=extras)
    finally:
        bus.sinks.remove(sink)
    events = [e for e in sink if e.get("cat") == "sharding"]
    return findings, extras["sharding"], events


def test_live_mesh_findings(live_audit):
    """The weights gathered whole in each step and eval, the gradients
    sliced back: the findings the baseline accepts, no donation one (the
    rank's slices are updated in place), no budget overrun."""
    findings, reports, _ = live_audit
    got = {(f.rule, f.unit, f.key) for f in findings}
    assert got == {
        (rule, f"sharding:mesh_2x2:{slot}",
         f"{kind}|{op}|float32[{w}]|model")
        for rule, slot, kind, op in (
            ("full-width-materialization", "train_step", "full-width",
             "cat"),
            ("full-width-materialization", "eval_step", "full-width",
             "cat"),
            ("sharding-mismatch", "train_step", "reshard", "slice"))
        for w in ("48, 24", "24, 6")}
    assert [r["config"] for r in reports] == list(ps.rig_configs())
    for r in reports:
        assert {s["kind"] for s in r["sites"]} == {"full-width", "reshard"}
        assert [(m["parts"], m["model"]) for m in r["mesh_shapes"]] == \
            [(1, 8), (2, 4), (4, 2), (8, 1)]
        assert r["replicated_bytes"] > 0 and r["ledger"]


def _trace(before, after):
    meta = TensorMeta(tuple(before), "float32")
    return StepTrace(leaves=[LeafState(0, meta, 0, True, 1, tuple(after))])


def test_donation_under_sharding_fires_on_a_changed_shape():
    assert not sl.check_donation("c", "train_step",
                                 _trace((48, 12), (48, 12)), (0,))
    got = sl.check_donation("c", "train_step", _trace((48, 12), (48, 24)),
                            (0,))
    assert [(f.rule, f.key) for f in got] == [
        ("donation-under-sharding", "donate|0|float32[48, 12]")]
    # a position the step does not donate is not judged
    assert not sl.check_donation("c", "eval_step",
                                 _trace((48, 12), (48, 24)), ())


def test_report_renders_a_payload_and_events(live_audit, tmp_path):
    """``report --sharding FILE`` (a plain script, no torch) on the
    ``--json`` payload's ``sharding`` list and on the events."""
    _, reports, events = live_audit
    payload = tmp_path / "lint.json"
    payload.write_text(json.dumps({"sharding": reports}))
    ev = tmp_path / "ev.jsonl"
    ev.write_text("".join(json.dumps(e) + "\n" for e in events))
    outs = []
    for path in (payload, ev):
        r = subprocess.run(
            [sys.executable, os.path.join(_REPO, "roc_tpu_torch",
                                          "report.py"),
             "--sharding", str(path)], capture_output=True, text=True,
            timeout=60, cwd=str(tmp_path))
        assert r.returncode == 0, r.stderr
        outs.append(r.stdout)
    for name in ps.rig_configs():
        assert f"== sharding {name} " in outs[0]
        assert f"== sharding {name} " in outs[1]
    assert "replicated/step on 2x4" in outs[0]
    assert "cat    full-width" in outs[0] and "slice  reshard" in outs[0]
    assert "replication ledger (top 10, 2x4)" in outs[0]
    assert "modeled per-device memory by (parts x model)" in outs[1]
    bad = tmp_path / "missing.json"
    r = subprocess.run([sys.executable, os.path.join(
        _REPO, "roc_tpu_torch", "report.py"), "--sharding", str(bad)],
        capture_output=True, text=True, timeout=60)
    assert r.returncode == 2
