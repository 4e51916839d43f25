"""The port's quantized serving tables and export artifact against the
JAX package, on the CPU: the int8/fp8 codec bit for bit, the params
codec and the propagation file in both directions, JAX-exported
artifacts served by the port, the port's own export and cold load, the
drift gate, the scale guard and the export CLI.

The JAX serve rig's size (V = 300, 24 features, 5 classes).  A JAX
export is called with ``verify_warm=False`` and a cache directory in
``tmp_path``: its second warm pass is a check of the JAX compile cache,
which has no counterpart here and is unsteady.
"""

import json
import os

import numpy as np
import pytest

import jax
import torch

from roc_tpu.core.graph import synthetic_dataset as j_synthetic_dataset
from roc_tpu.models import model_builders as j_model_builders
from roc_tpu.serve import export as jexport
from roc_tpu.serve import quant as jquant
from roc_tpu.serve.propagation import PropagationCache as JCache
from roc_tpu.train.trainer import TrainConfig as JTrainConfig
from roc_tpu_torch import convert
from roc_tpu_torch.core.graph import synthetic_dataset
from roc_tpu_torch.models import model_builders
from roc_tpu_torch.serve import quant
from roc_tpu_torch.serve.export import (build_predictor, export_predictor,
                                        export_trainer, load_predictor,
                                        main)
from roc_tpu_torch.serve.propagation import PropagationCache
from roc_tpu_torch.train.trainer import TrainConfig, Trainer

V, IN, C = 300, 24, 5
TOL = 1e-5
# artifact case -> (registry name, builder kwargs, layers, backend, quant)
CASES = {"off": ("sgc", {"k": 2}, [IN, C], "auto", "off"),
         "int8": ("sgc", {"k": 2}, [IN, C], "auto", "int8"),
         "fp8": ("sgc", {"k": 2}, [IN, C], "auto", "fp8"),
         "table": ("appnp", {"k": 3}, [IN, 16, C], "precomputed", "off"),
         "full": ("gcn", {}, [IN, 16, C], "full", "off")}
# fp8-e4m3 keeps 3 mantissa bits: its export needs the relaxed gate the
# JAX package's tests give it (tests/test_serve_quant.py)
GATE = {"fp8": dict(drift_argmax_min=0.90, drift_dlogit_max=0.20)}


@pytest.fixture(scope="module")
def data():
    return (j_synthetic_dataset(V, 6, in_dim=IN, num_classes=C, seed=0),
            synthetic_dataset(V, 6, in_dim=IN, num_classes=C, seed=0))


def _models(case):
    name, kw, layers, backend, mode = CASES[case]
    jm = j_model_builders()[name](layers, dropout_rate=0.5, **kw)
    m = model_builders()[name](layers, dropout_rate=0.5, **kw)
    jp = jm.init_params(jax.random.PRNGKey(11))
    return jm, m, jp, backend, mode


def _table():
    """A heavy-tailed table with all-zero rows."""
    rng = np.random.RandomState(0)
    x = (rng.standard_t(2, size=(2000, 77))
         * rng.lognormal(0, 3, size=(2000, 1))).astype(np.float32)
    x[[5, 1999]] = 0.0
    return x


@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_codes_and_scales_bit_equal_jax(mode):
    """int8 codes and fp8 codes (as bytes), and their scales, bit-equal
    to the JAX package's ``quantize_rows`` (numpy's rint and torch's fp8
    cast both round half to even), the all-zero rows at scale 1.0 and
    code 0; the dequantized tables are equal, and the round trip
    ``quantize(dequantize(q)) == q`` holds."""
    x = _table()
    q, sc = quant.quantize_rows(x, mode)
    jq, jsc = jquant.quantize_rows(x, mode)
    assert q.dtype == quant.storage_dtype(mode)
    assert np.array_equal(q.view(np.uint8), np.asarray(jq).view(np.uint8))
    assert np.array_equal(sc, jsc) and sc.dtype == np.float32
    assert (sc[[5, 1999]] == 1.0).all() and not q[[5, 1999]].any()
    deq = quant.dequantize_rows(q, sc)
    assert np.array_equal(deq, jquant.dequantize_rows(jq, jsc))
    q2, sc2 = quant.quantize_rows(deq, mode)
    assert np.array_equal(q2, q) and np.array_equal(sc2, sc)
    assert quant.table_bytes(x.shape, mode) == \
        jquant.table_bytes(x.shape, mode)
    raw = quant.to_storage_bytes(q)
    assert np.array_equal(raw, jquant.to_storage_bytes(jq))
    assert np.array_equal(quant.from_storage_bytes(raw, mode), q)


@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_params_codec_both_ways(mode):
    """``quantize_params`` stores the JAX package's bytes and scales, and
    each package's ``dequantize_params`` reads the other's store to the
    same fp32 values."""
    rng = np.random.RandomState(1)
    params = {"linear_0": rng.randn(24, 16).astype(np.float32),
              "linear_1": rng.randn(16, 5).astype(np.float32),
              "eps_0": np.float32(0.25) * np.ones((), np.float32)}
    store, rt, keys = quant.quantize_params(params, mode)
    jstore, jrt, jkeys = jquant.quantize_params(params, mode)
    assert keys == jkeys == ["linear_0", "linear_1"]
    assert set(store) == set(jstore)
    for k in store:
        a, b = np.asarray(store[k]), np.asarray(jstore[k])
        assert a.shape == b.shape and a.tobytes() == b.tobytes(), k
    for k in rt:
        assert np.array_equal(rt[k], np.asarray(jrt[k]))
    a = quant.dequantize_params(jstore, mode)
    b = jquant.dequantize_params(store, mode)
    for k in params:
        assert np.array_equal(a[k], np.asarray(b[k]))
        assert np.array_equal(a[k], rt[k])


@pytest.mark.parametrize("mode", ["off", "int8"])
def test_propagation_file_crosses_both_ways(data, tmp_path, mode):
    """A propagation.npz saved by either package loads in the other with
    the same ops, graph and stages (quantized: the same dequantized
    stages)."""
    jds, ds = data
    ops = [{"kind": "fused_aggregate", "activation": "none"}] * 2
    c = PropagationCache.build(ds.graph, ops, np.asarray(ds.features),
                               device="cpu")
    jc = JCache.build(jds.graph, ops, np.asarray(jds.features))
    c.save(str(tmp_path / "t.npz"), quant=mode)
    jc.save(str(tmp_path / "j.npz"), quant=mode)
    for a, b in ((JCache.load(str(tmp_path / "t.npz")), c),
                 (PropagationCache.load(str(tmp_path / "j.npz")), jc)):
        assert a.ops == b.ops
        assert np.array_equal(a.row_ptr, b.row_ptr)
        assert np.array_equal(a.x0, b.x0)
        for got, src in zip(a.stages, b.stages):
            want = (src if mode == "off"
                    else quant.dequantize_rows(*quant.quantize_rows(src,
                                                                    mode)))
            assert np.array_equal(np.asarray(got), want)


@pytest.mark.parametrize("case", ["off", "int8", "table"])
def test_jax_artifact_serves_in_the_port(data, tmp_path, case):
    """An artifact exported by the JAX package (akx fp32, akx int8, the
    APPNP 'table' flavor) loads in the port and serves within 1e-5 of
    JAX's own ``load_predictor``; the JAX route name maps to the port's."""
    jds, _ = data
    jm, _, jp, backend, mode = _models(case)
    jpred = jexport.build_predictor(
        jm, jds, JTrainConfig(aggr_impl="segment", verbose=False,
                              symmetric=True), params=jp, backend=backend,
        quant=mode)
    art = str(tmp_path / "art")
    jexport.export_predictor(jpred, art, cache_dir=str(tmp_path / "cc"),
                             verify_warm=False)
    want = jexport.load_predictor(art).query(np.arange(V))
    pred = load_predictor(art, device="cpu")
    assert pred.quant == mode and pred.config.aggr_impl == "segment"
    assert (pred.backend, pred.flavor) == ("precomputed",
                                           "akx" if case != "table"
                                           else "table")
    got = pred.query(np.arange(V))
    err = np.abs(got - want).max()
    assert err <= TOL * max(1.0, np.abs(want).max()), err


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_export_cold_load_bit_equal(data, tmp_path, case):
    """The port's export → load serves the exporting predictor's rows bit
    for bit, in every mode and on both backends (the full backend's
    artifact holds no graph: the loader takes the dataset); the manifest
    records the spec, the table's shrink and, quantized, a passing drift
    gate."""
    _, ds = data
    _, m, jp, backend, mode = _models(case)
    pred = build_predictor(m, ds, TrainConfig(), device="cpu",
                           params=convert.params_from_jax(
                               {k: np.asarray(v) for k, v in jp.items()}),
                           backend=backend, quant=mode)
    art = str(tmp_path / "art")
    man = export_predictor(pred, art, **GATE.get(mode, {}))
    assert man["quant"]["spec"]["mode"] == mode
    assert man["config"]["aggr_impl"] == "pallas"
    if mode != "off":
        assert man["quant"]["drift"]["ok"]
        assert man["quant"]["table"]["shrink"] >= 3.0
    with open(os.path.join(art, "serve_manifest.json")) as f:
        assert json.load(f)["fingerprint"]["params_sig"] == \
            man["fingerprint"]["params_sig"]
    ids = np.arange(V)
    cold = load_predictor(art, device="cpu",
                          dataset=ds if backend == "full" else None)
    assert (cold.quant, cold.flavor) == (mode, pred.flavor)
    assert np.array_equal(cold.query(ids), pred.query(ids))


def test_drift_gate_refuses_before_any_write(data, tmp_path):
    _, ds = data
    _, m, _, _, _ = _models("int8")
    pred = build_predictor(m, ds, TrainConfig(), device="cpu",
                           quant="int8")
    art = str(tmp_path / "refused")
    with pytest.raises(quant.QuantDriftError, match="drift"):
        export_predictor(pred, art, drift_dlogit_max=1e-12)
    assert not os.path.exists(art)


def test_scale_guard_refuses_and_keeps_the_old_version(data):
    """Refreshed rows whose scale leaves the envelope refuse to publish
    (QuantDriftError); the old version stays published and serving."""
    _, ds = data
    _, m, _, _, _ = _models("int8")
    pred = build_predictor(m, ds, TrainConfig(), device="cpu",
                           quant="int8")
    pub0 = pred.published()
    want = pred.query(np.arange(8))
    pred._scale_guard = 1e-12
    with pytest.raises(quant.QuantDriftError, match="envelope"):
        pred.invalidate([3, 250], [250, 3])
    assert pred.published() is pub0
    assert np.array_equal(pred.query(np.arange(8)), want)


@pytest.mark.parametrize("argv,rc", [
    (["--cpu", "--model", "sgc", "-layers", "24-5", "--quantize",
      "int8"], 0),
    (["--cpu", "--model", "sgc", "-layers", "24-5", "--backend", "full",
      "--shards", "2"], 2),
])
def test_export_cli(tmp_path, argv, rc, capsys):
    """``python -m roc_tpu_torch.export``: an int8 SGC export on the CPU
    passes the default gate and cold-loads; ``--shards`` on the full
    backend (no table to slice) is refused before any file is written."""
    art = str(tmp_path / "art")
    assert main(argv + ["--out", art]) == rc
    if rc == 0:
        out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert (out["backend"], out["flavor"]) == ("precomputed", "akx")
        assert out["quant"]["drift"]["ok"]
        assert load_predictor(art, device="cpu").quant == "int8"
    else:
        assert "precomputed table backend" in capsys.readouterr().err
        assert not os.path.exists(art)


def test_export_cli_from_a_checkpoint(tmp_path):
    """``--checkpoint``: the port's trainer checkpoint exported through
    the CLI serves the trainer's own predictions (the CLI's synthetic
    dataset is the trainer's: 512 nodes, degree 8, from ``-seed``)."""
    from roc_tpu_torch.models.sgc import build_sgc
    from roc_tpu_torch.utils.checkpoint import checkpoint_trainer
    ds = synthetic_dataset(512, 8, in_dim=IN, num_classes=C, seed=3)
    tr = Trainer(build_sgc([IN, C], k=2), ds,
                 TrainConfig(verbose=False, seed=3), device="cpu")
    tr.train(2)
    ck = str(tmp_path / "ck")
    checkpoint_trainer(tr, ck)
    art = str(tmp_path / "art")
    assert main(["--cpu", "--checkpoint", ck, "--model", "sgc",
                 "-layers", f"{IN}-{C}", "-seed", "3", "--out", art]) == 0
    got = load_predictor(art, device="cpu").query(np.arange(512))
    want = tr.predict().detach().numpy()
    assert np.abs(got - want).max() <= TOL * max(1.0, np.abs(want).max())


def test_fp8_gathers_through_byte_codes(data):
    """An fp8 table lives on the device as its uint8 bytes; the gathered
    rows widen to the fp8 values times their scales."""
    _, ds = data
    _, m, _, _, _ = _models("fp8")
    pred = build_predictor(m, ds, TrainConfig(), device="cpu", quant="fp8")
    pub = pred.published()
    assert pub.table.dtype == torch.uint8 and pub.qmode == "fp8"
    ids = torch.tensor([0, 5, V], dtype=torch.long)
    rows = pred._gather(pub, ids)
    q, sc = quant.quantize_rows(pred.cache.table, "fp8")
    want = quant.dequantize_rows(q, sc)
    assert np.array_equal(rows[:2].numpy(), want[[0, 5]])
    assert not rows[2].any()
    assert pred.table_bytes() == quant.table_bytes((V + 1, IN), "fp8")


def test_full_artifact_on_an_unported_layout_is_refused(data, tmp_path):
    """A full-backend artifact resolved to a layout the port lacks (a
    name no route of either package has, every JAX layout being ported)
    raises NotImplementedError naming it; a full artifact loaded without
    its dataset, or with another graph, raises ValueError."""
    _, ds = data
    _, m, _, _, _ = _models("full")
    art = str(tmp_path / "art")
    export_predictor(build_predictor(m, ds, TrainConfig(), device="cpu",
                                     backend="full"), art)
    with pytest.raises(ValueError, match="dataset"):
        load_predictor(art, device="cpu")
    other = synthetic_dataset(V + 1, 6, in_dim=IN, num_classes=C, seed=0)
    with pytest.raises(ValueError, match="silently wrong"):
        load_predictor(art, dataset=other, device="cpu")
    path = os.path.join(art, "serve_manifest.json")
    with open(path) as f:
        man = json.load(f)
    man["config"]["aggr_impl"] = "tiled"
    with open(path, "w") as f:
        json.dump(man, f)
    with pytest.raises(NotImplementedError, match="tiled"):
        load_predictor(art, dataset=ds, device="cpu")


def test_entry_points_take_the_card_unless_told(data, tmp_path,
                                                monkeypatch):
    """export_trainer and load_predictor run on the card unless the
    caller passes a device: with no card they raise, and never fall back
    to the CPU; with device='cpu' the trainer's export round-trips."""
    _, ds = data
    _, m, _, _, _ = _models("off")
    tr = Trainer(m, ds, TrainConfig(verbose=False), device="cpu")
    art = str(tmp_path / "art")
    man = export_trainer(tr, ds, art, quant="int8", device="cpu")
    assert man["dataset"]["V"] == V and man["quant"]["drift"]["ok"]
    want = load_predictor(art, device="cpu").query(np.arange(V))
    assert np.abs(want - tr.predict().detach().numpy()).max() <= \
        quant.DRIFT_DLOGIT_MAX * max(1.0, np.abs(want).max())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_predictor(art)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        export_trainer(tr, ds, str(tmp_path / "card"))
    assert not os.path.exists(str(tmp_path / "card"))
