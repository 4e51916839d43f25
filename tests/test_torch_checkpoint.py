"""The port's checkpoint format (roc_tpu_torch/utils/checkpoint.py)
against the JAX package's (roc_tpu/utils/checkpoint.py), on the CPU.

Both packages read and write format v3: a JAX checkpoint restores into
the port bit for bit and training continues on the JAX curve; a port
checkpoint restores into the JAX package; the fingerprints are the same
strings.  Integrity failures raise CheckpointCorrupt or leave the
checkpoint invisible, as in tests/test_resilience.py.  Every tolerance
is stated with its reason.
"""

import contextlib
import json
import os
import zlib

import numpy as np
import pytest

import jax
import torch

from roc_tpu.core import graph as jgraph
from roc_tpu.models.gcn import build_gcn as j_build_gcn
from roc_tpu.train.trainer import TrainConfig as JTrainConfig
from roc_tpu.train.trainer import Trainer as JTrainer
from roc_tpu.train.trainer import resolve_dtypes as j_resolve_dtypes
from roc_tpu.utils import checkpoint as jck
from roc_tpu_torch.core import graph as tgraph
from roc_tpu_torch.models.gcn import build_gcn
from roc_tpu_torch.obs.events import get_bus
from roc_tpu_torch.resilience.recovery import CheckpointRotation
from roc_tpu_torch.train.trainer import TrainConfig, Trainer, resolve_dtypes
from roc_tpu_torch.utils import checkpoint as ck

LAYERS = [16, 16, 4]
SAVE_AT = 3        # epochs before the save
CONTINUE = 3       # steps after it
# tests/test_torch_train.py's tolerances: the printed loss curve within
# rtol 1e-4 (sums in another order over the steps) and the weights
# within rtol 2e-4, atol 1e-5 (Adam moves a weight by ~lr whatever its
# gradient's size).  Both trainers run unfused ('aggr_fuse' off), so in
# 'mixed' and 'bfloat16' they round the bf16 activations at the same
# places (fused, the JAX 'ell' route bakes d_i d_j into bf16 edge weights
# where the port scales before and after the sum: tests/test_torch_bf16.py)
# but for d itself: lax.rsqrt in JAX, a correctly rounded 1/sqrt in the
# port, one bf16 ulp apart where they differ.  So with bf16 activations
# the curve is held to tests/test_torch_bf16.py's rel 2e-3 for the mixed
# loss against JAX's (measured 1.2e-4 here); bf16 weights to one bf16
# ulp (ulp(x) <= 2^-7 |x|: the same fp32 update rounds to neighbours);
# 'mixed' fp32 master weights to a few bf16 ulps of each step's move
# (~lr: the gradients come from bf16 activations), CONTINUE * lr * 2^-6
# (measured 2.4e-4).
LR = 0.01
CURVE_RTOL = {"float32": 1e-4, "mixed": 2e-3, "bfloat16": 2e-3}
PARAM_TOL = {"float32": dict(rtol=2e-4, atol=1e-5),
             "mixed": dict(rtol=2e-4, atol=CONTINUE * LR * 2.0 ** -6),
             "bfloat16": dict(rtol=2.0 ** -7, atol=1e-5)}


def _datasets():
    return (jgraph.synthetic_dataset(512, 8, in_dim=LAYERS[0],
                                     num_classes=LAYERS[-1], seed=5),
            tgraph.synthetic_dataset(512, 8, in_dim=LAYERS[0],
                                     num_classes=LAYERS[-1], seed=5))


def _jax_trainer(jds, mode, impl="ell", dropout=0.0, layers=LAYERS):
    dtype, compute = j_resolve_dtypes(mode)
    return JTrainer(j_build_gcn(layers, dropout_rate=dropout), jds,
                    JTrainConfig(aggr_impl=impl, eval_every=1,
                                 verbose=False, aggr_fuse="off",
                                 symmetric=True, chunk=64,
                                 dtype=dtype, compute_dtype=compute,
                                 dropout_rate=dropout))


def _port_trainer(tds, mode, impl="ell", dropout=0.0, layers=LAYERS,
                  **kw):
    dtype, compute = resolve_dtypes(mode)
    return Trainer(build_gcn(layers, dropout_rate=dropout), tds,
                   TrainConfig(aggr_impl=impl, eval_every=1, verbose=False,
                               aggr_fuse="off", symmetric=True, chunk=64,
                               dtype=dtype, compute_dtype=compute,
                               dropout_rate=dropout,
                               **kw),
                   device="cpu")


@contextlib.contextmanager
def _events():
    """The port bus's records emitted inside the block, through a sink
    for the block (the bus's flight ring is bounded: once it is full its
    length stops growing, and a slice past it would miss them)."""
    bus = get_bus()
    out = []

    class _Sink:
        def write(self, record):
            out.append(record)

        def close(self):
            pass

    sink = _Sink()
    bus.add_sink(sink)
    try:
        yield out
    finally:
        bus.sinks.remove(sink)


def _bits(a):
    """Raw bits of a JAX/numpy array or a tensor, for exact equality
    (bf16 through a 16-bit view)."""
    if isinstance(a, torch.Tensor):
        a = a.detach()
        return (a.view(torch.int16) if a.dtype == torch.bfloat16
                else a).numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.itemsize == 2 and \
        a.dtype.kind not in "iu" else a


@pytest.fixture(scope="module")
def jax_saved(tmp_path_factory):
    """Per dtype mode: a JAX trainer (dropout 0) trained SAVE_AT epochs
    and checkpointed, then CONTINUE more epochs from the same state —
    restored from the file in fp32 and 'mixed', the saving trainer itself
    in 'bfloat16', whose checkpoint the JAX package cannot restore."""
    jds, tds = _datasets()
    root = tmp_path_factory.mktemp("jax_ck")
    out = {}
    for mode in ("float32", "mixed", "bfloat16"):
        jtr = _jax_trainer(jds, mode)
        jtr.train(epochs=SAVE_AT)
        path = str(root / f"{mode}.{SAVE_AT}")
        jck.checkpoint_trainer(jtr, path)
        saved = dict(params={k: np.asarray(v) for k, v in
                             jtr.params.items()},
                     m={k: np.asarray(v) for k, v in jtr.opt_state.m.items()},
                     v={k: np.asarray(v) for k, v in jtr.opt_state.v.items()},
                     step=int(jtr.opt_state.step),
                     beta1_t=np.float32(jtr.opt_state.beta1_t),
                     beta2_t=np.float32(jtr.opt_state.beta2_t),
                     fingerprint=jck.trainer_fingerprint(jtr))
        if mode != "bfloat16":
            jtr = _jax_trainer(jds, mode)
            jck.restore_trainer(jtr, path)
        hist = jtr.train(epochs=CONTINUE)
        out[mode] = dict(path=path, saved=saved, hist=hist,
                         params={k: np.asarray(v, np.float32)
                                 for k, v in jtr.params.items()})
    return tds, out


@pytest.mark.parametrize("mode", ["float32", "mixed", "bfloat16"])
def test_jax_checkpoint_restores_bit_for_bit(jax_saved, mode):
    """A JAX checkpoint into the port: params (bf16 by their bits), m,
    v, step, beta1_t, beta2_t and the epoch equal; the fingerprints agree
    (no elastic_restore event); the generator is reseeded, with an
    event, since a JAX PRNG key cannot drive torch's dropout.  In
    'bfloat16' this is a file the JAX package cannot restore itself
    (its loader's ``jnp.asarray`` of the ``|V2`` member raises)."""
    tds, runs = jax_saved
    run = runs[mode]
    tr = _port_trainer(tds, mode)
    with _events() as recs:
        ck.restore_trainer(tr, run["path"])
    s = run["saved"]
    assert tr.epoch == SAVE_AT
    for k in s["params"]:
        assert np.array_equal(_bits(tr.params[k]), _bits(s["params"][k])), k
        assert tr.params[k].dtype == (torch.bfloat16 if mode == "bfloat16"
                                      else torch.float32)
        assert np.array_equal(_bits(tr.opt_state.m[k]), _bits(s["m"][k]))
        assert np.array_equal(_bits(tr.opt_state.v[k]), _bits(s["v"][k]))
    st = tr.opt_state
    assert (st.step, st.beta1_t, st.beta2_t) == \
        (s["step"], s["beta1_t"], s["beta2_t"])
    assert isinstance(st.step, int) and st.beta1_t.dtype == np.float32
    kinds = [r.get("kind") for r in recs]
    assert "rng_reseed" in kinds and "elastic_restore" not in kinds
    if mode == "bfloat16":
        j = _jax_trainer(_datasets()[0], mode)
        with pytest.raises(ValueError):
            jck.restore_trainer(j, run["path"])


@pytest.mark.parametrize("mode", ["float32", "mixed", "bfloat16"])
def test_restored_port_continues_on_the_jax_curve(jax_saved, mode):
    """After the restore, CONTINUE steps with dropout 0 follow the JAX
    trainer continuing from the same state: the printed loss curve and
    the weights within the mode's CURVE_RTOL and PARAM_TOL."""
    tds, runs = jax_saved
    run = runs[mode]
    tr = _port_trainer(tds, mode)
    ck.restore_trainer(tr, run["path"])
    hist = tr.train(CONTINUE)
    assert [m["epoch"] for m in hist] == [m["epoch"] for m in run["hist"]] \
        == list(range(SAVE_AT, SAVE_AT + CONTINUE))
    np.testing.assert_allclose([m["train_loss"] for m in hist],
                               [m["train_loss"] for m in run["hist"]],
                               rtol=CURVE_RTOL[mode])
    for k, want in run["params"].items():
        np.testing.assert_allclose(tr.params[k].detach().float().numpy(),
                                   want, **PARAM_TOL[mode])


@pytest.mark.parametrize("mode", ["float32", "mixed"])
def test_port_checkpoint_restores_into_jax(tmp_path, mode):
    """A port checkpoint (dropout 0.5, so it carries ``__torch_rng__``)
    through the JAX package's load_checkpoint, restore_trainer (its
    strict fingerprint check included) and restore_params_only: the same
    bits, step, betas and epoch."""
    jds, tds = _datasets()
    tr = _port_trainer(tds, mode, dropout=0.5)
    tr.train(SAVE_AT)
    path = str(tmp_path / "ck")
    ck.checkpoint_trainer(tr, path)
    with np.load(os.path.join(path, "shard_00000.npz")) as z:
        assert ck.RNG_KEY in z.files
        assert z[ck.RNG_KEY].dtype == np.uint8
    jtr = _jax_trainer(jds, mode, dropout=0.5)
    params, opt, epoch, key = jck.load_checkpoint(
        path, jtr.params, jtr.opt_state,
        expect_fingerprint=jck.trainer_fingerprint(jtr))
    assert epoch == SAVE_AT and key is None
    jck.restore_trainer(jtr, path)
    jp, _, jep = jck.restore_params_only(path)
    assert jtr.epoch == jep == SAVE_AT
    for k, t in tr.params.items():
        for got in (params[k], jtr.params[k], jp[k]):
            assert np.array_equal(np.asarray(got), _bits(t)), k
        for a, b in ((opt.m[k], tr.opt_state.m[k]),
                     (jtr.opt_state.v[k], tr.opt_state.v[k])):
            assert np.array_equal(np.asarray(a), _bits(b))
    assert int(jtr.opt_state.step) == tr.opt_state.step == SAVE_AT
    assert np.float32(jtr.opt_state.beta1_t) == tr.opt_state.beta1_t
    assert np.float32(jtr.opt_state.beta2_t) == tr.opt_state.beta2_t


@pytest.mark.parametrize("mode", ["float32", "mixed", "bfloat16"])
@pytest.mark.parametrize("jimpl,impl", [("ell", "ell"), ("pallas", "cuda"),
                                        ("segment", "segment")])
def test_fingerprint_is_the_jax_string(mode, jimpl, impl):
    """``params_signature`` and the whole fingerprint, strict and
    elastic halves, equal the JAX package's for the same model, dataset,
    dtype mode and route (the port's 'cuda' is JAX's 'pallas')."""
    jds, tds = _datasets()
    jtr = _jax_trainer(jds, mode, impl=jimpl)
    tr = _port_trainer(tds, mode, impl=impl)
    assert ck.params_signature(tr.params) == \
        jck.params_signature(jtr.params)
    assert ck.trainer_fingerprint(tr) == jck.trainer_fingerprint(jtr)
    # the JSON round trip a manifest takes keeps them equal
    assert json.loads(json.dumps(ck.trainer_fingerprint(tr))) == \
        json.loads(json.dumps(jck.trainer_fingerprint(jtr)))


# -------------------------------------------------------------- integrity


def _saved_port(tmp_path, epochs=(2, 4)):
    """A rotation of two committed port checkpoints."""
    _, tds = _datasets()
    tr = _port_trainer(tds, "float32", dropout=0.5)
    rot = CheckpointRotation(str(tmp_path / "ck"), keep=3)
    for e in epochs:
        tr.train(e - tr.epoch)
        rot.save(tr)
    return tds, tr, rot


def _flip(path, offset=None):
    with open(path, "r+b") as f:
        raw = bytearray(f.read())
        i = len(raw) // 2 if offset is None else offset
        raw[i] ^= 0xFF
        f.seek(0)
        f.write(raw)


def _corrupt(path, how):
    shard = os.path.join(path, "shard_00000.npz")
    man = os.path.join(path, ck.MANIFEST_NAME)
    if how == "shard_byte":
        _flip(shard)
    elif how == "member_crc":
        # rewrite one member and the manifest's file CRC to match: only
        # the shard header's member CRC can catch it
        with np.load(shard) as z:
            data = {k: z[k] for k in z.files}
        data["params['linear_0']"] = data["params['linear_0']"] + 1
        np.savez(shard, **data)
        with open(shard, "rb") as f:
            raw = f.read()
        with open(man) as f:
            doc = json.load(f)
        doc["shards"][0].update(bytes=len(raw),
                                crc32=zlib.crc32(raw) & 0xFFFFFFFF)
        with open(man, "w") as f:
            json.dump(doc, f)
    elif how == "missing_shard":
        os.remove(shard)
    elif how == "torn_manifest":
        with open(man, "r+b") as f:
            f.truncate(os.path.getsize(man) // 2)
    elif how == "uncommitted":
        os.remove(man)


@pytest.mark.parametrize("how", ["shard_byte", "member_crc",
                                 "missing_shard", "torn_manifest",
                                 "uncommitted"])
def test_corrupt_newest_raises_and_falls_back(tmp_path, how):
    """A flipped shard byte (file CRC), a rewritten member (member CRC),
    a missing shard and a torn manifest each raise CheckpointCorrupt on a
    direct restore, and the rotation falls back to the previous
    checkpoint with a corrupt_fallback event; an uncommitted directory is
    invisible to the rotation and raises on a direct restore."""
    tds, tr, rot = _saved_port(tmp_path)
    _corrupt(rot.path(4), how)
    fresh = _port_trainer(tds, "float32", dropout=0.5)
    with pytest.raises(ck.CheckpointCorrupt):
        ck.restore_trainer(fresh, rot.path(4))
    assert fresh.epoch == 0
    assert rot.existing() == ([2] if how == "uncommitted" else [2, 4])
    with _events() as recs:
        assert rot.restore_latest(fresh) == 2
    falls = [r for r in recs if r.get("kind") == "corrupt_fallback"]
    assert len(falls) == (0 if how == "uncommitted" else 1)
    assert fresh.epoch == 2


def _jax_legacy(tmp_path, version):
    """A JAX trainer's state as a legacy single-file checkpoint: v1 a
    bare npz, v2 with the CRC header."""
    jds, _ = _datasets()
    jtr = _jax_trainer(jds, "float32")
    jtr.train(epochs=2)
    data = {**jck._flatten(jtr.params, "params"),
            **jck._flatten(jtr.opt_state, "opt"),
            "__epoch__": np.asarray(2, np.int64)}
    if version == 2:
        crc = {k: zlib.crc32(np.ascontiguousarray(v).tobytes()) & 0xFFFFFFFF
               for k, v in data.items()}
        data["__header__"] = np.frombuffer(json.dumps(
            {"version": 2, "crc32": crc,
             "fingerprint": jck.trainer_fingerprint(jtr)}).encode(),
            dtype=np.uint8)
    path = str(tmp_path / f"v{version}.npz")
    np.savez(path, **data)
    return path, {k: np.asarray(v) for k, v in jtr.params.items()}


@pytest.mark.parametrize("version", [1, 2])
def test_legacy_v1_v2_files_load(tmp_path, version):
    """The JAX package's legacy single-file checkpoints restore into the
    port bit for bit, each with its event (v1: no validation; v2:
    validated); a flipped byte of a v2 file raises."""
    path, want = _jax_legacy(tmp_path, version)
    _, tds = _datasets()
    tr = _port_trainer(tds, "float32")
    with _events() as recs:
        ck.restore_trainer(tr, path)
    assert tr.epoch == 2 and tr.opt_state.step == 2
    for k, w in want.items():
        assert np.array_equal(_bits(tr.params[k]), w)
    assert ("v1_checkpoint" if version == 1 else "legacy_checkpoint") in \
        [r.get("kind") for r in recs]
    if version == 2:
        with np.load(path) as z:
            data = {k: z[k] for k in z.files}
        data["params['linear_1']"] = data["params['linear_1']"] * 2
        np.savez(path, **data)
        with pytest.raises(ck.CheckpointCorrupt, match="CRC32"):
            ck.restore_trainer(_port_trainer(tds, "float32"), path)


def test_fingerprint_mismatch_raises(tmp_path):
    """Another model, another dataset or another dtype mode: the strict
    half refuses the restore before the trainer is touched."""
    tds, tr, rot = _saved_port(tmp_path, epochs=(2,))
    other_ds = tgraph.synthetic_dataset(300, 8, in_dim=LAYERS[0],
                                        num_classes=LAYERS[-1], seed=5)
    for other in (_port_trainer(tds, "float32", layers=[16, 8, 4]),
                  _port_trainer(other_ds, "float32"),
                  _port_trainer(tds, "mixed")):
        before = {k: v.clone() for k, v in other.params.items()}
        with pytest.raises(ck.CheckpointCorrupt, match="fingerprint"):
            ck.restore_trainer(other, rot.path(2))
        assert other.epoch == 0 and all(
            torch.equal(before[k], other.params[k]) for k in before)


def test_restore_params_only_and_bf16_round_trip(tmp_path):
    """A port 'bfloat16' checkpoint back into the port: the params' bits
    and the generator state through restore_trainer, the params through
    restore_params_only (as name -> CPU tensor); on disk the bf16 members
    are ``|V2`` with ``"bfloat16"`` in the header, as JAX writes them."""
    _, tds = _datasets()
    tr = _port_trainer(tds, "bfloat16", dropout=0.5)
    tr.train(2)
    path = str(tmp_path / "ck")
    ck.checkpoint_trainer(tr, path)
    with np.load(os.path.join(path, "shard_00000.npz")) as z:
        assert z["params['linear_0']"].dtype == np.dtype("V2")
        header = json.loads(bytes(z["__header__"]))
    assert header["arrays"]["params['linear_0']"]["dtype"] == "bfloat16"
    assert header["arrays"]["opt.m['linear_0']"]["dtype"] == "float32"
    fresh = _port_trainer(tds, "bfloat16", dropout=0.5)
    ck.restore_trainer(fresh, path)
    params, fp, epoch = ck.restore_params_only(path)
    assert epoch == 2 and fp["strict"]["dtype"] == "bfloat16"
    for k, t in tr.params.items():
        assert torch.equal(fresh.params[k], t) and torch.equal(params[k], t)
    assert torch.equal(fresh.generator.get_state(), tr.generator.get_state())
