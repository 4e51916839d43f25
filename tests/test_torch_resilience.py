"""The port's recovery path on the CPU: the rotation, the async saver,
the finite guard, the watchdog, the preemption guard, the fault sites,
four kill drills through the CLI in subprocesses, and restores across
partition counts (roc_tpu_torch/resilience, obs, utils/checkpoint.py).

The drills mirror tests/test_drills.py: each runs the real CLI with one
armed fault, re-invokes the identical command the way a supervisor
would, and requires the uninterrupted run's end — here bit for bit, the
final checkpoint's every array and the last eval's train loss, dropout
0.5 included (the checkpoint carries the dropout generator's state).
"""

import contextlib
import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

import torch
import torch.distributed as dist

from roc_tpu_torch.core.graph import synthetic_dataset
from roc_tpu_torch.models.gcn import build_gcn
from roc_tpu_torch.obs.events import get_bus
from roc_tpu_torch.obs.heartbeat import Heartbeat, StallFailure
from roc_tpu_torch.parallel.distributed import (DistributedTrainer,
                                                run_ranks, train_job)
from roc_tpu_torch.resilience import inject, preempt
from roc_tpu_torch.resilience.async_save import AsyncSaver
from roc_tpu_torch.resilience.recovery import (CheckpointRotation,
                                               NumericFailure,
                                               check_params_finite,
                                               train_with_recovery)
from roc_tpu_torch.train.trainer import TrainConfig, Trainer
from roc_tpu_torch.utils import checkpoint as ck

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAYERS = [16, 16, 4]


def _ds():
    return synthetic_dataset(512, 8, in_dim=LAYERS[0],
                             num_classes=LAYERS[-1], seed=3)


def _config(**kw):
    return TrainConfig(**dict(dict(aggr_impl="cuda", eval_every=2,
                                   verbose=False, symmetric=True, chunk=64),
                              **kw))


def _trainer(ds=None, dropout=0.5, **kw):
    return Trainer(build_gcn(LAYERS, dropout_rate=dropout), ds or _ds(),
                   _config(**kw), device="cpu")


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


@pytest.fixture(autouse=True)
def _no_fault():
    inject.disarm()
    yield
    inject.disarm()
    preempt.reset()


def _state(path):
    """Every array of a v3 checkpoint, as saved."""
    data, _, _ = ck._load_v3(path)
    return data


def _same_state(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


# ---------------------------------------------------------------- rotation


@pytest.mark.parametrize("async_save", [False, True])
def test_rotation_keeps_last_k_after_commit(tmp_path, async_save):
    """keep=3 over saves at epochs 2..10: the three newest committed
    directories remain (in async mode the prune runs after each commit,
    on the saver thread); every save's record carries its timings."""
    tr = _trainer()
    rot = CheckpointRotation(str(tmp_path / "ck"), keep=3,
                             async_save=async_save)
    for _ in range(5):
        tr.train(2)
        rot.save(tr)
        rot.flush()
    rot.drain()
    assert rot.existing() == [6, 8, 10]
    assert sorted(os.listdir(tmp_path)) == ["ck.10", "ck.6", "ck.8"]
    st = rot.save_stats()
    assert st["saved"] == 5 and st["saves"][-1]["epoch"] == 10
    for k in ("block_ms", "write_ms", "commit_ms", "bytes"):
        assert st["saves"][-1][k] > 0


def test_async_and_sync_saves_hold_the_same_arrays(tmp_path):
    """An async save (host copies written on the saver thread) and a
    sync save of the same state hold the same arrays, and
    saving does not perturb training: the trainer that saved every 2
    epochs ends on the unsaved trainer's bits."""
    a, b = _trainer(), _trainer()
    rot = CheckpointRotation(str(tmp_path / "a" / "ck"), keep=5,
                             async_save=True)
    for _ in range(3):
        a.train(2)
        rot.save(a)
    b.train(6)
    ck.checkpoint_trainer(b, str(tmp_path / "b"))
    rot.drain()
    _same_state(_state(rot.path(6)), _state(str(tmp_path / "b")))
    assert torch.equal(torch.stack(a.losses), torch.stack(b.losses))


def test_restore_latest_only_if_ahead_never_rewinds(tmp_path):
    """only_if_ahead: a trainer at or past the newest checkpoint is left
    alone; with the newest ahead but corrupt and every intact fallback
    behind, nothing is restored."""
    tr = _trainer()
    rot = CheckpointRotation(str(tmp_path / "ck"), keep=3)
    for _ in range(2):
        tr.train(2)
        rot.save(tr)
    live = _trainer()
    live.train(4)
    assert rot.restore_latest(live, only_if_ahead=True) is None
    live = _trainer()
    live.train(3)
    os.remove(os.path.join(rot.path(4), "shard_00000.npz"))
    with _events() as recs:
        assert rot.restore_latest(live, only_if_ahead=True) is None
    assert live.epoch == 3
    assert [r["epoch"] for r in recs
            if r.get("kind") == "corrupt_fallback"] == [4]


# ------------------------------------------------------------- async saver


def _snap(epoch):
    tr = _trainer(dropout=0.0)
    tr.epoch = epoch
    return ck.snapshot_trainer(tr)


def test_coalescing_drops_superseded_snapshot(tmp_path, monkeypatch):
    """Queue depth 1: with save 0 in flight, save 1 is superseded by save
    2 (a ``superseded`` event), and saves 0 and 2 commit."""
    gate = threading.Event()
    orig = ck.write_snapshot

    def slow(path, snap):
        if snap.epoch == 0:
            gate.wait(timeout=30.0)
        return orig(path, snap)

    monkeypatch.setattr(ck, "write_snapshot", slow)
    saver = AsyncSaver()
    snaps = [_snap(e) for e in range(3)]
    with _events() as recs:
        saver.submit(snaps[0], str(tmp_path / "ck.0"))
        deadline = time.monotonic() + 10.0
        while not saver.stats()["busy"]:
            assert time.monotonic() < deadline
            time.sleep(0.005)
        saver.submit(snaps[1], str(tmp_path / "ck.1"))
        saver.submit(snaps[2], str(tmp_path / "ck.2"))
        gate.set()
        saver.drain()
    sup = [r for r in recs if r.get("kind") == "superseded"]
    assert len(sup) == 1 and sup[0]["epoch"] == 1 and sup[0]["by"] == 2
    assert ck.is_committed(str(tmp_path / "ck.0"))
    assert not os.path.exists(str(tmp_path / "ck.1"))
    assert ck.is_committed(str(tmp_path / "ck.2"))
    st = saver.stats()
    assert st["saved"] == 2 and st["superseded"] == 1


def test_wedged_saver_is_bounded_by_the_flush_deadline(tmp_path):
    """The saver_stall site wedges the saver thread: flush() raises
    StallFailure within its deadline (never hangs), drain() too, and the
    daemon thread is abandoned."""
    inject.arm("saver_stall:0")
    saver = AsyncSaver()
    saver.submit(_snap(0), str(tmp_path / "ck.0"))
    t0 = time.monotonic()
    with pytest.raises(StallFailure, match="wedged"):
        saver.flush(timeout_s=0.5)
    with pytest.raises(StallFailure):
        saver.drain(timeout_s=0.2)
    assert time.monotonic() - t0 < 10.0
    assert not ck.is_committed(str(tmp_path / "ck.0"))


def test_background_failure_surfaces_on_next_flush(tmp_path, monkeypatch):
    """An async save that fails on the saver thread is stored, reported
    (``saver_error``) and raised by the next flush: never silent."""
    def boom(path, snap):
        raise OSError("injected background write failure")

    monkeypatch.setattr(ck, "write_snapshot", boom)
    saver = AsyncSaver()
    with _events() as recs:
        saver.submit(_snap(0), str(tmp_path / "ck.0"))
        with pytest.raises(OSError, match="injected"):
            saver.flush(timeout_s=10.0)
    saver.drain(timeout_s=5.0)
    assert any(r.get("kind") == "saver_error" for r in recs)


# ------------------------------------------------- guard, watchdog, faults


def test_check_params_finite_covers_the_opt_state():
    """The guard passes a finite state, and names a NaN/Inf in a param,
    in Adam's m or v, or in a beta scalar."""
    tr = _trainer()
    tr.train(1)
    check_params_finite(tr.params, tr.opt_state)
    for where in ("param", "m", "v"):
        t = _trainer()
        t.train(1)
        leaf = {"param": t.params, "m": t.opt_state.m,
                "v": t.opt_state.v}[where]["linear_1"]
        with torch.no_grad():
            leaf.view(-1)[3] = float("inf") if where == "v" else float("nan")
        with pytest.raises(NumericFailure,
                           match=r"param|opt_state\.[mv]"):
            check_params_finite(t.params, t.opt_state)
    t = _trainer()
    t.opt_state = t.opt_state._replace(beta2_t=np.float32("nan"))
    with pytest.raises(NumericFailure, match="beta2_t"):
        check_params_finite(t.params, t.opt_state)


def test_rotation_save_refuses_a_poisoned_state(tmp_path):
    tr = _trainer()
    tr.train(2)
    with torch.no_grad():
        tr.params["linear_0"].view(-1)[0] = float("nan")
    rot = CheckpointRotation(str(tmp_path / "ck"), keep=3, async_save=True)
    with pytest.raises(NumericFailure):
        rot.save(tr)
    rot.drain()
    assert rot.existing() == []


def test_heartbeat_deadline_raises_and_beats_observe():
    """A region past its deadline leaves as StallFailure; without one the
    watchdog only beats (``stall`` events)."""
    with pytest.raises(StallFailure, match="deadline"):
        with Heartbeat("unit_stall", interval_s=0.05, deadline_s=0.3):
            time.sleep(5.0)
    with _events() as recs:
        with Heartbeat("unit_beat", interval_s=0.05, deadline_s=0) as hb:
            time.sleep(0.3)
    assert hb.fired >= 2 and not hb.deadline_hit
    assert any(r["cat"] == "stall" and r.get("stage") == "unit_beat"
               for r in recs)


def test_preemption_guard_is_graceful():
    """SIGTERM only sets the flag; the epoch-boundary check raises
    Preempted; the exit code is 75."""
    g = preempt.install(grace_s=5.0)
    assert not preempt.requested()
    os.kill(os.getpid(), signal.SIGTERM)
    deadline = time.monotonic() + 5.0
    while not g.requested():
        assert time.monotonic() < deadline
        time.sleep(0.01)
    with pytest.raises(preempt.Preempted, match="SIGTERM"):
        preempt.raise_if_preempted(7)
    assert preempt.RESTARTABLE_EXIT_CODE == 75


@pytest.mark.parametrize("spec", ["replica_sigkill", "replica_stall",
                                  "table_swap_mid_query", "serve_io"])
def test_inject_refuses_unported_sites(spec):
    """The serve sites, once refused as not ported, now parse as the JAX
    package's do; their malformed specs are refused, never armed as a
    no-op."""
    assert spec in inject.SITES
    assert inject.parse(f"{spec}:1:0").spec_str() == f"{spec}:1:0"
    for bad in (f"{spec}", f"{spec}:x", f"{spec}:-1", f"{spec}:1:-2"):
        with pytest.raises(ValueError):
            inject.parse(bad)


def test_inject_parse_and_arm():
    assert inject.parse("sigkill:3").spec_str() == "sigkill:3"
    assert inject.parse("nan_grads:2:1").proc == 1
    for bad in ("sigkill", "sigkill:x", "sigkill:-1", "bogus:1",
                "sigkill:1:2:3"):
        with pytest.raises(ValueError):
            inject.parse(bad)
    a = inject.arm("nan_grads:2")
    a.fired = True
    assert inject.arm("nan_grads:2") is a and a.fired


def test_nan_grads_drill_retries_once_in_process(tmp_path):
    """nan_grads:3 poisons a weight after epoch 3's step: the round's
    save refuses it, the rotation restores epoch 2, the generator is
    reseeded, and the run finishes with a finite loss after one retry."""
    tr = _trainer(fault="nan_grads:3")
    rot = CheckpointRotation(str(tmp_path / "ck"), keep=3, async_save=True)
    with _events() as recs:
        hist = train_with_recovery(tr, 8, rot, checkpoint_every=2)
    rec = [r for r in recs if r.get("kind") == "recovery"]
    assert len(rec) == 1 and rec[0]["error"] == "NumericFailure"
    assert tr.epoch == 8 and np.isfinite(hist[-1]["train_loss"])
    assert all(torch.isfinite(p).all() for p in tr.params.values())
    assert rot.existing() == [4, 6, 8]


# ----------------------------------------------------- CLI kill drills

CLI = ["--cpu", "-layers", "16-16-4", "-e", "10", "--eval-every", "5",
       "--checkpoint-every", "2", "--recovery"]
# site: (expected return code of the faulted run, checks on its leftovers)
DRILLS = {"sigkill:5": -signal.SIGKILL, "kill_in_save:4": -signal.SIGKILL,
          "kill_in_async_save:4": -signal.SIGKILL, "sigterm:5": 75}


def _cli(tmp, tag, fault=None):
    env = {k: v for k, v in os.environ.items()
           if k not in ("ROC_TPU_FAULT", "ROC_TPU_EVENTS")}
    env.update(PYTHONPATH=_REPO + os.pathsep + env.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1", ROC_TPU_FLIGHT_DIR=str(tmp))
    args = [sys.executable, "-m", "roc_tpu_torch.train.cli", *CLI,
            "--checkpoint", str(tmp / "ck"),
            "--events", str(tmp / f"{tag}.jsonl")]
    if fault:
        args += ["--fault", fault]
    return subprocess.Popen(args, cwd=_REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _wait(p, timeout=240):
    out, err = p.communicate(timeout=timeout)
    return p.returncode, out, err


def _last_loss(path):
    recs = [json.loads(ln) for ln in open(path)]
    ep = [r for r in recs if r["cat"] == "epoch"]
    assert ep and ep[-1]["epoch"] == 9, ep
    return ep[-1]["train_loss"], recs


@pytest.fixture(scope="module")
def drills(tmp_path_factory):
    """The uninterrupted run and the four faulted runs side by side, then
    the four re-invocations; returns each drill's leftovers after the
    fault and the resumed run's outcome."""
    root = tmp_path_factory.mktemp("drills")
    dirs = {name: root / name.split(":")[0] for name in ["base", *DRILLS]}
    for d in dirs.values():
        d.mkdir()
    procs = {"base": _cli(dirs["base"], "run")}
    procs.update({f: _cli(dirs[f], "fault", f) for f in DRILLS})
    first = {k: _wait(p) for k, p in procs.items()}
    leftovers = {f: CheckpointRotation(str(dirs[f] / "ck")).existing()
                 for f in DRILLS}
    ck4 = {f: sorted(os.listdir(dirs[f] / "ck.4"))
           if (dirs[f] / "ck.4").is_dir() else None for f in DRILLS}
    resumed = {f: _wait(_cli(dirs[f], "resume")) for f in DRILLS}
    return dirs, first, leftovers, ck4, resumed


@pytest.mark.parametrize("fault", list(DRILLS))
def test_cli_drill_resumes_bit_for_bit(drills, fault):
    """The faulted run dies as armed (SIGKILL, or exit 75 after an
    emergency checkpoint on SIGTERM), leaving only committed checkpoints
    visible (kill_in_save: a torn ``.npz.tmp``; kill_in_async_save: a
    shard and no manifest); the identical command then resumes from the
    newest committed checkpoint, with no corrupt_fallback, and ends on
    the uninterrupted run's final checkpoint and last train loss bit for
    bit."""
    dirs, first, leftovers, ck4, resumed = drills
    rc, out, err = first[fault]
    assert rc == DRILLS[fault], err[-2000:]
    assert first["base"][0] == 0, first["base"][2][-2000:]
    if fault.startswith("kill_in_save"):
        assert ck4[fault] is not None and "MANIFEST.json" not in ck4[fault]
        assert not any(n == "shard_00000.npz" for n in ck4[fault])
        assert any(n.endswith(".npz.tmp") for n in ck4[fault])
    if fault.startswith("kill_in_async_save"):
        assert ck4[fault] == ["shard_00000.npz"]
    # the committed epochs the faulted run left (an armed fault flushes
    # every save, so the last one before the fault is committed)
    assert leftovers[fault] == {"sigkill:5": [2, 4], "kill_in_save:4": [2],
                                "kill_in_async_save:4": [2],
                                "sigterm:5": [2, 4, 6]}[fault]
    if fault.startswith("sigterm"):
        assert "preempted" in err
    rc, out, err = resumed[fault]
    assert rc == 0, err[-2000:]
    loss, recs = _last_loss(dirs[fault] / "resume.jsonl")
    want, _ = _last_loss(dirs["base"] / "run.jsonl")
    assert loss == want
    assert not [r for r in recs if r.get("kind") == "corrupt_fallback"]
    _same_state(_state(str(dirs[fault] / "ck.10")),
                _state(str(dirs["base"] / "ck.10")))


# ------------------------------------------------- across partition counts


@pytest.fixture
def world_of_one(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_world_of_one_recovery_round_trip(world_of_one, tmp_path):
    """DistributedTrainer at world size 1 through train_with_recovery
    (the epoch chosen on rank 0 and broadcast), then a fresh one resumed
    from the rotation: the run of an unsaved Trainer bit for bit."""
    ds = _ds()
    cfg = _config(chunk=2)
    a = Trainer(build_gcn(LAYERS, dropout_rate=0.5), ds, cfg, device="cpu")
    a.train(6)
    rot = CheckpointRotation(str(tmp_path / "ck"), keep=3, async_save=True)
    b = DistributedTrainer(build_gcn(LAYERS, dropout_rate=0.5), ds, 1, cfg,
                           device="cpu")
    train_with_recovery(b, 4, rot, checkpoint_every=2)
    c = DistributedTrainer(build_gcn(LAYERS, dropout_rate=0.5), ds, 1, cfg,
                           device="cpu")
    assert rot.restore_latest(c) == 4 and c.epoch == 4
    c.train(2)
    for k in a.params:
        assert torch.equal(a.params[k], c.params[k])
        assert torch.equal(a.opt_state.v[k], c.opt_state.v[k])


def test_elastic_restore_from_two_ranks_into_one(tmp_path):
    """A checkpoint saved by a P = 2 gloo DistributedTrainer (spawned
    ranks, dropout 0) restores into a single-process Trainer (an
    ``elastic_restore`` event) and continues on the single-process
    curve: 4 + 4 epochs against 8 epochs of Trainer from the same
    weights, within tests/test_torch_distributed.py's tolerances for a
    partitioned run against one device (loss rtol 1e-4; weights rtol
    2e-4, atol 2e-5)."""
    ds = _ds()
    cfg = _config(dropout_rate=0.0, eval_every=1)
    model = build_gcn(LAYERS, dropout_rate=0.0)
    ref = Trainer(model, ds, cfg, device="cpu")
    p0 = {k: v.detach().clone() for k, v in ref.params.items()}
    want = ref.train(8)
    path = str(tmp_path / "ck.4")
    run_ranks(train_job, 2, backend="gloo", timeout_s=300,
              runs=[dict(model=model, dataset=ds, config=cfg, params=p0,
                         epochs=4, checkpoint=path)], device="cpu")
    saved = json.load(open(os.path.join(path, ck.MANIFEST_NAME)))
    assert saved["fingerprint"]["elastic"]["num_parts"] == 2
    tr = Trainer(model, ds, cfg, device="cpu")
    with _events() as recs:
        ck.restore_trainer(tr, path)
    assert tr.epoch == 4 and tr.opt_state.step == 4
    assert any(r.get("kind") == "elastic_restore" for r in recs)
    hist = tr.train(4)
    np.testing.assert_allclose([m["train_loss"] for m in hist],
                               [m["train_loss"] for m in want[4:]],
                               rtol=1e-4)
    for k in ref.params:
        np.testing.assert_allclose(tr.params[k].detach().numpy(),
                                   ref.params[k].detach().numpy(),
                                   rtol=2e-4, atol=2e-5)
