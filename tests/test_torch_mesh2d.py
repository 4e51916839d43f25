"""The port's ``(parts, model)`` mesh (parallel/distributed.py
``DistributedTrainer`` with ``TrainConfig.mesh='PxM'``) and its
multi-writer checkpoint (utils/checkpoint.py), on the CPU, against the
port's 1-D run and the JAX package's 1-D ``DistributedTrainer``; the
CLI's ``--mesh`` and its ``--impl`` default.

The port's ranks are spawned gloo processes running
``tests/torch_rank_jobs.py`` (the port alone); one ``run_ranks`` call of
four ranks runs every mesh case, the 1-D references on subgroups of the
same ranks.  The JAX package runs in the pytest process on its virtual
CPU devices, and only its 1-D trainer: its 2-D trainer needs
``jax.shard_map(..., auto=)``, which this rig's JAX refuses (ROADMAP
Queue 3).  Dropout is 0 wherever two runs are compared.
"""

import os
import queue
import subprocess
import sys

import numpy as np
import pytest

import jax

from roc_tpu.core import graph as jgraph
from roc_tpu.models.gcn import build_gcn as j_build_gcn
from roc_tpu.parallel import candidate_mesh_shapes as j_candidates
from roc_tpu.parallel import mesh_axes as j_mesh_axes
from roc_tpu.parallel import model_shard_spec as j_model_shard_spec
from roc_tpu.parallel.distributed import DistributedTrainer as JDist
from roc_tpu.parallel.distributed import make_mesh, put_replicated
from roc_tpu.train import cli as jcli
from roc_tpu.train.optimizer import adam_init as j_adam_init
from roc_tpu.train.trainer import TrainConfig as JTrainConfig
from roc_tpu.train.trainer import resolve_mesh as j_resolve_mesh
from roc_tpu.utils import checkpoint as jck
from roc_tpu_torch import convert
from roc_tpu_torch.core import graph as tgraph
from roc_tpu_torch.models.gcn import build_gcn
from roc_tpu_torch.models.gin import build_gin
from roc_tpu_torch.obs.events import get_bus
from roc_tpu_torch.parallel import (RankMesh, candidate_mesh_shapes,
                                    mesh_axes, model_shard_spec)
from roc_tpu_torch.parallel.distributed import run_ranks
from roc_tpu_torch.resilience.recovery import CheckpointRotation
from roc_tpu_torch.train import cli
from roc_tpu_torch.train.trainer import TrainConfig, Trainer, resolve_mesh
from roc_tpu_torch.utils import checkpoint as ck

import torch_rank_jobs

LAYERS = [12, 16, 3]
EPOCHS = 4
SAVE_AT = 3
# the 2-D mesh against the port's 1-D run at the same P: the contract's
# 1e-5 (the same sums in the same order: bit-equality is expected, and
# the test prints nothing else); against JAX's 1-D trainer the same
# 1e-5 on the objectives (4 epochs of fp32 sums in another order) and
# tests/test_torch_distributed.py's weight tolerance (Adam moves a weight
# by ~lr whatever its gradient's size, so a near-zero gradient amplifies
# rounding)
MESH_RTOL = 1e-5
# a made-up epoch time that moves the cost split of
# tests/test_torch_costmodel.py's skewed graph at P = 2 (its value)
FORCED_MS = 500.0
JAX_PARAM_TOL = dict(rtol=2e-4, atol=2e-5)
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _datasets():
    return (jgraph.synthetic_dataset(96, 7, in_dim=12, num_classes=3,
                                     seed=11),
            tgraph.synthetic_dataset(96, 7, in_dim=12, num_classes=3,
                                     seed=11))


def _config(mesh="auto", halo="gather", **kw):
    return TrainConfig(**dict(dict(
        aggr_impl="cuda", dropout_rate=0.0, eval_every=1, verbose=False,
        symmetric=True, chunk=64, epochs=EPOCHS, weight_decay=1e-3,
        learning_rate=0.01, partition="greedy", mesh=mesh, halo=halo),
        **kw))


def _jax_run(jds, P, halo):
    """JAX DistributedTrainer (1-D) at P parts, an eval every epoch:
    starting weights, the evals' train_loss and final weights."""
    tr = JDist(j_build_gcn(LAYERS, dropout_rate=0.0), jds, P,
               JTrainConfig(aggr_impl="ell" if halo == "gather"
                            else "segment", dropout_rate=0.0,
                            verbose=False, epochs=EPOCHS, eval_every=1,
                            weight_decay=1e-3, learning_rate=0.01, chunk=64,
                            symmetric=True, partition="greedy", halo=halo))
    p0 = {k: np.asarray(v) for k, v in tr.params.items()}
    hist = tr.train()
    return p0, [m["train_loss"] for m in hist], \
        {k: np.asarray(v, np.float32) for k, v in tr.params.items()}


# the mesh cases: (mesh, parts, halo); 1x4 runs the gather (one part)
CASES = [("1x4", 1, "gather"), ("2x2", 2, "gather"), ("2x2", 2, "ring"),
         ("4x1", 4, "gather"), ("4x1", 4, "ring")]


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    """One call of four ranks: every case of CASES, the 1-D references on
    subgroups (P = 1, 2; P = 4 is 4x1 itself), GIN with learnable
    epsilons (0-d leaves, whole on every rank) at 2x2 and at P = 2, the
    two-writer save at 2x2 (SAVE_AT epochs, then one more), its restore
    into a fresh 2x2 trainer (one step) and into 1-D trainers at P = 2
    and 4, a JAX checkpoint of model-sharded leaves restored at 2x2, and
    a forced rebalance at 2x2 and at P = 2.  All from the JAX run's
    starting weights."""
    tmp = tmp_path_factory.mktemp("mesh")
    jds, tds = _datasets()
    refs = {(P, halo): _jax_run(jds, P, halo)
            for P, halo in ((1, "gather"), (2, "gather"), (2, "ring"),
                            (4, "gather"), (4, "ring"))}
    p0 = convert.params_from_jax(refs[(1, "gather")][0])
    # a JAX checkpoint of leaves sharded over the model axis of a (2, 2)
    # mesh, by device_put alone (no shard_map)
    jmesh = make_mesh(2, model=2)
    jparams = j_build_gcn(LAYERS).init_params(jax.random.PRNGKey(7))
    jdir = str(tmp / "jax_sharded")
    jck.write_snapshot(jdir, jck.snapshot_state(
        put_replicated(jparams, jmesh),
        put_replicated(j_adam_init(jparams), jmesh), 5))
    ckdir = str(tmp / "ck2x2")
    gcn = build_gcn(LAYERS, dropout_rate=0.0)
    gin = build_gin(LAYERS, dropout_rate=0.0, learn_eps=True)

    def run(mesh, P, halo="gather", model=gcn, params=p0, **kw):
        return dict(dict(model=model, dataset=tds, parts=P, epochs=EPOCHS,
                         params=params, config=_config(mesh, halo)), **kw)

    runs = {f"{m}/{h}": run(m, P, h) for m, P, h in CASES}
    runs.update({
        "1d/1/gather": run("auto", 1),
        "1d/2/gather": run("auto", 2),
        "1d/2/ring": run("auto", 2, "ring"),
        "gin/2x2": run("2x2", 2, model=gin, params=None),
        "gin/1d/2": run("auto", 2, model=gin, params=None),
        "save/2x2": run("2x2", 2, epochs=SAVE_AT, save=ckdir,
                        more=EPOCHS - SAVE_AT),
        "restore/2x2": run("2x2", 2, epochs=EPOCHS - SAVE_AT,
                           restore=ckdir),
        "restore/1d/2": run("auto", 2, epochs=0, restore=ckdir),
        "restore/1d/4": run("auto", 4, epochs=0, restore=ckdir),
        "restore/jax": run("2x2", 2, epochs=0, restore=jdir, params=None),
    })
    # the skewed graph of tests/test_torch_costmodel.py (not symmetric:
    # the plain 'ell' route by autograd), where FORCED_MS moves the split
    zg = tgraph.zipf_csr(300, 3000, seed=0)
    rng = np.random.RandomState(0)
    zds = tgraph.Dataset(zg, rng.randn(300, LAYERS[0]).astype(np.float32),
                         rng.randint(0, LAYERS[-1], 300).astype(np.int32),
                         rng.randint(0, 4, 300).astype(np.int32), LAYERS[-1])
    for mesh in ("2x2", "auto"):
        runs[f"rebalance/{mesh}"] = dict(
            run(mesh, 2), dataset=zds, force=(FORCED_MS, FORCED_MS),
            config=_config(mesh, aggr_impl="ell", symmetric=False,
                           rebalance=True, rebalance_gain=1e-9,
                           rebalance_max=1, partition="cost"))
    names = list(runs)
    res = run_ranks(torch_rank_jobs.mesh_job, 4, runs=list(runs.values()),
                    timeout_s=300)
    return dict(refs=refs, jparams=jparams, ckdir=ckdir,
                ranks=[dict(zip(names, r)) for r in res])


def test_mesh_arithmetic_matches_jax():
    """The mesh's shape arithmetic is the JAX package's: the
    factorizations, the axis names, the shard spec of a grid of shapes
    and widths, and resolve_mesh's vocabulary and refusals."""
    for n in (1, 4, 6, 8):
        assert candidate_mesh_shapes(n) == j_candidates(n)
    assert mesh_axes((2, 4)) == j_mesh_axes((2, 4))
    for shape in [(), (3,), (16,), (12, 16), (16, 3), (5, 7), (8, 6, 4)]:
        for m in (1, 2, 3, 4, 8):
            assert model_shard_spec(shape, m) == \
                j_model_shard_spec(shape, m), (shape, m)
    for mesh, P in [("auto", 3), ("2x4", 2), ("1x1", 1), ((4, 2), 4),
                    ("2X2", 2)]:
        assert resolve_mesh(TrainConfig(mesh=mesh), num_parts=P) == \
            j_resolve_mesh(JTrainConfig(mesh=mesh), num_parts=P)
    for mesh, P in [("2x", 2), ("0x2", 0), ("3x2", 2), ("ax2", 2)]:
        with pytest.raises(ValueError):
            j_resolve_mesh(JTrainConfig(mesh=mesh), num_parts=P)
        with pytest.raises(ValueError):
            resolve_mesh(TrainConfig(mesh=mesh), num_parts=P)
    mesh = RankMesh(2, 2)
    assert [mesh.part_of(r) for r in range(4)] == [0, 0, 1, 1]
    assert mesh.parts_group(1) == [1, 3] and mesh.model_group(1) == [2, 3]


@pytest.mark.parametrize("mesh,P,halo", CASES)
def test_every_factorization_trains_the_1d_trajectory(mesh_runs, mesh, P,
                                                      halo):
    """Each factorization of four ranks, on the gather and on the ring:
    every rank's objectives and whole weights within MESH_RTOL of the
    port's 1-D run at the same P (bit-equal here), its logits equal, and
    each epoch's eval train_loss within MESH_RTOL of JAX's 1-D
    DistributedTrainer's, its weights within JAX_PARAM_TOL."""
    ref_key = f"4x1/{halo}" if P == 4 else f"1d/{P}/{halo}"
    for ranks in mesh_runs["ranks"]:
        got, want = ranks[f"{mesh}/{halo}"], ranks[ref_key]
        np.testing.assert_allclose(got["losses"], want["losses"],
                                   rtol=MESH_RTOL, atol=0)
        for k in want["params"]:
            np.testing.assert_allclose(got["params"][k], want["params"][k],
                                       rtol=MESH_RTOL, atol=0)
        np.testing.assert_array_equal(got["logits"], want["logits"])
        _, jlosses, jparams = mesh_runs["refs"][(P, halo)]
        np.testing.assert_allclose(got["train_loss"], jlosses,
                                   rtol=MESH_RTOL, atol=0)
        for k in jparams:
            np.testing.assert_allclose(got["params"][k], jparams[k],
                                       **JAX_PARAM_TOL)


@pytest.mark.parametrize("mesh,P,halo", CASES + [("2x2", 2, "gin")])
def test_params_and_moments_sharded_at_rest(mesh_runs, mesh, P, halo):
    """Every param and both Adam moments of a rank have the shape of its
    model_shard_spec slice of the whole leaf (a leaf no dimension divides,
    GIN's 0-d epsilons, stays whole); the model ranks of a part hold
    distinct slices, parts-major."""
    M = int(mesh.split("x")[1])
    key = "gin/2x2" if halo == "gin" else f"{mesh}/{halo}"
    for r, ranks in enumerate(mesh_runs["ranks"]):
        rec = ranks[key]
        assert (rec["part"], rec["model_index"]) == (r // M, r % M)
        for k, full in rec["params"].items():
            spec = model_shard_spec(full.shape, M)
            want = tuple(n // M if spec is not None and spec[i] == "model"
                         else n for i, n in enumerate(full.shape))
            assert rec["rest"][k] == rec["rest_m"][k] == \
                rec["rest_v"][k] == want, (k, full.shape)
    if halo == "gin":
        rec = mesh_runs["ranks"][0]["gin/2x2"]
        assert any(np.ndim(v) == 0 for v in rec["params"].values())
        ref = mesh_runs["ranks"][0]["gin/1d/2"]
        np.testing.assert_allclose(rec["losses"], ref["losses"],
                                   rtol=MESH_RTOL, atol=0)
        for k in ref["params"]:
            np.testing.assert_allclose(rec["params"][k], ref["params"][k],
                                       rtol=MESH_RTOL, atol=0)


def test_two_writer_checkpoint(mesh_runs):
    """The 2x2 save has two writers (part 0's model ranks): the manifest
    lists two shard files, each with its slices as pieces, and both
    barriers ran (every rank's stats).  It restores in the JAX package's
    ``restore_params_only`` to the saved weights; into a fresh 2x2
    trainer, whose next step equals the uninterrupted run's bit for bit;
    and into 1-D trainers at P = 2 and 4, with the saved weights."""
    ckdir = mesh_runs["ckdir"]
    man = ck.read_manifest(ckdir)
    assert [s["file"] for s in man["shards"]] == \
        [ck.shard_file_name(0), ck.shard_file_name(1)]
    ranks = mesh_runs["ranks"]
    for r in range(4):
        stats = ranks[r]["save/2x2"]["save"]
        assert stats["shards"] == 2 and (stats["bytes"] > 0) == (r < 2)
    saved = ranks[0]["save/2x2"]["saved_params"]
    jparams, _, epoch = jck.restore_params_only(ckdir)
    assert epoch == SAVE_AT
    for k in saved:
        np.testing.assert_array_equal(np.asarray(jparams[k]), saved[k])
    for r in range(4):
        full = ranks[r]["save/2x2"]
        resumed = ranks[r]["restore/2x2"]
        assert resumed["restored_epoch"] == SAVE_AT
        np.testing.assert_array_equal(resumed["losses"],
                                      full["losses"][SAVE_AT:])
        for k in full["params"]:
            np.testing.assert_array_equal(resumed["params"][k],
                                          full["params"][k])
        for tag in ("restore/1d/2", "restore/1d/4"):
            for k in saved:
                np.testing.assert_array_equal(ranks[r][tag]["params"][k],
                                              saved[k])


def test_rebalance_on_the_mesh_repartitions_alike(mesh_runs):
    """A forced rebalance (FORCED_MS fed twice, threshold 1e-9, at most
    once): rank 0's time is broadcast to the world, so every rank of the
    2x2 mesh, both model replicas of each part included, moves to the
    1-D run's new split, and trains its trajectory."""
    ranks = mesh_runs["ranks"]
    first = ranks[0]["rebalance/auto"]
    assert first["forced"] == [True, False]
    for rank_runs in ranks:
        got, want = rank_runs["rebalance/2x2"], rank_runs["rebalance/auto"]
        assert got["forced"] == want["forced"] == [True, False]
        assert got["bounds"] == want["bounds"] == first["bounds"]
        np.testing.assert_allclose(got["losses"], want["losses"],
                                   rtol=MESH_RTOL, atol=0)


def test_jax_model_sharded_checkpoint_restores_at_2x2(mesh_runs):
    """A JAX checkpoint whose leaves were sharded over a (2, 2) mesh's
    model axis (pieces by device, written by the JAX package) restores
    into a 2x2 port trainer: the whole weights are JAX's, each rank
    holding its slice."""
    for ranks in mesh_runs["ranks"]:
        rec = ranks["restore/jax"]
        assert rec["restored_epoch"] == 5
        for k, v in mesh_runs["jparams"].items():
            np.testing.assert_array_equal(rec["params"][k], np.asarray(v))


def test_rank_killed_in_commit_window_keeps_previous(tmp_path):
    """Mesh 1x2, two writers: the save at epoch 1 commits; at epoch 2
    rank 1 is killed after its shard's rename and before the commit
    barrier (``kill_in_async_save:2:1``), so rank 0 never publishes the
    manifest.  The epoch-1 checkpoint stays the newest one the rotation
    and both packages' loaders see."""
    _, tds = _datasets()
    prefix = str(tmp_path / "ck")
    # rank 0 waits at the commit barrier until run_ranks's timeout ends
    # the call (no rank reports: queue.Empty) and kills it
    with pytest.raises((RuntimeError, queue.Empty)):
        run_ranks(torch_rank_jobs.commit_kill_job, 2, timeout_s=20,
                  model=build_gcn(LAYERS, dropout_rate=0.0), dataset=tds,
                  config=_config("1x2", epochs=2), prefix=prefix)
    assert CheckpointRotation(prefix).existing() == [1]
    assert ck.is_committed(prefix + ".1")
    assert not ck.is_committed(prefix + ".2")
    assert os.path.exists(os.path.join(prefix + ".2",
                                       ck.shard_file_name(1)))
    params, _, epoch = ck.restore_params_only(prefix + ".1")
    jparams, _, jepoch = jck.restore_params_only(prefix + ".1")
    assert epoch == jepoch == 1
    for k in params:
        np.testing.assert_array_equal(params[k].numpy(),
                                      np.asarray(jparams[k]))


def test_async_rotation_with_two_writers_drops_no_save(tmp_path):
    """Mesh 1x2, two writers, async rotation: saves after every epoch,
    submitted faster than they commit, rank 1's saver slower than rank
    0's.  No save is superseded on either rank (a dropped epoch on one
    rank alone would pair different epochs at the commit barrier), every
    epoch commits two shards under its own epoch, and the newest restores
    the final weights.  A commit barrier reached with different tags
    raises on both ranks."""
    _, tds = _datasets()
    saves = 5
    res = run_ranks(torch_rank_jobs.async_rotation_job, 2, timeout_s=120,
                    model=build_gcn(LAYERS, dropout_rate=0.0), dataset=tds,
                    config=_config("1x2"), prefix=str(tmp_path / "ck"),
                    saves=saves, delay_s=0.2)
    epochs = list(range(1, saves + 1))
    for rank, rec in enumerate(res):
        assert rec["superseded"] == 0 and rec["saved"] == saves, rec
        assert rec["existing"] == rec["manifest_epochs"] == epochs
        assert rec["shards"] == [2] * saves
        assert rec["restored"] == rec["epoch"] == saves and rec["same"]
        assert rec["mismatch"] is not None
        assert "'ck:0'" in rec["mismatch"] and "'ck:1'" in rec["mismatch"]


def test_single_device_trainer_takes_no_model_axis():
    """Trainer takes 'auto' and '1x1'; '1x2' raises and names the ranked
    path (DistributedTrainer at P = 1 on 2 ranks); a mesh whose P is not
    the partition count is refused as in the JAX package."""
    _, tds = _datasets()
    Trainer(build_gcn(LAYERS), tds, _config("1x1"), device="cpu")
    with pytest.raises(NotImplementedError, match="DistributedTrainer"):
        Trainer(build_gcn(LAYERS), tds, _config("1x2"), device="cpu")
    with pytest.raises(ValueError, match="parts axis"):
        resolve_mesh(_config("2x2"), num_parts=4)


class _Sink(list):
    write = list.append


def test_cli_impl_defaults_to_auto_as_jax():
    """The port parser's --impl default is the JAX parser's ('auto'); a
    CPU run without --impl resolves it with a ``resolve`` event giving
    the JAX rule's answer for the graph (the JAX package's
    ``resolve_auto_impl``) beside the route."""
    from roc_tpu.core.ell import resolve_auto_impl as j_resolve_auto_impl
    assert cli.parse_args([]).impl == jcli.parse_args([]).impl == "auto"
    sink = _Sink()
    get_bus().add_sink(sink)
    try:
        assert cli.main(["--cpu", "-e", "1", "--eval-every", "1"]) == 0
    finally:
        get_bus().sinks.remove(sink)
    (ev,) = [e for e in sink if e["cat"] == "resolve"
             and e.get("requested") == "auto"]
    ds = tgraph.synthetic_dataset(512, 8, in_dim=16, num_classes=4, seed=1)
    assert ev["jax_resolves"] == j_resolve_auto_impl(
        ds.graph.num_nodes, num_edges=ds.graph.num_edges)
    assert ev["resolved"] == "cuda"


def test_cli_mesh_flag(capsys):
    """--mesh takes the JAX CLI's vocabulary and checks (exit 2 on a bad
    shape or a P other than --parts), and the launcher must start P x M
    ranks; under torchrun, 4 ranks of --parts 2 --mesh 2x2 print the
    [INFER] lines of 2 ranks of --parts 2."""
    for bad in (["--mesh", "2x"], ["--mesh", "3x2", "--parts", "2"],
                ["--mesh", "2x2", "--parts", "2"]):
        assert cli.main(["--cpu", "-e", "1", *bad]) == 2
    flags = ["--cpu", "-layers", "16-16-4", "-e", "4", "--eval-every", "2",
             "-dropout", "0"]
    env = dict(os.environ, PYTHONPATH=_REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    out = {}
    for n, extra in ((2, []), (4, ["--mesh", "2x2"])):
        r = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc-per-node", str(n), "-m", "roc_tpu_torch.train.cli",
             "--parts", "2", *extra, *flags], capture_output=True,
            text=True, timeout=300, cwd=_REPO, env=env)
        assert r.returncode == 0, r.stderr[-3000:]
        out[n] = [ln for ln in r.stdout.splitlines()
                  if ln.startswith("[INFER]")]
    assert len(out[2]) == 2 and out[4] == out[2]
