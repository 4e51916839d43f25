"""The chunked head (``TrainConfig.head_chunk``, ``resolve_head_chunk``)
and the CLI's compute flags ``--head-chunk``, ``--eval-only`` and
``--save-logits`` against the JAX package, on the CPU at small sizes.
Each tolerance is stated where it is used.
"""

import contextlib
import os
import re

import numpy as np
import pytest

import torch

from roc_tpu.core import graph as jgraph
from roc_tpu.models.gcn import build_gcn as j_build_gcn
from roc_tpu.obs import events as jevents
from roc_tpu.train import cli as jcli
from roc_tpu.train.trainer import TrainConfig as JTrainConfig
from roc_tpu.train.trainer import Trainer as JTrainer
from roc_tpu.train.trainer import resolve_head_chunk as j_resolve_head_chunk
from roc_tpu_torch import convert
from roc_tpu_torch.core import graph as tgraph
from roc_tpu_torch.models.gcn import build_gcn
from roc_tpu_torch.obs import events as tevents
from roc_tpu_torch.ops import dense as tdense
from roc_tpu_torch.train import cli
from roc_tpu_torch.train.trainer import (HEAD_CHUNK_AUTO_MIN_ROWS,
                                         HEAD_CHUNK_ROWS, TrainConfig,
                                         Trainer, resolve_head_chunk)

LAYERS = [24, 16, 5]


@pytest.mark.parametrize("hc,rows", [
    ("auto", HEAD_CHUNK_AUTO_MIN_ROWS - 1), ("auto", HEAD_CHUNK_AUTO_MIN_ROWS),
    ("auto", 10 ** 7), (0, 1000), (1, 1000), (999, 1000), (1000, 1000),
    (65_536, 1000), ("128", 1000), ("0", 5), (-1, 1000), ("-7", 1000),
    ("junk", 1000), (None, 1000), ("1.5", 1000), ([3], 1000)])
def test_resolve_head_chunk_matches_jax(hc, rows):
    """The same block, or the same refusal with the same message, for
    'auto' on either side of the threshold, 0, blocks below, at and past
    the row count, numeric strings, negatives and junk."""
    assert (HEAD_CHUNK_ROWS, HEAD_CHUNK_AUTO_MIN_ROWS) == (65_536, 262_144)
    try:
        want = j_resolve_head_chunk(JTrainConfig(head_chunk=hc), rows)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            resolve_head_chunk(TrainConfig(head_chunk=hc), rows)
        assert str(got.value) == str(e)
        return
    assert resolve_head_chunk(TrainConfig(head_chunk=hc), rows) == want


@pytest.mark.parametrize("bad", ["-1", "x"])
def test_cli_head_chunk_refused_as_jax(bad, capsys):
    """A bad --head-chunk exits 2 before any data is read, in both CLIs,
    naming the flag."""
    assert cli.main(["--cpu", "--head-chunk", bad]) == 2
    assert "--head-chunk" in capsys.readouterr().err
    assert jcli.main(["--cpu", "--no-compile-cache", "--head-chunk",
                      bad]) == 2


def _datasets(V=200, deg=6, seed=0):
    return (jgraph.synthetic_dataset(V, deg, in_dim=LAYERS[0],
                                     num_classes=LAYERS[-1], seed=seed),
            tgraph.synthetic_dataset(V, deg, in_dim=LAYERS[0],
                                     num_classes=LAYERS[-1], seed=seed))


def test_chunked_head_trains_as_jax_and_as_unchunked(monkeypatch):
    """head_chunk=64 on 200 rows: the context carries 64, only the last
    linear (the classifier) runs in blocks, and 3 epochs (dropout 0) give
    the objectives of head_chunk=0 within rtol 1e-6 (the weight gradient
    summed by blocks) and of the JAX trainer at head_chunk=64 within rtol
    1e-4 (fp32 sums in another order, through Adam)."""
    jds, tds = _datasets()
    jtr = JTrainer(j_build_gcn(LAYERS, dropout_rate=0.0), jds,
                   JTrainConfig(aggr_impl="ell", epochs=3, eval_every=1,
                                verbose=False, symmetric=True,
                                head_chunk=64))
    p0 = convert.params_from_jax({k: np.asarray(v)
                                  for k, v in jtr.params.items()})
    jhist = jtr.train()
    calls = []
    real = tdense.linear_chunked
    monkeypatch.setattr(tdense, "linear_chunked", lambda x, w, *a: (
        calls.append(tuple(w.shape)), real(x, w, *a))[1])
    runs = {}
    for hc in (64, 0):
        tr = Trainer(build_gcn(LAYERS, dropout_rate=0.0), tds,
                     TrainConfig(aggr_impl="ell", epochs=3, eval_every=1,
                                 verbose=False, symmetric=True,
                                 head_chunk=hc),
                     params=p0, device="cpu")
        assert tr.gctx.head_chunk == hc
        runs[hc] = [m["train_loss"] for m in tr.train()]
        if hc:
            assert calls and set(calls) == {(LAYERS[1], LAYERS[2])}
    np.testing.assert_allclose(runs[64], runs[0], rtol=1e-6)
    np.testing.assert_allclose(runs[64], [m["train_loss"] for m in jhist],
                               rtol=1e-4)


@pytest.fixture
def world_of_one(tmp_path):
    """This process as a world of one gloo rank."""
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_partitioned_head_chunk_reads_the_part_rows(world_of_one):
    """DistributedTrainer resolves head_chunk against its part's rows
    (the JAX trainer's ``pgr.part_nodes``), and its objective equals
    the unchunked run's within rtol 1e-6."""
    from roc_tpu_torch.parallel.distributed import DistributedTrainer
    _, tds = _datasets()
    losses = []
    for hc in (50, 0):
        tr = DistributedTrainer(
            build_gcn(LAYERS, dropout_rate=0.0), tds, 1,
            TrainConfig(aggr_impl="ell", verbose=False, symmetric=True,
                        head_chunk=hc, seed=3), device="cpu")
        assert tr.gctx.head_chunk == resolve_head_chunk(
            tr.config, tr.plan.part_nodes) == hc
        tr.train(2)
        losses.append(torch.stack(tr.losses).numpy())
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-6)


# ------------------------------------------------------------ the CLI


@contextlib.contextmanager
def _sink(bus):
    class Sink(list):
        write = list.append

    sink = Sink()
    bus.add_sink(sink)
    try:
        yield sink
    finally:
        bus.sinks.remove(sink)


_INFER = re.compile(r"^\[INFER\]\[(\d+)\] train_loss: ([0-9.]+)  (.*)$")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A 300-vertex dataset in the reference's files (the JAX package's
    writer) and a port checkpoint after 3 epochs of the port's CLI."""
    root = tmp_path_factory.mktemp("cli")
    prefix = str(root / "g")
    jds, _ = _datasets(300, 7, seed=2)
    jgraph.save_dataset(jds, prefix, csv=False)
    ck = str(root / "ck")
    assert cli.main(["--cpu", "-file", prefix, "-layers", "24-16-5", "-e",
                     "3", "--impl", "ell", "--checkpoint", ck]) == 0
    return root, prefix, ck


def _eval_only(main, argv, capsys):
    capsys.readouterr()
    assert main(argv) == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("[INFER]")]
    assert len(lines) == 1
    return _INFER.match(lines[0]).groups()


def test_eval_only_and_save_logits_match_the_jax_cli(files, capsys):
    """--resume --eval-only --save-logits under --reorder bfs, in both
    CLIs on the same files and checkpoint: one [INFER] line at the
    checkpoint's epoch with equal counts and train loss within rtol 1e-5;
    [V, C] fp32 logits in the original vertex order within 1e-5 of the
    logit scale of the JAX CLI's .npy (fp32 sums in another order) and
    of the port's unreordered run; the same 'run' event."""
    root, prefix, ck = files
    common = ["--cpu", "-file", prefix, "-layers", "24-16-5", "--impl",
              "ell", "--resume", ck, "--eval-only"]
    npy = {k: str(root / f"{k}.npy") for k in ("port", "jax", "plain")}
    with _sink(tevents.get_bus()) as tev:
        port = _eval_only(cli.main, common + [
            "--save-logits", npy["port"], "--reorder", "bfs"], capsys)
    with _sink(jevents.get_bus()) as jev:
        jax_ = _eval_only(jcli.main, common + [
            "--no-compile-cache", "--save-logits", npy["jax"], "--reorder",
            "bfs"], capsys)
    plain = _eval_only(cli.main, common + ["--save-logits", npy["plain"]],
                       capsys)
    assert port[0] == jax_[0] == plain[0] == "3"
    assert port[2] == jax_[2] == plain[2]
    np.testing.assert_allclose(float(port[1]), float(jax_[1]), rtol=1e-5)
    got, want, unre = (np.load(npy[k]) for k in ("port", "jax", "plain"))
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape == (300, LAYERS[-1])
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 1e-5 * scale
    assert np.abs(got - unre).max() <= 1e-5 * scale
    runs = [[r["msg"] for r in ev if r["cat"] == "run"
             and "path" in r and r["path"].endswith(".npy")]
            for ev in (tev, jev)]
    assert [m.replace(npy["port"], "P") for m in runs[0]] == \
        [m.replace(npy["jax"], "P") for m in runs[1]] == \
        ["logits [300, 5] saved to P"]


def test_save_logits_after_training(files, capsys):
    """--save-logits after training writes the trained model's logits:
    equal to --eval-only on the checkpoint it saved (the same weights,
    the same ops)."""
    root, prefix, _ = files
    ck, a, b = (str(root / n) for n in ("ck2", "a.npy", "b.npy"))
    base = ["--cpu", "-file", prefix, "-layers", "24-16-5", "--impl", "ell"]
    assert cli.main(base + ["-e", "2", "--checkpoint", ck,
                            "--save-logits", a]) == 0
    assert cli.main(base + ["--resume", ck, "--eval-only",
                            "--save-logits", b]) == 0
    assert os.path.exists(a)
    np.testing.assert_array_equal(np.load(a), np.load(b))
