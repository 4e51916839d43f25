"""The port's dataset converter (roc_tpu_torch/convert_dataset.py) against
the JAX package's scripts/convert_dataset.py: every file it writes from
the same raw input is byte for byte the script's, a missing raw file or
a missing ``ogb`` fails the same way, its CLI runs with JAX and the JAX
package blocked (the card machine's situation), the sha256 constants
chip_smoke.py pins are the script's outputs, and the BASELINE.md
config-1 gate holds through the port's converter and CLI on the CPU.
The Planetoid writer is tests/test_dataset_convert.py's; the citeseer
and DGL writers follow that file's, with a second neighbour per node in
citeseer and repeated edges, both directions and self loops in the DGL
pair."""

import hashlib
import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SCRIPTS = os.path.join(_REPO, "scripts")
sys.path.insert(0, _SCRIPTS)
sys.path.insert(0, _REPO)
sys.path.insert(0, os.path.join(_REPO, "tests"))

import chip_smoke  # noqa: E402
import convert_dataset as jconv  # noqa: E402  (the JAX package's script)
from test_dataset_convert import _write_planetoid_fixture  # noqa: E402

from roc_tpu_torch import convert_dataset as tconv  # noqa: E402
from roc_tpu_torch import native  # noqa: E402

SUFFIXES = chip_smoke.CONVERTED_SUFFIXES


# ---------------------------------------------------------------- fixtures

def _write_citeseer_fixture(raw_dir):
    """Citeseer's quirks: test.index permuted AND with a gap (node 17, an
    isolated vertex absent from tx/ty)."""
    import scipy.sparse as sp
    rng = np.random.RandomState(3)
    V, F, C, n_train, n_all = 20, 10, 3, 4, 14
    dense = (rng.rand(V, F) < 0.4).astype(np.float32)
    onehot = np.eye(C, dtype=np.int32)[rng.randint(0, C, size=V)]
    test_real = np.array([14, 15, 16, 18, 19])
    test_reorder = test_real[rng.permutation(len(test_real))]
    dense[17] = 0
    objs = {"x": sp.csr_matrix(dense[:n_train]), "y": onehot[:n_train],
            "allx": sp.csr_matrix(dense[:n_all]), "ally": onehot[:n_all],
            "tx": sp.csr_matrix(dense[test_reorder]),
            "ty": onehot[test_reorder],
            "graph": {v: [int((v + 1) % V), int((v * 7) % V)]
                      for v in range(V)}}
    for ext, obj in objs.items():
        with open(os.path.join(raw_dir, f"ind.citeseer.{ext}"), "wb") as f:
            pickle.dump(obj, f)
    np.savetxt(os.path.join(raw_dir, "ind.citeseer.test.index"),
               test_reorder, fmt="%d")


def _write_dgl_fixture(raw_dir):
    """DGL's Reddit pair, with a COO adjacency that repeats edges, holds
    both directions of some and self loops of others: what the
    symmetrise-and-dedupe and the self-edge insertion must order."""
    import scipy.sparse as sp
    rng = np.random.RandomState(1)
    V, F = 40, 6
    np.savez(os.path.join(raw_dir, "reddit_data.npz"),
             feature=rng.rand(V, F).astype(np.float32),
             label=rng.randint(0, 4, size=V).astype(np.int64),
             node_types=rng.choice([0, 1, 2, 3], size=V))
    adj = sp.random(V, V, density=0.1, random_state=2, format="coo")
    row = np.concatenate([adj.row, adj.row[:9], adj.col[9:18],
                          [3, 7, 7, 21]])
    col = np.concatenate([adj.col, adj.col[:9], adj.row[9:18],
                          [3, 7, 7, 21]])
    sp.save_npz(os.path.join(raw_dir, "reddit_graph.npz"),
                sp.coo_matrix((np.ones(row.size), (row, col)),
                              shape=(V, V)))


# dataset -> (its fixture writer, or None: made without raw files)
RAW = {"cora": lambda d: _write_planetoid_fixture(d, "cora"),
       "citeseer": _write_citeseer_fixture,
       "reddit": _write_dgl_fixture,
       "cora-synth": None,
       "karate": None}


def _files(prefix):
    """``{suffix: bytes}`` of every file written under ``prefix``."""
    out = {}
    for s in SUFFIXES:
        if os.path.exists(prefix + s):
            with open(prefix + s, "rb") as f:
                out[s] = f.read()
    return out


@pytest.fixture(scope="module")
def raw_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("raw"))
    for write in RAW.values():
        if write is not None:
            write(d)
    return d


@pytest.fixture(scope="module")
def jax_outputs(raw_dir, tmp_path_factory):
    """The JAX script's files for each (dataset, --no-csv), written once."""
    root = tmp_path_factory.mktemp("jax_out")
    out = {}
    for name in RAW:
        for no_csv in (False, True):
            prefix = str(root / f"{name}{'_nocsv' if no_csv else ''}" / "d")
            argv = ["--dataset", name, "--raw-dir", raw_dir, "--out",
                    prefix] + (["--no-csv"] if no_csv else [])
            assert jconv.main(argv) == 0
            out[name, no_csv] = _files(prefix)
    return out


# ---------------------------------------------------------------- bytes

@pytest.mark.parametrize("path", ["native", "numpy"])
@pytest.mark.parametrize("no_csv", [False, True], ids=["csv", "no_csv"])
@pytest.mark.parametrize("name", sorted(RAW))
def test_outputs_byte_equal_to_the_jax_script(name, no_csv, path, raw_dir,
                                              jax_outputs, tmp_path,
                                              monkeypatch, capsys):
    """Every file the port writes equals the JAX script's byte for byte,
    through the port's native loaders (when built) and its numpy paths;
    the training hint names the port's CLI."""
    if path == "numpy":
        monkeypatch.setattr(native, "available", lambda: False)
    elif not native.available():
        pytest.skip("the port's native library does not build here")
    prefix = str(tmp_path / "out" / "d")
    argv = ["--dataset", name, "--raw-dir", raw_dir, "--out", prefix] + (
        ["--no-csv"] if no_csv else [])
    assert tconv.main(argv) == 0
    got, want = _files(prefix), jax_outputs[name, no_csv]
    names = set(SUFFIXES) - ({".feats.csv"} if no_csv else set())
    assert set(got) == set(want) == names
    for s in sorted(names):
        assert got[s] == want[s], f"{name}{s} differs from the JAX script's"
    out = capsys.readouterr().out
    assert f"# train: python -m roc_tpu_torch.train.cli -file {prefix} " \
        in out, out


@pytest.mark.parametrize("name", ["cora", "citeseer", "reddit"])
def test_parsed_dataset_equals_the_jax_script(name, raw_dir):
    """The converters' Dataset records agree field for field (the graph,
    features, labels, mask and classes), before any file is written."""
    def parse(mod):
        if name == "reddit":
            return mod.convert_dgl_reddit(raw_dir)
        return mod.convert_planetoid(raw_dir, name)
    got, want = parse(tconv), parse(jconv)
    np.testing.assert_array_equal(got.graph.row_ptr, want.graph.row_ptr)
    np.testing.assert_array_equal(got.graph.col_idx, want.graph.col_idx)
    for f in ("features", "labels", "mask"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert (got.num_classes, got.name) == (want.num_classes, want.name)


# the citeseer gap node and the permuted test ids land where the JAX
# script puts them (its own test checks them against the raw truth)
def test_citeseer_gap_and_permutation(raw_dir):
    ds = tconv.convert_planetoid(raw_dir, "citeseer")
    assert (ds.features[17] == 0).all() and ds.mask[17] == tconv.MASK_NONE
    assert (ds.mask == tconv.MASK_TEST).sum() == 5
    assert ds.graph.is_symmetric() and ds.graph.has_all_self_edges()


# ---------------------------------------------------------------- failures

def _missing(raw, which):
    """Raw files for ``which`` with one removed: ``(converter call, the
    missing path)``."""
    if which.startswith("planetoid"):
        _write_planetoid_fixture(raw, "cora")
        gone = os.path.join(raw, "ind.cora." + which.split(":")[1])
        os.unlink(gone)
        return (lambda mod: mod.convert_planetoid(raw, "cora")), gone
    _write_dgl_fixture(raw)
    gone = os.path.join(raw, which.split(":")[1])
    os.unlink(gone)
    return (lambda mod: mod.convert_dgl_reddit(raw)), gone


@pytest.mark.parametrize("which", ["planetoid:x", "planetoid:graph",
                                   "planetoid:test.index",
                                   "dgl:reddit_data.npz",
                                   "dgl:reddit_graph.npz"])
def test_missing_raw_file_fails_as_the_jax_script(which, tmp_path):
    """One raw file absent: both raise the same exception type, and the
    port's message names the missing path."""
    call, gone = _missing(str(tmp_path), which)
    with pytest.raises(Exception) as want:
        call(jconv)
    with pytest.raises(Exception) as got:
        call(tconv)
    assert type(got.value) is type(want.value)
    assert isinstance(got.value, FileNotFoundError)
    assert gone in str(got.value), str(got.value)
    assert str(got.value) == str(want.value)


def test_missing_raw_dir_through_main(tmp_path):
    """The CLI on an empty raw directory raises before writing a file."""
    prefix = str(tmp_path / "out" / "d")
    for mod in (jconv, tconv):
        with pytest.raises(FileNotFoundError, match="Planetoid"):
            mod.main(["--dataset", "pubmed", "--raw-dir", str(tmp_path),
                      "--out", prefix])
    assert not os.path.exists(os.path.dirname(prefix))


@pytest.mark.parametrize("name", ["ogbn-arxiv", "ogbn-products"])
def test_ogbn_without_ogb_exits_as_the_jax_script(name, tmp_path,
                                                  monkeypatch):
    """Without the ``ogb`` package both exit with SystemExit and the same
    advice, through the function and through the CLI."""
    monkeypatch.setitem(sys.modules, "ogb", None)
    monkeypatch.setitem(sys.modules, "ogb.nodeproppred", None)
    msgs = []
    for mod in (jconv, tconv):
        with pytest.raises(SystemExit) as e:
            mod.convert_ogbn(name, str(tmp_path))
        msgs.append(str(e.value))
        with pytest.raises(SystemExit) as e2:
            mod.main(["--dataset", name, "--raw-dir", str(tmp_path),
                      "--out", str(tmp_path / "d")])
        assert str(e2.value) == msgs[-1]
    assert msgs[0] == msgs[1] and "'ogb' package" in msgs[1]


# ---------------------------------------------------------------- no JAX

_BLOCKED = (
    "import json, runpy, sys\n"
    "sys.modules['jax'] = None\n"
    "sys.modules['roc_tpu'] = None\n"
    "sys.argv = ['convert_dataset'] + sys.argv[1:]\n"
    "try:\n"
    "    runpy.run_module('roc_tpu_torch.convert_dataset',\n"
    "                     run_name='__main__', alter_sys=True)\n"
    "except SystemExit as e:\n"
    "    assert e.code in (0, None), e.code\n"
    "mods = sorted(m for m, v in sys.modules.items() if v is not None\n"
    "              and (m in ('torch', 'roc_tpu') or\n"
    "                   m.startswith(('jax', 'roc_tpu.', 'torch.'))))\n"
    "print(json.dumps({'modules': mods}))\n")


@pytest.mark.parametrize("name", ["karate", "cora-synth"])
def test_cli_runs_with_jax_and_roc_tpu_blocked(name, tmp_path):
    """``python -m roc_tpu_torch.convert_dataset`` in a process whose
    ``sys.modules`` blocks ``jax`` and ``roc_tpu`` (an import of either
    raises): exit 0, no torch loaded, and the files hash to the
    constants chip_smoke.py pins."""
    prefix = str(tmp_path / "d" / name)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [_REPO, os.environ.get("PYTHONPATH", "")]))
    r = subprocess.run([sys.executable, "-c", _BLOCKED, "--dataset", name,
                        "--out", prefix], capture_output=True, text=True,
                       timeout=120, cwd=str(tmp_path), env=env)
    assert r.returncode == 0, r.stderr
    assert json.loads(r.stdout.splitlines()[-1]) == {"modules": []}
    assert {s: chip_smoke._sha256(prefix + s) for s in SUFFIXES} == \
        chip_smoke.CONVERTED_SHA256[name]


@pytest.mark.parametrize("name", ["karate", "cora-synth"])
def test_pinned_hashes_are_the_jax_scripts(name, jax_outputs):
    """chip_smoke.py's data phase holds the card machine's conversion to
    these constants: each is the sha256 of the JAX script's file."""
    want = {s: hashlib.sha256(b).hexdigest()
            for s, b in jax_outputs[name, False].items()}
    assert chip_smoke.CONVERTED_SHA256[name] == want


def test_module_imports_nothing_of_jax():
    """The module's own imports: numpy and the port's core.graph."""
    import ast
    with open(tconv.__file__) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add("." * node.level + (node.module or ""))
    assert names == {"__future__", "argparse", "os", "sys", "numpy",
                     ".core.graph", "pickle", "scipy.sparse",
                     "ogb.nodeproppred"}, names


# ---------------------------------------------------------------- gates

def _cli_accuracies(argv, capsys):
    from roc_tpu_torch.train import cli
    assert cli.main(argv) == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("[INFER]")]
    assert lines
    return tuple(float(x) for x in chip_smoke._ACCURACY.search(lines[-1]).groups()), lines


@pytest.mark.parametrize("mode", ["float32", "mixed"])
def test_config1_gate_through_the_port(mode, tmp_path, capsys):
    """BASELINE.md config 1 (scripts/cora_run.sh's flags) on cora-synth,
    converted by the port and trained by the port's CLI on the CPU: test
    and val accuracy >= 85 %, the JAX gate's floors
    (tests/test_dataset_convert.py test_cora_accuracy_gate)."""
    prefix = str(tmp_path / "d" / "cora")
    assert tconv.main(["--dataset", "cora-synth", "--out", prefix,
                       "--no-csv"]) == 0
    (val, test), lines = _cli_accuracies(
        ["--cpu", "-file", prefix] + chip_smoke.CONFIG1 + ["--dtype", mode],
        capsys)
    assert len(lines) == 4, lines
    assert val >= chip_smoke.CONFIG1_FLOOR and \
        test >= chip_smoke.CONFIG1_FLOOR, lines[-1]


def test_lint_lets_the_converter_print(tmp_path):
    """The converter's stdout is its product (the JAX script's summary
    and training hint): the port's stdout-print rule allows it there and
    still flags the same print in a module beside it."""
    from roc_tpu_torch.analysis.ast_lint import run_ast_lint
    pkg = tmp_path / "roc_tpu_torch"
    pkg.mkdir()
    for rel in ("convert_dataset.py", "convert.py"):
        (pkg / rel).write_text("print('# wrote x')\n")
    got = run_ast_lint(str(tmp_path), select=["stdout-print"])
    assert [f.unit for f in got] == ["roc_tpu_torch/convert.py"], got
