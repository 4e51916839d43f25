"""roc-lint over the port (roc_tpu_torch/analysis): each AST rule fires on a
planted violation and stays quiet on the allowed and pragma'd forms; the
concurrency and protocol rules give the JAX package's findings on one
stdlib-only fixture tree laid under either package; the model checker
reports as the JAX package's; the wire spec's kinds and fields are the
JAX package's; the port's tree is clean with an empty baseline; the CLI
gate, the shrink-only ratchet and the report's two analysis views; the
``utils/resilience.py`` shim; and the lint repairs that changed code.
"""

import ast
import contextlib
import io
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from roc_tpu.analysis import concurrency_lint as jconc
from roc_tpu.analysis import modelcheck as jmc
from roc_tpu.analysis import protocol_lint as jproto
from roc_tpu.analysis import protocol_specs as jspecs
from roc_tpu_torch import report
from roc_tpu_torch.analysis import concurrency_lint as conc
from roc_tpu_torch.analysis import modelcheck as mc
from roc_tpu_torch.analysis import protocol_lint as proto
from roc_tpu_torch.analysis import protocol_specs as specs
from roc_tpu_torch.analysis.__main__ import main as lint_main
from roc_tpu_torch.analysis.ast_lint import RULES, run_ast_lint
from roc_tpu_torch.analysis.driver import all_rule_names
from roc_tpu_torch.analysis.findings import (Finding, dedupe, load_baseline,
                                             save_baseline, shrink_baseline,
                                             split_findings)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "roc_tpu_torch"


def _plant(root, relpath, text):
    p = root / relpath
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(text)


def _lines(findings, rule):
    return sorted({f.line for f in findings if f.rule == rule})


# ------------------------------------------------------------ AST rules

AST_CASES = {
    # rule: (path under roc_tpu_torch/, source, lines that fire)
    "stdout-print": ("train/x.py",
                     "import sys\n"
                     "print('a')\n"                                # 2
                     "print('b', file=sys.stderr)\n"
                     "print(format_metrics(0, {}))\n"
                     "print('c')  # roc-lint: ok=stdout-print\n",
                     [2]),
    "host-sync-hot-path": ("ops/h.py",
                           "import numpy as np\n"
                           "import torch\n"
                           "def f(x: torch.Tensor, n):\n"
                           "    a = x.item()\n"                       # 4
                           "    b = x[:, 0].tolist()\n"               # 5
                           "    c = x.cpu()\n"                        # 6
                           "    torch.cuda.synchronize()\n"           # 7
                           "    d = int(x.sum())\n"                   # 8
                           "    e = float(n) + int(x.shape[0])\n"
                           "    k = np.zeros(3).tolist()\n"
                           "    y = torch.cumsum(x, 0).tolist()\n"    # 11
                           "    s = x * 2\n"
                           "    w = float(s[0])\n"                    # 13
                           "    # the result: roc-lint: ok=host-sync-hot-path\n"
                           "    z = x.numpy()\n"
                           "    return int(len(k))\n",
                           [4, 5, 6, 7, 8, 11, 13]),
    "sync-h2d-in-loop": ("ops/l.py",
                         "import torch\n"
                         "def f(blocks, dev):\n"
                         "    out = []\n"
                         "    for b in blocks:\n"
                         "        out.append(torch.as_tensor(b, device=dev))\n"  # 5
                         "        out.append(b.to(dev))\n"                      # 6
                         "        out.append(b.cuda())\n"                       # 7
                         "        out.append(b.to(torch.float32))\n"
                         "        out.append(torch.as_tensor(b))\n"
                         "    w = [torch.tensor(b, device='cuda') for b in blocks]\n"  # 10
                         "    return torch.as_tensor(blocks[0], device=dev), w\n",
                         [5, 6, 7, 10]),
    "unobserved-step": ("train/t.py",
                        "class T:\n"
                        "    def __init__(self):\n"
                        "        self._train_step = lambda lr: self.step(lr)\n"  # 3
                        "        self._eval_step = ObservedStep(self.evaluate,\n"
                        "                                       name='eval_step')\n"
                        "    def train(self):\n"
                        "        run_epoch_loop(self, 3, self.step, self._eval_step)\n"  # 7
                        "        return run_epoch_loop(self, 3, self._train_step,\n"
                        "                              self._eval_step)\n",
                        [3, 7]),
    "kernel-fallback": ("kernels/k.py",
                        "def k(x):\n"
                        "    if x.device.type == 'cpu':\n"
                        "        return k_plain(x)\n"
                        "    try:\n"
                        "        return launch(x)\n"
                        "    except RuntimeError:\n"
                        "        return k_plain(x)\n"                  # 7
                        "def k2(x):\n"
                        "    try:\n"
                        "        return launch(x)\n"
                        "    except OSError as e:\n"
                        "        raise RuntimeError('no kernel') from e\n"
                        "def k3(x):\n"
                        "    try:\n"
                        "        return launch(x)\n"
                        "    except OSError:\n"
                        "        return x\n",                          # 17
                        [7, 17]),
    "swallowed-exception": ("resilience/r.py",
                            "def f():\n"
                            "    try:\n"
                            "        g()\n"
                            "    except:\n"                        # 4
                            "        raise\n"
                            "    try:\n"
                            "        g()\n"
                            "    except OSError:\n"                # 8
                            "        pass\n"
                            "    try:\n"
                            "        g()\n"
                            "    # cleanup: roc-lint: ok=swallowed-exception\n"
                            "    except OSError:\n"
                            "        pass\n"
                            "    try:\n"
                            "        g()\n"
                            "    except OSError as e:\n"
                            "        emit('resilience', str(e))\n",
                            [4, 8]),
    "event-clock": ("serve/e.py",
                    "def f():\n"
                    "    emit('run', 'x', t=1.0)\n"                 # 2
                    "    emit('run', 'x', proc=3)\n"                # 3
                    "    emit('run', 'x', epoch=3)\n"
                    "    return {'cat': 'run', 'msg': 'x'}\n",      # 5
                    [2, 3, 5]),
    "metric-adhoc": ("serve/m.py",
                     "class S:\n"
                     "    def f(self):\n"
                     "        self._n_ok += 1\n"                    # 3
                     "        self.lat_ms.append(1.0)\n"            # 4
                     "        self.n_ok += 1\n"
                     "        self.rows.append(1)\n",
                     [3, 4]),
    "dequant-hot-path": ("serve/d.py",
                         "import numpy as np\n"
                         "import torch\n"
                         "def f(self, table, rows):\n"
                         "    a = table.astype(np.float32)\n"              # 4
                         "    b = self.table.to(torch.float32)\n"          # 5
                         "    c = self.stage.float()\n"                    # 6
                         "    d = np.asarray(table, dtype=np.float32)\n"   # 7
                         "    e = rows.astype(np.float32)\n"
                         "    g = self.table.to(self.device)\n"
                         "    return a, b, c, d, e, g\n",
                         [4, 5, 6, 7]),
}


def test_every_ast_rule_has_a_case():
    assert sorted(AST_CASES) == sorted(r.name for r in RULES)


@pytest.mark.parametrize("rule", sorted(AST_CASES))
def test_ast_rule_fires_on_its_violations_only(tmp_path, rule):
    """The rule's planted file: exactly the violating lines fire; the
    allowed forms and the pragma'd line stay quiet; a file outside the
    rule's scope is not read (the same source under ``core/``)."""
    rel, src, want = AST_CASES[rule]
    _plant(tmp_path, f"{PKG}/{rel}", src)
    got = run_ast_lint(str(tmp_path), select=[rule])
    assert _lines(got, rule) == want, [f.render() for f in got]
    if rule not in ("stdout-print", "event-clock"):
        other = tmp_path / "other"
        _plant(other, f"{PKG}/core/graph.py", src)
        assert run_ast_lint(str(other), select=[rule]) == []


def test_allowed_surfaces_may_print(tmp_path):
    """The CLIs whose stdout is their product may print; the bus module
    may hand-roll records."""
    for rel in ("report.py", "obs/timeline.py", "analysis/__main__.py",
                "serve/export.py"):
        _plant(tmp_path, f"{PKG}/{rel}", "print('product')\n")
    _plant(tmp_path, f"{PKG}/obs/events.py",
           "R = {'cat': 'run', 'msg': 'x'}\n")
    assert run_ast_lint(str(tmp_path),
                        select=["stdout-print", "event-clock"]) == []


def test_unknown_rule_raises(tmp_path):
    with pytest.raises(ValueError, match="unknown lint rule"):
        run_ast_lint(str(tmp_path), select=["no-such-rule"])


# ------------------------- concurrency + protocol: the JAX package's rules

SHARED_TREE = {
    "conc/sig.py":
        "import signal\n"
        "import threading\n"
        "import numpy as np\n"
        "_LOCK = threading.Lock()\n"
        "FLAG = [False]\n"
        "def _helper():\n"
        "    emit('run', 'x')\n"
        "def bad(signum, frame):\n"
        "    import os\n"
        "    with _LOCK:\n"
        "        FLAG[0] = True\n"
        "    print('caught')\n"
        "    np.zeros(3)\n"
        "    _helper()\n"
        "def good(signum, frame):\n"
        "    FLAG[0] = True\n"
        "def install():\n"
        "    signal.signal(signal.SIGTERM, bad)\n"
        "    signal.signal(signal.SIGINT, good)\n"
        "    signal.signal(signal.SIGUSR1, signal.SIG_DFL)\n",
    "conc/locks.py":
        "import subprocess\n"
        "import threading\n"
        "import time\n"
        "A = threading.Lock()\n"
        "B = threading.Lock()\n"
        "def t1():\n"
        "    with A:\n"
        "        with B:\n"
        "            pass\n"
        "def t2():\n"
        "    with B:\n"
        "        with A:\n"
        "            pass\n"
        "class Box:\n"
        "    def __init__(self):\n"
        "        self._lock = threading.Lock()\n"
        "        self._cv = threading.Condition()\n"
        "        self._stop = threading.Event()\n"
        "        self.items = []\n"
        "        self._t = threading.Thread(target=self._run, daemon=True)\n"
        "        self._t.start()\n"
        "    def _run(self):\n"
        "        while not self._stop.is_set():\n"
        "            self.items.append(1)\n"
        "    def close(self):\n"
        "        self._stop.set()\n"
        "    def size(self):\n"
        "        return len(self.items)\n"
        "    def locked_size(self):\n"
        "        with self._lock:\n"
        "            return len(self.items)\n"
        "    def wait_one(self):\n"
        "        with self._cv:\n"
        "            self._cv.wait()\n"
        "    def wait_ok(self):\n"
        "        with self._cv:\n"
        "            while not self.items:\n"
        "                self._cv.wait()\n"
        "    def slow(self, fut, path):\n"
        "        with self._lock:\n"
        "            time.sleep(0.1)\n"
        "            open(path).read()\n"
        "            fut.result()\n"
        "            subprocess.run(['true'])\n"
        "            self._t.join()\n"
        "        self._lock.acquire()\n"
        "        try:\n"
        "            time.sleep(0.1)\n"
        "        finally:\n"
        "            self._lock.release()\n"
        "def orphan():\n"
        "    t = threading.Thread(target=t1)\n"
        "    t.start()\n"
        "def joined():\n"
        "    t = threading.Thread(target=t2)\n"
        "    t.start()\n"
        "    t.join()\n",
    "conc/ckpt.py":
        "import os\n"
        "class CheckpointRotation:\n"
        "    def __init__(self, prefix):\n"
        "        self.prefix = prefix\n"
        "    def save(self, trainer):\n"
        "        return self.prefix\n"
        "def checkpoint_trainer(trainer, path):\n"
        "    return path\n"
        "def ungated(trainer):\n"
        "    rot = CheckpointRotation('/tmp/shared')\n"
        "    rot.save(trainer)\n"
        "    checkpoint_trainer(trainer, '/tmp/x')\n"
        "def gated(trainer):\n"
        "    if process_index() != 0:\n"
        "        return\n"
        "    checkpoint_trainer(trainer, '/tmp/x')\n"
        "def per_process(trainer):\n"
        "    rot = CheckpointRotation(f'/tmp/r{os.getpid()}')\n"
        "    rot.save(trainer)\n"
        "def waived(trainer):\n"
        "    # one writer by construction: roc-lint: ok=artifact-lock-ownership\n"
        "    checkpoint_trainer(trainer, '/tmp/y')\n",
    "serve/router.py":
        "class Router:\n"
        "    def submit(self, ids):\n"
        "        return ids\n"
        "    def _dispatch(self, rep, sub):\n"
        "        rep.send({'kind': 'req', 'id': 1, 'ids': [],\n"
        "                  'deadline_ms': 5})\n"
        "    def _fetch(self, rep):\n"
        "        rep.send({'kind': 'bogus', 'x': 1})\n"
        "    def _read_loop(self, msg):\n"
        "        kind = msg.get('kind')\n"
        "        if kind == 'ready':\n"
        "            pass\n"
        "        elif kind == 'res':\n"
        "            pass\n",
    "serve/replica.py":
        "def serve_loop(wire, msg):\n"
        "    kind = msg.get('kind')\n"
        "    if kind != 'req':\n"
        "        return\n"
        "    wire.send({'kind': 'res', 'id': 1, 'ok': True, 'extra': 2})\n",
    "utils/order.py":
        "import os\n"
        "def commit_manifest(path):\n"
        "    return path\n"
        "def bad(tmp, path):\n"
        "    commit_manifest(path)\n"
        "    os.replace(tmp, path)\n"
        "def good(tmp, path):\n"
        "    os.replace(tmp, path)\n"
        "    commit_manifest(path)\n",
}


@pytest.fixture(scope="module")
def shared_trees(tmp_path_factory):
    """The fixture tree under ``roc_tpu/`` (for the JAX package) and
    under ``roc_tpu_torch/`` (for the port)."""
    root = tmp_path_factory.mktemp("shared")
    for pkg in ("roc_tpu", PKG):
        for rel, src in SHARED_TREE.items():
            _plant(root / pkg, f"{pkg}/{rel}", src)
    return str(root / "roc_tpu"), str(root / PKG)


def _keyed(findings, pkg):
    """(rule, unit, line) with the package prefix taken off the unit."""
    return sorted({(f.rule, f.unit.replace(pkg + "/", "", 1), f.line or 0)
                   for f in findings})


def test_concurrency_rules_match_the_jax_packages(shared_trees):
    """Every concurrency rule fires on the shared tree, and the port's
    findings are the JAX package's, rule, file and line."""
    jroot, troot = shared_trees
    j = jconc.run_concurrency_lint(jroot)
    t = conc.run_concurrency_lint(troot)
    assert _keyed(t, PKG) == _keyed(j, "roc_tpu")
    assert {f.rule for f in t} == set(conc.CONCURRENCY_RULES)
    assert conc.CONCURRENCY_RULES == jconc.CONCURRENCY_RULES


def test_protocol_rules_match_the_jax_packages(shared_trees):
    """The wire, drift and commit-order rules fire on the shared tree as
    the JAX package's do; the model-check rule on a seeded model."""
    jroot, troot = shared_trees
    j = jproto.run_protocol_lint(jroot)
    t = proto.run_protocol_lint(troot)
    assert _keyed(t, PKG) == _keyed(j, "roc_tpu")
    assert {f.rule for f in t} == set(proto.PROTOCOL_RULES) - {
        "modelcheck-invariant"}
    assert proto.PROTOCOL_RULES == jproto.PROTOCOL_RULES
    for name, seed in mc.SEEDS.items():
        got = proto.run_protocol_lint(
            troot, select=["modelcheck-invariant"],
            model_reports=[mc.run_model(name, seed=seed)])
        want = jproto.run_protocol_lint(
            jroot, select=["modelcheck-invariant"],
            model_reports=[jmc.run_model(name, seed=seed)])
        assert [(f.rule, f.unit, f.key, f.detail) for f in got] == \
            [(f.rule, f.unit, f.key, f.detail) for f in want]
        assert got and got[0].rule == "modelcheck-invariant"


def test_concurrency_surfaces_match(shared_trees):
    jroot, troot = shared_trees
    j = jconc.concurrency_surface(jconc.TreeModel(jroot))
    t = conc.concurrency_surface(conc.TreeModel(troot))
    strip = lambda s, p: json.loads(json.dumps(s).replace(p + "/", ""))  # noqa: E731
    j, t = strip(j, "roc_tpu"), strip(t, PKG)
    assert t["modules"] == j["modules"]
    assert t["totals"]["threads"] == j["totals"]["threads"] == 3


def test_port_vocabulary_torch_waits_and_rank_gates(tmp_path):
    """The port's own vocabulary: torch's device waits and collectives
    block under a lock; ``get_rank()``, ``rank == 0`` and the ``RANK``
    variable are process gates of a rotation write."""
    _plant(tmp_path, f"{PKG}/w.py",
           "import os\n"
           "import threading\n"
           "import torch\n"
           "import torch.distributed as dist\n"
           "_L = threading.Lock()\n"
           "def f(x):\n"
           "    with _L:\n"
           "        torch.cuda.synchronize()\n"            # 8
           "        y = x.item()\n"                        # 9
           "        z = x.cpu()\n"                         # 10
           "        w = x.to('cuda')\n"                    # 11
           "        dist.all_reduce(x)\n"                  # 12
           "        dist.barrier()\n"                      # 13
           "        n = len(x)\n"
           "def g1(trainer):\n"
           "    if torch.distributed.get_rank() != 0:\n"
           "        return\n"
           "    checkpoint_trainer(trainer, '/tmp/a')\n"
           "def g2(trainer):\n"
           "    rank = trainer.rank\n"
           "    if rank == 0:\n"
           "        save_checkpoint('/tmp/b', trainer)\n"
           "def g3(trainer):\n"
           "    if os.environ['RANK'] == '0':\n"
           "        checkpoint_trainer(trainer, '/tmp/c')\n"
           "def g4(trainer):\n"
           "    checkpoint_trainer(trainer, '/tmp/d')\n")  # 27
    got = conc.run_concurrency_lint(str(tmp_path))
    assert _lines(got, "blocking-under-lock") == [8, 9, 10, 11, 12, 13]
    assert _lines(got, "artifact-lock-ownership") == [27]


# ----------------------------------------------------- the model checker

def test_modelcheck_reports_equal_the_jax_packages():
    """Unseeded and under every seeded bug: the same states,
    transitions, verdicts and counterexample schedules, and each seeded
    bug is caught."""
    assert mc.STATE_BUDGET == jmc.STATE_BUDGET and mc.MODELS == jmc.MODELS
    assert [r.to_json() for r in mc.check_all()] == \
        [r.to_json() for r in jmc.check_all()]
    assert all(not r.violations and r.complete for r in mc.check_all())
    for name in mc.MODELS:
        for seed in (mc.SEEDS[name],) + mc.EXTRA_SEEDS.get(name, ()):
            got = mc.run_model(name, seed=seed)
            assert got.to_json() == jmc.run_model(name, seed=seed).to_json()
            assert got.violations, (name, seed)


def test_wire_spec_is_the_jax_packages():
    """The port speaks the JAX package's wire: every channel's kinds and
    fields equal, the files the same but for the package prefix; the
    transition sites and model invariants equal."""
    def swap(path):
        return path.replace(PKG + "/", "roc_tpu/", 1)
    assert len(specs.WIRE_CHANNELS) == len(jspecs.WIRE_CHANNELS)
    for t, j in zip(specs.WIRE_CHANNELS, jspecs.WIRE_CHANNELS):
        assert t["name"] == j["name"]
        assert (swap(t["sender"]), swap(t["receiver"])) == \
            (j["sender"], j["receiver"])
        assert t["kinds"] == j["kinds"]
    for tt, jt in ((specs.LIFECYCLE_SITES, jspecs.LIFECYCLE_SITES),
                   (specs.COMMIT_SITES, jspecs.COMMIT_SITES)):
        assert {swap(k): v for k, v in tt.items()} == jt
    assert specs.MODEL_INVARIANTS == jspecs.MODEL_INVARIANTS
    assert specs.MANIFEST_COMMITTERS == jspecs.MANIFEST_COMMITTERS
    assert specs.SHARD_WRITERS == jspecs.SHARD_WRITERS


# --------------------------------------------------- the tree and the CLI

@pytest.fixture(scope="module")
def tree_payload():
    """``main(['--json', '--strict'])`` over the checkout, in process."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = lint_main(["--json", "--strict", "--root", _REPO])
    return rc, json.loads(buf.getvalue())


def test_tree_is_clean_and_the_baseline_empty(tree_payload):
    rc, payload = tree_payload
    assert rc == 0
    assert payload["findings"] == [] and payload["stale"] == []
    assert load_baseline(os.path.join(
        _REPO, PKG, "analysis", "lint_baseline.json")) == set()
    with open(os.path.join(_REPO, PKG, "analysis",
                           "lint_baseline.json")) as f:
        assert json.load(f) == {"version": 1, "findings": []}


def test_tree_surfaces_document_the_ports_threads(tree_payload):
    """The surfaces name the port's threads, locks and handlers, and its
    five protocol modules' sites, all present."""
    _, payload = tree_payload
    mods = {m["module"]: m for m in payload["concurrency_surface"]["modules"]}
    for rel in ("serve/router.py", "serve/replica.py", "serve/server.py",
                "resilience/async_save.py", "obs/heartbeat.py",
                "obs/compile_watch.py", "core/streaming.py"):
        assert mods[f"{PKG}/{rel}"]["threads"], rel
    assert mods[f"{PKG}/resilience/preempt.py"]["handlers"]
    assert mods[f"{PKG}/kernels/_build.py"]["locks"]
    ps = payload["protocol_surface"]
    assert ps["totals"]["violations"] == 0
    assert all(s["present"] for s in ps["sites"])
    assert {k["status"] for c in ps["channels"]
            for k in c["kinds"].values()} == {"ok"}


def test_analysis_modules_import_no_torch():
    """The analysis levels, the merger and the report name no torch and
    nothing of the JAX package in their imports."""
    paths = [os.path.join(_REPO, PKG, "analysis", n)
             for n in os.listdir(os.path.join(_REPO, PKG, "analysis"))
             if n.endswith(".py")]
    paths += [os.path.join(_REPO, PKG, "obs", "timeline.py"),
              os.path.join(_REPO, PKG, "report.py")]
    for p in paths:
        with open(p) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import)
                     else [node.module or ""]
                     if isinstance(node, ast.ImportFrom) else [])
            for n in names:
                assert n.split(".")[0] not in ("torch", "jax", "roc_tpu"), \
                    (p, n)


def test_cli_strict_exits_zero_on_the_tree():
    """The gate: ``python -m roc_tpu_torch.analysis --strict`` exits 0 in a
    fresh process in under 30 s."""
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "roc_tpu_torch.analysis",
                        "--strict"], cwd=_REPO, capture_output=True,
                       text=True, timeout=120)
    took = time.perf_counter() - t0
    assert r.returncode == 0, r.stdout + r.stderr
    assert "roc-lint: 0 new, 0 baselined, 0 stale" in r.stdout
    assert took < 30.0, took


def test_list_rules_and_groups(capsys):
    assert lint_main(["--list-rules"]) == 0
    names = capsys.readouterr().out.split()
    assert names == all_rule_names()
    assert set(conc.CONCURRENCY_RULES) | set(proto.PROTOCOL_RULES) <= \
        set(names)
    assert lint_main(["--select", "no-such-rule"]) == 2


def _cli(root, *args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = lint_main(["--root", str(root), *args])
    return rc, buf.getvalue()


def test_baseline_split_and_shrink_only(tmp_path):
    bp = str(tmp_path / "baseline.json")
    save_baseline(bp, ["r|u|a", "r|u|gone"])
    findings = [Finding("r", "u", "m", key="a"),
                Finding("r", "u", "m", key="new")]
    new, old, stale = split_findings(findings, load_baseline(bp))
    assert ([f.key for f in new], [f.key for f in old], stale) == \
        (["new"], ["a"], {"r|u|gone"})
    assert shrink_baseline(bp, findings) == {"r|u|a"}
    assert load_baseline(bp) == {"r|u|a"}
    assert len(dedupe([Finding("r", "u", "m", key="k"),
                       Finding("r", "u", "m2", key="k")])) == 1


def test_cli_ratchet_bites(tmp_path):
    """A planted violation in a scratch tree fails the CLI."""
    _plant(tmp_path, f"{PKG}/leaky.py", "print('oops stdout')\n")
    rc, out = _cli(tmp_path, "--select", "stdout-print")
    assert rc == 1 and "leaky.py:1" in out
    rc, out = _cli(tmp_path, "--select", "concurrency")
    assert rc == 0 and "0 new" in out


def test_cli_update_baseline_shrinks_never_absorbs(tmp_path):
    """--update-baseline drops the stale entry of the rule that ran,
    keeps another rule's entry, and never absorbs the live finding."""
    _plant(tmp_path, f"{PKG}/leaky.py", "print('oops stdout')\n")
    bp = tmp_path / PKG / "analysis" / "lint_baseline.json"
    bp.parent.mkdir(parents=True)
    bp.write_text(json.dumps(
        {"version": 1, "findings": ["lock-order-cycle|x|y",
                                    "stdout-print|gone|x"]}))
    rc, _ = _cli(tmp_path, "--select", "stdout-print", "--update-baseline")
    assert rc == 1
    assert json.loads(bp.read_text())["findings"] == ["lock-order-cycle|x|y"]


def test_cli_selective_run_reports_no_phantom_stale(tmp_path):
    _plant(tmp_path, f"{PKG}/clean.py", "x = 1\n")
    bp = tmp_path / "b.json"
    bp.write_text(json.dumps({"version": 1,
                              "findings": ["lock-order-cycle|x|y"]}))
    rc, out = _cli(tmp_path, "--select", "stdout-print", "--strict",
                   "--baseline", str(bp))
    assert rc == 0, out
    assert "0 stale" in out and "no longer fire" not in out
    rc, out = _cli(tmp_path, "--select", "concurrency", "--strict",
                   "--baseline", str(bp))
    assert rc == 1 and "1 stale" in out


# ----------------------------------------------------- the report's views

def test_report_renders_both_views_of_a_json_payload(tree_payload,
                                                     tmp_path, capsys):
    """``--concurrency FILE`` and ``--protocol FILE`` render the CLI's
    ``--json`` payload without event files; with event files the same
    tables come from the surfaces' events."""
    _, payload = tree_payload
    path = tmp_path / "lint.json"
    path.write_text(json.dumps(payload))
    assert report.main(["--concurrency", str(path),
                        "--protocol", str(path)]) == 0
    out = capsys.readouterr().out
    assert "== concurrency surface" in out
    assert f"{PKG}/serve/router.py" in out and "_read_loop" in out
    assert "== wire vocabulary: router->replica" in out
    assert "== protocol models" in out and "router-lifecycle" in out
    assert "== protocol transition sites" in out
    ev = tmp_path / "ev.jsonl"
    conc_s = payload["concurrency_surface"]
    prot_s = payload["protocol_surface"]
    recs = [{"t": 1.0, "cat": "analysis", "kind": "concurrency_surface",
             "modules": conc_s["modules"], "totals": conc_s["totals"]},
            {"t": 2.0, "cat": "protocol", "kind": "protocol_surface",
             "channels": prot_s["channels"], "models": prot_s["models"],
             "totals": prot_s["totals"]}]
    ev.write_text("".join(json.dumps(r) + "\n" for r in recs))
    assert report.main([str(ev)]) == 0
    out2 = capsys.readouterr().out
    assert f"{PKG}/serve/router.py" in out2
    assert "== wire vocabulary: replica->router" in out2
    assert report.main(["--protocol", str(tmp_path / "nope.json")]) == 2


# ------------------------------------------------------------ the shim

def test_resilience_shim_exports_the_jax_names():
    from roc_tpu.utils import resilience as jshim
    from roc_tpu_torch.utils import resilience as shim
    names = {n for n in vars(jshim) if not n.startswith("_")
             and n != "annotations"}
    assert names <= set(vars(shim))
    from roc_tpu_torch.resilience.recovery import CheckpointRotation
    assert shim.CheckpointRotation is CheckpointRotation


# ------------------------------------------------- the lint repairs

@pytest.mark.parametrize("impl,aggr", [("scan", "sum"), ("flat_sum", "max")])
def test_routes_read_no_table_to_the_host_per_call(monkeypatch, impl, aggr):
    """Routes 'scan' (its chunk offsets) and the flat max (its runs' row
    ends) take the host bits of their tables from the graph context,
    read once where it is built: a call reads nothing to the host, and
    gives the bits of the op that reads them itself."""
    from roc_tpu_torch.core.graph import synthetic_dataset
    from roc_tpu_torch.ops import aggregate as agg
    from roc_tpu_torch.train.trainer import make_graph_context
    ds = synthetic_dataset(300, 6, in_dim=8, num_classes=3, seed=1)
    gctx = make_graph_context(ds, impl, symmetric=True, device="cpu",
                              chunk=64)
    x = torch.from_numpy(np.random.RandomState(0).randn(
        300, 8).astype(np.float32))
    reads = []
    real = torch.Tensor.tolist
    monkeypatch.setattr(torch.Tensor, "tolist",
                        lambda self: reads.append(1) or real(self))
    got = gctx.aggregate(x, aggr)
    assert reads == []
    full = gctx._gathered_with_zero(x)
    if impl == "scan":
        want = agg.aggregate_scan(full, gctx.edge_src, gctx.edge_dst,
                                  gctx.num_rows, chunk=64)
    else:
        want = agg.aggregate_flat_max(full, gctx.flat8_idx, gctx.flat8_dst,
                                      gctx.num_rows)
        want = torch.where(torch.isfinite(want), want, 0.0)
    assert reads        # the op alone reads them
    assert torch.equal(got, want)
