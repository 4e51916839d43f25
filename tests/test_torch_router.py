"""The port's replica fleet on the CPU: routers with ``cpu=True`` over one
module-scoped pair of artifacts exported by the port (the SGC 24-5 on
'akx' and the APPNP 24-16-5 on 'table', V = 2,000, each with two table
slices), held to the exporting ``Predictor.query``.

- answers, unsharded and ``sharded=True``: bit-equal on 'table' (a pure
  gather); within 1e-5 of the logit scale on 'akx', whose head GEMM runs
  at the bucket of the sub-request a replica receives, and a GEMM is
  bit-exact within one bucket size only;
- the four serve drills and the SIGTERM drain, as the JAX package's
  robustness tests run them on its router: every accepted request
  correct within 1e-5 of the logit scale or typed, none hangs;
- the table budget (exit 3 before ``ready``), the serve sites' parse and
  proc gate, ``Server.stats()``'s keys and spans;
- every line the port's router and replicas put on the wire, checked
  against the JAX package's declared protocol (``WIRE_CHANNELS``).

Every router passes ``--drain-timeout 3`` so that ``close()`` ends a
wedged replica within ~20 s.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from roc_tpu.analysis.protocol_specs import WIRE_CHANNELS
from roc_tpu_torch.analysis.protocol_specs import PORT_OPTIONAL
from roc_tpu_torch.core.graph import synthetic_dataset
from roc_tpu_torch.models import model_builders
from roc_tpu_torch.obs.events import get_bus
from roc_tpu_torch.resilience import inject
from roc_tpu_torch.serve import router as router_mod
from roc_tpu_torch.serve.errors import ServeTimeout
from roc_tpu_torch.serve.export import (build_predictor, export_predictor,
                                        load_predictor)
from roc_tpu_torch.serve.router import Router
from roc_tpu_torch.serve.server import Server
from roc_tpu_torch.train.trainer import TrainConfig

V, IN, C = 2000, 24, 5
TOL = 1e-5
# flavor -> (registry name, builder kwargs, layers, backend)
FLAVORS = {"akx": ("sgc", {"k": 2}, [IN, C], "auto"),
           "table": ("appnp", {"k": 3}, [IN, 16, C], "precomputed")}
# the JAX package's Server.stats() keys
STATS_KEYS = {"availability", "batch_p50_ms", "batch_p99_ms", "error_rate",
              "gather_p50_ms", "n_batches", "n_errors", "n_ok",
              "n_queries", "n_rejected_closed", "n_shed", "n_timeout",
              "queue_p50_ms", "rows_per_batch", "shed_rate", "window_s",
              "table_versions"}


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    ds = synthetic_dataset(V, 6, in_dim=IN, num_classes=C, seed=0)
    out = {}
    for flavor, (name, kw, layers, backend) in FLAVORS.items():
        model = model_builders()[name](layers, dropout_rate=0.5, **kw)
        pred = build_predictor(model, ds, TrainConfig(symmetric=True, seed=3),
                               device="cpu", backend=backend)
        art = str(tmp_path_factory.mktemp(flavor))
        man = export_predictor(pred, art, shards=2)
        out[flavor] = (art, pred, man, pred.query(np.arange(V)))
    return out


class _Sink(list):
    """An event-bus sink that keeps the records."""

    def write(self, record):
        self.append(record)

    def close(self):
        pass


@pytest.fixture
def events():
    sink = _Sink()
    bus = get_bus()
    bus.add_sink(sink)
    yield sink
    bus.sinks.remove(sink)


def _env(fault=None, **extra):
    env = os.environ.copy()
    env.pop("ROC_TPU_FAULT", None)
    if fault:
        env["ROC_TPU_FAULT"] = fault
    env.update(extra)
    return env


def _router(art, fault=None, env=None, **kw):
    kw.setdefault("default_deadline_ms", 30_000.0)
    return Router(art, n_replicas=2, cpu=True,
                  env=env if env is not None else _env(fault),
                  replica_args=["--drain-timeout", "3"], **kw)


def _close(got, want, scale):
    err = float(np.abs(np.asarray(got) - want).max())
    return err <= TOL * max(1.0, scale)


# ------------------------------------------------------------- answers

@pytest.mark.parametrize("sharded", [False, True])
@pytest.mark.parametrize("flavor", ["akx", "table"])
def test_router_answers_match_the_predictor(artifacts, flavor, sharded):
    """Requests of 1 to 1,500 ids (under the gather rider cap, split per
    shard above it, and a batch straddling the seam) through two
    replicas; a sharded fleet loads one slice each, under a per-replica
    budget of the slice's bytes."""
    art, pred, man, ref = artifacts[flavor]
    sb = man["shards"]
    seam = sb["plan"][0][1]
    rng = np.random.RandomState(5)
    batches = [rng.randint(0, V, size=n) for n in (1, 5, 8, 9, 64, 600,
                                                   1500)]
    batches.append(np.arange(seam - 6, seam + 6))
    budget = sb["bytes_per_replica"] if sharded else None
    with _router(art, sharded=sharded, table_budget_bytes=budget) as r:
        for ids in batches:
            got = np.asarray(r.submit(ids).result(timeout=60))
            want = pred.query(ids)
            assert got.shape == want.shape
            if flavor == "table":
                assert np.array_equal(got, want), ids.size
            else:
                assert _close(got, want, np.abs(want).max()), ids.size
        st = r.stats()
    assert st["n_ok"] == len(batches) and st["n_failed"] == 0
    shards = [tuple(x["shard"]) if x["shard"] else None
              for x in st["replicas"]]
    assert shards == ([tuple(p) for p in sb["plan"]] if sharded
                      else [None, None])
    if sharded:
        assert st["gather_p50_ms"] is not None


def test_table_budget_refuses_the_full_table(artifacts):
    """``--table-budget-bytes`` below the full table: the replica exits 3
    before ``ready``; a slice under the same budget serves, and its
    stdout carries only wire lines (``ready``, ``drained`` at stdin
    EOF)."""
    art, _, man, _ = artifacts["akx"]
    budget = str(man["shards"]["bytes_per_replica"])
    base = [sys.executable, "-m", "roc_tpu_torch.serve.replica", art,
            "--cpu", "--table-budget-bytes", budget]
    full, sliced = [subprocess.Popen(
        base + extra, stdin=subprocess.DEVNULL, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=_env())
        for extra in ([], ["--shard-index", "1", "--replica", "1"])]
    out, err = full.communicate(timeout=120)
    assert full.returncode == 3 and out == "", (out, err[-500:])
    assert "exceeds the per-replica budget" in err
    out, err = sliced.communicate(timeout=120)
    assert sliced.returncode == 0, err[-500:]
    lines = [json.loads(ln) for ln in out.splitlines()]
    assert [m["kind"] for m in lines] == ["ready", "drained"]
    assert lines[0]["shard"] == man["shards"]["plan"][1]
    assert lines[0]["table_bytes"] <= int(budget)
    assert lines[1]["clean"] is True


# -------------------------------------------------------------- drills

def test_router_failover_replica_sigkill(artifacts, events):
    """SIGKILL one of two replicas mid-load: every accepted request
    completes correct or with ServeTimeout, one replica stays alive, and
    the failover leaves its event."""
    art, _, _, ref = artifacts["akx"]
    scale = float(np.abs(ref).max())
    with _router(art, "replica_sigkill:2:1",
                 default_deadline_ms=20_000.0) as router:
        # warm both replicas first: a replica still in its first dispatch
        # never reaches the armed microbatch
        t_warm = time.monotonic() + 120.0
        while time.monotonic() < t_warm:
            for p in [router.submit([0, 1]) for _ in range(2)]:
                p.result(timeout=60)
            reps = router.stats()["replicas"]
            if (any(not x["alive"] for x in reps)
                    or all(x["served"] > 0 for x in reps)):
                break
            time.sleep(0.05)
        # a burst: least-loaded dispatch spreads it over both replicas
        # (a CPU dispatch ends in ~1 ms, so spaced requests would all go
        # to the idle replica 0)
        futs = [(i, router.submit([i % V, (i * 3) % 200]))
                for i in range(60)]
        ok = timeouts = 0
        for i, fut in futs:
            try:
                rows = fut.result(timeout=60)
                assert _close(rows, ref[[i % V, (i * 3) % 200]], scale), i
                ok += 1
            except ServeTimeout:
                timeouts += 1
        stats = router.stats()
    assert ok + timeouts == 60 and ok > 0
    assert [x["alive"] for x in stats["replicas"]] == [True, False]
    fo = [e for e in events if e.get("cat") == "serve"
          and e.get("kind") == "failover"]
    assert fo and fo[0]["replica"] == 1


def test_router_hedges_stalled_replica(artifacts, events):
    """replica_stall: replica 0 wedges a dispatch for an hour; the hedge
    answers from replica 1, and close() still ends the wedged process.
    The replicas run every bucket before ready (Predictor.warm), so the
    drill sends no warm-up request of its own, as the JAX package's
    does; the hedge keys on the median round trip, which a loaded host's
    slow first round trips do not move past the deadline."""
    art, _, _, ref = artifacts["akx"]
    scale = float(np.abs(ref).max())
    t0 = time.monotonic()
    with _router(art, "replica_stall:2:0", hedge_min_ms=150.0,
                 hedge_pct=0.5) as router:
        futs = []
        for i in range(40):
            futs.append((i, router.submit([i])))
            time.sleep(0.003)
        ok = timeouts = 0
        for i, fut in futs:
            try:
                assert _close(fut.result(timeout=60), ref[[i]], scale), i
                ok += 1
            except ServeTimeout:
                timeouts += 1
        stats = router.stats()
    assert ok + timeouts == 40 and ok > 0
    assert stats["n_hedge"] >= 1, stats
    assert any(e.get("cat") == "serve" and e.get("kind") == "hedge"
               for e in events)
    assert all(x.proc.poll() is not None for x in router.replicas)
    assert time.monotonic() - t0 < 60.0


def test_router_serve_io_redispatches(artifacts):
    """serve_io: a retryable replica failure is re-dispatched and the
    client gets the right answer."""
    art, _, _, ref = artifacts["akx"]
    scale = float(np.abs(ref).max())
    with _router(art, "serve_io:1:0") as router:
        futs = [router.submit([i]) for i in range(30)]
        for i, f in enumerate(futs):
            assert _close(f.result(timeout=60), ref[[i]], scale), i
        stats = router.stats()
    assert stats["n_ok"] == 30 and stats["n_failed"] == 0


def test_router_table_swap_mid_query_drill(artifacts):
    """table_swap_mid_query: replica 0 publishes a real edge-append
    version between a microbatch's capture and its dispatch; every
    answer equals the table before the swap or the one after, never a
    mix."""
    art, _, _, ref = artifacts["akx"]
    scale = float(np.abs(ref).max())
    pred2 = load_predictor(art, device="cpu")
    pred2.invalidate([0], [0])
    ref_new = pred2.query(np.arange(V))
    assert not np.array_equal(ref_new, ref)
    probe = np.arange(200)
    with _router(art, "table_swap_mid_query:1:0") as router:
        futs = [router.submit([int(i)]) for i in probe]
        versions = set()
        for i, f in enumerate(futs):
            rows = f.result(timeout=60)
            versions.add(rows.version)
            assert (_close(rows, ref[[i]], scale)
                    or _close(rows, ref_new[[i]], scale)), i
        stats = router.stats()
    assert stats["n_ok"] == probe.size
    assert versions <= {0, 1}


def test_replica_drains_gracefully_on_sigterm(artifacts):
    """SIGTERM to a replica: it stops admitting, finishes what is in
    flight, writes ``drained`` (clean) and exits 0; the router fails
    over around it."""
    art, _, _, ref = artifacts["akx"]
    scale = float(np.abs(ref).max())
    with _router(art, default_deadline_ms=20_000.0) as router:
        for i in range(10):
            assert _close(router.submit([i]).result(timeout=60), ref[[i]],
                          scale)
        victim = router.replicas[0].proc
        victim.send_signal(signal.SIGTERM)
        assert victim.wait(timeout=30) == 0
        for i in range(10, 20):
            assert _close(router.submit([i]).result(timeout=60), ref[[i]],
                          scale)
        stats = router.stats()
    assert [x["alive"] for x in stats["replicas"]] == [False, True]


# ------------------------------------------------ sites, stats, the wire

@pytest.mark.parametrize("site", ["replica_sigkill", "replica_stall",
                                  "table_swap_mid_query", "serve_io"])
def test_serve_sites_parse(site):
    spec = inject.parse(f"{site}:2:1")
    assert (spec.site, spec.epoch, spec.proc) == (site, 2, 1)


def test_serve_sites_fire_once_in_the_armed_proc(artifacts, events):
    """The ``:proc`` arm matches the replica index a replica notes; a site
    fires at or past its microbatch, once; table_swap_mid_query on a
    table with no mutation path records a ``fault_noop``."""
    _, tab, _, _ = artifacts["table"]

    class _Srv:
        pred = tab
    try:
        inject.disarm()
        inject.arm("serve_io:3:1")
        inject.note_proc_index(0)
        inject.serve_batch_hooks(_Srv(), 5)        # another replica
        inject.note_proc_index(1)
        inject.serve_batch_hooks(_Srv(), 2)        # before the index
        with pytest.raises(OSError, match="injected serve I/O"):
            inject.serve_batch_hooks(_Srv(), 5)
        inject.serve_batch_hooks(_Srv(), 6)        # spent
        inject.disarm()
        inject.arm("table_swap_mid_query:0")
        inject.serve_batch_hooks(_Srv(), 1)
        assert tab.published().version == 0
        assert any(e.get("kind") == "fault_noop" for e in events)
    finally:
        inject.disarm()


def test_server_stats_keys_spans_and_rids(artifacts, events):
    """``Server.stats()`` has the JAX package's keys; a closed server
    sheds typed and counts it; the microbatch spans carry the rids and
    flush as timeline events at close, after the clock_sync event."""
    _, pred, _, ref = artifacts["akx"]
    srv = Server(pred, max_wait_ms=0.0, name="stats_test")
    for i in range(6):
        srv.submit([i, i + 1], rid=f"r{i}").result(timeout=30)
    srv.close()
    late = srv.submit([0])
    with pytest.raises(Exception, match="closed"):
        late.result(timeout=5)
    st = srv.stats()
    assert set(st) == STATS_KEYS
    assert st["n_queries"] == 6 and st["n_ok"] == 6
    assert st["n_rejected_closed"] == 1 and st["n_batches"] >= 1
    assert st["availability"] == round(6 / 7, 4)
    assert st["table_versions"] == [0] and st["gather_p50_ms"] is None
    mine = [e for e in events if e.get("cat") == "timeline"]
    assert mine[0]["kind"] == "clock_sync"
    spans = [s for e in mine if e.get("kind") == "spans"
             for s in e["spans"]]
    rids = sorted(r for s in spans for r in s[3].get("rids", []))
    assert rids == [f"r{i}" for i in range(6)]


def _check_line(channel, raw):
    """One wire line against its channel's declaration: a JSON object of
    a declared kind, its required fields present, no field outside
    required and optional (and the port's own optional fields,
    ``PORT_OPTIONAL``: the replica's warm report on ready)."""
    msg = json.loads(raw)
    kinds = channel["kinds"]
    assert msg.get("kind") in kinds, (channel["name"], raw[:200])
    spec = kinds[msg["kind"]]
    keys = set(msg)
    missing = set(spec["required"]) - keys
    extra = keys - set(spec["required"]) - set(spec["optional"]) - set(
        PORT_OPTIONAL.get((channel["name"], msg["kind"]), ()))
    assert not missing and not extra, (channel["name"], msg["kind"],
                                       missing, extra)
    return msg["kind"]


def test_wire_lines_match_the_declared_protocol(artifacts, monkeypatch):
    """Every line a sharded fleet writes in both directions (requests,
    the gather's fetch_rows and rows, heartbeats, an error answer from
    the serve_io drill, drained) parses and matches the JAX package's
    WIRE_CHANNELS; the replicas' stdout holds nothing else."""
    art, pred, man, _ = artifacts["akx"]
    chan = {c["name"]: c for c in WIRE_CHANNELS}
    sent, read = [], []
    lock = threading.Lock()
    send = router_mod._Replica.send
    read_loop = router_mod.Router._read_loop

    def spy_send(self, obj):
        with lock:
            sent.append(json.dumps(obj))
        return send(self, obj)

    class _Tee:
        def __init__(self, stream):
            self._stream = stream

        def __iter__(self):
            for line in self._stream:
                with lock:
                    read.append(line)
                yield line

    def spy_read(self, rep):
        rep.proc.stdout = _Tee(rep.proc.stdout)
        return read_loop(self, rep)

    monkeypatch.setattr(router_mod._Replica, "send", spy_send)
    monkeypatch.setattr(router_mod.Router, "_read_loop", spy_read)
    seam = man["shards"]["plan"][0][1]
    with _router(art, sharded=True, max_tries=1,
                 env=_env("serve_io:1:0", ROC_TPU_SERVE_HB_S="0.1")) as r:
        outcomes = []
        for ids in ([seam - 1, seam], [0], [seam + 3, 2, seam - 2],
                    np.arange(0, V, 7)):
            try:
                r.submit(ids).result(timeout=60)
                outcomes.append("ok")
            except Exception as e:  # noqa: BLE001 - counted below
                outcomes.append(type(e).__name__)
        time.sleep(0.3)
    assert "ok" in outcomes
    kinds_in = {_check_line(chan["router->replica"], ln) for ln in sent}
    kinds_out = {_check_line(chan["replica->router"], ln.strip())
                 for ln in read if ln.strip()}
    assert {"req", "fetch_rows", "rows"} <= kinds_in
    assert {"ready", "hb", "res", "fetch_rows", "rows",
            "drained"} <= kinds_out
    errors = [json.loads(ln) for ln in read
              if '"ok": false' in ln]
    assert errors and all(m["retryable"] for m in errors)
    # each replica ran every bucket before ready, none failed
    readies = [json.loads(ln) for ln in read if '"kind": "ready"' in ln]
    assert readies and all(
        m["warm"]["programs"] == len(m["buckets"])
        and m["warm"]["failed"] == 0 for m in readies)
