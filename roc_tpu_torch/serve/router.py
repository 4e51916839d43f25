"""Multi-replica routing (``roc_tpu/serve/router.py``): N server
replicas behind one ``submit``.

A :class:`Router` fronts N replica subprocesses (``python -m
roc_tpu_torch.serve.replica``, each loading the same exported artifact;
serve/replica.py has the wire protocol) behind the ``submit(node_ids) ->
Future`` surface of :class:`~roc_tpu_torch.serve.server.Server`, and adds
what one process cannot have:

- **shard-aware least-loaded dispatch**: a request goes to the eligible
  replica with the fewest requests in flight.  A replica may own a ``[lo,
  hi)`` range (``sharded=True`` spawns one replica per table slice of an
  artifact exported with ``--shards``); a request larger than
  ``gather_rider_cap`` ids is split per range and reassembled in order,
  a smaller one goes whole to its majority owner, which gathers the rest
  through the router (``fetch_rows`` forwarded to the owner, ``rows``
  relayed back; an owner's death answers its outstanding gathers with
  the error form of ``rows``);
- **health and failover**: liveness rides the replicas' heartbeat lines
  (``ROC_TPU_SERVE_HB_S``); a silent replica leaves a dated ``stall``
  event; when a replica dies (EOF, exit: the ``replica_sigkill`` drill)
  its in-flight requests are requeued onto the others, with a ``serve``
  event of kind ``failover``;
- **hedging**: a request in flight longer than twice the ``hedge_pct``
  quantile of replica round trips (at least ``hedge_min_ms``) is
  duplicated onto a second replica, first answer wins (the
  ``replica_stall`` drill);
- **deadlines and backpressure**: the monitor fails requests past
  ``deadline_ms`` with ``ServeTimeout`` even when every replica is
  wedged, ``max_inflight`` sheds with ``ServeOverload`` at submit, and a
  retryable replica failure (``serve_io``) is re-dispatched, at most
  ``max_tries`` times.

An accepted request completes with its answer or fails typed
(serve/errors.py).  Every submit mints a request id (``rid``) that rides
the wire and is stamped into the replica's microbatch span.  Every count
goes through a :class:`~roc_tpu_torch.obs.metrics_registry.MetricsRegistry`;
``slos=[...]`` arms a :class:`~roc_tpu_torch.obs.slo.SloEngine` over it,
which the monitor ticks, and :meth:`Router.health` returns its verdict.
``snapshot_path`` (or ``ROC_TPU_SLO_SNAPSHOT``) makes the monitor write
the registry and verdict as JSON once a second.  Replicas take the card
unless ``cpu=True``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time
from concurrent.futures import Future
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..obs.events import emit
from ..obs.metrics_registry import MetricsRegistry
from ..obs.slo import SloEngine
from .errors import (ReplicaLost, ServeClosed, ServeError,
                     ServeOverload, ServeTimeout)
from .replica import hb_interval

# monitor cadence: deadline expiry + hedging both resolve on this
# grain, so it sits well under the smallest deadline worth setting
_MONITOR_TICK_S = 0.01

# typed names a replica may report; anything else maps to ServeError
_TYPED = {"ServeTimeout": ServeTimeout, "ServeOverload": ServeOverload,
          "ServeClosed": ServeClosed, "ValueError": ValueError}


class _Replica:
    """Router-side handle for one replica subprocess."""

    def __init__(self, idx: int, proc: subprocess.Popen):
        self.idx = idx
        self.proc = proc
        self.wlock = threading.Lock()
        self.alive = True
        self.requeued = False   # failover ran for this corpse already
        self.ready: Dict[str, Any] = {}
        self.shard: Optional[Tuple[int, int]] = None
        self.inflight = 0
        self.served = 0
        self.last_hb = time.monotonic()
        self.silent_noted = False
        self.reader: Optional[threading.Thread] = None

    def covers(self, lo: int, hi: int) -> bool:
        if self.shard is None:
            return True
        return self.shard[0] <= lo and hi <= self.shard[1]

    def send(self, obj: Dict[str, Any]) -> bool:
        line = json.dumps(obj) + "\n"
        try:
            with self.wlock:
                # the per-replica pipe's serialiser: one flushed line
                self.proc.stdin.write(line)
                self.proc.stdin.flush()
            return True
        except (OSError, ValueError):
            return False


class _Sub:
    """One wire request: a shard-slice of a client submit, assigned to
    (up to two, when hedged) replicas."""

    __slots__ = ("wire_id", "parent", "slot", "ids", "deadline_t",
                 "replica", "hedge_replica", "t_sent", "tries")

    def __init__(self, wire_id, parent, slot, ids, deadline_t):
        self.wire_id = wire_id
        self.parent = parent
        self.slot = slot
        self.ids = ids
        self.deadline_t = deadline_t
        self.replica: Optional[int] = None
        self.hedge_replica: Optional[int] = None
        self.t_sent = 0.0
        self.tries = 0


class _Parent:
    """One client submit: future + per-shard result slots, plus the
    minted request id and submit stamp the trace/latency metrics
    read."""

    __slots__ = ("fut", "n_left", "parts", "order", "version",
                 "rid", "t0")

    def __init__(self, fut: Future, n_slots: int, order,
                 rid: Optional[str] = None, t0: float = 0.0):
        self.fut = fut
        self.n_left = n_slots
        self.parts: List[Optional[np.ndarray]] = [None] * n_slots
        self.order = order
        self.version: Optional[int] = None
        self.rid = rid
        self.t0 = t0


class Router:
    """See module docstring.  ``Router(artifact_dir, n_replicas=2)``
    spawns the replicas; ``submit``/``query``/``stats``/``close``
    mirror :class:`~roc_tpu_torch.serve.server.Server`."""

    def __init__(self, artifact_dir: str, n_replicas: int = 2,
                 shards: Optional[Sequence[Tuple[int, int]]] = None,
                 max_wait_ms: float = 0.2,
                 max_inflight: int = 1024,
                 default_deadline_ms: Optional[float] = None,
                 hedge_pct: float = 0.95,
                 hedge_min_ms: float = 50.0,
                 max_tries: int = 3,
                 cpu: bool = False,
                 ready_timeout_s: float = 180.0,
                 env: Optional[Dict[str, str]] = None,
                 replica_args: Optional[Sequence[str]] = None,
                 registry: Optional[MetricsRegistry] = None,
                 stats_window_s: float = 60.0,
                 slos: Optional[Sequence[Any]] = None,
                 snapshot_path: Optional[str] = None,
                 sharded: bool = False,
                 table_budget_bytes: Optional[int] = None,
                 gather_rider_cap: int = 8):
        if n_replicas < 1:
            raise ValueError("need at least one replica")
        if shards is not None and len(shards) != n_replicas:
            raise ValueError("one shard range per replica")
        self._sharded = bool(sharded)
        self.table_budget_bytes = table_budget_bytes
        self.gather_rider_cap = int(gather_rider_cap)
        # in-flight cross-shard gathers: gid -> (requester replica idx,
        # owner replica idx); an owner dying mid-gather answers its
        # outstanding gids with the error variant of ``rows`` so the
        # requester's pinned gather fails typed instead of timing out
        self._gathers: Dict[str, Tuple[int, int]] = {}
        if sharded:
            # derive one replica per exported table slice: each spawns
            # with --shard-index K and cold-loads O(V/N)+halo bytes
            from .export import MANIFEST_NAME
            with open(os.path.join(artifact_dir, MANIFEST_NAME)) as f:
                sb = json.load(f).get("shards") or {}
            if not sb:
                raise ValueError(
                    f"{artifact_dir}: sharded=True but the artifact "
                    f"was not exported with --shards")
            if shards is not None:
                raise ValueError("sharded=True derives the shard "
                                 "ranges from the artifact; drop "
                                 "shards=")
            if n_replicas != int(sb["n"]):
                raise ValueError(
                    f"sharded artifact has {sb['n']} slice(s); "
                    f"n_replicas={n_replicas} must match")
            shards = [(int(lo), int(hi)) for lo, hi in sb["plan"]]
        self.artifact_dir = artifact_dir
        self.max_inflight = int(max_inflight)
        self.default_deadline_ms = default_deadline_ms
        self.hedge_pct = float(hedge_pct)
        self.hedge_min_ms = float(hedge_min_ms)
        self.max_tries = int(max_tries)
        self.stats_window_s = float(stats_window_s)
        self._lock = threading.Lock()
        self._pending: Dict[int, _Sub] = {}
        self._next_id = 0
        self._rid_seq = 0
        self._closed = False
        self._stop = threading.Event()
        # ALL counting goes through the registry: lifetime totals AND
        # windowed rates from one recording
        self.reg = (registry if registry is not None
                    else MetricsRegistry("router"))
        self._c_requests = self.reg.counter("requests")
        self._c_shed = self.reg.counter("shed")
        self._c_timeout = self.reg.counter("timeout")
        self._c_failover = self.reg.counter("failover")
        self._c_hedge = self.reg.counter("hedge")
        self._c_ok = self.reg.counter("ok")
        self._c_failed = self.reg.counter("failed")
        # wire_ms: per-sub replica round trips (the hedge threshold's
        # base); request_ms: client submit -> assembled result (the
        # p99 the latency SLO guards)
        self._h_wire = self.reg.histogram("wire_ms")
        self._h_request = self.reg.histogram("request_ms")
        # per-microbatch cross-shard gather wall, from res.gather_ms —
        # the request-path cost of serving O(V/N) tables
        self._h_gather = self.reg.histogram("gather_ms")
        self._spans: List[Tuple[str, float, float,
                                Dict[str, Any]]] = []
        self._slo: Optional[SloEngine] = None
        if slos:
            self._slo = SloEngine(self.reg, slos, component="router")
        self.snapshot_path = (snapshot_path
                              or os.environ.get("ROC_TPU_SLO_SNAPSHOT")
                              or None)
        self._last_snapshot = 0.0
        self.num_nodes: Optional[int] = None
        # the router's own lane handshake, like Server's
        emit("timeline", f"clock_sync: serve router up "
             f"({n_replicas} replica(s) over {artifact_dir})",
             console=False, kind="clock_sync", server="router")
        self._replica_args = list(replica_args or [])
        self._monitor: Optional[threading.Thread] = None
        self.replicas: List[_Replica] = []
        for i in range(n_replicas):
            self.replicas.append(self._spawn(
                i, shards[i] if shards else None, max_wait_ms, cpu,
                env))
        self._await_ready(ready_timeout_s)
        self._monitor = threading.Thread(
            target=self._monitor_loop, name="router:monitor",
            daemon=True)
        self._monitor.start()

    # ------------------------------------------------------- lifecycle

    def _spawn(self, idx: int, shard, max_wait_ms: float, cpu: bool,
               env: Optional[Dict[str, str]]) -> _Replica:
        cmd = [sys.executable, "-m", "roc_tpu_torch.serve.replica",
               self.artifact_dir, "--replica", str(idx),
               "--max-wait-ms", str(max_wait_ms)]
        if self._sharded:
            # the real sliced-table load; the replica derives its
            # owned [lo, hi) range (and the gather plan) from the
            # artifact's shard manifest
            cmd += ["--shard-index", str(idx)]
        elif shard is not None:
            cmd += ["--shard", f"{shard[0]}:{shard[1]}"]
        if self.table_budget_bytes:
            cmd += ["--table-budget-bytes",
                    str(self.table_budget_bytes)]
        if cpu:
            cmd += ["--cpu"]
        cmd += self._replica_args
        child_env = dict(env) if env is not None else os.environ.copy()
        # `-m roc_tpu_torch.serve.replica` must resolve from any cwd:
        # the package's parent dir rides PYTHONPATH
        pkg_root = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
        child_env["PYTHONPATH"] = (
            pkg_root + os.pathsep + child_env["PYTHONPATH"]
            if child_env.get("PYTHONPATH") else pkg_root)
        proc = subprocess.Popen(
            cmd, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            text=True, env=child_env)
        rep = _Replica(idx, proc)
        if shard is not None:
            rep.shard = (int(shard[0]), int(shard[1]))
        rep.reader = threading.Thread(
            target=self._read_loop, args=(rep,),
            name=f"router:read{idx}", daemon=True)
        rep.reader.start()
        return rep

    def _await_ready(self, timeout_s: float) -> None:
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            with self._lock:
                ready = [r for r in self.replicas if r.ready]
                dead = [r for r in self.replicas if not r.alive]
            if dead:
                self.close()
                raise ServeError(
                    f"replica(s) {[r.idx for r in dead]} died during "
                    f"startup (see stderr)")
            if len(ready) == len(self.replicas):
                self.num_nodes = int(ready[0].ready["num_nodes"])
                emit("serve", f"router ready: {len(ready)} replica(s), "
                     f"V={self.num_nodes}", console=False,
                     kind="router_ready", replicas=len(ready))
                return
            time.sleep(0.05)
        self.close()
        raise ServeError(f"replicas not ready within {timeout_s:.0f}s")

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            pending = list(self._pending.values())
            self._pending.clear()
        self._stop.set()
        for sub in pending:
            if not sub.parent.fut.done():
                sub.parent.fut.set_exception(
                    ServeClosed("router closed with requests in "
                                "flight"))
        # graceful first: close stdin → replica drains and exits 0
        for rep in self.replicas:
            try:
                rep.proc.stdin.close()
            except (OSError, ValueError):
                pass
        deadline = time.monotonic() + 15.0
        for rep in self.replicas:
            try:
                rep.proc.wait(timeout=max(0.1,
                                          deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                # a wedged replica (the replica_stall drill) cannot
                # drain: TERM, then KILL
                rep.proc.terminate()
                try:
                    rep.proc.wait(timeout=5.0)
                except subprocess.TimeoutExpired:
                    rep.proc.kill()
                    rep.proc.wait()
        if self._monitor is not None:
            self._monitor.join(timeout=5.0)
        for rep in self.replicas:
            if rep.reader is not None:
                rep.reader.join(timeout=5.0)
        self._flush_spans(final=True)
        s = self.stats()
        emit("serve", f"router closed: {s['n_ok']} ok / "
             f"{s['n_timeout']} timeout / {s['n_shed']} shed / "
             f"{s['n_failover']} failover / {s['n_hedge']} hedge",
             console=False, kind="router_summary", **s)

    def __enter__(self) -> "Router":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ---------------------------------------------------------- submit

    def submit(self, node_ids,
               deadline_ms: Optional[float] = None) -> Future:
        """One client request; resolves to the fp32 ``[n, C]`` logits
        or a typed ``serve/errors.py`` failure.  Mints the request id
        (``rid``) the distributed trace connects on."""
        ids = np.asarray(node_ids, dtype=np.int32).ravel()
        fut: Future = Future()
        if ids.size and self.num_nodes is not None and (
                ids.min() < 0 or ids.max() >= self.num_nodes):
            fut.set_exception(ValueError(
                f"node ids out of range [0, {self.num_nodes})"))
            return fut
        if deadline_ms is None:
            deadline_ms = self.default_deadline_ms
        t0 = time.monotonic()
        deadline_t = (None if deadline_ms is None
                      else t0 + max(0.0, deadline_ms) / 1e3)
        groups = self._shard_groups(ids)
        with self._lock:
            if self._closed:
                fut.set_exception(ServeClosed("router is closed"))
                return fut
            self._c_requests.inc()
            if len(self._pending) + len(groups) > self.max_inflight:
                self._c_shed.inc()
                fut.set_exception(ServeOverload(
                    f"router in-flight cap {self.max_inflight} "
                    f"reached — load shed"))
                return fut
            self._rid_seq += 1
            rid = f"{os.getpid():x}-{self._rid_seq}"
            parent = _Parent(fut, len(groups),
                             [g[1] for g in groups], rid=rid, t0=t0)
            subs = []
            for slot, (gids, _order) in enumerate(groups):
                wire_id = self._next_id
                self._next_id += 1
                sub = _Sub(wire_id, parent, slot, gids, deadline_t)
                self._pending[wire_id] = sub
                subs.append(sub)
        for sub in subs:
            self._dispatch(sub)
        return fut

    def query(self, node_ids,
              deadline_ms: Optional[float] = None) -> np.ndarray:
        return self.submit(node_ids, deadline_ms=deadline_ms).result()

    def _shard_groups(self, ids: np.ndarray):
        """Split ``ids`` into per-shard-group sub-requests.  Returns
        ``[(gids, positions)]``; with full-range replicas this is one
        group carrying everything.

        Sharded fleets: requests at or under ``gather_rider_cap`` ids
        stay ONE wire sub — the majority owner serves them, fetching
        the foreign rows through its cross-shard gather (splitting a
        tiny request across N replicas would trade one gather for N
        wire round trips).  Larger requests split per owner range; ids
        outside every advertised range go to any replica, which
        gathers them."""
        ranges = sorted({r.shard for r in self.replicas
                         if r.shard is not None})
        if not ranges:
            return [(ids, np.arange(ids.size))]
        if ids.size <= self.gather_rider_cap:
            return [(ids, np.arange(ids.size))]
        groups = []
        claimed = np.zeros(ids.size, dtype=bool)
        for lo, hi in ranges:
            mask = (ids >= lo) & (ids < hi) & ~claimed
            if mask.any():
                claimed |= mask
                groups.append((ids[mask], np.nonzero(mask)[0]))
        if not claimed.all():
            # ids outside every advertised range ride one extra group;
            # _pick_replica lands it on the least-loaded live replica
            # and the gather leg makes that correct
            rest = ~claimed
            groups.append((ids[rest], np.nonzero(rest)[0]))
        return groups or [(ids, np.arange(ids.size))]

    # -------------------------------------------------------- dispatch

    def _pick_replica(self, sub: _Sub,
                      exclude: Sequence[int] = ()) -> Optional[_Replica]:
        lo = int(sub.ids.min()) if sub.ids.size else 0
        hi = int(sub.ids.max()) + 1 if sub.ids.size else 0
        with self._lock:
            # exclude is HARD: a hedge must never land back on the
            # replica it hedges around (a wedged-but-alive replica
            # would absorb its own hedge and defeat the bound), and a
            # broken-pipe exclude must never be re-picked mid-loop
            cands = [r for r in self.replicas
                     if r.alive and r.ready and r.idx not in exclude]
            if not cands:
                return None
            covering = [r for r in cands if r.covers(lo, hi)]
            if covering:
                return min(covering, key=lambda r: r.inflight)
            # no single replica owns the whole sub (a gather-rider
            # request, or uncovered ids after an owner died): route to
            # the MAJORITY owner, least-loaded on ties — the foreign
            # minority arrives through its gather leg
            def owned(r: _Replica) -> int:
                if r.shard is None:
                    return int(sub.ids.size)
                return int(((sub.ids >= r.shard[0])
                            & (sub.ids < r.shard[1])).sum())
            return max(cands, key=lambda r: (owned(r), -r.inflight))

    def _dispatch(self, sub: _Sub, hedge: bool = False) -> None:
        """Assign ``sub`` to the least-loaded eligible replica and put
        it on the wire; a dead pipe fails over immediately."""
        exclude = ([sub.replica] if hedge and sub.replica is not None
                   else [])
        while True:
            rep = self._pick_replica(sub, exclude=exclude)
            if rep is None:
                if hedge:
                    return     # nowhere to hedge — original still owns
                self._fail_sub(sub, ReplicaLost(
                    "no live replica covers this request's shard"))
                return
            remaining_ms = (None if sub.deadline_t is None else
                            max(0.0, (sub.deadline_t - time.monotonic())
                                * 1e3))
            ok = rep.send({"kind": "req", "id": sub.wire_id,
                           "ids": sub.ids.tolist(),
                           "deadline_ms": remaining_ms,
                           "rid": sub.parent.rid})
            if ok:
                with self._lock:
                    rep.inflight += 1
                    if hedge:
                        sub.hedge_replica = rep.idx
                    else:
                        sub.replica = rep.idx
                        sub.t_sent = time.monotonic()
                        sub.tries += 1
                return
            # broken pipe: this replica is gone.  Requeue its OTHER
            # in-flight requests (skip= keeps THIS sub out — the loop
            # below re-dispatches it itself, a double-send would act
            # like an accidental hedge)
            self._mark_dead(rep, "write failed", skip=sub)
            exclude = list(exclude) + [rep.idx]

    def _fail_sub(self, sub: _Sub, exc: Exception) -> None:
        """Fail the whole parent (pop every sibling sub).  Counts ONE
        failure per parent, and only when the request was actually
        still pending — a request completed by _on_result in the
        monitor's snapshot-to-call window, or a sibling of an
        already-failed parent, must not inflate the stats."""
        with self._lock:
            popped = self._pending.pop(sub.wire_id, None) is not None
            for wid, other in list(self._pending.items()):
                if other.parent is sub.parent:
                    self._pending.pop(wid)
                    popped = True
            count = popped and not sub.parent.fut.done()
        if count:
            if isinstance(exc, ServeTimeout):
                self._c_timeout.inc()
            self._c_failed.inc()
        if count and not sub.parent.fut.done():
            try:
                sub.parent.fut.set_exception(exc)
            except Exception:  # noqa: BLE001 - lost the completion race
                pass

    # --------------------------------------------------------- readers

    def _read_loop(self, rep: _Replica) -> None:
        try:
            for line in rep.proc.stdout:
                if self._stop.is_set():
                    break
                line = line.strip()
                if not line:
                    continue
                try:
                    msg = json.loads(line)
                except ValueError:
                    continue
                kind = msg.get("kind")
                if kind == "ready":
                    with self._lock:
                        rep.ready = msg
                        if msg.get("shard"):
                            rep.shard = tuple(msg["shard"])
                        rep.last_hb = time.monotonic()
                elif kind == "hb":
                    with self._lock:
                        rep.last_hb = time.monotonic()
                        rep.silent_noted = False
                elif kind == "res":
                    self._on_result(rep, msg)
                elif kind == "fetch_rows":
                    self._forward_fetch(rep, msg)
                elif kind == "rows":
                    self._relay_rows(rep, msg)
                elif kind == "drained":
                    with self._lock:
                        rep.last_hb = time.monotonic()
                else:
                    # explicit unknown-kind rejection: a replica
                    # speaking a newer/typo'd protocol fails loud
                    # on the bus instead of being silently ignored
                    emit("serve",
                         f"replica {rep.idx} sent unknown wire "
                         f"kind {kind!r} — dropped", console=False,
                         kind_rejected=str(kind), replica=rep.idx)
        except (OSError, ValueError):
            pass
        finally:
            self._mark_dead(rep, "stdout EOF")

    def _forward_fetch(self, rep: _Replica,
                       msg: Dict[str, Any]) -> None:
        """Gather leg, requester → owner: forward a version-pinned row
        fetch to the live replica OWNING the ids' range (the line is
        re-built, not relayed raw — the declared field contract is the
        send site's shape on both channels).  No live owner → the
        requester gets the error variant of ``rows`` immediately."""
        gid = str(msg.get("gid"))
        ids = [int(i) for i in (msg.get("ids") or [])]
        version = int(msg.get("version") or 0)
        lo = min(ids) if ids else 0
        hi = (max(ids) + 1) if ids else 0
        owner: Optional[_Replica] = None
        with self._lock:
            for r in self.replicas:
                if (r.alive and r.ready and r.idx != rep.idx
                        and r.shard is not None and r.covers(lo, hi)):
                    owner = r
                    break
            if owner is not None:
                self._gathers[gid] = (rep.idx, owner.idx)
        if owner is not None:
            ok = owner.send({"kind": "fetch_rows", "gid": gid,
                             "ids": ids, "version": version})
            if ok:
                return
            with self._lock:
                self._gathers.pop(gid, None)
            self._mark_dead(owner, "write failed")
        rep.send({"kind": "rows", "gid": gid, "ids": ids, "rows": [],
                  "version": version, "qmode": "off", "scales": None,
                  "replica": None,
                  "error": "ReplicaLost: no live replica owns these "
                           "rows"})

    def _relay_rows(self, rep: _Replica, msg: Dict[str, Any]) -> None:
        """Gather leg, owner → requester: relay the owner's answer
        back to the replica whose gid this is (re-built line, same
        contract note as :meth:`_forward_fetch`)."""
        gid = str(msg.get("gid"))
        requester: Optional[_Replica] = None
        with self._lock:
            entry = self._gathers.pop(gid, None)
            if entry is not None:
                for r in self.replicas:
                    if r.idx == entry[0]:
                        requester = r
                        break
        if requester is None or not requester.alive:
            return      # requester died mid-gather; nothing to do
        requester.send({"kind": "rows", "gid": gid,
                        "ids": msg.get("ids"),
                        "rows": msg.get("rows"),
                        "version": msg.get("version"),
                        "qmode": msg.get("qmode"),
                        "scales": msg.get("scales"),
                        "replica": rep.idx,
                        "error": msg.get("error")})

    def _on_result(self, rep: _Replica, msg: Dict[str, Any]) -> None:
        with self._lock:
            rep.inflight = max(0, rep.inflight - 1)
            sub = self._pending.get(msg.get("id"))
            if sub is not None and msg.get("ok"):
                del self._pending[sub.wire_id]
                rep.served += 1
                wire_ms = (time.monotonic() - sub.t_sent) * 1e3
        if sub is not None and msg.get("ok"):
            self._h_wire.record(wire_ms)
            gms = msg.get("gather_ms")
            if gms is not None:
                self._h_gather.record(float(gms))
        if sub is None:
            return   # hedge already won (or expired): late twin
        if msg.get("ok"):
            rows = np.asarray(msg["rows"], dtype=np.float32)
            self._complete(sub, rows, msg.get("version"))
            return
        # typed failure from the replica
        retryable = bool(msg.get("retryable"))
        if retryable:
            with self._lock:
                still = sub.wire_id in self._pending
                tries = sub.tries
            if still and tries < self.max_tries:
                emit("serve", f"retryable failure on replica "
                     f"{rep.idx} ({msg.get('error')}) — "
                     f"re-dispatching", console=False,
                     kind="redispatch", replica=rep.idx,
                     error=msg.get("error"))
                self._dispatch(sub)
                return
        exc_type = _TYPED.get(msg.get("error"), ServeError)
        self._fail_sub(sub, exc_type(
            f"replica {rep.idx}: {msg.get('msg', msg.get('error'))}"))

    def _complete(self, sub: _Sub, rows: np.ndarray,
                  version: Optional[int]) -> None:
        parent = sub.parent
        done = False
        with self._lock:
            parent.parts[sub.slot] = rows
            if version is not None:
                parent.version = (version if parent.version is None
                                  else max(parent.version, version))
            parent.n_left -= 1
            done = parent.n_left == 0
        if not done:
            return
        self._c_ok.inc()
        ms = (time.monotonic() - parent.t0) * 1e3
        self._h_request.record(ms)
        # the router-lane span for this request's trace (flushed in
        # batches like Server's)
        with self._lock:
            self._spans.append(
                ("route_request", parent.t0, ms,
                 {"rid": parent.rid,
                  "version": int(parent.version or 0)}))
            flush = len(self._spans) >= 64
        if flush:
            self._flush_spans()
        if parent.fut.done():
            return
        if len(parent.parts) == 1:
            out = parent.parts[0]
        else:
            n = sum(p.shape[0] for p in parent.parts)
            out = np.empty((n, parent.parts[0].shape[1]), np.float32)
            for part, pos in zip(parent.parts, parent.order):
                out[np.asarray(pos)] = part
        from .server import ServeResult
        res = out.view(ServeResult)
        res.version = int(parent.version or 0)
        parent.fut.set_result(res)

    # -------------------------------------------------- failover/hedge

    def _mark_dead(self, rep: _Replica, why: str,
                   skip: Optional[_Sub] = None) -> None:
        """Mark a replica dead and fail over its in-flight requests —
        exactly once per corpse, whichever of the reader (EOF), the
        monitor (poll), or a failed write gets here first."""
        with self._lock:
            was_alive = rep.alive
            rep.alive = False
            if rep.requeued or self._closed:
                if not was_alive:
                    return
                orphans = []
            else:
                rep.requeued = True
                orphans = [s for s in self._pending.values()
                           if (s.replica == rep.idx
                               or s.hedge_replica == rep.idx)
                           and s is not skip]
            closed = self._closed
            # gathers where the corpse was the OWNER get an error
            # answer (the requester retries → GatherError → retryable
            # res → re-dispatch); requester-side entries just drop.
            owed = [(gid, req_idx) for gid, (req_idx, own_idx)
                    in self._gathers.items()
                    if own_idx == rep.idx or req_idx == rep.idx]
            notify = []
            for gid, req_idx in owed:
                del self._gathers[gid]
                if req_idx == rep.idx:
                    continue
                for r in self.replicas:
                    if r.idx == req_idx and r.alive:
                        notify.append((gid, r))
                        break
        for gid, requester in notify:
            requester.send({"kind": "rows", "gid": gid, "ids": [],
                            "rows": [], "version": -1, "qmode": "off",
                            "scales": None, "replica": rep.idx,
                            "error": "ReplicaLost: owner died "
                                     "mid-gather"})
        if closed or (not was_alive and not orphans):
            return
        # the failover marker the timeline renders on the router lane;
        # rids connect it into each requeued request's trace
        rids = sorted({s.parent.rid for s in orphans
                       if s.parent.rid is not None})
        self._c_failover.inc(len(orphans))
        emit("serve", f"replica {rep.idx} died ({why}): failing over "
             f"{len(orphans)} in-flight request(s)",
             kind="failover", replica=rep.idx, requeued=len(orphans),
             rids=rids)
        for sub in orphans:
            if sub.hedge_replica == rep.idx:
                with self._lock:
                    sub.hedge_replica = None
                continue
            # requeue onto a survivor (deadline still enforced by the
            # monitor; a request whose deadline already passed expires
            # there as ServeTimeout, never silently dropped)
            self._dispatch(sub)

    def _hedge_threshold_ms(self) -> float:
        # windowed first (current behavior under load shifts), whole-
        # ring fallback; the log-bucket quantile's ~16% grain is fine
        # for a 2x-padded hedge trigger
        q = (self._h_wire.quantile(self.hedge_pct,
                                   self.stats_window_s)
             or self._h_wire.quantile(self.hedge_pct, None))
        if q is None:
            return self.hedge_min_ms
        return max(self.hedge_min_ms, q * 2.0)

    def _monitor_loop(self) -> None:
        hb_timeout = 3.0 * hb_interval()
        while not self._stop.wait(_MONITOR_TICK_S):
            now = time.monotonic()
            # deadline expiry — authoritative, replica-independent:
            # this is the "never a hang" backstop
            with self._lock:
                expired = [s for s in self._pending.values()
                           if s.deadline_t is not None
                           and s.deadline_t <= now]
            for sub in expired:
                self._fail_sub(sub, ServeTimeout(
                    "deadline expired in flight"))
            # hedging: slow in-flight subs get a second replica
            thr_s = self._hedge_threshold_ms() / 1e3
            with self._lock:
                slow = [s for s in self._pending.values()
                        if s.hedge_replica is None and s.t_sent
                        and now - s.t_sent > thr_s
                        and len([r for r in self.replicas
                                 if r.alive]) > 1]
            for sub in slow:
                self._c_hedge.inc()
                emit("serve", f"hedging request {sub.wire_id} "
                     f"(in flight {1e3 * (now - sub.t_sent):.0f} ms "
                     f"on replica {sub.replica})", console=False,
                     kind="hedge", replica=sub.replica,
                     rid=sub.parent.rid)
                self._dispatch(sub, hedge=True)
            # health: dead processes + silent heartbeats
            for rep in list(self.replicas):
                if rep.alive and rep.proc.poll() is not None:
                    self._mark_dead(rep,
                                    f"exit rc={rep.proc.returncode}")
                    continue
                with self._lock:
                    silent = (rep.alive and rep.ready
                              and now - rep.last_hb > hb_timeout
                              and not rep.silent_noted)
                    if silent:
                        rep.silent_noted = True
                        age = now - rep.last_hb
                if silent:
                    emit("stall", f"replica {rep.idx} heartbeat "
                         f"silent for {age:.1f}s",
                         stage=f"serve_replica{rep.idx}",
                         elapsed_s=round(age, 1))
            # SLO evaluation (rate-limited inside tick) + the live
            # dashboard feed
            if self._slo is not None:
                self._slo.tick()
            if (self.snapshot_path
                    and now - self._last_snapshot >= 1.0):
                self._last_snapshot = now
                extra = {"component": "router",
                         "health": (self._slo.tick()
                                    if self._slo is not None
                                    else None)}
                self.reg.dump(self.snapshot_path,
                              windows=(10.0, self.stats_window_s),
                              extra=extra)

    def _flush_spans(self, final: bool = False) -> None:
        with self._lock:
            spans, self._spans = self._spans, []
        if not spans:
            return
        emit("timeline",
             f"spans: {len(spans)} routed request(s)"
             + (" (final)" if final else ""), console=False,
             kind="spans",
             spans=[[n, round(t0, 6), round(ms, 3), args]
                    for n, t0, ms, args in spans])

    # ----------------------------------------------------------- stats

    def stats(self) -> Dict[str, Any]:
        """Lifetime ``n_*`` totals + *windowed* rates and latency
        quantiles over the trailing ``window_s`` seconds (``None``
        when the window saw no requests)."""
        w = self.stats_window_s
        with self._lock:
            reps = [{"replica": r.idx, "alive": r.alive,
                     "inflight": r.inflight, "served": r.served,
                     "shard": list(r.shard) if r.shard else None}
                    for r in self.replicas]
        n_req = self._c_requests.total
        n_shed = self._c_shed.total
        out = {"n_submitted": n_req - n_shed, "n_ok": self._c_ok.total,
               "n_failed": self._c_failed.total,
               "n_timeout": self._c_timeout.total,
               "n_shed": n_shed,
               "n_failover": self._c_failover.total,
               "n_hedge": self._c_hedge.total,
               "replicas": reps,
               "window_s": w}
        w_denom = self._c_requests.sum_over(w)

        def rate(num: int) -> Optional[float]:
            return round(num / w_denom, 4) if w_denom > 0 else None

        def q(h, p: float) -> Optional[float]:
            v = h.quantile(p, None)
            return round(v, 4) if v is not None else None

        out["p50_ms"] = q(self._h_request, 0.50)
        out["p99_ms"] = q(self._h_request, 0.99)
        out["gather_p50_ms"] = q(self._h_gather, 0.50)
        out["shed_rate"] = rate(self._c_shed.sum_over(w))
        out["error_rate"] = rate(self._c_failed.sum_over(w))
        out["availability"] = rate(self._c_ok.sum_over(w))
        return out

    def health(self) -> Dict[str, Any]:
        """Machine-readable serving health: the SLO engine's verdict
        (fresh evaluation) + replica liveness.  ``ok`` is the one bit
        an autoscaler/pager keys on: every objective in-state AND at
        least one replica alive."""
        alive = sum(1 for r in self.replicas if r.alive)
        if self._slo is None:
            v: Dict[str, Any] = {"ok": True, "states": {},
                                 "objectives": []}
        else:
            v = self._slo.verdict()
        v = dict(v)
        v["replicas_alive"] = alive
        v["replicas"] = len(self.replicas)
        v["ok"] = bool(v["ok"]) and alive > 0
        return v
