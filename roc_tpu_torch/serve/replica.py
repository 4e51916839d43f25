"""Serve replica worker (``roc_tpu/serve/replica.py``): one server process
behind the Router.

``python -m roc_tpu_torch.serve.replica <artifact_dir> --replica N`` is
what :class:`~roc_tpu_torch.serve.router.Router` spawns, once per
replica, over one exported artifact: the replica loads the predictor
(``load_predictor``; one table slice with ``--shard-index K``), runs a
:class:`~roc_tpu_torch.serve.server.Server` and speaks the JAX package's
line-JSON protocol on stdin and stdout:

stdin (router -> replica)
    ``{"kind": "req", "id": i, "ids": [...], "deadline_ms": f|null,
    "rid": s|null}``: one request; ``rid`` is the router-minted request
    id, stamped into the span of the microbatch that serves it;
    ``{"kind": "close"}``: drain and exit (stdin EOF means the same);
    ``{"kind": "fetch_rows", "gid": g, "ids": [...], "version": v}``: a
    version-pinned row fetch another shard asked for (the owner side);
    ``{"kind": "rows", ...}``: the answer to one of this replica's own
    fetches, relayed by the router.

stdout (replica -> router)
    ``{"kind": "ready", "replica": n, "num_nodes": V, ...}`` once;
    ``{"kind": "hb", "inflight": q, "served": n, "mono": t}`` beats;
    ``{"kind": "res", "id": i, "ok": true, "rows": [[...]],
    "version": v, ...}`` or ``{"kind": "res", "id": i, "ok": false,
    "error": "<TypeName>", "msg": ..., "retryable": bool}``;
    ``fetch_rows`` and ``rows``, the gather's two halves;
    ``{"kind": "drained", "clean": bool, ...}``, the last line before
    exit 0.

stdout carries the wire alone: at start the replica keeps a duplicate of
its stdout for the wire and points file descriptor 1 (and
``sys.stdout``) at stderr, so a build log, a warning or a stray print
never reaches the router.  fp32 rows travel as ``ndarray.tolist()``
floats (shortest round-trip decimals: every value reads back as the same
float32), int8 and fp8 codes as their storage bytes.

A :class:`~roc_tpu_torch.resilience.preempt.PreemptionGuard` turns
SIGTERM into a drain: stop admitting (late requests fail typed
``ServeClosed``), finish what is in flight, write ``drained``, exit 0.
Fault drills arm per replica through ``ROC_TPU_FAULT=site:epoch:proc``
with ``proc`` this replica's index (``inject.note_proc_index``) and
``epoch`` the microbatch index.  The replica takes the card unless given
``--cpu``; with no card it exits before ``ready`` and its router fails
typed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np

from .errors import GatherError

# failures the router may re-dispatch to another replica: transient I/O
# (the serve_io drill) and a failed cross-shard gather, which says
# nothing about the request (a re-dispatch captures a fresh version).
# Deadline, shed and closed failures are the contract and go back typed.
RETRYABLE = (OSError, GatherError)

GATHER_TIMEOUT_ENV = "ROC_TPU_GATHER_TIMEOUT_S"
DEFAULT_GATHER_TIMEOUT_S = 10.0

HB_ENV = "ROC_TPU_SERVE_HB_S"
DEFAULT_HB_S = 1.0


def hb_interval() -> float:
    try:
        return max(0.05, float(os.environ.get(HB_ENV, DEFAULT_HB_S)))
    except ValueError:
        return DEFAULT_HB_S


class _Wire:
    """The stdout writer: one lock, one flushed line per message (the
    dispatcher's callbacks, the heartbeat and the reader all write)."""

    def __init__(self, stream):
        self._stream = stream
        self._lock = threading.Lock()

    def send(self, obj: Dict[str, Any]) -> None:
        line = json.dumps(obj)
        with self._lock:
            # the wire lock is its line serialiser: one flushed line
            # roc-lint: ok=blocking-under-lock
            self._stream.write(line + "\n")
            # same bounded hold
            # roc-lint: ok=blocking-under-lock
            self._stream.flush()


def _rows_payload(gid: Any, ids: List[int], rows: Any, version: int,
                  qmode: str, scales: Any, replica: int,
                  error: Optional[str]) -> Dict[str, Any]:
    # one shape for both halves of a row-fetch answer: the stored rows
    # (and scales when quantized), or "error" with the rows empty
    return {"kind": "rows", "gid": gid, "ids": ids, "rows": rows,
            "version": version, "qmode": qmode, "scales": scales,
            "replica": replica, "error": error}


class _GatherClient:
    """The requester half of the cross-shard gather: ``gather(ids,
    version)`` splits a microbatch's foreign ids by the artifact's shard
    plan, sends one version-pinned ``fetch_rows`` per owning shard (the
    router forwards it to the owner and relays its ``rows`` back by
    ``gid``), waits for every answer and merges them into the ``(values,
    scales, version, qmode)`` that ``Predictor._stage_foreign`` takes.
    A refusal (another version at the owner, the owner's death) answers
    version -1, so the predictor's pin (one retry, then GatherError)
    decides; a gather never mixes versions."""

    def __init__(self, wire: _Wire, plan: List[List[int]], replica: int,
                 timeout_s: Optional[float] = None):
        self._wire = wire
        self._plan = [(int(lo), int(hi)) for lo, hi in plan]
        self._replica = replica
        if timeout_s is None:
            try:
                timeout_s = float(os.environ.get(
                    GATHER_TIMEOUT_ENV, DEFAULT_GATHER_TIMEOUT_S))
            except ValueError:
                timeout_s = DEFAULT_GATHER_TIMEOUT_S
        self._timeout_s = timeout_s
        self._lock = threading.Lock()
        self._seq = 0
        self._pending: Dict[str, Dict[str, Any]] = {}

    def on_rows(self, msg: Dict[str, Any]) -> None:
        """The reader thread's delivery of one ``rows`` answer."""
        gid = str(msg.get("gid"))
        with self._lock:
            call = self._pending.pop(gid, None)
            if call is None:
                return      # a late answer to a gather that timed out
            call["got"][gid] = msg
            done = set(call["got"]) >= call["need"]
        if done:
            call["ev"].set()

    def gather(self, ids, version: int):
        ids = np.asarray(ids, dtype=np.int64).ravel()
        call: Dict[str, Any] = {"need": set(), "got": {},
                                "ev": threading.Event()}
        sends = []
        with self._lock:
            for lo, hi in self._plan:
                m = (ids >= lo) & (ids < hi)
                if not m.any():
                    continue
                gid = f"r{self._replica}g{self._seq}"
                self._seq += 1
                self._pending[gid] = call
                call["need"].add(gid)
                sends.append((gid, ids[m]))
        for gid, sub in sends:
            self._wire.send({"kind": "fetch_rows", "gid": gid,
                             "ids": sub.tolist(), "version": int(version)})
        if not call["ev"].wait(self._timeout_s):
            with self._lock:
                for gid in call["need"]:
                    self._pending.pop(gid, None)
            raise GatherError(
                f"cross-shard gather of {ids.size} row(s) timed out after "
                f"{self._timeout_s}s (pinned to v{version})")
        return self._merge(ids, list(call["got"].values()), version)

    def _merge(self, ids: np.ndarray, msgs: List[Dict[str, Any]],
               version: int):
        from ..obs.events import emit
        from .quant import from_storage_bytes
        for m in msgs:
            if m.get("error") or int(m.get("version", -1)) != int(version):
                emit("serve", f"replica {self._replica}: gather refused "
                     f"by owner: {m.get('error')!r} (owner "
                     f"v{m.get('version')}, pinned v{version})",
                     console=False, kind="gather_refused",
                     replica=self._replica)
                return None, None, -1, str(m.get("qmode", "off"))
        qmode = str(msgs[0].get("qmode", "off"))
        got_ids = np.concatenate([np.asarray(m["ids"], dtype=np.int64)
                                  for m in msgs])
        if qmode == "off":
            vals = np.concatenate([np.asarray(m["rows"], dtype=np.float32)
                                   .reshape(len(m["ids"]), -1)
                                   for m in msgs])
            scales = None
        else:
            vals = np.concatenate([from_storage_bytes(
                np.asarray(m["rows"], dtype=np.uint8)
                .reshape(len(m["ids"]), -1), qmode) for m in msgs])
            scales = np.concatenate([np.asarray(m["scales"],
                                                dtype=np.float32)
                                     for m in msgs])
        order = np.argsort(got_ids, kind="stable")
        at = order[np.searchsorted(got_ids[order], ids)]
        if not np.array_equal(got_ids[at], ids):
            return None, None, -1, qmode
        return (vals[at], None if scales is None else scales[at],
                int(version), qmode)


def _answer_fetch(server, wire: _Wire, replica: int,
                  msg: Dict[str, Any]) -> None:
    """The owner half: answer a version-pinned row fetch from the
    predictor's host rows (no device work, on the reader thread).  A
    refusal (another version, ids not owned) answers with the error form
    of ``rows``."""
    gid = msg.get("gid")
    ids = [int(i) for i in (msg.get("ids") or [])]
    version = int(msg.get("version") or 0)
    try:
        vals, scales, ver, qmode = server.pred.read_rows(ids, version)
        if qmode != "off":
            from .quant import to_storage_bytes
            rows_w = to_storage_bytes(vals).tolist()
            scales_w = np.asarray(scales, dtype=np.float32).tolist()
        else:
            rows_w = np.asarray(vals, dtype=np.float32).tolist()
            scales_w = None
        wire.send(_rows_payload(gid, ids, rows_w, int(ver), qmode,
                                scales_w, replica, None))
    except Exception as e:  # noqa: BLE001 - wire the refusal back
        wire.send(_rows_payload(gid, ids, [], version, "off", None,
                                replica, f"{type(e).__name__}: "
                                f"{str(e)[:300]}"))


def _error_payload(req_id: int, e: BaseException) -> Dict[str, Any]:
    # the Server wraps dispatch failures in ServeError with the cause
    # chained: an injected serve_io OSError still comes back retryable
    retryable = isinstance(e, RETRYABLE) \
        or isinstance(getattr(e, "__cause__", None), RETRYABLE)
    return {"kind": "res", "id": req_id, "ok": False,
            "error": type(e).__name__, "msg": str(e)[:300],
            "retryable": retryable}


def serve_loop(server, wire: _Wire, replica: int,
               drain_timeout_s: float = 30.0) -> bool:
    """Read requests until stdin EOF, a ``close`` message or a preemption
    signal; then drain.  Returns the drain's verdict."""
    from ..obs.events import emit
    from ..resilience import preempt

    inflight = [0]
    served = [0]
    stop = threading.Event()

    def on_done(req_id):
        def cb(fut):
            inflight[0] -= 1   # dispatcher thread only; hb reads racily
            try:
                rows = fut.result()
                served[0] += 1
                wire.send({"kind": "res", "id": req_id, "ok": True,
                           "rows": rows.tolist(),
                           "version": int(rows.version),
                           "qmode": rows.qmode,
                           "shard": (None if rows.shard is None
                                     else list(rows.shard)),
                           "gather_ms": rows.gather_ms})
            except Exception as e:  # noqa: BLE001 - wire it back
                wire.send(_error_payload(req_id, e))
        return cb

    def hb_loop():
        iv = hb_interval()
        while not stop.wait(iv):
            wire.send({"kind": "hb", "inflight": inflight[0],
                       "served": served[0],
                       "mono": round(time.monotonic(), 3)})

    def read_loop():
        for line in sys.stdin:
            if stop.is_set():
                break
            line = line.strip()
            if not line:
                continue
            try:
                msg = json.loads(line)
            except ValueError:
                continue
            kind = msg.get("kind")
            if kind == "close":
                break
            if kind == "fetch_rows":
                _answer_fetch(server, wire, replica, msg)
                continue
            if kind == "rows":
                client = getattr(server.pred, "_gather_client", None)
                if client is not None:
                    client.on_rows(msg)
                continue
            req_id = msg.get("id")
            if kind != "req":
                # an unknown kind fails loud, never served as a request
                emit("serve", f"replica {replica}: rejecting unknown wire "
                     f"kind {kind!r}", console=False,
                     kind_rejected=str(kind), replica=replica)
                if req_id is not None:
                    wire.send({"kind": "res", "id": req_id, "ok": False,
                               "error": "ServeError",
                               "msg": f"unknown wire kind {kind!r}",
                               "retryable": False})
                continue
            if req_id is None:
                continue
            inflight[0] += 1
            fut = server.submit(msg.get("ids") or [],
                                deadline_ms=msg.get("deadline_ms"),
                                rid=msg.get("rid"))
            fut.add_done_callback(on_done(req_id))
        stop.set()

    hb = threading.Thread(target=hb_loop, name="replica:hb", daemon=True)
    reader = threading.Thread(target=read_loop, name="replica:stdin",
                              daemon=True)
    hb.start()
    reader.start()
    # SIGTERM (the guard's flag) and the reader's end (EOF, close) both
    # end in one drain; a read retries EINTR, so the flag is polled here
    while not stop.wait(0.05):
        if preempt.requested():
            stop.set()
    clean = server.drain(timeout=drain_timeout_s)
    hb.join(timeout=2.0)
    wire.send({"kind": "drained", "clean": bool(clean), "replica": replica,
               "served": served[0]})
    return clean


def _wire_stdout():
    """The wire's stream: a duplicate of the process's stdout.  File
    descriptor 1 and ``sys.stdout`` then point at stderr, so nothing
    else this process (or a compiler it starts) prints reaches the
    router."""
    sys.stdout.flush()
    stream = os.fdopen(os.dup(1), "w", buffering=1)
    os.dup2(2, 1)
    sys.stdout = sys.stderr
    return stream


def main(argv: Optional[List[str]] = None) -> int:
    wire = _Wire(_wire_stdout())
    ap = argparse.ArgumentParser(
        prog="python -m roc_tpu_torch.serve.replica", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("artifact", help="exported serving artifact dir")
    ap.add_argument("--replica", type=int, default=0,
                    help="router-assigned replica index (the :proc arm of "
                         "serve fault drills)")
    ap.add_argument("--shard", default=None,
                    help="lo:hi node range this replica ADVERTISES "
                         "(routing metadata only; --shard-index is the "
                         "real sliced-table load)")
    ap.add_argument("--shard-index", type=int, default=None,
                    help="load table slice K of a sharded artifact (export "
                         "--shards N): O(V/N)+halo table bytes, foreign ids "
                         "served through the cross-shard gather")
    ap.add_argument("--table-budget-bytes", type=int, default=0,
                    help="per-replica serving-table byte cap: exit 3 before "
                         "ready when the loaded table exceeds it")
    ap.add_argument("--max-wait-ms", type=float, default=0.2)
    ap.add_argument("--max-queue", type=int, default=None)
    ap.add_argument("--drain-timeout", type=float, default=30.0)
    ap.add_argument("--cpu", action="store_true",
                    help="serve on the CPU (default: the card)")
    args = ap.parse_args(argv)

    from ..obs.events import emit, set_clock_identity
    from ..obs.heartbeat import Heartbeat
    from ..resilience import inject, preempt
    from .export import MANIFEST_NAME, load_predictor
    from .server import DEFAULT_MAX_QUEUE, Server
    # identity first: the fault arm carries the index; the event lane is
    # proc 1 + index, since the router's own lane is proc 0 (its rank):
    # the merged trace keeps the router and replica 0 apart
    inject.note_proc_index(args.replica)
    set_clock_identity(proc=args.replica + 1)
    preempt.install()
    with Heartbeat(f"replica{args.replica} loading artifact"):
        pred = load_predictor(args.artifact, shard=args.shard_index,
                              device="cpu" if args.cpu else None)
    table_bytes = int(pred.table_bytes())
    if args.table_budget_bytes and table_bytes > args.table_budget_bytes:
        emit("serve", f"replica {args.replica}: table {table_bytes} B "
             f"exceeds --table-budget-bytes {args.table_budget_bytes} — "
             f"refusing to serve", kind="table_budget_refused",
             replica=args.replica, table_bytes=table_bytes,
             budget=args.table_budget_bytes)
        print(f"error: serving table {table_bytes} B exceeds the "
              f"per-replica budget {args.table_budget_bytes} B (export "
              f"with --shards to slice it)", file=sys.stderr)
        return 3
    shard = None
    if pred.shard is not None:
        shard = [int(pred.shard[0]), int(pred.shard[1])]
        # the gather's plan is this replica's own manifest's
        with open(os.path.join(args.artifact, MANIFEST_NAME)) as f:
            plan = (json.load(f).get("shards") or {}).get("plan") or []
        client = _GatherClient(wire, plan, args.replica)
        pred._gather_client = client
        pred.gather_fn = client.gather
    elif args.shard:
        lo, hi = args.shard.split(":")
        shard = [int(lo), int(hi)]
    # no clock_sync: the router started this process on its own host, so
    # the lane aligns on the wall clock they share (a sync stamped at this
    # replica's start is no barrier with the router's, and the timeline
    # merger would pin the two different instants together)
    server = Server(pred, max_wait_ms=args.max_wait_ms,
                    name=f"replica{args.replica}",
                    max_queue=(DEFAULT_MAX_QUEUE if args.max_queue is None
                               else args.max_queue), clock_sync=False)
    wire.send({"kind": "ready", "replica": args.replica,
               "pid": os.getpid(), "num_nodes": int(pred.num_nodes),
               "num_classes": pred.num_classes,
               "buckets": list(pred.buckets), "backend": pred.backend,
               "shard": shard, "quant": pred.quant,
               "table_version": int(pred.published().version),
               "table_bytes": table_bytes})
    serve_loop(server, wire, args.replica,
               drain_timeout_s=args.drain_timeout)
    return 0


if __name__ == "__main__":
    sys.exit(main())
