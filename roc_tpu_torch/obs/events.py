"""Categorized event bus (``roc_tpu/obs/events.py``): the one home for
run diagnostics.

Every runtime decision and failure the port reports flows through
:func:`emit` as a categorized event, fanned out to sinks:

- :class:`ConsoleSink` — ``# <message>`` lines on stderr (stdout stays
  the ``[INFER]`` metrics stream);
- :class:`JsonlSink` — append-only JSONL, one flushed line per event.

The bus starts with a console sink; a JSONL sink attaches through
:func:`configure` (the CLI's ``--events``) or the ``ROC_TPU_EVENTS``
environment variable, the same switch as the JAX package's, so one
harness arms both and a stream from either reads the same: the same
categories, the same record keys.

Every record carries the clock tuple ``t`` (wall seconds), ``mono``
(monotonic seconds), ``host`` and ``proc`` — the ``torch.distributed``
rank when a process group is up, else 0, unless
:func:`set_clock_identity` pinned it.  The bus keeps a bounded ring of
recent records; :func:`dump_flight_record` writes it to a dated
``flightrecord_*.json`` on fatal paths (fault sites about to SIGKILL,
preemption, stall deadlines, and an unhandled exception once
:func:`install_excepthook` ran, as the CLI's does), so a dead process's
last events survive without a JSONL sink.

Thread-safe: the heartbeat and the async saver emit from their own
threads.
"""

from __future__ import annotations

import collections
import json
import os
import socket
import sys
import threading
import time
from typing import Any, Dict, List, Optional

# The JAX package's categories (roc_tpu/obs/events.py CATEGORIES); free-
# form strings are accepted.  The port emits: resolve, epoch, stall, run,
# resilience (injected faults, recovery retries, corrupt-checkpoint
# fallbacks, preemption, elastic restores), timeline (the saver's span
# laps, the server's and router's spans and clock_sync), checkpoint
# (committed async saves, superseded snapshots), serve (publishes,
# failover, hedges, re-dispatches, drains, summaries) and slo (breaches
# and recoveries).
CATEGORIES = ("manifest", "resolve", "plan", "compile", "epoch",
              "bench", "stall", "run", "analysis", "pipeline",
              "costmodel", "programspace", "resilience", "timeline",
              "serve", "sharding", "checkpoint", "slo", "protocol")

_HOST = socket.gethostname().split(".")[0]
_PROC: Optional[int] = None


def set_clock_identity(proc: Optional[int] = None,
                       host: Optional[str] = None) -> None:
    """Pin the process identity stamped on every event (otherwise the
    ``torch.distributed`` rank, or 0 with no process group)."""
    global _PROC, _HOST
    if proc is not None:
        _PROC = int(proc)
    if host is not None:
        _HOST = host


def process_index() -> int:
    """This process's rank in the default ``torch.distributed`` group,
    0 when none is up (nor can be: ``torch.distributed`` not imported)."""
    if "torch.distributed" not in sys.modules:
        return 0
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return int(dist.get_rank())
    return 0


def clock_identity() -> Dict[str, Any]:
    """The ``host``/``proc`` half of the clock tuple."""
    return {"host": _HOST,
            "proc": _PROC if _PROC is not None else process_index()}


def _jsonable(v: Any) -> Any:
    """Best-effort conversion to something json.dumps accepts."""
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple, set)):
        return [_jsonable(x) for x in v]
    import numpy as np
    if isinstance(v, np.integer):
        return int(v)
    if isinstance(v, np.floating):
        return float(v)
    if isinstance(v, np.ndarray) and v.size <= 64:
        return v.tolist()
    return str(v)


class ConsoleSink:
    """``# <message>`` lines on stderr."""

    def __init__(self, stream=None):
        self._stream = stream

    def write(self, record: Dict[str, Any]) -> None:
        if not record.get("console", True):
            return
        stream = self._stream if self._stream is not None else sys.stderr
        print(f"# {record['msg']}", file=stream)

    def close(self) -> None:
        pass


class JsonlSink:
    """Append-only JSONL; opens lazily on the first event and writes
    every line at once, unbuffered, to a file opened for appending: a
    killed run still leaves a readable artifact, and processes that
    share one file (a router and the replicas that inherit its
    ``ROC_TPU_EVENTS``) append whole lines that never interleave."""

    def __init__(self, path: str):
        self.path = path
        self._fh = None

    def write(self, record: Dict[str, Any]) -> None:
        rec = {k: _jsonable(v) for k, v in record.items()
               if k != "console"}
        if self._fh is None:
            d = os.path.dirname(os.path.abspath(self.path))
            os.makedirs(d, exist_ok=True)
            self._fh = open(self.path, "ab", buffering=0)
        # one write call a line (O_APPEND places it at the end whole)
        self._fh.write((json.dumps(rec) + "\n").encode())

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


# ring capacity (events, not bytes) of the crash flight recorder
FLIGHT_RING_EVENTS = 256


def flight_ring_events() -> int:
    try:
        return int(os.environ.get("ROC_TPU_FLIGHT_EVENTS",
                                  FLIGHT_RING_EVENTS))
    except ValueError:
        return FLIGHT_RING_EVENTS


class EventLog:
    """A bus fanning events out to its sinks.  A sink's failure is
    reported once on stderr and then ignored: telemetry must never take
    down the run it observes.  Every record is stamped with the clock
    tuple and kept in the flight ring."""

    def __init__(self, sinks: Optional[List] = None,
                 ring_events: Optional[int] = None):
        self.sinks: List = list(sinks) if sinks is not None else []
        self._lock = threading.Lock()
        self._sink_warned = False
        self.ring: collections.deque = collections.deque(
            maxlen=flight_ring_events() if ring_events is None
            else ring_events)

    def emit(self, cat: str, msg: str, console: bool = True,
             **fields: Any) -> Dict[str, Any]:
        record = {"t": round(time.time(), 3),
                  "mono": round(time.monotonic(), 6),
                  **clock_identity(),
                  "cat": cat, "msg": msg,
                  "console": console, **fields}
        with self._lock:
            self.ring.append(record)
            for sink in self.sinks:
                try:
                    # the bus lock serialises the sinks: concurrent
                    # emitters would tear a shared JSONL handle's lines
                    # roc-lint: ok=blocking-under-lock
                    sink.write(record)
                except Exception as e:  # noqa: BLE001 - never raise
                    if not self._sink_warned:
                        self._sink_warned = True
                        print(f"# event sink {type(sink).__name__} "
                              f"failed: {e!r} (further failures "
                              f"silent)", file=sys.stderr)
        return record

    def add_sink(self, sink) -> None:
        with self._lock:
            self.sinks.append(sink)

    def jsonl_path(self) -> Optional[str]:
        for sink in self.sinks:
            if isinstance(sink, JsonlSink):
                return sink.path
        return None

    def close(self) -> None:
        with self._lock:
            for sink in self.sinks:
                try:
                    sink.close()
                except Exception:  # noqa: BLE001
                    pass


_BUS: Optional[EventLog] = None
_BUS_LOCK = threading.Lock()


def get_bus() -> EventLog:
    """The process-global bus, created on first use: a console sink,
    plus a JSONL sink when ``ROC_TPU_EVENTS`` is set."""
    global _BUS
    with _BUS_LOCK:
        if _BUS is None:
            _BUS = EventLog([ConsoleSink()])
            env_path = os.environ.get("ROC_TPU_EVENTS")
            if env_path:
                _BUS.add_sink(JsonlSink(env_path))
        return _BUS


def configure(jsonl_path: Optional[str] = None,
              console: bool = True) -> EventLog:
    """(Re)build the global bus: ``jsonl_path`` attaches the JSONL sink,
    ``console=False`` drops the stderr lines."""
    global _BUS
    with _BUS_LOCK:
        if _BUS is not None:
            _BUS.close()
        sinks: List = [ConsoleSink()] if console else []
        if jsonl_path:
            sinks.append(JsonlSink(jsonl_path))
        _BUS = EventLog(sinks)
        return _BUS


def emit(cat: str, msg: str, console: bool = True,
         **fields: Any) -> Dict[str, Any]:
    """Emit on the global bus; ``console=False`` keeps the event off
    stderr (it still lands in the JSONL artifact and the ring)."""
    return get_bus().emit(cat, msg, console=console, **fields)


def flight_record_dir() -> str:
    """Where dumps land: ``ROC_TPU_FLIGHT_DIR``, else next to the JSONL
    artifact, else the working directory."""
    env = os.environ.get("ROC_TPU_FLIGHT_DIR")
    if env:
        return env
    jl = get_bus().jsonl_path()
    if jl:
        return os.path.dirname(os.path.abspath(jl)) or "."
    return "."


def dump_flight_record(reason: str,
                       path: Optional[str] = None) -> Optional[str]:
    """Write the ring to a dated ``flightrecord_*.json`` (date, pid and
    a slug of ``reason`` in the name); returns its path, or None on
    failure — a dump never masks the failure that triggered it."""
    bus = get_bus()
    try:
        ident = clock_identity()
        if path is None:
            slug = "".join(c if c.isalnum() else "-"
                           for c in reason)[:40].strip("-")
            name = (f"flightrecord_"
                    f"{time.strftime('%Y%m%d-%H%M%S')}_"
                    f"p{ident['proc']}_pid{os.getpid()}_{slug}.json")
            path = os.path.join(flight_record_dir(), name)
        with bus._lock:
            events = [
                {k: _jsonable(v) for k, v in r.items() if k != "console"}
                for r in bus.ring]
        payload = {"reason": reason,
                   "t": round(time.time(), 3),
                   "mono": round(time.monotonic(), 6),
                   "pid": os.getpid(), **ident,
                   "n_events": len(events), "events": events}
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        tmp = f"{path}.tmp{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(payload, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except Exception as e:  # noqa: BLE001 - never mask the trigger
        try:
            print(f"# flight-record dump failed: {e!r}", file=sys.stderr)
        except OSError:
            pass
        return None
    try:
        print(f"# flight record ({reason}): {path}", file=sys.stderr)
    except OSError:
        pass
    return path


_EXCEPTHOOK_INSTALLED = False


def install_excepthook() -> None:
    """Chain a flight-record dump onto ``sys.excepthook`` so an unhandled
    exception leaves the last events behind.  Idempotent; the previous
    hook always runs; ``KeyboardInterrupt`` and ``SystemExit`` dump
    nothing."""
    global _EXCEPTHOOK_INSTALLED
    if _EXCEPTHOOK_INSTALLED:
        return
    _EXCEPTHOOK_INSTALLED = True
    prev = sys.excepthook

    def hook(exc_type, exc, tb):
        if not issubclass(exc_type, (KeyboardInterrupt, SystemExit)):
            dump_flight_record(f"unhandled {exc_type.__name__}")
        prev(exc_type, exc, tb)

    sys.excepthook = hook
