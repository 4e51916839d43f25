"""Host-resident tensor streaming (``roc_tpu/core/streaming.py``): train
graphs whose features do not fit on the device.

The reference's answer to a graph larger than the framebuffer is host
residency: every tensor lives in zero-copy host memory and each GPU task
stages its working set through a small framebuffer cache
(``types.cu:22-32``, ``load_task.cu:365-374``,
``resourcemanager.cc:29-57``).  Here the input features (the dominant
tensor, ``[V, in_dim]``) stay in host memory and row blocks stream
through the card:

- :class:`StagingPool` stages blocks host -> device.  On the card each
  stage copies the rows into a pinned buffer from a small ring (a source
  already in pinned memory is copied from directly), issues the copy with
  ``non_blocking=True`` on a copy stream of its own and records a CUDA
  event; the consumer makes its compute stream wait on that event, never
  the host.  With ``depth >= 1`` a worker thread stages block k+1 while
  block k computes; ``depth == 0`` stages inline, with bit-identical
  results.  On the CPU a stage is a contiguous copy of the rows.
- :class:`StreamedHead`: the first layer (dropout -> linear) from host
  features, forward and weight gradient (``features='host'``).
- :func:`aggregate_to_host` and :class:`StreamingAggregator`: neighbour
  sums with host-resident operands, each tile's sum on the hand-written
  CSR kernel K3 (kernels/spmm.py ``csr_spmm``); on the CPU its plain
  version runs.
- :func:`stream_prefix_to_host`: the parameter-free propagation prefix
  (``S^k X``) with every ``[V, F]`` stage on the host: the SGC host
  tier's precompute and the serving table (serve/propagation.py), one
  walk for both.
"""

from __future__ import annotations

import functools
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from .graph import Graph
from ..resilience.inject import maybe_staging_error

# rows of one staged block (the JAX package's block, and the memory
# model's streamed-block term, core/memory.py)
BLOCK_ROWS = 65536
# the edge-count multiple K3 takes (kernels/spmm.py csr_spmm's ``chunk``)
K3_CHUNK = 512


class _StageError:
    """Worker-side exception carrier (re-raised on the consumer)."""

    def __init__(self, exc: BaseException):
        self.exc = exc


@dataclass
class _Staged:
    """A device block whose copy was issued on the copy stream; ``ready``
    is recorded after it."""
    tensor: torch.Tensor
    ready: torch.cuda.Event


class _PinnedStager:
    """The card's side of staging: a ring of pinned host buffers, one copy
    stream and an event per copy.

    A ring slot is refilled only after the copy that last read it has
    finished (its event, waited on by the staging thread).  Each copy is
    bracketed by two timing events, so :meth:`take_copies` can report the
    device's copy time and bytes (the pinned H2D rate)."""

    def __init__(self, device: torch.device, slots: int):
        self.device = device
        self.stream: Optional[torch.cuda.Stream] = None
        self.slots: List[Optional[torch.Tensor]] = [None] * slots
        self.slot_ready: List[Optional[torch.cuda.Event]] = [None] * slots
        self.next = 0
        self.ring_copies = 0      # stages through the pinned ring
        self.direct_copies = 0    # stages from an already pinned source
        self._copies: List = []   # (start event, end event, bytes)
        self._lock = threading.Lock()

    def stage(self, src: torch.Tensor) -> _Staged:
        torch.cuda.set_device(self.device)
        if self.stream is None:
            self.stream = torch.cuda.Stream(self.device)
        slot = None
        if src.is_pinned():
            host = src
            self.direct_copies += 1
        else:
            slot = self.next
            self.next = (slot + 1) % len(self.slots)
            done = self.slot_ready[slot]
            if done is not None:
                done.synchronize()
            buf = self.slots[slot]
            if buf is None or buf.dtype != src.dtype \
                    or buf.numel() < src.numel():
                buf = self.slots[slot] = torch.empty(
                    src.numel(), dtype=src.dtype, pin_memory=True)
            host = buf[:src.numel()].view(src.shape)
            host.copy_(src)
            self.ring_copies += 1
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with torch.cuda.stream(self.stream):
            start.record(self.stream)
            dev = torch.empty(src.shape, dtype=src.dtype, device=self.device)
            dev.copy_(host, non_blocking=True)
            end.record(self.stream)
        if slot is not None:
            self.slot_ready[slot] = end
        with self._lock:
            self._copies.append((start, end, src.numel()
                                 * src.element_size()))
        return _Staged(dev, end)

    def take_copies(self) -> Dict[str, float]:
        """The copies since the last call: their count, bytes and device
        ms (waits for them to finish)."""
        with self._lock:
            copies, self._copies = self._copies, []
        ms = 0.0
        for start, end, _ in copies:
            end.synchronize()
            ms += start.elapsed_time(end)
        return {"copies": len(copies),
                "bytes": int(sum(n for _, _, n in copies)), "copy_ms": ms}


def _host_tensor(a) -> torch.Tensor:
    """A host array as a CPU tensor (numpy without a copy when it is
    C-contiguous)."""
    if isinstance(a, torch.Tensor):
        if a.device.type != "cpu":
            raise ValueError("host features must be a CPU tensor or a "
                             "numpy array")
        return a
    return torch.from_numpy(np.ascontiguousarray(a))


def _resolve_device(device) -> torch.device:
    from ..train.trainer import resolve_device
    return resolve_device(device)


class StagingPool:
    """Reusable double-buffered host -> device staging pipeline.

    ``stream(fns)`` yields each stage function's result in order.  With
    ``depth >= 1`` a daemon worker thread runs up to ``depth`` stage
    calls ahead of the consumer, so block k+1's host copy and copy issue
    run under block k's compute (the reference's ZC -> FB overlap,
    ``load_task.cu:365-374``).  ``depth == 0`` stages inline: the
    bit-identical parity reference and the baseline ``overlap_frac``
    compares against.

    ``device``: where the blocks go.  On the card the stage functions
    (:func:`_stage_block` with :attr:`stager`) return a block whose copy
    is in flight on the copy stream; before yielding it the pool makes
    the consumer's current stream wait on the copy's event and marks the
    block as used by that stream (``record_stream``), so its memory is
    not reused while the stream still reads it.  The worker thread sets
    the device before its first CUDA call.

    Live-buffer bound: the worker takes one of ``depth`` credits before
    each stage and the consumer returns it when it takes the block, so at
    most ``depth + 1`` staged blocks exist at once.  On the card the host
    runs ahead of the device, so the bound is kept on the device too:
    when the consumer asks for block i+1 it records an event on its
    stream after its work on block i, and the stage of block
    i + depth + 1 waits for that event (with ``depth == 0`` the stage of
    block i+1 waits for block i's work: the synchronous form).

    Stats (reset by :meth:`take_stats`): per block the consumer's
    ``h2d_wait_ms`` (time blocked waiting for a staged block) and the
    worker's ``stage_ms`` (host copy and copy issue); ``1 - wait/stage``
    is the share of staging hidden under compute (``overlap_frac``).  On
    the card a stage issues its copy and returns, so these are the
    host's view: the copy itself runs on the copy stream, and its device
    time is in :meth:`take_stats`'s ``h2d_copy_ms``."""

    def __init__(self, depth: int = 1, device=None):
        self.depth = int(depth)
        if self.depth < 0:
            raise ValueError(f"prefetch depth must be >= 0, got {depth}")
        self.device = torch.device(device) if device is not None \
            else torch.device("cpu")
        if self.device.type == "cuda" and self.device.index is None:
            # the stream and event calls want the card's index
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.stager = (_PinnedStager(self.device, max(2, self.depth + 1))
                       if self.device.type == "cuda" else None)
        self.h2d_wait_ms: List[float] = []
        self.stage_ms: List[float] = []
        self._d2h: Optional[torch.Tensor] = None
        self.max_live = 0
        self._live = 0
        self._lock = threading.Lock()

    def _note_live(self, delta: int) -> None:
        with self._lock:
            self._live += delta
            if self._live > self.max_live:
                self.max_live = self._live

    def take_stats(self) -> Dict[str, object]:
        """The per-block series since the last call, and their summary:
        ``wait_p50_ms``, ``stage_p50_ms`` and ``overlap_frac`` (clamped
        ``1 - wait_total / stage_total``, host times; None when nothing
        was staged).
        On the card also the copies' ``h2d_bytes``, ``h2d_copy_ms``
        (device time) and ``h2d_gbps``.  ``max_live`` is a lifetime high
        mark and persists."""
        with self._lock:
            wait, stage = self.h2d_wait_ms, self.stage_ms
            self.h2d_wait_ms, self.stage_ms = [], []
            max_live = self.max_live
        out: Dict[str, object] = {
            "n": len(wait), "wait_ms": wait, "stage_ms": stage,
            "max_live": max_live, "depth": self.depth,
            "wait_p50_ms": None, "stage_p50_ms": None,
            "overlap_frac": None}
        if wait:
            out["wait_p50_ms"] = round(float(np.median(wait)), 3)
        if stage:
            out["stage_p50_ms"] = round(float(np.median(stage)), 3)
            total = float(sum(stage))
            if total > 0:
                out["overlap_frac"] = round(min(1.0, max(
                    0.0, 1.0 - float(sum(wait)) / total)), 4)
        if self.stager is not None:
            c = self.stager.take_copies()
            out["h2d_bytes"] = c["bytes"]
            out["h2d_copy_ms"] = c["copy_ms"]
            out["h2d_gbps"] = (c["bytes"] / c["copy_ms"] / 1e6
                               if c["copy_ms"] > 0 else None)
        return out

    def download(self, src: torch.Tensor, out: np.ndarray) -> None:
        """``out[...] = src``: from the card through one pinned buffer the
        pool keeps (a pageable download runs at a fraction of the pinned
        rate); from the CPU, a copy."""
        if self.stager is None:
            out[...] = src.numpy()
            return
        n = src.numel()
        buf = self._d2h
        if buf is None or buf.dtype != src.dtype or buf.numel() < n:
            buf = self._d2h = torch.empty(n, dtype=src.dtype,
                                          pin_memory=True)
        host = buf[:n].view(src.shape)
        host.copy_(src)
        out[...] = host.numpy()

    def _ready(self, item):
        """A staged block for the consumer's current stream."""
        if isinstance(item, _Staged):
            cur = torch.cuda.current_stream(item.tensor.device)
            cur.wait_event(item.ready)
            item.tensor.record_stream(cur)
            return item.tensor
        return item

    def stream(self, stage_fns: Sequence[Callable[[], object]]
               ) -> Iterator[object]:
        """Yield ``fn()`` for each staging function, in order, staging up
        to ``depth`` calls ahead on a worker thread."""
        fns = list(stage_fns)
        # live accounting is per pass: a block is released when the
        # consumer asks for the next one
        with self._lock:
            self._live = 0
        # done[i]: recorded on the consumer's stream once it has issued
        # its work on block i (card only)
        done: List[torch.cuda.Event] = []

        def consumer_done():
            if self.stager is not None:
                ev = torch.cuda.Event()
                ev.record(torch.cuda.current_stream(self.device))
                done.append(ev)

        def wait_done(j: int):
            if self.stager is not None and j >= 0:
                done[j].synchronize()

        if self.depth == 0:
            for i, fn in enumerate(fns):
                if i > 0:
                    self._note_live(-1)
                    consumer_done()
                t0 = time.perf_counter()
                wait_done(i - 1)
                val = fn()
                ms = (time.perf_counter() - t0) * 1e3
                with self._lock:
                    self.stage_ms.append(ms)
                    # synchronous: the whole stage is on the critical path
                    self.h2d_wait_ms.append(ms)
                self._note_live(+1)
                yield self._ready(val)
            return

        q: "queue.Queue" = queue.Queue()
        credits = threading.Semaphore(self.depth)
        cancel = threading.Event()
        device = self.device

        def work():
            try:
                if device.type == "cuda":
                    torch.cuda.set_device(device)
                for j, fn in enumerate(fns):
                    while not credits.acquire(timeout=0.1):
                        if cancel.is_set():
                            return
                    if cancel.is_set():
                        return
                    # the credit for block j came with block
                    # j - depth's dequeue, after done[j - depth - 1]
                    wait_done(j - self.depth - 1)
                    t0 = time.perf_counter()
                    val = fn()
                    with self._lock:
                        self.stage_ms.append(
                            (time.perf_counter() - t0) * 1e3)
                    self._note_live(+1)
                    q.put(val)
                    val = None  # the queue owns the only worker reference
            except BaseException as e:  # noqa: BLE001 - re-raised below
                q.put(_StageError(e))

        worker = threading.Thread(target=work, daemon=True,
                                  name="roc-staging")
        worker.start()
        try:
            for i in range(len(fns)):
                if i > 0:
                    consumer_done()
                t0 = time.perf_counter()
                item = q.get()
                with self._lock:
                    self.h2d_wait_ms.append(
                        (time.perf_counter() - t0) * 1e3)
                if isinstance(item, _StageError):
                    raise item.exc
                if i > 0:
                    self._note_live(-1)
                # the credit goes back before the yield: the worker
                # stages the next block while the consumer computes
                credits.release()
                yield self._ready(item)
        finally:
            # a consumer that stops early (an error, a closed generator)
            # waits for the worker's stage in flight, so the next stream
            # of this pool never shares the stager's ring with it
            cancel.set()
            worker.join()


def _stage_block(src, lo: int, hi: int,
                 stager: Optional[_PinnedStager] = None):
    """The one staging call: rows ``[lo, hi)`` of the host array ``src``,
    through ``stager`` onto the card (a :class:`_Staged` block), or, with
    no stager, as a contiguous host copy.  Loops call it through
    :meth:`StagingPool.stream`.  Also the streamed tier's drill site: an
    armed ``staging_io`` fault raises OSError here once."""
    maybe_staging_error()
    rows = _host_tensor(src)[lo:hi]
    if stager is None:
        return rows.clone()
    return stager.stage(rows)


def _stage_fns(pool: StagingPool, src: torch.Tensor,
               ranges: Sequence) -> List[Callable[[], object]]:
    return [functools.partial(_stage_block, src, lo, hi, pool.stager)
            for lo, hi in ranges]


def streamed_linear(feats_host, weight: torch.Tensor,
                    block_rows: int = BLOCK_ROWS,
                    dtype: torch.dtype = torch.float32,
                    prefetch: int = 1) -> torch.Tensor:
    """``feats @ weight`` with ``feats`` in host memory, streamed in
    ``block_rows``-row blocks to ``weight``'s device (block k+1 staged
    under block k's product).  Returns the ``[V, out_dim]`` result on
    that device; the device holds two blocks and the output."""
    src = _host_tensor(feats_host)
    V = src.shape[0]
    pool = StagingPool(depth=prefetch, device=weight.device)
    outs = [block.to(dtype) @ weight for block in pool.stream(_stage_fns(
        pool, src, [(lo, lo + block_rows) for lo in range(0, V, block_rows)]))]
    return torch.cat(outs, dim=0) if len(outs) > 1 else outs[0]


# Device-residency budget for the tile plans' index tables: tables whose
# total bytes fit stay on the device for the plan's lifetime (uploaded
# once); past it they upload per call, one edge chunk at a time, because
# pinning O(E) index bytes on the device would defeat the out-of-core
# tier on the graphs it exists for.
TABLE_CACHE_BYTES = 1 << 30


def _pad_chunk(src: np.ndarray, dst: np.ndarray, dummy: int):
    """One edge chunk as K3 takes it: destination ids relative to the
    chunk's first row ``d0``, both arrays padded to a :data:`K3_CHUNK`
    multiple with the dummy source (which adds nothing) on the chunk's
    last row.  Returns ``(src, dst, d0, rows)``."""
    d0 = int(dst[0])
    rows = int(dst[-1]) - d0 + 1
    n = -(-src.shape[0] // K3_CHUNK) * K3_CHUNK
    s = np.full(n, dummy, dtype=np.int32)
    d = np.full(n, rows - 1, dtype=np.int32)
    s[:src.shape[0]] = src
    d[:dst.shape[0]] = dst - d0
    return s, d, d0, rows


def _iter_chunks(src: np.ndarray, dst: np.ndarray, edge_chunk: int,
                 dummy: int, device: torch.device):
    for e0 in range(0, src.shape[0], edge_chunk):
        s, d, d0, rows = _pad_chunk(src[e0:e0 + edge_chunk],
                                    dst[e0:e0 + edge_chunk], dummy)
        yield (torch.from_numpy(s).to(device), torch.from_numpy(d).to(device),
               d0, rows)


def _dev_chunks(src: np.ndarray, dst: np.ndarray, edge_chunk: int,
                dummy: int, device: torch.device, cache: Optional[dict]):
    """The chunks of a (dst-sorted) edge list on ``device``.  ``cache`` is
    the plan's memo dict (upload once, keep for the plan's lifetime) or
    None (past :data:`TABLE_CACHE_BYTES`), which yields lazily so one
    chunk's upload is live at a time."""
    if cache is None:
        return _iter_chunks(src, dst, edge_chunk, dummy, device)
    key = (edge_chunk, str(device))
    chunks = cache.get(key)
    if chunks is None:
        chunks = list(_iter_chunks(src, dst, edge_chunk, dummy, device))
        cache[key] = chunks
    return chunks


def _chunk_sum(acc: torch.Tensor, block: torch.Tensor, chunk) -> None:
    """``acc[d0:d0 + rows] += A_chunk @ block`` on K3 (the plain version
    for a CPU block)."""
    from ..kernels.spmm import csr_spmm
    src, dst, d0, rows = chunk
    acc[d0:d0 + rows].add_(csr_spmm(block, src, dst, rows, chunk=K3_CHUNK))


@dataclass
class _SrcBlockPlan:
    """Static per-source-block edge layout (host side, built once)."""
    lo: int                 # first global source row of the block
    hi: int                 # one past the last
    src_local: np.ndarray   # int32 [E_b] source ids relative to lo
    dst: np.ndarray         # int32 [E_b] destination rows (sorted)
    _dev: dict = field(default_factory=dict, repr=False, compare=False)

    def dev_chunks(self, edge_chunk: int, device, cache: bool = True):
        return _dev_chunks(self.src_local, self.dst, edge_chunk,
                           self.hi - self.lo, torch.device(device),
                           self._dev if cache else None)


class StreamingAggregator:
    """Out-of-core CSR sum ``out[dst] = sum feats[src]`` with ``feats`` in
    host memory and ``out`` on the device.

    Edges are grouped by source block once, at construction; their index
    tables go to the device here, once, while their bytes fit
    ``table_cache_bytes`` (past it they upload per call).  Each call
    streams the feature blocks through the staging pool and adds each
    block's edge chunks into the output with K3, the chunk's destination
    rows only.  Device memory: two feature blocks, the ``[num_rows, F]``
    output and one chunk's rows.  ``device``: the card unless the caller
    asks for another."""

    def __init__(self, graph: Graph, block_rows: int = BLOCK_ROWS,
                 edge_chunk: int = 1 << 20, prefetch: int = 1,
                 table_cache_bytes: int = TABLE_CACHE_BYTES, device=None):
        self.device = _resolve_device(device)
        self.num_rows = graph.num_nodes
        self.block_rows = block_rows
        self.edge_chunk = edge_chunk
        self.pool = StagingPool(depth=prefetch, device=self.device)
        dst_all = graph.edge_dst()
        src_all = graph.col_idx
        # group edges by source block; within a block keep dst order
        block_of = src_all // block_rows
        order = np.argsort(block_of, kind="stable")
        src_s, dst_s = src_all[order], dst_all[order]
        blocks_present = np.unique(block_of)
        self.plans: List[_SrcBlockPlan] = []
        starts = np.searchsorted(block_of[order], blocks_present, side="left")
        ends = np.searchsorted(block_of[order], blocks_present, side="right")
        for b, lo_e, hi_e in zip(blocks_present, starts, ends):
            lo = int(b) * block_rows
            hi = min(lo + block_rows, self.num_rows)
            sl = src_s[lo_e:hi_e] - lo
            dl = dst_s[lo_e:hi_e]
            o = np.argsort(dl, kind="stable")
            self.plans.append(_SrcBlockPlan(
                lo=lo, hi=hi, src_local=sl[o].astype(np.int32),
                dst=dl[o].astype(np.int32)))
        idx_bytes = sum(p.src_local.nbytes + p.dst.nbytes
                        for p in self.plans)
        self.cache_tables = idx_bytes <= table_cache_bytes
        if self.cache_tables:
            for plan in self.plans:
                plan.dev_chunks(edge_chunk, self.device)

    def __call__(self, feats_host,
                 out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
        src = _host_tensor(feats_host)
        out = torch.zeros((self.num_rows, src.shape[1]), dtype=out_dtype,
                          device=self.device)
        stage = _stage_fns(self.pool, src,
                           [(p.lo, p.hi) for p in self.plans])
        for plan, block in zip(self.plans, self.pool.stream(stage)):
            block = block.to(out_dtype)
            for chunk in plan.dev_chunks(self.edge_chunk, self.device,
                                         cache=self.cache_tables):
                _chunk_sum(out, block, chunk)
        return out


@dataclass
class _TilePlan:
    """Edges of one (dst block, src block) adjacency tile."""
    src_lo: int
    src_rows: int           # rows of the staged source block
    src_local: np.ndarray   # int32 [E_t] source ids relative to src_lo
    dst_local: np.ndarray   # int32 [E_t] dst ids relative to the dst
    #                         block start (sorted)
    _dev: dict = field(default_factory=dict, repr=False, compare=False)

    def dev_chunks(self, edge_chunk: int, device, cache: bool = True):
        return _dev_chunks(self.src_local, self.dst_local, edge_chunk,
                           self.src_rows, torch.device(device),
                           self._dev if cache else None)


def build_tile_plans(graph: Graph, block_rows: int):
    """dst block -> its per-src-block edge tiles (host side, once): both
    operands of a tile fit one block, so neither the features nor the
    output is ever whole on the device.  The CSR is already in
    destination order, so a dst block's edges are a contiguous range and
    each src block's share of it, taken in that order, is sorted by
    destination: the JAX package's lexsorted tiles, edge for edge,
    without a sort."""
    V = graph.num_nodes
    row_ptr = np.asarray(graph.row_ptr)
    col = np.asarray(graph.col_idx)
    tiles: dict = {}
    for d in range(-(-V // block_rows)):
        lo, hi = d * block_rows, min((d + 1) * block_rows, V)
        e0, e1 = int(row_ptr[lo]), int(row_ptr[hi])
        if e0 == e1:
            continue
        src = col[e0:e1]
        dst = np.repeat(np.arange(hi - lo, dtype=np.int32),
                        np.diff(row_ptr[lo:hi + 1]))
        sb = src // block_rows
        for s in np.unique(sb):
            m = sb == s
            s_lo = int(s) * block_rows
            tiles.setdefault(d, []).append(_TilePlan(
                src_lo=s_lo, src_rows=min(block_rows, V - s_lo),
                src_local=(src[m] - s_lo).astype(np.int32),
                dst_local=dst[m]))
    return tiles


def aggregate_to_host(graph: Graph, feats_host,
                      block_rows: int = BLOCK_ROWS,
                      edge_chunk: int = 1 << 20,
                      tiles=None, prefetch: int = 1,
                      pool: Optional[StagingPool] = None,
                      device=None) -> np.ndarray:
    """Fully out-of-core CSR sum: the features and the fp32 result live in
    host memory; the device holds one destination accumulator block, the
    double-buffered source blocks and the tiles' index chunks.  The next
    tile's source block stages under the current tile's sums, each edge
    chunk of a tile one K3 launch (``acc[rows].add_(csr_spmm(...))``),
    the reference's stage-compute-writeback loop (``types.cu:22-32``,
    ``load_task.cu:365-374``); each finished accumulator comes back
    through the pool's pinned download buffer.  Runs on ``pool``'s device, else
    ``device`` (the card unless the caller asks for another); a failed
    K3 build or launch raises."""
    if pool is None:
        pool = StagingPool(depth=prefetch, device=_resolve_device(device))
    dev = pool.device
    src = _host_tensor(feats_host)
    V = graph.num_nodes
    F = src.shape[1]
    if tiles is None:
        tiles = build_tile_plans(graph, block_rows)
    out = np.zeros((V, F), dtype=np.float32)
    work = [(d, t) for d in sorted(tiles) for t in tiles[d]]
    idx_bytes = sum(t.src_local.nbytes + t.dst_local.nbytes
                    for _, t in work)
    cache_tables = idx_bytes <= TABLE_CACHE_BYTES
    stage = _stage_fns(pool, src, [(t.src_lo, t.src_lo + block_rows)
                                   for _, t in work])
    acc = None
    cur_d = None
    for (d, t), block in zip(work, pool.stream(stage)):
        if d != cur_d:
            if acc is not None:
                d_lo = cur_d * block_rows
                pool.download(acc, out[d_lo:d_lo + acc.shape[0]])
            cur_d = d
            rows = min(block_rows, V - d * block_rows)
            acc = torch.zeros((rows, F), dtype=torch.float32, device=dev)
        block = block.to(torch.float32)
        for chunk in t.dev_chunks(edge_chunk, dev, cache=cache_tables):
            _chunk_sum(acc, block, chunk)
    if acc is not None:
        d_lo = cur_d * block_rows
        pool.download(acc, out[d_lo:d_lo + acc.shape[0]])
    return out


def _prefix_op_view(op) -> tuple:
    """``(kind, attrs)`` of a prefix op: the builder's ``_Op`` objects
    (the trainer's ``streamable_agg_head``) and the dict descriptors the
    serving manifest keeps (serve/propagation.py) walk the same path."""
    if isinstance(op, dict):
        return op["kind"], op
    return op.kind, op.attrs


def stream_prefix_to_host(graph: Graph, prefix_ops, feats_host,
                          block_rows: int = BLOCK_ROWS,
                          prefetch: int = 1,
                          capture=None, device=None,
                          pool: Optional[StagingPool] = None) -> np.ndarray:
    """Evaluate a parameter-free norm/aggregation prefix (the op list of
    ``Model.streamable_agg_head``, or its dict descriptors) with every
    ``[V, F]`` stage in host memory, in fp32: ``indegree_norm`` is a
    host row scale, ``scatter_gather`` SUM/AVG a :func:`aggregate_to_host`
    (AVG then divides by ``max(deg, 1)`` on the host), and
    ``fused_aggregate`` the host-scaled sum ``[relu](d * A (d * x))``.
    One staging pool (``pool``, else one of depth ``prefetch`` made here)
    and one set of tile plans serve the whole walk; the sums run on the
    pool's device (``device``: the card unless the caller asks for
    another), through K3.  Returns the last stage.

    ``capture`` receives each post-op stage: a list (anything with
    ``.append``) keeps them (the per-stage tables of the serving tier's
    invalidation, serve/propagation.py); a callable is called with each
    instead (serve/quant.py ``QuantizingCapture`` encodes each as it
    streams).  Each stage is an array the sink owns alone.  One walk for
    the trainer's precompute and the serving table."""
    from ..models.builder import AGGR_AVG, AGGR_SUM
    from ..ops.norm import inv_sqrt_degree_np
    x = np.asarray(feats_host, dtype=np.float32)
    deg = np.asarray(graph.in_degree, dtype=np.float32)
    inv_sqrt = inv_sqrt_degree_np(graph.in_degree)[:, None]
    tiles = None
    if pool is None:
        pool = StagingPool(depth=prefetch, device=_resolve_device(device))
    for op in prefix_ops:
        kind, attrs = _prefix_op_view(op)
        if kind == "indegree_norm":
            x = x * inv_sqrt
        elif kind == "scatter_gather":
            aggr = attrs.get("aggr", AGGR_SUM)
            if aggr not in (AGGR_SUM, AGGR_AVG):
                raise NotImplementedError(
                    f"{aggr} aggregation in a precompute prefix")
            if tiles is None:
                tiles = build_tile_plans(graph, block_rows)
            x = aggregate_to_host(graph, x, block_rows, tiles=tiles,
                                  pool=pool)
            if aggr == AGGR_AVG:
                x = x / np.maximum(deg, 1.0)[:, None]
        elif kind == "fused_aggregate":
            # the fused norm -> sum -> norm [-> relu], unrolled on the
            # host: the walk runs once, so exactness is what matters
            if tiles is None:
                tiles = build_tile_plans(graph, block_rows)
            x = aggregate_to_host(graph, x * inv_sqrt, block_rows,
                                  tiles=tiles, pool=pool) * inv_sqrt
            if attrs.get("activation", "none") != "none":
                np.maximum(x, 0.0, out=x)
        else:
            raise NotImplementedError(kind)
        if capture is not None:
            # every branch rebinds x to a fresh array (the relu above
            # runs in place before this), so the sink owns each stage
            if callable(capture):
                capture(x)
            else:
                capture.append(x)
    return x


class StreamedHead:
    """The first model layer (``dropout -> linear``) from host-resident
    features, with its weight gradient: what makes
    ``TrainConfig(features='host')`` a training path.

    Forward: per ``block_rows`` block, stage the block to ``device``
    through the staging pool, apply inverted dropout and multiply into the
    ``[V, H]`` output.  Weight gradient: given the cotangent ``dY`` of the
    projected activations, ``dW = sum_b dropout(X_b)^T @ dY_b`` in fp32,
    with the same masks: block b's mask is drawn from a generator seeded
    with ``derived_seed(seed, b)`` (train/trainer.py), where ``seed`` is
    the step's, so :meth:`wgrad` redraws :meth:`forward`'s masks exactly
    and the masks do not depend on the staging order (``prefetch`` 0 and
    1 give the same bits).  The raw ``[V, F]`` features never reside on
    the device, and the pool holds at most ``prefetch + 1`` blocks.

    Blocks cross in the host copy's dtype: the trainer keeps it in the
    compute dtype (bf16 in 'mixed' and 'bfloat16': 2 bytes an element).
    The mask stream differs from the device-resident path's (one
    generator per block), as in the JAX package (one key per block);
    eval mode matches it."""

    def __init__(self, rate: float, block_rows: int = BLOCK_ROWS,
                 prefetch: int = 1, device=None):
        self.rate = float(rate)
        self.block_rows = block_rows
        self.pool = StagingPool(depth=prefetch, device=device)

    def _blocks(self, V: int):
        return [(lo, min(lo + self.block_rows, V))
                for lo in range(0, V, self.block_rows)]

    def _generators(self, seed: Optional[int], n_blocks: int):
        if seed is None:
            return [None] * n_blocks
        from ..train.trainer import derived_seed
        return [torch.Generator(device=self.pool.device).manual_seed(
            derived_seed(seed, b)) for b in range(n_blocks)]

    def _masked(self, x, gen, train):
        from ..ops.dense import dropout
        if not (train and gen is not None):
            return x
        return dropout(x, self.rate, gen, True)

    def forward(self, weight: torch.Tensor, feats_host,
                seed: Optional[int], train: bool) -> torch.Tensor:
        """``[V, H]`` projected activations on ``weight``'s device, in
        its dtype (``dense.linear``)."""
        from ..ops.dense import linear
        src = _host_tensor(feats_host)
        blocks = self._blocks(src.shape[0])
        gens = self._generators(seed, len(blocks))
        y = torch.empty((src.shape[0], weight.shape[1]), dtype=weight.dtype,
                        device=weight.device)
        for (lo, hi), gen, x in zip(blocks, gens, self.pool.stream(
                _stage_fns(self.pool, src, blocks))):
            y[lo:hi] = linear(self._masked(x.to(weight.dtype), gen, train),
                              weight)
        return y

    def wgrad(self, feats_host, dY: torch.Tensor, seed: Optional[int],
              train: bool) -> torch.Tensor:
        """dL/dW of the head linear, fp32 ``[F, H]``, streamed: each block
        in ``dY``'s dtype, its mask redrawn from the forward's seed, its
        product upcast to fp32 (bf16 products are exact in fp32, so this
        is fp32 accumulation of the bf16 products) and summed over the
        blocks in fp32."""
        src = _host_tensor(feats_host)
        blocks = self._blocks(src.shape[0])
        gens = self._generators(seed, len(blocks))
        dW = torch.zeros((src.shape[1], dY.shape[1]), dtype=torch.float32,
                         device=dY.device)
        for (lo, hi), gen, x in zip(blocks, gens, self.pool.stream(
                _stage_fns(self.pool, src, blocks))):
            d = self._masked(x.to(dY.dtype), gen, train)
            dW.addmm_(d.t().float(), dY[lo:hi].float())
        return dW
