"""The ring halo (``roc_tpu/parallel/ring.py``): the halo exchange as a
rotation of one part's rows around the ranks, overlapped with the
aggregation, so no rank holds more than two parts' rows at a time.

The reference materialises every vertex's features on every GPU for each
aggregation (``scattergather.cc:70-72``), which caps the graph at one
device's memory.  On a ring each rank keeps a rotating buffer of one
part's rows.  At hop k, rank p holds part ``(p - k) mod S`` and sums the
edges of its own rows whose sources live in that part into its
``[part_nodes, F]`` output, while the buffer moves one rank on.  After S
hops every edge has been summed once, and the peak holds O(V/P) rows
instead of O(V).

The tables are the JAX package's, built by the same numpy code and
bit-equal to it (tests/test_torch_ring.py): for each (part, source part)
pair a flat edge list sorted by destination, padded to ``pair_edges``
(a multiple of :data:`RING_MULTIPLE`, the largest pair over every part)
with the dummy source ``part_nodes`` (a row that reads as zero) on the
destination ``part_nodes - 1``.  On power-law graphs the padding comes
to 1.5-1.7x the real edges (``padding_ratio``).

The port's additions, for a rank that holds only its own part:

- each pair's row ranges (:func:`pair_row_ptr`, int64 ``[S, part_nodes
  + 1]``), built once from the real edges, so K3 (kernels/spmm.py) walks
  no padding: with its own pre-pass every padding edge would fall in the
  last row's range, one warp gathering them all;
- :func:`ring_aggregate`'s hop sum: K3 on the kernel routes, K3's plain
  version on the plain ones (or, given the baked fused weights of
  :func:`ring_weight_tables`, a weighted plain sum);
- the rotation over ``torch.distributed`` (parallel/distributed.py
  ``Collectives.ring_shift``), differentiable through :class:`_RingHop`,
  whose backward sends the cotangent the other way round.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from ..ops.aggregate import DEFAULT_BUDGET_ELEMS

# pair_edges is rounded up to a multiple of this (the JAX package's 8);
# K3 takes it as its ``chunk``, the multiple its edge count must have
RING_MULTIPLE = 8


def ring_hop_perm(num_shards: int):
    """One hop of the rotation as ``(source rank, destination rank)``
    pairs: ``[(i, (i + 1) % S)]``, one cycle over every rank.  Each hop
    of :func:`ring_aggregate` sends to the next rank and receives from
    the previous one, this permutation."""
    return [(i, (i + 1) % num_shards) for i in range(num_shards)]


@dataclass
class RingTables:
    """Flat per-(part, source part) edge lists, uniform shapes.

    src: int32 ``[P, S, pair_edges]`` source ids local to the source part
      (dummy ``part_nodes``).
    dst: int32 ``[P, S, pair_edges]`` local destination rows, ascending
      within each pair; padding ``part_nodes - 1``.
    padding_ratio: padded slots over real edges (>= 1).
    """

    src: np.ndarray
    dst: np.ndarray
    padding_ratio: float

    @property
    def pair_edges(self) -> int:
        return int(self.src.shape[2])


def build_ring_pairs(pg, p: int, col: Optional[np.ndarray] = None) -> dict:
    """Part ``p``'s edge lists by source part, from ``p``'s own columns:
    ``{s: (src local to part s, local dst)}``, dst ascending in each
    pair.  ``col`` is the part's column array (global ids, as
    core/partition.py ``partition_col`` gives it) for a plan without
    ``part_col_idx``."""
    P = pg.num_parts
    offsets = np.asarray([l for l, _ in pg.bounds] + [pg.num_nodes],
                         dtype=np.int64)
    starts = np.minimum(offsets[:P], pg.num_nodes)
    n = int(pg.real_nodes[p])
    ptr = pg.part_row_ptr[p, :n + 1].astype(np.int64)
    if col is None:
        col = pg.part_col_idx[p]
    col = np.asarray(col[:int(ptr[n])], dtype=np.int64)
    dst = np.repeat(np.arange(n, dtype=np.int64), np.diff(ptr))
    shard = np.searchsorted(offsets[1:P + 1], col, side="right")
    pairs = {}
    for s in range(P):
        sel = shard == s
        # dst is sorted, so the stable mask keeps it sorted
        pairs[s] = ((col[sel] - starts[s]).astype(np.int32),
                    dst[sel].astype(np.int32))
    return pairs


def pack_ring_part(pairs: dict, num_shards: int, pair_edges: int,
                   part_nodes: int):
    """One part's ``[S, pair_edges]`` (src, dst) tables: padding sources
    are the dummy ``part_nodes``, padding destinations the last row."""
    src = np.full((num_shards, pair_edges), part_nodes, dtype=np.int32)
    dst = np.full((num_shards, pair_edges), part_nodes - 1, dtype=np.int32)
    for s, (c, d) in pairs.items():
        src[s, :c.shape[0]] = c
        dst[s, :d.shape[0]] = d
    return src, dst


def round_pair_edges(max_pair: int) -> int:
    """The pair width: ``max_pair`` rounded up to :data:`RING_MULTIPLE`."""
    return -(-max(max_pair, 1) // RING_MULTIPLE) * RING_MULTIPLE


def build_ring_tables(pg) -> RingTables:
    """Every part's tables, padded to the largest pair (the JAX package's
    single-process form; a rank builds its own part's with
    :func:`build_ring_pairs` and agrees on ``pair_edges`` with the others,
    parallel/distributed.py ``shard_dataset``)."""
    P = pg.num_parts
    all_pairs = {p: build_ring_pairs(pg, p) for p in range(P)}
    max_pair = max((d.shape[0] for pairs in all_pairs.values()
                    for _, d in pairs.values()), default=1)
    total_real = sum(d.shape[0] for pairs in all_pairs.values()
                     for _, d in pairs.values())
    pair_edges = round_pair_edges(max_pair)
    src = np.empty((P, P, pair_edges), dtype=np.int32)
    dst = np.empty((P, P, pair_edges), dtype=np.int32)
    for p, pairs in all_pairs.items():
        src[p], dst[p] = pack_ring_part(pairs, P, pair_edges, pg.part_nodes)
    ratio = (P * P * pair_edges) / max(total_real, 1)
    return RingTables(src=src, dst=dst, padding_ratio=float(ratio))


def ring_weight_part(pg, p: int, src: np.ndarray, dst: np.ndarray,
                     d_global: np.ndarray) -> np.ndarray:
    """Part ``p``'s baked fused weights, fp32 ``[S, pair_edges]`` for its
    tables ``src``/``dst``: ``w = d[dst_global] * d[src_global]``, the
    entries of ``D^-1/2 A D^-1/2`` in ring layout; padding slots (the
    dummy source) weigh 0.  ``d_global`` is the inv-sqrt in-degree over
    the original vertex ids."""
    P = pg.num_parts
    S = src.shape[0]
    offsets = np.asarray([l for l, _ in pg.bounds] + [pg.num_nodes],
                         dtype=np.int64)
    starts = np.minimum(offsets[:P], pg.num_nodes)
    d = np.asarray(d_global, dtype=np.float32)
    w = np.zeros(src.shape, dtype=np.float32)
    # padding dst slots use part_nodes - 1 (past the real rows perhaps):
    # clipped for the lookup, and the dummy-source mask zeroes them
    dstg = np.minimum(starts[p] + dst.astype(np.int64), pg.num_nodes - 1)
    for s in range(S):
        srcl = src[s].astype(np.int64)
        real = srcl < pg.part_nodes
        srcg = np.minimum(starts[s] + srcl, pg.num_nodes - 1)
        w[s] = np.where(real, d[dstg[s]] * d[srcg], 0.0)
    return w


def ring_weight_tables(pg, rt: RingTables,
                       d_global: np.ndarray) -> np.ndarray:
    """Every part's :func:`ring_weight_part`, fp32 ``[P, S,
    pair_edges]``."""
    return np.stack([ring_weight_part(pg, p, rt.src[p], rt.dst[p], d_global)
                     for p in range(pg.num_parts)])


def pair_row_ptr(pairs: dict, num_shards: int, part_nodes: int
                 ) -> np.ndarray:
    """Each pair's row ranges over its real edges, int64 ``[S, part_nodes
    + 1]``: ``row_ptr[s, v]`` is the first edge of pair s with destination
    at least v, and ``row_ptr[s, part_nodes]`` the pair's real edge count,
    so the padding after it is in no row's range."""
    keys = np.arange(part_nodes + 1, dtype=np.int64)
    out = np.zeros((num_shards, part_nodes + 1), dtype=np.int64)
    for s, (_, d) in pairs.items():
        out[s] = np.searchsorted(d.astype(np.int64), keys, side="left")
    return out


# ----------------------------------------------------------- the rotation


class _RingHop(torch.autograd.Function):
    """One hop of the rotation: the previous rank's buffer, received for
    ``buf`` sent to the next one (``pending``, started by the caller, so
    the transfer can run under the hop's sum).  The backward sends the
    cotangent the other way round: the transpose of a rotation is the
    opposite rotation."""

    @staticmethod
    def forward(ctx, buf, comm, pending):
        ctx.comm = comm
        return pending.wait()

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.ring_shift(g.contiguous(), -1).wait(), None, None


def _weighted_pair_sum(buf: torch.Tensor, src: torch.Tensor,
                       dst: torch.Tensor, w: torch.Tensor, num_rows: int,
                       budget_elems: int = DEFAULT_BUDGET_ELEMS
                       ) -> torch.Tensor:
    """``out[d] = sum w_e * buf[s]`` over the pair's edges (plain, the
    baked fused ring): the zero row appended for the dummy source, the
    weight applied in the activations' dtype to each gathered row, the
    rows added in fp32 (bf16 activations) and rounded once."""
    full = torch.cat([buf, buf.new_zeros((1, buf.shape[1]))], dim=0)
    acc = torch.promote_types(buf.dtype, torch.float32)
    out = buf.new_zeros((num_rows, buf.shape[1]), dtype=acc)
    step = max(1, budget_elems // max(buf.shape[1], 1))
    for e0 in range(0, src.shape[0], step):
        g = full[src[e0:e0 + step].long()] * \
            w[e0:e0 + step, None].to(buf.dtype)
        out.index_add_(0, dst[e0:e0 + step].long(), g.to(acc))
    return out.to(buf.dtype)


def _pair_sum(buf, src, dst, num_rows, row_ptr, w, kernel):
    if w is not None:
        return _weighted_pair_sum(buf, src, dst, w, num_rows)
    from ..kernels.spmm import csr_spmm, csr_spmm_plain
    if kernel:
        return csr_spmm(buf, src, dst, num_rows, chunk=RING_MULTIPLE,
                        row_ptr=row_ptr)
    return csr_spmm_plain(buf, src, dst, num_rows)


def ring_aggregate(x: torch.Tensor, ring_src: torch.Tensor,
                   ring_dst: Optional[torch.Tensor], comm,
                   row_ptr: Optional[torch.Tensor] = None,
                   weights: Optional[torch.Tensor] = None,
                   kernel: bool = True, overlap: bool = True
                   ) -> torch.Tensor:
    """The neighbour sum of this rank's rows over every part, on a ring.

    x: ``[part_nodes, F]`` this rank's rows.  ring_src/ring_dst: int32
    ``[S, pair_edges]``, this rank's tables (S the world size of
    ``comm``, parallel/distributed.py ``Collectives``); ``ring_dst`` is
    None on the kernel routes, whose K3 reads row_ptr alone.  row_ptr:
    int64 ``[S, part_nodes + 1]`` (:func:`pair_row_ptr`), read by K3.
    Returns ``[part_nodes, F]``: at hop k the rank holds part ``(rank -
    k) mod S`` and adds that pair's sum, then the buffer moves to rank +
    1 and the previous rank's arrives (S hops, S - 1 transfers).

    The hop's sum: K3 (kernels/spmm.py ``csr_spmm``, the card's kernel
    for a tensor on the card, its plain version on the CPU) when
    ``kernel``, else K3's plain version; with ``weights`` (``[S,
    pair_edges]``, :func:`ring_weight_tables`) a weighted plain sum.
    The hops' sums are added in ``x.dtype`` in hop order.

    ``overlap`` starts each transfer before the hop's sum and waits for
    it after, two buffers live; ``overlap=False`` transfers after the
    sum.  The transfer never reads the output, so both give the same
    bits.  Differentiable by autograd (:class:`_RingHop` and the plain
    sums); the kernel routes take the symmetric trick instead
    (models/builder.py)."""
    S = ring_src.shape[0]
    if S != comm.world_size:
        raise ValueError(f"ring tables for {S} parts on a group of "
                         f"{comm.world_size} ranks")
    n = x.shape[0]
    me = comm.rank
    buf = x.contiguous()
    out = None
    for k in range(S):
        s = (me - k) % S
        last = k == S - 1
        pending = comm.ring_shift(buf, 1) if overlap and not last else None
        part = _pair_sum(buf, ring_src[s],
                         None if ring_dst is None else ring_dst[s], n,
                         None if row_ptr is None else row_ptr[s],
                         None if weights is None else weights[s], kernel)
        out = part if out is None else out.add_(part)
        del part
        if not last:
            if pending is None:
                pending = comm.ring_shift(buf, 1)
            buf = _RingHop.apply(buf, comm, pending)
    return out


def ring_part_tables(plan, rank: int, col: np.ndarray,
                     agree_max=None) -> Dict[str, object]:
    """Rank ``rank``'s ring tables from its own columns (``col``, global
    ids): ``src``, ``dst`` ``[S, pair_edges]``, ``row_ptr`` (:func:`
    pair_row_ptr`), ``real`` (each pair's real edge count), ``pair_edges``
    and ``padding_ratio``.  ``agree_max(v)`` returns the elementwise max
    of an int64 vector over the ranks (one collective): the ranks agree
    on the largest pair and the real total with it, and so on the JAX
    package's ``pair_edges`` and ``padding_ratio``; None is a world of
    one."""
    P = plan.num_parts
    pairs = build_ring_pairs(plan, rank, col)
    counts = np.array([pairs[s][1].shape[0] for s in range(P)],
                      dtype=np.int64)
    # slot r holds rank r's largest pair, slot P + r its real total
    mine = np.zeros(2 * P, dtype=np.int64)
    mine[rank] = max(int(counts.max()), 1) if P else 1
    mine[P + rank] = int(counts.sum())
    got = mine if agree_max is None else agree_max(mine)
    pair_edges = round_pair_edges(int(got[:P].max()))
    src, dst = pack_ring_part(pairs, P, pair_edges, plan.part_nodes)
    return dict(src=src, dst=dst,
                row_ptr=pair_row_ptr(pairs, P, plan.part_nodes),
                real=counts, pair_edges=pair_edges,
                padding_ratio=float(P * P * pair_edges
                                    / max(int(got[P:].sum()), 1)))

