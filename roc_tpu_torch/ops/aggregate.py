"""Plain neighbour sums and maxima (``roc_tpu/ops/aggregate.py``).  The
sums are the routes the hand-written kernels are held to:

- :func:`aggregate_ell`, the degree-bucketed ELL sum (route 'ell',
  kernel K4 in kernels/ell_spmm.py): per width bucket, gather
  ``feats[idx]`` and sum the width axis; then inverse-permute the
  concatenated bucket outputs back to row order.
- :func:`aggregate_segment`, the edge-list sum (route 'segment', kernel
  K3 in kernels/spmm.py): gather ``feats[src]`` and ``index_add_`` it
  into the destination rows.
- :func:`aggregate_blocked` and :func:`aggregate_scan` (routes 'blocked'
  and 'scan'), the JAX package's chunked edge-list sums.  There they are
  TPU tricks (a one-hot selection matmul, a cumsum difference); here
  each keeps its contract: dst-sorted edges padded to a ``chunk``
  multiple (another count raises, as the JAX assertion does), taken in
  runs of whole chunks under a budget, never the ``[E, F]`` gather.
  'blocked' adds every gathered row into its destination; 'scan' sums
  each chunk's rows by prefix-sum differences at the chunk's row ends
  and adds one partial a row a chunk (the JAX scan's carry records).
- :func:`aggregate_ell_sect` (route 'sectioned', and the residual of
  'bdense') and :func:`aggregate_flat_sum` (route 'flat_sum'), the
  large-graph layouts' sums over core/ell.py's sub-row tables: gather a
  run of chunks' sub-rows, sum their width, ``index_add_`` the partials
  into their rows.  No kernel; they are raced against K3 and K4.

The ELL and segment sums work in pieces of at most ``budget_elems``
gathered scalars (row segments of a bucket, chunks of edges), the
chunked edge-list sums and the layouts in runs of their chunks under
``LAYOUT_BUDGET_ELEMS``.  Without
them the transient is the whole gather: at Reddit scale (E ~ 112M,
F = 256) over 100 GB.

All sum in fp32: a reduced-precision input (bf16) is widened, summed in
fp32 and rounded once to its dtype, as the JAX package's ``aggregate_ell``
and the hand-written kernels do (a bf16 ``sum`` or ``index_add_`` would
round while it accumulates).  fp32 inputs are summed as they are.

The neighbour maxima (:func:`aggregate_ell_max`,
:func:`aggregate_segment_max`, :func:`aggregate_flat_max`; MIN is
``-max(-x)`` at the call site) are plain ops on every route: the
JAX package computes them with XLA ops outside any Pallas kernel.  The
ELL and flat maxima recompute each gathered segment in the backward
(``torch.utils.checkpoint``) instead of keeping it.  They
mask the padding/dummy sources to ``-inf`` and differentiate by autograd
with the JAX package's tie rule, the gradient split evenly among the
tied maxima (``amax`` and ``scatter_reduce('amax')`` do so; ``max(dim)``
would route it all to one index).  Rows with no real neighbour come out
``-inf`` here; the caller maps them to 0.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch.utils.checkpoint import checkpoint

# 2**24 scalars = 64 MiB of fp32 per gathered segment, the JAX
# package's default
DEFAULT_BUDGET_ELEMS = 1 << 24
# 2^27 gathered elements (512 MiB of fp32) per step of the chunked
# layouts, the chunked edge-list sums and the checkpointed maxima: a step
# takes as many consecutive chunks (rows) as fit, so a table of small
# chunks does not cost one round of launches, or of a checkpoint's
# recompute, per chunk.
LAYOUT_BUDGET_ELEMS = 1 << 27


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """The accumulator of a sum over ``dtype``: fp32 for bf16."""
    return torch.float32 if dtype == torch.bfloat16 else dtype


def ell_bucket_sum(feats: torch.Tensor, idx: torch.Tensor,
                   budget_elems: int = DEFAULT_BUDGET_ELEMS
                   ) -> torch.Tensor:
    """``feats[idx].sum(1)`` for one bucket ``idx [rows, width]``, in row
    segments of at most ``budget_elems`` gathered scalars; a bf16 sum is
    taken in fp32 and rounded once."""
    R, W = idx.shape
    F = feats.shape[1]
    acc = _acc_dtype(feats.dtype)

    def rowsum(i):
        return feats[i].sum(dim=1, dtype=acc).to(feats.dtype)

    seg_rows = max(1, budget_elems // max(W * F, 1))
    if seg_rows >= R:
        return rowsum(idx)
    out = torch.empty((R, F), dtype=feats.dtype, device=feats.device)
    for r0 in range(0, R, seg_rows):
        out[r0:r0 + seg_rows] = rowsum(idx[r0:r0 + seg_rows])
    return out


def aggregate_ell(feats: torch.Tensor, ell_idx: Sequence[torch.Tensor],
                  ell_row_pos: torch.Tensor, num_rows: int,
                  budget_elems: int = DEFAULT_BUDGET_ELEMS
                  ) -> torch.Tensor:
    """feats: [R+1, F] gathered features with a trailing zero row (the
    dummy id R points at it).  ell_idx: int32 ``[rows_b, width_b]`` per
    bucket.  ell_row_pos: int32 [num_rows] slot of each output row in
    the concatenated bucket outputs (zero slot == total bucket rows)."""
    F = feats.shape[1]
    outs = [ell_bucket_sum(feats, idx, budget_elems) for idx in ell_idx]
    outs.append(torch.zeros((1, F), dtype=feats.dtype, device=feats.device))
    cat = torch.cat(outs, dim=0)
    return cat.index_select(0, ell_row_pos)[:num_rows]


def aggregate_segment(feats: torch.Tensor, edge_src: torch.Tensor,
                      edge_dst: torch.Tensor, num_rows: int,
                      budget_elems: int = DEFAULT_BUDGET_ELEMS
                      ) -> torch.Tensor:
    """``out[d] = sum over edges (s, d) of feats[s]``.

    feats: [R(+1), F] (a trailing zero row for padding edges to read).
    edge_src/edge_dst: int [E], any order.  Returns [num_rows, F].
    Edges go in chunks of at most ``budget_elems // F`` gathered rows,
    each added into the output in place (differentiable by autograd);
    a bf16 input is added into an fp32 output, rounded once at the end."""
    F = feats.shape[1]
    acc = _acc_dtype(feats.dtype)
    out = feats.new_zeros((num_rows, F), dtype=acc)
    step = max(1, budget_elems // max(F, 1))
    for e0 in range(0, edge_src.shape[0], step):
        out.index_add_(0, edge_dst[e0:e0 + step].long(),
                       feats[edge_src[e0:e0 + step].long()].to(acc))
    return out.to(feats.dtype)


def rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx]`` for an index table ``idx [r, w]``, as ``index_select``:
    its backward is an ``index_add_`` (atomic adds on the card), where
    advanced indexing's backward sorts the ids and accumulates each
    repeated one serially (seconds a step at ogbn-arxiv's shape on the
    H100, where a source repeats ~28 times)."""
    return x.index_select(0, idx.reshape(-1)).reshape(*idx.shape,
                                                      *x.shape[1:])


def aggregate_ell_max(feats: torch.Tensor, ell_idx: Sequence[torch.Tensor],
                      ell_row_pos: torch.Tensor, num_rows: int,
                      budget_elems: int = LAYOUT_BUDGET_ELEMS
                      ) -> torch.Tensor:
    """ELL neighbour MAX, the JAX function's contract: ``feats [R+1, F]``
    with the dummy id ``R`` masked to ``-inf`` (not read as its zero
    row), per bucket a masked ``amax`` over the width axis in row
    segments of at most ``budget_elems`` gathered scalars (a row's whole
    neighbourhood stays in one segment, so ties split as in one max),
    then ``ell_row_pos`` back to row order; degree-0 rows read a
    trailing ``-inf`` slot.  Under autograd each segment is recomputed
    in the backward (``torch.utils.checkpoint``), so the backward keeps
    no gathered ``[rows, W, F]`` segment, with the same gradients; a
    segment is then transient, so the default budget is the layouts'
    (the segmentation changes no value: rows are never split)."""
    F = feats.shape[1]
    grad = torch.is_grad_enabled() and feats.requires_grad
    outs = []
    for idx in ell_idx:
        R, W = idx.shape
        seg_rows = max(1, budget_elems // max(W * F, 1))
        for r0 in range(0, R, seg_rows):
            seg = idx[r0:r0 + seg_rows]
            outs.append(checkpoint(_ell_max_segment, feats, seg,
                                   use_reentrant=False)
                        if grad else _ell_max_segment(feats, seg))
    outs.append(feats.new_full((1, F), float("-inf")))
    return torch.cat(outs, dim=0).index_select(0, ell_row_pos)[:num_rows]


def _ell_max_segment(feats: torch.Tensor, idx: torch.Tensor
                     ) -> torch.Tensor:
    """The masked maximum over the width of one row segment ``idx [r,
    W]`` of a bucket (the dummy id ``feats.shape[0] - 1`` masked to
    ``-inf``)."""
    g = rows(feats, idx)                               # [r, W, F]
    return torch.where((idx != feats.shape[0] - 1)[:, :, None], g,
                       torch.tensor(float("-inf"), dtype=feats.dtype,
                                    device=feats.device)).amax(dim=1)


def aggregate_segment_max(feats: torch.Tensor, edge_src: torch.Tensor,
                          edge_dst: torch.Tensor, num_rows: int
                          ) -> torch.Tensor:
    """Edge-list neighbour MAX (the JAX ``segment`` branch of
    ``_max_fwd``): gather ``feats[src]``, mask the dummy id ``R`` to
    ``-inf`` and scatter-max into a ``-inf`` output (an output holding 0
    would count as a tie of a zero maximum).  Like the JAX route it
    materialises the ``[E, F]`` gather in one piece: splitting it would
    change how a tie across two pieces shares the gradient."""
    F = feats.shape[1]
    dummy = feats.shape[0] - 1
    src = edge_src.long()
    g = torch.where((src != dummy)[:, None], feats.index_select(0, src),
                    torch.tensor(float("-inf"), dtype=feats.dtype,
                                 device=feats.device))
    out = feats.new_full((num_rows, F), float("-inf"))
    return out.scatter_reduce(0, edge_dst.long()[:, None].expand(-1, F), g,
                              "amax", include_self=False)




def _steps(n_chunks: int, chunk_elems: int, budget_elems: int):
    """``(c0, c1)`` chunk ranges of at most ``budget_elems`` gathered
    elements each (at least one chunk)."""
    step = max(1, budget_elems // max(chunk_elems, 1))
    return [(c0, min(c0 + step, n_chunks)) for c0 in range(0, n_chunks, step)]


def _ids(idx: torch.Tensor) -> torch.Tensor:
    """int32 ids of an int32 or uint16 table (uint16 widened through an
    int16 view, whose casts every backend has)."""
    if idx.dtype == torch.uint16:
        return idx.view(torch.int16).to(torch.int32) & 0xFFFF
    return idx.to(torch.int32)


def _sum_chunks(out: torch.Tensor, src: torch.Tensor, idx: torch.Tensor,
                dst: torch.Tensor, w: Optional[torch.Tensor],
                budget_elems: int) -> None:
    """``out[dst] += sum_j w * src[idx[:, j]]`` over the sub-rows of the
    tables ``idx [n_chunks, seg, W]`` / ``dst [n_chunks, seg]``, in
    ``out``'s dtype (fp32 for a bf16 ``src``: the products in ``src``'s
    dtype, as the JAX function multiplies, the sums in fp32)."""
    n, seg, W = idx.shape
    for c0, c1 in _steps(n, seg * W * src.shape[1], budget_elems):
        i = _ids(idx[c0:c1].reshape(-1, W))
        g = rows(src, i)
        if w is not None:
            g = g * w[c0:c1].reshape(-1, W, 1).to(src.dtype)
        out.index_add_(0, dst[c0:c1].reshape(-1).to(torch.int64),
                       g.sum(dim=1, dtype=out.dtype))


def aggregate_ell_sect(feats: torch.Tensor, sect_idx: Sequence[torch.Tensor],
                       sect_sub_dst: Sequence[torch.Tensor],
                       sect_meta: Sequence[Tuple[int, int]], num_rows: int,
                       sect_w: Optional[Sequence[torch.Tensor]] = None,
                       budget_elems: int = LAYOUT_BUDGET_ELEMS,
                       partial: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """The sectioned sum (core/ell.py SectionedEll): per section, the
    ``[start, start+size)`` rows of ``feats`` with a zero row appended
    (the section's dummy id), gathered sub-row by sub-row, the width
    summed and ``index_add_`` into the output rows.  ``sect_w``: the
    baked fused-normalization weights, per section shaped like its ids.
    ``partial``: ``[num_rows, F]`` sums (fp32 for bf16 ``feats``) the
    sections' are added to, as the block-dense route's dense tiles are.
    Sums in fp32 for bf16 ``feats``, rounded once."""
    F = feats.shape[1]
    out = feats.new_zeros((num_rows + 1, F), dtype=_acc_dtype(feats.dtype))
    if partial is not None:
        out[:num_rows] += partial
    zero = feats.new_zeros((1, F))
    for si, ((st, sz), tbl, sdst) in enumerate(zip(sect_meta, sect_idx,
                                                   sect_sub_dst)):
        xsec = torch.cat([feats[st:st + sz], zero], dim=0)
        _sum_chunks(out, xsec, tbl, sdst, sect_w[si] if sect_w else None,
                    budget_elems)
    return out[:num_rows].to(feats.dtype)


def aggregate_ell_sect_split(feats: torch.Tensor,
                             sect_idx: Sequence[torch.Tensor],
                             sect_sub_dst: Sequence[torch.Tensor],
                             sect_meta: Sequence[Tuple[int, int]],
                             num_rows: int,
                             budget_elems: int = LAYOUT_BUDGET_ELEMS
                             ) -> torch.Tensor:
    """:func:`aggregate_ell_sect` with the ``[N, W]`` block gather
    replaced by W ``[N]``-row gathers added as they go (one ``[N, F]``
    accumulator, no ``[N, W, F]`` transient)."""
    F = feats.shape[1]
    acc = _acc_dtype(feats.dtype)
    out = feats.new_zeros((num_rows + 1, F), dtype=acc)
    zero = feats.new_zeros((1, F))
    for (st, sz), tbl, sdst in zip(sect_meta, sect_idx, sect_sub_dst):
        xsec = torch.cat([feats[st:st + sz], zero], dim=0)
        n, seg, W = tbl.shape
        for c0, c1 in _steps(n, seg * F, budget_elems):
            i = _ids(tbl[c0:c1].reshape(-1, W))
            part = xsec.index_select(0, i[:, 0]).to(acc)
            for j in range(1, W):
                part = part + xsec.index_select(0, i[:, j]).to(acc)
            out.index_add_(0, sdst[c0:c1].reshape(-1).to(torch.int64), part)
    return out[:num_rows].to(feats.dtype)


def aggregate_flat_sum(feats: torch.Tensor, flat_idx: torch.Tensor,
                       flat_dst: torch.Tensor, num_rows: int,
                       flat_w: Optional[torch.Tensor] = None,
                       budget_elems: int = LAYOUT_BUDGET_ELEMS
                       ) -> torch.Tensor:
    """The flat sum: the sectioned sum of the one section spanning every
    source (core/ell.py ``flat_sum_from_graph``).  ``feats [G+1, F]``
    with a trailing zero row (the dummy id G); ``flat_idx [n_chunks,
    seg, 8]`` global ids, ``flat_dst [n_chunks, seg]`` ascending output
    rows (padding at ``num_rows``); ``flat_w`` the baked weights."""
    out = feats.new_zeros((num_rows + 1, feats.shape[1]),
                          dtype=_acc_dtype(feats.dtype))
    _sum_chunks(out, feats, flat_idx, flat_dst, flat_w, budget_elems)
    return out[:num_rows].to(feats.dtype)


def _flat_max_piece(feats: torch.Tensor, carry: Optional[torch.Tensor],
                    idx: torch.Tensor, dst: torch.Tensor, lo: int,
                    hi: int) -> torch.Tensor:
    """Rows ``lo..hi`` after the chunks ``idx [c, seg, W]``: row ``lo``
    starts from ``carry`` (its maximum over earlier chunks) when given,
    every other row from ``-inf``; each chunk is combined by its own
    scatter-max, as the JAX scan's steps are."""
    c, seg, W = idx.shape
    F = feats.shape[1]
    dummy = feats.shape[0] - 1
    i = idx.reshape(-1, W).to(torch.int32)
    g = torch.where((i != dummy)[:, :, None], rows(feats, i),
                    torch.tensor(float("-inf"), dtype=feats.dtype,
                                 device=feats.device))
    part = g.amax(dim=1)
    local = feats.new_full((hi - lo + 1, F), float("-inf"))
    if carry is not None:
        local = torch.cat([carry, local[1:]], dim=0)
    d = (dst.reshape(-1).to(torch.int64) - lo)[:, None].expand(-1, F)
    for k in range(c):
        s = slice(k * seg, (k + 1) * seg)
        local = local.scatter_reduce(0, d[s], part[s], "amax",
                                     include_self=True)
    return local


def aggregate_flat_max(feats: torch.Tensor, flat_idx: torch.Tensor,
                       flat_dst: torch.Tensor, num_rows: int,
                       budget_elems: int = LAYOUT_BUDGET_ELEMS
                       ) -> torch.Tensor:
    """Neighbour MAX over the flat layout (MIN as ``-max(-x)`` at the call
    site): per sub-row a masked ``amax`` over the width (the dummy id
    ``G`` masked to ``-inf``), combined per row by one scatter-max per
    chunk with the running maximum (``include_self``), so the gradient
    of a tie is shared as in the JAX scan: among the tied entries of a
    chunk and the running maximum.  Rows with no neighbour give
    ``-inf``.

    The output rows of a run of chunks are a contiguous range (the
    tables are sorted by row), so a run is computed as its own piece of
    the output, starting from the previous piece's last row where the
    row continues; under autograd each piece is recomputed in the
    backward (``torch.utils.checkpoint``), which keeps no gathered
    ``[rows, 8, F]`` block alive."""
    n, seg, W = flat_idx.shape
    F = feats.shape[1]
    firsts = flat_dst[:, 0].tolist()
    lasts = flat_dst[:, -1].tolist()
    grad = torch.is_grad_enabled() and feats.requires_grad
    pieces = []
    prev, prev_hi = None, -1
    for c0, c1 in _steps(n, seg * W * F, budget_elems):
        lo, hi = int(firsts[c0]), int(lasts[c1 - 1])
        carry = prev[-1:] if prev is not None and lo == prev_hi else None
        if prev is not None:
            pieces.append(prev[:-1] if carry is not None else prev)
        if carry is None and lo > prev_hi + 1:
            pieces.append(feats.new_full((lo - prev_hi - 1, F),
                                         float("-inf")))
        args = (feats, carry, flat_idx[c0:c1], flat_dst[c0:c1], lo, hi)
        prev = (checkpoint(_flat_max_piece, *args, use_reentrant=False)
                if grad else _flat_max_piece(*args))
        prev_hi = hi
    pieces.append(prev)
    if prev_hi < num_rows:
        pieces.append(feats.new_full((num_rows - prev_hi, F), float("-inf")))
    return torch.cat(pieces, dim=0)[:num_rows]


def _check_chunks(num_edges: int, chunk: int) -> int:
    """The chunk count of ``num_edges`` edges; raises unless they are a
    whole number of chunks (the JAX package asserts it)."""
    if chunk < 1 or num_edges % chunk:
        raise ValueError(f"pad edges to a chunk multiple: {num_edges} "
                         f"edges, chunk {chunk}")
    return num_edges // chunk


def aggregate_blocked(feats: torch.Tensor, edge_src: torch.Tensor,
                      edge_dst: torch.Tensor, num_rows: int,
                      chunk: int = 512,
                      budget_elems: int = LAYOUT_BUDGET_ELEMS
                      ) -> torch.Tensor:
    """The JAX package's ``aggregate_blocked`` contract: ``out[d] = sum of
    feats[s]`` over the edges ``(s, d)``, sorted by destination and
    padded to a ``chunk`` multiple (padding edges read the zero row
    ``feats[-1]``).  Runs of whole chunks of at most ``budget_elems``
    gathered scalars are gathered and ``index_add_`` into the output;
    a bf16 input is summed in fp32 and rounded once."""
    n = _check_chunks(edge_src.shape[0], chunk)
    acc = _acc_dtype(feats.dtype)
    out = feats.new_zeros((num_rows, feats.shape[1]), dtype=acc)
    for c0, c1 in _steps(n, chunk * feats.shape[1], budget_elems):
        e0, e1 = c0 * chunk, c1 * chunk
        out.index_add_(0, edge_dst[e0:e1].long(),
                       rows(feats, edge_src[e0:e1]).to(acc))
    return out.to(feats.dtype)


def aggregate_scan(feats: torch.Tensor, edge_src: torch.Tensor,
                   edge_dst: torch.Tensor, num_rows: int,
                   chunk: int = 1024,
                   budget_elems: int = LAYOUT_BUDGET_ELEMS) -> torch.Tensor:
    """The JAX package's ``aggregate_scan`` contract (as
    :func:`aggregate_blocked`'s): within each chunk of dst-sorted edges
    the row sums are differences of the chunk's prefix sum (fp32) at the
    row ends, and each chunk adds one partial a row into the output, so
    a row that spans chunks is summed from their partials, as the JAX
    scan's carry records are.  The row ends are found once for the whole
    edge list; runs of whole chunks of at most ``budget_elems`` gathered
    scalars go at a time.  A bf16 input is rounded once."""
    n = _check_chunks(edge_src.shape[0], chunk)
    F = feats.shape[1]
    acc = _acc_dtype(feats.dtype)
    out = feats.new_zeros((num_rows, F), dtype=acc)
    dst = edge_dst.reshape(n, chunk)
    # a row ends at its chunk's last edge or where the next edge's row
    # differs; the first end of each chunk subtracts nothing
    is_end = torch.ones_like(dst, dtype=torch.bool)
    is_end[:, :-1] = dst[:, 1:] != dst[:, :-1]
    ends = torch.nonzero(is_end.view(-1)).squeeze(1)
    first = torch.ones_like(ends, dtype=torch.bool)
    first[1:] = ends[1:] // chunk != ends[:-1] // chunk
    end_rows = edge_dst.index_select(0, ends).long()
    offsets = [0] + torch.cumsum(is_end.sum(dim=1), 0).tolist()
    zero = torch.zeros((), dtype=acc, device=feats.device)
    for c0, c1 in _steps(n, chunk * F, budget_elems):
        e0, e1 = c0 * chunk, c1 * chunk
        k0, k1 = offsets[c0], offsets[c1]
        g = rows(feats, edge_src[e0:e1]).to(acc)
        prefix = g.view(c1 - c0, chunk, F).cumsum(dim=1).view(-1, F)
        at_end = prefix.index_select(0, ends[k0:k1] - e0)
        before = torch.where(first[k0:k1, None], zero,
                             at_end.roll(1, dims=0))
        out.index_add_(0, end_rows[k0:k1], at_end - before)
    return out.to(feats.dtype)


IMPLS = ("segment", "blocked", "scan", "cuda_csr")


def aggregate(feats: torch.Tensor, edge_src: torch.Tensor,
              edge_dst: torch.Tensor, num_rows: int,
              impl: str = "segment", chunk: int = 512) -> torch.Tensor:
    """The edge-list dispatcher (``roc_tpu/ops/aggregate.py aggregate``)
    over the ported impls: 'segment', 'blocked', 'scan' (plain) or
    'cuda_csr' (kernel K3, the JAX package's 'pallas_csr').  ``feats``
    is ``[R+1, F]`` with a trailing zero row, as there; edges are sorted
    by destination and padded to a ``chunk`` multiple for every impl
    but 'segment'.  The sums agree to fp32 rounding (another summation
    order)."""
    if impl == "segment":
        return aggregate_segment(feats, edge_src, edge_dst, num_rows)
    if impl == "blocked":
        return aggregate_blocked(feats, edge_src, edge_dst, num_rows,
                                 chunk=chunk)
    if impl == "scan":
        return aggregate_scan(feats, edge_src, edge_dst, num_rows,
                              chunk=chunk)
    if impl == "cuda_csr":
        from ..kernels.spmm import csr_spmm
        # K3 skips the dummy id instead of reading the zero row
        return csr_spmm(feats[:-1], edge_src, edge_dst, num_rows,
                        chunk=chunk)
    raise ValueError(f"aggregate impl {impl!r} is not ported; expected "
                     f"one of {IMPLS}")


def aggregate_mean(feats: torch.Tensor, edge_src: torch.Tensor,
                   edge_dst: torch.Tensor, num_rows: int,
                   in_degree: torch.Tensor, impl: str = "segment",
                   chunk: int = 512) -> torch.Tensor:
    """The mean aggregator (the reference's AGGR_AVG, ``gnn.h:75-80``):
    the :func:`aggregate` sum over the real in-degree, ``max(deg, 1)``
    cast to the sum's dtype, as the JAX package divides."""
    s = aggregate(feats, edge_src, edge_dst, num_rows, impl=impl,
                  chunk=chunk)
    deg = in_degree.to(s.dtype).clamp_min(1.0)
    return s / deg[:, None]
