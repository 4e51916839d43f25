"""The host-built aggregation layouts: the degree-bucketed ELLPACK
tables, the source-sectioned and flat sub-row tables, and the 'auto'
route rule.

A numpy copy of ``roc_tpu/core/ell.py``; the tables are bit-equal to
the JAX package's for the same graph (tests/test_torch_data.py,
tests/test_torch_layouts.py, tests/test_torch_layouts_parts.py).  The
sectioned builder and the ELL bucket widths run in the native library
(roc_tpu_torch/native) when it is built.  The partitioned builders take
every part or, on a rank of a partitioned run, its own part with an
``agree_max`` collective that gives it the shapes the all-parts build
would.

- every row is assigned to a power-of-two **width bucket** covering its
  in-degree (min width 8; a hub row of any degree gets its own wide
  bucket);
- each bucket stores a dense ``[rows, width]`` matrix of source ids;
  padding entries hold the dummy id (== the gathered row count);
- ``row_pos`` maps every output row to its slot in the concatenated
  bucket outputs (degree-0 rows point at the trailing zero slot), and
  ``row_id`` is the forward map from each bucket row to its output row
  (padding bucket rows carry ``part_nodes``).  The plain sum
  (ops/aggregate.py) reads ``row_pos``; the CUDA kernel
  (kernels/ell_spmm.py) writes each bucket row straight to its
  ``row_id``.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Dict, Optional, Sequence, Tuple

import numpy as np


@dataclass
class EllTable:
    """Stacked per-partition ELL tables with uniform shapes.

    widths: bucket widths (powers of two, ascending).
    idx: one int32 ``[P, rows_b, width_b]`` array per bucket.
    row_pos: int32 ``[P, part_nodes]`` slot of each row in the
      concatenated bucket output (zero slot == total bucket rows).
    row_id: one int32 ``[P, rows_b]`` array per bucket, the output row
      of each bucket row (padding == ``part_nodes``).
    """

    widths: Tuple[int, ...]
    idx: Tuple[np.ndarray, ...]
    row_pos: np.ndarray
    row_id: Tuple[np.ndarray, ...] = ()

    @property
    def num_parts(self) -> int:
        return self.row_pos.shape[0]


def row_widths(deg: np.ndarray, min_width: int) -> np.ndarray:
    """Per-row bucket width: the smallest power of two >= degree
    (floored at ``min_width``); 0 for empty rows.  Exact integer
    comparisons against a power table, no float log2."""
    deg = np.asarray(deg)
    max_d = int(deg.max()) if deg.size else 1
    powers = [min_width]
    while powers[-1] < max_d:
        powers.append(powers[-1] * 2)
    powers = np.array(powers, dtype=np.int64)
    w = powers[np.searchsorted(powers, deg, side="left")]
    return np.where(deg > 0, w, 0).astype(np.int64)


def build_ell(local_row_ptr: np.ndarray, col_idx: np.ndarray,
              min_width: int = 8) -> dict:
    """One partition's buckets from a local CSR: ``{width: (rows,
    idx)}`` with int64 row ids and int32 ``[R_w, w]`` source ids (-1
    padding, replaced by the dummy id in :func:`stack_ell`)."""
    from .. import native
    row_ptr = np.asarray(local_row_ptr, dtype=np.int64)
    deg = np.diff(row_ptr)
    # the widths natively when the library is built (the same values)
    widths = (native.ell_widths(row_ptr, min_width).astype(np.int64)
              if native.available() else row_widths(deg, min_width))
    buckets: dict = {}
    for w in np.unique(widths[widths > 0]):
        w = int(w)
        rows = np.flatnonzero(widths == w)
        grid = np.arange(w, dtype=np.int64)[None, :]
        valid = grid < deg[rows][:, None]
        flat = row_ptr[rows][:, None] + grid
        idx = np.full((rows.shape[0], w), -1, dtype=np.int32)
        idx[valid] = col_idx[flat[valid]]
        buckets[w] = (rows, idx)
    return buckets


def _place_part(buckets: dict, widths: Tuple[int, ...],
                rows_per_width: dict, part_nodes: int,
                dummy: int) -> Tuple[list, np.ndarray, list]:
    """One partition's buckets placed into the uniform shapes:
    ``(idx_arrays, row_pos, row_id_arrays)``."""
    idx_arrays = []
    rid_arrays = []
    total_rows = sum(rows_per_width[w] for w in widths)
    row_pos = np.full(part_nodes, total_rows, dtype=np.int32)
    offset = 0
    for w in widths:
        R = rows_per_width[w]
        arr = np.full((R, w), dummy, dtype=np.int32)
        rid = np.full(R, part_nodes, dtype=np.int32)
        if w in buckets:
            rows, idx = buckets[w]
            n = rows.shape[0]
            arr[:n] = np.where(idx >= 0, idx, dummy)
            rid[:n] = rows
            row_pos[rows] = offset + np.arange(n, dtype=np.int32)
        idx_arrays.append(arr)
        rid_arrays.append(rid)
        offset += R
    return idx_arrays, row_pos, rid_arrays


def stack_ell(per_part_buckets: Sequence[dict], part_nodes: int,
              dummy: int) -> EllTable:
    """Unify the bucket structure across partitions and stack it into
    equal-shape arrays (at least one bucket, so shapes always exist)."""
    P = len(per_part_buckets)
    widths = sorted({w for b in per_part_buckets for w in b})
    rows_per_width = {
        w: max((b[w][0].shape[0] if w in b else 0
                for b in per_part_buckets), default=0)
        for w in widths}
    widths = tuple(w for w in widths if rows_per_width[w] > 0) or (8,)
    rows_per_width = {w: max(rows_per_width.get(w, 0), 1) for w in widths}
    per_part = [_place_part(b, widths, rows_per_width, part_nodes, dummy)
                for b in per_part_buckets]
    idx_arrays = tuple(np.stack([per_part[p][0][wi] for p in range(P)])
                       for wi in range(len(widths)))
    row_pos = np.stack([per_part[p][1] for p in range(P)])
    row_id = tuple(np.stack([per_part[p][2][wi] for p in range(P)])
                   for wi in range(len(widths)))
    return EllTable(widths=widths, idx=idx_arrays, row_pos=row_pos,
                    row_id=row_id)


def ell_from_padded_parts(part_row_ptr: np.ndarray,
                          part_col_idx: np.ndarray,
                          real_nodes: np.ndarray,
                          part_nodes: int, dummy: int,
                          min_width: int = 8) -> EllTable:
    """EllTable of a partitioned graph's local CSRs (core/partition.py),
    column ids already in gathered-row coordinates; padding rows and
    edges are left out by cutting each local CSR at its real row count.
    ``row_id`` is per part, ``[P, rows_b]``: a rank takes its own row."""
    per_part = []
    for p in range(part_row_ptr.shape[0]):
        n = int(real_nodes[p])
        ptr = part_row_ptr[p, :n + 1].astype(np.int64)
        per_part.append(build_ell(ptr, part_col_idx[p],
                                  min_width=min_width))
    return stack_ell(per_part, part_nodes, dummy)


def ell_from_graph(row_ptr: np.ndarray, col_idx: np.ndarray,
                   num_nodes: int, min_width: int = 8) -> EllTable:
    """Single-device EllTable (P == 1); dummy == ``num_nodes``."""
    b = build_ell(np.asarray(row_ptr), np.asarray(col_idx),
                  min_width=min_width)
    return stack_ell([b], num_nodes, dummy=num_nodes)


# ---------------------------------------------------------------------------
# The sectioned and flat layouts (``roc_tpu/core/ell.py`` SectionedEll)
# ---------------------------------------------------------------------------


@dataclass
class SectionedEll:
    """Source-sectioned width-``sub_w`` sub-row tables.  The source ids
    are split into sections of at most ``section_rows`` rows; every
    output row's neighbours in a section are laid out as consecutive
    sub-rows of ``sub_w`` ids (padded with the section's dummy id, its
    size), each sub-row tagged with its output row.  Per section:

    - ``idx[s]``: ``[n_chunks, seg_rows, sub_w]`` section-local source
      ids (int32, or uint16 after :meth:`with_idx_dtype`);
    - ``sub_dst[s]``: int32 ``[n_chunks, seg_rows]`` the output row of
      each sub-row, ascending; chunk padding points at ``num_rows``.

    The flat layout (:func:`flat_sum_from_graph`) is the same tables
    with one section spanning every source, so its ids are global.
    ops/aggregate.py ``aggregate_ell_sect`` and ``aggregate_flat_sum``
    sum them: gather, reduce the width, ``index_add_`` into the rows."""

    num_rows: int
    src_rows: int
    section_rows: int
    seg_rows: int
    sec_starts: Tuple[int, ...]
    sec_sizes: Tuple[int, ...]
    idx: Tuple[np.ndarray, ...]
    sub_dst: Tuple[np.ndarray, ...]
    sub_w: int = 8

    @property
    def meta(self) -> Tuple[Tuple[int, int], ...]:
        """``(start, size)`` of each section."""
        return tuple(zip(self.sec_starts, self.sec_sizes))

    def weight_tables(self, d_dst: np.ndarray,
                      d_src: np.ndarray) -> Tuple[np.ndarray, ...]:
        """Baked fused-normalization weights, one fp32 array per section
        shaped like ``idx``: ``w = d_dst[sub_dst] * d_src[start + idx]``
        (the entries of ``D^-1/2 A D^-1/2``).  Chunk-padding sub-rows and
        dummy ids weigh 0.  ``d_dst`` may be stacked ``[P, num_rows]``."""
        d_dst = np.asarray(d_dst, dtype=np.float32)
        d_src = np.asarray(d_src, dtype=np.float32)
        stacked = d_dst.ndim == 2
        zpad = (np.zeros((d_dst.shape[0], 1), np.float32) if stacked
                else np.zeros(1, np.float32))
        dd = np.concatenate([d_dst, zpad], axis=-1)
        out = []
        for st, sz, idx, sdst in zip(self.sec_starts, self.sec_sizes,
                                     self.idx, self.sub_dst):
            ds = np.concatenate([d_src[st:st + sz], np.zeros(1, np.float32)])
            if stacked:
                wd = dd[np.arange(d_dst.shape[0])[:, None, None], sdst]
            else:
                wd = dd[sdst]
            out.append((wd[..., None]
                        * ds[idx.astype(np.int64)]).astype(np.float32))
        return tuple(out)

    def with_idx_dtype(self, dtype) -> "SectionedEll":
        """The same tables with the ids narrowed to ``dtype`` (uint16
        halves the index bytes); raises when a section's dummy id (its
        size) does not fit."""
        info = np.iinfo(dtype)
        hi = max(self.sec_sizes)
        if hi > info.max:
            raise ValueError(
                f"section dummy id {hi} does not fit {np.dtype(dtype)} "
                f"(max {info.max}); build with section_rows <= {info.max}")
        return replace(self, idx=tuple(a.astype(dtype) for a in self.idx))


# Chunk granularity of the flat layout's one section: bounds a chunk's
# gathered [seg, 8, F] transient at 64 MiB for F = 256 fp32.
FLAT_SEG_ROWS = 8192

# Edge count past which the JAX package's 'auto' rule takes the flat
# layout outside the sectioned window (its compile-size rule; the same
# threshold as the attention path's ATTN_FLAT8_MIN_EDGES).
FLAT_SUM_MIN_EDGES = 20_000_000

# The JAX package's sectioned window: its lower bound is the gathered
# source-table size (num_nodes), its upper bound the output rows.
SECTION_ROWS_DEFAULT = 65_536
SECTIONED_MAX_ROWS = 600_000


def default_section_rows(sect_u16: bool = False) -> int:
    """Default section size; uint16 ids need the dummy id (the section
    size) to fit, so 65,535 then."""
    return min(SECTION_ROWS_DEFAULT, 65_535) if sect_u16 \
        else SECTION_ROWS_DEFAULT


def flat_sum_from_graph(row_ptr: np.ndarray, col_idx: np.ndarray,
                        num_rows: int, src_rows: Optional[int] = None,
                        seg_rows: int = FLAT_SEG_ROWS) -> SectionedEll:
    """The flat layout: a :class:`SectionedEll` with one section over all
    ``src_rows`` sources (global ids, dummy == ``src_rows``).  The
    'flat_sum' sum and max and the 'attn_flat8' attention read it."""
    if src_rows is None:
        src_rows = num_rows
    return sectioned_from_graph(row_ptr, col_idx, num_rows,
                                src_rows=src_rows, section_rows=src_rows,
                                seg_rows=seg_rows)


def section_sub_counts(row_ptr: np.ndarray, col_idx: np.ndarray,
                       num_rows: int, src_rows: int,
                       section_rows: int = SECTION_ROWS_DEFAULT,
                       sub_w: int = 8) -> np.ndarray:
    """Per-section sub-row totals (native when the host planners are
    built, numpy bincounts otherwise)."""
    from .. import native
    row_ptr = np.asarray(row_ptr)
    col_idx = np.asarray(col_idx)
    n_sec = max(1, -(-src_rows // section_rows))
    if native.available():
        return native.sectioned_counts(row_ptr, col_idx, num_rows,
                                       section_rows, n_sec, sub_w)
    dst_all = np.repeat(np.arange(num_rows, dtype=np.int64),
                        np.diff(row_ptr))
    sec_of = col_idx.astype(np.int64) // section_rows
    out = np.zeros(n_sec, dtype=np.int64)
    for s in range(n_sec):
        cnt = np.bincount(dst_all[sec_of == s], minlength=num_rows)
        out[s] = int((-(-cnt // sub_w)).sum())
    return out


def _resolve_chunks(counts, seg_rows: int, chunks_plan,
                    first_section: int = 0) -> list:
    """Per-section chunk counts from sub-row totals, held to a uniform
    plan when one is given (a section needing more chunks raises)."""
    out = []
    for i, c in enumerate(counts):
        s = first_section + i
        n = max(1, -(-int(c) // seg_rows))
        if chunks_plan is not None:
            if n > chunks_plan[s]:
                raise ValueError(
                    f"section {s}: needs {n} chunks > planned "
                    f"{chunks_plan[s]} — the plan must come from "
                    f"section_sub_counts over the same edges")
            n = int(chunks_plan[s])
        out.append(n)
    return out


def sectioned_from_graph(row_ptr: np.ndarray, col_idx: np.ndarray,
                         num_rows: int, src_rows: Optional[int] = None,
                         section_rows: int = SECTION_ROWS_DEFAULT,
                         seg_rows: int = 131_072,
                         chunks_plan=None, counts=None,
                         sub_w: int = 8) -> SectionedEll:
    """The sectioned layout of a dst-major CSR, bit-equal to the JAX
    package's.  ``src_rows`` is the source-id space (default
    ``num_rows``); ``chunks_plan`` forces per-section chunk counts;
    ``counts`` reuses a counts pass.  The native two-pass builder
    (counts, then fill) runs when the host planners are built, the numpy
    path otherwise; they give the same tables."""
    row_ptr = np.asarray(row_ptr)
    col_idx = np.asarray(col_idx)
    if src_rows is None:
        src_rows = num_rows
    n_sec = max(1, -(-src_rows // section_rows))
    all_sizes = [min(section_rows, src_rows - s * section_rows)
                 for s in range(n_sec)]
    starts = tuple(s * section_rows for s in range(n_sec))
    from .. import native
    if native.available():
        if counts is None:
            counts = native.sectioned_counts(row_ptr, col_idx, num_rows,
                                             section_rows, n_sec, sub_w)
        chunks = _resolve_chunks(counts, seg_rows, chunks_plan)
        slots = np.asarray([n * seg_rows for n in chunks], dtype=np.int64)
        idx_flat, sub_flat = native.sectioned_fill(
            row_ptr, col_idx, num_rows, section_rows,
            np.asarray(all_sizes, dtype=np.int64), slots, sub_w)
        idxs, dsts, off = [], [], 0
        for s in range(n_sec):
            n = int(slots[s])
            idxs.append(idx_flat[off:off + n].reshape(chunks[s], seg_rows,
                                                      sub_w))
            dsts.append(sub_flat[off:off + n].reshape(chunks[s], seg_rows))
            off += n
        return SectionedEll(
            num_rows=num_rows, src_rows=src_rows, section_rows=section_rows,
            seg_rows=seg_rows, sec_starts=starts, sec_sizes=tuple(all_sizes),
            idx=tuple(idxs), sub_dst=tuple(dsts), sub_w=sub_w)
    dst_all = np.repeat(np.arange(num_rows, dtype=np.int64),
                        np.diff(row_ptr))
    src_all = col_idx.astype(np.int64)
    sec_of = (src_all // section_rows).astype(np.int8 if n_sec < 128
                                              else np.int32)
    idxs, dsts = [], []
    for s in range(n_sec):
        sel = sec_of == s
        srcs = (src_all[sel] - s * section_rows).astype(np.int32)
        dst = dst_all[sel]
        cnt = np.bincount(dst, minlength=num_rows)
        padded = -(-cnt // sub_w) * sub_w
        nz = np.flatnonzero(padded)
        sub_rows = padded[nz] // sub_w
        total_sub = int(sub_rows.sum())
        n_chunks = _resolve_chunks([total_sub], seg_rows, chunks_plan,
                                   first_section=s)[0]
        pad = n_chunks * seg_rows - total_sub
        tbl = np.full((n_chunks * seg_rows, sub_w), all_sizes[s],
                      dtype=np.int32)
        start_sub = np.zeros(len(nz) + 1, dtype=np.int64)
        np.cumsum(sub_rows, out=start_sub[1:])
        grp_start = np.zeros(num_rows + 1, dtype=np.int64)
        np.cumsum(cnt, out=grp_start[1:])
        off = np.arange(dst.shape[0], dtype=np.int64) - grp_start[dst]
        act_of = np.zeros(num_rows, dtype=np.int64)
        act_of[nz] = np.arange(len(nz))
        tbl.reshape(-1)[start_sub[act_of[dst]] * sub_w + off] = srcs
        sub_dst = np.concatenate(
            [np.repeat(nz, sub_rows),
             np.full(pad, num_rows, np.int64)]).astype(np.int32)
        idxs.append(tbl.reshape(n_chunks, seg_rows, sub_w))
        dsts.append(sub_dst.reshape(n_chunks, seg_rows))
    return SectionedEll(
        num_rows=num_rows, src_rows=src_rows, section_rows=section_rows,
        seg_rows=seg_rows, sec_starts=starts, sec_sizes=tuple(all_sizes),
        idx=tuple(idxs), sub_dst=tuple(dsts), sub_w=sub_w)


def sectioned_plan(counts_max: np.ndarray,
                   seg_rows: int = 131_072) -> Tuple[int, list]:
    """``(seg_rows, per-section chunk counts)`` from elementwise-maxed
    per-part sub-row counts: the uniform shapes partitioned tables
    agree on."""
    max_sub = int(np.max(counts_max)) if np.size(counts_max) else 1
    seg = max(8, min(seg_rows, -(-max_sub // 8) * 8))
    plan = [max(1, -(-int(c) // seg)) for c in np.asarray(counts_max)]
    return seg, plan


def clean_part_ptr(part_row_ptr: np.ndarray, real_nodes: int,
                   part_nodes: int) -> np.ndarray:
    """One part's row pointers with the padding edges dropped: rows past
    ``real_nodes`` are empty instead of carrying the padded edge tail."""
    n = int(real_nodes)
    ptr = part_row_ptr[:n + 1].astype(np.int64)
    return np.concatenate(
        [ptr, np.full(part_nodes - n, ptr[n], dtype=np.int64)])


def sectioned_from_padded_parts(part_row_ptr: np.ndarray,
                                part_col: np.ndarray,
                                real_nodes: np.ndarray,
                                part_nodes: int, src_rows: int,
                                section_rows: int = SECTION_ROWS_DEFAULT,
                                seg_rows: int = 131_072,
                                sub_w: int = 8,
                                agree_max=None) -> SectionedEll:
    """Stacked per-part sectioned tables with one shape: ``idx[s]``
    ``[P, n_chunks_s, seg_rows, sub_w]``, ``sub_dst[s]`` ``[P, n_chunks_s,
    seg_rows]``.  The chunk counts and ``seg_rows`` come from the
    elementwise max of every part's per-section sub-row counts
    (:func:`sectioned_plan`), so a part with fewer edges carries padding
    chunks.  ``part_col`` is ``[P, part_edges]`` in gathered coordinates;
    the padding edges are cut by the real row extents.

    ``agree_max(v)`` (an elementwise max over the ranks of a partitioned
    run) lets a rank pass its own part alone (P = 1 here) and get its row
    of the all-parts tables."""
    P = part_row_ptr.shape[0]
    ptrs = [clean_part_ptr(part_row_ptr[p], real_nodes[p], part_nodes)
            for p in range(P)]
    cols = [np.asarray(part_col[p][:int(ptrs[p][-1])]) for p in range(P)]
    counts = np.stack([
        section_sub_counts(ptrs[p], cols[p], part_nodes, src_rows,
                           section_rows, sub_w) for p in range(P)])
    counts_max = counts.max(axis=0)
    if agree_max is not None:
        counts_max = agree_max(counts_max)
    seg_rows, plan = sectioned_plan(counts_max, seg_rows)
    per_part = [
        sectioned_from_graph(ptrs[p], cols[p], part_nodes,
                             src_rows=src_rows, section_rows=section_rows,
                             seg_rows=seg_rows, chunks_plan=plan,
                             counts=counts[p], sub_w=sub_w)
        for p in range(P)]
    first = per_part[0]
    return SectionedEll(
        num_rows=part_nodes, src_rows=src_rows, section_rows=section_rows,
        seg_rows=seg_rows, sec_starts=first.sec_starts,
        sec_sizes=first.sec_sizes,
        idx=tuple(np.stack([pp.idx[s] for pp in per_part])
                  for s in range(len(first.idx))),
        sub_dst=tuple(np.stack([pp.sub_dst[s] for pp in per_part])
                      for s in range(len(first.sub_dst))),
        sub_w=sub_w)


def flat_sum_from_padded_parts(part_row_ptr: np.ndarray,
                               part_col: np.ndarray,
                               real_nodes: np.ndarray,
                               part_nodes: int, src_rows: int,
                               seg_rows: int = FLAT_SEG_ROWS,
                               agree_max=None) -> SectionedEll:
    """Stacked per-part flat tables (one section over the ``src_rows``
    gathered rows), the partitioned :func:`flat_sum_from_graph`."""
    return sectioned_from_padded_parts(
        part_row_ptr, part_col, real_nodes, part_nodes, src_rows=src_rows,
        section_rows=src_rows, seg_rows=seg_rows, agree_max=agree_max)


# ---------------------------------------------------------------------------
# The 'auto' rule
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class CardRow:
    """What the port runs on a card where the JAX rule names a layout:
    ``routes`` maps each of the JAX rule's answers for a model of sums
    ('sectioned', 'flat_sum', 'bdense', 'ell') to the port's route that
    the races on that card put first; ``source`` says which races, on
    which card.  ``attention`` and ``attention_source`` do the same for
    the JAX rule's answers for an attention model ('attn_flat8', 'ell')."""
    routes: Dict[str, str]
    source: str
    attention: Dict[str, str] = field(default_factory=dict)
    attention_source: str = ""


# JAX's 'ell' is the port's kernel route 'cuda' (K4 is the port's ELL
# sum, as 'pallas' is the JAX package's).
JAX_ROUTE = {"ell": "cuda"}

# One row per card kind (torch.cuda.get_device_name) with races; every
# other kind, the CPU included, takes the JAX rule's answer.
CARD_ROWS: Dict[str, CardRow] = {
    "NVIDIA H100 80GB HBM3": CardRow(
        routes={"sectioned": "cuda", "flat_sum": "cuda", "bdense": "cuda"},
        source="chip_smoke.py phase 14 races on an NVIDIA H100 80GB HBM3 "
               "at a 700.00 W limit: at Reddit's shape (E = 111,689,429) "
               "the forward sum at F = 256 fp32 took 145.3 ms on "
               "'sectioned', 146.6 on 'flat_sum', 14.6 on K4 (bf16: 128.1, "
               "124.7, 7.5; F = 41: 7-8x K4); on planted communities "
               "(E = 23 M, 81 % on dense tiles) 'bdense' took 84.1-139.3 ms "
               "fp32 and 48.7-99.9 bf16 against K4's 5.6 and 3.3",
        attention={"attn_flat8": "cuda"},
        attention_source="chip_smoke.py --attention-race on an NVIDIA H100 "
                         "80GB HBM3 at a 700.00 W limit: GAT 100-256-47 "
                         "(1 head) at ogbn-products' shape (E = 127,348,145), "
                         "3 steps, a steady step in 'mixed' took 2467.7 ms on "
                         "'cuda', 2564.1 on 'ell', 3068.2 on 'attn_flat8'; "
                         "in fp32 2934.7, 2798.2, 2696.5 (a tie: 'cuda' and "
                         "'ell' run the same ops 4.9 % apart); peak 9.8 GB "
                         "against 35.6 ('mixed'), 16.8 against 41.2 (fp32)"),
}


def jax_auto_impl(num_nodes: int, out_rows: Optional[int] = None,
                  num_edges: Optional[int] = None) -> str:
    """The JAX package's ``resolve_auto_impl`` on a device with no
    calibrated row (its defaults): 'sectioned' inside the window, else
    'flat_sum' from :data:`FLAT_SUM_MIN_EDGES` edges (when ``num_edges``
    is given), else 'ell'."""
    if out_rows is None:
        out_rows = num_nodes
    if num_nodes > SECTION_ROWS_DEFAULT and out_rows <= SECTIONED_MAX_ROWS:
        return "sectioned"
    if num_edges is not None and num_edges >= FLAT_SUM_MIN_EDGES:
        return "flat_sum"
    return "ell"


def port_route(jax_choice: str, device_kind: Optional[str] = None) -> str:
    """The port's route for the JAX rule's answer ``jax_choice`` on a card
    of ``device_kind``: its row's route where it has one, else the same
    layout ('ell' as 'cuda')."""
    row = CARD_ROWS.get(device_kind) if device_kind else None
    if row is not None and jax_choice in row.routes:
        return row.routes[jax_choice]
    return JAX_ROUTE.get(jax_choice, jax_choice)


def port_attention_route(jax_choice: str,
                         device_kind: Optional[str] = None) -> str:
    """The port's route for an attention model where the JAX rule answers
    ``jax_choice`` ('attn_flat8' or 'ell') on a card of ``device_kind``:
    its row's attention entry where it has one, else the same layout
    ('ell' as 'cuda')."""
    row = CARD_ROWS.get(device_kind) if device_kind else None
    if row is not None and jax_choice in row.attention:
        return row.attention[jax_choice]
    return JAX_ROUTE.get(jax_choice, jax_choice)


def resolve_auto_impl(num_nodes: int, out_rows: Optional[int] = None,
                      device_kind: Optional[str] = None,
                      num_edges: Optional[int] = None) -> str:
    """``aggr_impl='auto'`` without the block-dense probe: the JAX rule
    (:func:`jax_auto_impl`) through the card's row (:func:`port_route`).
    train/trainer.py ``resolve_auto_impl_probed`` adds the probe."""
    return port_route(jax_auto_impl(num_nodes, out_rows, num_edges),
                      device_kind)
