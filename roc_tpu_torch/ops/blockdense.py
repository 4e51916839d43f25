"""Block-dense aggregation (``roc_tpu/ops/blockdense.py``): the adjacency
tiled over the vertex ids into ``[128, 128]`` blocks, every block with at
least ``min_fill`` edges summed as one small dense product

    out[dst_tile] += A_tile @ x[src_tile]        (A_tile: [128, 128])

and the scattered residual edges left to the sectioned sum
(models/builder.py, route 'bdense').  It pays where the vertex order packs
edges into tiles (community graphs after core/reorder.py ``lpa_order``);
:func:`plan_blocks` builds the plan on the host and
``BlockPlan.occupancy`` reports the numbers that decide it.

The planner is a copy of the JAX package's, bit-equal: the native census
and fill (roc_tpu_torch/native) when the host planners are built, the
numpy path otherwise.  The JAX package computes the tile products with
``jnp.einsum`` outside any Pallas kernel; here they are ``torch.bmm``
(bf16 or fp32 operands, fp32 accumulation) and ``index_add_`` into the
output tiles.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Tuple

import numpy as np
import torch

BLOCK = 128
# gathered elements per step of aggregate_block_dense ([C, 128, F] source
# tiles); a step takes C = this // (128 F) blocks
BD_BUDGET_ELEMS = 1 << 27

# The 'auto' probe: below this edge count the probe is not run; at or
# above this share of edges on dense tiles the JAX rule takes 'bdense'.
BDENSE_AUTO_MIN_EDGES = 5_000_000
BDENSE_AUTO_MIN_FRAC = 0.15

# the largest multiplicity a u4-packed A-table holds
U4_MAX = 15


@dataclass
class BlockPlan:
    """Host-built dense-tile layout and residual CSR.

    a_blocks: uint8 ``[nblk, 128, 128]`` edge multiplicities, or after
      :func:`pack_a_u4` ``[nblk, 128, 64]`` with two per byte (low nibble
      = even column).
    src_blk/dst_blk: int32 ``[nblk]`` tile ids, sorted by ``dst_blk``.
    res_row_ptr/res_col: the residual dst-major CSR (edges of tiles under
      ``min_fill`` and multiplicities past 255).
    src_vpad: the source tile space (``vpad`` for the square plan).
    pad_blocks: zero-A blocks added by :func:`pad_plan_groups`.
    """
    num_rows: int
    vpad: int
    a_blocks: np.ndarray
    src_blk: np.ndarray
    dst_blk: np.ndarray
    res_row_ptr: np.ndarray
    res_col: np.ndarray
    dense_edges: int
    total_edges: int
    src_vpad: int = 0
    pad_blocks: int = 0

    def __post_init__(self):
        if not self.src_vpad:
            self.src_vpad = self.vpad

    @property
    def n_blocks(self) -> int:
        return int(self.a_blocks.shape[0])

    def occupancy(self) -> dict:
        """Blocks, dense edges and their share, mean fill of the blocks
        that carry edges, and the A-table's bytes (padding included)."""
        nb = self.n_blocks
        raw = nb - self.pad_blocks
        occ = {
            "n_blocks": nb,
            "dense_edges": int(self.dense_edges),
            "dense_frac": round(self.dense_edges
                                / max(self.total_edges, 1), 4),
            "mean_fill": round(self.dense_edges / max(raw, 1), 1),
            "a_bytes": int(self.a_blocks.nbytes),
        }
        if self.pad_blocks:
            occ["pad_blocks"] = int(self.pad_blocks)
        return occ


def _select_dense(counts: np.ndarray, min_fill: int,
                  a_budget_bytes: Optional[int], group: int = 1,
                  dst_of: Optional[np.ndarray] = None) -> np.ndarray:
    """Boolean selection over the tile census: at least ``min_fill``
    edges, densest first under the A-table budget (with ``group > 1``
    the budget caps the table after :func:`pad_plan_groups`, found by a
    binary search over the densest-first prefix)."""
    dense_sel = counts >= min_fill
    if a_budget_bytes is None:
        return dense_sel
    bb = BLOCK * BLOCK
    cand = np.flatnonzero(dense_sel)
    order = cand[np.argsort(-counts[cand], kind="stable")]
    if group > 1:
        if dst_of is None:
            raise ValueError("group > 1 needs each tile's dst tile")

        def fits(k: int) -> bool:
            if k == 0:
                return True
            w = np.bincount(dst_of[order[:k]])
            padded = int((-(-w[w > 0] // group) * group).sum())
            return padded * bb <= a_budget_bytes

        keep_n = len(order)
        if not fits(keep_n):
            lo, hi = 0, keep_n
            while lo < hi:
                mid = (lo + hi + 1) // 2
                if fits(mid):
                    lo = mid
                else:
                    hi = mid - 1
            keep_n = lo
    else:
        keep_n = min(len(order), int(a_budget_bytes // bb))
    if keep_n < len(order):
        dense_sel = np.zeros_like(dense_sel)
        dense_sel[order[:keep_n]] = True
    return dense_sel


def plan_blocks(row_ptr: np.ndarray, col_idx: np.ndarray, num_rows: int,
                min_fill: int = 64, a_budget_bytes: Optional[int] = 2 << 30,
                num_cols: Optional[int] = None, group: int = 1,
                census: Optional[Tuple[np.ndarray, np.ndarray]] = None
                ) -> BlockPlan:
    """Tile the dst-major CSR into ``[128, 128]`` blocks: those with at
    least ``min_fill`` edges go dense (densest first under
    ``a_budget_bytes`` of uint8 A-table; None: no cap), the rest stay in
    the residual CSR.  ``num_cols`` sets a rectangular source space;
    ``group > 1`` returns a :func:`pad_plan_groups`-aligned plan;
    ``census`` reuses the ``(keys, counts)`` of :func:`probe_dense_frac`
    over the same tile space (native path)."""
    row_ptr = np.asarray(row_ptr, dtype=np.int64)
    col_i32 = np.ascontiguousarray(col_idx, dtype=np.int32)
    E = col_i32.shape[0]
    vpad = -(-num_rows // BLOCK) * BLOCK
    if num_cols is None:
        num_cols = num_rows
    src_vpad = -(-num_cols // BLOCK) * BLOCK
    n_tiles = src_vpad // BLOCK

    from .. import native
    if native.available():
        keys_all, counts_all = census if census is not None \
            else native.block_counts(row_ptr, col_i32, num_rows, BLOCK,
                                     num_cols=num_cols)
        dense_keys = keys_all[_select_dense(
            counts_all, min_fill, a_budget_bytes, group=group,
            dst_of=keys_all // n_tiles)]
        a, res_ptr, res_col = native.block_fill(
            row_ptr, col_i32, num_rows, BLOCK, dense_keys, num_cols=num_cols)
        return pad_plan_groups(BlockPlan(
            num_rows=num_rows, vpad=vpad, a_blocks=a,
            src_blk=(dense_keys % n_tiles).astype(np.int32),
            dst_blk=(dense_keys // n_tiles).astype(np.int32),
            res_row_ptr=res_ptr, res_col=res_col,
            dense_edges=E - res_col.shape[0], total_edges=E,
            src_vpad=src_vpad), group)

    col = col_i32.astype(np.int64)
    if E and (col.min() < 0 or col.max() >= num_cols):
        raise ValueError(f"col_idx out of range [0, {num_cols}) for the "
                         f"declared source space")
    dst_all = np.repeat(np.arange(num_rows, dtype=np.int64),
                        np.diff(row_ptr))
    key = (dst_all // BLOCK) * n_tiles + col // BLOCK
    order = np.argsort(key, kind="stable")
    key_s = key[order]
    blocks, counts = np.unique(key_s, return_counts=True)
    dense_sel = _select_dense(counts, min_fill, a_budget_bytes, group=group,
                              dst_of=blocks // n_tiles)
    dense_blocks = blocks[dense_sel]
    nblk = int(dense_blocks.shape[0])
    a = np.zeros((nblk, BLOCK, BLOCK), dtype=np.uint8)
    if nblk:
        pos = np.minimum(np.searchsorted(dense_blocks, key_s), nblk - 1)
        in_dense = dense_blocks[pos] == key_s
    else:
        in_dense = np.zeros(E, dtype=bool)
    e_sel = order[in_dense]
    dense_edges = overflow_edges = 0
    if nblk:
        flat = (pos[in_dense] * BLOCK * BLOCK
                + (dst_all[e_sel] % BLOCK) * BLOCK + (col[e_sel] % BLOCK))
        flat_order = np.argsort(flat, kind="stable")
        flat_sorted = flat[flat_order]
        slots, counts_s = np.unique(flat_sorted, return_counts=True)
        # saturating multiplicities: duplicates past 255 stay residual
        kept = np.minimum(counts_s, 255)
        a.reshape(-1)[slots] = kept.astype(np.uint8)
        dense_edges = int(kept.sum())
        overflow_edges = int((counts_s - kept).sum())
    res_mask = np.ones(E, dtype=bool)
    res_mask[e_sel] = False
    if overflow_edges:
        # the last `excess` duplicates of a saturated slot stay residual
        over = counts_s > 255
        s1 = np.searchsorted(flat_sorted, slots[over], side="right")
        for hi, ex in zip(s1, counts_s[over] - 255):
            res_mask[e_sel[flat_order[hi - ex:hi]]] = True
    res_dst = dst_all[res_mask]
    res_ptr = np.zeros(num_rows + 1, dtype=np.int64)
    np.cumsum(np.bincount(res_dst, minlength=num_rows), out=res_ptr[1:])
    return pad_plan_groups(BlockPlan(
        num_rows=num_rows, vpad=vpad, a_blocks=a,
        src_blk=(dense_blocks % n_tiles).astype(np.int32),
        dst_blk=(dense_blocks // n_tiles).astype(np.int32),
        res_row_ptr=res_ptr, res_col=col[res_mask].astype(np.int32),
        dense_edges=dense_edges, total_edges=E, src_vpad=src_vpad), group)


def probe_dense_frac(row_ptr: np.ndarray, col_idx: np.ndarray,
                     num_rows: int, min_fill: int = 64,
                     a_budget_bytes: Optional[int] = 2 << 30,
                     num_cols: Optional[int] = None, group: int = 1,
                     return_census: bool = False):
    """The share of edges a :func:`plan_blocks` plan would put on dense
    tiles, from the native tile census and the budget selection alone
    (no fill): the 'auto' rule's structure probe.  None without the
    native planners (the numpy census takes minutes where the probe
    matters).  ``return_census`` also returns ``(keys, counts)`` for
    :func:`plan_blocks` to reuse."""
    from .. import native
    if not native.available():
        return None
    row_ptr = np.asarray(row_ptr, dtype=np.int64)
    col_i32 = np.ascontiguousarray(col_idx, dtype=np.int32)
    E = col_i32.shape[0]
    if num_cols is None:
        num_cols = num_rows
    n_tiles = -(-num_cols // BLOCK)
    if E == 0:
        empty = (np.zeros(0, np.int64), np.zeros(0, np.int64))
        return (0.0, empty) if return_census else 0.0
    keys, counts = native.block_counts(row_ptr, col_i32, num_rows, BLOCK,
                                       num_cols=num_cols)
    sel = _select_dense(counts, min_fill, a_budget_bytes, group=group,
                        dst_of=keys // n_tiles)
    frac = float(counts[sel].sum()) / E
    return (frac, (keys, counts)) if return_census else frac


def pad_plan_groups(plan: BlockPlan, group: int) -> BlockPlan:
    """Pad each dst tile's run of blocks to a multiple of ``group`` with
    zero-A blocks (src tile 0), so :func:`aggregate_block_dense` can
    reduce ``group`` blocks per output-tile update."""
    if group <= 1 or plan.n_blocks == 0:
        return plan
    uniq, counts = np.unique(plan.dst_blk, return_counts=True)
    padded = -(-counts // group) * group
    total = int(padded.sum())
    if total == plan.n_blocks:
        return plan
    new_start = np.zeros(len(uniq) + 1, np.int64)
    np.cumsum(padded, out=new_start[1:])
    old_start = np.zeros(len(uniq) + 1, np.int64)
    np.cumsum(counts, out=old_start[1:])
    run_id = np.repeat(np.arange(len(uniq)), counts)
    pos = new_start[run_id] + (np.arange(plan.n_blocks) - old_start[run_id])
    a2 = np.zeros((total, BLOCK, BLOCK), np.uint8)
    a2[pos] = plan.a_blocks
    src2 = np.zeros(total, np.int32)
    src2[pos] = plan.src_blk
    return replace(plan, a_blocks=a2, src_blk=src2,
                   dst_blk=np.repeat(uniq, padded).astype(np.int32),
                   pad_blocks=plan.pad_blocks + (total - plan.n_blocks))


def plan_blocks_packed(row_ptr: np.ndarray, col_idx: np.ndarray,
                       num_rows: int, min_fill: int = 64,
                       a_budget_bytes: Optional[int] = 2 << 30,
                       num_cols: Optional[int] = None, group: int = 1,
                       census=None) -> BlockPlan:
    """:func:`plan_blocks` with the u4 budget rule: plan against twice the
    budget (packing halves the bytes) and pack; a plan that does not
    pack (a multiplicity past 15) is planned again at the true budget
    when over it, reusing ``census``."""
    budget2 = a_budget_bytes * 2 if a_budget_bytes is not None else None
    plan = plan_blocks(row_ptr, col_idx, num_rows, min_fill=min_fill,
                       a_budget_bytes=budget2, num_cols=num_cols,
                       group=group, census=census)
    p4 = pack_a_u4(plan)
    if p4 is not None:
        return p4
    if a_budget_bytes is not None and plan.a_blocks.nbytes > a_budget_bytes:
        plan = plan_blocks(row_ptr, col_idx, num_rows, min_fill=min_fill,
                           a_budget_bytes=a_budget_bytes, num_cols=num_cols,
                           group=group, census=census)
    return plan


def pack_a_u4(plan: BlockPlan) -> Optional[BlockPlan]:
    """The A-table packed to uint4 (``byte[..., k] = col 2k | col 2k+1 <<
    4``), or None when a multiplicity exceeds :data:`U4_MAX`.  An empty
    plan packs too (to ``[0, 128, 64]``)."""
    if plan.n_blocks and plan.a_blocks.max() > U4_MAX:
        return None
    a = plan.a_blocks
    return replace(plan, a_blocks=(a[..., 0::2] | (a[..., 1::2] << 4))
                   .astype(np.uint8))


def _tile_products(a: torch.Tensor, gx: torch.Tensor) -> torch.Tensor:
    """``a @ gx`` batched, fp32 out: bf16 operands on the card through
    ``torch.bmm(..., out_dtype=float32)`` (fp32 accumulation), otherwise
    the operands widened to fp32 (a bf16 product is exact in fp32)."""
    if gx.dtype == torch.bfloat16 and gx.is_cuda:
        return torch.bmm(a.to(torch.bfloat16), gx, out_dtype=torch.float32)
    acc = torch.promote_types(gx.dtype, torch.float32)
    return torch.bmm(a.to(acc), gx.to(acc))


def aggregate_block_dense(x: torch.Tensor, a_blocks: torch.Tensor,
                          src_blk: torch.Tensor, dst_blk: torch.Tensor,
                          num_rows: int, vpad: int,
                          out_dtype: torch.dtype = torch.float32,
                          chunk_blocks: Optional[int] = None,
                          src_vpad: int = 0, group: int = 1,
                          scale_dst: Optional[torch.Tensor] = None,
                          scale_src: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """The dense tiles' part of the sum (the residual is the caller's).

    x: ``[src_rows, F]`` source features (rows past ``src_vpad`` are
    ignored).  a_blocks: uint8 ``[nblk, 128, 128]`` or u4-packed
    ``[nblk, 128, 64]`` (unpacked per step); src_blk/dst_blk ``[nblk]``.
    Returns ``[num_rows, F]`` in ``out_dtype`` (fp32 by default),
    accumulated in fp32.  ``group > 1`` needs a :func:`pad_plan_groups`
    plan and sums ``group`` blocks per output tile in one product.
    ``scale_dst [vpad]`` / ``scale_src [src_vpad]`` (set together): the
    fused normalization's row scales, the source tile scaled in the
    compute dtype after its gather and the fp32 product before its
    ``index_add_`` (the integer A-table is left as it is).
    ``chunk_blocks``: blocks a step (default from
    :data:`BD_BUDGET_ELEMS`)."""
    F = x.shape[1]
    nblk = a_blocks.shape[0]
    n_tiles = vpad // BLOCK
    src_vpad = src_vpad or vpad
    src_rows = min(x.shape[0], src_vpad)
    group = max(1, group)
    if nblk % group:
        raise ValueError(f"group={group} needs a pad_plan_groups-padded "
                         f"plan; got {nblk} blocks")
    if (scale_dst is None) != (scale_src is None):
        raise ValueError("scale_dst and scale_src must be set together")
    compute = x.dtype if x.dtype == torch.bfloat16 else \
        torch.promote_types(x.dtype, torch.float32)
    xt = torch.cat([x[:src_rows].to(compute),
                    x.new_zeros((src_vpad - src_rows, F), dtype=compute)]
                   ).reshape(src_vpad // BLOCK, BLOCK, F)
    packed = a_blocks.shape[-1] == BLOCK // 2
    if scale_src is not None:
        ssrc_t = scale_src.to(compute).reshape(src_vpad // BLOCK, BLOCK)
        sdst_t = scale_dst.to(torch.float32).reshape(n_tiles, BLOCK)
    out = x.new_zeros((n_tiles, BLOCK, F), dtype=torch.float32)
    if chunk_blocks is None:
        chunk_blocks = BD_BUDGET_ELEMS // (BLOCK * F)
    C = max(group, chunk_blocks // group * group)
    for b0 in range(0, nblk, C):
        a = a_blocks[b0:b0 + C]
        if packed:
            a = torch.stack([a & 0xF, a >> 4], dim=-1).reshape(
                a.shape[0], BLOCK, BLOCK)
        s_ids = src_blk[b0:b0 + C].to(torch.int64)
        d_ids = dst_blk[b0:b0 + C].to(torch.int64)
        gx = xt.index_select(0, s_ids)
        if scale_src is not None:
            gx = gx * ssrc_t.index_select(0, s_ids)[:, :, None]
        if group > 1:
            c = s_ids.shape[0] // group
            # [c, group, i, j] -> [c, i, group*j] against [c, group*j, F]
            a = a.reshape(c, group, BLOCK, BLOCK).permute(0, 2, 1, 3) \
                .reshape(c, BLOCK, group * BLOCK)
            gx = gx.reshape(c, group * BLOCK, F)
            d_ids = d_ids.reshape(c, group)[:, 0]
        y = _tile_products(a, gx)
        if scale_dst is not None:
            y = y * sdst_t.index_select(0, d_ids)[:, :, None]
        out.index_add_(0, d_ids, y)
    return out.reshape(vpad, F)[:num_rows].to(out_dtype)
