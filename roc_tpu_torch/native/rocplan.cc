// rocplan — the host planners of the large-graph aggregation layouts,
// for roc_tpu_torch (roc_tpu_torch/native/__init__.py loads it with
// ctypes).  A copy of the planning passes of the JAX package's
// native/rocio.cc with the same C ABI: the sectioned sub-row tables, the
// [128, 128] tile census and fill of the block-dense plan, and one
// asynchronous label-propagation sweep.  Every buffer is a
// caller-allocated numpy array; errors are negative return codes.

#include <cstdint>

#include <algorithm>
#include <vector>

namespace {

constexpr int kOk = 0;
constexpr int kErrValue = -4;

}  // namespace

extern "C" {

// Bumped on every change of a C signature below or in rocload.cc, the
// loaders built into the same library; the loader refuses a library whose
// version differs.  v2: rocload.cc's loader passes added.
int roc_abi_version(void) { return 2; }

// ---------------------------------------------------------------------------
// Sectioned fast-gather layout prep (core/ell.py SectionedEll): the
// O(E) host pass that splits each dst row's neighbor list by source
// section and emits width-8 sub-rows.  Two passes behind a C ABI with
// caller-allocated buffers, like everything else in this file:
// counts (so Python can compute the uniform chunk plan and allocate)
// then fill.  Both walk the dst-major CSR once — O(E + V * n_sec).
// ---------------------------------------------------------------------------

int roc_sectioned_counts(const int64_t* row_ptr, const int32_t* col,
                         int64_t num_rows, int64_t section_rows,
                         int64_t n_sec, int64_t sub_w,
                         int64_t* counts) {
  if (sub_w <= 0) return kErrValue;
  std::vector<int64_t> local(static_cast<size_t>(n_sec));
  for (int64_t s = 0; s < n_sec; ++s) counts[s] = 0;
  for (int64_t v = 0; v < num_rows; ++v) {
    std::fill(local.begin(), local.end(), 0);
    for (int64_t e = row_ptr[v]; e < row_ptr[v + 1]; ++e) {
      int64_t s = col[e] / section_rows;
      if (col[e] < 0 || s >= n_sec) return kErrValue;  // out of range
      local[static_cast<size_t>(s)] += 1;
    }
    for (int64_t s = 0; s < n_sec; ++s) {
      counts[s] += (local[static_cast<size_t>(s)] + sub_w - 1) / sub_w;
    }
  }
  return kOk;
}

// sec_sizes[s]: the section's row count == its local dummy id.
// slots[s]: allocated sub-rows per section (chunk plan * seg_rows);
// must be >= the counts pass's result or kErrValue is returned.
// idx_flat: [sum(slots) * sub_w] int32; sub_dst_flat: [sum(slots)] int32.
// Sub-rows are emitted in ascending dst order per section (matching
// the numpy builder exactly); leftover slots become padding sub-rows
// (idx = section dummy, sub_dst = num_rows).
int roc_sectioned_fill(const int64_t* row_ptr, const int32_t* col,
                       int64_t num_rows, int64_t section_rows,
                       int64_t n_sec, int64_t sub_w,
                       const int64_t* sec_sizes,
                       const int64_t* slots, int32_t* idx_flat,
                       int32_t* sub_dst_flat) {
  if (sub_w <= 0) return kErrValue;
  std::vector<int64_t> cursor(static_cast<size_t>(n_sec));
  std::vector<int64_t> limit(static_cast<size_t>(n_sec));
  int64_t off = 0;
  for (int64_t s = 0; s < n_sec; ++s) {
    cursor[static_cast<size_t>(s)] = off;
    off += slots[s];
    limit[static_cast<size_t>(s)] = off;
  }
  std::vector<std::vector<int32_t>> buf(static_cast<size_t>(n_sec));
  for (int64_t v = 0; v < num_rows; ++v) {
    for (int64_t e = row_ptr[v]; e < row_ptr[v + 1]; ++e) {
      int64_t s = col[e] / section_rows;
      if (col[e] < 0 || s >= n_sec) return kErrValue;  // out of range
      buf[static_cast<size_t>(s)].push_back(
          static_cast<int32_t>(col[e] - s * section_rows));
    }
    for (int64_t s = 0; s < n_sec; ++s) {
      std::vector<int32_t>& b = buf[static_cast<size_t>(s)];
      if (b.empty()) continue;
      int64_t nsub =
          (static_cast<int64_t>(b.size()) + sub_w - 1) / sub_w;
      if (cursor[static_cast<size_t>(s)] + nsub >
          limit[static_cast<size_t>(s)]) {
        return kErrValue;  // plan smaller than the counts pass said
      }
      int64_t base = cursor[static_cast<size_t>(s)] * sub_w;
      for (int64_t k = 0; k < nsub * sub_w; ++k) {
        idx_flat[base + k] =
            k < static_cast<int64_t>(b.size())
                ? b[static_cast<size_t>(k)]
                : static_cast<int32_t>(sec_sizes[s]);
      }
      for (int64_t j = 0; j < nsub; ++j) {
        sub_dst_flat[cursor[static_cast<size_t>(s)] + j] =
            static_cast<int32_t>(v);
      }
      cursor[static_cast<size_t>(s)] += nsub;
      b.clear();
    }
  }
  for (int64_t s = 0; s < n_sec; ++s) {
    for (int64_t slot = cursor[static_cast<size_t>(s)];
         slot < limit[static_cast<size_t>(s)]; ++slot) {
      for (int64_t k = 0; k < sub_w; ++k) {
        idx_flat[slot * sub_w + k] =
            static_cast<int32_t>(sec_sizes[s]);
      }
      sub_dst_flat[slot] = static_cast<int32_t>(num_rows);
    }
  }
  return kOk;
}

// ---------------------------------------------------------------------------
// Block-dense tile planning (ops/blockdense.py plan_blocks): the
// occupied-tile census and the A-table/residual fill as O(E) CSR
// walks, where the numpy path sorts all E keys.  Same two-pass
// caller-allocates shape as the sectioned prep above.
// ---------------------------------------------------------------------------

// (key, count) per occupied [block x block] tile, key ascending
// (key = dst_tile * n_src_tiles + src_tile, where n_src_tiles covers
// num_cols — the source space may be wider than the dst rows, e.g.
// the distributed planner's gathered coordinates).  Counts include
// every edge
// of the tile (saturation is the fill pass's business).  Writes at
// most `cap` rows; returns the TOTAL occupied-tile count (a result
// > cap means the output is truncated and the caller must retry with
// more room), or kErrValue for out-of-range columns.
int64_t roc_block_counts(const int64_t* row_ptr, const int32_t* col,
                         int64_t num_rows, int64_t num_cols,
                         int64_t block,
                         int64_t* keys, int64_t* counts, int64_t cap) {
  if (block <= 0 || num_cols <= 0) return kErrValue;
  int64_t n_tiles = (num_rows + block - 1) / block;
  int64_t n_src_tiles = (num_cols + block - 1) / block;
  std::vector<int64_t> cnt(static_cast<size_t>(n_src_tiles), 0);
  std::vector<int64_t> touched;
  int64_t nnz = 0;
  for (int64_t t = 0; t < n_tiles; ++t) {
    int64_t lo = t * block;
    int64_t hi = std::min(num_rows, lo + block);
    touched.clear();
    for (int64_t v = lo; v < hi; ++v) {
      for (int64_t e = row_ptr[v]; e < row_ptr[v + 1]; ++e) {
        int64_t s = col[e] / block;
        if (col[e] < 0 || s >= n_src_tiles) return kErrValue;
        if (cnt[static_cast<size_t>(s)]++ == 0) touched.push_back(s);
      }
    }
    std::sort(touched.begin(), touched.end());
    for (int64_t s : touched) {
      if (nnz < cap) {
        keys[nnz] = t * n_src_tiles + s;
        counts[nnz] = cnt[static_cast<size_t>(s)];
      }
      ++nnz;
      cnt[static_cast<size_t>(s)] = 0;
    }
  }
  return nnz;
}

// Fill pass: dense_keys is the planner's ASCENDING selection of tile
// keys; `a` is the zeroed uint8 [nblk * block * block] multiplicity
// table.  Edges in selected tiles increment their slot (saturating at
// 255 — overflow duplicates spill to the residual, keeping the
// semantics exact); everything else lands in the residual dst-major
// CSR (res_ptr [num_rows + 1], res_col capacity res_cap, original
// per-row edge order preserved).  Returns the residual edge count, or
// kErrValue on out-of-range columns / capacity overflow.
int64_t roc_block_fill(const int64_t* row_ptr, const int32_t* col,
                       int64_t num_rows, int64_t num_cols,
                       int64_t block,
                       const int64_t* dense_keys, int64_t nblk,
                       uint8_t* a, int64_t* res_ptr, int32_t* res_col,
                       int64_t res_cap) {
  if (block <= 0 || num_cols <= 0) return kErrValue;
  int64_t n_tiles = (num_rows + block - 1) / block;
  int64_t n_src_tiles = (num_cols + block - 1) / block;
  std::vector<int64_t> blk_of(static_cast<size_t>(n_src_tiles), -1);
  int64_t res_n = 0;
  int64_t k_lo = 0;
  for (int64_t t = 0; t < n_tiles; ++t) {
    int64_t k_hi = k_lo;
    while (k_hi < nblk && dense_keys[k_hi] < (t + 1) * n_src_tiles)
      ++k_hi;
    for (int64_t i = k_lo; i < k_hi; ++i) {
      blk_of[static_cast<size_t>(dense_keys[i] % n_src_tiles)] = i;
    }
    int64_t lo = t * block;
    int64_t hi = std::min(num_rows, lo + block);
    for (int64_t v = lo; v < hi; ++v) {
      res_ptr[v] = res_n;
      for (int64_t e = row_ptr[v]; e < row_ptr[v + 1]; ++e) {
        int64_t s = col[e] / block;
        if (col[e] < 0 || s >= n_src_tiles) return kErrValue;
        int64_t b = blk_of[static_cast<size_t>(s)];
        if (b >= 0) {
          uint8_t* slot = a + (b * block + (v - lo)) * block
                            + (col[e] - s * block);
          if (*slot < 255) {
            ++*slot;
            continue;
          }
        }
        if (res_n >= res_cap) return kErrValue;
        res_col[res_n++] = col[e];
      }
    }
    for (int64_t i = k_lo; i < k_hi; ++i) {
      blk_of[static_cast<size_t>(dense_keys[i] % n_src_tiles)] = -1;
    }
    k_lo = k_hi;
  }
  res_ptr[num_rows] = res_n;
  return res_n;
}

// ---------------------------------------------------------------------------
// Label propagation (core/reorder.py lpa_order): one ASYNCHRONOUS
// sweep over an undirected neighbor CSR, in increasing vertex order.
// labels_out starts as a copy of labels and every vote READS
// labels_out, so vertex v sees the already-updated labels of
// vertices < v.  labels_out[v] = the most frequent label among v's
// neighbors, ties -> smallest label; isolated vertices keep theirs.
// Returns the number of vertices whose final label differs from the
// entry label (the caller iterates to convergence).
//
// Asynchrony is load-bearing, not an optimization: fully-synchronous
// LPA 2-cycles (a star flips center<->leaf labels forever, so a
// convergence test never fires and the result depends on sweep-count
// parity), and no fixed vertex bipartition fixes that (same-class
// cycles survive).  The async rule is cycle-free by a lexicographic
// potential: every change either strictly raises the vertex's
// neighbor-agreement count or keeps it equal while strictly lowering
// the label (smallest-among-maxima tie rule), so sweeps terminate.
// The numpy fallback replays the identical vertex order — results
// are tested equal.
// ---------------------------------------------------------------------------

int64_t roc_lpa_iterate(const int64_t* nbr_ptr, const int32_t* nbr,
                        int64_t num_nodes, const int32_t* labels,
                        int32_t* labels_out) {
  std::vector<int32_t> scratch;
  int64_t changed = 0;
  std::copy(labels, labels + num_nodes, labels_out);
  for (int64_t v = 0; v < num_nodes; ++v) {
    int64_t lo = nbr_ptr[v], hi = nbr_ptr[v + 1];
    if (hi <= lo) {
      continue;
    }
    scratch.clear();
    for (int64_t e = lo; e < hi; ++e) {
      if (nbr[e] < 0 || nbr[e] >= num_nodes) return kErrValue;
      scratch.push_back(labels_out[nbr[e]]);
    }
    std::sort(scratch.begin(), scratch.end());
    int32_t best = scratch[0];
    int64_t best_n = 0;
    const int64_t n = static_cast<int64_t>(scratch.size());
    int64_t i = 0;
    while (i < n) {
      int64_t j = i;
      while (j < n && scratch[j] == scratch[i]) ++j;
      if (j - i > best_n) {
        best_n = j - i;
        best = scratch[i];
      }
      i = j;
    }
    labels_out[v] = best;
    if (best != labels[v]) ++changed;
  }
  return changed;
}

}  // extern "C"
