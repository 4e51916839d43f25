// CSR neighbour sum over a destination-sorted edge list, fp32 (K3).
//
// Replaces roc_tpu/kernels/spmm.py csr_spmm_pallas (_seg_reduce_kernel):
//   out[v, :] = sum over edges e with dst[e] == v of feats[src[e], :]
// for every output row v < num_rows, over edges sorted by dst and padded
// to a chunk multiple.  Ids outside [0, dummy) (the padding edges' source
// is dummy == the feature row count) add nothing, so no zero row has to be
// appended to feats.  Rows with no edges come out 0.
//
// The TPU design gathers feats[src] for a chunk of edges in XLA and reduces
// it with a one-hot MXU matmul plus carry records, because Mosaic has no
// vector gather.  The card can gather, so this kernel is a row-parallel CSR
// sum instead (the reference's own aggre_coop_kernel shape,
// scattergather_kernel.cu:20-76):
// - one warp per destination row; its edge range [lo, hi) is found by two
//   binary searches in the sorted dst (lower_bound of v and of v + 1), so
//   the kernel takes the JAX function's arguments and needs no host-built
//   row table;
// - the range is summed by the shared warp gather-sum of row_gather.cuh
//   (source ids loaded 32 at a time and broadcast by __shfl_sync, float4
//   loads along F, fp32 register sums written once, no atomics), so the
//   result is deterministic.
//
// Bound on the H100: bytes, and really latency, as for K4: each gathered
// row is read where it lies, so the kernel needs many row loads in flight.
// A warp per row serialises a hub row's edges (a row of 10^5 edges is one
// warp's work); balancing hub rows and keeping more loads in flight are
// later work.  The searches cost 2 * log2(E) dst loads per row, most of
// them from L2.

#include "row_gather.cuh"

using roc_gather::kWarpsPerBlock;

namespace {

// first index i in [lo, hi) with a[i] >= key (hi if none)
__device__ __forceinline__ long long lower_bound(const int* __restrict__ a,
                                                 long long lo, long long hi,
                                                 int key) {
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (a[mid] < key)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

template <bool VEC>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    csr_row_sum(const float* __restrict__ feats, const int* __restrict__ src,
                const int* __restrict__ dst, float* __restrict__ out,
                long long num_edges, int dummy, int num_rows, int F) {
  const int v = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (v >= num_rows) return;  // uniform across the warp
  // every lane searches the same addresses: one broadcast load per step
  const long long lo = lower_bound(dst, 0, num_edges, v);
  const long long hi = lower_bound(dst, lo, num_edges, v + 1);
  roc_gather::warp_row_sum<VEC>(feats, src + lo, (int)(hi - lo), dummy, F,
                                out + (long long)v * F, lane);
}

}  // namespace

extern "C" int roc_csr_spmm_f32(const float* feats, const int* edge_src,
                                const int* edge_dst, float* out,
                                long long num_edges, int dummy, int num_rows,
                                int F, void* stream) {
  if (num_rows == 0 || F == 0) return (int)cudaGetLastError();
  const unsigned blocks =
      (unsigned)((num_rows + kWarpsPerBlock - 1) / kWarpsPerBlock);
  if (roc_gather::use_vec4(feats, out, F))
    csr_row_sum<true><<<blocks, kWarpsPerBlock * 32, 0, (cudaStream_t)stream>>>(
        feats, edge_src, edge_dst, out, num_edges, dummy, num_rows, F);
  else
    csr_row_sum<false><<<blocks, kWarpsPerBlock * 32, 0, (cudaStream_t)stream>>>(
        feats, edge_src, edge_dst, out, num_edges, dummy, num_rows, F);
  return (int)cudaGetLastError();
}
