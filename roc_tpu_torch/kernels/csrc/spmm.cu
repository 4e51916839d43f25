// CSR neighbour sum over a destination-sorted edge list, fp32 and bf16 (K3).
//
// Replaces roc_tpu/kernels/spmm.py csr_spmm_pallas (_seg_reduce_kernel):
//   out[v, :] = sum over edges e with dst[e] == v of feats[src[e], :]
// for every output row v < num_rows, over edges sorted by dst and padded
// to a chunk multiple, summed in fp32 and written in feats' type (bf16
// rounded once at the store).  Ids outside [0, dummy) (the padding edges'
// source is dummy == the feature row count) add nothing, so no zero row
// has to be appended to feats.  Rows with no edges come out 0.
//
// The TPU design gathers feats[src] for a chunk of edges in XLA and reduces
// it with a one-hot MXU matmul plus carry records, because Mosaic has no
// vector gather.  The card can gather, so this is a row-parallel CSR sum
// (the reference's own aggre_coop_kernel shape, scattergather_kernel.cu:
// 20-76), in two kernels:
// - csr_row_ptr, a pre-pass: one thread per row v in [0, num_rows] writes
//   row_ptr[v] = lower_bound(dst, v) (64-bit) into scratch the wrapper
//   allocates, so the row ranges are found once per call and the kernel
//   still takes the JAX function's arguments (no host-built row table);
// - csr_row_sum, the main pass: one warp per (destination row, column
//   slice) sums the edge range [row_ptr[v], row_ptr[v + 1]) with the
//   shared gather-sum of row_gather.cuh.
//
// Bound on the H100 (80GB HBM3, 700 W): the rate of its gathers, E * F *
// sizeof(E) bytes a call, every segment from L2 at least.  The L2-to-SM
// rate measured for these gathers is ~7.8 TB/s (chip_smoke.py
// --gather-race, row_gather.cuh), 20-30x above the time of moving each
// input byte once.  A warp per row walking all of F (the unsliced
// instance) gathers at F = 256 mostly from HBM (~3.7 TB/s, 31 ms in fp32).
// The main pass is column-sliced and slice-major (the slice on
// blockIdx.y, so all row blocks of one slice run before the next and its
// V * S * sizeof(E) bytes of feats stay in L2); the fp32 gathers then come
// from L2 at the ceiling (7.8-8.0 TB/s, 14.3-14.5 ms). Rows move in the
// widest unit their starts allow (row_gather.cuh unit_bytes): at the
// blocked walk's chunk (F = 602 fp32, 2,408-byte rows on 8-byte units,
// 7,732 output rows) slice 64 in 8-byte units takes 0.41 ms, against
// 0.66 in one-element units and torch.sparse.mm's 0.55. HBM carries feats
// once, out once, and edge_src and row_ptr once per slice (ceil(F / S)
// passes, the price of slicing). Without the pre-pass every slice would
// repeat two binary searches per row over the whole edge list. Lane
// groups fill the warp on narrow slices and combine in a fixed tree: no
// atomics, so a row's sum is the same bits on every launch. The slice
// width is a template parameter, one instance each for 16, 32, 64, 128
// and 0 (unsliced: a warp per row walking all of F over the pre-pass's
// ranges, which stays the faster one at F <= 64 and over units narrower
// than 8 bytes), and the unit another; the wrapper picks the width per F
// and dtype from a race on the card (kernels/spmm.py), the launch the
// unit from the addresses. A warp per row still serialises a hub row's
// edges; balancing hub rows is later work.

#include "row_gather.cuh"

using roc_gather::kWarpsPerBlock;

namespace {

constexpr int kRowPtrThreads = 256;

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

__global__ void __launch_bounds__(kRowPtrThreads)
    csr_row_ptr(const int* __restrict__ dst, long long* __restrict__ row_ptr,
                long long num_edges, int num_rows) {
  const long long v = (long long)blockIdx.x * kRowPtrThreads + threadIdx.x;
  if (v > num_rows) return;
  row_ptr[v] = lower_bound(dst, 0, num_edges, (int)v);
}

template <typename E, int S, int B>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    csr_row_sum(const E* __restrict__ feats, const int* __restrict__ src,
                const long long* __restrict__ row_ptr, E* __restrict__ out,
                int dummy, int num_rows, int F) {
  const int v = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (v >= num_rows) return;  // uniform across the warp
  const long long lo = row_ptr[v];
  const long long hi = row_ptr[v + 1];
  roc_gather::warp_gather_sum<E, S, B>(feats, src + lo, (int)(hi - lo),
                                         dummy, F, out + (long long)v * F,
                                         lane);
}

template <typename E, int S>
void launch(const E* feats, const int* src, const long long* row_ptr, E* out,
            int dummy, int num_rows, int F, cudaStream_t stream) {
  const dim3 grid((unsigned)((num_rows + kWarpsPerBlock - 1) / kWarpsPerBlock),
                  roc_gather::num_slices(S, F));
  const int unit = roc_gather::unit_bytes(feats, out, F);
  roc_gather::with_unit<E>(unit, [&](auto B) {
    csr_row_sum<E, S, decltype(B)::value>
        <<<grid, kWarpsPerBlock * 32, 0, stream>>>(
            feats, src, row_ptr, out, dummy, num_rows, F);
  });
}

template <typename E>
int run(const E* feats, const int* edge_src, const long long* row_ptr,
        E* out, int dummy, int num_rows, int F, int slice_cols,
        void* stream) {
  if (!roc_gather::valid_slice(slice_cols)) return (int)cudaErrorInvalidValue;
  if (num_rows == 0 || F == 0) return (int)cudaGetLastError();
  roc_gather::with_slice(slice_cols, [&](auto S) {
    launch<E, decltype(S)::value>(feats, edge_src, row_ptr, out, dummy,
                                  num_rows, F, (cudaStream_t)stream);
  });
  return (int)cudaGetLastError();
}

}  // namespace

// the pre-pass is the same for every element type
extern "C" int roc_csr_row_ptr(const int* edge_dst, long long* row_ptr,
                               long long num_edges, int num_rows,
                               void* stream) {
  const unsigned blocks =
      (unsigned)((num_rows + 1 + kRowPtrThreads - 1) / kRowPtrThreads);
  csr_row_ptr<<<blocks, kRowPtrThreads, 0, (cudaStream_t)stream>>>(
      edge_dst, row_ptr, num_edges, num_rows);
  return (int)cudaGetLastError();
}

extern "C" int roc_csr_spmm_f32(const float* feats, const int* edge_src,
                                const long long* row_ptr, float* out,
                                int dummy, int num_rows, int F, int slice_cols,
                                void* stream) {
  return run(feats, edge_src, row_ptr, out, dummy, num_rows, F, slice_cols,
             stream);
}

extern "C" int roc_csr_spmm_bf16(const __nv_bfloat16* feats,
                                 const int* edge_src,
                                 const long long* row_ptr, __nv_bfloat16* out,
                                 int dummy, int num_rows, int F,
                                 int slice_cols, void* stream) {
  return run(feats, edge_src, row_ptr, out, dummy, num_rows, F, slice_cols,
             stream);
}
