// Degree-bucketed ELL neighbour sum, fp32.
//
// Replaces roc_tpu/kernels/ell_spmm.py ell_aggregate_pallas
// (_bucket_kernel): for one degree bucket idx [rows, width] of source ids,
//   out[row_id[r], :] = sum_j feats[idx[r, j], :]
// summed in fp32 over the row's valid ids.  Ids outside [0, dummy) (the
// bucket padding holds dummy == the gathered row count) add nothing, so no
// zero row has to be appended to feats.  Bucket rows whose row_id is not a
// real output row are skipped.  Rows in no bucket (degree 0) keep the zeros
// the caller allocated out with.
//
// Bound on the H100: bytes, and really latency.  The work is a gather of
// E source rows of F floats each, one add per gathered element.  Each
// gathered row is read where it lies, so the kernel needs many row loads in
// flight at once to reach the memory rate.  Design: one warp per bucket
// row, running the shared warp gather-sum of row_gather.cuh (ids broadcast
// by __shfl_sync, float4 loads along F, fp32 register sums written once,
// no atomics), each sum written straight to its output row: no [rows, F]
// bucket output to concatenate and permute afterwards.
// The TPU kernel's 8-row DMA groups and SMEM index staging answer the
// TPU's (8, 128) HBM tiling and scalar-core DMA issue; neither exists here.

#include "row_gather.cuh"

using roc_gather::kWarpsPerBlock;

namespace {

template <bool VEC>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    ell_bucket_sum(const float* __restrict__ feats, const int* __restrict__ idx,
                   const int* __restrict__ row_id, float* __restrict__ out,
                   int rows, int width, int dummy, int num_rows, int F) {
  const int r = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (r >= rows) return;  // uniform across the warp
  const int dst = row_id[r];
  if (dst < 0 || dst >= num_rows) return;
  roc_gather::warp_row_sum<VEC>(feats, idx + (long long)r * width, width,
                                dummy, F, out + (long long)dst * F, lane);
}

}  // namespace

extern "C" int roc_ell_aggregate_f32(const float* feats, const int* idx,
                                     const int* row_id, float* out, int rows,
                                     int width, int dummy, int num_rows, int F,
                                     void* stream) {
  if (rows == 0 || F == 0) return (int)cudaGetLastError();
  const unsigned blocks = (unsigned)((rows + kWarpsPerBlock - 1) / kWarpsPerBlock);
  if (roc_gather::use_vec4(feats, out, F))
    ell_bucket_sum<true><<<blocks, kWarpsPerBlock * 32, 0, (cudaStream_t)stream>>>(
        feats, idx, row_id, out, rows, width, dummy, num_rows, F);
  else
    ell_bucket_sum<false><<<blocks, kWarpsPerBlock * 32, 0, (cudaStream_t)stream>>>(
        feats, idx, row_id, out, rows, width, dummy, num_rows, F);
  return (int)cudaGetLastError();
}
