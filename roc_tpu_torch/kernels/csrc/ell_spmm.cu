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
// flight at once to reach the memory rate.  Design:
// - one warp per bucket row; the row's ids are loaded 32 at a time, one per
//   lane, and broadcast with __shfl_sync, so the id list costs one
//   coalesced load per 32 neighbours;
// - lanes stride over F: each lane holds kVec float4 accumulators (F % 4 ==
//   0, 16-byte aligned rows) or kVec floats (otherwise), so one neighbour's
//   row is one coalesced warp-wide load of 32 * 16 bytes, and F = 256 fits
//   one pass (wider F loops over column tiles);
// - the sum stays in registers and is written once, straight to its output
//   row: no atomics, so the result is deterministic, and no [rows, F]
//   bucket output to concatenate and permute afterwards.
// The TPU kernel's 8-row DMA groups and SMEM index staging answer the
// TPU's (8, 128) HBM tiling and scalar-core DMA issue; neither exists here.
// Row offsets are 64-bit (V * F passes 2^31 at Reddit scale with F = 602).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kVec = 2;  // accumulators per lane

__device__ __forceinline__ void add4(float4& a, const float4 b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

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
  const int* ids = idx + (long long)r * width;
  float* orow = out + (long long)dst * F;
  constexpr int kTile = VEC ? kVec * 32 * 4 : kVec * 32;

  for (int c0 = 0; c0 < F; c0 += kTile) {
    float4 acc4[kVec];
    float acc1[kVec];
#pragma unroll
    for (int v = 0; v < kVec; ++v) {
      acc4[v] = make_float4(0.f, 0.f, 0.f, 0.f);
      acc1[v] = 0.f;
    }
    for (int j0 = 0; j0 < width; j0 += 32) {
      const int mine = j0 + lane < width ? ids[j0 + lane] : dummy;
      const int n = width - j0 < 32 ? width - j0 : 32;
#pragma unroll 4
      for (int k = 0; k < n; ++k) {
        const int s = __shfl_sync(0xffffffffu, mine, k);
        if ((unsigned)s >= (unsigned)dummy) continue;  // padding id
        const float* srow = feats + (long long)s * F;
#pragma unroll
        for (int v = 0; v < kVec; ++v) {
          if (VEC) {
            const int c = c0 + (v * 32 + lane) * 4;
            if (c < F) add4(acc4[v], *reinterpret_cast<const float4*>(srow + c));
          } else {
            const int c = c0 + v * 32 + lane;
            if (c < F) acc1[v] += srow[c];
          }
        }
      }
    }
#pragma unroll
    for (int v = 0; v < kVec; ++v) {
      if (VEC) {
        const int c = c0 + (v * 32 + lane) * 4;
        if (c < F) *reinterpret_cast<float4*>(orow + c) = acc4[v];
      } else {
        const int c = c0 + v * 32 + lane;
        if (c < F) orow[c] = acc1[v];
      }
    }
  }
}

}  // namespace

extern "C" int roc_ell_aggregate_f32(const float* feats, const int* idx,
                                     const int* row_id, float* out, int rows,
                                     int width, int dummy, int num_rows, int F,
                                     void* stream) {
  if (rows == 0 || F == 0) return (int)cudaGetLastError();
  const bool vec = F % 4 == 0 && ((uintptr_t)feats % 16) == 0 &&
                   ((uintptr_t)out % 16) == 0;
  const unsigned blocks = (unsigned)((rows + kWarpsPerBlock - 1) / kWarpsPerBlock);
  if (vec)
    ell_bucket_sum<true><<<blocks, kWarpsPerBlock * 32, 0, (cudaStream_t)stream>>>(
        feats, idx, row_id, out, rows, width, dummy, num_rows, F);
  else
    ell_bucket_sum<false><<<blocks, kWarpsPerBlock * 32, 0, (cudaStream_t)stream>>>(
        feats, idx, row_id, out, rows, width, dummy, num_rows, F);
  return (int)cudaGetLastError();
}
