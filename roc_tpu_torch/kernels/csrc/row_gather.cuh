// The warp-per-row gather-sum shared by the neighbour-sum kernels K3
// (spmm.cu, rows of a destination-sorted edge list) and K4 (ell_spmm.cu,
// rows of a degree bucket).
//
// One warp sums the feature rows of n source ids and writes the sum once:
// - the ids are loaded 32 at a time, one per lane (one coalesced load per
//   32 neighbours), and broadcast with __shfl_sync;
// - lanes stride over F: each lane holds kVec float4 accumulators (VEC: F %
//   4 == 0 and 16-byte aligned rows) or kVec floats (otherwise), so one
//   neighbour's row is one coalesced warp-wide load, and F = 256 fits one
//   pass (wider F loops over column tiles);
// - ids outside [0, dummy) add nothing (the padding id is dummy == the
//   feature row count), so no zero row has to be appended to feats;
// - the sum is kept in fp32 registers in id order and written straight to
//   its output row: no atomics, so the result is deterministic.
// Row offsets are 64-bit (V * F passes 2^31 at Reddit scale with F = 602).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace roc_gather {

constexpr int kWarpsPerBlock = 8;
constexpr int kVec = 2;  // accumulators per lane

__device__ __forceinline__ void add4(float4& a, const float4 b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

// Whether the float4 path may run: F % 4 == 0 and both row arrays 16-byte
// aligned (then every row start is too).
inline bool use_vec4(const float* feats, const float* out, int F) {
  return F % 4 == 0 && ((uintptr_t)feats % 16) == 0 &&
         ((uintptr_t)out % 16) == 0;
}

// orow[:] = sum over k < n of feats[ids[k], :] for ids in [0, dummy); all
// 32 lanes of the warp call it together (n is uniform across the warp).
template <bool VEC>
__device__ __forceinline__ void warp_row_sum(const float* __restrict__ feats,
                                             const int* __restrict__ ids,
                                             int n, int dummy, int F,
                                             float* __restrict__ orow,
                                             int lane) {
  constexpr int kTile = VEC ? kVec * 32 * 4 : kVec * 32;
  for (int c0 = 0; c0 < F; c0 += kTile) {
    float4 acc4[kVec];
    float acc1[kVec];
#pragma unroll
    for (int v = 0; v < kVec; ++v) {
      acc4[v] = make_float4(0.f, 0.f, 0.f, 0.f);
      acc1[v] = 0.f;
    }
    for (int j0 = 0; j0 < n; j0 += 32) {
      const int mine = j0 + lane < n ? ids[j0 + lane] : dummy;
      const int m = n - j0 < 32 ? n - j0 : 32;
#pragma unroll 4
      for (int k = 0; k < m; ++k) {
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

}  // namespace roc_gather
