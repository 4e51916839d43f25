// The warp gather-sum shared by the neighbour-sum kernels K3 (spmm.cu,
// rows of a destination-sorted edge list; replaces roc_tpu/kernels/spmm.py
// csr_spmm_pallas) and K4 (ell_spmm.cu, rows of a degree bucket; replaces
// roc_tpu/kernels/ell_spmm.py ell_aggregate_pallas).
//
// What bounds it on the H100 (80GB HBM3, 700 W): the bytes of gathered rows
// and where they come from. At F = 256 one call gathers E * F * 4 = 114.4 GB
// (E = 111.7 M edges) out of a 238 MB feats, 4.8x the 50 MB L2. A warp per
// row walking all of F (the unsliced schedule) gathers at ~3.8 TB/s, the
// 3.35 TB/s memory rate plus what L2 happens to hold: most gathered lines
// come from HBM. Making the gathers hit L2 is what helps.
//
// Design: column slices, walked slice-major.  The kernels split F into
// slices of S columns (S = 16, 32, 64) and put the slice on blockIdx.y,
// the row blocks on x: the hardware dispatches x fastest, so the blocks of
// slice 0 run before slice 1, and the resident warps gather from one
// slice of feats, V * S * 4 bytes (29.8 MB at S = 32, V = 232,965), which
// L2 holds.  At F = 256 a row's 32-column segment is exactly one 128-byte
// line.  HBM then carries feats once per launch, out once, and the ids
// once per slice: ceil(F / S) passes over the ids are the price.  Sliced,
// the gathers run at ~7.8-8.0 TB/s at F = 256, twice the unsliced rate.
//
// One warp sums one (row, slice), in chunks of t <= 32 units (a unit is a
// float4 where F % 4 == 0 and both arrays are 16-byte aligned, else a
// float), each in G = 32 / t lane groups of t lanes: group g takes the
// neighbours j with j % G == g, so one load instruction serves G
// neighbours (S = 32 with float4s: 8 lanes cover a segment, 4 neighbours
// per instruction).  Each lane issues kUnroll loads before it adds them.
// The ids are loaded 32 at a time, one per lane, with a streaming hint
// (__ldcs), and broadcast by __shfl_sync; the sums are stored with
// __stcs: neither evicts the feature slice from L2.
//
// S = 0 is the unsliced instance, the warp-per-row schedule (lanes
// stride over all of F, a neighbour's row in back-to-back loads).  It
// stays the choice where feats fits L2 anyway: at F = 41 (38 MB, rows of
// 164 unaligned bytes) it beats every sliced instance, and a lane-grouped
// tail for columns 32-40 was slower than its mostly idle second load.
//
// Deterministic: a lane adds its neighbours in a fixed order, and the lane
// groups combine in a fixed tree (group g takes group g + off for off =
// 1, 2, 4, ... by __shfl_down_sync); no atomics, so a row's sum is the
// same bits on every launch.
//
// In every instance, ids outside [0, dummy) add nothing (the padding id is
// dummy == the feature row count), so no zero row is appended to feats;
// row offsets are 64-bit (V * F passes 2^31 at Reddit scale with F = 602).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace roc_gather {

constexpr int kWarpsPerBlock = 8;
constexpr int kVec = 2;     // accumulators per lane, unsliced
constexpr int kUnroll = 4;  // loads a lane issues before it adds them, sliced
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void add(float4& a, const float4 b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}
__device__ __forceinline__ void add(float& a, const float b) { a += b; }

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float4 zero<float4>() {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}
template <>
__device__ __forceinline__ float zero<float>() {
  return 0.f;
}

__device__ __forceinline__ float shfl_down(float v, int d) {
  return __shfl_down_sync(kFull, v, d);
}
__device__ __forceinline__ float4 shfl_down(float4 v, int d) {
  return make_float4(__shfl_down_sync(kFull, v.x, d),
                     __shfl_down_sync(kFull, v.y, d),
                     __shfl_down_sync(kFull, v.z, d),
                     __shfl_down_sync(kFull, v.w, d));
}

template <bool VEC>
struct Unit {
  using T = float;
  static constexpr int kFloats = 1;
};
template <>
struct Unit<true> {
  using T = float4;
  static constexpr int kFloats = 4;
};

// Whether the float4 path may run: F % 4 == 0 and both row arrays 16-byte
// aligned (then every row start, and every slice start, is too).
inline bool use_vec4(const float* feats, const float* out, int F) {
  return F % 4 == 0 && ((uintptr_t)feats % 16) == 0 &&
         ((uintptr_t)out % 16) == 0;
}

// The slice widths the kernels are instantiated for (0: unsliced).
inline bool valid_slice(int S) {
  return S == 0 || S == 16 || S == 32 || S == 64;
}

// Calls f(std::integral_constant<int, S>()) for a valid slice width S.
template <typename Fn>
void with_slice(int S, Fn&& f) {
  switch (S) {
    case 0: f(std::integral_constant<int, 0>()); break;
    case 16: f(std::integral_constant<int, 16>()); break;
    case 32: f(std::integral_constant<int, 32>()); break;
    default: f(std::integral_constant<int, 64>()); break;
  }
}

inline unsigned num_slices(int S, int F) {
  return S ? (unsigned)((F + S - 1) / S) : 1u;
}

// The unsliced instance (S = 0): orow[:] = sum over k < n of feats[ids[k], :]
// for ids in [0, dummy).  Lanes stride over F, each holding kVec
// accumulators (float4s where VEC, else floats), so one neighbour's row is
// kVec coalesced warp-wide loads issued back to back, and F = 256 fits one
// pass (wider F loops over column tiles).  All 32 lanes of the warp call it
// together (n is uniform across the warp).
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
            if (c < F)
              add(acc4[v], *reinterpret_cast<const float4*>(srow + c));
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

// The sliced instances (S = 16, 32, 64): orow[c0, c0 + W) = sum over k < n
// of feats[ids[k], c0 : c0 + W) for ids in [0, dummy), W <= S.  The slice
// is walked in chunks of t <= 32 units, each in G = 32 / t lane groups of
// t lanes: group g sums the neighbours j with j % G == g, kUnroll of its
// neighbours' loads issued before it adds them, and the groups combine in
// a fixed tree.  All 32 lanes call it together; VEC requires c0 and W to
// be multiples of 4.
template <bool VEC>
__device__ __forceinline__ void warp_slice_sum(const float* __restrict__ feats,
                                               const int* __restrict__ ids,
                                               int n, int dummy, int F, int c0,
                                               int W, float* __restrict__ orow,
                                               int lane) {
  using T = typename Unit<VEC>::T;
  constexpr int kF = Unit<VEC>::kFloats;
  const T* __restrict__ src = reinterpret_cast<const T*>(feats + c0);
  T* __restrict__ dst = reinterpret_cast<T*>(orow + c0);
  const long long ld = F / kF;  // row stride in units
  const int units = W / kF;
  for (int u0 = 0; u0 < units; u0 += 32) {
    const int t = min(units - u0, 32);  // units in this chunk
    const int G = 32 / t;               // lane groups
    const int g = lane / t;             // this lane's group
    const int u = u0 + lane - g * t;    // its unit
    const bool active = g < G;
    T acc = zero<T>();
    for (int j0 = 0; j0 < n; j0 += 32) {
      const int m = min(n - j0, 32);
      const int mine = lane < m ? __ldcs(ids + j0 + lane) : dummy;
      for (int k = 0; k < m; k += G * kUnroll) {
        int s[kUnroll];
        T v[kUnroll];
#pragma unroll
        for (int q = 0; q < kUnroll; ++q) {
          const int j = k + q * G + g;  // the group's q-th neighbour
          const int id = __shfl_sync(kFull, mine, j & 31);
          s[q] = active && j < m ? id : dummy;
          v[q] = (unsigned)s[q] < (unsigned)dummy ? src[s[q] * ld + u]
                                                  : zero<T>();
        }
#pragma unroll
        for (int q = 0; q < kUnroll; ++q)
          if ((unsigned)s[q] < (unsigned)dummy) add(acc, v[q]);
      }
    }
    // fixed tree over the groups: group 0 ends with the chunk's sum
    for (int off = 1; off < G; off <<= 1) {
      const T o = shfl_down(acc, off * t);
      if (g % (2 * off) == 0 && g + off < G) add(acc, o);
    }
    if (g == 0) __stcs(dst + u, acc);
  }
}

// The gather-sum of one (row, slice) for the instance of slice width S.
template <int S, bool VEC>
__device__ __forceinline__ void warp_gather_sum(const float* __restrict__ feats,
                                                const int* __restrict__ ids,
                                                int n, int dummy, int F,
                                                float* __restrict__ orow,
                                                int lane) {
  if constexpr (S == 0) {
    warp_row_sum<VEC>(feats, ids, n, dummy, F, orow, lane);
  } else {
    const int c0 = (int)blockIdx.y * S;
    warp_slice_sum<VEC>(feats, ids, n, dummy, F, c0, min(S, F - c0), orow,
                        lane);
  }
}

}  // namespace roc_gather
