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
// slices of S columns (S = 16, 32, 64, 128) and put the slice on
// blockIdx.y, the row blocks on x: the hardware dispatches x fastest, so
// the blocks of slice 0 run before slice 1, and the resident warps gather
// from one slice of feats, V * S * sizeof(E) bytes (29.8 MB at S = 32 in
// fp32 or S = 64 in bf16, V = 232,965), which L2 holds.  At F = 256 a
// row's 32-column fp32 segment is exactly one 128-byte line.  HBM then
// carries feats once per launch, out once, and the ids once per slice:
// ceil(F / S) passes over the ids are the price.  Sliced, the fp32 gathers
// run at ~7.8-8.0 TB/s at F = 256, twice the unsliced rate.
//
// Element types E: float and __nv_bfloat16 (the JAX kernels' x.dtype).
// Both accumulate in fp32 registers; a bf16 sum is rounded to bf16 once,
// at the store (__float2bfloat16_rn, round to nearest even, as PyTorch's
// cast), so it is round_bf16(fp32 sum), what the plain version computes.
// bf16 halves the gathered bytes: E * F * 2 = 57.2 GB at F = 256.
//
// One warp sums one (row, slice), in chunks of t <= 32 units, each in
// G = 32 / t lane groups of t lanes: group g takes the neighbours j with
// j % G == g, so one load instruction serves G neighbours.  A unit is 16
// bytes where F fills whole units and both arrays are 16-byte aligned (a
// float4, or 8 bf16 unpacked into 8 fp32 accumulators), else one element
// (S = 32 in fp32: 8 lanes cover a segment, 4 neighbours per instruction).
// F = 41 in bf16 (82-byte rows, 2-byte aligned) takes the element path.
// Each lane issues kUnroll loads before it adds them.  The ids are loaded
// 32 at a time, one per lane, with a streaming hint (__ldcs), and
// broadcast by __shfl_sync; the sums are stored with __stcs: neither
// evicts the feature slice from L2.
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

#include "bf16.cuh"

namespace roc_gather {

constexpr int kWarpsPerBlock = 8;
constexpr int kVec = 2;     // accumulators per lane, unsliced
constexpr int kUnroll = 4;  // loads a lane issues before it adds them, sliced
constexpr unsigned kFull = 0xffffffffu;

// eight fp32 accumulators: the sum of one 16-byte unit of bf16
struct Float8 {
  float v[8];
};

// A unit of the gather: Raw is what one lane loads (and stores), Acc its
// fp32 sum.  add() adds a loaded unit, combine() a lane's sum to another's,
// store() / store_cs() write a sum (the latter with the streaming hint).
template <typename E, bool VEC>
struct Unit;

template <>
struct Unit<float, false> {
  using Raw = float;
  using Acc = float;
  static constexpr int kCols = 1;
  static __device__ __forceinline__ Raw zero_raw() { return 0.f; }
  static __device__ __forceinline__ Acc zero() { return 0.f; }
  static __device__ __forceinline__ void add(Acc& a, const Raw b) { a += b; }
  static __device__ __forceinline__ void combine(Acc& a, const Acc b) {
    a += b;
  }
  static __device__ __forceinline__ Acc shfl_down(const Acc a, int d) {
    return __shfl_down_sync(kFull, a, d);
  }
  static __device__ __forceinline__ void store(Raw* p, const Acc a) {
    *p = a;
  }
  static __device__ __forceinline__ void store_cs(Raw* p, const Acc a) {
    __stcs(p, a);
  }
};

template <>
struct Unit<float, true> {
  using Raw = float4;
  using Acc = float4;
  static constexpr int kCols = 4;
  static __device__ __forceinline__ Raw zero_raw() {
    return make_float4(0.f, 0.f, 0.f, 0.f);
  }
  static __device__ __forceinline__ Acc zero() { return zero_raw(); }
  static __device__ __forceinline__ void add(Acc& a, const Raw b) {
    a.x += b.x;
    a.y += b.y;
    a.z += b.z;
    a.w += b.w;
  }
  static __device__ __forceinline__ void combine(Acc& a, const Acc b) {
    add(a, b);
  }
  static __device__ __forceinline__ Acc shfl_down(const Acc a, int d) {
    return make_float4(__shfl_down_sync(kFull, a.x, d),
                       __shfl_down_sync(kFull, a.y, d),
                       __shfl_down_sync(kFull, a.z, d),
                       __shfl_down_sync(kFull, a.w, d));
  }
  static __device__ __forceinline__ void store(Raw* p, const Acc a) {
    *p = a;
  }
  static __device__ __forceinline__ void store_cs(Raw* p, const Acc a) {
    __stcs(p, a);
  }
};

// bf16, one element: the raw 16 bits, widened exactly to fp32
template <>
struct Unit<__nv_bfloat16, false> {
  using Raw = unsigned short;
  using Acc = float;
  static constexpr int kCols = 1;
  static __device__ __forceinline__ Raw zero_raw() { return 0; }
  static __device__ __forceinline__ Acc zero() { return 0.f; }
  static __device__ __forceinline__ void add(Acc& a, const Raw b) {
    a += roc_bf16::widen(b);
  }
  static __device__ __forceinline__ void combine(Acc& a, const Acc b) {
    a += b;
  }
  static __device__ __forceinline__ Acc shfl_down(const Acc a, int d) {
    return __shfl_down_sync(kFull, a, d);
  }
  static __device__ __forceinline__ void store(Raw* p, const Acc a) {
    *p = roc_bf16::narrow(a);
  }
  static __device__ __forceinline__ void store_cs(Raw* p, const Acc a) {
    __stcs(p, roc_bf16::narrow(a));
  }
};

// bf16, 16 bytes: 8 columns, element k in the k/2-th word (low half first)
template <>
struct Unit<__nv_bfloat16, true> {
  using Raw = uint4;
  using Acc = Float8;
  static constexpr int kCols = 8;
  static __device__ __forceinline__ Raw zero_raw() {
    return make_uint4(0u, 0u, 0u, 0u);
  }
  static __device__ __forceinline__ Acc zero() {
    Acc a;
#pragma unroll
    for (int k = 0; k < 8; ++k) a.v[k] = 0.f;
    return a;
  }
  static __device__ __forceinline__ void add(Acc& a, const Raw b) {
    a.v[0] += roc_bf16::lo(b.x);
    a.v[1] += roc_bf16::hi(b.x);
    a.v[2] += roc_bf16::lo(b.y);
    a.v[3] += roc_bf16::hi(b.y);
    a.v[4] += roc_bf16::lo(b.z);
    a.v[5] += roc_bf16::hi(b.z);
    a.v[6] += roc_bf16::lo(b.w);
    a.v[7] += roc_bf16::hi(b.w);
  }
  static __device__ __forceinline__ void combine(Acc& a, const Acc b) {
#pragma unroll
    for (int k = 0; k < 8; ++k) a.v[k] += b.v[k];
  }
  static __device__ __forceinline__ Acc shfl_down(const Acc a, int d) {
    Acc o;
#pragma unroll
    for (int k = 0; k < 8; ++k) o.v[k] = __shfl_down_sync(kFull, a.v[k], d);
    return o;
  }
  static __device__ __forceinline__ Raw pack(const Acc a) {
    return make_uint4(roc_bf16::pack2(a.v[0], a.v[1]),
                      roc_bf16::pack2(a.v[2], a.v[3]),
                      roc_bf16::pack2(a.v[4], a.v[5]),
                      roc_bf16::pack2(a.v[6], a.v[7]));
  }
  static __device__ __forceinline__ void store(Raw* p, const Acc a) {
    *p = pack(a);
  }
  static __device__ __forceinline__ void store_cs(Raw* p, const Acc a) {
    __stcs(p, pack(a));
  }
};

// Whether the 16-byte unit path may run: F fills whole units and both row
// arrays are 16-byte aligned (then every row start, and every slice
// start, is too).
template <typename E>
inline bool use_vec(const E* feats, const E* out, int F) {
  return F % Unit<E, true>::kCols == 0 && ((uintptr_t)feats % 16) == 0 &&
         ((uintptr_t)out % 16) == 0;
}

// The slice widths the kernels are instantiated for (0: unsliced).
inline bool valid_slice(int S) {
  return S == 0 || S == 16 || S == 32 || S == 64 || S == 128;
}

// Calls f(std::integral_constant<int, S>()) for a valid slice width S.
template <typename Fn>
void with_slice(int S, Fn&& f) {
  switch (S) {
    case 0: f(std::integral_constant<int, 0>()); break;
    case 16: f(std::integral_constant<int, 16>()); break;
    case 32: f(std::integral_constant<int, 32>()); break;
    case 64: f(std::integral_constant<int, 64>()); break;
    default: f(std::integral_constant<int, 128>()); break;
  }
}

inline unsigned num_slices(int S, int F) {
  return S ? (unsigned)((F + S - 1) / S) : 1u;
}

// The unsliced instance (S = 0): orow[:] = sum over k < n of feats[ids[k], :]
// for ids in [0, dummy).  Lanes stride over F, each holding kVec unit
// accumulators, so one neighbour's row is kVec coalesced warp-wide loads
// issued back to back, and F = 256 fits one pass (wider F loops over
// column tiles).  All 32 lanes of the warp call it together (n is uniform
// across the warp).
template <typename E, bool VEC>
__device__ __forceinline__ void warp_row_sum(const E* __restrict__ feats,
                                             const int* __restrict__ ids,
                                             int n, int dummy, int F,
                                             E* __restrict__ orow, int lane) {
  using U = Unit<E, VEC>;
  using Raw = typename U::Raw;
  constexpr int kTile = kVec * 32 * U::kCols;
  for (int c0 = 0; c0 < F; c0 += kTile) {
    typename U::Acc acc[kVec];
#pragma unroll
    for (int v = 0; v < kVec; ++v) acc[v] = U::zero();
    for (int j0 = 0; j0 < n; j0 += 32) {
      const int mine = j0 + lane < n ? ids[j0 + lane] : dummy;
      const int m = n - j0 < 32 ? n - j0 : 32;
#pragma unroll 4
      for (int k = 0; k < m; ++k) {
        const int s = __shfl_sync(0xffffffffu, mine, k);
        if ((unsigned)s >= (unsigned)dummy) continue;  // padding id
        const E* srow = feats + (long long)s * F;
#pragma unroll
        for (int v = 0; v < kVec; ++v) {
          const int c = c0 + (v * 32 + lane) * U::kCols;
          if (c < F)
            U::add(acc[v], *reinterpret_cast<const Raw*>(srow + c));
        }
      }
    }
#pragma unroll
    for (int v = 0; v < kVec; ++v) {
      const int c = c0 + (v * 32 + lane) * U::kCols;
      if (c < F) U::store(reinterpret_cast<Raw*>(orow + c), acc[v]);
    }
  }
}

// The sliced instances (S = 16, 32, 64, 128): orow[c0, c0 + W) = sum over
// k < n of feats[ids[k], c0 : c0 + W) for ids in [0, dummy), W <= S.  The
// slice is walked in chunks of t <= 32 units, each in G = 32 / t lane
// groups of t lanes: group g sums the neighbours j with j % G == g,
// kUnroll of its neighbours' loads issued before it adds them, and the
// groups combine in a fixed tree.  All 32 lanes call it together; VEC
// requires c0 and W to be multiples of the unit's columns.
template <typename E, bool VEC>
__device__ __forceinline__ void warp_slice_sum(const E* __restrict__ feats,
                                               const int* __restrict__ ids,
                                               int n, int dummy, int F, int c0,
                                               int W, E* __restrict__ orow,
                                               int lane) {
  using U = Unit<E, VEC>;
  using Raw = typename U::Raw;
  constexpr int kC = U::kCols;
  const Raw* __restrict__ src = reinterpret_cast<const Raw*>(feats + c0);
  Raw* __restrict__ dst = reinterpret_cast<Raw*>(orow + c0);
  const long long ld = F / kC;  // row stride in units
  const int units = W / kC;
  for (int u0 = 0; u0 < units; u0 += 32) {
    const int t = min(units - u0, 32);  // units in this chunk
    const int G = 32 / t;               // lane groups
    const int g = lane / t;             // this lane's group
    const int u = u0 + lane - g * t;    // its unit
    const bool active = g < G;
    typename U::Acc acc = U::zero();
    for (int j0 = 0; j0 < n; j0 += 32) {
      const int m = min(n - j0, 32);
      const int mine = lane < m ? __ldcs(ids + j0 + lane) : dummy;
      for (int k = 0; k < m; k += G * kUnroll) {
        int s[kUnroll];
        Raw v[kUnroll];
#pragma unroll
        for (int q = 0; q < kUnroll; ++q) {
          const int j = k + q * G + g;  // the group's q-th neighbour
          const int id = __shfl_sync(kFull, mine, j & 31);
          s[q] = active && j < m ? id : dummy;
          v[q] = (unsigned)s[q] < (unsigned)dummy ? src[s[q] * ld + u]
                                                  : U::zero_raw();
        }
#pragma unroll
        for (int q = 0; q < kUnroll; ++q)
          if ((unsigned)s[q] < (unsigned)dummy) U::add(acc, v[q]);
      }
    }
    // fixed tree over the groups: group 0 ends with the chunk's sum
    for (int off = 1; off < G; off <<= 1) {
      const typename U::Acc o = U::shfl_down(acc, off * t);
      if (g % (2 * off) == 0 && g + off < G) U::combine(acc, o);
    }
    if (g == 0) U::store_cs(dst + u, acc);
  }
}

// The gather-sum of one (row, slice) for the instance of slice width S.
template <typename E, int S, bool VEC>
__device__ __forceinline__ void warp_gather_sum(const E* __restrict__ feats,
                                                const int* __restrict__ ids,
                                                int n, int dummy, int F,
                                                E* __restrict__ orow,
                                                int lane) {
  if constexpr (S == 0) {
    warp_row_sum<E, VEC>(feats, ids, n, dummy, F, orow, lane);
  } else {
    const int c0 = (int)blockIdx.y * S;
    warp_slice_sum<E, VEC>(feats, ids, n, dummy, F, c0, min(S, F - c0), orow,
                           lane);
  }
}

}  // namespace roc_gather
