// The warp gather-sum shared by the neighbour-sum kernels K3 (spmm.cu,
// rows of a destination-sorted edge list; replaces roc_tpu/kernels/spmm.py
// csr_spmm_pallas) and K4 (ell_spmm.cu, rows of a degree bucket; replaces
// roc_tpu/kernels/ell_spmm.py ell_aggregate_pallas).
//
// What bounds it on the H100 (80GB HBM3, 700 W): the rate at which it
// gathers row segments, E * F * sizeof(E) bytes a call (114.4 GB at F =
// 256 in fp32, E = 111.7 M edges, out of a 238 MB feats, 4.8x the 50 MB
// L2).  The ceiling, measured (chip_smoke.py --gather-race,
// gather_ceiling: K4 at F = 256 fp32, slice 32, one bucket of 512 ids a
// row over V = 232,965 rows): 7.8 TB/s with ids uniform over V and the
// same with sequential ids (whose 29.8 MB slice L2 holds too, so neither
// reads HBM for most segments), 13.8-14.5 TB/s when the ids fall in 128
// rows that L1 holds.  So the L2-to-SM rate bounds it, not the rate of
// issuing loads; the bound that counts each input byte once is 20-30x
// out of reach for a gather of random rows.  The sliced instances over
// rows of 16-byte units gather at that ceiling (7.5-7.9 TB/s at F = 256
// in fp32 and bf16, and at the ring hop).
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
// j % G == g, so one load instruction serves G neighbours.  A unit is the
// widest of 16, 8 and 4 bytes on which every row of both arrays starts
// (unit_bytes: the lowest set bit of F * sizeof(E) and of the two
// addresses), else one element: fp32 rows of 2,408 bytes (F = 602) move
// as 8-byte units, bf16 rows of 1,204 as 4-byte ones, and F = 41 (164
// bytes in fp32, 82 in bf16) one element a lane.  Units narrower than 16
// bytes are what closes most of the unaligned widths' gap: at F = 602 the
// 8-byte units took K3's walk chunk from 0.66 to 0.41 ms and K4 from 68.7
// to 44.1 ms (fp32) and from 65.3 to 22.6 ms (bf16), on the H100 above.
// Two designs that move such rows as aligned 16-byte units lost to it:
// realigning them in registers (each lane's next unit by __shfl_down_sync,
// a funnel shift at the row's own offset; 3.15 TB/s at F = 41 against the
// element path's 5.4, 2.8 at F = 602 unsliced) and copying them into
// shared memory by asynchronous bulk copies, an mbarrier a stage (1.3-5.0
// TB/s across the kernel table's shapes, 3.4 on the ceiling's bucket:
// the SM's rate of issuing copies and adds; its best, 0.547 ms at the
// walk's chunk, is slower than the 8-byte units').  Each lane issues kUnroll
// loads before it adds them.  The ids are loaded 32 at a time, one per
// lane, with a streaming hint (__ldcs), and broadcast by __shfl_sync; the
// sums are stored with __stcs: neither evicts the feature slice from L2.
//
// S = 0 is the unsliced instance, the warp-per-row schedule (lanes
// stride over all of F, a neighbour's row in back-to-back loads).  It
// stays the choice where feats fits L2 anyway (F <= 64: at F = 41 it
// beats every sliced instance, and a lane-grouped tail for columns 32-40
// was slower than its mostly idle second load) and for rows of units
// narrower than 8 bytes (at F = 602, one-element fp32 units: 45.2 ms
// unsliced against 68.7-84.0 sliced; 4-byte bf16 units: 22.6 against
// 35.7-56.6).  Over 8-byte units it loses (88.0 ms at F = 602: its
// 128-column tile of V rows, 119 MB, is more than L2 holds).
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

// N fp32 accumulators: the sum of one unit of 2N bf16 bytes
template <int N>
struct Floats {
  float v[N];
};

// A unit of the gather: Raw is what one lane loads (and stores), Acc its
// fp32 sum.  add() adds a loaded unit, combine() a lane's sum to another's,
// store() / store_cs() write a sum (the latter with the streaming hint).
// B is the unit's bytes: 16, 8, 4, or one element (sizeof(E)).
template <typename E, int B>
struct Unit;

template <>
struct Unit<float, 4> {
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

// fp32, 8 bytes: 2 columns
template <>
struct Unit<float, 8> {
  using Raw = float2;
  using Acc = float2;
  static constexpr int kCols = 2;
  static __device__ __forceinline__ Raw zero_raw() {
    return make_float2(0.f, 0.f);
  }
  static __device__ __forceinline__ Acc zero() { return zero_raw(); }
  static __device__ __forceinline__ void add(Acc& a, const Raw b) {
    a.x += b.x;
    a.y += b.y;
  }
  static __device__ __forceinline__ void combine(Acc& a, const Acc b) {
    add(a, b);
  }
  static __device__ __forceinline__ Acc shfl_down(const Acc a, int d) {
    return make_float2(__shfl_down_sync(kFull, a.x, d),
                       __shfl_down_sync(kFull, a.y, d));
  }
  static __device__ __forceinline__ void store(Raw* p, const Acc a) {
    *p = a;
  }
  static __device__ __forceinline__ void store_cs(Raw* p, const Acc a) {
    __stcs(p, a);
  }
};

// fp32, 16 bytes: 4 columns
template <>
struct Unit<float, 16> {
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
struct Unit<__nv_bfloat16, 2> {
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

// bf16, 4 and 8 bytes: 2 and 4 columns, element k in the k/2-th word (low
// half first)
template <>
struct Unit<__nv_bfloat16, 4> {
  using Raw = unsigned;
  using Acc = Floats<2>;
  static constexpr int kCols = 2;
  static __device__ __forceinline__ Raw zero_raw() { return 0u; }
  static __device__ __forceinline__ Acc zero() { return Acc{{0.f, 0.f}}; }
  static __device__ __forceinline__ void add(Acc& a, const Raw b) {
    a.v[0] += roc_bf16::lo(b);
    a.v[1] += roc_bf16::hi(b);
  }
  static __device__ __forceinline__ void combine(Acc& a, const Acc b) {
    a.v[0] += b.v[0];
    a.v[1] += b.v[1];
  }
  static __device__ __forceinline__ Acc shfl_down(const Acc a, int d) {
    return Acc{{__shfl_down_sync(kFull, a.v[0], d),
                __shfl_down_sync(kFull, a.v[1], d)}};
  }
  static __device__ __forceinline__ void store(Raw* p, const Acc a) {
    *p = roc_bf16::pack2(a.v[0], a.v[1]);
  }
  static __device__ __forceinline__ void store_cs(Raw* p, const Acc a) {
    __stcs(p, roc_bf16::pack2(a.v[0], a.v[1]));
  }
};

template <>
struct Unit<__nv_bfloat16, 8> {
  using Raw = uint2;
  using Acc = Floats<4>;
  static constexpr int kCols = 4;
  static __device__ __forceinline__ Raw zero_raw() {
    return make_uint2(0u, 0u);
  }
  static __device__ __forceinline__ Acc zero() {
    return Acc{{0.f, 0.f, 0.f, 0.f}};
  }
  static __device__ __forceinline__ void add(Acc& a, const Raw b) {
    a.v[0] += roc_bf16::lo(b.x);
    a.v[1] += roc_bf16::hi(b.x);
    a.v[2] += roc_bf16::lo(b.y);
    a.v[3] += roc_bf16::hi(b.y);
  }
  static __device__ __forceinline__ void combine(Acc& a, const Acc b) {
#pragma unroll
    for (int k = 0; k < 4; ++k) a.v[k] += b.v[k];
  }
  static __device__ __forceinline__ Acc shfl_down(const Acc a, int d) {
    Acc o;
#pragma unroll
    for (int k = 0; k < 4; ++k) o.v[k] = __shfl_down_sync(kFull, a.v[k], d);
    return o;
  }
  static __device__ __forceinline__ Raw pack(const Acc a) {
    return make_uint2(roc_bf16::pack2(a.v[0], a.v[1]),
                      roc_bf16::pack2(a.v[2], a.v[3]));
  }
  static __device__ __forceinline__ void store(Raw* p, const Acc a) {
    *p = pack(a);
  }
  static __device__ __forceinline__ void store_cs(Raw* p, const Acc a) {
    __stcs(p, pack(a));
  }
};

// bf16, 16 bytes: 8 columns
template <>
struct Unit<__nv_bfloat16, 16> {
  using Raw = uint4;
  using Acc = Floats<8>;
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

// The widest unit, 16, 8 or 4 bytes or one element, on which every row of
// both arrays starts: the lowest set bit of the row bytes and the two
// addresses, at most 16 (then every slice start, a multiple of 16 bytes
// into its row, is on a unit too).
template <typename E>
inline int unit_bytes(const E* feats, const E* out, int F) {
  const uintptr_t a = (uintptr_t)feats | (uintptr_t)out |
                      (uintptr_t)F * sizeof(E) | (uintptr_t)16;
  return (int)(a & (~a + 1));
}

// Calls f(std::integral_constant<int, B>()) for the unit bytes B of
// unit_bytes().
template <typename E, typename Fn>
void with_unit(int B, Fn&& f) {
  switch (B) {
    case 16: f(std::integral_constant<int, 16>()); break;
    case 8: f(std::integral_constant<int, 8>()); break;
    case 4: f(std::integral_constant<int, 4>()); break;
    default:
      if constexpr (sizeof(E) == 2) f(std::integral_constant<int, 2>());
      break;
  }
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
template <typename E, int B>
__device__ __forceinline__ void warp_row_sum(const E* __restrict__ feats,
                                             const int* __restrict__ ids,
                                             int n, int dummy, int F,
                                             E* __restrict__ orow, int lane) {
  using U = Unit<E, B>;
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
// groups combine in a fixed tree.  All 32 lanes call it together; c0 and
// W are multiples of the unit's columns.
template <typename E, int B>
__device__ __forceinline__ void warp_slice_sum(const E* __restrict__ feats,
                                               const int* __restrict__ ids,
                                               int n, int dummy, int F, int c0,
                                               int W, E* __restrict__ orow,
                                               int lane) {
  using U = Unit<E, B>;
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
template <typename E, int S, int B>
__device__ __forceinline__ void warp_gather_sum(const E* __restrict__ feats,
                                                const int* __restrict__ ids,
                                                int n, int dummy, int F,
                                                E* __restrict__ orow,
                                                int lane) {
  if constexpr (S == 0) {
    warp_row_sum<E, B>(feats, ids, n, dummy, F, orow, lane);
  } else {
    const int c0 = (int)blockIdx.y * S;
    warp_slice_sum<E, B>(feats, ids, n, dummy, F, c0, min(S, F - c0), orow,
                           lane);
  }
}

}  // namespace roc_gather
