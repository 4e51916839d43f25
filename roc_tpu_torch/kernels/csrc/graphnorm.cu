// Row-scale kernels of the GCN normalization chain, fp32 and bf16.
//
// Replaces roc_tpu/kernels/graphnorm.py:
//   indegree_norm_pallas (_norm_kernel):   out[v,:] = x[v,:] * d(deg[v])
//   scale_act_pallas (_scale_act_kernel):  out[v,:] = act(x[v,:] * s[v])
// with d(deg) = deg > 0 ? 1/sqrt(max(deg, 1)) : 0 and act in {none, relu},
// and a masked form of the first for the relu backward of the fused chain:
//   out[v,:] = (y[v,:] > 0 ? g[v,:] : 0) * d(deg[v])
// a select, as jax.nn.relu's VJP is, so a NaN or inf in g where y <= 0
// gives 0.  x, g, y and out are fp32 or bf16 (the TPU kernels' x.dtype);
// deg is int32 and s fp32 in both, and the math is fp32: a bf16 element is
// widened exactly, scaled, activated and rounded once to bf16 (round to
// nearest even, as the TPU kernels' final astype and PyTorch's cast).
//
// Bound on the H100: bytes.  Each element is read once and written once
// with one multiply, 0.25 FLOP per byte in fp32 (0.5 in bf16) against the
// card's ~20 FLOP/byte fp32 balance, so the best time is the arrays' bytes
// over 3.35 TB/s.  The design spends nothing but the streams, with one
// schedule at every width F, in both dtypes:
// - a thread owns 16-byte units (4 fp32 or 8 bf16) of the flat [V*F]
//   array, and keeps kUnroll of them in flight before it computes;
// - a unit spans at most two rows when F >= its element count, so it takes
//   one or two scale values; the row of an element comes from a
//   multiply-high by the host's ceil(2^64 / F), not a divide;
// - the units are cut at out's 16-byte boundaries: the elements before the
//   first (a scalar head) and after the last whole unit (a scalar tail)
//   take one element a thread; an input whose 16-byte phase differs from
//   out's is read with element-sized loads, the stores stay 16 bytes;
// - F below a unit's element count computes each element's row;
// - the grid is as many blocks as fit on the card at once (occupancy times
//   the SM count), striding over the units.
// The TPU kernel's 1024-row VMEM tiles have no counterpart: there is no
// scratch to stage.
//
// d is 1.0f / sqrtf(deg): both correctly rounded without fast-math, so it
// equals the plain PyTorch version (ops/norm.py inv_sqrt_degree) bit for
// bit, and so does each element (one product, one rounding to bf16); each
// element is computed alone, so every launch gives the same bits.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16.cuh"

namespace {

using u64 = unsigned long long;

// what a kernel computes from an element (and the relu output y)
enum Op { kNorm, kNormMasked, kScale, kScaleRelu };

constexpr int kThreads = 256;
constexpr int kUnroll = 4;  // units a thread loads before it computes

__device__ __forceinline__ float inv_sqrt_deg(int deg) {
  return deg > 0 ? 1.0f / sqrtf((float)(deg > 1 ? deg : 1)) : 0.0f;
}

// relu that keeps NaN (as jnp.maximum and torch.relu do)
__device__ __forceinline__ float relu(float v) { return v < 0.0f ? 0.0f : v; }

struct Args {
  const void* x;     // x, or g for kNormMasked
  const void* y;     // the relu output (kNormMasked), else unused
  const int* deg;    // kNorm, kNormMasked
  const float* scale;  // kScale, kScaleRelu
  void* out;
  u64 head;   // elements before out's first 16-byte boundary
  u64 units;  // whole 16-byte units of out after the head
  u64 tail;   // elements after the last unit (fewer than a unit's)
  u64 magic;  // ceil(2^64 / F); 0 for F == 1
  unsigned f;
};

// the row of flat element e: floor(e / F), exact for e * F < 2^64
__device__ __forceinline__ u64 row_of(u64 e, const Args& a) {
  return a.magic ? __umul64hi(e, a.magic) : e;
}

template <int OP>
__device__ __forceinline__ float row_scale(const Args& a, u64 row) {
  return (OP == kNorm || OP == kNormMasked) ? inv_sqrt_deg(__ldg(a.deg + row))
                                            : __ldg(a.scale + row);
}

template <int OP>
__device__ __forceinline__ float apply(float v, float y, float s) {
  if (OP == kNormMasked) v = y > 0.0f ? v : 0.0f;
  v *= s;
  return OP == kScaleRelu ? relu(v) : v;
}

// One element of E, and a 16-byte unit of E, widened to and narrowed from
// fp32; a unit travels as its raw bits (uint4).
template <typename E>
struct Elem;

template <>
struct Elem<float> {
  using Raw = unsigned;
  static constexpr int kN = 4;  // elements in a unit
  static __device__ __forceinline__ float get(Raw r) {
    return __uint_as_float(r);
  }
  static __device__ __forceinline__ Raw put(float f) {
    return __float_as_uint(f);
  }
  static __device__ __forceinline__ void unpack(const uint4 v, float* f) {
    f[0] = __uint_as_float(v.x);
    f[1] = __uint_as_float(v.y);
    f[2] = __uint_as_float(v.z);
    f[3] = __uint_as_float(v.w);
  }
  static __device__ __forceinline__ uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};

template <>
struct Elem<__nv_bfloat16> {
  using Raw = unsigned short;
  static constexpr int kN = 8;
  static __device__ __forceinline__ float get(Raw r) {
    return roc_bf16::widen(r);
  }
  static __device__ __forceinline__ Raw put(float f) {
    return roc_bf16::narrow(f);
  }
  static __device__ __forceinline__ void unpack(const uint4 v, float* f) {
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      f[2 * k] = roc_bf16::lo(w[k]);
      f[2 * k + 1] = roc_bf16::hi(w[k]);
    }
  }
  static __device__ __forceinline__ uint4 pack(const float* f) {
    return make_uint4(roc_bf16::pack2(f[0], f[1]), roc_bf16::pack2(f[2], f[3]),
                      roc_bf16::pack2(f[4], f[5]),
                      roc_bf16::pack2(f[6], f[7]));
  }
};

// The unit at p (kN elements of E) as raw bits: one 16-byte load when p is
// 16-byte aligned (WIDE), else one load per element.
template <typename E, bool WIDE>
__device__ __forceinline__ uint4 load_unit(const E* p) {
  using T = Elem<E>;
  if (WIDE) return __ldg(reinterpret_cast<const uint4*>(p));
  union {
    uint4 v;
    typename T::Raw r[T::kN];
  } u;
  const typename T::Raw* q = reinterpret_cast<const typename T::Raw*>(p);
#pragma unroll
  for (int k = 0; k < T::kN; ++k) u.r[k] = __ldg(q + k);
  return u.v;
}

// One element (the head and the tail)
template <typename E, int OP>
__device__ __forceinline__ void one_element(const Args& a, u64 e) {
  using T = Elem<E>;
  const auto* x = static_cast<const typename T::Raw*>(a.x);
  const auto* y = static_cast<const typename T::Raw*>(a.y);
  auto* out = static_cast<typename T::Raw*>(a.out);
  const float yv = OP == kNormMasked ? T::get(__ldg(y + e)) : 0.0f;
  out[e] = T::put(
      apply<OP>(T::get(__ldg(x + e)), yv, row_scale<OP>(a, row_of(e, a))));
}

// The units: kUnroll units' loads (and their scale loads) in flight, then
// their products and stores.  MANY_ROWS (F < kN): each element finds its
// own row; otherwise a unit's elements before `split` take row r0's scale
// and the rest row r0 + 1's.
template <typename E, int OP, bool WIDE, bool MANY_ROWS>
__device__ __forceinline__ void units(const Args& a) {
  using T = Elem<E>;
  constexpr int kN = T::kN;
  const E* x = static_cast<const E*>(a.x) + a.head;
  const E* y = OP == kNormMasked ? static_cast<const E*>(a.y) + a.head
                                 : nullptr;
  uint4* out = reinterpret_cast<uint4*>(static_cast<E*>(a.out) + a.head);
  const u64 stride = (u64)gridDim.x * blockDim.x;
  for (u64 u0 = (u64)blockIdx.x * blockDim.x + threadIdx.x; u0 < a.units;
       u0 += kUnroll * stride) {
    uint4 xv[kUnroll], yv[kUnroll];
    float s0[kUnroll], s1[kUnroll];
    unsigned split[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const u64 u = u0 + k * stride;
      if (u < a.units) {
        xv[k] = load_unit<E, WIDE>(x + u * kN);
        if (OP == kNormMasked) yv[k] = load_unit<E, WIDE>(y + u * kN);
        if (!MANY_ROWS) {
          const u64 e0 = a.head + u * kN;
          const u64 r0 = row_of(e0, a);
          split[k] = (unsigned)((r0 + 1) * a.f - e0);
          s0[k] = row_scale<OP>(a, r0);
          s1[k] = split[k] < kN ? row_scale<OP>(a, r0 + 1) : s0[k];
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const u64 u = u0 + k * stride;
      if (u < a.units) {
        float f[kN], m[kN];
        T::unpack(xv[k], f);
        if (OP == kNormMasked) T::unpack(yv[k], m);
#pragma unroll
        for (int j = 0; j < kN; ++j) {
          const float s =
              MANY_ROWS ? row_scale<OP>(a, row_of(a.head + u * kN + j, a))
                        : (j < split[k] ? s0[k] : s1[k]);
          f[j] = apply<OP>(f[j], OP == kNormMasked ? m[j] : 0.0f, s);
        }
        out[u] = T::pack(f);
      }
    }
  }
}

template <typename E, int OP, bool WIDE>
__global__ void __launch_bounds__(kThreads) row_scale_kernel(const Args a) {
  if (a.f < Elem<E>::kN)
    units<E, OP, WIDE, true>(a);
  else
    units<E, OP, WIDE, false>(a);
  const u64 t = (u64)blockIdx.x * blockDim.x + threadIdx.x;
  if (t < a.head) one_element<E, OP>(a, t);
  if (t < a.tail)
    one_element<E, OP>(a, a.head + a.units * Elem<E>::kN + t);
}

// Blocks of an instance that fit on the card at once, found at its first
// launch (one card type a process)
template <typename E, int OP, bool WIDE>
int resident_blocks() {
  static const int blocks = [] {
    auto kernel = row_scale_kernel<E, OP, WIDE>;
    int dev = 0, sms = 0, per_sm = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, 0) !=
            cudaSuccess)
      return 0;
    return sms * per_sm;
  }();
  return blocks;
}

template <typename E, int OP, bool WIDE>
int launch_kernel(const Args& a, cudaStream_t stream) {
  const int cap = resident_blocks<E, OP, WIDE>();
  if (cap <= 0) return (int)cudaErrorInvalidConfiguration;
  const u64 per_block = (u64)kThreads * kUnroll;
  u64 blocks = (a.units + per_block - 1) / per_block;
  if (blocks < 1) blocks = 1;  // the head and the tail
  if (blocks > (u64)cap) blocks = cap;
  row_scale_kernel<E, OP, WIDE><<<(unsigned)blocks, kThreads, 0, stream>>>(
      a);
  return (int)cudaGetLastError();
}

// Cuts [rows * F] into head, units and tail at out's 16-byte boundaries,
// and launches with 16-byte loads where every input shares out's phase.
template <typename E, int OP>
int launch(const E* x, const E* y, const int* deg, const float* scale,
           E* out, long long rows, int F, cudaStream_t stream) {
  constexpr u64 kN = Elem<E>::kN;
  constexpr uintptr_t es = sizeof(E);
  if (rows < 0 || F < 0) return (int)cudaErrorInvalidValue;
  const u64 n = (u64)rows * (u64)F;
  if (n == 0) return (int)cudaGetLastError();
  // the multiply-high row is exact for every e < n only while n * F < 2^64
  if (n > ~0ull / (u64)F) return (int)cudaErrorInvalidValue;
  if ((uintptr_t)x % es || (uintptr_t)y % es || (uintptr_t)out % es)
    return (int)cudaErrorMisalignedAddress;
  Args a;
  a.x = x;
  a.y = y;
  a.deg = deg;
  a.scale = scale;
  a.out = out;
  a.f = (unsigned)F;
  a.magic = F == 1 ? 0 : ~0ull / (u64)F + 1;
  const uintptr_t phase = (uintptr_t)out % 16;
  a.head = (u64)((16 - phase) % 16 / es);
  if (a.head > n) a.head = n;
  a.units = (n - a.head) / kN;
  a.tail = n - a.head - a.units * kN;
  // every input at out's 16-byte phase: whole-unit loads
  const bool wide = (uintptr_t)x % 16 == phase &&
                    (OP != kNormMasked || (uintptr_t)y % 16 == phase);
  return wide ? launch_kernel<E, OP, true>(a, stream)
              : launch_kernel<E, OP, false>(a, stream);
}

template <typename E>
int scale_act(const E* x, const float* scale, E* out, long long rows, int F,
              int act_relu, void* stream) {
  if (act_relu)
    return launch<E, kScaleRelu>(x, nullptr, nullptr, scale, out, rows, F,
                                 (cudaStream_t)stream);
  return launch<E, kScale>(x, nullptr, nullptr, scale, out, rows, F,
                           (cudaStream_t)stream);
}

}  // namespace

extern "C" int roc_indegree_norm_f32(const float* x, const int* in_degree,
                                     float* out, long long rows, int F,
                                     void* stream) {
  return launch<float, kNorm>(x, nullptr, in_degree, nullptr, out, rows, F,
                              (cudaStream_t)stream);
}

extern "C" int roc_indegree_norm_bf16(const __nv_bfloat16* x,
                                      const int* in_degree,
                                      __nv_bfloat16* out, long long rows,
                                      int F, void* stream) {
  return launch<__nv_bfloat16, kNorm>(x, nullptr, in_degree, nullptr, out,
                                      rows, F, (cudaStream_t)stream);
}

extern "C" int roc_indegree_norm_masked_f32(const float* g, const float* y,
                                            const int* in_degree, float* out,
                                            long long rows, int F,
                                            void* stream) {
  return launch<float, kNormMasked>(g, y, in_degree, nullptr, out, rows, F,
                                    (cudaStream_t)stream);
}

extern "C" int roc_indegree_norm_masked_bf16(const __nv_bfloat16* g,
                                             const __nv_bfloat16* y,
                                             const int* in_degree,
                                             __nv_bfloat16* out,
                                             long long rows, int F,
                                             void* stream) {
  return launch<__nv_bfloat16, kNormMasked>(g, y, in_degree, nullptr, out,
                                            rows, F, (cudaStream_t)stream);
}

extern "C" int roc_scale_act_f32(const float* x, const float* scale,
                                 float* out, long long rows, int F,
                                 int act_relu, void* stream) {
  return scale_act(x, scale, out, rows, F, act_relu, stream);
}

extern "C" int roc_scale_act_bf16(const __nv_bfloat16* x, const float* scale,
                                  __nv_bfloat16* out, long long rows, int F,
                                  int act_relu, void* stream) {
  return scale_act(x, scale, out, rows, F, act_relu, stream);
}

extern "C" const char* roc_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
