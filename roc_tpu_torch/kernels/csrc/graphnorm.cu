// Row-scale kernels of the GCN normalization chain, fp32 and bf16.
//
// Replaces roc_tpu/kernels/graphnorm.py:
//   indegree_norm_pallas (_norm_kernel):   out[v,:] = x[v,:] * d(deg[v])
//   scale_act_pallas (_scale_act_kernel):  out[v,:] = act(x[v,:] * s[v])
// with d(deg) = deg > 0 ? 1/sqrt(max(deg, 1)) : 0 and act in {none, relu}.
// x and out are fp32 or bf16 (the TPU kernels' x.dtype); deg is int32 and
// s fp32 in both, and the math is fp32: a bf16 element is widened exactly,
// scaled, activated and rounded once to bf16 (round to nearest even, as
// the TPU kernels' final astype and PyTorch's cast).
//
// Bound on the H100: bytes.  Each element is read once and written once
// with one multiply, 0.25 FLOP per byte in fp32 (0.5 in bf16) against the
// card's ~20 FLOP/byte fp32 balance, so the best time is 2*V*F*sizeof(E)
// bytes over 3.35 TB/s.  The design spends nothing but the streams: a
// grid-stride loop over the flat [V*F] array, 16-byte loads and stores (a
// float4, or 8 bf16) when F fills whole 16-byte units and the pointers are
// 16-byte aligned (one element at a time otherwise), one scale load per
// unit that the L1 serves to all threads of a row.  The TPU kernel's
// 1024-row VMEM tiles have no counterpart: there is no scratch to stage.
//
// d is 1.0f / sqrtf(deg): both correctly rounded without fast-math, so it
// equals the plain PyTorch version (ops/norm.py inv_sqrt_degree) bit for
// bit, and so does each product (and its one rounding to bf16).

#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16.cuh"

namespace {

__device__ __forceinline__ float inv_sqrt_deg(int deg) {
  return deg > 0 ? 1.0f / sqrtf((float)(deg > 1 ? deg : 1)) : 0.0f;
}

// relu that keeps NaN (as jnp.maximum and torch.relu do)
__device__ __forceinline__ float relu(float v) { return v < 0.0f ? 0.0f : v; }

template <bool FROM_DEG>
__device__ __forceinline__ float row_scale(const int* deg, const float* scale,
                                           long long row) {
  return FROM_DEG ? inv_sqrt_deg(deg[row]) : scale[row];
}

template <bool RELU>
__device__ __forceinline__ float scaled(float v, float s) {
  v *= s;
  return RELU ? relu(v) : v;
}

// One element and one 16-byte unit of E, widened to and narrowed from fp32.
template <typename E>
struct Elem;

template <>
struct Elem<float> {
  using Raw = float;
  using Vec = float4;
  static constexpr int kN = 4;  // elements in a Vec
  static __device__ __forceinline__ float get(Raw r) { return r; }
  static __device__ __forceinline__ Raw put(float f) { return f; }
  static __device__ __forceinline__ void unpack(const Vec v, float* f) {
    f[0] = v.x;
    f[1] = v.y;
    f[2] = v.z;
    f[3] = v.w;
  }
  static __device__ __forceinline__ Vec pack(const float* f) {
    return make_float4(f[0], f[1], f[2], f[3]);
  }
};

template <>
struct Elem<__nv_bfloat16> {
  using Raw = unsigned short;
  using Vec = uint4;
  static constexpr int kN = 8;
  static __device__ __forceinline__ float get(Raw r) {
    return roc_bf16::widen(r);
  }
  static __device__ __forceinline__ Raw put(float f) {
    return roc_bf16::narrow(f);
  }
  static __device__ __forceinline__ void unpack(const Vec v, float* f) {
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      f[2 * k] = roc_bf16::lo(w[k]);
      f[2 * k + 1] = roc_bf16::hi(w[k]);
    }
  }
  static __device__ __forceinline__ Vec pack(const float* f) {
    return make_uint4(roc_bf16::pack2(f[0], f[1]), roc_bf16::pack2(f[2], f[3]),
                      roc_bf16::pack2(f[4], f[5]),
                      roc_bf16::pack2(f[6], f[7]));
  }
};

// Idx is the flat index type: 32-bit whenever the array allows it, so the
// row division i / fv is a 32-bit one
template <typename E, bool FROM_DEG, bool RELU, typename Idx>
__global__ void row_scale_vec(const typename Elem<E>::Vec* __restrict__ x,
                              const int* __restrict__ deg,
                              const float* __restrict__ scale,
                              typename Elem<E>::Vec* __restrict__ out, Idx nv,
                              Idx fv) {
  using T = Elem<E>;
  const Idx stride = (Idx)gridDim.x * blockDim.x;
  for (Idx i = (Idx)blockIdx.x * blockDim.x + threadIdx.x; i < nv;
       i += stride) {
    const float s = row_scale<FROM_DEG>(deg, scale, i / fv);
    float f[T::kN];
    T::unpack(x[i], f);
#pragma unroll
    for (int k = 0; k < T::kN; ++k) f[k] = scaled<RELU>(f[k], s);
    out[i] = T::pack(f);
  }
}

template <typename E, bool FROM_DEG, bool RELU, typename Idx>
__global__ void row_scale_scalar(const typename Elem<E>::Raw* __restrict__ x,
                                 const int* __restrict__ deg,
                                 const float* __restrict__ scale,
                                 typename Elem<E>::Raw* __restrict__ out,
                                 Idx n, Idx f) {
  using T = Elem<E>;
  const Idx stride = (Idx)gridDim.x * blockDim.x;
  for (Idx i = (Idx)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    out[i] = T::put(
        scaled<RELU>(T::get(x[i]), row_scale<FROM_DEG>(deg, scale, i / f)));
  }
}

constexpr int kThreads = 256;
// 132 SMs x 8 blocks of 256 threads fill the card; larger arrays loop
constexpr long long kMaxBlocks = 132 * 8;

template <typename E, bool FROM_DEG, bool RELU, typename Idx>
void launch_idx(const E* x, const int* deg, const float* scale, E* out,
                bool vec, long long items, int F, unsigned blocks,
                cudaStream_t stream) {
  using T = Elem<E>;
  if (vec) {
    row_scale_vec<E, FROM_DEG, RELU, Idx><<<blocks, kThreads, 0, stream>>>(
        reinterpret_cast<const typename T::Vec*>(x), deg, scale,
        reinterpret_cast<typename T::Vec*>(out), (Idx)items,
        (Idx)(F / T::kN));
  } else {
    row_scale_scalar<E, FROM_DEG, RELU, Idx><<<blocks, kThreads, 0, stream>>>(
        reinterpret_cast<const typename T::Raw*>(x), deg, scale,
        reinterpret_cast<typename T::Raw*>(out), (Idx)items, (Idx)F);
  }
}

template <typename E, bool FROM_DEG, bool RELU>
int launch(const E* x, const int* deg, const float* scale, E* out,
           long long rows, int F, cudaStream_t stream) {
  constexpr int kN = Elem<E>::kN;
  const long long n = rows * (long long)F;
  if (n == 0) return (int)cudaGetLastError();
  const bool vec = F % kN == 0 && ((uintptr_t)x % 16) == 0 &&
                   ((uintptr_t)out % 16) == 0;
  const long long items = vec ? n / kN : n;
  long long blocks = (items + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  // the grid-stride loop's last step may pass items by one stride
  if (items + (long long)blocks * kThreads < 0xffffffffLL)
    launch_idx<E, FROM_DEG, RELU, unsigned>(x, deg, scale, out, vec, items, F,
                                            (unsigned)blocks, stream);
  else
    launch_idx<E, FROM_DEG, RELU, long long>(x, deg, scale, out, vec, items,
                                             F, (unsigned)blocks, stream);
  return (int)cudaGetLastError();
}

template <typename E>
int scale_act(const E* x, const float* scale, E* out, long long rows, int F,
              int act_relu, void* stream) {
  if (act_relu)
    return launch<E, false, true>(x, nullptr, scale, out, rows, F,
                                  (cudaStream_t)stream);
  return launch<E, false, false>(x, nullptr, scale, out, rows, F,
                                 (cudaStream_t)stream);
}

}  // namespace

extern "C" int roc_indegree_norm_f32(const float* x, const int* in_degree,
                                     float* out, long long rows, int F,
                                     void* stream) {
  return launch<float, true, false>(x, in_degree, nullptr, out, rows, F,
                                    (cudaStream_t)stream);
}

extern "C" int roc_indegree_norm_bf16(const __nv_bfloat16* x,
                                      const int* in_degree,
                                      __nv_bfloat16* out, long long rows,
                                      int F, void* stream) {
  return launch<__nv_bfloat16, true, false>(x, in_degree, nullptr, out, rows,
                                            F, (cudaStream_t)stream);
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
