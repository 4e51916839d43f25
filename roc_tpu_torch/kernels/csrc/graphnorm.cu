// Row-scale kernels of the GCN normalization chain, fp32.
//
// Replaces roc_tpu/kernels/graphnorm.py:
//   indegree_norm_pallas (_norm_kernel):   out[v,:] = x[v,:] * d(deg[v])
//   scale_act_pallas (_scale_act_kernel):  out[v,:] = act(x[v,:] * s[v])
// with d(deg) = deg > 0 ? 1/sqrt(max(deg, 1)) : 0 and act in {none, relu}.
//
// Bound on the H100: bytes.  Each element is read once and written once
// with one multiply, 0.25 FLOP per byte against the card's ~20 FLOP/byte
// fp32 balance, so the best time is 8*V*F bytes over 3.35 TB/s.  The
// design spends nothing but the streams: a grid-stride loop over the
// flat [V*F] array, 16-byte float4 loads and stores when F % 4 == 0 and
// the pointers are 16-byte aligned (scalar otherwise), one scale load per
// element that the L1 serves to all threads of a row.  The TPU kernel's
// 1024-row VMEM tiles have no counterpart: there is no scratch to stage.
//
// d is 1.0f / sqrtf(deg): both correctly rounded without fast-math, so it
// equals the plain PyTorch version (ops/norm.py inv_sqrt_degree) bit for
// bit, and so does each product.

#include <cuda_runtime.h>
#include <stdint.h>

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

// Idx is the flat index type: 32-bit whenever the array allows it, so the
// row division i / f is a 32-bit one
template <bool FROM_DEG, bool RELU, typename Idx>
__global__ void row_scale_vec4(const float4* __restrict__ x,
                               const int* __restrict__ deg,
                               const float* __restrict__ scale,
                               float4* __restrict__ out, Idx n4, Idx f4) {
  const Idx stride = (Idx)gridDim.x * blockDim.x;
  for (Idx i = (Idx)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += stride) {
    const float s = row_scale<FROM_DEG>(deg, scale, i / f4);
    float4 v = x[i];
    v.x *= s;
    v.y *= s;
    v.z *= s;
    v.w *= s;
    if (RELU) {
      v.x = relu(v.x);
      v.y = relu(v.y);
      v.z = relu(v.z);
      v.w = relu(v.w);
    }
    out[i] = v;
  }
}

template <bool FROM_DEG, bool RELU, typename Idx>
__global__ void row_scale_scalar(const float* __restrict__ x,
                                 const int* __restrict__ deg,
                                 const float* __restrict__ scale,
                                 float* __restrict__ out, Idx n, Idx f) {
  const Idx stride = (Idx)gridDim.x * blockDim.x;
  for (Idx i = (Idx)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    float v = x[i] * row_scale<FROM_DEG>(deg, scale, i / f);
    out[i] = RELU ? relu(v) : v;
  }
}

constexpr int kThreads = 256;
// 132 SMs x 8 blocks of 256 threads fill the card; larger arrays loop
constexpr long long kMaxBlocks = 132 * 8;

template <bool FROM_DEG, bool RELU, typename Idx>
void launch_idx(const float* x, const int* deg, const float* scale,
                float* out, bool vec, long long items, int F, unsigned blocks,
                cudaStream_t stream) {
  if (vec) {
    row_scale_vec4<FROM_DEG, RELU, Idx><<<blocks, kThreads, 0, stream>>>(
        reinterpret_cast<const float4*>(x), deg, scale,
        reinterpret_cast<float4*>(out), (Idx)items, (Idx)(F / 4));
  } else {
    row_scale_scalar<FROM_DEG, RELU, Idx><<<blocks, kThreads, 0, stream>>>(
        x, deg, scale, out, (Idx)items, (Idx)F);
  }
}

template <bool FROM_DEG, bool RELU>
int launch(const float* x, const int* deg, const float* scale, float* out,
           long long rows, int F, cudaStream_t stream) {
  const long long n = rows * (long long)F;
  if (n == 0) return (int)cudaGetLastError();
  const bool vec = F % 4 == 0 && ((uintptr_t)x % 16) == 0 &&
                   ((uintptr_t)out % 16) == 0;
  const long long items = vec ? n / 4 : n;
  long long blocks = (items + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  // the grid-stride loop's last step may pass items by one stride
  if (items + (long long)blocks * kThreads < 0xffffffffLL)
    launch_idx<FROM_DEG, RELU, unsigned>(x, deg, scale, out, vec, items, F,
                                         (unsigned)blocks, stream);
  else
    launch_idx<FROM_DEG, RELU, long long>(x, deg, scale, out, vec, items, F,
                                          (unsigned)blocks, stream);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int roc_indegree_norm_f32(const float* x, const int* in_degree,
                                     float* out, long long rows, int F,
                                     void* stream) {
  return launch<true, false>(x, in_degree, nullptr, out, rows, F,
                             (cudaStream_t)stream);
}

extern "C" int roc_scale_act_f32(const float* x, const float* scale,
                                 float* out, long long rows, int F,
                                 int act_relu, void* stream) {
  if (act_relu)
    return launch<false, true>(x, nullptr, scale, out, rows, F,
                               (cudaStream_t)stream);
  return launch<false, false>(x, nullptr, scale, out, rows, F,
                              (cudaStream_t)stream);
}

extern "C" const char* roc_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
