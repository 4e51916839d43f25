// bf16 <-> fp32 for the kernels' bf16 instances (graphnorm.cu and the
// gather-sum of row_gather.cuh), on the raw 16 bits: widening is exact
// (the bf16 bits are the high half of the fp32 ones), narrowing rounds to
// nearest even (__float2bfloat16_rn), as PyTorch's cast and the TPU
// kernels' astype do.

#pragma once

#include <cuda_bf16.h>

namespace roc_bf16 {

__device__ __forceinline__ float widen(unsigned short b) {
  return __uint_as_float((unsigned)b << 16);
}
// the low and high bf16 of a 32-bit word (element 2k, then 2k + 1)
__device__ __forceinline__ float lo(unsigned w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float hi(unsigned w) {
  return __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ unsigned short narrow(float f) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(f));
}
__device__ __forceinline__ unsigned pack2(float l, float h) {
  return (unsigned)narrow(l) | ((unsigned)narrow(h) << 16);
}

}  // namespace roc_bf16
