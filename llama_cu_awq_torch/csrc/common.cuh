// Shared helpers for the port's kernels. Each .cu file is its own shared
// library with a plain C interface (bound with ctypes); every exported
// launcher returns the cudaError_t of its launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define LLAMA_EXPORT extern "C" __attribute__((visibility("default")))

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// bf16 round-to-nearest-even of an f32 value, returned as f32
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Shared-memory layout of a staged activation row: every 32-element chunk
// (one lane's 16-byte weight vector covers 32 int4 rows) is followed by 2
// pad elements, so the 32 lanes of a warp, which read chunks 34 elements
// (17 words) apart, hit 32 different banks.
__device__ __forceinline__ int xs_index(int k) {
  return (k >> 5) * 34 + (k & 31);
}

LLAMA_EXPORT const char* llama_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
