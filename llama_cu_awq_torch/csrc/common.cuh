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

// D += A * B on the tensor cores, one warp: A 16x16 bf16 (row), B 16x8
// bf16 (col), D 16x8 f32. Fragments as the PTX ISA lays them out for
// mma.m16n8k16 (g = lane / 4, c = lane % 4):
//   a[0] = A[g][2c..2c+1]   a[1] = A[g+8][2c..]   a[2] = A[g][2c+8..]
//   a[3] = A[g+8][2c+8..]   b[0] = B[2c..2c+1][g] b[1] = B[2c+8..][g]
//   d[0..1] = D[g][2c..2c+1]  d[2..3] = D[g+8][2c..2c+1]
// Each 32-bit register holds two bf16, the lower index in the low half.
__device__ __forceinline__ void mma_bf16_16x8x16(float (&d)[4],
                                                 const uint32_t (&a)[4],
                                                 const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// two f32 -> one register of two bf16 (round to nearest even), lo first
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// A refused launch's error, with the runtime's last-error state cleared:
// a failed attribute call or launch also records its error there, and the
// next check after an unrelated launch (this library's or PyTorch's)
// would report it again.
inline int launch_refused(cudaError_t e) {
  cudaGetLastError();
  return static_cast<int>(e);
}

LLAMA_EXPORT const char* llama_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
