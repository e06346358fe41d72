// Shared helpers for the port's kernels. Each .cu file is its own shared
// library with a plain C interface (bound with ctypes); every exported
// launcher returns the cudaError_t of its launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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

// Activation types (--act-dtype), as the wrappers pass them at run time
// (ops/cuda/__init__.py DTYPE_CODES); 0 and 1 keep the meaning of the
// older out_bf16 flag.
constexpr int DT_F32 = 0;
constexpr int DT_BF16 = 1;
constexpr int DT_F16 = 2;

// an activation widened to f32 (exact for every type)
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

// an f32 value rounded to nearest even in T (XLA's astype)
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half_rn(v);
}

// element i of an activation array of type code dt, widened to f32;
// FROM_L2 reads through L2 only (ld.global.cg), for data the same kernel
// wrote before a grid barrier
template <bool FROM_L2>
__device__ __forceinline__ float load_dt(const void* p, size_t i, int dt) {
  if (dt == DT_BF16) {
    const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(p) + i;
    return __bfloat162float(FROM_L2 ? __ldcg(q) : *q);
  }
  if (dt == DT_F16) {
    const __half* q = static_cast<const __half*>(p) + i;
    return __half2float(FROM_L2 ? __ldcg(q) : *q);
  }
  const float* q = static_cast<const float*>(p) + i;
  return FROM_L2 ? __ldcg(q) : *q;
}

// v rounded to type code dt and stored at element i
__device__ __forceinline__ void store_dt(void* p, size_t i, int dt, float v) {
  if (dt == DT_BF16) {
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(v);
  } else if (dt == DT_F16) {
    static_cast<__half*>(p)[i] = __float2half_rn(v);
  } else {
    static_cast<float*>(p)[i] = v;
  }
}

// An activation type chosen at run time: ld_act and st_act then go by
// the type code; with a concrete T (bf16, __half, float) they compile to
// the plain typed access and ignore the code. A launcher instantiates
// its kernel for the concrete types it sees most (a run-time branch per
// element cost the epilogues up to 12 % on the H100) and Dyn for the
// rest.
struct Dyn {};

template <typename T, bool FROM_L2>
__device__ __forceinline__ float ld_act(const void* p, size_t i, int dt) {
  if constexpr (std::is_same_v<T, Dyn>) {
    return load_dt<FROM_L2>(p, i, dt);
  } else {
    const T* q = static_cast<const T*>(p) + i;
    return to_f32(FROM_L2 ? __ldcg(q) : *q);
  }
}

template <typename T>
__device__ __forceinline__ void st_act(void* p, size_t i, int dt, float v) {
  if constexpr (std::is_same_v<T, Dyn>) {
    store_dt(p, i, dt, v);
  } else {
    static_cast<T*>(p)[i] = from_f32<T>(v);
  }
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
