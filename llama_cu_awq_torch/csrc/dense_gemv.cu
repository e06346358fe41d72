// Dense GEMV for the lm_head: out[m, v] = sum_d x[m, d] * w[v, d].
//
// Replaces: llama_cu_awq_tpu/ops/pallas/dense_gemv.py, _gemv_2d
//   (dense_gemv), the bf16 kernel and the int8-row kernel.
//
// What bounds it on the H100: the weight bytes. At 7B the head is
//   32000 x 4096: 262 MB in bf16 (78 us at 3.35 TB/s), 131 MB plus 128 KB
//   of scales in int8, each byte used for one multiply-add per row of x.
//
// What the design does about it: one warp per vocab row, each lane
//   reading 16 bytes per load (8 bf16 or 16 int8 weights), a warp 512
//   contiguous bytes. x (up to MAX_ROWS rows per pass) sits in shared
//   memory as bf16, read by all 16 warps of the block. Operands go to f32
//   exactly (bf16 and int8 both widen without rounding), products are
//   summed in f32, and the int8 per-row scale multiplies the accumulated
//   sum, as dense_gemv.py:36-44 does.

#include "common.cuh"

namespace {

constexpr int WARPS = 16;
constexpr int MAX_ROWS = 8;

__device__ __forceinline__ float2 bf16x2_bits_to_float2(uint32_t u) {
  return make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xffff0000u));
}

// E weights per 16-byte vector; staged x chunks of E elements are padded
// to E + 2, so lanes reading chunks (E + 2) * 2 bytes apart (5 or 9 words,
// both odd) hit different banks.
template <bool INT8>
__global__ void __launch_bounds__(WARPS * 32)
dense_gemv_kernel(const __nv_bfloat16* __restrict__ x, int ldx,
                  const uint4* __restrict__ w,
                  const float* __restrict__ scale,
                  float* __restrict__ out, int m, int d, int v_rows,
                  int rows_per_pass) {
  constexpr int E = INT8 ? 16 : 8;
  constexpr int P = E + 2;
  extern __shared__ __align__(16) __nv_bfloat16 xs[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * WARPS + warp;
  const int nvec = d / E;
  const int row_elems = nvec * P;

  for (int r0 = 0; r0 < m; r0 += rows_per_pass) {
    const int mr = min(rows_per_pass, m - r0);
    __syncthreads();
    for (int i = threadIdx.x; i < mr * d; i += blockDim.x) {
      const int r = i / d;
      const int k = i - r * d;
      xs[r * row_elems + (k / E) * P + (k % E)] = x[(size_t)(r0 + r) * ldx + k];
    }
    __syncthreads();
    if (row < v_rows) {
      float acc[MAX_ROWS];
#pragma unroll
      for (int r = 0; r < MAX_ROWS; ++r) acc[r] = 0.0f;
      const uint4* wrow = w + (size_t)row * nvec;
      for (int vi = lane; vi < nvec; vi += 32) {
        const uint4 w4 = __ldg(wrow + vi);
        const uint32_t words[4] = {w4.x, w4.y, w4.z, w4.w};
        float wf[E];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if constexpr (INT8) {
#pragma unroll
            for (int i = 0; i < 4; ++i)
              wf[j * 4 + i] = static_cast<float>(
                  static_cast<int8_t>((words[j] >> (8 * i)) & 0xFFu));
          } else {
            const float2 f = bf16x2_bits_to_float2(words[j]);
            wf[2 * j] = f.x;
            wf[2 * j + 1] = f.y;
          }
        }
#pragma unroll
        for (int r = 0; r < MAX_ROWS; ++r) {
          if (r < mr) {
            const __nv_bfloat162* xr = reinterpret_cast<const __nv_bfloat162*>(
                xs + r * row_elems + vi * P);
            float a = acc[r];
#pragma unroll
            for (int i = 0; i < E / 2; ++i) {
              const float2 xf = __bfloat1622float2(xr[i]);
              a = fmaf(xf.x, wf[2 * i], a);
              a = fmaf(xf.y, wf[2 * i + 1], a);
            }
            acc[r] = a;
          }
        }
      }
#pragma unroll
      for (int r = 0; r < MAX_ROWS; ++r) {
        if (r < mr) {
          float total = warp_sum(acc[r]);
          if (lane == 0) {
            if constexpr (INT8) total *= scale[row];
            out[(size_t)(r0 + r) * v_rows + row] = total;
          }
        }
      }
    }
  }
}

template <bool INT8>
int launch(const void* x, int ldx, const void* w, const void* scale,
           void* out, int m, int d, int v_rows, int rows_per_pass,
           cudaStream_t stream) {
  constexpr int E = INT8 ? 16 : 8;
  const size_t smem = (size_t)rows_per_pass * (d / E) * (E + 2) *
                      sizeof(__nv_bfloat16);
  cudaError_t e = cudaFuncSetAttribute(
      dense_gemv_kernel<INT8>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((v_rows + WARPS - 1) / WARPS);
  dense_gemv_kernel<INT8><<<grid, WARPS * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), ldx,
      static_cast<const uint4*>(w), static_cast<const float*>(scale),
      static_cast<float*>(out), m, d, v_rows, rows_per_pass);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (m, d) bf16 with row stride ldx; w: (v_rows, d) bf16, or int8 when
// scale ((v_rows,) f32) is given; out: (m, v_rows) f32. Needs d % 16 == 0.
LLAMA_EXPORT int dense_gemv(const void* x, int ldx, const void* w,
                            const void* scale, void* out, int m, int d,
                            int v_rows, int rows_per_pass, void* stream) {
  if (d % 16 != 0 || rows_per_pass < 1 || rows_per_pass > MAX_ROWS)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (scale != nullptr)
    return launch<true>(x, ldx, w, scale, out, m, d, v_rows, rows_per_pass, st);
  return launch<false>(x, ldx, w, scale, out, m, d, v_rows, rows_per_pass, st);
}
