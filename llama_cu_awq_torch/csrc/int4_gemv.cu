// w4-g128 dequant GEMV with optional prologue and epilogue.
//
// Replaces: llama_cu_awq_tpu/ops/pallas/int4_matmul.py,
//   _int4_matmul_fused_2d (int4_matmul_fused) and _int4_matmul_2d
//   (int4_matmul). One source serves both: the prologue and epilogue are
//   runtime choices.
//
// What bounds it on the H100: the weight bytes. At batch 1 every packed
//   nibble, fp16 scale and uint8 zero is read once per token and used for
//   one multiply-add per row of x, far below the ~295 operations per byte
//   where the tensor cores would take over. At 7B the qkv projection reads
//   4096*12288/2 B of nibbles plus 12288*32*3 B of scales and zeros,
//   about 26 MB: 7.8 us at 3.35 TB/s.
//
// What the design does about it:
//   - The weights keep the checkpoint's own layout, qw (n_out, n_in/8)
//     int32: one output column's input rows are contiguous, so one warp
//     streams one column, each lane reading 16 bytes (32 nibbles, all in
//     one 128-row group) per load, 512 contiguous bytes per warp.
//   - Dequantization is (q - z) * s in f32, as the reference CUDA kernel
//     does (gpu_kernels.h:196-197). The TPU kernel's sum(x)*(z+128) bias
//     trick exists for the TPU's matrix unit and is not needed here.
//   - The effective x of a pass (up to MAX_ROWS rows) is staged once per
//     block into shared memory as bf16, with the prologue applied:
//     bf16(x*ss*norm_w) (rmsnorm apply) or bf16(silu(g)*u) (SwiGLU), the
//     staging of ops/linear.py:122-128 and int4_matmul.py:421-428.
//     Rows beyond MAX_ROWS take further passes over the weights; that is
//     the large-m case, whose speed is later work.
//   - The epilogue adds the residual in f32 and casts. The rms scale of
//     the output, ss' = rsqrt(mean(out^2) + eps), is a reduction over all
//     n_out columns, which blocks running in parallel cannot finish, so a
//     second small launch (rms_scale) computes it over the cast output.

#include "int4_gemv.cuh"

namespace {

using w4gemv::MAX_ROWS;
using w4gemv::WARPS;

// MODE 0: x as given; 1: x*ss*norm_w; 2: silu(x)*u
template <int MODE>
__global__ void __launch_bounds__(WARPS * 32)
int4_gemv_kernel(const __nv_bfloat16* __restrict__ x, int ldx,
                 const __nv_bfloat16* __restrict__ u, int ldu,
                 const float* __restrict__ ss,
                 const float* __restrict__ nw,
                 const uint4* __restrict__ qw,
                 const __half* __restrict__ scales,
                 const uint8_t* __restrict__ zeros,
                 const __nv_bfloat16* __restrict__ res,
                 void* __restrict__ out, int out_bf16,
                 int m, int n_in, int n_out, int groups,
                 int rows_per_pass) {
  extern __shared__ __align__(16) __nv_bfloat16 xs[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int col = blockIdx.x * WARPS + warp;
  const int nvec = n_in >> 5;        // 16-byte vectors per column
  const int row_elems = nvec * 34;   // padded staged row (see xs_index)

  for (int r0 = 0; r0 < m; r0 += rows_per_pass) {
    const int mr = min(rows_per_pass, m - r0);
    __syncthreads();  // the previous pass has finished reading xs
    w4gemv::stage_rows<MODE, false>(xs, x, ldx, u, ldu,
                                    ss != nullptr ? ss + r0 : nullptr, nw,
                                    r0, mr, n_in);
    __syncthreads();
    if (col < n_out) {
      float acc[MAX_ROWS];
      w4gemv::column_partials(acc, xs, row_elems, qw, scales, zeros, col,
                              nvec, groups, mr, lane);
      w4gemv::store_column(acc, mr, lane, r0, col, n_out, res, out,
                           out_bf16);
    }
  }
}

// ss[r] = 1 / sqrt(mean(out[r, :]^2) + eps), over the cast output row
__global__ void __launch_bounds__(w4gemv::RMS_THREADS)
rms_scale_kernel(const void* __restrict__ out, int out_bf16,
                 float* __restrict__ ss, int n, float eps) {
  __shared__ float part[w4gemv::RMS_THREADS / 32];
  const int r = blockIdx.x;
  const size_t elem = out_bf16 ? sizeof(__nv_bfloat16) : sizeof(float);
  const float s = w4gemv::rms_scale_row<false>(
      static_cast<const char*>(out) + (size_t)r * n * elem, out_bf16, n, eps,
      part);
  if (threadIdx.x == 0) ss[r] = s;
}

template <int MODE>
int launch_gemv(const void* x, int ldx, const void* u, int ldu,
                const void* ss, const void* nw, const void* qw,
                const void* scales, const void* zeros, const void* res,
                void* out, int out_bf16, int m, int n_in, int n_out,
                int groups, int rows_per_pass, cudaStream_t stream) {
  const size_t smem = w4gemv::staged_bytes(rows_per_pass, n_in);
  cudaError_t e = cudaFuncSetAttribute(
      int4_gemv_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((n_out + WARPS - 1) / WARPS);
  int4_gemv_kernel<MODE><<<grid, WARPS * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), ldx,
      static_cast<const __nv_bfloat16*>(u), ldu,
      static_cast<const float*>(ss), static_cast<const float*>(nw),
      static_cast<const uint4*>(qw), static_cast<const __half*>(scales),
      static_cast<const uint8_t*>(zeros),
      static_cast<const __nv_bfloat16*>(res), out, out_bf16, m, n_in, n_out,
      groups, rows_per_pass);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (m, n_in) bf16, row stride ldx. u: SwiGLU up values (m, n_in) bf16,
// row stride ldu, or null. ss: (m,) f32 and nw: (n_in,) f32 for the
// rmsnorm-apply prologue, or null. qw: (n_out, n_in/8) int32; scales:
// (n_out, groups) fp16; zeros: (n_out, groups) uint8. res: (m, n_out)
// bf16 or null. out: (m, n_out), bf16 when out_bf16 else f32.
// Needs n_in % 32 == 0.
LLAMA_EXPORT int int4_gemv(const void* x, int ldx, const void* u, int ldu,
                           const void* ss, const void* nw, const void* qw,
                           const void* scales, const void* zeros,
                           const void* res, void* out, int out_bf16, int m,
                           int n_in, int n_out, int groups,
                           int rows_per_pass, void* stream) {
  if (n_in % 32 != 0 || rows_per_pass < 1 || rows_per_pass > MAX_ROWS)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (u != nullptr)
    return launch_gemv<2>(x, ldx, u, ldu, ss, nw, qw, scales, zeros, res,
                          out, out_bf16, m, n_in, n_out, groups,
                          rows_per_pass, st);
  if (ss != nullptr)
    return launch_gemv<1>(x, ldx, u, ldu, ss, nw, qw, scales, zeros, res,
                          out, out_bf16, m, n_in, n_out, groups,
                          rows_per_pass, st);
  return launch_gemv<0>(x, ldx, u, ldu, ss, nw, qw, scales, zeros, res, out,
                        out_bf16, m, n_in, n_out, groups, rows_per_pass, st);
}

// ss: (m,) f32 from out (m, n) bf16 or f32
LLAMA_EXPORT int rms_scale(const void* out, int out_bf16, void* ss, int m,
                           int n, float eps, void* stream) {
  rms_scale_kernel<<<m, w4gemv::RMS_THREADS, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      out, out_bf16, static_cast<float*>(ss), n, eps);
  return static_cast<int>(cudaGetLastError());
}
