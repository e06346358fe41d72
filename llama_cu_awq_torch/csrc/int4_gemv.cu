// w4-g128 dequant GEMV with optional prologue and epilogue.
//
// Replaces: llama_cu_awq_tpu/ops/pallas/int4_matmul.py,
//   _int4_matmul_fused_2d (int4_matmul_fused) and _int4_matmul_2d
//   (int4_matmul). One source serves both: the prologue and epilogue are
//   runtime choices.
//
// What bounds it on the H100: the weight bytes. Every packed nibble, fp16
//   scale and uint8 zero is read once per launch for up to MAX_ROWS rows of
//   x, far below the ~295 operations per byte where the tensor cores would
//   take over. At 7B the qkv projection reads 4096*12288/2 B of nibbles
//   plus 12288*32*3 B of scales and zeros, about 26 MB: 7.8 us at
//   3.35 TB/s, at m=1 as at m=8.
//
// What the design does about it:
//   - Every output column comes from int4_gemv.cuh's tensor-core column
//     tile (mma.sync m16n8k16, 16 weight columns in M, the pass's rows of
//     x in N, the raw codes exact in bf16 and the group's zero and scale
//     applied in f32), for every m from 1 to MAX_ROWS: no per-weight
//     dequantize and no per-row multiply-add loop on the CUDA cores, so the
//     time follows the weight bytes, not the rows. The weights keep the
//     checkpoint's own layout, qw (n_out, n_in/8) int32.
//   - The effective x of a pass (up to MAX_ROWS rows) is staged once per
//     block into shared memory as bf16, with the prologue applied:
//     bf16(x*ss*norm_w) (rmsnorm apply) or bf16(silu(g)*u) (SwiGLU), the
//     staging of ops/linear.py:122-128 and int4_matmul.py:421-428. The
//     grid is at most the resident blocks (occupancy times the SM count),
//     each striding over the column tiles, so a launch stages
//     grid * mr * n_in * 2 bytes from L2 (x2 with the SwiGLU operand u):
//     at 7B and m=8 the down projection's 132 blocks stage 46 MB, twice its
//     23.6 MB of weights. Rows beyond MAX_ROWS take further passes over the
//     weights; that is the large-m case, which the GEMM takes from
//     GEMM_MIN_M rows on.
//   - The epilogue adds the residual in f32 and casts. The residual and
//     the output are each bf16, fp16 or f32 (--act-dtype), a run-time type
//     code: the JAX kernel reads its residual as f32 and stores out_dtype
//     (int4_matmul.py:471-472). The rms scale of the output, ss' =
//     rsqrt(mean(out^2) + eps), is a reduction over all n_out columns,
//     which blocks running in parallel cannot finish, so a second small
//     launch (rms_scale) computes it over the cast output (:475), read in
//     its own type. The staged x and the MMA stay bf16: the wrapper casts
//     x and u to bf16 as the JAX wrapper does (int4_matmul.py:656-661).

#include "int4_gemv.cuh"

namespace {

using w4gemv::MAX_ROWS;
using w4gemv::WARPS;

// MODE 0: x as given; 1: x*ss*norm_w; 2: silu(x)*u. T: the output's type
// (and the residual's), or Dyn for the type codes
template <int MODE, typename T>
__global__ void __launch_bounds__(WARPS * 32)
int4_gemv_kernel(const __nv_bfloat16* __restrict__ x, int ldx,
                 const __nv_bfloat16* __restrict__ u, int ldu,
                 const float* __restrict__ ss,
                 const float* __restrict__ nw, w4gemv::W4 w,
                 const void* __restrict__ res, int res_dt,
                 void* __restrict__ out, int out_dt, int m,
                 int rows_per_pass) {
  extern __shared__ __align__(16) __nv_bfloat16 xs[];
  __shared__ float red[2 * w4gemv::RED_FLOATS];
  for (int r0 = 0; r0 < m; r0 += rows_per_pass) {
    const int mr = min(rows_per_pass, m - r0);
    const w4gemv::TileLoads pre = w4gemv::prefetch(w);
    __syncthreads();  // the previous pass has finished reading xs
    w4gemv::stage_rows<MODE, false>(xs, x, ldx, u, ldu,
                                    ss != nullptr ? ss + r0 : nullptr, nw,
                                    r0, mr, w.n_in);
    __syncthreads();
    w4gemv::tile_pass<false, T, T>(w, pre, xs, r0, mr, res, res_dt, out,
                                   out_dt, red);
  }
}

// ss[r] = 1 / sqrt(mean(out[r, :]^2) + eps), over the cast output row
// of type T
template <typename T>
__global__ void __launch_bounds__(w4gemv::RMS_THREADS)
rms_scale_kernel(const T* __restrict__ out, float* __restrict__ ss, int n,
                 float eps) {
  __shared__ float part[w4gemv::RMS_PART];
  const int r = blockIdx.x;
  w4gemv::rms_scale_rows<false, T>(out + (size_t)r * n, 0, n, 1, n, eps,
                                   part, ss + r);
}

// kernel slots: the three prologue modes times the epilogue's 4 types
w4gemv::Residency<12> residency;

template <int MODE, typename T>
int launch_typed(const void* x, int ldx, const void* u, int ldu,
                 const void* ss, const void* nw, const w4gemv::W4& w,
                 const void* res, int res_dt, void* out, int out_dt, int m,
                 int rows_per_pass, int slot, cudaStream_t stream) {
  const size_t smem = w4gemv::staged_bytes(rows_per_pass, w.n_in);
  const void* kernel =
      reinterpret_cast<const void*>(&int4_gemv_kernel<MODE, T>);
  int grid = 0;
  cudaError_t e = residency.blocks(kernel, 4 * MODE + slot, smem, false,
                                   &grid);
  if (e != cudaSuccess) return launch_refused(e);
  const int tiles = (w.n_out + w4gemv::TILE_N - 1) / w4gemv::TILE_N;
  if (grid > tiles) grid = tiles;
  int4_gemv_kernel<MODE, T><<<grid, WARPS * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), ldx,
      static_cast<const __nv_bfloat16*>(u), ldu,
      static_cast<const float*>(ss), static_cast<const float*>(nw), w,
      res, res_dt, out, out_dt, m, rows_per_pass);
  return static_cast<int>(cudaGetLastError());
}

// the epilogue's types at compile time where the output is one of the
// three and the residual is none or of its type, else by type code
template <int MODE>
int launch_gemv(const void* x, int ldx, const void* u, int ldu,
                const void* ss, const void* nw, const w4gemv::W4& w,
                const void* res, int res_dt, void* out, int out_dt, int m,
                int rows_per_pass, cudaStream_t stream) {
#define LAUNCH(T, SLOT)                                                    \
  launch_typed<MODE, T>(x, ldx, u, ldu, ss, nw, w, res, res_dt, out,      \
                        out_dt, m, rows_per_pass, SLOT, stream)
  if (res != nullptr && res_dt != out_dt) return LAUNCH(Dyn, 3);
  if (out_dt == DT_BF16) return LAUNCH(__nv_bfloat16, DT_BF16);
  if (out_dt == DT_F16) return LAUNCH(__half, DT_F16);
  return LAUNCH(float, DT_F32);
#undef LAUNCH
}

}  // namespace

// x: (m, n_in) bf16, row stride ldx. u: SwiGLU up values (m, n_in) bf16,
// row stride ldu, or null. ss: (m,) f32 and nw: (n_in,) f32 for the
// rmsnorm-apply prologue, or null. qw: (n_out, n_in/8) int32; scales:
// (n_out, groups) fp16; zeros: (n_out, groups) uint8. res: (m, n_out)
// of type code res_dt (DT_F32, DT_BF16 or DT_F16) or null. out: (m,
// n_out) of type code out_dt. Needs
// n_in % 32 == 0, groups = ceil(n_in / 128), x, u and nw 16-byte aligned,
// row strides % 8 == 0.
LLAMA_EXPORT int int4_gemv(const void* x, int ldx, const void* u, int ldu,
                           const void* ss, const void* nw, const void* qw,
                           const void* scales, const void* zeros,
                           const void* res, int res_dt, void* out,
                           int out_dt, int m,
                           int n_in, int n_out, int groups,
                           int rows_per_pass, void* stream) {
  const bool aligned =
      reinterpret_cast<uintptr_t>(x) % 16 == 0 && ldx % 8 == 0 &&
      (u == nullptr ||
       (reinterpret_cast<uintptr_t>(u) % 16 == 0 && ldu % 8 == 0)) &&
      (ss == nullptr || reinterpret_cast<uintptr_t>(nw) % 16 == 0);
  if (n_in % 32 != 0 || groups != w4gemv::n_groups(n_in) || m < 1 ||
      res_dt < DT_F32 || res_dt > DT_F16 || out_dt < DT_F32 ||
      out_dt > DT_F16 ||
      rows_per_pass < 1 || rows_per_pass > MAX_ROWS || !aligned)
    return static_cast<int>(cudaErrorInvalidValue);
  const w4gemv::W4 w = w4gemv::make_w4(qw, scales, zeros, n_in, n_out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (u != nullptr)
    return launch_gemv<2>(x, ldx, u, ldu, ss, nw, w, res, res_dt, out,
                          out_dt, m, rows_per_pass, st);
  if (ss != nullptr)
    return launch_gemv<1>(x, ldx, u, ldu, ss, nw, w, res, res_dt, out,
                          out_dt, m, rows_per_pass, st);
  return launch_gemv<0>(x, ldx, u, ldu, ss, nw, w, res, res_dt, out, out_dt,
                        m, rows_per_pass, st);
}

// ss: (m,) f32 from out (m, n) of type code out_dt
LLAMA_EXPORT int rms_scale(const void* out, int out_dt, void* ss, int m,
                           int n, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* ss_ = static_cast<float*>(ss);
  if (out_dt == DT_BF16) {
    rms_scale_kernel<<<m, w4gemv::RMS_THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(out), ss_, n, eps);
  } else if (out_dt == DT_F16) {
    rms_scale_kernel<<<m, w4gemv::RMS_THREADS, 0, st>>>(
        static_cast<const __half*>(out), ss_, n, eps);
  } else if (out_dt == DT_F32) {
    rms_scale_kernel<<<m, w4gemv::RMS_THREADS, 0, st>>>(
        static_cast<const float*>(out), ss_, n, eps);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
