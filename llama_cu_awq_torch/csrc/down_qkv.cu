// Layer l's down projection chained with layer l+1's qkv projection, in
// one launch.
//
// Replaces: llama_cu_awq_tpu/ops/pallas/down_qkv.py, _down_qkv_2d
//   (down_qkv_fused). It computes, for m rows:
//     h   = bf16(silu(g) * u)                       (once, over the grid)
//     x2  = XT(h @ W_down + res)                              (stage D)
//     ss2 = 1 / sqrt(mean(x2^2) + eps)                        (over XT x2)
//     qkv = bf16(x2 * ss2 * attn_norm') @ W_qkv'  (f32, bf16 or fp16)
//                                                               (stage Q)
//   x2's type XT is the activation type (bf16, fp16 or f32, --act-dtype),
//   as the JAX kernel stores x2 in out_dtype and reads it back for stage Q
//   (down_qkv.py:86-91, 112-113); the residual is bf16, as the JAX wrapper
//   rounds it (down_qkv.py:238-244, prep).
//
// What bounds it on the H100: the weight bytes of both matrices. At 7B,
//   W_down (11008 x 4096) and W_qkv (4096 x 12288) are 22.5 + 25.2 MB of
//   nibbles plus 0.4 + 1.2 MB of scales and zeros, read once per launch for
//   up to MAX_ROWS rows: 14.9 us at 3.35 TB/s at m=1, 15.1 at m=8.
//
// What the design does about it:
//   - The TPU kernel welds the two matmuls so that W_qkv's first blocks
//     prefetch while down still runs. On the card the same chain needs a
//     grid-wide barrier: stage Q's rows need all of x2 and its rms scale.
//     So this is one cooperative launch (cudaLaunchCooperativeKernel) of
//     persistent blocks, as many as can be resident at once (occupancy
//     times the SM count, at most one per column tile of the wider stage),
//     which stride over the column tiles of each stage, with
//     cooperative_groups' grid.sync() between the stages. x2 goes through
//     global memory; the barrier orders it, and stage Q reads it through L2
//     (__ldcg).
//   - Each stage is int4_gemv.cuh's tensor-core column tile over rows
//     staged once per pass as bf16 with the SwiGLU or rmsnorm prologue
//     applied, and each block computes the rms scale of a pass's rows
//     itself with rms_scale's exact reduction. The tile's sums depend on
//     n_in alone, not on the grid, so x2, ss2 and qkv are bit-equal to
//     int4_gemv (SwiGLU + residual), rms_scale and int4_gemv (prescale),
//     the pair this launch replaces, and each row to the same launch on
//     that row alone.
//   - Staging bytes: every block stages a pass's rows at full width from
//     L2. The SwiGLU prologue is computed once, over the grid, into the
//     scratch h (swiglu_rows) behind one more grid barrier, and stage D
//     stages h: each block would otherwise read g and u and redo the exp.
//     At 7B and m=8 stage D stages 8 x 11008 x 2 B = 176 KB a block and
//     stage Q 8 x 4096 x 2 B = 64 KB, times the grid (one block an SM at
//     that shared-memory size: 132 blocks, 32 MB in all) against 49 MB of
//     weights. Each warp's first code loads are issued before the staging,
//     so they are in flight while it runs.
//   - Rows beyond MAX_ROWS take further passes over the weights, as the
//     GEMV does.
//   - A launch that cannot be co-resident (cudaErrorCooperativeLaunchTooLarge
//     and the like) returns its error; the wrapper raises. It never falls
//     back to the pair.

#include <cooperative_groups.h>

#include "int4_gemv.cuh"

namespace cg = cooperative_groups;

namespace {

using w4gemv::MAX_ROWS;
using w4gemv::WARPS;

// XT: x2's type; x2_dt its type code. QT: qkv's type, or Dyn for its
// type code qkv_dt
template <typename XT, typename QT>
__global__ void __launch_bounds__(WARPS * 32)
down_qkv_kernel(const __nv_bfloat16* __restrict__ g, int ldg,
                const __nv_bfloat16* __restrict__ u, int ldu,
                const __nv_bfloat16* __restrict__ res,
                const float* __restrict__ nw, w4gemv::W4 wd, w4gemv::W4 wq,
                __nv_bfloat16* h, XT* x2, int x2_dt,
                float* __restrict__ ss2, void* qkv, int qkv_dt, int m,
                float eps, int rpp_d, int rpp_q) {
  extern __shared__ __align__(16) __nv_bfloat16 xs[];
  __shared__ float red[2 * w4gemv::RED_FLOATS];
  __shared__ float part[w4gemv::RMS_PART];
  __shared__ float ss_rows[MAX_ROWS];
  const int dim = wd.n_out;

  // ---- h = bf16(silu(g) * u), once for the launch ----
  w4gemv::swiglu_rows<false>(g, ldg, u, ldu, h, wd.n_in, m, wd.n_in);
  cg::this_grid().sync();

  // ---- stage D: x2 = XT(h @ W_down + res) ----
  for (int r0 = 0; r0 < m; r0 += rpp_d) {
    const int mr = min(rpp_d, m - r0);
    const w4gemv::TileLoads pre = w4gemv::prefetch(wd);
    __syncthreads();  // the previous pass has finished reading xs
    w4gemv::stage_rows<0, true>(xs, h, wd.n_in, nullptr, 0, nullptr,
                                nullptr, r0, mr, wd.n_in);
    __syncthreads();
    w4gemv::tile_pass<false, __nv_bfloat16, XT>(wd, pre, xs, r0, mr, res,
                                                DT_BF16, x2, x2_dt, red);
  }

  cg::this_grid().sync();  // all of x2 is written and visible

  // ---- stage Q: qkv = bf16(x2 * ss2 * attn_norm') @ W_qkv' ----
  for (int r0 = 0; r0 < m; r0 += rpp_q) {
    const int mr = min(rpp_q, m - r0);
    const w4gemv::TileLoads pre = w4gemv::prefetch(wq);
    XT* raw = reinterpret_cast<XT*>(
        reinterpret_cast<unsigned char*>(xs) + w4gemv::raw_offset(mr, dim));
    __syncthreads();
    w4gemv::copy_rows(raw, x2, dim, r0, mr, dim);
    __syncthreads();
    w4gemv::rms_scale_rows<false, XT>(raw, x2_dt, dim, mr, dim, eps, part,
                                      ss_rows);
    if (blockIdx.x == 0 && threadIdx.x < mr)
      ss2[r0 + threadIdx.x] = ss_rows[threadIdx.x];
    w4gemv::stage_rows<1, false>(xs, raw, dim, nullptr, 0, ss_rows, nw, 0,
                                 mr, dim);
    __syncthreads();
    w4gemv::tile_pass<false, QT, QT>(wq, pre, xs, r0, mr, nullptr, DT_BF16,
                                     qkv, qkv_dt, red);
  }
}

// kernel slots: x2 in f32, bf16, fp16 (the type codes), qkv in x2's type
// or by type code
w4gemv::Residency<6> residency;

template <typename XT, typename QT>
int launch(const void* g, int ldg, const void* u, int ldu, const void* res,
           const void* nw, const w4gemv::W4& wd_, const w4gemv::W4& wq_,
           void* h, void* x2, int x2_dt, void* ss2, void* qkv, int qkv_dt,
           int m, float eps, int rpp_d, int rpp_q, cudaStream_t stream) {
  const int hid = wd_.n_in, dim = wd_.n_out, n_q = wq_.n_out;
  const size_t raw = w4gemv::staged_raw_bytes(rpp_q, dim, sizeof(XT));
  const size_t smem = w4gemv::staged_bytes(rpp_d, hid) > raw
                          ? w4gemv::staged_bytes(rpp_d, hid)
                          : raw;
  const void* kernel =
      reinterpret_cast<const void*>(&down_qkv_kernel<XT, QT>);
  int grid = 0;
  cudaError_t e = residency.blocks(
      kernel, 2 * x2_dt + (std::is_same_v<QT, Dyn> ? 1 : 0), smem, true,
      &grid);
  if (e != cudaSuccess) return launch_refused(e);
  const int cols = dim > n_q ? dim : n_q;
  const int tiles = (cols + w4gemv::TILE_N - 1) / w4gemv::TILE_N;
  if (grid > tiles) grid = tiles;

  const __nv_bfloat16* g_ = static_cast<const __nv_bfloat16*>(g);
  const __nv_bfloat16* u_ = static_cast<const __nv_bfloat16*>(u);
  const __nv_bfloat16* res_ = static_cast<const __nv_bfloat16*>(res);
  const float* nw_ = static_cast<const float*>(nw);
  w4gemv::W4 wd = wd_;
  w4gemv::W4 wq = wq_;
  XT* x2_ = static_cast<XT*>(x2);
  float* ss2_ = static_cast<float*>(ss2);
  __nv_bfloat16* h_ = static_cast<__nv_bfloat16*>(h);
  void* args[] = {&g_,  &ldg,   &u_,   &ldu, &res_,   &nw_, &wd,
                  &wq,  &h_,    &x2_,  &x2_dt, &ss2_, &qkv, &qkv_dt,
                  &m,   &eps,   &rpp_d, &rpp_q};
  e = cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(WARPS * 32), args,
                                  smem, stream);
  if (e != cudaSuccess) return launch_refused(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// g, u: (m, hid) bf16 gate and up values, row strides ldg and ldu. res:
// (m, dim) bf16. nw: (dim,) f32, the next layer's attn_norm. W_down: qw_d
// (dim, hid/8) int32, s_d (dim, groups_d) fp16, z_d (dim, groups_d) uint8;
// W_qkv: qw_q (n_q, dim/8), s_q and z_q (n_q, groups_q). Scratch h (m, hid)
// bf16, 16-byte aligned. Outputs x2 (m, dim) of type code x2_dt, ss2 (m,)
// f32, qkv (m, n_q) of type code qkv_dt (DT_F32, DT_BF16 or DT_F16). rpp_d
// and rpp_q: rows per pass of each stage (1..MAX_ROWS). Needs hid % 32 ==
// 0, dim % 32 == 0, groups_* = ceil(n_in / 128), g, u and nw 16-byte
// aligned, row strides % 8 == 0.
LLAMA_EXPORT int down_qkv(const void* g, int ldg, const void* u, int ldu,
                          const void* res, const void* nw, const void* qw_d,
                          const void* s_d, const void* z_d, int hid, int dim,
                          int groups_d, const void* qw_q, const void* s_q,
                          const void* z_q, int n_q, int groups_q, void* h,
                          void* x2, int x2_dt, void* ss2, void* qkv,
                          int qkv_dt, int m, float eps, int rpp_d, int rpp_q,
                          void* stream) {
  const bool aligned = reinterpret_cast<uintptr_t>(g) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(u) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(nw) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(h) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(x2) % 16 == 0 &&
                       ldg % 8 == 0 && ldu % 8 == 0;
  if (hid % 32 != 0 || dim % 32 != 0 || m < 1 || rpp_d < 1 ||
      rpp_d > MAX_ROWS || rpp_q < 1 || rpp_q > MAX_ROWS || !aligned ||
      groups_d != w4gemv::n_groups(hid) || groups_q != w4gemv::n_groups(dim) ||
      qkv_dt < DT_F32 || qkv_dt > DT_F16)
    return static_cast<int>(cudaErrorInvalidValue);
  const w4gemv::W4 wd = w4gemv::make_w4(qw_d, s_d, z_d, hid, dim);
  const w4gemv::W4 wq = w4gemv::make_w4(qw_q, s_q, z_q, dim, n_q);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // qkv in x2's type (the forward's) at compile time, else by type code
#define LAUNCH(XT)                                                         \
  (qkv_dt == x2_dt                                                          \
       ? launch<XT, XT>(g, ldg, u, ldu, res, nw, wd, wq, h, x2, x2_dt, ss2, \
                        qkv, qkv_dt, m, eps, rpp_d, rpp_q, st)              \
       : launch<XT, Dyn>(g, ldg, u, ldu, res, nw, wd, wq, h, x2, x2_dt,     \
                         ss2, qkv, qkv_dt, m, eps, rpp_d, rpp_q, st))
  if (x2_dt == DT_BF16) return LAUNCH(__nv_bfloat16);
  if (x2_dt == DT_F16) return LAUNCH(__half);
  if (x2_dt == DT_F32) return LAUNCH(float);
#undef LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}
