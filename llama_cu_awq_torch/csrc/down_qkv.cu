// Layer l's down projection chained with layer l+1's qkv projection, in
// one launch.
//
// Replaces: llama_cu_awq_tpu/ops/pallas/down_qkv.py, _down_qkv_2d
//   (down_qkv_fused). It computes, for m rows:
//     x2  = bf16(silu(g) * u @ W_down + res)                  (stage D)
//     ss2 = 1 / sqrt(mean(x2^2) + eps)                        (over bf16 x2)
//     qkv = bf16(x2 * ss2 * attn_norm') @ W_qkv'  (f32 or bf16)  (stage Q)
//
// What bounds it on the H100: the weight bytes of both matrices. At 7B,
//   W_down (11008 x 4096) and W_qkv (4096 x 12288) are 22.5 + 25.2 MB of
//   nibbles plus 0.4 + 1.2 MB of scales and zeros, read once per launch for
//   every m the GEMV passes take in one pass: 14.9 us at 3.35 TB/s at m=1.
//
// What the design does about it:
//   - The TPU kernel welds the two matmuls so that W_qkv's first blocks
//     prefetch while down still runs. On the card the same chain needs a
//     grid-wide barrier: stage Q's rows need all of x2 and its rms scale.
//     So this is one cooperative launch (cudaLaunchCooperativeKernel) of
//     persistent blocks, as many as can be resident at once (occupancy
//     times the SM count, at most one per 16 columns), which stride over
//     the output columns of each stage, with cooperative_groups'
//     grid.sync() between the stages. x2 goes through global memory; the
//     barrier orders it, and stage Q reads it through L2 (__ldcg).
//   - Each column is the standalone GEMV's column (int4_gemv.cuh: one warp
//     per column, rows staged once per pass as bf16 in shared memory with
//     the SwiGLU or rmsnorm prologue applied), and each block computes the
//     rms scale of a pass's rows itself with rms_scale's exact reduction.
//     So x2, ss2 and qkv are bit-equal to int4_gemv (SwiGLU + residual),
//     rms_scale and int4_gemv (prescale), the pair this launch replaces.
//   - Rows beyond MAX_ROWS take further passes over the weights, as the
//     GEMV does. No L2 prefetch of W_qkv before the barrier yet: a simple,
//     right kernel first.
//   - A launch that cannot be co-resident (cudaErrorCooperativeLaunchTooLarge
//     and the like) returns its error; the wrapper raises. It never falls
//     back to the pair.

#include <cooperative_groups.h>

#include <mutex>

#include "int4_gemv.cuh"

namespace cg = cooperative_groups;

namespace {

using w4gemv::MAX_ROWS;
using w4gemv::WARPS;

__global__ void __launch_bounds__(WARPS * 32)
down_qkv_kernel(const __nv_bfloat16* __restrict__ g, int ldg,
                const __nv_bfloat16* __restrict__ u, int ldu,
                const __nv_bfloat16* __restrict__ res,
                const float* __restrict__ nw,
                const uint4* __restrict__ qw_d,
                const __half* __restrict__ s_d,
                const uint8_t* __restrict__ z_d, int hid, int dim,
                int groups_d, const uint4* __restrict__ qw_q,
                const __half* __restrict__ s_q,
                const uint8_t* __restrict__ z_q, int n_q, int groups_q,
                __nv_bfloat16* x2, float* __restrict__ ss2, void* qkv,
                int qkv_bf16, int m, float eps, int rpp_d, int rpp_q) {
  extern __shared__ __align__(16) __nv_bfloat16 xs[];
  __shared__ float part[w4gemv::RMS_THREADS / 32];
  __shared__ float ss_rows[MAX_ROWS];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int first_col = blockIdx.x * WARPS + warp;
  const int col_stride = gridDim.x * WARPS;

  // ---- stage D: x2 = bf16(silu(g) * u @ W_down + res) ----
  const int nvec_d = hid >> 5;
  for (int r0 = 0; r0 < m; r0 += rpp_d) {
    const int mr = min(rpp_d, m - r0);
    __syncthreads();  // the previous pass has finished reading xs
    w4gemv::stage_rows<2, false>(xs, g, ldg, u, ldu, nullptr, nullptr, r0,
                                 mr, hid);
    __syncthreads();
    for (int col = first_col; col < dim; col += col_stride) {
      float acc[MAX_ROWS];
      w4gemv::column_partials(acc, xs, nvec_d * 34, qw_d, s_d, z_d, col,
                              nvec_d, groups_d, mr, lane);
      w4gemv::store_column(acc, mr, lane, r0, col, dim, res, x2, 1);
    }
  }

  cg::this_grid().sync();  // all of x2 is written and visible

  // ---- stage Q: qkv = bf16(x2 * ss2 * attn_norm') @ W_qkv' ----
  const int nvec_q = dim >> 5;
  for (int r0 = 0; r0 < m; r0 += rpp_q) {
    const int mr = min(rpp_q, m - r0);
    __syncthreads();
    for (int r = 0; r < mr; ++r) {
      const float s = w4gemv::rms_scale_row<true>(
          x2 + (size_t)(r0 + r) * dim, 1, dim, eps, part);
      if (threadIdx.x == 0) {
        ss_rows[r] = s;
        if (blockIdx.x == 0) ss2[r0 + r] = s;
      }
    }
    __syncthreads();
    w4gemv::stage_rows<1, true>(xs, x2, dim, nullptr, 0, ss_rows, nw, r0, mr,
                                dim);
    __syncthreads();
    for (int col = first_col; col < n_q; col += col_stride) {
      float acc[MAX_ROWS];
      w4gemv::column_partials(acc, xs, nvec_q * 34, qw_q, s_q, z_q, col,
                              nvec_q, groups_q, mr, lane);
      w4gemv::store_column(acc, mr, lane, r0, col, n_q, nullptr, qkv,
                           qkv_bf16);
    }
  }
}

// What a launch needs to know of its device, read once per device (SM
// count, cooperative support) or once per shared-memory size (occupancy):
// the queries and the attribute call cost host time on every layer of a
// host-bound decode step.
struct LaunchInfo {
  int sms = 0;
  int coop = 0;
  size_t smem_attr = 0;  // the largest size the kernel's attribute allows
  size_t occ_smem = 0;   // the size per_sm was computed for
  int per_sm = 0;
};
constexpr int MAX_DEVICES = 64;
LaunchInfo launch_info[MAX_DEVICES];
bool launch_info_read[MAX_DEVICES] = {};
std::mutex launch_info_mu;

// Resident blocks per SM times the SM count for a launch of `smem` bytes of
// dynamic shared memory on the current device, or an error.
cudaError_t resident_blocks(size_t smem, int* blocks) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(launch_info_mu);
  LaunchInfo& li = launch_info[dev];
  if (!launch_info_read[dev]) {
    e = cudaDeviceGetAttribute(&li.sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    e = cudaDeviceGetAttribute(&li.coop, cudaDevAttrCooperativeLaunch, dev);
    if (e != cudaSuccess) return e;
    launch_info_read[dev] = true;
  }
  if (!li.coop) return cudaErrorNotSupported;
  if (smem > li.smem_attr) {
    e = cudaFuncSetAttribute(down_qkv_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    li.smem_attr = smem;
  }
  if (smem != li.occ_smem || li.per_sm == 0) {
    int per_sm = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, down_qkv_kernel,
                                                      WARPS * 32, smem);
    if (e != cudaSuccess) return e;
    if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
    li.per_sm = per_sm;
    li.occ_smem = smem;
  }
  *blocks = li.per_sm * li.sms;
  return cudaSuccess;
}

}  // namespace

// g, u: (m, hid) bf16 gate and up values, row strides ldg and ldu. res:
// (m, dim) bf16. nw: (dim,) f32, the next layer's attn_norm. W_down: qw_d
// (dim, hid/8) int32, s_d (dim, groups_d) fp16, z_d (dim, groups_d) uint8;
// W_qkv: qw_q (n_q, dim/8), s_q and z_q (n_q, groups_q). Outputs x2 (m, dim)
// bf16, ss2 (m,) f32, qkv (m, n_q) bf16 when qkv_bf16 else f32. rpp_d and
// rpp_q: rows per pass of each stage (1..MAX_ROWS). Needs hid % 32 == 0
// and dim % 32 == 0.
LLAMA_EXPORT int down_qkv(const void* g, int ldg, const void* u, int ldu,
                          const void* res, const void* nw, const void* qw_d,
                          const void* s_d, const void* z_d, int hid, int dim,
                          int groups_d, const void* qw_q, const void* s_q,
                          const void* z_q, int n_q, int groups_q, void* x2,
                          void* ss2, void* qkv, int qkv_bf16, int m,
                          float eps, int rpp_d, int rpp_q, void* stream) {
  if (hid % 32 != 0 || dim % 32 != 0 || m < 1 || rpp_d < 1 ||
      rpp_d > MAX_ROWS || rpp_q < 1 || rpp_q > MAX_ROWS)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = w4gemv::staged_bytes(rpp_d, hid) >
                              w4gemv::staged_bytes(rpp_q, dim)
                          ? w4gemv::staged_bytes(rpp_d, hid)
                          : w4gemv::staged_bytes(rpp_q, dim);
  int grid = 0;
  cudaError_t e = resident_blocks(smem, &grid);
  if (e != cudaSuccess) return launch_refused(e);
  const int cols = dim > n_q ? dim : n_q;
  if (grid > (cols + WARPS - 1) / WARPS) grid = (cols + WARPS - 1) / WARPS;

  const __nv_bfloat16* g_ = static_cast<const __nv_bfloat16*>(g);
  const __nv_bfloat16* u_ = static_cast<const __nv_bfloat16*>(u);
  const __nv_bfloat16* res_ = static_cast<const __nv_bfloat16*>(res);
  const float* nw_ = static_cast<const float*>(nw);
  const uint4* qw_d_ = static_cast<const uint4*>(qw_d);
  const __half* s_d_ = static_cast<const __half*>(s_d);
  const uint8_t* z_d_ = static_cast<const uint8_t*>(z_d);
  const uint4* qw_q_ = static_cast<const uint4*>(qw_q);
  const __half* s_q_ = static_cast<const __half*>(s_q);
  const uint8_t* z_q_ = static_cast<const uint8_t*>(z_q);
  __nv_bfloat16* x2_ = static_cast<__nv_bfloat16*>(x2);
  float* ss2_ = static_cast<float*>(ss2);
  void* args[] = {&g_,    &ldg,  &u_,       &ldu,  &res_,  &nw_,   &qw_d_,
                  &s_d_,  &z_d_, &hid,      &dim,  &groups_d, &qw_q_,
                  &s_q_,  &z_q_, &n_q,      &groups_q, &x2_, &ss2_, &qkv,
                  &qkv_bf16, &m, &eps,      &rpp_d, &rpp_q};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(down_qkv_kernel),
                                  dim3(grid), dim3(WARPS * 32), args, smem,
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return launch_refused(e);
  return static_cast<int>(cudaGetLastError());
}
