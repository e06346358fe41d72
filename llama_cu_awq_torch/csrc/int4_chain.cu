// The matmul chain of one decoder layer (ffn_chain), and the whole layer
// with its decode attention in front (mono_layer), each in one launch.
//
// Replaces: tools/experiments/int4_chain.py, ffn_chain (kernel
//   _make_chain_kernel, pallas_call at :587) and mono_layer (the same
//   kernel with its attention prefix, pallas_call at :806). For m rows:
//     stage O:  x1  = bf16(attn @ W_o + x_res)
//               ss1 = 1 / sqrt(mean(x1^2) + eps)          (over bf16 x1)
//     stage GU: gu  = bf16(bf16(x1 * ss1 * ffn_norm) @ W_gate_up)
//     stage D:  out = bf16(bf16(silu(g) * u) @ W_down + x1)   g|u = gu
//               ss  = 1 / sqrt(mean(out^2) + eps)
//     stage Q (optional): qkv = bf16(bf16(out * ss * attn_norm') @ W_qkv')
//   mono_layer first runs decode attention for every (slot, kv head)
//   (attention_step.cuh attention_item: the whole window in one online
//   softmax, where attention_step.cu splits it across blocks; the new
//   cache rows come from the same phase 1, new_row), whose bf16 rows are
//   stage O's attn, and returns the new cache rows (and int8 scales); the
//   caller scatters them.
//
// What bounds it on the H100: the weight bytes. At 7B and m=1 the four
//   matrices are 105.9 MB of nibbles, fp16 scales and uint8 zeros, read
//   once: 31.6 us at 3.35 TB/s. mono_layer adds the cache's history rows,
//   24.6 MB of bf16 k and v at position 1500 (7.3 us).
//
// What the design does about it:
//   - The TPU kernel runs the stages as one sequential grid so that the
//     next stage's first weight blocks prefetch while the current one runs.
//     On the card the stages run over all SMs in parallel, and each stage
//     needs the previous stage's whole row (and its rms scale). So this is
//     one cooperative launch (cudaLaunchCooperativeKernel) of persistent
//     blocks, as many as can be resident at once (occupancy times the SM
//     count, at most one per 16 columns of the widest stage), which stride
//     over each stage's output columns, with cooperative_groups' grid.sync()
//     between the stages: down_qkv.cu's design, with two more stages.
//   - Each column is the standalone GEMV's column (int4_gemv.cuh: one warp
//     per column, a pass's rows staged once as bf16 in shared memory with
//     the prologue applied) and each block computes the rms scale of a
//     pass's rows itself with rms_scale's exact reduction. So ffn_chain's
//     x_out, ss and qkv are bit-equal to the launch sequence of the
//     standalone path:
//     int4_gemv (residual), rms_scale, int4_gemv (rmsnorm prologue),
//     int4_gemv (SwiGLU + residual), rms_scale, int4_gemv (rmsnorm
//     prologue). x1, gu and out go through global memory and are read back
//     through L2 (__ldcg) after the barrier. Rows beyond MAX_ROWS take
//     further passes over the weights, as the GEMV's do.
//   - mono_layer's attention stage gives one (slot, kv head) work item at a
//     time to the first D threads of a block (named barrier 1 among them),
//     over the persistent blocks; at batch 1 and 7B that is 32 items, so
//     the other blocks wait at the first barrier. Its scratch (Smem) lies
//     in the same dynamic shared memory as the staged rows of later stages.
//   - No L2 prefetch of the next stage's weights before a barrier, no
//     tensor cores: a simple, right kernel first.
//   - A launch that cannot be co-resident returns its error (as
//     cudaFuncSetAttribute, the occupancy query or the cooperative launch
//     report it); the wrapper raises. It never falls back.

#include <cooperative_groups.h>

#include <mutex>

#include "attention_step.cuh"
#include "int4_gemv.cuh"

namespace cg = cooperative_groups;

namespace {

using attn_step::KV_BF16;
using attn_step::KV_INT8;
using w4gemv::MAX_ROWS;
using w4gemv::WARPS;

// one packed w4-g128 weight: qw (n_out, n_in/8) int32, s and z
// (n_out, groups) fp16 and uint8
struct W4 {
  const uint4* qw;
  const __half* s;
  const uint8_t* z;
  int n_in, n_out, groups;
};

struct ChainArgs {
  const __nv_bfloat16* attn;  // (m, wo.n_in)
  const __nv_bfloat16* res;   // (m, dim)
  const float* ffn_norm;      // (dim,)
  const float* attn_norm;     // (dim,) of the next layer, or null
  W4 wo, wgu, wd, wq;         // wq unused without a next layer
  __nv_bfloat16* x1;          // (m, dim) scratch
  __nv_bfloat16* gu;          // (m, 2 * hid) scratch
  __nv_bfloat16* out;         // (m, dim)
  float* ss;                  // (m,)
  __nv_bfloat16* qkv;         // (m, wq.n_out), or null: no stage Q
  int m;
  float eps;
  int rpp_o, rpp_gu, rpp_d, rpp_q;  // rows per pass of each stage
};

struct AttnArgs {
  const __nv_bfloat16* qkv;  // (B, (H + 2 * n_kv) * D)
  const void* k_cache;       // (B, S, n_kv, D) bf16 or int8
  const void* v_cache;
  const float* k_scale;      // (B, S, n_kv), int8 only
  const float* v_scale;
  const int* pos;            // (B,)
  const float* cos2;         // (B, D)
  const float* sinm;
  __nv_bfloat16* rows;       // (B, H * D): stage O's attn
  void* k_new;               // (B, n_kv, D)
  void* v_new;
  float* ks_new;             // (B, n_kv), int8 only
  float* vs_new;
  int B, H, n_kv, D, S, win;
  float scale;
};

// The columns of weight w for the mr rows staged in xs: column col goes
// to the warp of this block that grid-strides onto it.
template <bool RES_L2>
__device__ __forceinline__ void pass_columns(const W4& w,
                                             const __nv_bfloat16* xs,
                                             int r0, int mr,
                                             const __nv_bfloat16* res,
                                             __nv_bfloat16* out) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nvec = w.n_in >> 5;
  for (int col = blockIdx.x * WARPS + warp; col < w.n_out;
       col += gridDim.x * WARPS) {
    float acc[MAX_ROWS];
    w4gemv::column_partials(acc, xs, nvec * 34, w.qw, w.s, w.z, col, nvec,
                            w.groups, mr, lane);
    w4gemv::store_column<RES_L2>(acc, mr, lane, r0, col, w.n_out, res, out,
                                 1);
  }
}

// ss_rows[r] for rows r0..r0+mr-1 of x (m, n) bf16, written in this same
// launch: rms_scale's reduction. Block 0 also stores them to ss_out.
__device__ __forceinline__ void rms_rows(const __nv_bfloat16* x, int n,
                                         int r0, int mr, float eps,
                                         float* part, float* ss_rows,
                                         float* ss_out) {
  for (int r = 0; r < mr; ++r) {
    const float s = w4gemv::rms_scale_row<true>(x + (size_t)(r0 + r) * n, 1,
                                                n, eps, part);
    if (threadIdx.x == 0) {
      ss_rows[r] = s;
      if (ss_out != nullptr && blockIdx.x == 0) ss_out[r0 + r] = s;
    }
  }
}

// Stages O, GU, D and (with a next layer) Q, a grid barrier after each but
// the last. ATTN_L2: attn was written in this launch (mono_layer).
template <bool ATTN_L2>
__device__ __forceinline__ void chain_stages(const ChainArgs& a,
                                             __nv_bfloat16* xs, float* part,
                                             float* ss_rows) {
  cg::grid_group grid = cg::this_grid();
  const int dim = a.wo.n_out;
  const int hid = a.wd.n_in;

  // ---- stage O: x1 = bf16(attn @ W_o + x_res) ----
  for (int r0 = 0; r0 < a.m; r0 += a.rpp_o) {
    const int mr = min(a.rpp_o, a.m - r0);
    __syncthreads();  // the previous pass has finished reading xs
    w4gemv::stage_rows<0, ATTN_L2>(xs, a.attn, a.wo.n_in, nullptr, 0,
                                   nullptr, nullptr, r0, mr, a.wo.n_in);
    __syncthreads();
    pass_columns<false>(a.wo, xs, r0, mr, a.res, a.x1);
  }
  grid.sync();

  // ---- stage GU: gu = bf16(bf16(x1 * ss1 * ffn_norm) @ W_gate_up) ----
  for (int r0 = 0; r0 < a.m; r0 += a.rpp_gu) {
    const int mr = min(a.rpp_gu, a.m - r0);
    __syncthreads();
    rms_rows(a.x1, dim, r0, mr, a.eps, part, ss_rows, nullptr);
    __syncthreads();
    w4gemv::stage_rows<1, true>(xs, a.x1, dim, nullptr, 0, ss_rows,
                                a.ffn_norm, r0, mr, dim);
    __syncthreads();
    pass_columns<false>(a.wgu, xs, r0, mr, nullptr, a.gu);
  }
  grid.sync();

  // ---- stage D: out = bf16(bf16(silu(g) * u) @ W_down + x1) ----
  for (int r0 = 0; r0 < a.m; r0 += a.rpp_d) {
    const int mr = min(a.rpp_d, a.m - r0);
    __syncthreads();
    w4gemv::stage_rows<2, true>(xs, a.gu, 2 * hid, a.gu + hid, 2 * hid,
                                nullptr, nullptr, r0, mr, hid);
    __syncthreads();
    pass_columns<true>(a.wd, xs, r0, mr, a.x1, a.out);
  }
  grid.sync();

  if (a.qkv == nullptr) {
    // ---- ss of out, one row per block ----
    for (int r = blockIdx.x; r < a.m; r += gridDim.x) {
      const float s = w4gemv::rms_scale_row<true>(a.out + (size_t)r * dim, 1,
                                                  dim, a.eps, part);
      if (threadIdx.x == 0) a.ss[r] = s;
    }
    return;
  }
  // ---- stage Q: qkv = bf16(bf16(out * ss * attn_norm') @ W_qkv') ----
  for (int r0 = 0; r0 < a.m; r0 += a.rpp_q) {
    const int mr = min(a.rpp_q, a.m - r0);
    __syncthreads();
    rms_rows(a.out, dim, r0, mr, a.eps, part, ss_rows, a.ss);
    __syncthreads();
    w4gemv::stage_rows<1, true>(xs, a.out, dim, nullptr, 0, ss_rows,
                                a.attn_norm, r0, mr, dim);
    __syncthreads();
    pass_columns<false>(a.wq, xs, r0, mr, nullptr, a.qkv);
  }
}

__global__ void __launch_bounds__(WARPS * 32) ffn_chain_kernel(ChainArgs a) {
  extern __shared__ __align__(16) __nv_bfloat16 xs[];
  __shared__ float part[w4gemv::RMS_THREADS / 32];
  __shared__ float ss_rows[MAX_ROWS];
  chain_stages<false>(a, xs, part, ss_rows);
}

template <int KV>
__global__ void __launch_bounds__(WARPS * 32)
mono_layer_kernel(AttnArgs t, ChainArgs a) {
  extern __shared__ __align__(16) __nv_bfloat16 xs[];
  __shared__ float part[w4gemv::RMS_THREADS / 32];
  __shared__ float ss_rows[MAX_ROWS];
  // ---- attention: one (slot, kv head) item at a time on D threads ----
  if (static_cast<int>(threadIdx.x) < t.D) {
    attn_step::Smem& sm = *reinterpret_cast<attn_step::Smem*>(xs);
    for (int item = blockIdx.x; item < t.B * t.n_kv; item += gridDim.x) {
      attn_step::attention_item<KV, true>(
          sm, t.qkv, t.k_cache, t.v_cache, t.k_scale, t.v_scale, t.pos,
          t.cos2, t.sinm, t.rows, t.k_new, t.v_new, t.ks_new, t.vs_new, t.H,
          t.n_kv, t.D, t.S, t.win, t.scale, item / t.n_kv, item % t.n_kv);
      attn_step::item_sync<true>(t.D);  // sm is free for the next item
    }
  }
  cg::this_grid().sync();  // every attention row is written
  chain_stages<true>(a, xs, part, ss_rows);
}

// What a launch needs to know of its device, read once per device (SM
// count, cooperative support) and once per kernel and shared-memory size
// (the attribute, occupancy): the queries cost host time on every layer of
// a host-bound decode step.
struct LaunchInfo {
  int sms = 0;
  int coop = 0;
  size_t smem_attr = 0;  // the largest size the kernel's attribute allows
  size_t occ_smem = 0;   // the size per_sm was computed for
  int per_sm = 0;
};
constexpr int MAX_DEVICES = 64;
constexpr int N_KERNELS = 3;  // ffn_chain, mono_layer bf16, mono_layer int8
LaunchInfo launch_info[N_KERNELS][MAX_DEVICES];
bool launch_info_read[N_KERNELS][MAX_DEVICES] = {};
std::mutex launch_info_mu;

// Resident blocks per SM times the SM count for a launch of `kernel` (slot
// `which` of launch_info) with `smem` bytes of dynamic shared memory on the
// current device, or an error.
cudaError_t resident_blocks(const void* kernel, int which, size_t smem,
                            int* blocks) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(launch_info_mu);
  LaunchInfo& li = launch_info[which][dev];
  if (!launch_info_read[which][dev]) {
    e = cudaDeviceGetAttribute(&li.sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    e = cudaDeviceGetAttribute(&li.coop, cudaDevAttrCooperativeLaunch, dev);
    if (e != cudaSuccess) return e;
    launch_info_read[which][dev] = true;
  }
  if (!li.coop) return cudaErrorNotSupported;
  if (smem > li.smem_attr) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    li.smem_attr = smem;
  }
  if (smem != li.occ_smem || li.per_sm == 0) {
    int per_sm = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      WARPS * 32, smem);
    if (e != cudaSuccess) return e;
    if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
    li.per_sm = per_sm;
    li.occ_smem = smem;
  }
  *blocks = li.per_sm * li.sms;
  return cudaSuccess;
}

W4 make_w4(const void* qw, const void* s, const void* z, int n_in,
           int n_out) {
  return W4{static_cast<const uint4*>(qw), static_cast<const __half*>(s),
            static_cast<const uint8_t*>(z), n_in, n_out, (n_in + 127) / 128};
}

bool rpp_ok(int rpp) { return rpp >= 1 && rpp <= MAX_ROWS; }

// Checks the chain's widths and passes; fills the launch's shared-memory
// bytes (the largest stage's staged rows, at least min_smem) and grid.
cudaError_t chain_launch_shape(const ChainArgs& a, const void* kernel,
                               int which, size_t min_smem, size_t* smem,
                               int* grid) {
  const int dim = a.wo.n_out;
  const int hid = a.wd.n_in;
  if (a.wo.n_in % 32 != 0 || dim % 32 != 0 || hid % 32 != 0 || a.m < 1 ||
      a.wgu.n_in != dim || a.wgu.n_out != 2 * hid || a.wd.n_out != dim ||
      !rpp_ok(a.rpp_o) || !rpp_ok(a.rpp_gu) || !rpp_ok(a.rpp_d) ||
      (a.qkv != nullptr && (a.wq.n_in != dim || !rpp_ok(a.rpp_q) ||
                            a.attn_norm == nullptr)))
    return cudaErrorInvalidValue;
  size_t need = min_smem;
  auto grow = [&need](int rpp, int n_in) {
    const size_t b = w4gemv::staged_bytes(rpp, n_in);
    if (b > need) need = b;
  };
  grow(a.rpp_o, a.wo.n_in);
  grow(a.rpp_gu, dim);
  grow(a.rpp_d, hid);
  int cols = a.wgu.n_out;
  if (a.wo.n_out > cols) cols = a.wo.n_out;
  if (a.qkv != nullptr) {
    grow(a.rpp_q, dim);
    if (a.wq.n_out > cols) cols = a.wq.n_out;
  }
  cudaError_t e = resident_blocks(kernel, which, need, grid);
  if (e != cudaSuccess) return e;
  if (*grid > (cols + WARPS - 1) / WARPS) *grid = (cols + WARPS - 1) / WARPS;
  *smem = need;
  return cudaSuccess;
}

ChainArgs make_chain(const void* attn, const void* res, const void* ffn_norm,
                     const void* qw_o, const void* s_o, const void* z_o,
                     const void* qw_gu, const void* s_gu, const void* z_gu,
                     const void* qw_d, const void* s_d, const void* z_d,
                     const void* attn_norm, const void* qw_q, const void* s_q,
                     const void* z_q, int n_q, void* x1, void* gu, void* out,
                     void* ss, void* qkv, int m, int n_o, int dim, int hid,
                     float eps, int rpp_o, int rpp_gu, int rpp_d,
                     int rpp_q) {
  ChainArgs a;
  a.attn = static_cast<const __nv_bfloat16*>(attn);
  a.res = static_cast<const __nv_bfloat16*>(res);
  a.ffn_norm = static_cast<const float*>(ffn_norm);
  a.attn_norm = static_cast<const float*>(attn_norm);
  a.wo = make_w4(qw_o, s_o, z_o, n_o, dim);
  a.wgu = make_w4(qw_gu, s_gu, z_gu, dim, 2 * hid);
  a.wd = make_w4(qw_d, s_d, z_d, hid, dim);
  a.wq = make_w4(qw_q, s_q, z_q, dim, n_q);
  a.x1 = static_cast<__nv_bfloat16*>(x1);
  a.gu = static_cast<__nv_bfloat16*>(gu);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.ss = static_cast<float*>(ss);
  a.qkv = static_cast<__nv_bfloat16*>(qkv);
  a.m = m;
  a.eps = eps;
  a.rpp_o = rpp_o;
  a.rpp_gu = rpp_gu;
  a.rpp_d = rpp_d;
  a.rpp_q = rpp_q;
  return a;
}

}  // namespace

// attn: (m, n_o) bf16; res: (m, dim) bf16; ffn_norm: (dim,) f32. W_o:
// qw_o (dim, n_o/8) int32, s_o and z_o (dim, ceil(n_o/128)) fp16 and uint8;
// W_gate_up (dim -> 2*hid), W_down (hid -> dim) alike. With a next layer:
// attn_norm (dim,) f32 and W_qkv' (dim -> n_q), and qkv (m, n_q) bf16 is
// written; qkv null: no stage Q. Scratch x1 (m, dim) and gu (m, 2*hid)
// bf16. Outputs out (m, dim) bf16 and ss (m,) f32. rpp_*: rows per pass of
// each stage (1..MAX_ROWS). Needs n_o, dim and hid multiples of 32.
LLAMA_EXPORT int ffn_chain(const void* attn, const void* res,
                           const void* ffn_norm, const void* qw_o,
                           const void* s_o, const void* z_o,
                           const void* qw_gu, const void* s_gu,
                           const void* z_gu, const void* qw_d,
                           const void* s_d, const void* z_d,
                           const void* attn_norm, const void* qw_q,
                           const void* s_q, const void* z_q, int n_q,
                           void* x1, void* gu, void* out, void* ss,
                           void* qkv, int m, int n_o, int dim, int hid,
                           float eps, int rpp_o, int rpp_gu, int rpp_d,
                           int rpp_q, void* stream) {
  ChainArgs a = make_chain(attn, res, ffn_norm, qw_o, s_o, z_o, qw_gu, s_gu,
                           z_gu, qw_d, s_d, z_d, attn_norm, qw_q, s_q, z_q,
                           n_q, x1, gu, out, ss, qkv, m, n_o, dim, hid, eps,
                           rpp_o, rpp_gu, rpp_d, rpp_q);
  const void* kernel = reinterpret_cast<const void*>(&ffn_chain_kernel);
  size_t smem = 0;
  int grid = 0;
  cudaError_t e = chain_launch_shape(a, kernel, 0, 0, &smem, &grid);
  if (e != cudaSuccess) return launch_refused(e);
  void* args[] = {&a};
  e = cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(WARPS * 32), args,
                                  smem, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return launch_refused(e);
  return static_cast<int>(cudaGetLastError());
}

// The attention stage's arguments as attention_step's (qkv (B, (H +
// 2*n_kv)*D) bf16; caches (B, S, n_kv, D) bf16, or int8 with k_scale and
// v_scale (B, S, n_kv) f32; pos (B,) int32; cos2, sinm (B, D) f32; k_new,
// v_new (B, n_kv, D) and, int8 only, ks_new, vs_new (B, n_kv) f32), plus
// rows (B, H*D) bf16 scratch and the window win <= S; then ffn_chain's
// arguments after attn, with m = B and n_o = H*D. The cache is not written.
LLAMA_EXPORT int mono_layer(
    const void* qkv_in, const void* k_cache, const void* v_cache,
    const void* k_scale, const void* v_scale, const void* pos,
    const void* cos2, const void* sinm, void* k_new, void* v_new,
    void* ks_new, void* vs_new, void* rows, int B, int H, int n_kv, int D,
    int S, int win, const void* res, const void* ffn_norm, const void* qw_o,
    const void* s_o, const void* z_o, const void* qw_gu, const void* s_gu,
    const void* z_gu, const void* qw_d, const void* s_d, const void* z_d,
    const void* attn_norm, const void* qw_q, const void* s_q,
    const void* z_q, int n_q, void* x1, void* gu, void* out, void* ss,
    void* qkv, int dim, int hid, float eps, int rpp_o, int rpp_gu,
    int rpp_d, int rpp_q, void* stream) {
  if (D % 32 != 0 || D > attn_step::MAX_D || n_kv < 1 || H % n_kv != 0 ||
      H / n_kv > attn_step::MAX_KV_MUL || B < 1 || win < 0 || win > S ||
      (k_scale == nullptr) != (v_scale == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  AttnArgs t;
  t.qkv = static_cast<const __nv_bfloat16*>(qkv_in);
  t.k_cache = k_cache;
  t.v_cache = v_cache;
  t.k_scale = static_cast<const float*>(k_scale);
  t.v_scale = static_cast<const float*>(v_scale);
  t.pos = static_cast<const int*>(pos);
  t.cos2 = static_cast<const float*>(cos2);
  t.sinm = static_cast<const float*>(sinm);
  t.rows = static_cast<__nv_bfloat16*>(rows);
  t.k_new = k_new;
  t.v_new = v_new;
  t.ks_new = static_cast<float*>(ks_new);
  t.vs_new = static_cast<float*>(vs_new);
  t.B = B;
  t.H = H;
  t.n_kv = n_kv;
  t.D = D;
  t.S = S;
  t.win = win;
  t.scale = static_cast<float>(1.0 / sqrt(static_cast<double>(D)));
  ChainArgs a = make_chain(rows, res, ffn_norm, qw_o, s_o, z_o, qw_gu, s_gu,
                           z_gu, qw_d, s_d, z_d, attn_norm, qw_q, s_q, z_q,
                           n_q, x1, gu, out, ss, qkv, B, H * D, dim, hid, eps,
                           rpp_o, rpp_gu, rpp_d, rpp_q);
  const bool int8 = k_scale != nullptr;
  const void* kernel =
      int8 ? reinterpret_cast<const void*>(&mono_layer_kernel<KV_INT8>)
           : reinterpret_cast<const void*>(&mono_layer_kernel<KV_BF16>);
  size_t smem = 0;
  int grid = 0;
  cudaError_t e = chain_launch_shape(a, kernel, int8 ? 2 : 1,
                                     sizeof(attn_step::Smem), &smem, &grid);
  if (e != cudaSuccess) return launch_refused(e);
  void* args[] = {&t, &a};
  e = cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(WARPS * 32), args,
                                  smem, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return launch_refused(e);
  return static_cast<int>(cudaGetLastError());
}
