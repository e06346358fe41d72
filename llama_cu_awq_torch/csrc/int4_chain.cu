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
//               (h = bf16(silu(g) * u) first, once for the launch)
//               ss  = 1 / sqrt(mean(out^2) + eps)
//     stage Q (optional): qkv = bf16(bf16(out * ss * attn_norm') @ W_qkv')
//   mono_layer first runs attention_step's split decode attention
//   (decode_attention.cuh step_split: every (split, kv head, slot) item,
//   the new cache rows from split 0's phase 1, the splits combined in
//   order by the last item of each (slot, kv head) to finish), whose rows,
//   rounded to bf16, are stage O's attn, and returns the new cache rows
//   (and int8 scales); the caller scatters them.
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
//     count, at most one per column tile of the widest stage), which
//     stride over each stage's column tiles, with cooperative_groups'
//     grid.sync() between the stages: down_qkv.cu's design, with two more
//     stages.
//   - Each stage is int4_gemv.cuh's tensor-core column tile (mma.sync
//     m16n8k16: 16 weight columns in M, a pass's rows in N, raw codes in
//     bf16, zero and scale per group in f32) over rows staged once per
//     pass as bf16 in shared memory with the prologue applied, and each
//     block computes the rms scale of a pass's rows itself with
//     rms_scale's exact reduction. The tile's sums depend on n_in alone,
//     never on the grid, m or the pass, so ffn_chain's x_out, ss and qkv
//     are bit-equal to the launch sequence of the standalone path:
//     int4_gemv (residual), rms_scale, int4_gemv (rmsnorm prologue),
//     int4_gemv (SwiGLU + residual), rms_scale, int4_gemv (rmsnorm
//     prologue), and each row to the same launch on that row alone. x1,
//     gu and out go through global memory and are read back through L2
//     (__ldcg) after the barrier. Rows beyond MAX_ROWS take further passes
//     over the weights, as the GEMV's do.
//   - Staging bytes: every block stages each pass's rows at full width
//     from L2, so a stage moves grid * mr * n_in * 2 bytes. Stage D's
//     SwiGLU prologue is computed once, over the grid, into the gate half
//     of gu (swiglu_rows) behind one more grid barrier, and stage D stages
//     h: each block would otherwise read g and u and redo the exp. At 7B
//     and m=8 stage D's rows are 8 x 11008 x 2 B = 176 KB a block and the
//     others' 8 x 4096 x 2 B = 64 KB; with one block an SM (stage D's
//     staged rows) the launch stages 132 x 368 KB = 49 MB from L2 against
//     106 MB of weights from device memory. Each warp's first code loads
//     are issued before a pass stages its rows, so they are in flight
//     while it does.
//   - mono_layer's attention stage walks attention_step's grid of items,
//     (split, kv head, slot), over the persistent blocks: each block runs
//     up to `groups` items at once, one on each group of D threads (its
//     own named barrier, attn_step::GroupItem, and its own slice of the
//     dynamic shared memory that the later stages stage rows in). At
//     batch 1 and 7B, position 1500 of a 2048-row window, 384 of the 16
//     x 32 items hold rows, 12 splits of each kv head (one item per (slot,
//     kv head) would leave most blocks waiting at the first barrier). Each item runs
//     attention_step's own body (step_split) and the splits combine in
//     attention_step's order, so the attention rows, and with them every
//     output, equal attention_step followed by ffn_chain bit for bit. The
//     groups are as many as fit the block's threads and the shared memory
//     the chain's stages already need (at least one), so the attention
//     stage's shared memory never lowers the grid's occupancy. Its
//     registers do: mono runs one block of 512 threads an SM (128
//     registers, none spilled at MHA), where ffn_chain runs two; held to
//     two, the items spilled and mono ran slower on the H100. The
//     partials and arrival counters are attention_step's scratch
//     (ops/cuda/attention_step.py split_scratch), sized by the wrapper.
//   - No L2 prefetch of the next stage's weights before a barrier (for
//     W_o behind mono's attention stage it measured slower on the H100).
//   - A launch that cannot be co-resident returns its error (as
//     cudaFuncSetAttribute, the occupancy query or the cooperative launch
//     report it); the wrapper raises. It never falls back.

#include <cooperative_groups.h>

#include "attention_step.cuh"
#include "decode_attention.cuh"
#include "int4_gemv.cuh"

namespace cg = cooperative_groups;

namespace {

using attn_step::KV_BF16;
using attn_step::KV_INT8;
using attn_step::MAX_D;
using w4gemv::MAX_ROWS;
using BF16 = __nv_bfloat16;  // the chains' activations (typed epilogues)
using w4gemv::W4;
using w4gemv::WARPS;

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
  float* part_ml;            // attention_step's split scratch
  float* part_acc;
  unsigned* counters;
  int B, H, n_kv, D, S, win;
  int max_splits;            // ceil(win / SPLIT_ROWS)
  int groups;                // items a block runs at once
  int group_floats;          // shared memory of one group, in floats
  float scale;
};

// A group's shared memory, in floats: step_split's Smem, then new_row's
// red and code.
__host__ __device__ inline int item_floats(int kv_mul, int D) {
  return decode_attn::smem_floats(kv_mul, D) + 2 * (MAX_D / 32) + 2 * MAX_D;
}

// The rmsnorm-apply prologue of rows r0..r0+mr-1 of x (m, n) bf16,
// written in this same launch: the rows copied to shared memory behind the
// staged rows, ss_rows[r] from the copy (rms_scale's reduction; block 0
// also stores them to ss_out), then the copy staged with nw.
__device__ __forceinline__ void rms_stage(__nv_bfloat16* xs,
                                          const __nv_bfloat16* x, int n,
                                          const float* nw, int r0, int mr,
                                          float eps, float* part,
                                          float* ss_rows, float* ss_out) {
  __nv_bfloat16* raw = xs + w4gemv::raw_offset(mr, n) / 2;
  w4gemv::copy_rows(raw, x, n, r0, mr, n);
  __syncthreads();
  w4gemv::rms_scale_rows<false, __nv_bfloat16>(raw, DT_BF16, n, mr, n, eps,
                                               part, ss_rows);
  if (ss_out != nullptr && blockIdx.x == 0 && threadIdx.x < mr)
    ss_out[r0 + threadIdx.x] = ss_rows[threadIdx.x];
  w4gemv::stage_rows<1, false>(xs, raw, n, nullptr, 0, ss_rows, nw, 0, mr,
                               n);
}

// Stages O, GU, D and (with a next layer) Q, a grid barrier after each but
// the last. ATTN_L2: attn was written in this launch (mono_layer). Each
// pass issues its warps' first code loads (prefetch) before it stages its
// rows (held across a grid barrier, they cost the chain spilled registers
// and time on the H100); red: the tiles' partial sums.
template <bool ATTN_L2>
__device__ __forceinline__ void chain_stages(const ChainArgs& a,
                                             __nv_bfloat16* xs, float* red,
                                             float* part, float* ss_rows) {
  cg::grid_group grid = cg::this_grid();
  const int dim = a.wo.n_out;
  const int hid = a.wd.n_in;

  // ---- stage O: x1 = bf16(attn @ W_o + x_res) ----
  for (int r0 = 0; r0 < a.m; r0 += a.rpp_o) {
    const int mr = min(a.rpp_o, a.m - r0);
    const w4gemv::TileLoads pre = w4gemv::prefetch(a.wo);
    __syncthreads();  // the previous pass has finished reading xs
    w4gemv::stage_rows<0, ATTN_L2>(xs, a.attn, a.wo.n_in, nullptr, 0,
                                   nullptr, nullptr, r0, mr, a.wo.n_in);
    __syncthreads();
    w4gemv::tile_pass<false, BF16, BF16>(a.wo, pre, xs, r0, mr, a.res,
                                         DT_BF16, a.x1, DT_BF16, red);
  }
  grid.sync();

  // ---- stage GU: gu = bf16(bf16(x1 * ss1 * ffn_norm) @ W_gate_up) ----
  for (int r0 = 0; r0 < a.m; r0 += a.rpp_gu) {
    const int mr = min(a.rpp_gu, a.m - r0);
    const w4gemv::TileLoads pre = w4gemv::prefetch(a.wgu);
    __syncthreads();
    rms_stage(xs, a.x1, dim, a.ffn_norm, r0, mr, a.eps, part, ss_rows,
              nullptr);
    __syncthreads();
    w4gemv::tile_pass<false, BF16, BF16>(a.wgu, pre, xs, r0, mr, nullptr,
                                         DT_BF16, a.gu, DT_BF16, red);
  }
  grid.sync();

  // ---- h = bf16(silu(g) * u), over the gate half of gu in place ----
  w4gemv::swiglu_rows<true>(a.gu, 2 * hid, a.gu + hid, 2 * hid, a.gu,
                            2 * hid, a.m, hid);
  grid.sync();

  // ---- stage D: out = bf16(h @ W_down + x1) ----
  for (int r0 = 0; r0 < a.m; r0 += a.rpp_d) {
    const int mr = min(a.rpp_d, a.m - r0);
    const w4gemv::TileLoads pre = w4gemv::prefetch(a.wd);
    __syncthreads();
    w4gemv::stage_rows<0, true>(xs, a.gu, 2 * hid, nullptr, 0, nullptr,
                                nullptr, r0, mr, hid);
    __syncthreads();
    w4gemv::tile_pass<true, BF16, BF16>(a.wd, pre, xs, r0, mr, a.x1,
                                        DT_BF16, a.out, DT_BF16, red);
  }
  grid.sync();

  if (a.qkv == nullptr) {
    // ---- ss of out, one row per block ----
    for (int r = blockIdx.x; r < a.m; r += gridDim.x)
      w4gemv::rms_scale_rows<true, BF16>(a.out + (size_t)r * dim, DT_BF16,
                                         dim, 1, dim, a.eps, part, a.ss + r);
    return;
  }
  // ---- stage Q: qkv = bf16(bf16(out * ss * attn_norm') @ W_qkv') ----
  for (int r0 = 0; r0 < a.m; r0 += a.rpp_q) {
    const int mr = min(a.rpp_q, a.m - r0);
    const w4gemv::TileLoads pre = w4gemv::prefetch(a.wq);
    __syncthreads();
    rms_stage(xs, a.out, dim, a.attn_norm, r0, mr, a.eps, part, ss_rows,
              a.ss);
    __syncthreads();
    w4gemv::tile_pass<false, BF16, BF16>(a.wq, pre, xs, r0, mr, nullptr,
                                         DT_BF16, a.qkv, DT_BF16, red);
  }
}

__global__ void __launch_bounds__(WARPS * 32) ffn_chain_kernel(ChainArgs a) {
  extern __shared__ __align__(16) __nv_bfloat16 xs[];
  __shared__ float red[2 * w4gemv::RED_FLOATS];
  __shared__ float part[w4gemv::RMS_PART];
  __shared__ float ss_rows[MAX_ROWS];
  chain_stages<false>(a, xs, red, part, ss_rows);
}

// mono_layer's attention stage: attention_step's (split, kv head, slot)
// items, one at a time on each group of D threads, slot gid * gridDim.x +
// blockIdx.x, so consecutive items (the splits of one kv head) land on
// different blocks and SMs.
template <int KV, int KVM>
__device__ __forceinline__ void attention_stage(const AttnArgs& t,
                                                float* smem) {
  const int gid = static_cast<int>(threadIdx.x) / t.D;
  if (gid >= t.groups) return;
  const attn_step::GroupItem it{gid, t.D};
  float* sm = smem + (size_t)gid * t.group_floats;
  float(&red)[2][MAX_D / 32] = *reinterpret_cast<float(*)[2][MAX_D / 32]>(
      sm + decode_attn::smem_floats(t.H / t.n_kv, t.D));
  int(&code)[2][MAX_D] = *reinterpret_cast<int(*)[2][MAX_D]>(
      &red[0][0] + 2 * (MAX_D / 32));
  const int n_items = t.max_splits * t.n_kv * t.B;
  for (int item = gid * gridDim.x + blockIdx.x; item < n_items;
       item += gridDim.x * t.groups) {
    const int split = item % t.max_splits;
    const int kvh = (item / t.max_splits) % t.n_kv;
    const int b = item / (t.max_splits * t.n_kv);
    decode_attn::step_split<KV, KVM>(
        it, sm, red, code, t.qkv, t.k_cache, t.v_cache, t.k_scale,
        t.v_scale, t.pos, t.cos2, t.sinm, t.rows, t.k_new, t.v_new,
        t.ks_new, t.vs_new, t.part_ml, t.part_acc, t.counters, t.H, t.n_kv,
        t.D, t.S, t.win, t.scale, split, kvh, b, t.max_splits);
    it.sync();  // the group's shared memory is free for its next item
  }
}

// KVM: the query heads per kv head compiled for (1 or MAX_KV_MUL), the
// split item's accumulators: at KVM 1 (MHA, 7B) the kernel spills no
// register.
template <int KV, int KVM>
__global__ void __launch_bounds__(WARPS * 32)
mono_layer_kernel(AttnArgs t, ChainArgs a) {
  extern __shared__ __align__(16) __nv_bfloat16 xs[];
  __shared__ float red[2 * w4gemv::RED_FLOATS];
  __shared__ float part[w4gemv::RMS_PART];
  __shared__ float ss_rows[MAX_ROWS];
  attention_stage<KV, KVM>(t, reinterpret_cast<float*>(xs));
  cg::this_grid().sync();  // every attention row is written
  chain_stages<true>(a, xs, red, part, ss_rows);
}

// ffn_chain, then mono_layer for bf16 and int8 KV at KVM 1 and MAX_KV_MUL
constexpr int N_KERNELS = 5;
w4gemv::Residency<N_KERNELS> residency;

bool rpp_ok(int rpp) { return rpp >= 1 && rpp <= MAX_ROWS; }

// Checks the chain's widths and passes; fills the launch's shared-memory
// bytes (the largest stage's staged rows, at least min_smem) and grid.
cudaError_t chain_launch_shape(const ChainArgs& a, const void* kernel,
                               int which, size_t min_smem, size_t* smem,
                               int* grid) {
  const int dim = a.wo.n_out;
  const int hid = a.wd.n_in;
  if (a.wo.n_in % 32 != 0 || dim % 32 != 0 || hid % 32 != 0 || a.m < 1 ||
      reinterpret_cast<uintptr_t>(a.attn) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(a.ffn_norm) % 16 != 0 ||
      (a.qkv != nullptr &&
       reinterpret_cast<uintptr_t>(a.attn_norm) % 16 != 0) ||
      a.wgu.n_in != dim || a.wgu.n_out != 2 * hid || a.wd.n_out != dim ||
      !rpp_ok(a.rpp_o) || !rpp_ok(a.rpp_gu) || !rpp_ok(a.rpp_d) ||
      (a.qkv != nullptr && (a.wq.n_in != dim || !rpp_ok(a.rpp_q) ||
                            a.attn_norm == nullptr)))
    return cudaErrorInvalidValue;
  size_t need = min_smem;
  auto grow = [&need](size_t b) {
    if (b > need) need = b;
  };
  grow(w4gemv::staged_bytes(a.rpp_o, a.wo.n_in));
  grow(w4gemv::staged_raw_bytes(a.rpp_gu, dim));
  grow(w4gemv::staged_bytes(a.rpp_d, hid));
  int cols = a.wgu.n_out;
  if (a.wo.n_out > cols) cols = a.wo.n_out;
  if (a.qkv != nullptr) {
    grow(w4gemv::staged_raw_bytes(a.rpp_q, dim));
    if (a.wq.n_out > cols) cols = a.wq.n_out;
  }
  cudaError_t e = residency.blocks(kernel, which, need, true, grid);
  if (e != cudaSuccess) return e;
  const int tiles = (cols + w4gemv::TILE_N - 1) / w4gemv::TILE_N;
  if (*grid > tiles) *grid = tiles;
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
  a.wo = w4gemv::make_w4(qw_o, s_o, z_o, n_o, dim);
  a.wgu = w4gemv::make_w4(qw_gu, s_gu, z_gu, dim, 2 * hid);
  a.wd = w4gemv::make_w4(qw_d, s_d, z_d, hid, dim);
  a.wq = w4gemv::make_w4(qw_q, s_q, z_q, dim, n_q);
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
// each stage (1..MAX_ROWS). Needs n_o, dim and hid multiples of 32, attn
// and the norm weights 16-byte aligned.
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
// v_new (B, n_kv, D) and, int8 only, ks_new, vs_new (B, n_kv) f32; its
// scratch part_ml, part_acc and counters, sized and zeroed as
// attention_step's for the window), plus rows (B, H*D) bf16 scratch and
// the window 1 <= win <= S; then ffn_chain's arguments after attn, with
// m = B and n_o = H*D. The cache is not written.
LLAMA_EXPORT int mono_layer(
    const void* qkv_in, const void* k_cache, const void* v_cache,
    const void* k_scale, const void* v_scale, const void* pos,
    const void* cos2, const void* sinm, void* k_new, void* v_new,
    void* ks_new, void* vs_new, void* part_ml, void* part_acc,
    void* counters, void* rows, int B, int H, int n_kv, int D, int S,
    int win, const void* res, const void* ffn_norm, const void* qw_o,
    const void* s_o, const void* z_o, const void* qw_gu, const void* s_gu,
    const void* z_gu, const void* qw_d, const void* s_d, const void* z_d,
    const void* attn_norm, const void* qw_q, const void* s_q,
    const void* z_q, int n_q, void* x1, void* gu, void* out, void* ss,
    void* qkv, int dim, int hid, float eps, int rpp_o, int rpp_gu,
    int rpp_d, int rpp_q, void* stream) {
  if (D % 32 != 0 || D > attn_step::MAX_D || n_kv < 1 || H % n_kv != 0 ||
      H / n_kv > attn_step::MAX_KV_MUL || B < 1 || win < 1 || win > S ||
      (k_scale == nullptr) != (v_scale == nullptr) ||
      reinterpret_cast<uintptr_t>(k_cache) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(v_cache) % 16 != 0)
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
  t.part_ml = static_cast<float*>(part_ml);
  t.part_acc = static_cast<float*>(part_acc);
  t.counters = static_cast<unsigned*>(counters);
  t.B = B;
  t.H = H;
  t.n_kv = n_kv;
  t.D = D;
  t.S = S;
  t.win = win;
  t.max_splits = (win + decode_attn::SPLIT_ROWS - 1) / decode_attn::SPLIT_ROWS;
  t.scale = static_cast<float>(1.0 / sqrt(static_cast<double>(D)));
  ChainArgs a = make_chain(rows, res, ffn_norm, qw_o, s_o, z_o, qw_gu, s_gu,
                           z_gu, qw_d, s_d, z_d, attn_norm, qw_q, s_q, z_q,
                           n_q, x1, gu, out, ss, qkv, B, H * D, dim, hid, eps,
                           rpp_o, rpp_gu, rpp_d, rpp_q);
  const bool int8 = k_scale != nullptr;
  const bool mha = H == n_kv;
  const void* kernels[4] = {
      reinterpret_cast<const void*>(&mono_layer_kernel<KV_BF16, 1>),
      reinterpret_cast<const void*>(
          &mono_layer_kernel<KV_BF16, attn_step::MAX_KV_MUL>),
      reinterpret_cast<const void*>(&mono_layer_kernel<KV_INT8, 1>),
      reinterpret_cast<const void*>(
          &mono_layer_kernel<KV_INT8, attn_step::MAX_KV_MUL>)};
  const int which = (int8 ? 2 : 0) + (mha ? 0 : 1);
  const void* kernel = kernels[which];
  // at least one group; then as many as the chain's shared memory holds
  t.group_floats = item_floats(H / n_kv, D);
  const size_t group_bytes = sizeof(float) * t.group_floats;
  size_t smem = 0;
  int grid = 0;
  cudaError_t e = chain_launch_shape(a, kernel, 1 + which, group_bytes,
                                     &smem, &grid);
  if (e != cudaSuccess) return launch_refused(e);
  t.groups = static_cast<int>(smem / group_bytes);
  if (t.groups > WARPS * 32 / D) t.groups = WARPS * 32 / D;
  if (t.groups > attn_step::MAX_GROUPS) t.groups = attn_step::MAX_GROUPS;
  void* args[] = {&t, &a};
  e = cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(WARPS * 32), args,
                                  smem, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return launch_refused(e);
  return static_cast<int>(cudaGetLastError());
}
