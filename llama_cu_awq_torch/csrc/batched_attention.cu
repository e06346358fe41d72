// Decode attention for one query token per slot over a KV cache that already
// holds the current row: slot b's heads attend to cache rows s <= pos[b],
// for the bf16, fp16, f32 and int8 caches, the window split across blocks
// (flash-decoding, decode_attention.cuh). q is bf16, fp16 or f32
// (--act-dtype) and rounds to bf16 as it loads; the unquantized cache's
// fp16 or f32 rows round to bf16 as they load, as the JAX kernel casts q
// and its blocks (batched_attention.py:83, 100-101): the bf16 cache's
// arithmetic, on twice its bytes for f32.
//
// Replaces: llama_cu_awq_tpu/ops/pallas/batched_attention.py,
//   batched_decode_attention (kernel _make_kernel, block size _pick_blk).
//
// What bounds it on the H100: the cache bytes. A slot reads rows 0..pos[b]
//   of k and v once: at 7B with a bf16 cache and one slot at position 1500
//   that is 1501 rows x 32 heads x 128 x 2 B x 2 = 24.6 MB per layer (7.35
//   us at 3.35 TB/s); the int8 cache halves it and adds 4 B of scales per
//   row and head. The arithmetic is 4 flops per cache element, far below
//   the tensor cores' line.
//
// What the design does about it: the split design of attention_step.cu
//   without its first phase (the current row is in the cache here). The
//   grid is (splits, n_kv, B), a split a fixed run of SPLIT_ROWS rows; D
//   threads a block cover the kv_mul query heads of the kv head, so each
//   k/v row is read once for all of them (the JAX kernel's block-diagonal
//   Q_bd does the same on the TPU's matrix unit), as 16-byte vectors.
//   Scores are f32 dots of the bf16-rounded q with the row (codes for
//   int8), times the row's k scale, times 1/sqrt(D); masked rows score
//   -1e30 and get p = 0; p is multiplied by the row's v scale and rounded
//   to bf16 before the PV product, against the split's max
//   (batched_attention.py:106-143). early_exit != 0 ("batched") splits
//   rows 0..pos[b]; early_exit == 0 ("batched_static") splits the whole
//   window under the mask and reads every row of it, which is what that
//   variant exists to measure: a split whose rows are all masked
//   contributes l = 0 and acc = 0 and stays out of the combined max.

#include "attention_step.cuh"
#include "decode_attention.cuh"

namespace {

using attn_step::KV_BF16;
using attn_step::KV_F16;
using attn_step::KV_F32;
using attn_step::KV_INT8;
using attn_step::MAX_D;
using attn_step::MAX_KV_MUL;
using decode_attn::SPLIT_ROWS;

// block (split, kv head, slot), D threads
template <int KV, typename QT>
__global__ void __launch_bounds__(MAX_D)
batched_attention_kernel(const QT* __restrict__ q,
                         const void* __restrict__ k_cache,
                         const void* __restrict__ v_cache,
                         const float* __restrict__ k_scale,
                         const float* __restrict__ v_scale,
                         const int* __restrict__ pos, float* __restrict__ out,
                         float* __restrict__ part_ml,
                         float* __restrict__ part_acc,
                         unsigned* __restrict__ counters, int H, int n_kv,
                         int D, int S, int window, int early_exit,
                         float scale) {
  extern __shared__ float4 dyn_smem[];
  const int split = blockIdx.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int p0 = pos[b];
  const int n_rows = early_exit ? min(p0 + 1, window) : window;
  const int n_splits = (n_rows + SPLIT_ROWS - 1) / SPLIT_ROWS;
  if (split >= n_splits) return;
  const int t = threadIdx.x;  // blockDim.x == D
  const int kv_mul = H / n_kv;
  const decode_attn::Smem sm = decode_attn::carve(
      reinterpret_cast<float*>(dyn_smem), kv_mul, D);
  for (int h = 0; h < kv_mul; ++h)
    sm.q[h * D + t] =
        round_bf16(to_f32(q[((size_t)b * H + kvh * kv_mul + h) * D + t]));
  const int r0 = split * SPLIT_ROWS;
  const attn_step::BlockItem it{};
  const decode_attn::Partial pt = decode_attn::attend_split<KV, MAX_KV_MUL>(
      it, sm, k_cache, v_cache, k_scale, v_scale, (size_t)b * S * n_kv + kvh,
      n_kv, r0, min(SPLIT_ROWS, n_rows - r0), p0, nullptr, kv_mul, D, scale);
  decode_attn::finish_split(
      it, sm, pt, out + ((size_t)b * H + kvh * kv_mul) * D, part_ml,
      part_acc, counters, (size_t)b * n_kv + kvh, split, n_splits, gridDim.x,
      kv_mul, D);
}

template <int KV, typename QT>
int launch(const void* q, const void* k_cache, const void* v_cache,
           const void* k_scale, const void* v_scale, const void* pos,
           void* out, void* part_ml, void* part_acc, void* counters, int B,
           int H, int n_kv, int D, int S, int window, int early_exit,
           float scale, cudaStream_t stream) {
  const int max_splits = (window + SPLIT_ROWS - 1) / SPLIT_ROWS;
  const size_t smem = sizeof(float) * decode_attn::smem_floats(H / n_kv, D);
  const cudaError_t e =
      decode_attn::prepare_smem(batched_attention_kernel<KV, QT>, smem);
  if (e != cudaSuccess) return launch_refused(e);
  batched_attention_kernel<KV, QT><<<dim3(max_splits, n_kv, B), D, smem,
                                     stream>>>(
      static_cast<const QT*>(q), k_cache, v_cache,
      static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
      static_cast<const int*>(pos), static_cast<float*>(out),
      static_cast<float*>(part_ml), static_cast<float*>(part_acc),
      static_cast<unsigned*>(counters), H, n_kv, D, S, window, early_exit,
      scale);
  return static_cast<int>(cudaGetLastError());
}

// launch<KV, QT> for q's type code q_dt
template <int KV>
int launch_q(int q_dt, const void* q, const void* k_cache,
             const void* v_cache, const void* k_scale, const void* v_scale,
             const void* pos, void* out, void* part_ml, void* part_acc,
             void* counters, int B, int H, int n_kv, int D, int S,
             int window, int early_exit, float scale, cudaStream_t stream) {
#define LAUNCH(QT)                                                          \
  launch<KV, QT>(q, k_cache, v_cache, k_scale, v_scale, pos, out, part_ml, \
                 part_acc, counters, B, H, n_kv, D, S, window, early_exit,  \
                 scale, stream)
  if (q_dt == DT_BF16) return LAUNCH(__nv_bfloat16);
  if (q_dt == DT_F16) return LAUNCH(__half);
  if (q_dt == DT_F32) return LAUNCH(float);
#undef LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q: (B, H, D) of type code q_dt (DT_F32, DT_BF16 or DT_F16).
// k_cache/v_cache: (B, S, n_kv, D) of type code kv_dt, or int8 codes when
// k_scale/v_scale ((B, S, n_kv) f32) are given (kv_dt is then ignored);
// row pos[b] already written. pos: (B,) int32 on the device, each below
// window (<= S). out: (B, H, D) f32. early_exit: 1 reads rows <= pos[b], 0
// the whole window. Scratch: part_ml (B*n_kv*splits*2*kv_mul f32) and
// part_acc (B*n_kv*splits*kv_mul*D f32) with splits = ceil(window /
// SPLIT_ROWS), and counters (B*n_kv uint32), zero before the launch and
// zero after it.
LLAMA_EXPORT int batched_decode_attention(
    const void* q, const void* k_cache, const void* v_cache,
    const void* k_scale, const void* v_scale, const void* pos, void* out,
    void* part_ml, void* part_acc, void* counters, int B, int H, int n_kv,
    int D, int S, int window, int early_exit, float scale, int q_dt,
    int kv_dt, void* stream) {
  if (D % 32 != 0 || D > MAX_D || H % n_kv != 0 ||
      H / n_kv > MAX_KV_MUL || B < 1 || window < 1 || window > S)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define LAUNCH(KV)                                                       \
  launch_q<KV>(q_dt, q, k_cache, v_cache, k_scale, v_scale, pos, out,   \
               part_ml, part_acc, counters, B, H, n_kv, D, S, window,   \
               early_exit, scale, st)
  if (k_scale != nullptr) return LAUNCH(KV_INT8);
  if (kv_dt == DT_BF16) return LAUNCH(KV_BF16);
  if (kv_dt == DT_F16) return LAUNCH(KV_F16);
  if (kv_dt == DT_F32) return LAUNCH(KV_F32);
#undef LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}
