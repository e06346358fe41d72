// One decode attention step straight from the fused qkv row: split, RoPE,
// bf16 rounding of q and k, optional quantization of the new k/v row (int8,
// or int4 packed two to a byte), then GQA attention over the cache rows
// below min(pos[b], win) plus the current token, the window split across
// blocks (flash-decoding, decode_attention.cuh). The qkv row is bf16, fp16
// or f32 (--act-dtype); the unquantized cache has the qkv row's type, and
// its fp16 or f32 rows round to bf16 as they load, as the JAX kernel casts
// its blocks (attention_step.py:211-212): the same arithmetic as the bf16
// cache on twice the bytes for f32. The new row is the bf16-rounded k and
// v widened to the cache's type (attention_step.py:190-204).
//
// Replaces: llama_cu_awq_tpu/ops/pallas/attention_step.py, attention_step
//   (kernel _make_kernel), for the bf16 and the int8 cache, and
//   _attention_step_kv4 (kernel _make_kernel_kv4, unpack _unpack4) for the
//   int4 cache.
//
// What bounds it on the H100: the cache bytes. A step reads every history
//   row of k and v once: at 7B with a bf16 cache at position 1500 that is
//   32 heads x 1500 rows x 128 x 2 B x 2 = 24.6 MB per layer (7.35 us at
//   3.35 TB/s); the int8 cache halves it and adds 4 B of scales per row and
//   head; the int4 cache reads 1500 x 32 x (64 + 4) B x 2 = 6.5 MB (1.96
//   us). The arithmetic is 4 flops per cache element, far below the tensor
//   cores' line.
//
// What the design does about it: the bytes need many blocks in flight.
//   One block per (slot, kv head) gave 32 blocks at batch 1 on 132 SMs,
//   each walking ~24 chunks in series with scalar 2-byte loads: 1.3 % of
//   the bound. Here the grid is (splits, n_kv, B): a split is a fixed run
//   of SPLIT_ROWS history rows (decode_attention.cuh, 128), so slot b has
//   max(1, ceil(min(pos[b], win) / SPLIT_ROWS)) splits; the
//   launch covers the window's splits, and blocks past a slot's rows exit
//   at once.
//   D threads a block cover the kv_mul query heads of the kv head, so a
//   k/v row is read once for all of them, as 16-byte vectors
//   (decode_attention.cuh). Phase 1 (attention_step.cuh new_row: RoPE in
//   f32 as x*cos2 + rot_half(x)*sinm, bf16 rounding as attention_step.py:
//   150-163, for int8 the scale absmax * f32(1/127), floor 1e-10, and
//   round-half-even codes) runs in split 0 only; every split recomputes
//   the rotated q (kv_mul x D multiplies). Split 0 visits the current token first, as
//   the JAX kernel does (p = 1 times its v scale, rounded to bf16; the
//   split's max starts at its score; its term scaled by exp(s_cur - m)).
//   Scores are f32, not staged through bf16 (the einsum path does that,
//   models/llama.py:408); p is rounded to bf16 before the PV product
//   (attention_step.py:139-141), against the split's own max. The last
//   block of each (slot, kv head) combines the splits in order, so a
//   layer is one launch and its bits repeat run to run.
//
// The int4 cache (attention_step_kv4): a head's row is D/2 bytes, byte i
//   holding lane i in its low nibble and lane i + D/2 in its high nibble
//   (quant/kv.py's halves packing, the JAX package's quantize_kv4), read
//   back with the sign rule ((c & 0xF) ^ 8) - 8 of _unpack4. The new row
//   is quantized and packed here (the JAX package does it in XLA before its
//   kernel only because Mosaic could not lower the pack): scale absmax *
//   f32(1/7) (what XLA makes of absmax/7 in a jit), floor 1e-10, codes
//   rintf and clipped to [-7, 7]. The current row enters the softmax as its
//   codes, the same values a later step unpacks from the cache; ks folds
//   into the scores and vs into p before p's bf16 rounding
//   (attention_step.py:293, 307), exactly as for int8.

#include "attention_step.cuh"
#include "decode_attention.cuh"

namespace {

using attn_step::KV_BF16;
using attn_step::KV_F16;
using attn_step::KV_F32;
using attn_step::KV_INT4;
using attn_step::KV_INT8;
using attn_step::MAX_D;
using attn_step::MAX_KV_MUL;
using decode_attn::SPLIT_ROWS;

// block (split, kv head, slot), D threads: one step_split item
template <int KV, typename QT>
__global__ void __launch_bounds__(MAX_D)
attention_step_kernel(const QT* __restrict__ qkv,
                      const void* __restrict__ k_cache,
                      const void* __restrict__ v_cache,
                      const float* __restrict__ k_scale,
                      const float* __restrict__ v_scale,
                      const int* __restrict__ pos,
                      const float* __restrict__ cos2,
                      const float* __restrict__ sinm,
                      float* __restrict__ attn, void* __restrict__ k_new,
                      void* __restrict__ v_new, float* __restrict__ ks_new,
                      float* __restrict__ vs_new, float* __restrict__ part_ml,
                      float* __restrict__ part_acc,
                      unsigned* __restrict__ counters, int H, int n_kv, int D,
                      int S, int win, float scale) {
  extern __shared__ float4 dyn_smem[];
  __shared__ float red[2][MAX_D / 32];
  __shared__ int code[2][MAX_D];
  decode_attn::step_split<KV, MAX_KV_MUL>(
      attn_step::BlockItem{}, reinterpret_cast<float*>(dyn_smem), red, code,
      qkv, k_cache, v_cache, k_scale, v_scale, pos, cos2, sinm, attn, k_new,
      v_new, ks_new, vs_new, part_ml, part_acc, counters, H, n_kv, D, S, win,
      scale, blockIdx.x, blockIdx.y, blockIdx.z, gridDim.x);
}

template <int KV, typename QT>
int launch(const void* qkv, const void* k_cache, const void* v_cache,
           const void* k_scale, const void* v_scale, const void* pos,
           const void* cos2, const void* sinm, void* attn, void* k_new,
           void* v_new, void* ks_new, void* vs_new, void* part_ml,
           void* part_acc, void* counters, int B, int H, int n_kv, int D,
           int S, int win, void* stream) {
  if (D % 32 != 0 || D > MAX_D || H % n_kv != 0 ||
      H / n_kv > MAX_KV_MUL || B < 1 || win < 1 || win > S)
    return static_cast<int>(cudaErrorInvalidValue);
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(D)));
  const int max_splits = (win + SPLIT_ROWS - 1) / SPLIT_ROWS;
  const size_t smem = sizeof(float) * decode_attn::smem_floats(H / n_kv, D);
  const cudaError_t e =
      decode_attn::prepare_smem(attention_step_kernel<KV, QT>, smem);
  if (e != cudaSuccess) return launch_refused(e);
  attention_step_kernel<KV, QT><<<dim3(max_splits, n_kv, B), D, smem,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const QT*>(qkv), k_cache, v_cache,
      static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
      static_cast<const int*>(pos), static_cast<const float*>(cos2),
      static_cast<const float*>(sinm), static_cast<float*>(attn), k_new, v_new,
      static_cast<float*>(ks_new), static_cast<float*>(vs_new),
      static_cast<float*>(part_ml), static_cast<float*>(part_acc),
      static_cast<unsigned*>(counters), H, n_kv, D, S, win, scale);
  return static_cast<int>(cudaGetLastError());
}

// launch<KV, QT> with QT the type of qkv_dt
template <int KV>
int launch_qkv(int qkv_dt, const void* qkv, const void* k_cache,
               const void* v_cache, const void* k_scale, const void* v_scale,
               const void* pos, const void* cos2, const void* sinm,
               void* attn, void* k_new, void* v_new, void* ks_new,
               void* vs_new, void* part_ml, void* part_acc, void* counters,
               int B, int H, int n_kv, int D, int S, int win, void* stream) {
  if (qkv_dt == DT_BF16)
    return launch<KV, __nv_bfloat16>(
        qkv, k_cache, v_cache, k_scale, v_scale, pos, cos2, sinm, attn, k_new,
        v_new, ks_new, vs_new, part_ml, part_acc, counters, B, H, n_kv, D, S,
        win, stream);
  if (qkv_dt == DT_F16)
    return launch<KV, __half>(qkv, k_cache, v_cache, k_scale, v_scale, pos,
                              cos2, sinm, attn, k_new, v_new, ks_new, vs_new,
                              part_ml, part_acc, counters, B, H, n_kv, D, S,
                              win, stream);
  if (qkv_dt == DT_F32)
    return launch<KV, float>(qkv, k_cache, v_cache, k_scale, v_scale, pos,
                             cos2, sinm, attn, k_new, v_new, ks_new, vs_new,
                             part_ml, part_acc, counters, B, H, n_kv, D, S,
                             win, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// qkv: (B, (H + 2*n_kv)*D) of type code qkv_dt (DT_F32, DT_BF16 or
// DT_F16). k_cache/v_cache: (B, S, n_kv, D) of the same type, or int8
// codes when k_scale/v_scale ((B, S, n_kv) f32) are given; rows below
// min(pos[b], win) are history. pos: (B,) int32 on the device. cos2/sinm:
// (B, D) f32. Outputs: attn (B, H, D) f32; k_new/v_new (B, n_kv, D) in the
// cache's type; ks_new/vs_new (B, n_kv) f32 (int8 only). Scratch: part_ml
// (B*n_kv*splits*2*kv_mul f32) and part_acc (B*n_kv*splits*kv_mul*D f32)
// with splits = ceil(win / SPLIT_ROWS), and counters (B*n_kv uint32), zero
// before the launch and zero after it.
LLAMA_EXPORT int attention_step(const void* qkv, const void* k_cache,
                                const void* v_cache, const void* k_scale,
                                const void* v_scale, const void* pos,
                                const void* cos2, const void* sinm,
                                void* attn, void* k_new, void* v_new,
                                void* ks_new, void* vs_new, void* part_ml,
                                void* part_acc, void* counters, int B, int H,
                                int n_kv, int D, int S, int win, int qkv_dt,
                                void* stream) {
  if (k_scale != nullptr)
    return launch_qkv<KV_INT8>(qkv_dt, qkv, k_cache, v_cache, k_scale,
                               v_scale, pos, cos2, sinm, attn, k_new, v_new,
                               ks_new, vs_new, part_ml, part_acc, counters, B,
                               H, n_kv, D, S, win, stream);
  if (qkv_dt == DT_BF16)
    return launch<KV_BF16, __nv_bfloat16>(
        qkv, k_cache, v_cache, nullptr, nullptr, pos, cos2, sinm, attn, k_new,
        v_new, nullptr, nullptr, part_ml, part_acc, counters, B, H, n_kv, D,
        S, win, stream);
  if (qkv_dt == DT_F16)
    return launch<KV_F16, __half>(qkv, k_cache, v_cache, nullptr, nullptr,
                                  pos, cos2, sinm, attn, k_new, v_new,
                                  nullptr, nullptr, part_ml, part_acc,
                                  counters, B, H, n_kv, D, S, win, stream);
  if (qkv_dt == DT_F32)
    return launch<KV_F32, float>(qkv, k_cache, v_cache, nullptr, nullptr,
                                 pos, cos2, sinm, attn, k_new, v_new, nullptr,
                                 nullptr, part_ml, part_acc, counters, B, H,
                                 n_kv, D, S, win, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The int4 cache: k_cache/v_cache (B, S, n_kv, D/2) int8, packed in halves,
// with k_scale/v_scale (B, S, n_kv) f32 required; k_new/v_new come back
// packed, (B, n_kv, D/2) int8, with ks_new/vs_new (B, n_kv) f32. qkv as
// for attention_step.
LLAMA_EXPORT int attention_step_kv4(
    const void* qkv, const void* k_cache, const void* v_cache,
    const void* k_scale, const void* v_scale, const void* pos,
    const void* cos2, const void* sinm, void* attn, void* k_new, void* v_new,
    void* ks_new, void* vs_new, void* part_ml, void* part_acc, void* counters,
    int B, int H, int n_kv, int D, int S, int win, int qkv_dt, void* stream) {
  if (k_scale == nullptr || v_scale == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_qkv<KV_INT4>(qkv_dt, qkv, k_cache, v_cache, k_scale, v_scale,
                             pos, cos2, sinm, attn, k_new, v_new, ks_new,
                             vs_new, part_ml, part_acc, counters, B, H, n_kv,
                             D, S, win, stream);
}
