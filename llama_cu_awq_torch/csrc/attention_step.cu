// One decode attention step straight from the fused qkv row: split, RoPE,
// bf16 rounding of q and k, optional quantization of the new k/v row (int8,
// or int4 packed two to a byte), then GQA attention over the cache rows
// below min(pos[b], win) plus the current token, the window split across
// blocks (flash-decoding, decode_attention.cuh).
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
using attn_step::KV_INT4;
using attn_step::KV_INT8;
using attn_step::MAX_D;
using attn_step::MAX_KV_MUL;
using decode_attn::SPLIT_ROWS;

// block (split, kv head, slot), D threads
template <int KV>
__global__ void __launch_bounds__(MAX_D)
attention_step_kernel(const __nv_bfloat16* __restrict__ qkv,
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
  constexpr bool QUANT = KV != KV_BF16;
  extern __shared__ float4 dyn_smem[];
  __shared__ float red[2][MAX_D / 32];
  __shared__ int code[2][MAX_D];
  const int split = blockIdx.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int n_hist = min(pos[b], win);
  const int n_splits = max(1, (n_hist + SPLIT_ROWS - 1) / SPLIT_ROWS);
  if (split >= n_splits) return;
  const int t = threadIdx.x;  // blockDim.x == D
  const int lane = t & 31;
  const int kv_mul = H / n_kv;
  const int half = D / 2;
  const decode_attn::Smem sm = decode_attn::carve(
      reinterpret_cast<float*>(dyn_smem), kv_mul, D);
  const __nv_bfloat16* row = qkv + (size_t)b * (H + 2 * n_kv) * D;
  const float c = cos2[(size_t)b * D + t];
  const float sn = sinm[(size_t)b * D + t];
  const int partner = t < half ? t + half : t - half;
  for (int h = 0; h < kv_mul; ++h)
    sm.q[h * D + t] = attn_step::rope_elem(
        row + (size_t)(kvh * kv_mul + h) * D, t, partner, c, sn);
  float vcur = 0.0f;
  float vsc = 1.0f;
  if (split == 0) {
    float kcur, ksc;
    attn_step::new_row<KV, false>(red, code, row, c, sn, partner, k_new,
                                  v_new, ks_new, vs_new, H, n_kv, D, kvh,
                                  (size_t)b * n_kv + kvh, kcur, vcur, ksc,
                                  vsc);
    sm.kcur[t] = kcur;
    __syncthreads();
    if (t < 32) {
      // the current token's score, elements lane + 32*i
      for (int h = 0; h < kv_mul; ++h) {
        float part = 0.0f;
        for (int e = lane; e < D; e += 32)
          part = fmaf(sm.kcur[e], sm.q[h * D + e], part);
        part = warp_sum(part);
        if (lane == 0) {
          float raw = part;
          if constexpr (QUANT) raw = raw * ksc;
          sm.scur[h] = raw * scale;
        }
      }
    }
  }
  const int r0 = split * SPLIT_ROWS;
  decode_attn::Partial pt = decode_attn::attend_split<KV>(
      sm, k_cache, v_cache, k_scale, v_scale, (size_t)b * S * n_kv + kvh,
      n_kv, r0, min(SPLIT_ROWS, n_hist - r0), INT_MAX,
      split == 0 ? sm.scur : nullptr, kv_mul, D, scale);
  if (split == 0) {
    // the current token's term: p = 1 times its v scale, rounded to bf16,
    // then scaled by alpha = exp(s_cur - m) as the online softmax does
    const float p = round_bf16(QUANT ? vsc : 1.0f);
#pragma unroll
    for (int h = 0; h < MAX_KV_MUL; ++h)
      if (h < kv_mul) {
        const float alpha = expf(sm.scur[h] - pt.m[h]);
        pt.l[h] = __fadd_rn(alpha, pt.l[h]);
        pt.acc[h] = __fadd_rn(__fmul_rn(p * vcur, alpha), pt.acc[h]);
      }
  }
  decode_attn::finish_split(
      pt, attn + ((size_t)b * H + kvh * kv_mul) * D, part_ml, part_acc,
      counters, (size_t)b * n_kv + kvh, split, n_splits, gridDim.x, kv_mul,
      D);
}

template <int KV>
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
      decode_attn::prepare_smem(attention_step_kernel<KV>, smem);
  if (e != cudaSuccess) return launch_refused(e);
  attention_step_kernel<KV><<<dim3(max_splits, n_kv, B), D, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(qkv), k_cache, v_cache,
      static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
      static_cast<const int*>(pos), static_cast<const float*>(cos2),
      static_cast<const float*>(sinm), static_cast<float*>(attn), k_new, v_new,
      static_cast<float*>(ks_new), static_cast<float*>(vs_new),
      static_cast<float*>(part_ml), static_cast<float*>(part_acc),
      static_cast<unsigned*>(counters), H, n_kv, D, S, win, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// qkv: (B, (H + 2*n_kv)*D) bf16. k_cache/v_cache: (B, S, n_kv, D) bf16,
// or int8 codes when k_scale/v_scale ((B, S, n_kv) f32) are given; rows
// below min(pos[b], win) are history. pos: (B,) int32 on the device.
// cos2/sinm: (B, D) f32. Outputs: attn (B, H, D) f32; k_new/v_new (B,
// n_kv, D) in the cache's dtype; ks_new/vs_new (B, n_kv) f32 (int8 only).
// Scratch: part_ml (B*n_kv*splits*2*kv_mul f32) and part_acc
// (B*n_kv*splits*kv_mul*D f32) with splits = ceil(win / SPLIT_ROWS), and
// counters (B*n_kv uint32), zero before the launch and zero after it.
LLAMA_EXPORT int attention_step(const void* qkv, const void* k_cache,
                                const void* v_cache, const void* k_scale,
                                const void* v_scale, const void* pos,
                                const void* cos2, const void* sinm,
                                void* attn, void* k_new, void* v_new,
                                void* ks_new, void* vs_new, void* part_ml,
                                void* part_acc, void* counters, int B, int H,
                                int n_kv, int D, int S, int win,
                                void* stream) {
  if (k_scale != nullptr)
    return launch<KV_INT8>(qkv, k_cache, v_cache, k_scale, v_scale, pos, cos2,
                           sinm, attn, k_new, v_new, ks_new, vs_new, part_ml,
                           part_acc, counters, B, H, n_kv, D, S, win,
                           stream);
  return launch<KV_BF16>(qkv, k_cache, v_cache, nullptr, nullptr, pos, cos2,
                         sinm, attn, k_new, v_new, nullptr, nullptr, part_ml,
                         part_acc, counters, B, H, n_kv, D, S, win, stream);
}

// The int4 cache: k_cache/v_cache (B, S, n_kv, D/2) int8, packed in halves,
// with k_scale/v_scale (B, S, n_kv) f32 required; k_new/v_new come back
// packed, (B, n_kv, D/2) int8, with ks_new/vs_new (B, n_kv) f32.
LLAMA_EXPORT int attention_step_kv4(
    const void* qkv, const void* k_cache, const void* v_cache,
    const void* k_scale, const void* v_scale, const void* pos,
    const void* cos2, const void* sinm, void* attn, void* k_new, void* v_new,
    void* ks_new, void* vs_new, void* part_ml, void* part_acc, void* counters,
    int B, int H, int n_kv, int D, int S, int win, void* stream) {
  if (k_scale == nullptr || v_scale == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch<KV_INT4>(qkv, k_cache, v_cache, k_scale, v_scale, pos, cos2,
                         sinm, attn, k_new, v_new, ks_new, vs_new, part_ml,
                         part_acc, counters, B, H, n_kv, D, S, win, stream);
}
