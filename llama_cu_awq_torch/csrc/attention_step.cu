// One decode attention step straight from the fused qkv row: split, RoPE,
// bf16 rounding of q and k, optional quantization of the new k/v row (int8,
// or int4 packed two to a byte), then online-softmax GQA attention over the
// cache rows below pos[b] plus the current token.
//
// Replaces: llama_cu_awq_tpu/ops/pallas/attention_step.py, attention_step
//   (kernel _make_kernel), for the bf16 and the int8 cache, and
//   _attention_step_kv4 (kernel _make_kernel_kv4, unpack _unpack4) for the
//   int4 cache. The per-(slot, kv head) body is in attention_step.cuh,
//   which int4_chain.cu's mono_layer runs too.
//
// What bounds it on the H100: the cache bytes. A step reads every history
//   row of k and v once: at 7B with a bf16 cache at position 1500 that is
//   32 heads x 1500 rows x 128 x 2 B x 2 = 24.6 MB per layer (7.3 us at
//   3.35 TB/s); the int8 cache halves it and adds 4 B of scales per row and
//   head. The arithmetic is 4 flops per cache element, far below the
//   tensor cores' line.
//
// What the design does about it: one block per (slot, kv head), D threads,
//   covering the kv_mul query heads that share the kv head, so each k/v
//   row is read once for all of them. A warp reads a k row as 32 lanes of
//   consecutive elements; a thread reads one element of each v row.
//   Phase 1 rotates q and k in f32 as x*cos2 + rot_half(x)*sinm, rounds
//   them to bf16 (as attention_step.py:150-163 does), and for int8
//   quantizes k and v with the scale absmax * f32(1/127) (floor 1e-10;
//   what XLA makes of absmax/127) and round-half-even (rintf, as
//   jnp.round). Phase 2 is the online softmax, visiting the
//   current token first and then the history in chunks of CHUNK rows:
//   f32 scores scaled by 1/sqrt(D), int8 scales folded as raw*ks and p*vs,
//   p rounded to bf16 before the PV product (attention_step.py:139-141).
//   Scores are not staged through bf16 (the einsum path does that,
//   models/llama.py:408); this follows the JAX attention_step kernel.
//   Single-block-per-head parallelism leaves most SMs idle at batch 1;
//   splitting the history across blocks is later work.
//
// The int4 cache (attention_step_kv4): a head's row is D/2 bytes, byte i
//   holding lane i in its low nibble and lane i + D/2 in its high nibble
//   (quant/kv.py's halves packing, the JAX package's quantize_kv4), read
//   back with the sign rule ((c & 0xF) ^ 8) - 8 of _unpack4. It moves a
//   quarter of the
//   bf16 cache's bytes plus the scales: 1500 rows x 32 heads x (64 + 4) B
//   x 2 = 6.5 MB per layer at 7B, 1.95 us. The new row is quantized and
//   packed here (the JAX package does it in XLA before its kernel only
//   because Mosaic could not lower the pack): scale absmax * f32(1/7)
//   (what XLA makes of absmax/7 in a jit), floor 1e-10, codes rintf and
//   clipped to [-7, 7]. The current row enters the softmax as its codes,
//   the same values a later step unpacks from the cache; ks folds into the
//   scores and vs into p before p's bf16 rounding (attention_step.py:293,
//   307), exactly as for int8.

#include "attention_step.cuh"

namespace {

using attn_step::KV_BF16;
using attn_step::KV_INT4;
using attn_step::KV_INT8;
using attn_step::MAX_D;
using attn_step::MAX_KV_MUL;

// one block per (kv head, slot), D threads: the body of attention_step.cuh
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
                      float* __restrict__ vs_new, int H, int n_kv, int D,
                      int S, float scale) {
  __shared__ attn_step::Smem sm;
  attn_step::attention_item<KV, false>(
      sm, qkv, k_cache, v_cache, k_scale, v_scale, pos, cos2, sinm, attn,
      k_new, v_new, ks_new, vs_new, H, n_kv, D, S, S, scale, blockIdx.y,
      blockIdx.x);
}

template <int KV>
int launch(const void* qkv, const void* k_cache, const void* v_cache,
           const void* k_scale, const void* v_scale, const void* pos,
           const void* cos2, const void* sinm, void* attn, void* k_new,
           void* v_new, void* ks_new, void* vs_new, int B, int H, int n_kv,
           int D, int S, void* stream) {
  if (D % 32 != 0 || D > MAX_D || H % n_kv != 0 ||
      H / n_kv > MAX_KV_MUL || B < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(D)));
  attention_step_kernel<KV><<<dim3(n_kv, B), D, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(qkv), k_cache, v_cache,
      static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
      static_cast<const int*>(pos), static_cast<const float*>(cos2),
      static_cast<const float*>(sinm), static_cast<float*>(attn), k_new, v_new,
      static_cast<float*>(ks_new), static_cast<float*>(vs_new), H, n_kv, D, S,
      scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// qkv: (B, (H + 2*n_kv)*D) bf16. k_cache/v_cache: (B, S, n_kv, D) bf16,
// or int8 codes when k_scale/v_scale ((B, S, n_kv) f32) are given.
// pos: (B,) int32 on the device. cos2/sinm: (B, D) f32. Outputs: attn
// (B, H, D) f32; k_new/v_new (B, n_kv, D) in the cache's dtype; ks_new/
// vs_new (B, n_kv) f32 (int8 only).
LLAMA_EXPORT int attention_step(const void* qkv, const void* k_cache,
                                const void* v_cache, const void* k_scale,
                                const void* v_scale, const void* pos,
                                const void* cos2, const void* sinm,
                                void* attn, void* k_new, void* v_new,
                                void* ks_new, void* vs_new, int B, int H,
                                int n_kv, int D, int S, void* stream) {
  if (k_scale != nullptr)
    return launch<KV_INT8>(qkv, k_cache, v_cache, k_scale, v_scale, pos, cos2,
                           sinm, attn, k_new, v_new, ks_new, vs_new, B, H,
                           n_kv, D, S, stream);
  return launch<KV_BF16>(qkv, k_cache, v_cache, nullptr, nullptr, pos, cos2,
                         sinm, attn, k_new, v_new, nullptr, nullptr, B, H,
                         n_kv, D, S, stream);
}

// The int4 cache: k_cache/v_cache (B, S, n_kv, D/2) int8, packed in halves,
// with k_scale/v_scale (B, S, n_kv) f32 required; k_new/v_new come back
// packed, (B, n_kv, D/2) int8, with ks_new/vs_new (B, n_kv) f32.
LLAMA_EXPORT int attention_step_kv4(const void* qkv, const void* k_cache,
                                    const void* v_cache, const void* k_scale,
                                    const void* v_scale, const void* pos,
                                    const void* cos2, const void* sinm,
                                    void* attn, void* k_new, void* v_new,
                                    void* ks_new, void* vs_new, int B, int H,
                                    int n_kv, int D, int S, void* stream) {
  if (k_scale == nullptr || v_scale == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch<KV_INT4>(qkv, k_cache, v_cache, k_scale, v_scale, pos, cos2,
                         sinm, attn, k_new, v_new, ks_new, vs_new, B, H, n_kv,
                         D, S, stream);
}
