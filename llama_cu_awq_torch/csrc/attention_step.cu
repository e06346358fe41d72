// One decode attention step straight from the fused qkv row: split, RoPE,
// bf16 rounding of q and k, optional quantization of the new k/v row (int8,
// or int4 packed two to a byte), then online-softmax GQA attention over the
// cache rows below pos[b] plus the current token.
//
// Replaces: llama_cu_awq_tpu/ops/pallas/attention_step.py, attention_step
//   (kernel _make_kernel), for the bf16 and the int8 cache, and
//   _attention_step_kv4 (kernel _make_kernel_kv4, unpack _unpack4) for the
//   int4 cache.
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

#include "common.cuh"

namespace {

constexpr int CHUNK = 64;       // history rows per online-softmax step
constexpr int MAX_KV_MUL = 8;   // query heads per kv head
constexpr int MAX_D = 256;      // head_dim (one thread per element)
constexpr float NEG = -1e30f;

// cache formats
constexpr int KV_BF16 = 0;
constexpr int KV_INT8 = 1;
constexpr int KV_INT4 = 2;

// element e of cache row `row` (row = (b * S + s) * n_kv + kv head) as the
// softmax sees it: the bf16 value, or the int8 / int4 code
template <int KV>
__device__ __forceinline__ float load_kv(const void* p, size_t row, int e,
                                         int D) {
  if constexpr (KV == KV_INT4) {
    const int half = D / 2;
    const int c = static_cast<const int8_t*>(p)[row * half + (e % half)];
    const int nib = e < half ? (c & 0xF) : ((c >> 4) & 0xF);
    return static_cast<float>((nib ^ 8) - 8);
  } else if constexpr (KV == KV_INT8) {
    return static_cast<float>(static_cast<const int8_t*>(p)[row * D + e]);
  } else {
    return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[row * D + e]);
  }
}

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
  __shared__ float q_s[MAX_KV_MUL * MAX_D];
  __shared__ float kcur_s[MAX_D];
  __shared__ float vcur_s[MAX_D];
  __shared__ float s_s[MAX_KV_MUL * CHUNK];
  __shared__ float p_s[MAX_KV_MUL * CHUNK];
  __shared__ float ks_rows[CHUNK];
  __shared__ float vs_rows[CHUNK];
  __shared__ float m_s[MAX_KV_MUL];
  __shared__ float l_s[MAX_KV_MUL];
  __shared__ float alpha_s[MAX_KV_MUL];
  __shared__ float red[2][MAX_D / 32];
  __shared__ int code_s[2][MAX_D];  // the new int4 row before packing

  constexpr bool QUANT = KV != KV_BF16;
  const int t = threadIdx.x;  // blockDim.x == D
  const int lane = t & 31;
  const int warp = t >> 5;
  const int nwarps = blockDim.x >> 5;
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int kv_mul = H / n_kv;
  const int half = D / 2;
  const __nv_bfloat16* row = qkv + (size_t)b * (H + 2 * n_kv) * D;
  const float c = cos2[(size_t)b * D + t];
  const float sn = sinm[(size_t)b * D + t];
  const int partner = t < half ? t + half : t - half;

  // ---- phase 1: split, rope, bf16 rounding, new cache row ----
  auto rope = [&](const __nv_bfloat16* x) {
    return round_bf16(__fadd_rn(__fmul_rn(__bfloat162float(x[t]), c),
                                __fmul_rn(__bfloat162float(x[partner]), sn)));
  };
  for (int h = 0; h < kv_mul; ++h)
    q_s[h * D + t] = rope(row + (size_t)(kvh * kv_mul + h) * D);
  const float kb = rope(row + (size_t)(H + kvh) * D);
  const float vb = __bfloat162float(row[(size_t)(H + n_kv + kvh) * D + t]);
  const size_t nrow = (size_t)b * n_kv + kvh;
  float kcur = kb;
  float vcur = vb;
  if constexpr (QUANT) {
    const float ka = warp_max(fabsf(kb));
    const float va = warp_max(fabsf(vb));
    if (lane == 0) {
      red[0][warp] = ka;
      red[1][warp] = va;
    }
    __syncthreads();
    float ksc = 0.0f;
    float vsc = 0.0f;
    for (int w = 0; w < nwarps; ++w) {
      ksc = fmaxf(ksc, red[0][w]);
      vsc = fmaxf(vsc, red[1][w]);
    }
    // absmax * f32(1/127) or f32(1/7): XLA rewrites the JAX package's
    // absmax/127 and absmax/7 so
    const float inv = KV == KV_INT4 ? 1.0f / 7.0f : 1.0f / 127.0f;
    ksc = fmaxf(ksc * inv, 1e-10f);
    vsc = fmaxf(vsc * inv, 1e-10f);
    kcur = rintf(kb / ksc);
    vcur = rintf(vb / vsc);
    if constexpr (KV == KV_INT4) {
      kcur = fminf(fmaxf(kcur, -7.0f), 7.0f);
      vcur = fminf(fmaxf(vcur, -7.0f), 7.0f);
      code_s[0][t] = static_cast<int>(kcur);
      code_s[1][t] = static_cast<int>(vcur);
      __syncthreads();
      if (t < half) {
        // byte t: lane t in the low nibble, lane t + D/2 in the high one
        auto pack = [&](const int* code) {
          return static_cast<int8_t>(static_cast<uint8_t>(
              (code[t] & 0xF) | ((code[t + half] & 0xF) << 4)));
        };
        static_cast<int8_t*>(k_new)[nrow * half + t] = pack(code_s[0]);
        static_cast<int8_t*>(v_new)[nrow * half + t] = pack(code_s[1]);
      }
    } else {
      static_cast<int8_t*>(k_new)[nrow * D + t] = static_cast<int8_t>(kcur);
      static_cast<int8_t*>(v_new)[nrow * D + t] = static_cast<int8_t>(vcur);
    }
    if (t == 0) {
      ks_new[nrow] = ksc;
      vs_new[nrow] = vsc;
      ks_rows[0] = ksc;
      vs_rows[0] = vsc;
    }
  } else {
    static_cast<__nv_bfloat16*>(k_new)[nrow * D + t] = __float2bfloat16_rn(kb);
    static_cast<__nv_bfloat16*>(v_new)[nrow * D + t] = __float2bfloat16_rn(vb);
  }
  kcur_s[t] = kcur;
  vcur_s[t] = vcur;
  if (t < kv_mul) {
    m_s[t] = NEG;
    l_s[t] = 0.0f;
  }
  float acc[MAX_KV_MUL];
#pragma unroll
  for (int h = 0; h < MAX_KV_MUL; ++h) acc[h] = 0.0f;
  __syncthreads();

  // ---- phase 2: online softmax ----
  // raw score of one k row (elements at lane + 32*i) against each query
  // head, written to s_s[h][j]
  auto score_row = [&](const float* kv, int j) {
    for (int h = 0; h < kv_mul; ++h) {
      float part = 0.0f;
      for (int i = 0, e = lane; e < D; ++i, e += 32)
        part = fmaf(kv[i], q_s[h * D + e], part);
      part = warp_sum(part);
      if (lane == 0) {
        float raw = part;
        if constexpr (QUANT) raw = raw * ks_rows[j];
        s_s[h * CHUNK + j] = raw * scale;
      }
    }
  };
  // softmax update over s_s[:, :n], then acc = acc*alpha + p @ v
  auto update = [&](int n, int r0, bool current) {
    for (int h = warp; h < kv_mul; h += nwarps) {
      float mx = NEG;
      for (int j = lane; j < n; j += 32) mx = fmaxf(mx, s_s[h * CHUNK + j]);
      mx = warp_max(mx);
      const float m_old = m_s[h];
      const float m_new = fmaxf(m_old, mx);
      const float alpha = expf(m_old - m_new);
      float sum = 0.0f;
      for (int j = lane; j < n; j += 32) {
        float p = expf(s_s[h * CHUNK + j] - m_new);
        sum += p;
        if constexpr (QUANT) p = p * vs_rows[j];
        p_s[h * CHUNK + j] = round_bf16(p);
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        l_s[h] = l_s[h] * alpha + sum;
        m_s[h] = m_new;
        alpha_s[h] = alpha;
      }
    }
    __syncthreads();
    float pv[MAX_KV_MUL];
#pragma unroll
    for (int h = 0; h < MAX_KV_MUL; ++h) pv[h] = 0.0f;
    for (int j = 0; j < n; ++j) {
      const float vv = current
          ? vcur_s[t]
          : load_kv<KV>(v_cache, ((size_t)b * S + r0 + j) * n_kv + kvh, t, D);
#pragma unroll
      for (int h = 0; h < MAX_KV_MUL; ++h)
        if (h < kv_mul) pv[h] = fmaf(p_s[h * CHUNK + j], vv, pv[h]);
    }
#pragma unroll
    for (int h = 0; h < MAX_KV_MUL; ++h)
      if (h < kv_mul) acc[h] = acc[h] * alpha_s[h] + pv[h];
    __syncthreads();
  };

  // the current token first, from shared memory
  if (warp == 0) {
    float kv[MAX_D / 32];
    for (int i = 0, e = lane; e < D; ++i, e += 32) kv[i] = kcur_s[e];
    score_row(kv, 0);
  }
  __syncthreads();
  update(1, 0, true);

  // then the history rows < pos[b], CHUNK at a time
  const int n_hist = min(pos[b], S);
  for (int r0 = 0; r0 < n_hist; r0 += CHUNK) {
    const int n = min(CHUNK, n_hist - r0);
    if constexpr (QUANT) {
      for (int j = t; j < n; j += blockDim.x) {
        const size_t si = ((size_t)b * S + r0 + j) * n_kv + kvh;
        ks_rows[j] = k_scale[si];
        vs_rows[j] = v_scale[si];
      }
      __syncthreads();
    }
    for (int j = warp; j < n; j += nwarps) {
      const size_t krow = ((size_t)b * S + r0 + j) * n_kv + kvh;
      float kv[MAX_D / 32];
      for (int i = 0, e = lane; e < D; ++i, e += 32)
        kv[i] = load_kv<KV>(k_cache, krow, e, D);
      score_row(kv, j);
    }
    __syncthreads();
    update(n, r0, false);
  }

#pragma unroll
  for (int h = 0; h < MAX_KV_MUL; ++h)
    if (h < kv_mul)
      attn[((size_t)b * H + kvh * kv_mul + h) * D + t] = acc[h] / l_s[h];
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
