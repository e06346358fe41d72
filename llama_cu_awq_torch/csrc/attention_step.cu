// One decode attention step straight from the fused qkv row: split, RoPE,
// bf16 rounding of q and k, optional int8 quantization of the new k/v row,
// then online-softmax GQA attention over the cache rows below pos[b] plus
// the current token.
//
// Replaces: llama_cu_awq_tpu/ops/pallas/attention_step.py, attention_step
//   (kernel _make_kernel), for the bf16 and the int8 cache.
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

#include "common.cuh"

namespace {

constexpr int CHUNK = 64;       // history rows per online-softmax step
constexpr int MAX_KV_MUL = 8;   // query heads per kv head
constexpr int MAX_D = 256;      // head_dim (one thread per element)
constexpr float NEG = -1e30f;

template <bool QUANT>
__device__ __forceinline__ float load_kv(const void* p, size_t i) {
  if constexpr (QUANT) {
    return static_cast<float>(static_cast<const int8_t*>(p)[i]);
  } else {
    return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
  }
}

template <bool QUANT>
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
    // absmax * f32(1/127): XLA rewrites the JAX package's absmax/127 so
    ksc = fmaxf(ksc * (1.0f / 127.0f), 1e-10f);
    vsc = fmaxf(vsc * (1.0f / 127.0f), 1e-10f);
    kcur = rintf(kb / ksc);
    vcur = rintf(vb / vsc);
    static_cast<int8_t*>(k_new)[nrow * D + t] = static_cast<int8_t>(kcur);
    static_cast<int8_t*>(v_new)[nrow * D + t] = static_cast<int8_t>(vcur);
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
          : load_kv<QUANT>(v_cache,
                           (((size_t)b * S + r0 + j) * n_kv + kvh) * D + t);
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
      const size_t base = (((size_t)b * S + r0 + j) * n_kv + kvh) * D;
      float kv[MAX_D / 32];
      for (int i = 0, e = lane; e < D; ++i, e += 32)
        kv[i] = load_kv<QUANT>(k_cache, base + e);
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
  if (D % 32 != 0 || D > MAX_D || H % n_kv != 0 ||
      H / n_kv > MAX_KV_MUL || B < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(D)));
  const dim3 grid(n_kv, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(qkv);
  if (k_scale != nullptr) {
    attention_step_kernel<true><<<grid, D, 0, st>>>(
        q, k_cache, v_cache, static_cast<const float*>(k_scale),
        static_cast<const float*>(v_scale), static_cast<const int*>(pos),
        static_cast<const float*>(cos2), static_cast<const float*>(sinm),
        static_cast<float*>(attn), k_new, v_new, static_cast<float*>(ks_new),
        static_cast<float*>(vs_new), H, n_kv, D, S, scale);
  } else {
    attention_step_kernel<false><<<grid, D, 0, st>>>(
        q, k_cache, v_cache, nullptr, nullptr, static_cast<const int*>(pos),
        static_cast<const float*>(cos2), static_cast<const float*>(sinm),
        static_cast<float*>(attn), k_new, v_new, nullptr, nullptr, H, n_kv,
        D, S, scale);
  }
  return static_cast<int>(cudaGetLastError());
}
