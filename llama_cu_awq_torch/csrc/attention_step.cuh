// Device code of one decode attention step for one (slot, kv head).
// new_row (phase 1: split, RoPE, bf16 rounding, quantizing and packing the
// new k/v row) is shared by attention_step.cu's split kernel
// (decode_attention.cuh) and attention_item, so both write the same bits.
// attention_item is int4_chain.cu's mono_layer attention stage (persistent
// blocks that walk the work items before the layer's matmul stages): the
// online softmax over the whole window in one walk, where attention_step.cu
// splits the window across blocks.
#pragma once

#include "common.cuh"

namespace attn_step {

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

// The shared memory of one work item.
struct Smem {
  float q_s[MAX_KV_MUL * MAX_D];
  float kcur_s[MAX_D];
  float vcur_s[MAX_D];
  float s_s[MAX_KV_MUL * CHUNK];
  float p_s[MAX_KV_MUL * CHUNK];
  float ks_rows[CHUNK];
  float vs_rows[CHUNK];
  float m_s[MAX_KV_MUL];
  float l_s[MAX_KV_MUL];
  float alpha_s[MAX_KV_MUL];
  float red[2][MAX_D / 32];
  int code_s[2][MAX_D];  // the new int4 row before packing
};

// The barrier of the item's D threads: the whole block where the block is
// D threads (NAMED false), else named barrier 1 over threads 0..D-1 (the
// other warps of a larger block do not take part).
template <bool NAMED>
__device__ __forceinline__ void item_sync(int D) {
  if constexpr (NAMED) {
    asm volatile("bar.sync 1, %0;" ::"r"(D) : "memory");
  } else {
    __syncthreads();
  }
}

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// element t of head row x, rotated in f32 as x*cos2 + rot_half(x)*sinm
// and rounded to bf16 (attention_step.py:150-163); partner = t +- D/2
__device__ __forceinline__ float rope_elem(const __nv_bfloat16* x, int t,
                                          int partner, float c, float sn) {
  return round_bf16(__fadd_rn(__fmul_rn(__bfloat162float(x[t]), c),
                              __fmul_rn(__bfloat162float(x[partner]), sn)));
}

// Phase 1's new cache row for (slot b, kv head kvh), run by threads
// 0..D-1 (D a multiple of 32): rotate and round k, take v, and for a
// quantized cache quantize both (int8, or int4 packed in halves); write
// k_new/v_new (and ks_new/vs_new) at row nrow = b * n_kv + kvh. Returns
// in every thread its element of the row as the softmax sees it (the bf16
// value or the code) and the scales (quantized only). red and code are
// the item's scratch; the barrier is item_sync<NAMED>. Shared by
// attention_item and the split kernel (decode_attention.cuh), so both
// write the same bits.
template <int KV, bool NAMED>
__device__ __forceinline__ void new_row(
    float (&red)[2][MAX_D / 32], int (&code)[2][MAX_D],
    const __nv_bfloat16* __restrict__ row, float c, float sn, int partner,
    void* __restrict__ k_new, void* __restrict__ v_new,
    float* __restrict__ ks_new, float* __restrict__ vs_new, int H, int n_kv,
    int D, int kvh, size_t nrow, float& kcur, float& vcur, float& ksc,
    float& vsc) {
  constexpr bool QUANT = KV != KV_BF16;
  const int t = threadIdx.x;  // < D
  const int lane = t & 31;
  const int warp = t >> 5;
  const int half = D / 2;
  const float kb = rope_elem(row + (size_t)(H + kvh) * D, t, partner, c, sn);
  const float vb = __bfloat162float(row[(size_t)(H + n_kv + kvh) * D + t]);
  kcur = kb;
  vcur = vb;
  ksc = vsc = 0.0f;
  if constexpr (QUANT) {
    const float ka = warp_max(fabsf(kb));
    const float va = warp_max(fabsf(vb));
    if (lane == 0) {
      red[0][warp] = ka;
      red[1][warp] = va;
    }
    item_sync<NAMED>(D);
    for (int w = 0; w < D / 32; ++w) {
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
      code[0][t] = static_cast<int>(kcur);
      code[1][t] = static_cast<int>(vcur);
      item_sync<NAMED>(D);
      if (t < half) {
        // byte t: lane t in the low nibble, lane t + D/2 in the high one
        auto pack = [&](const int* cd) {
          return static_cast<int8_t>(static_cast<uint8_t>(
              (cd[t] & 0xF) | ((cd[t + half] & 0xF) << 4)));
        };
        static_cast<int8_t*>(k_new)[nrow * half + t] = pack(code[0]);
        static_cast<int8_t*>(v_new)[nrow * half + t] = pack(code[1]);
      }
    } else {
      static_cast<int8_t*>(k_new)[nrow * D + t] = static_cast<int8_t>(kcur);
      static_cast<int8_t*>(v_new)[nrow * D + t] = static_cast<int8_t>(vcur);
    }
    if (t == 0) {
      ks_new[nrow] = ksc;
      vs_new[nrow] = vsc;
    }
  } else {
    static_cast<__nv_bfloat16*>(k_new)[nrow * D + t] = __float2bfloat16_rn(kb);
    static_cast<__nv_bfloat16*>(v_new)[nrow * D + t] = __float2bfloat16_rn(vb);
  }
}

// One (slot b, kv head kvh) work item of mono_layer (int4_chain.cu), run
// by threads 0..D-1 (D a multiple of 32): phase 1 (new_row) splits the
// qkv row, rotates, rounds and (for a quantized cache) quantizes the new
// k/v row; phase 2 is the online softmax over the current token, then the
// history rows below min(pos[b], win) in chunks of CHUNK, in one walk
// (attention_step_plain(split=False) walks the same chunks). S is the
// cache's row count (its stride). attn gets the kv_mul query heads'
// rows as f32 or as bf16 (OutT).
template <int KV, bool NAMED, typename OutT>
__device__ __forceinline__ void attention_item(
    Smem& sm, const __nv_bfloat16* __restrict__ qkv,
    const void* __restrict__ k_cache, const void* __restrict__ v_cache,
    const float* __restrict__ k_scale, const float* __restrict__ v_scale,
    const int* __restrict__ pos, const float* __restrict__ cos2,
    const float* __restrict__ sinm, OutT* __restrict__ attn,
    void* __restrict__ k_new, void* __restrict__ v_new,
    float* __restrict__ ks_new, float* __restrict__ vs_new, int H, int n_kv,
    int D, int S, int win, float scale, int b, int kvh) {
  constexpr bool QUANT = KV != KV_BF16;
  const int t = threadIdx.x;  // < D
  const int lane = t & 31;
  const int warp = t >> 5;
  // the block's own size where the block is the item
  const int nthreads = NAMED ? D : static_cast<int>(blockDim.x);
  const int nwarps = nthreads >> 5;
  const int kv_mul = H / n_kv;
  const int half = D / 2;
  const __nv_bfloat16* row = qkv + (size_t)b * (H + 2 * n_kv) * D;
  const float c = cos2[(size_t)b * D + t];
  const float sn = sinm[(size_t)b * D + t];
  const int partner = t < half ? t + half : t - half;

  // ---- phase 1: split, rope, bf16 rounding, new cache row ----
  for (int h = 0; h < kv_mul; ++h)
    sm.q_s[h * D + t] =
        rope_elem(row + (size_t)(kvh * kv_mul + h) * D, t, partner, c, sn);
  float kcur, vcur, ksc, vsc;
  new_row<KV, NAMED>(sm.red, sm.code_s, row, c, sn, partner, k_new, v_new,
                     ks_new, vs_new, H, n_kv, D, kvh,
                     (size_t)b * n_kv + kvh, kcur, vcur, ksc, vsc);
  if (QUANT && t == 0) {
    sm.ks_rows[0] = ksc;
    sm.vs_rows[0] = vsc;
  }
  sm.kcur_s[t] = kcur;
  sm.vcur_s[t] = vcur;
  if (t < kv_mul) {
    sm.m_s[t] = NEG;
    sm.l_s[t] = 0.0f;
  }
  float acc[MAX_KV_MUL];
#pragma unroll
  for (int h = 0; h < MAX_KV_MUL; ++h) acc[h] = 0.0f;
  item_sync<NAMED>(D);

  // ---- phase 2: online softmax ----
  // raw score of one k row (elements at lane + 32*i) against each query
  // head, written to s_s[h][j]
  auto score_row = [&](const float* kv, int j) {
    for (int h = 0; h < kv_mul; ++h) {
      float part = 0.0f;
      for (int i = 0, e = lane; e < D; ++i, e += 32)
        part = fmaf(kv[i], sm.q_s[h * D + e], part);
      part = warp_sum(part);
      if (lane == 0) {
        float raw = part;
        if constexpr (QUANT) raw = raw * sm.ks_rows[j];
        sm.s_s[h * CHUNK + j] = raw * scale;
      }
    }
  };
  // softmax update over s_s[:, :n], then acc = acc*alpha + p @ v
  auto update = [&](int n, int r0, bool current) {
    for (int h = warp; h < kv_mul; h += nwarps) {
      float mx = NEG;
      for (int j = lane; j < n; j += 32) mx = fmaxf(mx, sm.s_s[h * CHUNK + j]);
      mx = warp_max(mx);
      const float m_old = sm.m_s[h];
      const float m_new = fmaxf(m_old, mx);
      const float alpha = expf(m_old - m_new);
      float sum = 0.0f;
      for (int j = lane; j < n; j += 32) {
        float p = expf(sm.s_s[h * CHUNK + j] - m_new);
        sum += p;
        if constexpr (QUANT) p = p * sm.vs_rows[j];
        sm.p_s[h * CHUNK + j] = round_bf16(p);
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        sm.l_s[h] = sm.l_s[h] * alpha + sum;
        sm.m_s[h] = m_new;
        sm.alpha_s[h] = alpha;
      }
    }
    item_sync<NAMED>(D);
    float pv[MAX_KV_MUL];
#pragma unroll
    for (int h = 0; h < MAX_KV_MUL; ++h) pv[h] = 0.0f;
    // four v rows in flight a thread: 15-31 % faster at 7B than the
    // compiler's own choice, the same fmaf order
#pragma unroll 4
    for (int j = 0; j < n; ++j) {
      const float vv = current
          ? sm.vcur_s[t]
          : load_kv<KV>(v_cache, ((size_t)b * S + r0 + j) * n_kv + kvh, t, D);
#pragma unroll
      for (int h = 0; h < MAX_KV_MUL; ++h)
        if (h < kv_mul) pv[h] = fmaf(sm.p_s[h * CHUNK + j], vv, pv[h]);
    }
#pragma unroll
    for (int h = 0; h < MAX_KV_MUL; ++h)
      if (h < kv_mul) acc[h] = acc[h] * sm.alpha_s[h] + pv[h];
    item_sync<NAMED>(D);
  };

  // the current token first, from shared memory
  if (warp == 0) {
    float kv[MAX_D / 32];
    for (int i = 0, e = lane; e < D; ++i, e += 32) kv[i] = sm.kcur_s[e];
    score_row(kv, 0);
  }
  item_sync<NAMED>(D);
  update(1, 0, true);

  // then the history rows < min(pos[b], win), CHUNK at a time
  const int n_hist = min(pos[b], win);
  for (int r0 = 0; r0 < n_hist; r0 += CHUNK) {
    const int n = min(CHUNK, n_hist - r0);
    if constexpr (QUANT) {
      for (int j = t; j < n; j += nthreads) {
        const size_t si = ((size_t)b * S + r0 + j) * n_kv + kvh;
        sm.ks_rows[j] = k_scale[si];
        sm.vs_rows[j] = v_scale[si];
      }
      item_sync<NAMED>(D);
    }
    for (int j = warp; j < n; j += nwarps) {
      const size_t krow = ((size_t)b * S + r0 + j) * n_kv + kvh;
      float kv[MAX_D / 32];
      for (int i = 0, e = lane; e < D; ++i, e += 32)
        kv[i] = load_kv<KV>(k_cache, krow, e, D);
      score_row(kv, j);
    }
    item_sync<NAMED>(D);
    update(n, r0, false);
  }

#pragma unroll
  for (int h = 0; h < MAX_KV_MUL; ++h)
    if (h < kv_mul)
      store_out(attn + ((size_t)b * H + kvh * kv_mul + h) * D + t,
                acc[h] / sm.l_s[h]);
}

}  // namespace attn_step
