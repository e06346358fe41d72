// Device code shared by the decode attention kernels: the cache formats,
// the threads of one work item
// (a whole block, or a group of D threads inside a larger block), RoPE of
// one head row, and new_row (phase 1: split, RoPE, bf16 rounding,
// quantizing and packing the new k/v row). The split kernels
// (decode_attention.cuh) run in attention_step.cu, batched_attention.cu
// and int4_chain.cu's mono_layer, so all of them write the same bits.
#pragma once

#include "common.cuh"

namespace attn_step {

constexpr int MAX_KV_MUL = 8;   // query heads per kv head
constexpr int MAX_D = 256;      // head_dim (one thread per element)
constexpr float NEG = -1e30f;

// cache formats: bf16, int8 codes, int4 codes packed in halves, and the
// fp16 and f32 caches of --act-dtype float16 / float32, whose rows are
// rounded to bf16 as they load, as the JAX kernels cast their cache
// blocks (attention_step.py:211-212, batched_attention.py:100-101), so the
// dot products stay those of the bf16 cache
constexpr int KV_BF16 = 0;
constexpr int KV_INT8 = 1;
constexpr int KV_INT4 = 2;
constexpr int KV_F16 = 3;
constexpr int KV_F32 = 4;

// codes with per-row scales
__host__ __device__ constexpr bool quantized(int kv) {
  return kv == KV_INT8 || kv == KV_INT4;
}

// the element type of an unquantized cache
template <int KV>
struct CacheT;
template <>
struct CacheT<KV_BF16> {
  using T = __nv_bfloat16;
};
template <>
struct CacheT<KV_F16> {
  using T = __half;
};
template <>
struct CacheT<KV_F32> {
  using T = float;
};

// The D threads of one work item, numbered t = 0..D-1 (D a multiple of
// 32, so an item is whole warps). BlockItem: the block is the item, its
// barrier __syncthreads(). GroupItem: group `id` of D consecutive threads
// of a larger block, its barrier the named barrier 1 + id over those D
// threads (the other groups run their own items meanwhile).
struct BlockItem {
  __device__ __forceinline__ int t() const { return threadIdx.x; }
  __device__ __forceinline__ void sync() const { __syncthreads(); }
};

struct GroupItem {
  int id;
  int D;
  __device__ __forceinline__ int t() const {
    return static_cast<int>(threadIdx.x) - id * D;
  }
  __device__ __forceinline__ void sync() const {
    asm volatile("bar.sync %0, %1;" ::"r"(1 + id), "r"(D) : "memory");
  }
};

// named barriers 1..MAX_GROUPS (0 is __syncthreads')
constexpr int MAX_GROUPS = 8;

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// element t of head row x (bf16, fp16 or f32: the qkv row in the
// activation type), rotated in f32 as x*cos2 + rot_half(x)*sinm and
// rounded to bf16 (attention_step.py:150-163); partner = t +- D/2
template <typename QT>
__device__ __forceinline__ float rope_elem(const QT* x, int t, int partner,
                                          float c, float sn) {
  return round_bf16(__fadd_rn(__fmul_rn(to_f32(x[t]), c),
                              __fmul_rn(to_f32(x[partner]), sn)));
}

// Phase 1's new cache row for (slot b, kv head kvh), run by the item's D
// threads: rotate and round k, take v, and for a quantized cache quantize
// both (int8, or int4 packed in halves); write k_new/v_new (and
// ks_new/vs_new) at row nrow = b * n_kv + kvh, an unquantized row as its
// bf16 value widened to the cache's type (attention_step.py:190-204).
// Returns in every thread its element of the row as the softmax sees it
// (the bf16 value or the code) and the scales (quantized only). red and
// code are the item's scratch.
template <int KV, typename Item, typename QT>
__device__ __forceinline__ void new_row(
    const Item& it, float (&red)[2][MAX_D / 32], int (&code)[2][MAX_D],
    const QT* __restrict__ row, float c, float sn, int partner,
    void* __restrict__ k_new, void* __restrict__ v_new,
    float* __restrict__ ks_new, float* __restrict__ vs_new, int H, int n_kv,
    int D, int kvh, size_t nrow, float& kcur, float& vcur, float& ksc,
    float& vsc) {
  constexpr bool QUANT = quantized(KV);
  const int t = it.t();
  const int lane = t & 31;
  const int warp = t >> 5;
  const int half = D / 2;
  const float kb = rope_elem(row + (size_t)(H + kvh) * D, t, partner, c, sn);
  const float vb = round_bf16(to_f32(row[(size_t)(H + n_kv + kvh) * D + t]));
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
    it.sync();
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
      it.sync();
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
    using T = typename CacheT<KV>::T;
    static_cast<T*>(k_new)[nrow * D + t] = from_f32<T>(kb);
    static_cast<T*>(v_new)[nrow * D + t] = from_f32<T>(vb);
  }
}

}  // namespace attn_step
