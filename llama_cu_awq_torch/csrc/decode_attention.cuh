// Split-window decode attention (flash-decoding) for one query token per
// slot, shared by attention_step.cu, batched_attention.cu and
// int4_chain.cu (mono_layer's attention stage).
//
// A work item is one split of one (slot, kv head): a fixed run of
// SPLIT_ROWS cache rows (below; ops/cuda/attention_step.py's SPLIT_ROWS is
// the same number for the plain versions and the scratch sizes). The split
// length never depends on the batch, the card or other slots, so a slot's
// result depends only on its own position and cache. Threads: D (a
// multiple of 32), a whole block (attention_step.cu, batched_attention.cu:
// a grid of (splits, kv heads, slots)) or a group of D threads of a
// persistent block that walks the items (int4_chain.cu's mono_layer,
// attn_step::GroupItem). In a split:
//   1. scores: a k row is read as 16-byte vectors (32-byte pairs for an
//      f32 cache), one row across D/8 lanes for bf16, fp16 and f32 (16 at
//      D=128), D/16 for int8 and D/32 for packed int4; the next rows load
//      while the current ones reduce; fp16 and f32 values round to bf16 as
//      they load, as the JAX kernels cast their blocks;
//      q comes from shared memory and a row's dot product is reduced
//      across its lanes only. f32 raw scores times the row's k scale
//      (quantized), times 1/sqrt(D); masked rows score -1e30.
//   2. one max m over the split's scores, p = exp(s - m) (0 for a masked
//      row), l = the sum of p, then p times the row's v scale, rounded to
//      bf16 (the JAX kernels round p before the PV product).
//   3. PV: each lane owns 8 output elements of every query head of the kv
//      head (8 consecutive for bf16 and int8; 4 low and 4 high nibbles for
//      int4) and walks its group's rows, the first of them loaded while
//      the softmax runs; the groups are summed through shared memory in a
//      fixed order.
// attention_step's split 0 also takes the current token, first, as the
// JAX kernel visits it: its p is 1 (times its v scale, rounded to bf16),
// the split's max starts at its score, and its term enters as
// acc_cur * alpha + PV, l = alpha + sum p with alpha = exp(s_cur - m), the
// online softmax's step (step_split, below, is that item whole). The item
// then writes its partial (m, l, acc[kv_mul][D]) in f32 to scratch. The
// last item of a (slot, kv head) to finish (a __threadfence and an atomic
// counter, which that item resets to 0) combines the splits in split
// order 0..n-1:
//   M = max m_i (splits with l_i = 0, all rows masked, left out),
//   L = sum l_i * exp(m_i - M),  A = sum acc_i * exp(m_i - M),
//   out = A / L,
// with separately rounded products and sums (no atomic sums), so results
// are bit-identical from run to run. A slot with one split writes acc / l
// directly, which is the same value. ops/cuda/attention_step.py's
// split_partial, online_partial and combine_splits walk the same splits
// with the same max, p rounding and combine order.
#pragma once

#include <climits>

#include "attention_step.cuh"

namespace decode_attn {

using attn_step::KV_BF16;
using attn_step::KV_F16;
using attn_step::KV_F32;
using attn_step::KV_INT4;
using attn_step::KV_INT8;
using attn_step::MAX_D;
using attn_step::MAX_KV_MUL;
using attn_step::NEG;

// history rows of a split: 128 was the fastest of 64, 128 and 256 at
// batch 1 on the H100 (256 was 9 % faster at B=8 and 26 % slower at B=1;
// PERF.md, PR 6). A multiple of 32 (the max and softmax loops' lanes).
constexpr int SPLIT_ROWS = 128;
static_assert(SPLIT_ROWS % 32 == 0, "SPLIT_ROWS must be a multiple of 32");
// k or v rows a lane loads a step, double-buffered (the next step's load
// is issued before this step's arithmetic): 2 measured fastest on the
// H100 against 4 and 8, whose larger unrolled bodies and registers cost
// more than the loads they hide (PERF.md, PR 6)
constexpr int ROWS_IN_FLIGHT = 2;
constexpr unsigned FULL = 0xffffffffu;

// bytes of one head's row in the cache
template <int KV>
__host__ __device__ constexpr int row_bytes(int D) {
  return KV == KV_F32                      ? 4 * D
         : KV == KV_BF16 || KV == KV_F16 ? 2 * D
         : KV == KV_INT8                   ? D
                                           : D / 2;
}

// 32 bytes: a lane's share of an f32 row, 8 elements
struct U32B {
  uint4 a, b;
};

// read-only loads of a lane's vector
__device__ __forceinline__ uint4 ldg_vec(const uint4* p) { return __ldg(p); }
__device__ __forceinline__ uint2 ldg_vec(const uint2* p) { return __ldg(p); }
__device__ __forceinline__ uint32_t ldg_vec(const uint32_t* p) {
  return __ldg(p);
}
__device__ __forceinline__ U32B ldg_vec(const U32B* p) {
  const uint4* q = reinterpret_cast<const uint4*>(p);
  return U32B{__ldg(q), __ldg(q + 1)};
}

// A lane's k load in the scores phase: 16 bytes (8 bf16 or fp16, 16 int8,
// 32 packed int4 values), or 32 bytes of 8 f32
template <int KV>
struct KVec {
  using T = uint4;
};
template <>
struct KVec<KV_F32> {
  using T = U32B;
};

// the 8 bf16-rounded values of a 16-bit or f32 vector (fp16 and f32
// round to bf16 here, the JAX kernels' astype(bf16) of a cache block;
// bf16 is exact)
__device__ __forceinline__ void vals8_bf16(const uint4& w, float (&v)[8],
                                           bool half) {
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float2 f;
    if (half) {
      f = __half22float2(*reinterpret_cast<const __half2*>(&u[k]));
      f.x = round_bf16(f.x);
      f.y = round_bf16(f.y);
    } else {
      f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u[k]));
    }
    v[2 * k] = f.x;
    v[2 * k + 1] = f.y;
  }
}
__device__ __forceinline__ void vals8_bf16(const U32B& w, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(&w.a);
  const float4 b = *reinterpret_cast<const float4*>(&w.b);
  const float f[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
  for (int k = 0; k < 8; ++k) v[k] = round_bf16(f[k]);
}

__host__ __device__ inline int pow2_at_least(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

// Dynamic shared memory of a split item, in floats: m, l, the current
// token's scores and the item's last-arrival flag, then q, the scores,
// the rows' scales and the current token's k values, over which the
// per-warp PV partials (red) are laid once those are read.
struct Smem {
  float* m;     // [MAX_KV_MUL] the split's max per query head
  float* l;     // [MAX_KV_MUL] the split's sum of p
  float* scur;  // [MAX_KV_MUL] the current token's scores (attention_step)
  int* last;    // [1] finish_split: this item arrived last
  float* q;     // [kv_mul][D] bf16-rounded q
  float* s;     // [kv_mul][SPLIT_ROWS] scores, then bf16 p
  float* ks;    // [SPLIT_ROWS] k scales of the rows
  float* vs;    // [SPLIT_ROWS] v scales
  float* kcur;  // [D] the current token's k values (attention_step)
  float* red;   // [nwarps][kv_mul][D], over q.. after the PV loop
};

__host__ __device__ inline int smem_floats(int kv_mul, int D) {
  const int a = kv_mul * D + kv_mul * SPLIT_ROWS + 2 * SPLIT_ROWS + D;
  const int r = (D / 32) * kv_mul * D;
  return 4 * MAX_KV_MUL + (a > r ? a : r);
}

__device__ __forceinline__ Smem carve(float* base, int kv_mul, int D) {
  Smem sm;
  sm.m = base;
  sm.l = base + MAX_KV_MUL;
  sm.scur = base + 2 * MAX_KV_MUL;
  sm.last = reinterpret_cast<int*>(base + 3 * MAX_KV_MUL);
  sm.q = base + 4 * MAX_KV_MUL;  // 16-byte aligned
  sm.s = sm.q + kv_mul * D;
  sm.ks = sm.s + kv_mul * SPLIT_ROWS;
  sm.vs = sm.ks + SPLIT_ROWS;
  sm.kcur = sm.vs + SPLIT_ROWS;
  sm.red = sm.q;
  return sm;
}

// A split's (m, l, acc) as the item's thread t holds it: acc[h] is
// element t of query head h. KVM: the most query heads per kv head the
// caller compiles for (MAX_KV_MUL, or 1 where kv_mul is 1: fewer
// registers, the same arithmetic for each head).
template <int KVM>
struct Partial {
  float m[KVM];
  float l[KVM];
  float acc[KVM];
};

__device__ __forceinline__ float int4_lo(uint32_t w, int k) {
  return static_cast<float>(((static_cast<int>(w >> (8 * k)) & 0xF) ^ 8) - 8);
}
__device__ __forceinline__ float int4_hi(uint32_t w, int k) {
  return static_cast<float>(
      ((static_cast<int>(w >> (8 * k + 4)) & 0xF) ^ 8) - 8);
}
__device__ __forceinline__ float int8_at(uint32_t w, int k) {
  return static_cast<float>(static_cast<int8_t>(w >> (8 * k)));
}

// One lane's share of q . k for one query head: the lane's 16-byte vector
// w of the k row (lane sub of the row), q the head's D values (16-byte
// aligned; read as float4).
template <int KV>
__device__ __forceinline__ float dot16(const uint4& w, const float* q,
                                       int sub, int D) {
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
  float acc = 0.0f;
  if constexpr (KV == KV_BF16) {
    const float4* q4 = reinterpret_cast<const float4*>(q + 8 * sub);
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const float4 qv = q4[k];
      const float2 a = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&u[2 * k]));
      const float2 b = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&u[2 * k + 1]));
      acc = fmaf(a.x, qv.x, acc);
      acc = fmaf(a.y, qv.y, acc);
      acc = fmaf(b.x, qv.z, acc);
      acc = fmaf(b.y, qv.w, acc);
    }
  } else if constexpr (KV == KV_INT8) {
    const float4* q4 = reinterpret_cast<const float4*>(q + 16 * sub);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float4 qv = q4[k];
      acc = fmaf(int8_at(u[k], 0), qv.x, acc);
      acc = fmaf(int8_at(u[k], 1), qv.y, acc);
      acc = fmaf(int8_at(u[k], 2), qv.z, acc);
      acc = fmaf(int8_at(u[k], 3), qv.w, acc);
    }
  } else {
    // byte i of the vector holds element 16*sub + i in its low nibble and
    // element D/2 + 16*sub + i in its high one
    const float4* lo = reinterpret_cast<const float4*>(q + 16 * sub);
    const float4* hi = reinterpret_cast<const float4*>(q + D / 2 + 16 * sub);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float4 a = lo[k];
      const float4 b = hi[k];
      acc = fmaf(int4_lo(u[k], 0), a.x, acc);
      acc = fmaf(int4_hi(u[k], 0), b.x, acc);
      acc = fmaf(int4_lo(u[k], 1), a.y, acc);
      acc = fmaf(int4_hi(u[k], 1), b.y, acc);
      acc = fmaf(int4_lo(u[k], 2), a.z, acc);
      acc = fmaf(int4_hi(u[k], 2), b.z, acc);
      acc = fmaf(int4_lo(u[k], 3), a.w, acc);
      acc = fmaf(int4_hi(u[k], 3), b.w, acc);
    }
  }
  return acc;
}

// The same share for an fp16 or f32 cache: the lane's 8 values of the k
// row rounded to bf16, dotted in order with q's 8 (16-byte aligned)
template <int KV>
__device__ __forceinline__ float dot8(const typename KVec<KV>::T& w,
                                      const float* q, int sub) {
  float v[8];
  if constexpr (KV == KV_F32) {
    vals8_bf16(w, v);
  } else {
    vals8_bf16(w, v, true);
  }
  const float4* q4 = reinterpret_cast<const float4*>(q + 8 * sub);
  float acc = 0.0f;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const float4 qv = q4[k];
    acc = fmaf(v[4 * k], qv.x, acc);
    acc = fmaf(v[4 * k + 1], qv.y, acc);
    acc = fmaf(v[4 * k + 2], qv.z, acc);
    acc = fmaf(v[4 * k + 3], qv.w, acc);
  }
  return acc;
}

template <int KV>
__device__ __forceinline__ float dot_k(const typename KVec<KV>::T& w,
                                       const float* q, int sub, int D) {
  if constexpr (KV == KV_F16 || KV == KV_F32) {
    return dot8<KV>(w, q, sub);
  } else {
    return dot16<KV>(w, q, sub, D);
  }
}

// A lane's v load: 16 bytes of bf16 or fp16, 32 of f32, 8 of int8, 4 of
// packed int4, each 8 elements of the row.
template <int KV>
struct VVec;
template <>
struct VVec<KV_BF16> {
  using T = uint4;
};
template <>
struct VVec<KV_F16> {
  using T = uint4;
};
template <>
struct VVec<KV_F32> {
  using T = U32B;
};
template <>
struct VVec<KV_INT8> {
  using T = uint2;
};
template <>
struct VVec<KV_INT4> {
  using T = uint32_t;
};

template <int KV>
__device__ __forceinline__ void unpack_v(const typename VVec<KV>::T& w,
                                         float (&v)[8]) {
  if constexpr (KV == KV_F16) {
    vals8_bf16(w, v, true);
  } else if constexpr (KV == KV_F32) {
    vals8_bf16(w, v);
  } else if constexpr (KV == KV_BF16) {
    const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&u[k]));
      v[2 * k] = f.x;
      v[2 * k + 1] = f.y;
    }
  } else if constexpr (KV == KV_INT8) {
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] = int8_at(k < 4 ? w.x : w.y, k & 3);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v[k] = int4_lo(w, k);
      v[4 + k] = int4_hi(w, k);
    }
  }
}

// the row element of a PV lane's value i (lane sub of its row group)
template <int KV>
__device__ __forceinline__ int v_elem(int sub, int i, int D) {
  if constexpr (KV == KV_INT4) {
    return i < 4 ? 4 * sub + i : D / 2 + 4 * sub + i - 4;
  } else {
    return 8 * sub + i;
  }
}

// One split: history rows r0..r0+n-1 (n >= 0) of the (slot, kv head)
// whose row s is cache row row0 + s * n_kv; rows above p_last are masked.
// q must be in sm.q, visible after the first barrier here. m_start: where
// each query head's max starts (the current token's scores in
// attention_step's split 0; nullptr: -1e30). Returns the split's partial
// over its rows (l = 0 when n = 0 or every row is masked).
template <int KV, int KVM, typename Item>
__device__ __forceinline__ Partial<KVM> attend_split(
    const Item& it, const Smem& sm, const void* __restrict__ k_cache,
    const void* __restrict__ v_cache, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, size_t row0, int n_kv, int r0, int n,
    int p_last, const float* m_start, int kv_mul, int D, float scale) {
  constexpr bool QUANT = attn_step::quantized(KV);
  const int t = it.t();
  const int lane = t & 31;
  const int warp = t >> 5;
  const int nwarps = D >> 5;
  const int RB = row_bytes<KV>(D);

  if constexpr (QUANT) {
    for (int j = t; j < n; j += D) {
      const size_t si = row0 + (size_t)(r0 + j) * n_kv;
      sm.ks[j] = k_scale[si];
      sm.vs[j] = v_scale[si];
    }
  }
  it.sync();

  // ---- scores: a row across LK lanes (padded to LKP), 16 B each (32 for
  // f32); the next ROWS_IN_FLIGHT rows load while the current ones
  // reduce ----
  {
    using KT = typename KVec<KV>::T;
    const int LK = RB / static_cast<int>(sizeof(KT));
    const int LKP = pow2_at_least(LK);
    const int sub = lane & (LKP - 1);
    const int grp = warp * (32 / LKP) + lane / LKP;
    const int G = nwarps * (32 / LKP);
    const char* kb = static_cast<const char*>(k_cache);
    auto load = [&](KT (&w)[ROWS_IN_FLIGHT], int j0) {
#pragma unroll
      for (int u = 0; u < ROWS_IN_FLIGHT; ++u) {
        const int j = j0 + u * G + grp;
        if (sub < LK && j < n) {
          w[u] = ldg_vec(reinterpret_cast<const KT*>(
                             kb + (row0 + (size_t)(r0 + j) * n_kv) * RB) +
                         sub);
        } else {
          w[u] = KT{};
        }
      }
    };
    KT next[ROWS_IN_FLIGHT];
    load(next, 0);
    for (int j0 = 0; j0 < n; j0 += G * ROWS_IN_FLIGHT) {
      KT w[ROWS_IN_FLIGHT];
#pragma unroll
      for (int u = 0; u < ROWS_IN_FLIGHT; ++u) w[u] = next[u];
      load(next, j0 + G * ROWS_IN_FLIGHT);
#pragma unroll
      for (int u = 0; u < ROWS_IN_FLIGHT; ++u) {
        const int j = j0 + u * G + grp;
#pragma unroll
        for (int h = 0; h < KVM; ++h) {
          if (h < kv_mul) {
            float part = sub < LK ? dot_k<KV>(w[u], sm.q + h * D, sub, D)
                                  : 0.0f;
            for (int o = LKP >> 1; o > 0; o >>= 1)
              part += __shfl_xor_sync(FULL, part, o);
            if (sub == 0 && j < n) {
              float raw = part;
              if constexpr (QUANT) raw = raw * sm.ks[j];
              sm.s[h * SPLIT_ROWS + j] = r0 + j <= p_last ? raw * scale : NEG;
            }
          }
        }
      }
    }
  }

  // the PV phase's first rows load while the softmax runs
  using VT = typename VVec<KV>::T;
  const int LV = D / 8;
  const int LVP = pow2_at_least(LV);
  const int vsub = lane & (LVP - 1);
  const int vgrp = warp * (32 / LVP) + lane / LVP;
  const int VG = nwarps * (32 / LVP);
  const VT* vb = static_cast<const VT*>(v_cache);
  const size_t row_vecs = RB / sizeof(VT);
  auto load_v = [&](VT (&w)[ROWS_IN_FLIGHT], int j0) {
#pragma unroll
    for (int u = 0; u < ROWS_IN_FLIGHT; ++u) {
      const int j = j0 + u * VG;
      if (vsub < LV && j < n)
        w[u] = ldg_vec(vb + (row0 + (size_t)(r0 + j) * n_kv) * row_vecs +
                       vsub);
    }
  };
  VT vnext[ROWS_IN_FLIGHT];
  load_v(vnext, vgrp);
  it.sync();

  // ---- one max over the split, p rounded to bf16 ----
  for (int h = warp; h < kv_mul; h += nwarps) {
    float* sh = sm.s + h * SPLIT_ROWS;
    float mx = NEG;
    for (int j = lane; j < n; j += 32) mx = fmaxf(mx, sh[j]);
    mx = warp_max(mx);
    if (m_start != nullptr) mx = fmaxf(m_start[h], mx);
    float sum = 0.0f;
    for (int j = lane; j < n; j += 32) {
      float p = r0 + j <= p_last ? expf(sh[j] - mx) : 0.0f;
      sum += p;
      if constexpr (QUANT) p = p * sm.vs[j];
      sh[j] = round_bf16(p);
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      sm.m[h] = mx;
      sm.l[h] = sum;
    }
  }
  it.sync();

  // ---- PV: a row across D/8 lanes (padded to LVP), 8 elements each ----
  float acc[KVM][8];
#pragma unroll
  for (int h = 0; h < KVM; ++h)
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[h][i] = 0.0f;
  if (vsub < LV) {
    for (int j0 = vgrp; j0 < n; j0 += VG * ROWS_IN_FLIGHT) {
      VT w[ROWS_IN_FLIGHT];
#pragma unroll
      for (int u = 0; u < ROWS_IN_FLIGHT; ++u) w[u] = vnext[u];
      load_v(vnext, j0 + VG * ROWS_IN_FLIGHT);
#pragma unroll
      for (int u = 0; u < ROWS_IN_FLIGHT; ++u) {
        const int j = j0 + u * VG;
        if (j < n) {
          float v[8];
          unpack_v<KV>(w[u], v);
#pragma unroll
          for (int h = 0; h < KVM; ++h)
            if (h < kv_mul) {
              const float p = sm.s[h * SPLIT_ROWS + j];
#pragma unroll
              for (int i = 0; i < 8; ++i) acc[h][i] = fmaf(p, v[i], acc[h][i]);
            }
        }
      }
    }
  }
  // the row groups of a warp, then the warps in order
  for (int o = 16; o >= LVP; o >>= 1)
#pragma unroll
    for (int h = 0; h < KVM; ++h)
      if (h < kv_mul)
#pragma unroll
        for (int i = 0; i < 8; ++i)
          acc[h][i] += __shfl_xor_sync(FULL, acc[h][i], o);
  it.sync();  // q and s are read; red lies over them
  if (lane < LVP && vsub < LV) {
#pragma unroll
    for (int h = 0; h < KVM; ++h)
      if (h < kv_mul)
#pragma unroll
        for (int i = 0; i < 8; ++i)
          sm.red[(warp * kv_mul + h) * D + v_elem<KV>(vsub, i, D)] =
              acc[h][i];
  }
  it.sync();
  Partial<KVM> out;
#pragma unroll
  for (int h = 0; h < KVM; ++h) {
    float a = 0.0f;
    if (h < kv_mul) {
      for (int w = 0; w < nwarps; ++w) a += sm.red[(w * kv_mul + h) * D + t];
      out.m[h] = sm.m[h];
      out.l[h] = sm.l[h];
    }
    out.acc[h] = a;
  }
  return out;
}

// The end of a split item: with one split, out = acc / l; else write the
// partial and, in the last item of the (slot, kv head) to finish, combine
// every split in order, and reset the counter. item = b * n_kv + kvh; out
// points at the item's first query head row (f32, or bf16 rounded from
// the same f32 value); part_ml (items, max_splits, 2, kv_mul) and
// part_acc (items, max_splits, kv_mul, D) are f32 scratch.
template <int KVM, typename Item, typename OutT>
__device__ __forceinline__ void finish_split(
    const Item& it, const Smem& sm, const Partial<KVM>& pt,
    OutT* __restrict__ out,
    float* __restrict__ part_ml, float* __restrict__ part_acc,
    unsigned* __restrict__ counters, size_t item, int split, int n_splits,
    int max_splits, int kv_mul, int D) {
  const int t = it.t();
  if (n_splits == 1) {
#pragma unroll
    for (int h = 0; h < KVM; ++h)
      if (h < kv_mul) attn_step::store_out(out + (size_t)h * D + t,
                                           pt.acc[h] / pt.l[h]);
    return;
  }
  const size_t base = item * max_splits;
  float* pa = part_acc + (base + split) * kv_mul * D;
  float* pm = part_ml + (base + split) * 2 * kv_mul;
#pragma unroll
  for (int h = 0; h < KVM; ++h)
    if (h < kv_mul) {
      pa[(size_t)h * D + t] = pt.acc[h];
      if (t == h) {
        pm[h] = pt.m[h];
        pm[kv_mul + h] = pt.l[h];
      }
    }
  __threadfence();
  it.sync();
  if (t == 0)
    *sm.last = atomicAdd(counters + item, 1u) == (unsigned)n_splits - 1;
  it.sync();
  if (!*sm.last) return;
  __threadfence();
  const float* ml = part_ml + base * 2 * kv_mul;
  const float* pacc = part_acc + base * kv_mul * D;
  for (int h = 0; h < kv_mul; ++h) {
    float M = NEG;
    for (int i = 0; i < n_splits; ++i)
      if (__ldcg(ml + (size_t)(2 * i + 1) * kv_mul + h) > 0.0f)
        M = fmaxf(M, __ldcg(ml + (size_t)2 * i * kv_mul + h));
    float L = 0.0f;
    float A = 0.0f;
    for (int i = 0; i < n_splits; ++i) {
      const float l = __ldcg(ml + (size_t)(2 * i + 1) * kv_mul + h);
      if (l > 0.0f) {
        const float w = expf(__ldcg(ml + (size_t)2 * i * kv_mul + h) - M);
        L = __fadd_rn(L, __fmul_rn(l, w));
        A = __fadd_rn(
            A, __fmul_rn(__ldcg(pacc + ((size_t)i * kv_mul + h) * D + t), w));
      }
    }
    attn_step::store_out(out + (size_t)h * D + t, A / L);
  }
  if (t == 0) counters[item] = 0u;
}

// One split item of attention_step (the bf16, fp16, f32, int8 and int4
// caches; qkv (QT) bf16, fp16 or f32): split
// `split` of (slot b, kv head kvh) over the history rows below
// min(pos[b], win); items past the slot's splits return at once. Every
// split rotates q (kv_mul x D multiplies); split 0 also runs phase 1
// (attn_step::new_row: the new cache row, written to k_new/v_new and
// ks_new/vs_new) and visits the current token first. attn gets the
// kv_mul query heads' rows (OutT f32 or bf16). smem: the item's
// smem_floats floats (16-byte aligned); red and code: its new_row
// scratch. max_splits: the scratch's splits per (slot, kv head).
template <int KV, int KVM, typename Item, typename OutT, typename QT>
__device__ __forceinline__ void step_split(
    const Item& it, float* smem, float (&red)[2][MAX_D / 32],
    int (&code)[2][MAX_D], const QT* __restrict__ qkv,
    const void* __restrict__ k_cache, const void* __restrict__ v_cache,
    const float* __restrict__ k_scale, const float* __restrict__ v_scale,
    const int* __restrict__ pos, const float* __restrict__ cos2,
    const float* __restrict__ sinm, OutT* __restrict__ attn,
    void* __restrict__ k_new, void* __restrict__ v_new,
    float* __restrict__ ks_new, float* __restrict__ vs_new,
    float* __restrict__ part_ml, float* __restrict__ part_acc,
    unsigned* __restrict__ counters, int H, int n_kv, int D, int S, int win,
    float scale, int split, int kvh, int b, int max_splits) {
  constexpr bool QUANT = attn_step::quantized(KV);
  const int n_hist = min(pos[b], win);
  const int n_splits = max(1, (n_hist + SPLIT_ROWS - 1) / SPLIT_ROWS);
  if (split >= n_splits) return;
  const int t = it.t();
  const int lane = t & 31;
  const int kv_mul = H / n_kv;
  const int half = D / 2;
  const Smem sm = carve(smem, kv_mul, D);
  const QT* row = qkv + (size_t)b * (H + 2 * n_kv) * D;
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
    attn_step::new_row<KV>(it, red, code, row, c, sn, partner, k_new, v_new,
                           ks_new, vs_new, H, n_kv, D, kvh,
                           (size_t)b * n_kv + kvh, kcur, vcur, ksc, vsc);
    sm.kcur[t] = kcur;
    it.sync();
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
  Partial<KVM> pt = attend_split<KV, KVM>(
      it, sm, k_cache, v_cache, k_scale, v_scale, (size_t)b * S * n_kv + kvh,
      n_kv, r0, min(SPLIT_ROWS, n_hist - r0), INT_MAX,
      split == 0 ? sm.scur : nullptr, kv_mul, D, scale);
  if (split == 0) {
    // the current token's term: p = 1 times its v scale, rounded to bf16,
    // then scaled by alpha = exp(s_cur - m) as the online softmax does
    const float p = round_bf16(QUANT ? vsc : 1.0f);
#pragma unroll
    for (int h = 0; h < KVM; ++h)
      if (h < kv_mul) {
        const float alpha = expf(sm.scur[h] - pt.m[h]);
        pt.l[h] = __fadd_rn(alpha, pt.l[h]);
        pt.acc[h] = __fadd_rn(__fmul_rn(p * vcur, alpha), pt.acc[h]);
      }
  }
  finish_split(it, sm, pt, attn + ((size_t)b * H + kvh * kv_mul) * D,
               part_ml, part_acc, counters, (size_t)b * n_kv + kvh, split,
               n_splits, max_splits, kv_mul, D);
}

// the launch's dynamic shared memory, raising the kernel's limit above
// the default 48 KB where the shape needs it
template <typename Kernel>
inline cudaError_t prepare_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace decode_attn
