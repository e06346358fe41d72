// Split-window decode attention (flash-decoding) for one query token per
// slot, shared by attention_step.cu and batched_attention.cu.
//
// A block owns one split of one (slot, kv head): a fixed run of
// SPLIT_ROWS cache rows (below; ops/cuda/attention_step.py's SPLIT_ROWS is
// the same number for the plain versions and the scratch sizes). The split
// length never depends on the batch, the card or other slots, so a slot's
// result depends only on its own position and cache. Threads: D (a
// multiple of 32). In a split:
//   1. scores: a k row is read as 16-byte vectors, one row across
//      row_bytes/16 lanes (16 lanes for bf16 at D=128, 8 for int8, 4 for
//      packed int4); the next rows load while the current ones reduce;
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
// online softmax's step. The block then writes its partial (m, l,
// acc[kv_mul][D]) in f32 to scratch. The last block of a (slot, kv head)
// to finish (a __threadfence and an atomic counter, which that block
// resets to 0) combines the splits in split order 0..n-1:
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
  return KV == KV_BF16 ? 2 * D : KV == KV_INT8 ? D : D / 2;
}

__host__ __device__ inline int pow2_at_least(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

// Dynamic shared memory of a split block, in floats: m, l and the current
// token's scores, then q, the scores, the rows' scales and the current
// token's k values, over which the per-warp PV partials (red) are laid
// once those are read.
struct Smem {
  float* m;     // [MAX_KV_MUL] the split's max per query head
  float* l;     // [MAX_KV_MUL] the split's sum of p
  float* scur;  // [MAX_KV_MUL] the current token's scores (attention_step)
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
  sm.q = base + 4 * MAX_KV_MUL;  // 16-byte aligned
  sm.s = sm.q + kv_mul * D;
  sm.ks = sm.s + kv_mul * SPLIT_ROWS;
  sm.vs = sm.ks + SPLIT_ROWS;
  sm.kcur = sm.vs + SPLIT_ROWS;
  sm.red = sm.q;
  return sm;
}

// A split's (m, l, acc) as thread t holds it: acc[h] is element t of
// query head h.
struct Partial {
  float m[MAX_KV_MUL];
  float l[MAX_KV_MUL];
  float acc[MAX_KV_MUL];
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

// A lane's v load: 16 bytes of bf16, 8 of int8, 4 of packed int4, each
// 8 elements of the row.
template <int KV>
struct VVec;
template <>
struct VVec<KV_BF16> {
  using T = uint4;
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
  if constexpr (KV == KV_BF16) {
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
template <int KV>
__device__ __forceinline__ Partial attend_split(
    const Smem& sm, const void* __restrict__ k_cache,
    const void* __restrict__ v_cache, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, size_t row0, int n_kv, int r0, int n,
    int p_last, const float* m_start, int kv_mul, int D, float scale) {
  constexpr bool QUANT = KV != KV_BF16;
  const int t = threadIdx.x;
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
  __syncthreads();

  // ---- scores: a row across LK lanes (padded to LKP), 16 B each; the
  // next ROWS_IN_FLIGHT rows load while the current ones reduce ----
  {
    const int LK = RB / 16;
    const int LKP = pow2_at_least(LK);
    const int sub = lane & (LKP - 1);
    const int grp = warp * (32 / LKP) + lane / LKP;
    const int G = nwarps * (32 / LKP);
    const char* kb = static_cast<const char*>(k_cache);
    auto load = [&](uint4 (&w)[ROWS_IN_FLIGHT], int j0) {
#pragma unroll
      for (int u = 0; u < ROWS_IN_FLIGHT; ++u) {
        const int j = j0 + u * G + grp;
        if (sub < LK && j < n) {
          w[u] = __ldg(reinterpret_cast<const uint4*>(
                           kb + (row0 + (size_t)(r0 + j) * n_kv) * RB) +
                       sub);
        } else {
          w[u] = make_uint4(0u, 0u, 0u, 0u);
        }
      }
    };
    uint4 next[ROWS_IN_FLIGHT];
    load(next, 0);
    for (int j0 = 0; j0 < n; j0 += G * ROWS_IN_FLIGHT) {
      uint4 w[ROWS_IN_FLIGHT];
#pragma unroll
      for (int u = 0; u < ROWS_IN_FLIGHT; ++u) w[u] = next[u];
      load(next, j0 + G * ROWS_IN_FLIGHT);
#pragma unroll
      for (int u = 0; u < ROWS_IN_FLIGHT; ++u) {
        const int j = j0 + u * G + grp;
#pragma unroll
        for (int h = 0; h < MAX_KV_MUL; ++h) {
          if (h < kv_mul) {
            float part = sub < LK ? dot16<KV>(w[u], sm.q + h * D, sub, D)
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
        w[u] = __ldg(vb + (row0 + (size_t)(r0 + j) * n_kv) * row_vecs + vsub);
    }
  };
  VT vnext[ROWS_IN_FLIGHT];
  load_v(vnext, vgrp);
  __syncthreads();

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
  __syncthreads();

  // ---- PV: a row across D/8 lanes (padded to LVP), 8 elements each ----
  float acc[MAX_KV_MUL][8];
#pragma unroll
  for (int h = 0; h < MAX_KV_MUL; ++h)
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
          for (int h = 0; h < MAX_KV_MUL; ++h)
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
    for (int h = 0; h < MAX_KV_MUL; ++h)
      if (h < kv_mul)
#pragma unroll
        for (int i = 0; i < 8; ++i)
          acc[h][i] += __shfl_xor_sync(FULL, acc[h][i], o);
  __syncthreads();  // q and s are read; red lies over them
  if (lane < LVP && vsub < LV) {
#pragma unroll
    for (int h = 0; h < MAX_KV_MUL; ++h)
      if (h < kv_mul)
#pragma unroll
        for (int i = 0; i < 8; ++i)
          sm.red[(warp * kv_mul + h) * D + v_elem<KV>(vsub, i, D)] =
              acc[h][i];
  }
  __syncthreads();
  Partial out;
#pragma unroll
  for (int h = 0; h < MAX_KV_MUL; ++h) {
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

// The end of a split block: with one split, out = acc / l; else write the
// partial and, in the last block of the (slot, kv head) to finish, combine
// every split in order, and reset the counter. item =
// b * n_kv + kvh; out points at the item's first query head row; part_ml
// (items, max_splits, 2, kv_mul) and part_acc (items, max_splits, kv_mul,
// D) are f32 scratch.
__device__ __forceinline__ void finish_split(
    const Partial& pt, float* __restrict__ out, float* __restrict__ part_ml,
    float* __restrict__ part_acc, unsigned* __restrict__ counters,
    size_t item, int split, int n_splits, int max_splits, int kv_mul, int D) {
  __shared__ bool last;
  const int t = threadIdx.x;
  if (n_splits == 1) {
#pragma unroll
    for (int h = 0; h < MAX_KV_MUL; ++h)
      if (h < kv_mul) out[(size_t)h * D + t] = pt.acc[h] / pt.l[h];
    return;
  }
  const size_t base = item * max_splits;
  float* pa = part_acc + (base + split) * kv_mul * D;
  float* pm = part_ml + (base + split) * 2 * kv_mul;
#pragma unroll
  for (int h = 0; h < MAX_KV_MUL; ++h)
    if (h < kv_mul) {
      pa[(size_t)h * D + t] = pt.acc[h];
      if (t == h) {
        pm[h] = pt.m[h];
        pm[kv_mul + h] = pt.l[h];
      }
    }
  __threadfence();
  __syncthreads();
  if (t == 0) last = atomicAdd(counters + item, 1u) == (unsigned)n_splits - 1;
  __syncthreads();
  if (!last) return;
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
    out[(size_t)h * D + t] = A / L;
  }
  if (t == 0) counters[item] = 0u;
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
