// Causal flash-attention forward for a block of T query tokens over the KV
// cache window (block prefill, perplexity).
//
// Replaces: llama_cu_awq_tpu/ops/pallas/prefill_attention.py,
//   _prefill_attention_jit (kernel _make_kernel), for the bf16 and the
//   int8 cache.
//
// What bounds it on the H100: the cache bytes. At 7B, T = 128 at position
//   1024, one layer reads 1152 rows x 32 heads x 128 x 2 B for k and for v
//   (18.9 MB, 5.6 us at 3.35 TB/s) and does 4 x 128 x 32 x 128 x 1152 =
//   2.4 GFLOP (2.4 us at 989 TFLOP/s bf16).
//
// What the design does about it:
//   - One block per (slot, kv head, tile of QT query rows). The rows of a
//     kv head are the JAX kernel's (prefill_attention.py:202-204): row r
//     is token r / kv_mul, query head kv_head * kv_mul + r % kv_mul, so a
//     staged k/v chunk serves every query head that shares it.
//   - The block walks key chunks of KC rows from 0 up to the horizon of
//     its last row (pos[b] + t), so each slot stops at its own horizon.
//     k and v are staged row-major in shared memory (int8 codes widen
//     exactly to bf16 there); ldmatrix.trans reads v's PV operand.
//   - Scores and PV run on mma.sync m16n8k16 (bf16 operands, f32
//     accumulation), 4 warps of 16 query rows. q is held in registers as
//     bf16 fragments, scores stay in registers, and p moves from the score
//     accumulator layout straight into the A operand of PV.
//   - The staging is the JAX kernel's (prefill_attention.py:90-123):
//     f32 scores of bf16 operands; int8 scores times k_scale before
//     * 1/sqrt(D); masked scores -1e30 and p = 0 where masked; m starts at
//     -1e30 and l at 0; p times v_scale before it is rounded to bf16 for
//     PV; out = acc / l. Where p rounds depends on the chunks, so the
//     plain version walks the same KC-row chunks.
//   - Loads are not pipelined (stage, sync, compute); wgmma and TMA are
//     later work.

#include "common.cuh"

namespace {

constexpr int QT = 64;       // query rows per block: 4 warps x 16
constexpr int KC = 64;       // keys per online-softmax step
constexpr int THREADS = 128;
constexpr float NEG = -1e30f;

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// The B operand of mma.m16n8k16 (16 keys x 8 columns) from a row-major
// [key][d] tile in shared memory: two 8x8 matrices, transposed on the way
// in. Lanes 0-15 give the address of key row (lane) at column d0.
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&b)[2],
                                                  const __nv_bfloat16* row) {
  const unsigned addr =
      static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(b[0]), "=r"(b[1])
      : "r"(addr));
}

// 8 consecutive cache elements as 8 bf16 (int8 codes widen exactly)
template <bool QUANT>
__device__ __forceinline__ uint4 load8(const void* base, size_t off) {
  if constexpr (QUANT) {
    const uint2 raw = *reinterpret_cast<const uint2*>(
        static_cast<const int8_t*>(base) + off);
    const int8_t* c = reinterpret_cast<const int8_t*>(&raw);
    uint4 o;
    o.x = pack_bf16(static_cast<float>(c[0]), static_cast<float>(c[1]));
    o.y = pack_bf16(static_cast<float>(c[2]), static_cast<float>(c[3]));
    o.z = pack_bf16(static_cast<float>(c[4]), static_cast<float>(c[5]));
    o.w = pack_bf16(static_cast<float>(c[6]), static_cast<float>(c[7]));
    return o;
  } else {
    return *reinterpret_cast<const uint4*>(
        static_cast<const __nv_bfloat16*>(base) + off);
  }
}

template <int D, bool QUANT>
__global__ void __launch_bounds__(THREADS)
prefill_attention_kernel(const __nv_bfloat16* __restrict__ q,
                         const void* __restrict__ k_cache,
                         const void* __restrict__ v_cache,
                         const float* __restrict__ k_scale,
                         const float* __restrict__ v_scale,
                         const int* __restrict__ pos,
                         float* __restrict__ out, int T, int H, int n_kv,
                         int S, int window, float scale) {
  constexpr int LDK = D + 8;   // padded rows: conflict-free fragment loads
  constexpr int DK = D / 16;   // 16-deep steps of q . k
  constexpr int DT = D / 8;    // 8-wide column tiles of the output
  constexpr int NT = KC / 8;   // 8-key tiles of the scores
  __shared__ __align__(16) __nv_bfloat16 kt[KC * LDK];  // [key][d]
  __shared__ __align__(16) __nv_bfloat16 vt[KC * LDK];  // [key][d]
  __shared__ float ksc[KC];
  __shared__ float vsc[KC];

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int kv_mul = H / n_kv;
  const int Tm = T * kv_mul;
  const int r0 = blockIdx.x * QT;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g8 = lane >> 2;
  const int c4 = lane & 3;
  const int p0 = pos[b];

  // this thread's two query rows (fragment rows g8 and g8 + 8)
  const int ra = r0 + warp * 16 + g8;
  const int rb = ra + 8;
  const int lim_a = p0 + ra / kv_mul;  // last key each row may see
  const int lim_b = p0 + rb / kv_mul;
  auto row_off = [&](int r) -> size_t {
    const int t = r / kv_mul;
    const int head = h * kv_mul + r % kv_mul;
    return (static_cast<size_t>(b) * T + t) * H * D +
           static_cast<size_t>(head) * D;
  };

  uint32_t qa[DK][4];
#pragma unroll
  for (int kk = 0; kk < DK; ++kk) {
    const int d = kk * 16 + c4 * 2;
    qa[kk][0] = ra < Tm ? ld32(q + row_off(ra) + d) : 0u;
    qa[kk][1] = rb < Tm ? ld32(q + row_off(rb) + d) : 0u;
    qa[kk][2] = ra < Tm ? ld32(q + row_off(ra) + d + 8) : 0u;
    qa[kk][3] = rb < Tm ? ld32(q + row_off(rb) + d + 8) : 0u;
  }

  float o[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[dt][i] = 0.0f;
  float m_a = NEG, m_b = NEG, l_a = 0.0f, l_b = 0.0f;

  const int last_row = min(r0 + QT, Tm) - 1;
  const int horizon = min(p0 + last_row / kv_mul, window - 1);
  for (int c0 = 0; c0 <= horizon; c0 += KC) {
    __syncthreads();  // the previous chunk has been read
    for (int i = tid; i < KC * (D / 8); i += THREADS) {
      const int j = i / (D / 8);
      const int d8 = i % (D / 8);
      const int s = c0 + j;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u);
      uint4 vv = make_uint4(0u, 0u, 0u, 0u);
      if (s < window) {
        const size_t off =
            (static_cast<size_t>(b) * S + s) * n_kv * D +
            static_cast<size_t>(h) * D + d8 * 8;
        kv = load8<QUANT>(k_cache, off);
        vv = load8<QUANT>(v_cache, off);
      }
      *reinterpret_cast<uint4*>(kt + j * LDK + d8 * 8) = kv;
      *reinterpret_cast<uint4*>(vt + j * LDK + d8 * 8) = vv;
    }
    if (tid < KC) {
      const int s = c0 + tid;
      const size_t si = (static_cast<size_t>(b) * S + s) * n_kv + h;
      ksc[tid] = (QUANT && s < window) ? k_scale[si] : 0.0f;
      vsc[tid] = (QUANT && s < window) ? v_scale[si] : 0.0f;
    }
    __syncthreads();

    // scores: (16 rows) x (KC keys) per warp
    float sacc[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) sacc[nt][i] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < DK; ++kk) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const __nv_bfloat16* kp = kt + (nt * 8 + g8) * LDK + kk * 16 + c4 * 2;
        const uint32_t bk[2] = {ld32(kp), ld32(kp + 8)};
        mma_bf16_16x8x16(sacc[nt], qa[kk], bk);
      }
    }
    float mx_a = NEG, mx_b = NEG;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int j = nt * 8 + c4 * 2 + (i & 1);
        const int s = c0 + j;
        float v = sacc[nt][i];
        if (QUANT) v *= ksc[j];
        v *= scale;
        const bool ok = s < window && s <= (i < 2 ? lim_a : lim_b);
        v = ok ? v : NEG;
        sacc[nt][i] = v;
        if (i < 2) {
          mx_a = fmaxf(mx_a, v);
        } else {
          mx_b = fmaxf(mx_b, v);
        }
      }
    // the 4 lanes of a fragment row group hold one row between them
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 1));
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 2));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 1));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 2));
    const float mn_a = fmaxf(m_a, mx_a);
    const float mn_b = fmaxf(m_b, mx_b);
    const float al_a = expf(m_a - mn_a);
    const float al_b = expf(m_b - mn_b);
    float sum_a = 0.0f, sum_b = 0.0f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int j = nt * 8 + c4 * 2 + (i & 1);
        const int s = c0 + j;
        const bool ok = s < window && s <= (i < 2 ? lim_a : lim_b);
        const float p = ok ? expf(sacc[nt][i] - (i < 2 ? mn_a : mn_b)) : 0.0f;
        if (i < 2) {
          sum_a += p;
        } else {
          sum_b += p;
        }
        sacc[nt][i] = QUANT ? p * vsc[j] : p;
      }
    sum_a += __shfl_xor_sync(0xffffffffu, sum_a, 1);
    sum_a += __shfl_xor_sync(0xffffffffu, sum_a, 2);
    sum_b += __shfl_xor_sync(0xffffffffu, sum_b, 1);
    sum_b += __shfl_xor_sync(0xffffffffu, sum_b, 2);
    l_a = l_a * al_a + sum_a;
    l_b = l_b * al_b + sum_b;
    m_a = mn_a;
    m_b = mn_b;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      o[dt][0] *= al_a;
      o[dt][1] *= al_a;
      o[dt][2] *= al_b;
      o[dt][3] *= al_b;
    }
    // o += bf16(p) . v, p straight from the score accumulators
#pragma unroll
    for (int kk = 0; kk < KC / 16; ++kk) {
      const uint32_t pa[4] = {
          pack_bf16(sacc[2 * kk][0], sacc[2 * kk][1]),
          pack_bf16(sacc[2 * kk][2], sacc[2 * kk][3]),
          pack_bf16(sacc[2 * kk + 1][0], sacc[2 * kk + 1][1]),
          pack_bf16(sacc[2 * kk + 1][2], sacc[2 * kk + 1][3])};
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        uint32_t bv[2];
        ldmatrix_x2_trans(bv, vt + (kk * 16 + (lane & 15)) * LDK + dt * 8);
        mma_bf16_16x8x16(o[dt], pa, bv);
      }
    }
  }

#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
    const int d = dt * 8 + c4 * 2;
    if (ra < Tm)
      *reinterpret_cast<float2*>(out + row_off(ra) + d) =
          make_float2(o[dt][0] / l_a, o[dt][1] / l_a);
    if (rb < Tm)
      *reinterpret_cast<float2*>(out + row_off(rb) + d) =
          make_float2(o[dt][2] / l_b, o[dt][3] / l_b);
  }
}

template <int D, bool QUANT>
int launch(const void* q, const void* k, const void* v, const void* ks,
           const void* vs, const void* pos, void* out, int B, int T, int H,
           int n_kv, int S, int window, float scale, cudaStream_t stream) {
  const int Tm = T * (H / n_kv);
  const dim3 grid((Tm + QT - 1) / QT, n_kv, B);
  prefill_attention_kernel<D, QUANT><<<grid, THREADS, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), k, v,
      static_cast<const float*>(ks), static_cast<const float*>(vs),
      static_cast<const int*>(pos), static_cast<float*>(out), T, H, n_kv, S,
      window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q: (B, T, H, D) bf16. k, v: (B, S, n_kv, D) bf16, or int8 codes with
// ks, vs (B, S, n_kv) f32 (null for bf16). pos: (B,) int32, the position of
// each slot's first token; the cache already holds the block's own k/v.
// out: (B, T, H, D) f32. Key s is visible to token t of slot b iff
// s <= pos[b] + t and s < window (window <= S). Needs H % n_kv == 0 and
// D of 64 or 128.
LLAMA_EXPORT int prefill_attention(const void* q, const void* k,
                                   const void* v, const void* ks,
                                   const void* vs, const void* pos,
                                   void* out, int B, int T, int H, int n_kv,
                                   int D, int S, int window, float scale,
                                   void* stream) {
  if (B < 1 || T < 1 || n_kv < 1 || H % n_kv != 0 || window < 1 ||
      window > S || (D != 64 && D != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool quant = ks != nullptr;
  if (D == 64)
    return quant ? launch<64, true>(q, k, v, ks, vs, pos, out, B, T, H, n_kv,
                                    S, window, scale, st)
                 : launch<64, false>(q, k, v, ks, vs, pos, out, B, T, H,
                                     n_kv, S, window, scale, st);
  return quant ? launch<128, true>(q, k, v, ks, vs, pos, out, B, T, H, n_kv,
                                   S, window, scale, st)
               : launch<128, false>(q, k, v, ks, vs, pos, out, B, T, H, n_kv,
                                    S, window, scale, st);
}
