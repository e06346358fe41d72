// Decode attention for one query token per slot over a KV cache that already
// holds the current row: slot b's heads attend to cache rows s <= pos[b],
// with an online softmax, for the bf16 and the int8 cache.
//
// Replaces: llama_cu_awq_tpu/ops/pallas/batched_attention.py,
//   batched_decode_attention (kernel _make_kernel, block size _pick_blk).
//
// What bounds it on the H100: the cache bytes. A slot reads rows 0..pos[b]
//   of k and v once: at 7B with a bf16 cache and one slot at position 1500
//   that is 1501 rows x 32 heads x 128 x 2 B x 2 = 24.6 MB per layer (7.3 us
//   at 3.35 TB/s); the int8 cache halves it and adds 4 B of scales per row
//   and head. The arithmetic is 4 flops per cache element, far below the
//   tensor cores' line.
//
// What the design does about it: one block per (slot, kv head), D threads,
//   covering the kv_mul query heads that share the kv head, so each k/v row
//   is read once for all of them (the JAX kernel's block-diagonal Q_bd does
//   the same on the TPU's matrix unit). A warp reads a k row as 32 lanes of
//   consecutive elements; a thread reads one element of each v row. The
//   rows go in chunks of CHUNK: f32 scores of the bf16-rounded q against
//   the row (codes for int8), times the row's k scale, times 1/sqrt(D);
//   masked rows score -1e30 and get p = 0; p is multiplied by the row's v
//   scale and rounded to bf16 before the PV product (batched_attention.py:
//   106-143). Scores are not staged through bf16 (the einsum path does).
//   early_exit != 0 ("batched") stops after row pos[b]; early_exit == 0
//   ("batched_static") walks the whole window under the mask and reads
//   every row of it, which is what that variant exists to measure. This is
//   the structure of csrc/attention_step.cu without its first phase (the
//   current row is in the cache here). One block per head leaves most SMs
//   idle at batch 1; splitting the window across blocks is later work.

#include "common.cuh"

namespace {

constexpr int CHUNK = 64;       // cache rows per online-softmax step
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
batched_attention_kernel(const __nv_bfloat16* __restrict__ q,
                         const void* __restrict__ k_cache,
                         const void* __restrict__ v_cache,
                         const float* __restrict__ k_scale,
                         const float* __restrict__ v_scale,
                         const int* __restrict__ pos, float* __restrict__ out,
                         int H, int n_kv, int D, int S, int window,
                         int early_exit, float scale) {
  __shared__ float q_s[MAX_KV_MUL * MAX_D];
  __shared__ float s_s[MAX_KV_MUL * CHUNK];
  __shared__ float p_s[MAX_KV_MUL * CHUNK];
  __shared__ float ks_rows[CHUNK];
  __shared__ float vs_rows[CHUNK];
  __shared__ float m_s[MAX_KV_MUL];
  __shared__ float l_s[MAX_KV_MUL];
  __shared__ float alpha_s[MAX_KV_MUL];

  const int t = threadIdx.x;  // blockDim.x == D
  const int lane = t & 31;
  const int warp = t >> 5;
  const int nwarps = blockDim.x >> 5;
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int kv_mul = H / n_kv;
  const int p0 = pos[b];

  for (int h = 0; h < kv_mul; ++h)
    q_s[h * D + t] =
        __bfloat162float(q[((size_t)b * H + kvh * kv_mul + h) * D + t]);
  if (t < kv_mul) {
    m_s[t] = NEG;
    l_s[t] = 0.0f;
  }
  float acc[MAX_KV_MUL];
#pragma unroll
  for (int h = 0; h < MAX_KV_MUL; ++h) acc[h] = 0.0f;
  __syncthreads();

  const int n_rows = early_exit ? min(p0 + 1, window) : window;
  for (int r0 = 0; r0 < n_rows; r0 += CHUNK) {
    const int n = min(CHUNK, n_rows - r0);
    if constexpr (QUANT) {
      for (int j = t; j < n; j += blockDim.x) {
        const size_t si = ((size_t)b * S + r0 + j) * n_kv + kvh;
        ks_rows[j] = k_scale[si];
        vs_rows[j] = v_scale[si];
      }
      __syncthreads();
    }
    // scores: one warp per row, elements at lane + 32*i, every query head
    for (int j = warp; j < n; j += nwarps) {
      const size_t base = (((size_t)b * S + r0 + j) * n_kv + kvh) * D;
      float kv[MAX_D / 32];
      for (int i = 0, e = lane; e < D; ++i, e += 32)
        kv[i] = load_kv<QUANT>(k_cache, base + e);
      for (int h = 0; h < kv_mul; ++h) {
        float part = 0.0f;
        for (int i = 0, e = lane; e < D; ++i, e += 32)
          part = fmaf(kv[i], q_s[h * D + e], part);
        part = warp_sum(part);
        if (lane == 0) {
          float raw = part;
          if constexpr (QUANT) raw = raw * ks_rows[j];
          s_s[h * CHUNK + j] = r0 + j <= p0 ? raw * scale : NEG;
        }
      }
    }
    __syncthreads();
    // softmax update over the chunk, then acc = acc*alpha + p @ v
    for (int h = warp; h < kv_mul; h += nwarps) {
      float mx = NEG;
      for (int j = lane; j < n; j += 32) mx = fmaxf(mx, s_s[h * CHUNK + j]);
      mx = warp_max(mx);
      const float m_old = m_s[h];
      const float m_new = fmaxf(m_old, mx);
      const float alpha = expf(m_old - m_new);
      float sum = 0.0f;
      for (int j = lane; j < n; j += 32) {
        float p = r0 + j <= p0 ? expf(s_s[h * CHUNK + j] - m_new) : 0.0f;
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
      const float vv = load_kv<QUANT>(
          v_cache, (((size_t)b * S + r0 + j) * n_kv + kvh) * D + t);
#pragma unroll
      for (int h = 0; h < MAX_KV_MUL; ++h)
        if (h < kv_mul) pv[h] = fmaf(p_s[h * CHUNK + j], vv, pv[h]);
    }
#pragma unroll
    for (int h = 0; h < MAX_KV_MUL; ++h)
      if (h < kv_mul) acc[h] = acc[h] * alpha_s[h] + pv[h];
    __syncthreads();
  }

#pragma unroll
  for (int h = 0; h < MAX_KV_MUL; ++h)
    if (h < kv_mul)
      out[((size_t)b * H + kvh * kv_mul + h) * D + t] = acc[h] / l_s[h];
}

}  // namespace

// q: (B, H, D) bf16. k_cache/v_cache: (B, S, n_kv, D) bf16, or int8 codes
// when k_scale/v_scale ((B, S, n_kv) f32) are given; row pos[b] already
// written. pos: (B,) int32 on the device, each below window (<= S). out:
// (B, H, D) f32. early_exit: 1 reads rows <= pos[b], 0 the whole window.
LLAMA_EXPORT int batched_decode_attention(const void* q, const void* k_cache,
                                          const void* v_cache,
                                          const void* k_scale,
                                          const void* v_scale,
                                          const void* pos, void* out, int B,
                                          int H, int n_kv, int D, int S,
                                          int window, int early_exit,
                                          float scale, void* stream) {
  if (D % 32 != 0 || D > MAX_D || H % n_kv != 0 ||
      H / n_kv > MAX_KV_MUL || B < 1 || window < 1 || window > S)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(n_kv, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* qb = static_cast<const __nv_bfloat16*>(q);
  if (k_scale != nullptr) {
    batched_attention_kernel<true><<<grid, D, 0, st>>>(
        qb, k_cache, v_cache, static_cast<const float*>(k_scale),
        static_cast<const float*>(v_scale), static_cast<const int*>(pos),
        static_cast<float*>(out), H, n_kv, D, S, window, early_exit, scale);
  } else {
    batched_attention_kernel<false><<<grid, D, 0, st>>>(
        qb, k_cache, v_cache, nullptr, nullptr, static_cast<const int*>(pos),
        static_cast<float*>(out), H, n_kv, D, S, window, early_exit, scale);
  }
  return static_cast<int>(cudaGetLastError());
}
