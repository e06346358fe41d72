// Causal flash-attention forward for a block of T query tokens over the KV
// cache window (block prefill, perplexity), the key range split across
// blocks.
//
// Replaces: llama_cu_awq_tpu/ops/pallas/prefill_attention.py,
//   _prefill_attention_jit (kernel _make_kernel), for the bf16 and the
//   int8 cache, and the fp16 and f32 caches of --act-dtype float16 /
//   float32, whose blocks the JAX kernel casts to bf16 as it loads them
//   (prefill_attention.py:93-94).
//
// What bounds it on the H100: the cache bytes. At 7B, T = 128 at position
//   1024, one layer reads 1152 rows x 32 heads x 128 x 2 B for k and for v
//   (18.9 MB, 5.6 us at 3.35 TB/s; 6.57 us with q and the output) and
//   does 4 x 128 x 32 x 128 x 1152 = 2.4 GFLOP (2.4 us at 989 TFLOP/s
//   bf16): about 128 operations a byte, under the card's 295.
//
// What the design does about it:
//   - The key range is cut into splits of SPLIT (256) rows at fixed
//     boundaries (0, 256, 512, ...), as decode_attention.cuh cuts its
//     window in SPLIT_ROWS. A block takes one (query tile of QT = 64
//     rows, split, kv head, slot): grid (q tiles x splits of the window,
//     n_kv, B). At 7B, T = 128 at position 1024 over a 2048-row window,
//     that is 2 x 8 x 32 = 512 blocks of 128 threads, of which the
//     2 x 5 x 32 = 320 whose split starts at or below the tile's causal
//     horizon work (2.4 a SM) and the rest return at once; at position 0
//     only split 0 works (64 blocks); at position 1920, all 512. (128-row
//     splits, twice the blocks and twice the partials, measured slower on
//     the H100 at positions 1024 and 1920.)
//   - Rows of a kv head are the JAX kernel's (prefill_attention.py:
//     202-204): row r is token r / kv_mul, query head kv_head * kv_mul +
//     r % kv_mul, so a staged k/v chunk serves every query head that
//     shares it.
//   - In its split a block walks chunks of KC = 64 keys up to the split's
//     end or the tile's horizon, whichever is first (a split stops at its
//     own causal horizon). The chunks come through a ring of two stages
//     in shared memory filled by cp.async: the next chunk is in flight
//     while the tensor cores multiply the current one, and q's fragments
//     load from global memory while the first chunk arrives. The int8
//     cache copies its raw codes and scales; the block widens a chunk's
//     codes to bf16 out of shared memory (exact, by a byte permute into an
//     f32 and one subtraction) after it lands, never on the load path.
//     The fp16 and f32 caches take the same road: the ring holds the raw
//     rows (a stage of an f32 chunk is 2 x 64 x 128 x 4 B = 64 KB at
//     D=128, twice bf16's), and the landed chunk is rounded to bf16 into
//     the one pair of bf16 tiles the MMAs read. So the stages are sized for
//     the raw rows (the f32 form's 162 KB fit one block an SM, the fp16
//     form's 98 KB two) and the MMA operands stay as for bf16.
//   - A chunk that lies below the window and below the tile's first row's
//     limit (every chunk of a split but the last at pos 1024) takes a
//     softmax without the per-key mask.
//   - Scores and PV run on mma.sync m16n8k16 (bf16 operands, f32
//     accumulation), 4 warps of 16 query rows: at about 128 operations a
//     byte the kernel is bound by bytes, where mma.sync is enough. q is
//     held in registers as bf16 fragments, scores stay in registers, and p
//     moves from the score accumulator layout straight into the A operand
//     of PV; ldmatrix.trans reads v's PV operand.
//   - The staging is the JAX kernel's (prefill_attention.py:90-123):
//     f32 scores of bf16 operands; int8 scores times k_scale before
//     * 1/sqrt(D); masked scores -1e30 and p = 0 where masked; m starts at
//     -1e30 and l at 0 in each split; p times v_scale before it is rounded
//     to bf16 for PV.
//   - Each split writes its partial (m, l, unnormalised acc) in f32 to
//     scratch; a second launch (merge) combines, for each query row, the
//     splits 0 .. horizon / SPLIT in split order, as decode_attention.cuh
//     and ops/cuda/attention_step.py's combine_splits do:
//       M = max m_i (splits with l_i = 0 left out),
//       L = sum l_i * exp(m_i - M),  A = sum acc_i * exp(m_i - M),
//       out = A / L,
//     with separately rounded products and sums and no atomics, so a run
//     gives the same bits every time. Where p rounds depends on the splits
//     and chunks, so the plain version walks the same ones. The partials
//     at 7B, pos 1024: 320 blocks x 64 rows x 130 floats, 10.6 MB written
//     and read back (most of it from the 50 MB L2). The merge is launched
//     as a programmatic dependent of the split launch (griddepcontrol),
//     so its blocks are set up when the splits end.

#include "async_copy.cuh"
#include "common.cuh"

namespace {

namespace ac = async_copy;

constexpr int QT = 64;       // query rows per block: a warp's 16 each
constexpr int KC = 64;       // keys per online-softmax step
constexpr int SPLIT = 256;   // keys per split (SPLIT_ROWS in the wrapper)
constexpr int THREADS = 2 * QT;
constexpr float NEG = -1e30f;

// cache formats: bf16, int8 codes with f32 scales, fp16, f32
constexpr int CF_BF16 = 0;
constexpr int CF_INT8 = 1;
constexpr int CF_F16 = 2;
constexpr int CF_F32 = 3;
// bytes of one cache element
__host__ __device__ constexpr int elem_bytes(int cf) {
  return cf == CF_F32 ? 4 : cf == CF_INT8 ? 1 : 2;
}
static_assert(SPLIT % KC == 0, "a chunk never crosses a split boundary");

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// The B operand of mma.m16n8k16 (16 keys x 8 columns) from a row-major
// [key][d] tile in shared memory: two 8x8 matrices, transposed on the way
// in. Lanes 0-15 give the address of key row (lane) at column d0.
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&b)[2],
                                                  const __nv_bfloat16* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(b[0]), "=r"(b[1])
      : "r"(ac::smem_addr(row)));
}

// The online softmax of one chunk for a thread's two rows (fragment rows
// g8 and g8 + 8): raw scores (times k_scale for int8) times scale, masked
// to -1e30 where a key lies past the row's limit or the window (MASK), the
// new max m over the running one and the chunk, p = exp(s - m) (0 where
// masked), l = l * alpha + sum p with alpha = exp(m_old - m_new); p (times
// v_scale for int8) replaces the score in sacc for the PV product.
template <int NT, bool QUANT, bool MASK>
__device__ __forceinline__ void softmax_chunk(
    float (&sacc)[NT][4], const float* ksc, const float* vsc, float scale,
    int c0, int c4, int window, int lim_a, int lim_b, float& m_a,
    float& m_b, float& l_a, float& l_b, float& al_a, float& al_b) {
  float mx_a = NEG, mx_b = NEG;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = nt * 8 + c4 * 2 + (i & 1);
      float v = sacc[nt][i];
      if (QUANT) v *= ksc[j];
      v *= scale;
      if (MASK) {
        const int s = c0 + j;
        v = s < window && s <= (i < 2 ? lim_a : lim_b) ? v : NEG;
      }
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
  al_a = expf(m_a - mn_a);
  al_b = expf(m_b - mn_b);
  float sum_a = 0.0f, sum_b = 0.0f;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = nt * 8 + c4 * 2 + (i & 1);
      float p = expf(sacc[nt][i] - (i < 2 ? mn_a : mn_b));
      if (MASK) {
        const int s = c0 + j;
        p = s < window && s <= (i < 2 ? lim_a : lim_b) ? p : 0.0f;
      }
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
}

// 8 int8 codes as 8 bf16, exactly, on the integer and f32 pipes (no
// int-to-float conversion): byte b ^ 0x80 under the exponent of 2^23 is
// the f32 2^23 + 128 + b, less 2^23 + 128
__device__ __forceinline__ void widen8(uint2 c, uint4& o) {
  const uint32_t w[2] = {c.x ^ 0x80808080u, c.y ^ 0x80808080u};
  uint32_t* ow = reinterpret_cast<uint32_t*>(&o);
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const float lo = __uint_as_float(__byte_perm(w[h], 0x4B000000u,
                                                   0x7650u + 2 * p)) -
                       8388736.0f;
      const float hi = __uint_as_float(__byte_perm(w[h], 0x4B000000u,
                                                   0x7651u + 2 * p)) -
                       8388736.0f;
      ow[2 * h + p] = pack_bf16(lo, hi);
    }
}

// 8 fp16 or f32 cache values (16 or 32 bytes at p, shared memory) as 8
// bf16, rounded to nearest even (XLA's astype)
template <int CF>
__device__ __forceinline__ void round8(const unsigned char* p, uint4& o) {
  float v[8];
  if constexpr (CF == CF_F16) {
    const uint4 w = *reinterpret_cast<const uint4*>(p);
    const __half2* h = reinterpret_cast<const __half2*>(&w);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __half22float2(h[k]);
      v[2 * k] = f.x;
      v[2 * k + 1] = f.y;
    }
  } else {
    const float4 a = *reinterpret_cast<const float4*>(p);
    const float4 b = *reinterpret_cast<const float4*>(p + 16);
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
    v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
  }
  uint32_t* ow = reinterpret_cast<uint32_t*>(&o);
#pragma unroll
  for (int k = 0; k < 4; ++k) ow[k] = pack_bf16(v[2 * k], v[2 * k + 1]);
}

// Shared memory of one block, in bytes. bf16: two stages of k and v in
// bf16 rows padded to LDK. int8, fp16 and f32: two stages of the raw rows
// (and the int8 scales), and one pair of bf16 tiles the landed stage
// widens or rounds into.
template <int D, int CF>
struct Layout {
  static constexpr int LDK = D + 8;  // padded rows: conflict-free fragments
  static constexpr int TILE = KC * LDK * 2;           // one bf16 k or v tile
  // raw k and v rows of a chunk (+ the int8 k and v scales)
  static constexpr int RAW =
      2 * KC * D * elem_bytes(CF) + (CF == CF_INT8 ? 2 * KC * 4 : 0);
  static constexpr int BYTES = CF == CF_BF16 ? 4 * TILE : 2 * TILE + 2 * RAW;
};

// three blocks an SM (at most 168 registers; the int8 form spills a few
// bytes): at two, the int8 form's warps wait on their own chains, and it
// ran slower on the H100
template <int D, int CF>
__global__ void __launch_bounds__(THREADS, 3)
prefill_split_kernel(const __nv_bfloat16* __restrict__ q,
                     const void* __restrict__ k_cache,
                     const void* __restrict__ v_cache,
                     const float* __restrict__ k_scale,
                     const float* __restrict__ v_scale,
                     const int* __restrict__ pos,
                     float2* __restrict__ part_ml,
                     float* __restrict__ part_acc, int T, int H, int n_kv,
                     int S, int window, int n_qtiles, int n_splits,
                     float scale) {
  using L = Layout<D, CF>;
  constexpr bool QUANT = CF == CF_INT8;
  constexpr int EB = elem_bytes(CF);
  constexpr int LDK = L::LDK;
  constexpr int DK = D / 16;   // 16-deep steps of q . k
  constexpr int DT = D / 8;    // 8-wide column tiles of the output
  constexpr int NT = KC / 8;   // 8-key tiles of the scores
  extern __shared__ __align__(16) unsigned char smem[];

  // the merge launch may start now; it waits for this grid's end
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int qtile = blockIdx.x % n_qtiles;
  const int sp = blockIdx.x / n_qtiles;
  const int kv_mul = H / n_kv;
  const int Tm = T * kv_mul;
  const int r0 = qtile * QT;
  const int p0 = pos[b];
  const int last_row = min(r0 + QT, Tm) - 1;
  const int horizon = min(p0 + last_row / kv_mul, window - 1);
  const int s0 = sp * SPLIT;
  if (s0 > horizon) return;  // no key of this split is visible to the tile
  const int s_end = min(s0 + SPLIT, horizon + 1);
  const int n_chunks = (s_end - s0 + KC - 1) / KC;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g8 = lane >> 2;
  const int c4 = lane & 3;

  auto kv_off = [&](int s) -> size_t {
    return (static_cast<size_t>(b) * S + s) * n_kv * D +
           static_cast<size_t>(h) * D;
  };
  // stage st's tiles: bf16 k and v (bf16 cache), or raw rows (and
  // scales)
  auto bf16_tile = [&](int i) {
    return reinterpret_cast<__nv_bfloat16*>(smem + i * L::TILE);
  };
  auto raw = [&](int st) { return smem + 2 * L::TILE + st * L::RAW; };
  // issue the copies of chunk c into stage c % 2
  auto issue = [&](int c) {
    const int c0 = s0 + c * KC;
    const int st = c & 1;
    if constexpr (CF != CF_BF16) {
      // a row's D * EB bytes in 16-byte copies
      constexpr int U = D * EB / 16;
      unsigned char* kr = raw(st);
      unsigned char* vr = kr + KC * D * EB;
      float* ks = reinterpret_cast<float*>(vr + KC * D * EB);
      for (int i = tid; i < KC * U; i += THREADS) {
        const int j = i / U;
        const int u = i % U;
        const int s = c0 + j;
        const bool ok = s < window;
        const size_t off = ok ? kv_off(s) * EB + u * 16 : 0;
        ac::cp16(kr + (j * U + u) * 16,
                 static_cast<const unsigned char*>(k_cache) + off, ok);
        ac::cp16(vr + (j * U + u) * 16,
                 static_cast<const unsigned char*>(v_cache) + off, ok);
      }
      if (QUANT && tid < 2 * KC) {
        const int j = tid % KC;
        const int s = c0 + j;
        const bool ok = s < window;
        const size_t si = ok ? (static_cast<size_t>(b) * S + s) * n_kv + h
                             : 0;
        ac::cp4(ks + tid, (tid < KC ? k_scale : v_scale) + si, ok);
      }
    } else {
      __nv_bfloat16* kt = bf16_tile(2 * st);
      __nv_bfloat16* vt = bf16_tile(2 * st + 1);
      for (int i = tid; i < KC * (D / 8); i += THREADS) {
        const int j = i / (D / 8);
        const int d8 = i % (D / 8);
        const int s = c0 + j;
        const bool ok = s < window;
        const size_t off = ok ? kv_off(s) + d8 * 8 : 0;
        ac::cp16(kt + j * LDK + d8 * 8,
                 static_cast<const __nv_bfloat16*>(k_cache) + off, ok);
        ac::cp16(vt + j * LDK + d8 * 8,
                 static_cast<const __nv_bfloat16*>(v_cache) + off, ok);
      }
    }
    ac::commit();
  };
  issue(0);
  if (n_chunks > 1) issue(1);

  // this thread's two query rows (fragment rows g8 and g8 + 8), loaded
  // while the first chunks are in flight
  const int ra = r0 + warp * 16 + g8;
  const int rb = ra + 8;
  const int lim_a = p0 + ra / kv_mul;  // last key each row may see
  const int lim_b = p0 + rb / kv_mul;
  const int lim_tile = p0 + r0 / kv_mul;  // the tile's first row's
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

  for (int c = 0; c < n_chunks; ++c) {
    const int c0 = s0 + c * KC;
    const int st = c & 1;
    if (c == 0 && n_chunks > 1) {
      ac::wait<1>();  // chunk 0 has landed; chunk 1 is in flight
    } else {
      ac::wait<0>();  // chunk c has landed
    }
    // chunk c is visible to every warp, and every warp is done with chunk
    // c - 1, whose stage takes chunk c + 1 while chunk c multiplies
    __syncthreads();
    if (c >= 1 && c + 1 < n_chunks) issue(c + 1);
    const __nv_bfloat16* kt;
    const __nv_bfloat16* vt;
    const float* ksc = nullptr;
    const float* vsc = nullptr;
    if constexpr (CF != CF_BF16) {
      // widen the landed codes to bf16 (exact), or round the landed fp16
      // or f32 rows to bf16, out of shared memory
      const unsigned char* kr = raw(st);
      const unsigned char* vr = kr + KC * D * EB;
      ksc = reinterpret_cast<const float*>(vr + KC * D * EB);
      vsc = ksc + KC;
      __nv_bfloat16* kw = bf16_tile(0);
      __nv_bfloat16* vw = bf16_tile(1);
      for (int i = tid; i < KC * (D / 8); i += THREADS) {
        const int j = i / (D / 8);
        const int d8 = i % (D / 8);
        const size_t e = (static_cast<size_t>(j) * D + d8 * 8) * EB;
        uint4 ko, vo;
        if constexpr (QUANT) {
          widen8(*reinterpret_cast<const uint2*>(kr + e), ko);
          widen8(*reinterpret_cast<const uint2*>(vr + e), vo);
        } else {
          round8<CF>(kr + e, ko);
          round8<CF>(vr + e, vo);
        }
        *reinterpret_cast<uint4*>(kw + j * LDK + d8 * 8) = ko;
        *reinterpret_cast<uint4*>(vw + j * LDK + d8 * 8) = vo;
      }
      __syncthreads();
      kt = kw;
      vt = vw;
    } else {
      kt = bf16_tile(2 * st);
      vt = bf16_tile(2 * st + 1);
    }

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
    // a chunk below the window and the first row's limit is visible to
    // every row of the tile: its softmax skips the per-key mask
    float al_a, al_b;
    if (c0 + KC <= window && c0 + KC - 1 <= lim_tile) {
      softmax_chunk<NT, QUANT, false>(sacc, ksc, vsc, scale, c0, c4, window,
                                      lim_a, lim_b, m_a, m_b, l_a, l_b,
                                      al_a, al_b);
    } else {
      softmax_chunk<NT, QUANT, true>(sacc, ksc, vsc, scale, c0, c4, window,
                                     lim_a, lim_b, m_a, m_b, l_a, l_b, al_a,
                                     al_b);
    }
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

  // the split's partial of each row: (m, l) and the unnormalised acc
  const size_t base =
      ((static_cast<size_t>(b) * n_splits + sp) * n_kv + h) * Tm;
  if (c4 == 0) {
    if (ra < Tm) part_ml[base + ra] = make_float2(m_a, l_a);
    if (rb < Tm) part_ml[base + rb] = make_float2(m_b, l_b);
  }
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
    const int d = dt * 8 + c4 * 2;
    if (ra < Tm)
      *reinterpret_cast<float2*>(part_acc + (base + ra) * D + d) =
          make_float2(o[dt][0], o[dt][1]);
    if (rb < Tm)
      *reinterpret_cast<float2*>(part_acc + (base + rb) * D + d) =
          make_float2(o[dt][2], o[dt][3]);
  }
}

// One warp per output row (slot, token, query head): the splits 0 ..
// horizon / SPLIT of its row, combined in split order.
template <int D>
__global__ void __launch_bounds__(128)
prefill_merge_kernel(const float2* __restrict__ part_ml,
                     const float* __restrict__ part_acc,
                     const int* __restrict__ pos, float* __restrict__ out,
                     int B, int T, int H, int n_kv, int window,
                     int n_splits) {
  constexpr int VPL = D / 32;  // output elements per lane
  asm volatile("griddepcontrol.wait;\n" ::: "memory");  // the splits' end
  const int row = blockIdx.x * 4 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= B * T * H) return;
  const int head = row % H;
  const int t = (row / H) % T;
  const int b = row / (H * T);
  const int kv_mul = H / n_kv;
  const int h = head / kv_mul;
  const int Tm = T * kv_mul;
  const int r = t * kv_mul + head % kv_mul;
  const int hz = min(pos[b] + t, window - 1);
  const int ns = hz / SPLIT + 1;
  auto idx = [&](int sp) -> size_t {
    return ((static_cast<size_t>(b) * n_splits + sp) * n_kv + h) * Tm + r;
  };
  float M = NEG;
#pragma unroll 4
  for (int sp = 0; sp < ns; ++sp) {
    const float2 ml = part_ml[idx(sp)];
    if (ml.y > 0.0f) M = fmaxf(M, ml.x);
  }
  float Lsum = 0.0f;
  float A[VPL];
#pragma unroll
  for (int i = 0; i < VPL; ++i) A[i] = 0.0f;
#pragma unroll 4
  for (int sp = 0; sp < ns; ++sp) {
    const float2 ml = part_ml[idx(sp)];
    const float w = ml.y > 0.0f ? expf(ml.x - M) : 0.0f;
    Lsum = __fadd_rn(Lsum, __fmul_rn(ml.y, w));
    const float* acc = part_acc + idx(sp) * D + lane * VPL;
#pragma unroll
    for (int i = 0; i < VPL; ++i)
      A[i] = __fadd_rn(A[i], __fmul_rn(acc[i], w));
  }
  float* o = out + static_cast<size_t>(row) * D + lane * VPL;
#pragma unroll
  for (int i = 0; i < VPL; ++i) o[i] = A[i] / Lsum;
}

template <int D, int CF>
int launch(const void* q, const void* k, const void* v, const void* ks,
           const void* vs, const void* pos, void* out, void* part_ml,
           void* part_acc, int B, int T, int H, int n_kv, int S, int window,
           float scale, cudaStream_t stream) {
  constexpr int bytes = Layout<D, CF>::BYTES;
  cudaError_t e = cudaFuncSetAttribute(
      prefill_split_kernel<D, CF>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return launch_refused(e);
  const int Tm = T * (H / n_kv);
  const int n_qtiles = (Tm + QT - 1) / QT;
  const int n_splits = (window + SPLIT - 1) / SPLIT;
  const dim3 grid(n_qtiles * n_splits, n_kv, B);
  prefill_split_kernel<D, CF><<<grid, THREADS, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), k, v,
      static_cast<const float*>(ks), static_cast<const float*>(vs),
      static_cast<const int*>(pos), static_cast<float2*>(part_ml),
      static_cast<float*>(part_acc), T, H, n_kv, S, window, n_qtiles,
      n_splits, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int rows = B * T * H;
  e = ac::launch_dependent(prefill_merge_kernel<D>, dim3((rows + 3) / 4), 128,
                           0, stream, static_cast<const float2*>(part_ml),
                           static_cast<const float*>(part_acc),
                           static_cast<const int*>(pos),
                           static_cast<float*>(out), B, T, H, n_kv, window,
                           n_splits);
  if (e != cudaSuccess) return launch_refused(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q: (B, T, H, D) bf16. k, v: (B, S, n_kv, D) of type code kv_dt
// (DT_F32, DT_BF16 or DT_F16; ks, vs null), or int8 codes with ks, vs
// (B, S, n_kv) f32; the caches 16-byte aligned. pos: (B,) int32, the
// position of each slot's first token; the cache already holds the
// block's own k/v. out: (B, T, H, D) f32. part_ml: B x ceil(window / 256)
// x H x T float2 and part_acc the same count of D floats, scratch for the
// splits' partials. Key s is visible to token t of slot b iff s <= pos[b]
// + t and s < window (window <= S). Needs H % n_kv == 0 and D of 64 or
// 128.
LLAMA_EXPORT int prefill_attention(const void* q, const void* k,
                                   const void* v, const void* ks,
                                   const void* vs, const void* pos,
                                   void* out, void* part_ml, void* part_acc,
                                   int B, int T, int H, int n_kv, int D,
                                   int S, int window, float scale, int kv_dt,
                                   void* stream) {
  if (B < 1 || T < 1 || n_kv < 1 || H % n_kv != 0 || window < 1 ||
      window > S || (D != 64 && D != 128) ||
      reinterpret_cast<uintptr_t>(k) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(v) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int cf = ks != nullptr       ? CF_INT8
                 : kv_dt == DT_BF16 ? CF_BF16
                 : kv_dt == DT_F16  ? CF_F16
                 : kv_dt == DT_F32  ? CF_F32
                                    : -1;
  if (cf < 0) return static_cast<int>(cudaErrorInvalidValue);
#define LAUNCH(DD, CC)                                                   \
  launch<DD, CC>(q, k, v, ks, vs, pos, out, part_ml, part_acc, B, T, H, \
                 n_kv, S, window, scale, st)
  switch (D == 64 ? cf : 4 + cf) {
    case CF_BF16: return LAUNCH(64, CF_BF16);
    case CF_INT8: return LAUNCH(64, CF_INT8);
    case CF_F16: return LAUNCH(64, CF_F16);
    case CF_F32: return LAUNCH(64, CF_F32);
    case 4 + CF_BF16: return LAUNCH(128, CF_BF16);
    case 4 + CF_INT8: return LAUNCH(128, CF_INT8);
    case 4 + CF_F16: return LAUNCH(128, CF_F16);
    case 4 + CF_F32: return LAUNCH(128, CF_F32);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef LAUNCH
}
