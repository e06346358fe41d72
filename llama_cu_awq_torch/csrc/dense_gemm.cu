// Dense GEMM on the tensor cores for the lm_head over a block of rows:
// out[m, v] = sum_d x[m, d] * w[v, d], f32, at every m
// (ops/cuda/dense_gemv.py). It also serves decode's one row: on the H100
// it was faster than a warp-per-row GEMV at every m from 1 to 128.
//
// Replaces: llama_cu_awq_tpu/ops/pallas/dense_gemv.py, _gemv_2d
//   (dense_gemv), the bf16 kernel and the int8-row kernel (_kernel_int8,
//   the row scale on the accumulated sum), which does one MXU dot per
//   vocab tile over all m rows.
//
// What bounds it on the H100: the head's bytes, read once per block of
//   rows. At 7B and m = 128 the bf16 head is 262 MB, x 1 MB and the f32
//   out 16.4 MB: 83.5 us at 3.35 TB/s, against 33.5 GFLOP, 33.9 us at
//   989 TFLOP/s. The warp-per-row GEMV it replaces read the head once per
//   8 rows of x (16 times at m = 128) at scalar-FMA speed.
//
// What the design does about it:
//   - "Swap AB": the vocab rows are the MMA's M and the rows of x its N,
//     so a skinny m is the narrow side: out^T[v, m] = w[v, :] . x[m, :].
//     Both operands are K-major as they lie in memory (w row-major, x
//     row-major is the "col" B operand of mma .row.col).
//   - A block owns BV = 128 vocab rows and BN = 16, 32, 64 or 128 rows of
//     x (the smallest that covers m; m > 128 takes further column tiles,
//     each rereading the head). 8 warps: 4 along the vocab rows (32 each,
//     two m16 tiles) x 2 along x's rows (BN / 2 each). At 7B that is 250
//     blocks, two resident per SM: one wave on 132 SMs.
//   - The K loop streams BK = 64 deep tiles of w and x through a ring of
//     STAGES = 3 in shared memory with cp.async (16-byte copies, zero
//     filled past the vocab, past m and past d, so ragged edges need no
//     other masking than the stores), two tiles in flight while the third
//     multiplies.
//   - mma.sync m16n8k16, bf16 operands, f32 accumulation in registers;
//     fragments come from shared memory with ldmatrix (rows padded to
//     144 bytes: conflict-free). The int8 head's codes are widened to
//     bf16 exactly (|code| <= 127) in registers as the A fragment is read:
//     the code + 128 in the low byte of 2^23 as f32, minus 2^23 + 128,
//     whose upper 16 bits are its bf16. Products stay exact; only the f32
//     sum order differs from the plain version's.
//   - The epilogue multiplies by the int8 row scale and writes f32.
//   - mma.sync with a cp.async ring is the first step: no wgmma and no
//     TMA yet (later work); no split of K across blocks. Taller warp tiles
//     (four m16 tiles, 256-row blocks) and a fourth stage measured no
//     better on the H100.

#include "common.cuh"

namespace {

constexpr int BK = 64;          // K depth of a stage
constexpr int STAGES = 3;       // the cp.async ring
constexpr int MT = 2;           // m16 tiles of vocab rows a warp
constexpr int WARPS_V = 4;      // warps along the vocab rows
constexpr int WARPS_N = 2;      // warps along the rows of x
constexpr int BV = WARPS_V * 16 * MT;
constexpr int THREADS = WARPS_V * WARPS_N * 32;
constexpr int MIN_BLOCKS = 2;   // resident blocks an SM (registers)
constexpr int LDB = BK + 8;     // padded bf16 row of a staged tile (144 B)
constexpr int LDW8 = BK + 16;   // padded int8 row of a staged tile (80 B)

template <bool INT8>
__host__ __device__ constexpr int w_stage_bytes() {
  return BV * (INT8 ? LDW8 : LDB * 2);
}
template <int NT>  // BN = 16 * NT rows of x
__host__ __device__ constexpr int x_stage_bytes() {
  return 16 * NT * LDB * 2;
}
template <bool INT8, int NT>
__host__ __device__ constexpr size_t smem_bytes() {
  return static_cast<size_t>(STAGES) * (w_stage_bytes<INT8>() +
                                        x_stage_bytes<NT>());
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, or 16 zero bytes when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}
__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p))
               : "memory");
}

// The two int8 codes in the low 16 bits of u (lower index in the low
// byte) as two bf16, exactly: code ^ 0x80 = code + 128 as a byte; 2^23 +
// that byte as f32 minus (2^23 + 128) is the code, whose f32 has at most
// 8 significant bits, so its upper 16 bits are its bf16.
__device__ __forceinline__ uint32_t int8x2_to_bf16x2(uint32_t u) {
  const uint32_t b = u ^ 0x8080u;
  const float lo = __uint_as_float(__byte_perm(b, 0x4B000000u, 0x7440)) -
                   8388736.0f;
  const float hi = __uint_as_float(__byte_perm(b, 0x4B000000u, 0x7441)) -
                   8388736.0f;
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// block (vocab tile, column tile of x's rows); NT n8 tiles per warp
template <bool INT8, int NT>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
dense_gemm_kernel(const __nv_bfloat16* __restrict__ x, int ldx,
                  const void* __restrict__ w,
                  const float* __restrict__ scale, float* __restrict__ out,
                  int m, int d, int v_rows) {
  constexpr int BN = 16 * NT;
  constexpr int WN = 8 * NT;  // x rows of a warp
  constexpr int W_BYTES = w_stage_bytes<INT8>();
  constexpr int X_BYTES = x_stage_bytes<NT>();
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g8 = lane >> 2;
  const int c4 = lane & 3;
  const int wv = warp / WARPS_N;
  const int wn = warp % WARPS_N;
  const int v0 = blockIdx.x * BV;
  const int n0 = blockIdx.y * BN;
  const int k_tiles = (d + BK - 1) / BK;
  // warp-uniform: a warp whose rows of x all lie past m only loads
  const bool active = n0 + wn * WN < m;

  auto w_stage = [&](int s) { return smem + s * (W_BYTES + X_BYTES); };
  auto x_stage = [&](int s) {
    return reinterpret_cast<__nv_bfloat16*>(w_stage(s) + W_BYTES);
  };

  // one stage's copies: BV rows of w and BN rows of x, BK deep
  auto load = [&](int s, int kt) {
    const int k0 = kt * BK;
    unsigned char* ws = w_stage(s);
    if constexpr (INT8) {
      for (int i = tid; i < BV * (BK / 16); i += THREADS) {
        const int r = i / (BK / 16);
        const int ch = i % (BK / 16);
        const int k = k0 + ch * 16;
        const bool ok = v0 + r < v_rows && k < d;
        const int8_t* src = static_cast<const int8_t*>(w) +
                            (ok ? (size_t)(v0 + r) * d + k : 0);
        cp_async16(ws + r * LDW8 + ch * 16, src, ok);
      }
    } else {
      __nv_bfloat16* wb = reinterpret_cast<__nv_bfloat16*>(ws);
      for (int i = tid; i < BV * (BK / 8); i += THREADS) {
        const int r = i / (BK / 8);
        const int ch = i % (BK / 8);
        const int k = k0 + ch * 8;
        const bool ok = v0 + r < v_rows && k < d;
        const __nv_bfloat16* src = static_cast<const __nv_bfloat16*>(w) +
                                   (ok ? (size_t)(v0 + r) * d + k : 0);
        cp_async16(wb + r * LDB + ch * 8, src, ok);
      }
    }
    __nv_bfloat16* xs = x_stage(s);
    for (int i = tid; i < BN * (BK / 8); i += THREADS) {
      const int r = i / (BK / 8);
      const int ch = i % (BK / 8);
      const int k = k0 + ch * 8;
      const bool ok = n0 + r < m && k < d;
      const __nv_bfloat16* src = x + (ok ? (size_t)(n0 + r) * ldx + k : 0);
      cp_async16(xs + r * LDB + ch * 8, src, ok);
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.0f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < k_tiles) load(s, s);
    cp_async_commit();
  }

  for (int kt = 0; kt < k_tiles; ++kt) {
    cp_async_wait<STAGES - 2>();  // stage kt has landed (this thread's)
    __syncthreads();              // ... every thread's; kt - 1 is free
    const int next = kt + STAGES - 1;
    if (next < k_tiles) load(next % STAGES, next);
    cp_async_commit();  // an empty group past the end keeps the count

    const int s = kt % STAGES;
    const unsigned char* ws = w_stage(s);
    const __nv_bfloat16* xs = x_stage(s);
    if (active) {
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t a[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const int r = wv * 16 * MT + mt * 16;
          if constexpr (INT8) {
            // a[0] = A[g][2c..], a[1] = A[g+8][2c..], a[2] = A[g][2c+8..],
            // a[3] = A[g+8][2c+8..] (common.cuh), two codes a register
            const unsigned char* p = ws + (r + g8) * LDW8 + kk * 16 + 2 * c4;
            a[mt][0] = int8x2_to_bf16x2(*reinterpret_cast<const uint16_t*>(p));
            a[mt][1] = int8x2_to_bf16x2(
                *reinterpret_cast<const uint16_t*>(p + 8 * LDW8));
            a[mt][2] = int8x2_to_bf16x2(
                *reinterpret_cast<const uint16_t*>(p + 8));
            a[mt][3] = int8x2_to_bf16x2(
                *reinterpret_cast<const uint16_t*>(p + 8 * LDW8 + 8));
          } else {
            // lanes 0-15 address rows r..r+15 at k, lanes 16-31 at k + 8
            const __nv_bfloat16* wb =
                reinterpret_cast<const __nv_bfloat16*>(ws);
            ldmatrix_x4(a[mt], wb + (r + (lane & 15)) * LDB + kk * 16 +
                                   (lane >> 4) * 8);
          }
        }
        // B = x^T: b[0] = x[n][2c..], b[1] = x[n][2c+8..], n = g; x4
        // covers two n8 tiles (lanes 16-31 address the second)
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t b[4];
          ldmatrix_x4(b, xs + (wn * WN + np * 16 + (lane & 7) +
                               (lane >> 4) * 8) * LDB +
                             kk * 16 + ((lane >> 3) & 1) * 8);
          const uint32_t b0[2] = {b[0], b[1]};
          const uint32_t b1[2] = {b[2], b[3]};
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_bf16_16x8x16(acc[mt][2 * np], a[mt], b0);
            mma_bf16_16x8x16(acc[mt][2 * np + 1], a[mt], b1);
          }
        }
        if constexpr (NT % 2 == 1) {
          uint32_t b[2];
          ldmatrix_x2(b, xs + (wn * WN + (NT - 1) * 8 + (lane & 7)) * LDB +
                             kk * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
            mma_bf16_16x8x16(acc[mt][NT - 1], a[mt], b);
        }
      }
    }
  }
  cp_async_wait<0>();

  // d[0..1] = D[g][2c..2c+1], d[2..3] = D[g+8][2c..]: D's rows are vocab
  // rows, its columns rows of x
  if (!active) return;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int vr = v0 + wv * 16 * MT + mt * 16 + g8 + hi * 8;
      if (vr >= v_rows) continue;
      const float sc = INT8 ? scale[vr] : 1.0f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int n = n0 + wn * WN + nt * 8 + 2 * c4 + j;
          if (n >= m) continue;
          float val = acc[mt][nt][hi * 2 + j];
          if constexpr (INT8) val *= sc;
          out[(size_t)n * v_rows + vr] = val;
        }
    }
}

template <bool INT8, int NT>
int launch(const void* x, int ldx, const void* w, const void* scale,
           void* out, int m, int d, int v_rows, int grid_v, int grid_n,
           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<INT8, NT>();
  cudaError_t e = cudaFuncSetAttribute(
      dense_gemm_kernel<INT8, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return launch_refused(e);
  dense_gemm_kernel<INT8, NT><<<dim3(grid_v, grid_n), THREADS, smem,
                                stream>>>(
      static_cast<const __nv_bfloat16*>(x), ldx, w,
      static_cast<const float*>(scale), static_cast<float*>(out), m, d,
      v_rows);
  return static_cast<int>(cudaGetLastError());
}

template <bool INT8>
int launch_n(int n_tile, const void* x, int ldx, const void* w,
             const void* scale, void* out, int m, int d, int v_rows,
             int grid_v, int grid_n, cudaStream_t st) {
  switch (n_tile) {
    case 16:
      return launch<INT8, 1>(x, ldx, w, scale, out, m, d, v_rows, grid_v,
                             grid_n, st);
    case 32:
      return launch<INT8, 2>(x, ldx, w, scale, out, m, d, v_rows, grid_v,
                             grid_n, st);
    case 64:
      return launch<INT8, 4>(x, ldx, w, scale, out, m, d, v_rows, grid_v,
                             grid_n, st);
    default:
      return launch<INT8, 8>(x, ldx, w, scale, out, m, d, v_rows, grid_v,
                             grid_n, st);
  }
}

}  // namespace

// x: (m, d) bf16, row stride ldx (a multiple of 8), 16-byte aligned; w:
// (v_rows, d) bf16, or int8 codes when scale ((v_rows,) f32) is given,
// 16-byte aligned; out: (m, v_rows) f32. Needs d % 16 == 0. n_tile: the
// rows of x a block takes (16, 32, 64 or 128; ops/cuda/dense_gemv.py
// gemm_n_tile), grid_v = ceil(v_rows / 128) vocab tiles and grid_n =
// ceil(m / n_tile) column tiles (gemm_grid): the launch checks both.
LLAMA_EXPORT int dense_gemm(const void* x, int ldx, const void* w,
                            const void* scale, void* out, int m, int d,
                            int v_rows, int n_tile, int grid_v, int grid_n,
                            void* stream) {
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       ldx % 8 == 0 && ldx >= d &&
                       reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const bool tile_ok = n_tile == 16 || n_tile == 32 || n_tile == 64 ||
                       n_tile == 128;
  if (m < 1 || d < 16 || d % 16 != 0 || v_rows < 1 || !aligned ||
      !tile_ok || grid_v != (v_rows + BV - 1) / BV ||
      grid_n != (m + n_tile - 1) / n_tile || grid_n > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (scale != nullptr)
    return launch_n<true>(n_tile, x, ldx, w, scale, out, m, d, v_rows, grid_v,
                          grid_n, st);
  return launch_n<false>(n_tile, x, ldx, w, scale, out, m, d, v_rows, grid_v,
                         grid_n, st);
}
