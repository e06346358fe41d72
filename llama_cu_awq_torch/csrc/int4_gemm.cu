// w4-g128 GEMM on the tensor cores for blocks of rows (block prefill,
// perplexity), with the GEMV's prologue and epilogue options.
//
// Replaces: llama_cu_awq_tpu/ops/pallas/int4_matmul.py for m >= GEMM_MIN_M
//   (ops/cuda/int4_matmul.py): _int4_matmul_2d in its douter form, which
//   qkv and gate_up take at m = 128 through the unfused composite, and
//   _int4_matmul_fused_2d, which o and down take at m = 128.
//
// What bounds it on the H100: at m = 128, the operations. qkv at 7B does
//   2 x 128 x 4096 x 12288 = 12.9 GFLOP (13.0 us at 989 TFLOP/s bf16)
//   against 26.4 MB of codes, scales and zeros (7.9 us at 3.35 TB/s).
//
// What the design does about it:
//   - mma.sync m16n8k16, bf16 operands, f32 accumulation. A block holds a
//     128-row M tile (a whole prefill block, so each weight byte is read
//     once per block of tokens) and 64 output columns; 8 warps of 32 x 32.
//   - The K loop takes one 128-row quantization group per step and keeps
//     the TPU kernel's formulation (int4_matmul.py _accumulate_glue):
//     part = x_eff . q on the raw nibble codes (0..15, exact in bf16),
//     sx = sum(x_eff) over the group, acc += (part - sx * z) * s in f32.
//     The weight is never rounded: dequantizing (q - z) * s to bf16 before
//     the MMA would round it, and the plain version dequantizes exactly.
//   - x_eff is made once per staged K tile: bf16(x * ss * norm_w)
//     (rmsnorm apply) or bf16(silu(g) * u) (SwiGLU), the GEMV's staging.
//   - The codes keep the checkpoint layout, qw (n_out, n_in/8) int32 with
//     nibble i of word y = input row 8y + i (csrc/int4_gemv.cu): one output
//     column's K is contiguous, the "col" operand of mma .row.col. They are
//     widened to bf16 in shared memory, column-major, K contiguous.
//   - The epilogue adds the residual in f32 and casts; the rms scale of
//     the output is int4_gemv.cu's second launch (rms_scale).
//   - A thread loads the next K step's x, codes, scales and zeros into
//     registers while the current step multiplies (one step of register
//     prefetch); no cp.async or TMA pipelining and no wgmma yet. That is
//     later work.

#include "common.cuh"

namespace {

constexpr int BM = 128;      // rows of x per block
constexpr int BN = 64;       // output columns per block
constexpr int BK = 128;      // one quantization group per K step
constexpr int WARPS_N = 2;   // 4 warps along M x 2 along N, each 32 x 32
constexpr int THREADS = 256;
constexpr int XV = BM * (BK / 8) / THREADS;  // x vectors staged per thread
constexpr int LDS = BK + 8;  // padded shared row: conflict-free fragments
constexpr size_t SMEM_BYTES =
    static_cast<size_t>(BM + BN) * LDS * sizeof(__nv_bfloat16) +
    static_cast<size_t>(BM + 2 * BN) * sizeof(float);

// MODE 0: x as given; 1: x*ss*norm_w; 2: silu(x)*u. MODE 1 (qkv and
// gate_up at 7B, 192 and 344 column blocks) is held to two blocks per SM,
// which costs it a few spilled registers and measured faster on the H100;
// MODE 0 and 2 keep every register (the SwiGLU prologue holds x and u)
template <int MODE>
__global__ void __launch_bounds__(THREADS, MODE == 1 ? 2 : 1)
int4_gemm_kernel(const __nv_bfloat16* __restrict__ x, int ldx,
                 const __nv_bfloat16* __restrict__ u, int ldu,
                 const float* __restrict__ ss,
                 const float* __restrict__ nw,
                 const uint4* __restrict__ qw,
                 const __half* __restrict__ scales,
                 const uint8_t* __restrict__ zeros,
                 const __nv_bfloat16* __restrict__ res,
                 void* __restrict__ out, int out_bf16,
                 int m, int n_in, int n_out, int groups) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);  // BM x LDS
  __nv_bfloat16* ws = xs + BM * LDS;                            // BN x LDS
  float* sx = reinterpret_cast<float*>(ws + BN * LDS);          // BM
  float* sc = sx + BM;                                          // BN
  float* zc = sc + BN;                                          // BN

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g8 = lane >> 2;  // fragment row / column group
  const int c4 = lane & 3;   // fragment pair index
  const int wm = warp / WARPS_N;
  const int wn = warp % WARPS_N;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  const int mrows = min(BM, m - row0);
  const int nvec = n_in >> 5;  // 16-byte vectors (32 codes) per column

  float acc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.0f;

  // A thread's share of one K step's global reads, held in registers:
  // XV vectors of x (and of u), one vector of codes (column tid / 4,
  // vector tid % 4) and, for tid < BN, its column's scale and zero. The
  // next step's share is loaded while this step multiplies.
  uint4 xr[XV], ur[XV], w4;
  float4 nw_lo, nw_hi;  // MODE 1: norm_w of this thread's 8 columns
  float s_next = 0.0f, z_next = 0.0f;
  const int wcol = tid >> 2;
  const int wq4 = tid & 3;
  // MODE 1: the rms scale of each of this thread's XV rows (the rows do
  // not change from one K step to the next)
  float ss_r[XV];
#pragma unroll
  for (int it = 0; it < XV; ++it) {
    const int r = (it * THREADS + tid) >> 4;
    ss_r[it] = (MODE == 1 && r < mrows) ? ss[row0 + r] : 0.0f;
  }
  auto load_step = [&](int g) {
    const int k0 = g * BK;
    if (MODE == 1) {
      const int k = k0 + (tid & 15) * 8;
      nw_lo = nw_hi = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (k < n_in) {
        nw_lo = *reinterpret_cast<const float4*>(nw + k);
        nw_hi = *reinterpret_cast<const float4*>(nw + k + 4);
      }
    }
#pragma unroll
    for (int it = 0; it < XV; ++it) {
      const int i = it * THREADS + tid;
      const int r = i >> 4;
      const int k = k0 + (i & 15) * 8;
      xr[it] = ur[it] = make_uint4(0u, 0u, 0u, 0u);
      if (r < mrows && k < n_in) {
        xr[it] = *reinterpret_cast<const uint4*>(
            x + static_cast<size_t>(row0 + r) * ldx + k);
        if (MODE == 2)
          ur[it] = *reinterpret_cast<const uint4*>(
              u + static_cast<size_t>(row0 + r) * ldu + k);
      }
    }
    w4 = make_uint4(0u, 0u, 0u, 0u);
    if (col0 + wcol < n_out && g * 4 + wq4 < nvec)
      w4 = __ldg(qw + static_cast<size_t>(col0 + wcol) * nvec + g * 4 + wq4);
    if (tid < BN && col0 + tid < n_out) {
      const size_t gi = static_cast<size_t>(col0 + tid) * groups + g;
      s_next = __half2float(scales[gi]);
      z_next = static_cast<float>(zeros[gi]);
    }
  };
  load_step(0);

  for (int g = 0; g < groups; ++g) {
    __syncthreads();  // the previous step has finished reading xs and ws

    // x_eff: BM rows x 16 vectors of 8; the 16 lanes of a half warp hold
    // one row, so the group's row sum sx is a half-warp reduction
#pragma unroll
    for (int it = 0; it < XV; ++it) {
      const int i = it * THREADS + tid;
      const int r = i >> 4;
      const int c = i & 15;
      const __nv_bfloat16* xv = reinterpret_cast<const __nv_bfloat16*>(&xr[it]);
      const __nv_bfloat16* uv = reinterpret_cast<const __nv_bfloat16*>(&ur[it]);
      const float nwv[8] = {nw_lo.x, nw_lo.y, nw_lo.z, nw_lo.w,
                            nw_hi.x, nw_hi.y, nw_hi.z, nw_hi.w};
      float v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        v[j] = __bfloat162float(xv[j]);
        if (MODE == 1) {
          v[j] = v[j] * ss_r[it] * nwv[j];
        } else if (MODE == 2) {
          // the hardware exp and divide: the SwiGLU prologue is the
          // down projection's largest cost, redone by every column block
          const float sig = __fdividef(1.0f, 1.0f + __expf(-v[j]));
          v[j] = v[j] * sig * __bfloat162float(uv[j]);
        }
      }
      uint4 packed;
      uint32_t* pw = reinterpret_cast<uint32_t*>(&packed);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        pw[j] = pack_bf16(v[2 * j], v[2 * j + 1]);
        const float2 f = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&pw[j]));
        sum += f.x + f.y;
      }
      *reinterpret_cast<uint4*>(xs + r * LDS + c * 8) = packed;
      sum += __shfl_xor_sync(0xffffffffu, sum, 8);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      if (c == 0) sx[r] = sum;
    }

    // codes: BN columns x 4 vectors of 32 nibbles, widened to bf16
    {
      const uint32_t words[4] = {w4.x, w4.y, w4.z, w4.w};
      __nv_bfloat16* dst = ws + wcol * LDS + wq4 * 32;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint4 o;
        uint32_t* ow = reinterpret_cast<uint32_t*>(&o);
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          ow[p] = pack_bf16(static_cast<float>((words[j] >> (8 * p)) & 0xFu),
                            static_cast<float>((words[j] >> (8 * p + 4)) & 0xFu));
        }
        *reinterpret_cast<uint4*>(dst + j * 8) = o;
      }
      if (tid < BN) {
        sc[tid] = s_next;
        zc[tid] = z_next;
      }
    }
    __syncthreads();
    if (g + 1 < groups) load_step(g + 1);

    float part[2][4][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) part[mt][nt][i] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t b[4][2];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const __nv_bfloat16* wp =
            ws + (wn * 32 + nt * 8 + g8) * LDS + kk * 16 + c4 * 2;
        b[nt][0] = *reinterpret_cast<const uint32_t*>(wp);
        b[nt][1] = *reinterpret_cast<const uint32_t*>(wp + 8);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        if (wm * 32 + mt * 16 >= mrows) continue;  // warp-uniform
        const __nv_bfloat16* xp =
            xs + (wm * 32 + mt * 16 + g8) * LDS + kk * 16 + c4 * 2;
        const uint32_t a[4] = {
            *reinterpret_cast<const uint32_t*>(xp),
            *reinterpret_cast<const uint32_t*>(xp + 8 * LDS),
            *reinterpret_cast<const uint32_t*>(xp + 8),
            *reinterpret_cast<const uint32_t*>(xp + 8 * LDS + 8)};
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_bf16_16x8x16(part[mt][nt], a, b[nt]);
      }
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = wm * 32 + mt * 16 + g8 + (i >> 1) * 8;
          const int c = wn * 32 + nt * 8 + c4 * 2 + (i & 1);
          acc[mt][nt][i] += (part[mt][nt][i] - sx[r] * zc[c]) * sc[c];
        }
  }

#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = row0 + wm * 32 + mt * 16 + g8 + (i >> 1) * 8;
        const int c = col0 + wn * 32 + nt * 8 + c4 * 2 + (i & 1);
        if (r >= m || c >= n_out) continue;
        const size_t o = static_cast<size_t>(r) * n_out + c;
        float val = acc[mt][nt][i];
        if (res != nullptr) val += __bfloat162float(res[o]);
        if (out_bf16) {
          reinterpret_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16_rn(val);
        } else {
          reinterpret_cast<float*>(out)[o] = val;
        }
      }
}

template <int MODE>
int launch_gemm(const void* x, int ldx, const void* u, int ldu,
                const void* ss, const void* nw, const void* qw,
                const void* scales, const void* zeros, const void* res,
                void* out, int out_bf16, int m, int n_in, int n_out,
                int groups, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      int4_gemm_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(SMEM_BYTES));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((n_out + BN - 1) / BN, (m + BM - 1) / BM);
  int4_gemm_kernel<MODE><<<grid, THREADS, SMEM_BYTES, stream>>>(
      static_cast<const __nv_bfloat16*>(x), ldx,
      static_cast<const __nv_bfloat16*>(u), ldu,
      static_cast<const float*>(ss), static_cast<const float*>(nw),
      static_cast<const uint4*>(qw), static_cast<const __half*>(scales),
      static_cast<const uint8_t*>(zeros),
      static_cast<const __nv_bfloat16*>(res), out, out_bf16, m, n_in, n_out,
      groups);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The int4_gemv interface without rows_per_pass. x: (m, n_in) bf16, row
// stride ldx; u: SwiGLU up values (m, n_in) bf16, row stride ldu, or null;
// ss: (m,) f32 and nw: (n_in,) f32 for the rmsnorm-apply prologue, or
// null. qw: (n_out, n_in/8) int32; scales: (n_out, groups) fp16; zeros:
// (n_out, groups) uint8. res: (m, n_out) bf16 or null. out: (m, n_out),
// bf16 when out_bf16 else f32. Needs n_in % 32 == 0, groups =
// ceil(n_in / 128), x, u and nw 16-byte aligned, row strides % 8 == 0.
LLAMA_EXPORT int int4_gemm(const void* x, int ldx, const void* u, int ldu,
                           const void* ss, const void* nw, const void* qw,
                           const void* scales, const void* zeros,
                           const void* res, void* out, int out_bf16, int m,
                           int n_in, int n_out, int groups, void* stream) {
  const bool aligned =
      reinterpret_cast<uintptr_t>(x) % 16 == 0 && ldx % 8 == 0 &&
      (u == nullptr || (reinterpret_cast<uintptr_t>(u) % 16 == 0 &&
                        ldu % 8 == 0)) &&
      (ss == nullptr || reinterpret_cast<uintptr_t>(nw) % 16 == 0);
  if (n_in % 32 != 0 || groups != (n_in + BK - 1) / BK || m < 1 || !aligned)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (u != nullptr)
    return launch_gemm<2>(x, ldx, u, ldu, ss, nw, qw, scales, zeros, res,
                          out, out_bf16, m, n_in, n_out, groups, st);
  if (ss != nullptr)
    return launch_gemm<1>(x, ldx, u, ldu, ss, nw, qw, scales, zeros, res,
                          out, out_bf16, m, n_in, n_out, groups, st);
  return launch_gemm<0>(x, ldx, u, ldu, ss, nw, qw, scales, zeros, res, out,
                        out_bf16, m, n_in, n_out, groups, st);
}
