// Device code of the w4-g128 GEMV, shared by int4_gemv.cu, down_qkv.cu and
// int4_chain.cu.
//
// Both sources compute a column's dot product, a staged row and an rms
// scale with these functions, so the chained down->qkv kernel sums in the
// same order as the standalone GEMV and rms_scale launches it replaces and
// its outputs are bit-equal to theirs (see int4_gemv.cu's header for the
// design: one warp per output column, x staged once per pass as bf16 in
// shared memory with the prologue applied).
#pragma once

#include "common.cuh"

namespace w4gemv {

constexpr int WARPS = 16;        // one warp per output column
constexpr int MAX_ROWS = 8;      // rows of x per pass (accumulators in registers)
constexpr int RMS_THREADS = 256; // the rms reduction's thread count

// bf16 activation load. FROM_L2 reads through L2 only (ld.global.cg), for
// data the same kernel wrote before a grid barrier: the non-coherent
// read-only path must not serve it.
template <bool FROM_L2>
__device__ __forceinline__ float load_act(const __nv_bfloat16* p) {
  if (FROM_L2) return __bfloat162float(__ldcg(p));
  return __bfloat162float(*p);
}

// Stage rows r0..r0+mr-1 of the effective x into xs (xs_index layout, rows
// of (n_in / 32) * 34 elements), rounded to bf16. MODE 0: x as given;
// 1: x * ss[r] * nw[k], ss indexed by the pass-local row r (rmsnorm apply);
// 2: silu(x) * u (SwiGLU). Every thread of the block takes part.
template <int MODE, bool FROM_L2>
__device__ __forceinline__ void stage_rows(
    __nv_bfloat16* xs, const __nv_bfloat16* x, int ldx,
    const __nv_bfloat16* u, int ldu, const float* ss, const float* nw,
    int r0, int mr, int n_in) {
  const int row_elems = (n_in >> 5) * 34;
  for (int i = threadIdx.x; i < mr * n_in; i += blockDim.x) {
    const int r = i / n_in;
    const int k = i - r * n_in;
    float v = load_act<FROM_L2>(x + (size_t)(r0 + r) * ldx + k);
    if (MODE == 1) {
      v = v * ss[r] * nw[k];
    } else if (MODE == 2) {
      const float sig = 1.0f / (1.0f + expf(-v));
      v = v * sig * load_act<FROM_L2>(u + (size_t)(r0 + r) * ldu + k);
    }
    xs[r * row_elems + xs_index(k)] = __float2bfloat16_rn(v);
  }
}

// This lane's share of output column col for the mr staged rows: lane l
// takes the 16-byte weight vectors l, l + 32, ... (32 nibbles each, one
// 128-row group per 4 vectors), dequantizes (q - z) * s in f32 and
// accumulates x * w with fmaf in row order. warp_sum completes the dot.
__device__ __forceinline__ void column_partials(
    float (&acc)[MAX_ROWS], const __nv_bfloat16* xs, int row_elems,
    const uint4* __restrict__ qw, const __half* __restrict__ scales,
    const uint8_t* __restrict__ zeros, int col, int nvec, int groups,
    int mr, int lane) {
#pragma unroll
  for (int r = 0; r < MAX_ROWS; ++r) acc[r] = 0.0f;
  const uint4* wcol = qw + (size_t)col * nvec;
  const __half* scol = scales + (size_t)col * groups;
  const uint8_t* zcol = zeros + (size_t)col * groups;
  for (int v = lane; v < nvec; v += 32) {
    const uint4 w4 = __ldg(wcol + v);
    const int g = v >> 2;  // 32 rows per vector, 128 rows per group
    const float s = __half2float(scol[g]);
    const float z = static_cast<float>(zcol[g]);
    const uint32_t words[4] = {w4.x, w4.y, w4.z, w4.w};
    float w[32];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float q = static_cast<float>((words[j] >> (4 * i)) & 0xFu);
        w[j * 8 + i] = (q - z) * s;
      }
    }
#pragma unroll
    for (int r = 0; r < MAX_ROWS; ++r) {
      if (r < mr) {
        const __nv_bfloat162* xr = reinterpret_cast<const __nv_bfloat162*>(
            xs + r * row_elems + v * 34);
        float a = acc[r];
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const float2 xf = __bfloat1622float2(xr[i]);
          a = fmaf(xf.x, w[2 * i], a);
          a = fmaf(xf.y, w[2 * i + 1], a);
        }
        acc[r] = a;
      }
    }
  }
}

// Finish column col for rows r0..r0+mr-1: the warp's sum, plus the bf16
// residual when res is given (read through L2 with RES_L2, see load_act),
// stored as bf16 or f32 by lane 0.
template <bool RES_L2 = false>
__device__ __forceinline__ void store_column(
    float (&acc)[MAX_ROWS], int mr, int lane, int r0, int col, int n_out,
    const __nv_bfloat16* __restrict__ res, void* out, int out_bf16) {
#pragma unroll
  for (int r = 0; r < MAX_ROWS; ++r) {
    if (r < mr) {
      const float total = warp_sum(acc[r]);
      if (lane == 0) {
        const size_t o = (size_t)(r0 + r) * n_out + col;
        float val = total;
        if (res != nullptr) val += load_act<RES_L2>(res + o);
        if (out_bf16) {
          reinterpret_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16_rn(val);
        } else {
          reinterpret_cast<float*>(out)[o] = val;
        }
      }
    }
  }
}

// 1 / sqrt(mean(row^2) + eps) over the n values of row (bf16 or f32), in
// the order of a 256-thread block: thread t sums elements t, t + 256, ...
// with fmaf, 8 warp sums, then one warp sums those. Every thread of a block
// of at least 256 threads calls it; the result is valid in thread 0. part:
// 8 floats of shared memory, free again when it returns.
template <bool FROM_L2>
__device__ __forceinline__ float rms_scale_row(const void* row, int is_bf16,
                                               int n, float eps,
                                               float* part) {
  float acc = 0.0f;
  if (threadIdx.x < RMS_THREADS) {
    for (int i = threadIdx.x; i < n; i += RMS_THREADS) {
      const float v =
          is_bf16
              ? load_act<FROM_L2>(
                    reinterpret_cast<const __nv_bfloat16*>(row) + i)
              : reinterpret_cast<const float*>(row)[i];
      acc = fmaf(v, v, acc);
    }
  }
  acc = warp_sum(acc);
  if ((threadIdx.x & 31) == 0 && threadIdx.x < RMS_THREADS)
    part[threadIdx.x >> 5] = acc;
  __syncthreads();
  float ss = 0.0f;
  if (threadIdx.x < 32) {
    float t = threadIdx.x < (RMS_THREADS >> 5) ? part[threadIdx.x] : 0.0f;
    t = warp_sum(t);
    ss = 1.0f / sqrtf(t / static_cast<float>(n) + eps);
  }
  __syncthreads();
  return ss;
}

// shared-memory bytes of `rows` staged rows of n_in inputs
inline size_t staged_bytes(int rows, int n_in) {
  return (size_t)rows * (n_in / 32) * 34 * sizeof(__nv_bfloat16);
}

}  // namespace w4gemv
