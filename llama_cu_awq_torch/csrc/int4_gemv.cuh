// Device code of the w4-g128 matmul for 1 to MAX_ROWS rows of x: the
// tensor-core column tile that int4_gemv.cu, down_qkv.cu and int4_chain.cu
// all compute every output column with.
//
// The tile (tile_pass) is mma.sync m16n8k16 with A and B swapped: the MMA's
// M is 16 weight columns (output features), its N the pass's rows of x (at
// most 8, the instruction's n8), its K the input rows. Per 128-row
// quantization group g it keeps the arithmetic of int4_gemm.cu and of the
// TPU kernel (int4_matmul.py _accumulate_glue):
//   part = x_eff . q        on the raw codes (0..15, exact in bf16; every
//                           product is exact in f32)
//   sx   = sum(x_eff)       over the group, from the staged bf16 rows
//   acc += (part - sx * z) * s   in f32
// The weight is never rounded: (q - z) * s is not formed in bf16.
//
// The codes keep the checkpoint layout, qw (n_out, n_in/8) int32, nibble i
// of word y = input row 8y + i. Lane (g, t) of a warp (g = lane/4, t =
// lane%4) loads 16-byte vector t of its columns' group (words 4t..4t+3,
// rows 32t..32t+31), for columns g and g+8 of the tile; a quad holds the
// whole group. The MMA's K order within a group is a permutation of the
// rows chosen so that each lane's fragments come from its own vector with
// no shuffle: at k-step (word j, half h) the lane's A pairs are nibbles
// (2h, 2h+4) and (2h+1, 2h+5) of word j, widened with ((w >> 8h) &
// 0x000F000F) | 0x43004300 (bf16 128 + q, the trick of int4_matmul.py:41)
// minus 128, exactly. The staged x is stored in the same permuted order
// (stage_rows: within every 8 inputs, 0 4 1 5 2 6 3 7), so the lane's B
// pairs for those rows are one 16-byte shared load per word, at a fixed
// offset from the lane's chunk (xs_chunk).
//
// Row independence: row r of the output depends only on row r of x and
// the weights (D[i][j] of an MMA reads only A's row i and B's column j),
// and the order of every sum depends on n_in alone: the WARPS warps of a
// block split one tile's K by group, warp w taking groups [w*G/WARPS,
// (w+1)*G/WARPS); each scales its partial tile per group, and the block
// sums the WARPS partial tiles in shared memory in warp order. Neither
// gridDim, the occupancy, m, the rows per pass nor the pass enters it, so
// the standalone GEMV (any grid), down_qkv and the persistent chains give
// the same bits for a row, whatever batch it is in. B columns beyond the
// pass's rows repeat its last row; their outputs are never stored.
//
// Staging: a pass's rows of x_eff are staged once per block as bf16 with
// the prologue applied (stage_rows), then every tile the block takes reads
// them. So a block moves mr * n_in * 2 bytes from L2 per pass and operand
// (twice that with the SwiGLU prologue's g and u), and a launch moves that
// times its block count: the users keep the grid at the resident blocks.

#pragma once

#include <mutex>

#include "common.cuh"

namespace w4gemv {

constexpr int WARPS = 16;        // warps per block, all on one column tile
constexpr int TILE_N = 16;       // output columns per tile (the MMA's M)
constexpr int MAX_ROWS = 8;      // rows of x per pass (the MMA's N)
constexpr int RMS_THREADS = 256; // the rms reduction's thread count
constexpr int RED_FLOATS = WARPS * MAX_ROWS * TILE_N;  // partial tiles
constexpr int RMS_PART = MAX_ROWS * (RMS_THREADS / 32);  // rms_scale_rows

// one packed w4-g128 weight: qw (n_out, n_in/8) int32 as 16-byte vectors,
// s and z (n_out, groups) fp16 and uint8
struct W4 {
  const uint4* qw;
  const __half* s;
  const uint8_t* z;
  int n_in, n_out, groups;
};

__host__ __device__ inline int n_groups(int n_in) { return (n_in + 127) >> 7; }

// Staged layout. A row holds every group whole (a ragged last group's
// tail is zero), each group in 17 units of 16 bytes: its four 32-input
// chunks at units 0, 4, 9 and 13 (xs_chunk), and rows are staged_stride
// units apart, = 2 mod 8. So the 8 lanes of a quarter warp (rows g and
// g+1, chunks t = 0..3, one word j each) read 8 different 16-byte bank
// slots, and a lane's 4 words are at fixed offsets from its chunk.
constexpr int GROUP_UNITS = 17;
__host__ __device__ inline int staged_stride(int n_in) {
  const int u = GROUP_UNITS * n_groups(n_in);
  return u + ((2 - u) & 7);
}

// element offset of chunk t of group g in a row
__host__ __device__ inline int xs_chunk(int g, int t) {
  return (g * GROUP_UNITS + 4 * t + (t >> 1)) * 8;
}

// shared-memory bytes of `rows` staged rows of n_in inputs: the bf16 rows,
// then sx (rows x groups f32)
__host__ __device__ inline size_t staged_bytes(int rows, int n_in) {
  return (size_t)rows * (staged_stride(n_in) * 16 +
                         n_groups(n_in) * sizeof(float));
}

// The rms prologue's stages (rmsnorm apply of a row written in the same
// launch) first copy the pass's raw rows into shared memory behind the
// staged rows (copy_rows), then take the rms scale and the staging from
// that copy: one read of the rows from L2 where the rms reduction's
// strided 2-byte loads would be a second, slower one. The copy's offset
// (16-byte aligned) and the bytes of both:
__host__ __device__ inline size_t raw_offset(int rows, int n_in) {
  return (staged_bytes(rows, n_in) + 15) & ~static_cast<size_t>(15);
}
// (elem: the bytes of one raw element, 2 for bf16 and fp16 rows, 4 for f32)
__host__ __device__ inline size_t staged_raw_bytes(int rows, int n_in,
                                                   int elem = 2) {
  return raw_offset(rows, n_in) + (size_t)rows * n_in * elem;
}

// 8 consecutive activations of type XT as they lie in memory: one 16-byte
// vector of bf16 or fp16, two of f32
template <typename XT>
struct Act8 {
  uint4 w[sizeof(XT) / 2];
};

template <typename XT, bool FROM_L2>
__device__ __forceinline__ Act8<XT> load8(const XT* p) {
  Act8<XT> a;
  const uint4* v = reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int i = 0; i < static_cast<int>(sizeof(XT) / 2); ++i)
    a.w[i] = FROM_L2 ? __ldcg(v + i) : v[i];
  return a;
}

// the 8 values of an Act8, widened to f32 (exact)
__device__ __forceinline__ void widen8(const Act8<__nv_bfloat16>& a,
                                       float (&v)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(a.w);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    v[2 * j] = f.x;
    v[2 * j + 1] = f.y;
  }
}
__device__ __forceinline__ void widen8(const Act8<__half>& a, float (&v)[8]) {
  const __half2* h = reinterpret_cast<const __half2*>(a.w);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __half22float2(h[j]);
    v[2 * j] = f.x;
    v[2 * j + 1] = f.y;
  }
}
__device__ __forceinline__ void widen8(const Act8<float>& a, float (&v)[8]) {
  const float* f = reinterpret_cast<const float*>(a.w);
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = f[j];
}

// Rows r0..r0+mr-1 of x (n wide, row stride ld, of type T; written in this
// launch: read through L2) into raw (mr x n of T, shared memory), in
// 16-byte vectors, 2 in flight a thread. Every thread of the block takes
// part; the caller syncs the block before reading raw.
template <typename T>
__device__ __forceinline__ void copy_rows(T* raw, const T* x, int ld, int r0,
                                          int mr, int n) {
  const int per_row = n * static_cast<int>(sizeof(T)) / 16;
  const int total = mr * per_row;
  for (int i0 = threadIdx.x; i0 < total; i0 += 2 * blockDim.x) {
    uint4 v[2];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int i = i0 + q * blockDim.x;
      const int r = i / per_row;
      if (i < total)
        v[q] = __ldcg(reinterpret_cast<const uint4*>(
                          x + (size_t)(r0 + r) * ld) +
                      (i - r * per_row));
    }
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int i = i0 + q * blockDim.x;
      if (i < total) reinterpret_cast<uint4*>(raw)[i] = v[q];
    }
  }
}

// silu(g) * u, the SwiGLU prologue, with the hardware exp and divide as
// int4_gemm.cu's; stage_rows and swiglu_rows compute it alike
__device__ __forceinline__ float swiglu(float g, float u) {
  const float s = __fdividef(1.0f, 1.0f + __expf(-g));
  return g * s * u;
}

// h = bf16(silu(g) * u) for rows 0..m-1 of hid inputs (row strides ldg,
// ldu; h contiguous), in 8-input vectors split over the whole grid: the
// SwiGLU prologue computed once a launch, where stage_rows<2> computes it
// in every block. Staging h then gives stage_rows<2>'s rows and sums bit
// for bit. h may be g itself (each vector is read before it is written).
template <bool FROM_L2>
__device__ __forceinline__ void swiglu_rows(const __nv_bfloat16* g, int ldg,
                                            const __nv_bfloat16* u, int ldu,
                                            __nv_bfloat16* h, int ldh,
                                            int m, int hid) {
  const int per_row = hid >> 3;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < m * per_row;
       i += gridDim.x * blockDim.x) {
    const int r = i / per_row;
    const int k = (i - r * per_row) * 8;
    const uint4* gp = reinterpret_cast<const uint4*>(g + (size_t)r * ldg + k);
    const uint4* up = reinterpret_cast<const uint4*>(u + (size_t)r * ldu + k);
    const uint4 gv = FROM_L2 ? __ldcg(gp) : *gp;
    const uint4 uv = FROM_L2 ? __ldcg(up) : *up;
    const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&gv);
    const __nv_bfloat162* u2 = reinterpret_cast<const __nv_bfloat162*>(&uv);
    uint4 out;
    uint32_t* o = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 a = __bfloat1622float2(g2[j]);
      const float2 b = __bfloat1622float2(u2[j]);
      o[j] = pack_bf16(swiglu(a.x, b.x), swiglu(a.y, b.y));
    }
    *reinterpret_cast<uint4*>(h + (size_t)r * ldh + k) = out;
  }
}

// Stage rows r0..r0+mr-1 of the effective x, rounded to bf16, into xs
// (the staged layout above), and sx[r * groups + g], the sum of row r's
// staged values over group g, after them. MODE 0: x as given; 1: x *
// ss[r] * nw[k], ss indexed by the pass-local row r (rmsnorm apply); 2:
// silu(x) * u (SwiGLU). x is bf16, fp16 or f32 (XT; the down_qkv chain's
// x2 in the activation type), u bf16. A thread takes 8 inputs and sums
// them in order;
// the 16 threads of a half warp hold one group and finish sx with a fixed
// shuffle tree. A thread issues the loads of U items before it uses any
// (the rows come from L2, and one item's latency at a time would bound
// the pass). Every thread of the block takes part; x, u and nw are
// 16-byte aligned, row strides % 8 == 0.
template <int MODE, bool FROM_L2, typename XT>
__device__ __forceinline__ void stage_rows(
    __nv_bfloat16* xs, const XT* x, int ldx, const __nv_bfloat16* u,
    int ldu, const float* ss, const float* nw, int r0, int mr, int n_in) {
  constexpr int U = MODE == 2 ? 2 : 4;
  const int rs = staged_stride(n_in) * 8;
  const int groups = n_groups(n_in);
  float* sx = reinterpret_cast<float*>(xs + (size_t)mr * rs);
  const int items = mr * groups * 16;
  const int lane = threadIdx.x & 31;
  for (int i0 = threadIdx.x - lane; i0 < items; i0 += U * blockDim.x) {
    Act8<XT> xv[U];
    uint4 uv[U];
#pragma unroll
    for (int q = 0; q < U; ++q) {
      const int i = i0 + q * blockDim.x + lane;
      const int rg = i >> 4;  // r * groups + g
      const int r = rg / groups;
      const int k = (rg - r * groups) * 128 + (i & 15) * 8;
      xv[q] = Act8<XT>{};
      uv[q] = make_uint4(0u, 0u, 0u, 0u);
      if (i < items && k < n_in) {
        xv[q] = load8<XT, FROM_L2>(x + (size_t)(r0 + r) * ldx + k);
        if (MODE == 2) {
          const __nv_bfloat16* up = u + (size_t)(r0 + r) * ldu + k;
          uv[q] = FROM_L2 ? __ldcg(reinterpret_cast<const uint4*>(up))
                          : *reinterpret_cast<const uint4*>(up);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < U; ++q) {
      // warp-uniform
      if (i0 + q * static_cast<int>(blockDim.x) >= items) break;
      const int i = i0 + q * blockDim.x + lane;
      const int rg = i >> 4;
      const int r = rg / groups;
      const int grp = rg - r * groups;
      const int k = grp * 128 + (i & 15) * 8;
      float sum = 0.0f;
      if (i < items) {
        uint4 packed = make_uint4(0u, 0u, 0u, 0u);  // the ragged tail: 0
        if (k < n_in) {
          float v[8];
          widen8(xv[q], v);
          if (MODE == 1) {  // nw: the same 8 weights for every row
            const float4 n0 = *reinterpret_cast<const float4*>(nw + k);
            const float4 n1 = *reinterpret_cast<const float4*>(nw + k + 4);
            const float nwv[8] = {n0.x, n0.y, n0.z, n0.w,
                                  n1.x, n1.y, n1.z, n1.w};
#pragma unroll
            for (int j = 0; j < 8; ++j) v[j] = v[j] * ss[r] * nwv[j];
          } else if (MODE == 2) {
            const __nv_bfloat162* hu =
                reinterpret_cast<const __nv_bfloat162*>(&uv[q]);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const float2 f = __bfloat1622float2(hu[j]);
              v[2 * j] = swiglu(v[2 * j], f.x);
              v[2 * j + 1] = swiglu(v[2 * j + 1], f.y);
            }
          }
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            v[j] = round_bf16(v[j]);
            sum += v[j];
          }
          packed.x = pack_bf16(v[0], v[4]);
          packed.y = pack_bf16(v[1], v[5]);
          packed.z = pack_bf16(v[2], v[6]);
          packed.w = pack_bf16(v[3], v[7]);
        }
        const int c = (i & 15) >> 2;  // chunk of the group, word i & 3
        *reinterpret_cast<uint4*>(xs + (size_t)r * rs + xs_chunk(grp, c) +
                                  (i & 3) * 8) = packed;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 8);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      if (i < items && (i & 15) == 0) sx[rg] = sum;
    }
  }
}

// A lane's share of one group of a tile: its 16-byte code vector of
// columns g and g+8, and each column's fp16 scale bits | zero << 16 (all
// zero beyond the weight, or for an empty slot).
struct GroupLoad {
  uint4 q[2];
  uint32_t sz[2];
};

// The nibbles at bits SH..SH+3 and SH+16..SH+19 of w as two bf16 codes:
// 0x4300 | q is bf16 128 + q, and 128 is subtracted exactly. Volatile, as
// the MMA is: the codes are widened step by step in the MMAs' order
// rather than all at once, which would hold 32 more registers.
template <int SH>
__device__ __forceinline__ uint32_t codes_bf16(uint32_t w) {
  uint32_t r;
  asm volatile(
      "{\n"
      "  .reg .b32 t;\n"
      "  shr.b32 t, %1, %2;\n"
      "  lop3.b32 t, t, 0x000F000F, 0x43004300, 0xEA;\n"
      "  sub.rn.bf16x2 %0, t, %3;\n"
      "}\n"
      : "=r"(r)
      : "r"(w), "n"(SH), "r"(0x43004300u));
  return r;
}

// acc += one group's scaled partial tile (D layout of mma_bf16_16x8x16:
// acc[0..1] column g, rows 2t and 2t+1; acc[2..3] column g+8). xb: the
// lane's chunk of this group in its B row; sx0, sx1: the group sums of
// rows 2t and 2t+1.
__device__ __forceinline__ void group_tile(float (&acc)[4],
                                           const GroupLoad& L,
                                           const __nv_bfloat16* xb,
                                           float sx0, float sx1) {
  const uint32_t* qa = reinterpret_cast<const uint32_t*>(&L.q[0]);
  const uint32_t* qb = reinterpret_cast<const uint32_t*>(&L.q[1]);
  // two MMA chains, the k-steps of half h = 0 and of h = 1, summed after
  float ph[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint4 xv = *reinterpret_cast<const uint4*>(xb + 8 * j);
    const uint32_t a0[4] = {codes_bf16<0>(qa[j]), codes_bf16<0>(qb[j]),
                            codes_bf16<4>(qa[j]), codes_bf16<4>(qb[j])};
    const uint32_t b0[2] = {xv.x, xv.y};
    mma_bf16_16x8x16(ph[0], a0, b0);
    const uint32_t a1[4] = {codes_bf16<8>(qa[j]), codes_bf16<8>(qb[j]),
                            codes_bf16<12>(qa[j]), codes_bf16<12>(qb[j])};
    const uint32_t b1[2] = {xv.z, xv.w};
    mma_bf16_16x8x16(ph[1], a1, b1);
  }
  float s[2], z[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    s[h] = __half2float(__ushort_as_half(
        static_cast<unsigned short>(L.sz[h] & 0xFFFFu)));
    z[h] = static_cast<float>(L.sz[h] >> 16);
  }
  acc[0] += (ph[0][0] + ph[1][0] - sx0 * z[0]) * s[0];
  acc[1] += (ph[0][1] + ph[1][1] - sx1 * z[0]) * s[0];
  acc[2] += (ph[0][2] + ph[1][2] - sx0 * z[1]) * s[1];
  acc[3] += (ph[0][3] + ph[1][3] - sx1 * z[1]) * s[1];
}

// Groups in flight per warp: a ring of RING GroupLoads in registers; the
// loads of the next RING - 1 items are in flight while one multiplies.
constexpr int RING = 2;

// A warp's work in tile_pass is a flat list of items: for each of the
// block's tiles (blockIdx.x, + gridDim.x, ...), npw slots of groups, slot
// s being group lo + s of the warp's K range [lo, hi) = [w*G/WARPS,
// (w+1)*G/WARPS) (fixed by n_in alone) and empty from hi on. Every warp
// has the same npw = ceil(G / WARPS), so a tile ends on the same item in
// all of them. A Loader walks the list without dividing.
struct Loader {
  int slot;
  int ca;  // the lane's column g of the tile (column g + 8 is ca + 8)

  __device__ __forceinline__ void start(int lane) {  // at item 0
    slot = 0;
    ca = blockIdx.x * TILE_N + (lane >> 2);
  }
  __device__ __forceinline__ void next(int npw) {
    if (++slot == npw) {
      slot = 0;
      ca += gridDim.x * TILE_N;
    }
  }
  // the loads of the current item, group lo + slot (zero past the
  // weight's tiles, for an empty slot, a column past n_out, or a vector
  // past a ragged last group)
  __device__ __forceinline__ void load(GroupLoad& L, const W4& w, int lo,
                                       int hi, int lane) const {
    const int grp = lo + slot;
    const int nvec = w.n_in >> 5;
    const bool live = grp < hi;
    const bool vec = live && grp * 4 + (lane & 3) < nvec;
    const unsigned short* s = reinterpret_cast<const unsigned short*>(w.s);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = ca + 8 * h;
      const bool on = col < w.n_out;
      L.q[h] = vec && on ? __ldg(w.qw + (size_t)col * nvec + grp * 4 +
                                 (lane & 3))
                         : make_uint4(0u, 0u, 0u, 0u);
      const size_t gi = (size_t)col * w.groups + grp;
      L.sz[h] = live && on ? static_cast<uint32_t>(__ldg(s + gi)) |
                                 static_cast<uint32_t>(__ldg(w.z + gi)) << 16
                           : 0u;
    }
  }
};

// The loads of a warp's first RING items of tile_pass over w, and the
// loader at item RING: made before the pass stages its rows, so the loads
// are in flight while it does.
struct TileLoads {
  GroupLoad ring[RING];
  Loader ahead;
};

__device__ __forceinline__ int warp_lo(const W4& w) {
  return static_cast<int>(threadIdx.x >> 5) * w.groups / WARPS;
}
__device__ __forceinline__ int warp_hi(const W4& w) {
  return (static_cast<int>(threadIdx.x >> 5) + 1) * w.groups / WARPS;
}

__device__ __forceinline__ TileLoads prefetch(const W4& w) {
  const int lane = threadIdx.x & 31;
  const int npw = (w.groups + WARPS - 1) / WARPS;
  const int lo = warp_lo(w), hi = warp_hi(w);
  TileLoads p;
  p.ahead.start(lane);
#pragma unroll
  for (int k = 0; k < RING; ++k) {
    p.ahead.load(p.ring[k], w, lo, hi, lane);
    p.ahead.next(npw);
  }
  return p;
}

// Output columns of w for the mr rows staged in xs (stage_rows), one tile
// of TILE_N columns at a time: tiles blockIdx.x, + gridDim.x, ... Each
// warp accumulates its groups of a tile with the next group's loads in
// flight (across tiles too); the block sums the partial tiles in red (2 *
// RED_FLOATS of shared memory, one half a tile in turn) in warp order,
// then adds the residual when res is given (of type RT, or type code
// res_dt where RT is Dyn; read through L2 with RES_L2; loaded when the
// tile starts) in f32 and stores row r0 + r of out (n_out wide) rounded
// to OT (or type code out_dt). `pre` is prefetch(w). Every
// thread of the block calls it; the caller syncs the block before it
// writes xs or calls tile_pass again.
template <bool RES_L2, typename RT = Dyn, typename OT = Dyn>
__device__ __forceinline__ void tile_pass(const W4& w, TileLoads pre,
                                          const __nv_bfloat16* xs, int r0,
                                          int mr, const void* res,
                                          int res_dt, void* out, int out_dt,
                                          float* red) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int rs = staged_stride(w.n_in) * 8;
  const int npw = (w.groups + WARPS - 1) / WARPS;
  const int lo = warp_lo(w), hi = warp_hi(w);
  const int n_tiles = (w.n_out + TILE_N - 1) / TILE_N;
  const int my_tiles =
      n_tiles > static_cast<int>(blockIdx.x)
          ? (n_tiles - 1 - static_cast<int>(blockIdx.x)) / gridDim.x + 1
          : 0;
  const int total = my_tiles * npw;
  // the lane's B row (rows past the pass repeat its last) and the sums of
  // its D rows 2t and 2t + 1
  const __nv_bfloat16* xb =
      xs + (size_t)min(g, mr - 1) * rs + xs_chunk(lo, t);
  const float* sx = reinterpret_cast<const float*>(xs + (size_t)mr * rs);
  const float* sx0 = sx + min(2 * t, mr - 1) * w.groups + lo;
  const float* sx1 = sx + min(2 * t + 1, mr - 1) * w.groups + lo;
  // the epilogue's element: thread < MAX_ROWS * TILE_N takes row er,
  // column ec of the tile
  const int er = threadIdx.x / TILE_N;
  const int ec = threadIdx.x % TILE_N;
  const bool epi = threadIdx.x < MAX_ROWS * TILE_N && er < mr;
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float resv = 0.0f;
  int buf = 0;
  int slot = 0, tile = blockIdx.x;
  Loader ahead = pre.ahead;

  auto step = [&](GroupLoad& L, int f) {
    if (f >= total) return;  // block-uniform
    const int col = tile * TILE_N + ec;
    if (slot == 0 && res != nullptr && epi && col < w.n_out)
      resv = ld_act<RT, RES_L2>(res, (size_t)(r0 + er) * w.n_out + col,
                                res_dt);
    if (lo + slot < hi)
      group_tile(acc, L, xb + slot * (GROUP_UNITS * 8), sx0[slot],
                 sx1[slot]);
    ahead.load(L, w, lo, hi, lane);
    ahead.next(npw);
    if (++slot < npw) return;
    slot = 0;
    tile += gridDim.x;
    // the tile's last slot: partial tile -> red[buf][warp][row][col]
    float* rw = red + buf * RED_FLOATS + warp * (MAX_ROWS * TILE_N);
    rw[(2 * t) * TILE_N + g] = acc[0];
    rw[(2 * t + 1) * TILE_N + g] = acc[1];
    rw[(2 * t) * TILE_N + g + 8] = acc[2];
    rw[(2 * t + 1) * TILE_N + g + 8] = acc[3];
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[i] = 0.0f;
    __syncthreads();
    if (epi && col < w.n_out) {
      const float* rb = red + buf * RED_FLOATS + threadIdx.x;
      float sum = rb[0];
#pragma unroll
      for (int k = 1; k < WARPS; ++k) sum += rb[k * (MAX_ROWS * TILE_N)];
      const size_t o = (size_t)(r0 + er) * w.n_out + col;
      if (res != nullptr) sum += resv;
      st_act<OT>(out, o, out_dt, sum);
    }
    buf ^= 1;
  };
  for (int f = 0; f < total; f += RING) {
#pragma unroll
    for (int k = 0; k < RING; ++k) step(pre.ring[k], f + k);
  }
}

// 1 / sqrt(mean(row^2) + eps) of rows 0..mr-1 (mr <= MAX_ROWS) of x (n
// values a row, row stride ld; of type T, or of type code dt where T is
// Dyn) into out[r] (shared memory),
// each in the order of a 256-thread block: thread t sums elements t,
// t + 256, ... with fmaf, 8 warp sums, then one warp sums those. The rows
// are summed side by side, so their loads are in flight together. Every
// thread of a block of at least MAX_ROWS warps calls it; part: MAX_ROWS *
// 8 floats of shared memory, free again when it returns.
template <bool FROM_L2, typename T = Dyn>
__device__ __forceinline__ void rms_scale_rows(const void* x, int dt,
                                               size_t ld, int mr, int n,
                                               float eps, float* part,
                                               float* out) {
  float acc[MAX_ROWS];
#pragma unroll
  for (int r = 0; r < MAX_ROWS; ++r) acc[r] = 0.0f;
  if (threadIdx.x < RMS_THREADS) {
    for (int i = threadIdx.x; i < n; i += RMS_THREADS) {
#pragma unroll
      for (int r = 0; r < MAX_ROWS; ++r) {
        if (r < mr) {
          const size_t e = r * ld + i;
          const float v = ld_act<T, FROM_L2>(x, e, dt);
          acc[r] = fmaf(v, v, acc[r]);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < MAX_ROWS; ++r) {
    if (r < mr) {
      const float a = warp_sum(acc[r]);
      if ((threadIdx.x & 31) == 0 && threadIdx.x < RMS_THREADS)
        part[r * (RMS_THREADS >> 5) + (threadIdx.x >> 5)] = a;
    }
  }
  __syncthreads();
  const int r = threadIdx.x >> 5;
  if (r < mr) {
    const int lane = threadIdx.x & 31;
    float t = lane < (RMS_THREADS >> 5) ? part[r * (RMS_THREADS >> 5) + lane]
                                        : 0.0f;
    t = warp_sum(t);
    if (lane == 0) out[r] = 1.0f / sqrtf(t / static_cast<float>(n) + eps);
  }
  __syncthreads();
}

inline W4 make_w4(const void* qw, const void* s, const void* z, int n_in,
                  int n_out) {
  return W4{static_cast<const uint4*>(qw), static_cast<const __half*>(s),
            static_cast<const uint8_t*>(z), n_in, n_out, n_groups(n_in)};
}

// Resident blocks per SM times the SM count of a kernel of WARPS * 32
// threads, with `smem` bytes of dynamic shared memory, on the current
// device. What a launch needs to know of its device is read once per
// device (SM count, cooperative support) and once per kernel slot and
// shared-memory size (the attribute, occupancy): the queries cost host
// time on every layer of a host-bound decode step. COOP: the kernel is
// launched cooperatively, so a device without that support is refused.
template <int SLOTS>
class Residency {
 public:
  cudaError_t blocks(const void* kernel, int slot, size_t smem, bool coop,
                     int* out) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    if (dev >= MAX_DEVICES || slot < 0 || slot >= SLOTS)
      return cudaErrorInvalidValue;
    std::lock_guard<std::mutex> lock(mu_);
    Info& li = info_[slot][dev];
    if (!li.read) {
      e = cudaDeviceGetAttribute(&li.sms, cudaDevAttrMultiProcessorCount,
                                 dev);
      if (e != cudaSuccess) return e;
      e = cudaDeviceGetAttribute(&li.coop, cudaDevAttrCooperativeLaunch,
                                 dev);
      if (e != cudaSuccess) return e;
      li.read = true;
    }
    if (coop && !li.coop) return cudaErrorNotSupported;
    if (smem > li.smem_attr) {
      e = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
      if (e != cudaSuccess) return e;
      li.smem_attr = smem;
    }
    if (smem != li.occ_smem || li.per_sm == 0) {
      int per_sm = 0;
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        WARPS * 32, smem);
      if (e != cudaSuccess) return e;
      if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
      li.per_sm = per_sm;
      li.occ_smem = smem;
    }
    *out = li.per_sm * li.sms;
    return cudaSuccess;
  }

 private:
  static constexpr int MAX_DEVICES = 64;
  struct Info {
    bool read = false;
    int sms = 0;
    int coop = 0;
    size_t smem_attr = 0;  // the largest size the kernel's attribute allows
    size_t occ_smem = 0;   // the size per_sm was computed for
    int per_sm = 0;
  };
  Info info_[SLOTS][MAX_DEVICES];
  std::mutex mu_;
};

}  // namespace w4gemv
