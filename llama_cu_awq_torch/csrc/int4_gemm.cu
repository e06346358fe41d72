// w4-g128 GEMM for blocks of rows (block prefill, perplexity) on Hopper's
// warpgroup tensor-core instruction, with the GEMV's prologue and
// epilogue options.
//
// Replaces: llama_cu_awq_tpu/ops/pallas/int4_matmul.py for m >= GEMM_MIN_M
//   (ops/cuda/int4_matmul.py): _int4_matmul_2d in its douter form, which
//   qkv and gate_up take at m = 128 through the unfused composite, and
//   _int4_matmul_fused_2d, which o and down take at m = 128.
//
// What bounds it on the H100: at m = 128, the operations (989 TFLOP/s
//   bf16 against 3.35 TB/s for the codes, scales and zeros):
//     7B  qkv     4096 -> 12288  12.9 GFLOP  13.0 us (26.4 MB, 7.9 us)
//         o       4096 ->  4096   4.3 GFLOP   4.3 us
//         gate_up 4096 -> 22016  23.1 GFLOP  23.3 us
//         down   11008 ->  4096  11.5 GFLOP  11.7 us
//     13B qkv     5120 -> 15360  20.1 GFLOP  20.4 us
//         o       5120 ->  5120   6.7 GFLOP   6.8 us
//         gate_up 5120 -> 27648  36.2 GFLOP  36.6 us
//         down   13824 ->  5120  18.1 GFLOP  18.3 us
//
// What the design does about it:
//   - The arithmetic is the TPU kernel's (int4_matmul.py
//     _accumulate_glue), per 128-row quantization group g:
//     part = x_eff . q on the raw nibble codes (0..15, exact in bf16),
//     sx = sum(x_eff) over the group, acc += (part - sx * z) * s in f32.
//     (q - z) * s is never rounded to bf16.
//   - Two launches a call, three with a split K. (1) stage, one block per
//     group and 32 rows: x_eff is made once a call, bf16(x * ss * norm_w)
//     (rmsnorm apply) or bf16(silu(g) * u) (SwiGLU) or x itself, rounded
//     where the GEMV rounds it, together with its group sums sx, into a
//     scratch image of 128-row x 128-input tiles in the MMA's
//     shared-memory layout. Extra bytes: the image, m_pad x
//     n_in_pad x 2 B written once and read from L2 by every column tile,
//     and m_pad x groups x 4 B of sums (7B, m = 128: 1.0 MB for qkv, o
//     and gate_up, 2.8 MB for down). (2) the GEMM. (3) the sum of a split
//     K's partials. (2) and (3) are launched as programmatic dependents of
//     the launch before them (griddepcontrol), so that their blocks are
//     resident and set up when it ends.
//   - wgmma m64n128k16, bf16 operands, f32 accumulators (sm_90a). The
//     codes are the register A operand: weight columns are the MMA's M
//     (64 a consumer warpgroup, 128 a unit of work), rows of x its N (a
//     128-row tile of x), so the per-column scale and zero sit on
//     accumulator rows. Each thread reads its 16 bytes of each of its two
//     columns' group from shared memory and widens the nibbles to bf16 in
//     registers, two a register (nibbles i and i + 4 of a word: one
//     and-or gives bf16(128 + q), one fma.bf16x2 takes 128 away, exact).
//     The inputs of a group are taken in a fixed permuted order, so that
//     those 16 bytes are whole words and each register a k pair: logical
//     k of input row p = 8w + i (word w = 4c + j, nibble i) is
//     16 (2j + (i / 2) % 2) + 2c + 8 (i % 2) + i / 4; the stage launch
//     writes x_eff in that order, so q and x meet in the same k. x is
//     the shared-memory B operand: K-major, no swizzle, 8 x 8 core
//     matrices of 128 bytes, the two of a 16-deep step 2048 bytes apart
//     (LBO), rows of 8 x rows 128 bytes apart (SBO).
//   - Copies: a ring of STAGES = 4 groups in shared memory, each stage x's
//     32 KB tile, the unit's 128 columns x 64 bytes of codes and the 128
//     group sums, brought by TMA behind an mbarrier: one bulk copy each
//     for x and sx, and one 2-D tensor-map copy (a 16-word x 128-column
//     box of qw, zeros past n_out and n_in) for the codes; one producer
//     warp keeps them in flight while two consumer warpgroups multiply,
//     and each consumer warp frees a stage by an arrival on its empty
//     barrier. (A bulk copy of 64 bytes a column, 128 copies a stage,
//     made the copies, not the MMA, the limit on the H100.) Scales and
//     zeros (2 + 1 bytes a column and group, strided) are loaded by each
//     consumer thread one group ahead.
//   - Registers: a consumer thread holds acc (64 f32), the group's part
//     (64 f32, the wgmma accumulator, overwritten at each group's first
//     step) and its 8 steps of A (32 b32). Blocks of three warpgroups: at
//     384 threads ptxas gives each 168 registers, so the producer's
//     warpgroup gives up all but 40 (setmaxnreg) and the two consumer
//     warpgroups take 232 (ptxas's count is in chip_smoke.py's output).
//   - Grid: units of (128 columns, a split of the groups, a 128-row tile
//     of x), walked by persistent blocks, one a SM (min(units, SMs)): the
//     producer loads the next unit's first stages while the consumers
//     finish the current one. The split count S comes from the caller
//     (int4_matmul.py gemm_splits: max(1, min(132 // tiles, groups // 8)),
//     a function of n_in and n_out only): splits cut the groups at fixed
//     boundaries g0 = s * groups / S, each split writes its f32 partial,
//     and launch (3) adds the partials in split order and runs the
//     epilogue (spread over the card; a reduction by the last split of
//     each tile, on 32 blocks at o, ran slower on the H100). At m = 128
//     (one row tile):
//       7B  qkv 96 tiles, S 1: 96 units, 0.73 of a wave (96 of 132 SMs)
//           o 32 tiles, S 4 (8 groups a unit): 128 units, 0.97
//           gate_up 172 tiles, S 1: 172 units, 1.30 (40 blocks take 2)
//           down 32 tiles, S 4 (21-22 groups): 128 units, 0.97
//       13B qkv 120 tiles, S 1: 0.91; o 40 tiles, S 3: 0.91;
//           gate_up 216 tiles, S 1: 1.64; down 40 tiles, S 3: 0.91
//     qkv leaves 36 SMs idle on purpose: at 4 splits (384 units, every SM
//     busy) its f32 partials and their sum cost more than the idle SMs
//     (chip_smoke.py's gemm_splits line on the H100).
//   - Determinism and row independence: each output is the sum over its
//     groups in order (within a group the MMA's own fixed order), split
//     partials added in split order; the order depends on n_in, n_out and
//     the tile, never on m or on the other rows (an MMA's column n reads
//     only x's row n), so a row of a 128-row call equals the same row of
//     a 65- or 100-row call bit for bit. No atomics.
//   - Epilogue: the residual added in f32, the cast; the residual and the
//     output are each bf16, fp16 or f32 (a run-time type code, as in
//     int4_gemv.cu); the rms scale of the output is int4_gemv.cu's
//     rms_scale launch.

#include <cuda.h>

#include "async_copy.cuh"
#include "common.cuh"

namespace {

namespace ac = async_copy;

constexpr int BN = 128;          // output columns of a unit (the MMA's M)
constexpr int BM = 128;          // rows of x of a unit (the MMA's N)
constexpr int BK = 128;          // one quantization group a stage
constexpr int STAGES = 4;
constexpr int CONSUMERS = 256;   // two warpgroups
constexpr int THREADS = CONSUMERS + 128;  // and the producer's warpgroup
constexpr int X_BYTES = BM * BK * 2;     // x_eff tile image
constexpr int CODE_BYTES = BN * BK / 2;  // 64 bytes a column
constexpr int SX_BYTES = BM * 4;
constexpr int STAGE_BYTES = X_BYTES + CODE_BYTES + SX_BYTES;
constexpr size_t SMEM_BYTES =
    static_cast<size_t>(STAGES) * STAGE_BYTES + 2 * STAGES * sizeof(uint64_t);
constexpr int LBO = 2048;  // the two core matrices of a 16-deep k step
constexpr int SBO = 128;   // consecutive groups of 8 rows of x

// the wgmma shared-memory descriptor of a K-major, unswizzled operand
__device__ __forceinline__ uint64_t smem_desc(const void* p) {
  const uint64_t addr = ac::smem_addr(p);
  return ((addr & 0x3FFFFu) >> 4) | (static_cast<uint64_t>(LBO >> 4) << 16) |
         (static_cast<uint64_t>(SBO >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// D (64 x 128 f32) = A (64 x 16, bf16 fragments in registers, the
// mma.m16n8k16 A layout per warp of the warpgroup) x B (16 x 128 bf16 in
// shared memory, K-major, described by desc_b); D is added to when
// accumulate is nonzero, overwritten otherwise. Issued by the whole
// warpgroup; asynchronous until wgmma_wait.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64],
                                                 const uint32_t (&a)[4],
                                                 uint64_t desc_b,
                                                 int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(accumulate));
}

// nibbles i and i + 4 of w >> (4 i) as one bf16x2 (i in the low half):
// bf16(128 + q) is 0x4300 | q, one and-or; one fma takes 128 away,
// exactly
__device__ __forceinline__ uint32_t widen2(uint32_t w, int shift) {
  const uint32_t t = ((w >> shift) & 0x000F000Fu) | 0x43004300u;
  uint32_t r;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
      : "=r"(r)
      : "r"(t), "r"(0x3F803F80u), "r"(0xC300C300u));
  return r;
}

// Launch (1): one block per (group, quarter of a 128-row tile of x: 32
// rows, 4 groups of 8 rows in the image). MODE 0: x as given; 1:
// x*ss*norm_w; 2: silu(x)*u (the GEMV's staging and rounding). Writes the
// quarter's core matrices of the tile image (logical k order; x_eff (n,
// k) at byte ((k / 8) * 16 + n / 8) * 128 + (n % 8) * 16 + (k % 8) * 2)
// and the rows' group sums of the rounded values; rows past m and inputs
// past n_in are 0.
template <int MODE>
__global__ void __launch_bounds__(256)
stage_x_kernel(const __nv_bfloat16* __restrict__ x, int ldx,
               const __nv_bfloat16* __restrict__ u, int ldu,
               const float* __restrict__ ss, const float* __restrict__ nw,
               uint4* __restrict__ xs, float* __restrict__ sx, int m,
               int n_in, int groups) {
  constexpr int QROWS = BM / 4;
  // the quarter's 16 x 4 core matrices, [k / 8][n / 8 within][128 B]
  __shared__ __align__(16) unsigned char tile[X_BYTES / 4];
  // the GEMM launch may start now; it waits for this grid's end before it
  // reads the tiles
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int g = blockIdx.x;
  const int rt = blockIdx.y >> 2;
  const int q = blockIdx.y & 3;
  const int tid = threadIdx.x;
#pragma unroll
  for (int it = 0; it < QROWS * 16 / 256; ++it) {
    const int i = it * 256 + tid;
    const int nq = i >> 4;  // the 16 lanes of a half warp hold one row
    const int n = q * QROWS + nq;
    const int w = i & 15;   // word of the group: inputs 8w .. 8w + 7
    const int row = rt * BM + n;
    const int k = g * BK + w * 8;
    const bool ok = row < m && k < n_in;
    uint4 xv = make_uint4(0u, 0u, 0u, 0u), uv = xv;
    float4 nw_lo = make_float4(0.0f, 0.0f, 0.0f, 0.0f), nw_hi = nw_lo;
    float ss_r = 0.0f;
    if (ok) {
      xv = *reinterpret_cast<const uint4*>(x + static_cast<size_t>(row) * ldx
                                           + k);
      if (MODE == 2)
        uv = *reinterpret_cast<const uint4*>(
            u + static_cast<size_t>(row) * ldu + k);
      if (MODE == 1) {
        nw_lo = *reinterpret_cast<const float4*>(nw + k);
        nw_hi = *reinterpret_cast<const float4*>(nw + k + 4);
        ss_r = ss[row];
      }
    }
    const __nv_bfloat16* xe = reinterpret_cast<const __nv_bfloat16*>(&xv);
    const __nv_bfloat16* ue = reinterpret_cast<const __nv_bfloat16*>(&uv);
    const float nwv[8] = {nw_lo.x, nw_lo.y, nw_lo.z, nw_lo.w,
                          nw_hi.x, nw_hi.y, nw_hi.z, nw_hi.w};
    float v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      v[j] = __bfloat162float(xe[j]);
      if (MODE == 1) {
        v[j] = v[j] * ss_r * nwv[j];
      } else if (MODE == 2) {
        const float sig = __fdividef(1.0f, 1.0f + __expf(-v[j]));
        v[j] = v[j] * sig * __bfloat162float(ue[j]);
      }
    }
    // the pairs (inputs i, i + 4) that one widen2 gives a thread
    uint32_t pw[4];
    float sum = 0.0f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      pw[j] = pack_bf16(v[j], v[j + 4]);
      const float2 f = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&pw[j]));
      sum += f.x + f.y;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 8);
    sum += __shfl_xor_sync(0xffffffffu, sum, 4);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    if (w == 0) sx[(static_cast<size_t>(rt) * groups + g) * BM + n] = sum;
    // word w = 4c + j feeds k steps 2j and 2j + 1 of lane group c: pair
    // (i, i + 4) is logical k 32j + 2c + 8i (i = 0 .. 3), see the header
    const int k0 = 32 * (w & 3) + 2 * (w >> 2);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kl = k0 + 8 * j;
      *reinterpret_cast<uint32_t*>(
          tile + (((kl >> 3) * 4 + (nq >> 3)) << 7) + ((nq & 7) << 4) +
          ((kl & 7) << 1)) = pw[j];
    }
  }
  __syncthreads();
  // each k / 8 holds the quarter's 4 core matrices, 512 contiguous bytes
  // of the image
  uint4* dst = xs + (static_cast<size_t>(rt) * groups + g) * (X_BYTES / 16);
  const uint4* src = reinterpret_cast<const uint4*>(tile);
#pragma unroll
  for (int v = tid; v < X_BYTES / 64; v += 256) {
    const int kb = v >> 5;  // 32 vectors of 16 bytes a k / 8
    dst[(kb * (BM / 8) + 4 * q) * 8 + (v & 31)] = src[v];
  }
}

// the epilogue of one output: the residual (of type RT, or type code
// res_dt where RT is Dyn) added in f32, the cast to OT (or out_dt)
template <typename RT, typename OT>
__device__ __forceinline__ void store_out(void* out, int out_dt,
                                          const void* res, int res_dt,
                                          size_t o, float val) {
  if (res != nullptr) val += ld_act<RT, false>(res, o, res_dt);
  st_act<OT>(out, o, out_dt, val);
}

// A unit's 64 outputs (accumulator (column, row 8j + 2c + e % 2)) through
// the epilogue, the types known at compile time
template <typename RT, typename OT>
__device__ __forceinline__ void store_unit(const float (&acc)[64], void* out,
                                           int out_dt, const void* res,
                                           int res_dt, int m, int n_out,
                                           int row0, int col_a, int col_b) {
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = e < 2 ? col_a : col_b;
      const int n = row0 + 8 * j + (e & 1);
      if (n >= m || col >= n_out) continue;
      store_out<RT, OT>(out, out_dt, res, res_dt,
                        static_cast<size_t>(n) * n_out + col,
                        acc[4 * j + e]);
    }
}

// Launch (2), see the header. Unit u: split u % S, column tile (u / S) %
// tiles, row tile u / (S * tiles).
__global__ void __launch_bounds__(THREADS, 1)
int4_gemm_kernel(const __grid_constant__ CUtensorMap tmap_qw,
                 const __nv_bfloat16* __restrict__ xs,
                 const float* __restrict__ sxg,
                 const __half* __restrict__ scales,
                 const uint8_t* __restrict__ zeros,
                 const void* __restrict__ res, int res_dt,
                 void* __restrict__ out, float* __restrict__ part,
                 int out_dt, int m, int n_in, int n_out, int groups,
                 int splits, int tiles, int units) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE_BYTES);
  uint64_t* empty = full + STAGES;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int i = 0; i < STAGES; ++i) {
      ac::bar_init(full + i, 1);
      ac::bar_init(empty + i, CONSUMERS / 32);
    }
    ac::bar_init_fence();
  }
  __syncthreads();
  // launched before the stage launch ends (programmatic dependent
  // launch): everything above overlapped its tail; x_eff is read below
  asm volatile("griddepcontrol.wait;\n" ::: "memory");

  if (tid >= CONSUMERS) {
    // the producer warpgroup: its first warp issues the copies
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid >= CONSUMERS + 32) return;
    const int lane = tid & 31;
    int i = 0;
    for (int un = blockIdx.x; un < units; un += gridDim.x) {
      const int sp = un % splits;
      const int col0 = (un / splits) % tiles * BN;
      const int rt = un / (splits * tiles);
      const int g1 = (sp + 1) * groups / splits;
      for (int g = sp * groups / splits; g < g1; ++g, ++i) {
        const int st = i % STAGES;
        ac::bar_wait(empty + st, ((i / STAGES) & 1) ^ 1);
        unsigned char* sb = smem + st * STAGE_BYTES;
        if (lane == 0) {
          ac::bar_arrive_expect(full + st, STAGE_BYTES);
          const size_t tile_i = static_cast<size_t>(rt) * groups + g;
          ac::bulk_g2s(sb, xs + tile_i * (X_BYTES / 2), X_BYTES, full + st);
          ac::tma_2d(sb + X_BYTES, &tmap_qw, g * (BK / 8), col0, full + st);
          ac::bulk_g2s(sb + X_BYTES + CODE_BYTES, sxg + tile_i * BM,
                       SX_BYTES, full + st);
        }
        __syncwarp();
      }
    }
    return;
  }

  // the consumer warpgroups
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int lane = tid & 31;
  const int g8 = lane >> 2;
  const int c4 = lane & 3;
  // this thread's two columns of the unit (accumulator rows g8, g8 + 8
  // of its warp's 16)
  const int ra = (tid >> 7) * 64 + ((tid >> 5) & 3) * 16 + g8;
  float acc[64], pt[64];
  int i = 0;
  for (int un = blockIdx.x; un < units; un += gridDim.x) {
    const int sp = un % splits;
    const int col0 = (un / splits) % tiles * BN;
    const int rt = un / (splits * tiles);
    const int col_a = col0 + ra;
    const int col_b = col_a + 8;
    const int g0 = sp * groups / splits;
    const int g1 = (sp + 1) * groups / splits;
    auto sz = [&](int col, int g, float& s, float& z) {
      s = z = 0.0f;
      if (col < n_out) {
        const size_t gi = static_cast<size_t>(col) * groups + g;
        s = __half2float(scales[gi]);
        z = static_cast<float>(zeros[gi]);
      }
    };
    float s_a, z_a, s_b, z_b;
    sz(col_a, g0, s_a, z_a);
    sz(col_b, g0, s_b, z_b);
#pragma unroll
    for (int e = 0; e < 64; ++e) acc[e] = 0.0f;
    for (int g = g0; g < g1; ++g, ++i) {
      const int st = i % STAGES;
      // the next group's scales and zeros, loaded while this one runs
      float s_a2 = 0.0f, z_a2 = 0.0f, s_b2 = 0.0f, z_b2 = 0.0f;
      if (g + 1 < g1) {
        sz(col_a, g + 1, s_a2, z_a2);
        sz(col_b, g + 1, s_b2, z_b2);
      }
      ac::bar_wait(full + st, (i / STAGES) & 1);
      const unsigned char* sb = smem + st * STAGE_BYTES;
      const uint4 qa = *reinterpret_cast<const uint4*>(
          sb + X_BYTES + ra * (BK / 2) + c4 * 16);
      const uint4 qb = *reinterpret_cast<const uint4*>(
          sb + X_BYTES + (ra + 8) * (BK / 2) + c4 * 16);
      const uint32_t wa[4] = {qa.x, qa.y, qa.z, qa.w};
      const uint32_t wb[4] = {qb.x, qb.y, qb.z, qb.w};
      // step s = 2j + e: k pair (2c, 2c + 1) is nibbles (2e, 2e + 4) of
      // word j, pair (2c + 8, 2c + 9) nibbles (2e + 1, 2e + 5)
      uint32_t a[8][4];
#pragma unroll
      for (int s = 0; s < 8; ++s) {
        const int sh = (s & 1) * 8;
        a[s][0] = widen2(wa[s >> 1], sh);
        a[s][1] = widen2(wb[s >> 1], sh);
        a[s][2] = widen2(wa[s >> 1], sh + 4);
        a[s][3] = widen2(wb[s >> 1], sh + 4);
      }
      const uint64_t desc = smem_desc(sb);
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < 8; ++s)
        wgmma_m64n128k16(pt, a[s], desc + ((s * 2 * LBO) >> 4), s > 0);
      wgmma_commit();
      wgmma_wait();
      // fold: acc += (part - sx * z) * s, per accumulator row (column)
      const float* sxs =
          reinterpret_cast<const float*>(sb + X_BYTES + CODE_BYTES);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float2 sv =
            *reinterpret_cast<const float2*>(sxs + 8 * j + 2 * c4);
        acc[4 * j + 0] += (pt[4 * j + 0] - sv.x * z_a) * s_a;
        acc[4 * j + 1] += (pt[4 * j + 1] - sv.y * z_a) * s_a;
        acc[4 * j + 2] += (pt[4 * j + 2] - sv.x * z_b) * s_b;
        acc[4 * j + 3] += (pt[4 * j + 3] - sv.y * z_b) * s_b;
      }
      __syncwarp();
      if (lane == 0) ac::bar_arrive(empty + st);
      s_a = s_a2;
      z_a = z_a2;
      s_b = s_b2;
      z_b = z_b2;
    }
    // the unit's outputs: accumulator (column, row 8j + 2c + e % 2); with
    // a split K, this split's partial; else the epilogue, in the output's
    // type (and a residual of the same type) where it is one of the three,
    // by type code otherwise (a branch a unit, not one an output)
    const int row0 = rt * BM + 2 * c4;
    if (splits > 1) {
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = e < 2 ? col_a : col_b;
          const int n = row0 + 8 * j + (e & 1);
          if (n >= m || col >= n_out) continue;
          part[static_cast<size_t>(sp) * m * n_out +
               static_cast<size_t>(n) * n_out + col] = acc[4 * j + e];
        }
    } else if (res != nullptr && res_dt != out_dt) {
      store_unit<Dyn, Dyn>(acc, out, out_dt, res, res_dt, m, n_out, row0,
                           col_a, col_b);
    } else if (out_dt == DT_BF16) {
      store_unit<__nv_bfloat16, __nv_bfloat16>(acc, out, out_dt, res, res_dt,
                                               m, n_out, row0, col_a, col_b);
    } else if (out_dt == DT_F16) {
      store_unit<__half, __half>(acc, out, out_dt, res, res_dt, m, n_out,
                                 row0, col_a, col_b);
    } else {
      store_unit<float, float>(acc, out, out_dt, res, res_dt, m, n_out, row0,
                               col_a, col_b);
    }
  }
}

// Launch (3), with a split K: the splits' partials added in split order,
// then the epilogue (RT, OT: see store_out), 4 outputs a thread where
// m * n_out % 4 == 0 (VEC), else 1. A programmatic dependent of (2): it
// waits for (2)'s end.
template <int VEC, typename RT, typename OT>
__global__ void __launch_bounds__(256)
split_sum_kernel(const float* __restrict__ part,
                 const void* __restrict__ res, int res_dt,
                 void* __restrict__ out, int out_dt, int splits,
                 size_t total) {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  for (size_t o = (blockIdx.x * 256ull + threadIdx.x) * VEC; o < total;
       o += static_cast<size_t>(gridDim.x) * 256 * VEC) {
    float val[VEC];
    if constexpr (VEC == 4) {
      const float4 v = *reinterpret_cast<const float4*>(part + o);
      val[0] = v.x, val[1] = v.y, val[2] = v.z, val[3] = v.w;
      for (int s = 1; s < splits; ++s) {
        const float4 w =
            *reinterpret_cast<const float4*>(part + s * total + o);
        val[0] += w.x, val[1] += w.y, val[2] += w.z, val[3] += w.w;
      }
    } else {
      val[0] = part[o];
      for (int s = 1; s < splits; ++s) val[0] += part[s * total + o];
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      store_out<RT, OT>(out, out_dt, res, res_dt, o + e, val[e]);
  }
}

// cuTensorMapEncodeTiled, looked up through the CUDA runtime's entry
// point query (no link against libcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// qw (n_out rows of n_in / 8 words) as a 2-D tensor whose box is one
// group's 16 words of BN columns
int codes_map(CUtensorMap* map, const void* qw, int n_in, int n_out) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult q;
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &q);
    if (e != cudaSuccess) return launch_refused(e);
    if (q != cudaDriverEntryPointSuccess || fn == nullptr)
      return static_cast<int>(cudaErrorSymbolNotFound);
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(n_in / 8),
                              static_cast<cuuint64_t>(n_out)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(n_in / 2)};
  const cuuint32_t box[2] = {BK / 8, BN};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_UINT32, 2, const_cast<void*>(qw), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (n < 1) n = 1;
  }
  return n;
}

template <int MODE>
int launch_stage(const void* x, int ldx, const void* u, int ldu,
                 const void* ss, const void* nw, void* xs, void* sx, int m,
                 int n_in, int groups, cudaStream_t stream) {
  const dim3 grid(groups, 4 * ((m + BM - 1) / BM));
  stage_x_kernel<MODE><<<grid, 256, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), ldx,
      static_cast<const __nv_bfloat16*>(u), ldu,
      static_cast<const float*>(ss), static_cast<const float*>(nw),
      static_cast<uint4*>(xs), static_cast<float*>(sx), m, n_in, groups);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The int4_gemv interface without rows_per_pass, plus the split count
// and scratch. x: (m, n_in) bf16, row stride ldx; u: SwiGLU up values
// (m, n_in) bf16, row stride ldu, or null; ss: (m,) f32 and nw: (n_in,)
// f32 for the rmsnorm-apply prologue, or null. qw: (n_out, n_in/8) int32;
// scales: (n_out, groups) fp16; zeros: (n_out, groups) uint8. res:
// (m, n_out) of type code res_dt or null. out: (m, n_out) of type code
// out_dt (DT_F32, DT_BF16 or DT_F16). splits: 1 .. groups. xs: ceil(m/128) x groups x 32 KB, sx: ceil(m/128)
// x groups x 128 f32, part: splits x m x n_out f32 (null when splits is
// 1), each 16-byte aligned. Needs n_in % 32 == 0, groups =
// ceil(n_in / 128), x, u, nw and qw 16-byte aligned, row strides % 8 == 0.
LLAMA_EXPORT int int4_gemm(const void* x, int ldx, const void* u, int ldu,
                           const void* ss, const void* nw, const void* qw,
                           const void* scales, const void* zeros,
                           const void* res, int res_dt, void* out,
                           int out_dt, int m, int n_in, int n_out,
                           int groups, int splits,
                           void* xs, void* sx, void* part, void* stream) {
  auto al16 = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const bool aligned =
      al16(x) && ldx % 8 == 0 && (u == nullptr || (al16(u) && ldu % 8 == 0)) &&
      (ss == nullptr || al16(nw)) && al16(qw) && al16(xs) && al16(sx) &&
      (splits == 1 || al16(part));
  if (n_in % 32 != 0 || groups != (n_in + BK - 1) / BK || m < 1 ||
      n_out < 1 || splits < 1 || splits > groups || !aligned ||
      (splits > 1 && part == nullptr) || res_dt < DT_F32 ||
      res_dt > DT_F16 || out_dt < DT_F32 || out_dt > DT_F16)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc = u != nullptr
               ? launch_stage<2>(x, ldx, u, ldu, ss, nw, xs, sx, m, n_in,
                                 groups, st)
           : ss != nullptr
               ? launch_stage<1>(x, ldx, u, ldu, ss, nw, xs, sx, m, n_in,
                                 groups, st)
               : launch_stage<0>(x, ldx, u, ldu, ss, nw, xs, sx, m, n_in,
                                 groups, st);
  if (rc != 0) return rc;
  CUtensorMap tmap;
  rc = codes_map(&tmap, qw, n_in, n_out);
  if (rc != 0) return rc;
  cudaError_t e = cudaFuncSetAttribute(
      int4_gemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(SMEM_BYTES));
  if (e != cudaSuccess) return launch_refused(e);
  const int tiles = (n_out + BN - 1) / BN;
  const int units = (m + BM - 1) / BM * tiles * splits;
  e = ac::launch_dependent(
      int4_gemm_kernel, dim3(min(units, sm_count())), THREADS, SMEM_BYTES,
      st, tmap, static_cast<const __nv_bfloat16*>(xs),
      static_cast<const float*>(sx), static_cast<const __half*>(scales),
      static_cast<const uint8_t*>(zeros),
      res, res_dt, out, static_cast<float*>(part), out_dt, m, n_in, n_out,
      groups, splits, tiles, units);
  if (e != cudaSuccess) return launch_refused(e);
  if (splits == 1) return static_cast<int>(cudaGetLastError());
  const size_t total = static_cast<size_t>(m) * n_out;
  const bool vec = total % 4 == 0;
  const size_t want = (total / (vec ? 4 : 1) + 255) / 256;
  const dim3 grid(static_cast<int>(want < 4096 ? want : 4096));
  // the epilogue's types at compile time where the output is one of the
  // three and the residual is none or of its type, else by type code
  auto pick = [&](auto rt_ot) {
    using T = decltype(rt_ot);
    return vec ? split_sum_kernel<4, T, T> : split_sum_kernel<1, T, T>;
  };
  auto sum = res != nullptr && res_dt != out_dt
                 ? (vec ? split_sum_kernel<4, Dyn, Dyn>
                        : split_sum_kernel<1, Dyn, Dyn>)
             : out_dt == DT_BF16 ? pick(__nv_bfloat16{})
             : out_dt == DT_F16  ? pick(__half{})
                                 : pick(float{});
  e = ac::launch_dependent(sum, grid, 256, 0, st,
                       static_cast<const float*>(part),
                       res, res_dt, out, out_dt, splits, total);
  if (e != cudaSuccess) return launch_refused(e);
  return static_cast<int>(cudaGetLastError());
}
