// int8 weight-only matrix product on Hopper:
//   out[i, j] = cast((sum_k x[i, k] * q[k, j]) * scale[j])
// x [m, k] fp32 or bf16, q [k, n] int8 (row-major: n is contiguous, the
// JAX layout), scale [n] fp32, out [m, n] fp32 or bf16. Products and
// sums are fp32 (an int8 value is exact in fp32 and in bf16; a bf16 x
// times an int8 q is exact in fp32), the scale is applied once per
// output, then one rounding to the output type.
//
// Replaces the Pallas TPU kernel of tony_tpu/ops/quant.py,
// _q8_matmul_kernel (:42), launched by q8_matmul (:55), which keeps the
// whole K extent of a [k, bn] weight tile in VMEM. On Hopper 8960 x 256
// int8 is 2.3 MB, ten times a block's shared memory, so here K is walked
// in stages through shared memory, and split over blocks when the output
// tiles are too few to fill the card.
//
// What bounds it on an H100:
//  - decode (m = batch, 1-16): bytes. The weights are read once: k * n
//    bytes (13.8 MB for Qwen2.5-1.5B's wi, 4.1 us at 3.35 TB/s), against
//    2 m k n flops.
//  - prefill and scoring (m in the thousands): operations. 2 m k n flops
//    (112.7 GFLOP for wi at m = 4096) against the bf16 tensor-core peak
//    (989 TFLOP/s) for a bf16 x, and against the fp32 peak outside the
//    tensor cores (67 TFLOP/s) for an fp32 x, whose products must be
//    fp32 (a bf16 or TF32 product would round x).
//
// Three routes, chosen by m and x's type (tony_q8_matmul_route; the
// wrapper's plan mirrors the tile constants):
//  0. decode, m <= DEC_ROWS: stream the weight once. A block owns
//     DEC_BN = 128 columns and one of S K splits, split z taking the
//     DEC_BK-row stages z, z + S, z + 2S, ... The raw int8 tiles and the
//     x rows for the same k land by cp.async.cg (16 bytes a thread) in a
//     ring of DEC_STAGES, three stages (24 KB of weight) in flight while
//     the block computes. The plan sizes the grid (column slab x split)
//     to one wave of DEC_BLOCKS_PER_SM blocks an SM (wg/wi: 70 x 5 = 350
//     blocks). Interleaving the splits keeps the blocks' reads in a
//     compact front moving down k; giving each split a contiguous range
//     with all of it in flight at once was slower in trials at wg/wi,
//     m = 8.
//     - bf16 x, tensor cores: outT = qT . xT, the weight as the A operand
//       of mma.sync m16n8k16 (16 output columns x 16 k) and xT as B, its
//       n8 the batch (m <= 8 one tile, m <= 16 two). A lane builds its A
//       fragment in registers from four 16-bit words of the raw stage
//       (two adjacent columns of four rows of k, the k order permuted
//       alike in A and B, rows padded to 144 bytes so the reads do not
//       conflict), converting int8 to bf16 exactly: a byte permute into
//       the fp32 2^23 + q + 128, one subtraction, and the top halves of
//       two such floats as a bf16 pair. Each warp owns 16 columns over
//       the whole split, so the warps never meet. (SIMT FMAs for a bf16
//       x were slower in trials at wg/wi, m = 8: about ten instructions
//       a weight byte.)
//     - fp32 x, SIMT fp32 FMAs, since the products must be fp32 (TF32
//       would round x): each warp takes 8 rows of every stage, a lane 4
//       columns (one 32-bit shared word a row) and all rows of x, with
//       the same exact int8 -> fp32 conversion in registers; the warps'
//       sums meet in shared memory in warp order.
//     The K splits of a slab are one thread-block cluster (at most
//     DEC_MAX_SPLITS): each block pushes its sums into the shared memory
//     of the block that owns those outputs, and after one cluster
//     barrier each adds its share over the splits in split order, scales
//     and rounds. No global partials, counters or float atomics, and a
//     rerun gives the same bits. (A combine through global partials and
//     an integer counter, the last block adding, and the blocks reading
//     each other's memory between two barriers were both slower in
//     trials.)
//  1. tensor cores, m > DEC_ROWS, bf16 x: 128 x 128 output tiles, 8
//     warps of 64 x 32, mma.sync m16n8k16 bf16 with fp32 accumulators.
//     x tiles land by cp.async and are read by ldmatrix; the int8 tiles
//     land raw by cp.async, are converted to bf16 in shared memory
//     (exact) and read by ldmatrix.trans as the B operand; three stages.
//     The scale is applied in the epilogue.
//  2. SIMT tile, m > DEC_ROWS, fp32 x (the first port's kernel): a
//     128 x 128 tile, 256 threads of 8 x 8 outputs, BK = 32; the int8
//     tile is converted to fp32 in shared memory and the next chunk's
//     loads are in flight during the products.
// Routes 1 and 2 split K over blocks when the tiles are too few, and a
// second kernel adds the partials in split order. Any m, n, k: ragged
// edges load zeros, stores are bounds-checked, and 16-byte copies are
// used only where the row stride and the base pointer allow them.
//
// Expert-batched form (tony_q8_matmul_experts): the same product for E
// weight matrices q [E, k, n] with scales [E, n] into out [E, m, n], in
// one launch, as jax.vmap(q8_matmul) over the expert axis is one Pallas
// call with an expert grid dimension (the int8 MoE expert FFN of
// tony_tpu/parallel/moe.py, _q8_expert_ffn). x is [E, m, k] (stride m k
// between experts) or one [m, k] that every expert reads (stride 0, the
// dropless FFN's broadcast tokens). The decode route puts the expert on
// grid z (the K-split cluster stays within one expert); routes 1 and 2
// fold it into grid z beside the K split. Each block moves its pointers
// to its expert's matrices first; every bound check below is then the
// single matrix's.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;  // threads a block, every route

// decode route
constexpr int DEC_ROWS = 16;          // m at or below which it runs
constexpr int DEC_BN = 128;           // columns a block
constexpr int DEC_BK = 64;            // rows of k a stage
constexpr int DEC_STAGES = 4;         // ring depth
constexpr int DEC_MAX_SPLITS = 16;    // K splits of a slab: one cluster
constexpr int DEC_BLOCKS_PER_SM = 3;  // the plan's target
constexpr int DEC_LD = DEC_BN + 16;   // bytes a staged weight row
constexpr int DEC_W = DEC_BK * DEC_LD;  // weight bytes a stage
constexpr int DEC_WARPS = NT / 32;

// x elements a staged row: 144 bytes of bf16 (tensor cores) or 272 of
// fp32 (SIMT), so the rows' reads fall in distinct banks
template <typename XT>
__host__ __device__ constexpr int dec_xld() {
  return sizeof(XT) == 2 ? DEC_BK + 8 : DEC_BK + 4;
}
// a ring stage: the weight tile, then R rows of x for the same k
template <typename XT, int R>
__host__ __device__ constexpr int dec_stage() {
  return DEC_W + R * dec_xld<XT>() * static_cast<int>(sizeof(XT));
}
// the ring (or the warps' [R][DEC_BN] fp32 sums, SIMT, where they need
// more), then the inbox: the [splits][share] fp32 sums the blocks of the
// cluster push here, share = ceil(m DEC_BN / splits)
template <typename XT, int R>
__host__ __device__ constexpr int dec_inbox_at() {
  constexpr int ring = DEC_STAGES * dec_stage<XT, R>();
  constexpr int sums = sizeof(XT) == 4 ? DEC_WARPS * R * DEC_BN * 4 : 0;
  return ring > sums ? ring : sums;
}
template <typename XT, int R>
__host__ __device__ constexpr int dec_smem() {
  return dec_inbox_at<XT, R>() + (R * DEC_BN + DEC_MAX_SPLITS) * 4;
}

// tensor-core and SIMT tiles
constexpr int TILE_M = 128, TILE_N = 128, TILE_K = 32;
constexpr int TC_STAGES = 3;
constexpr int TC_XLD = TILE_K + 8;          // bf16 a row of the x tile
constexpr int TC_WLD = TILE_N + 8;          // bf16 a row of the weight tile
constexpr int TC_XT = TILE_M * TC_XLD * 2;  // bytes of an x tile
constexpr int TC_RAW = TILE_K * TILE_N;     // bytes of a raw int8 tile
constexpr int TC_STAGE = TC_XT + TC_RAW;
constexpr int TC_SMEM = TC_STAGES * TC_STAGE + TILE_K * TC_WLD * 2;

// ------------------------------------------------------------ helpers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zeros where !ok (src-size 0)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8x8 b16 matrices; lanes 8m..8m+7 give the row addresses of matrix m
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d[16x8] += a[16x16] . b[16x8], bf16 operands, fp32 sums
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the four int8 of a word as fp32, exactly: byte b + 128 becomes the low
// mantissa byte of 2^23, then 2^23 + 128 comes off
__device__ __forceinline__ void q4_to_f32(uint32_t w, float (&f)[4]) {
  const uint32_t u = w ^ 0x80808080u;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    f[j] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 | j)) -
           8388736.f;
}

// two small integers held exactly in fp32 as a bf16 pair (their top
// halves), the first in the low half
__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

template <typename OT>
__device__ __forceinline__ OT to_out(float v);
template <>
__device__ __forceinline__ float to_out<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 to_out<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// 16 int8 weights of row kr from column c into shared memory at dst: by
// cp.async where the row is 16-byte aligned, else byte by byte; zeros
// past kend or n
__device__ __forceinline__ void stage_w16(unsigned char* dst,
                                          const int8_t* __restrict__ w,
                                          int n, int kend, int kr, int c,
                                          bool vec) {
  if (vec) {
    const bool ok = kr < kend && c < n;
    cp_async16(smem_u32(dst), ok ? w + (size_t)kr * n + c : w, ok);
    return;
  }
  uint32_t v[4] = {0, 0, 0, 0};
  if (kr < kend) {
#pragma unroll
    for (int j = 0; j < 16; ++j)
      if (c + j < n)
        v[j >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(
                         w[(size_t)kr * n + c + j]))
                     << (8 * (j & 3));
  }
  *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
}

// ------------------------------------------------------ 0. decode route

// stage s of this block's split into slot s % DEC_STAGES of the ring:
// the int8 weight tile of k rows [k0, k0 + DEC_BK) of the slab at column
// n0, then rows [0, R) of x for the same k (zeros past m and k). Split z
// of S takes stages z, z + S, z + 2S, ...: at any moment the blocks read
// neighbouring rows of k, a compact front through the weight. One
// commit group a stage, empty past nst.
template <typename XT, int R>
__device__ __forceinline__ void dec_load(unsigned char* ring,
                                         const XT* __restrict__ x,
                                         const int8_t* __restrict__ w,
                                         int m, int n, int k, int n0, int nst,
                                         int s, bool vec_x, bool vec_w) {
  if (s < nst) {
    unsigned char* dst = ring + (s % DEC_STAGES) * dec_stage<XT, R>();
    const int k0 = (s * static_cast<int>(gridDim.y) + blockIdx.y) * DEC_BK;
#pragma unroll
    for (int it = 0; it < DEC_BK * DEC_BN / 16 / NT; ++it) {
      const int idx = threadIdx.x + it * NT;
      const int r = idx / (DEC_BN / 16), c = (idx % (DEC_BN / 16)) * 16;
      stage_w16(dst + r * DEC_LD + c, w, n, k, k0 + r, n0 + c, vec_w);
    }
    constexpr int XV = 16 / sizeof(XT);  // elements a 16-byte chunk
    constexpr int XC = DEC_BK / XV;      // chunks a row
    static_assert(R * XC <= NT, "one x chunk a thread at most");
    const int idx = threadIdx.x;
    if (idx < R * XC) {
      const int r = idx / XC, c = (idx % XC) * XV;
      unsigned char* xd = dst + DEC_W + (r * dec_xld<XT>() + c) * sizeof(XT);
      if (vec_x) {  // k is a multiple of XV: a chunk is wholly in or out
        const bool ok = r < m && k0 + c < k;
        cp_async16(smem_u32(xd), ok ? x + (size_t)r * k + k0 + c : x, ok);
      } else {
        uint4 u;
        XT* v = reinterpret_cast<XT*>(&u);
#pragma unroll
        for (int j = 0; j < XV; ++j)
          v[j] = r < m && k0 + c + j < k ? x[(size_t)r * k + k0 + c + j]
                                         : static_cast<XT>(0);
        *reinterpret_cast<uint4*>(xd) = u;
      }
    }
  }
  cp_commit();
}

// how many stages of k the block's split takes (see dec_load)
__device__ __forceinline__ int dec_nst(int k) {
  const int splits = gridDim.y, z = blockIdx.y;
  return ((k + DEC_BK - 1) / DEC_BK - z + splits - 1) / splits;
}

// cluster barriers: every thread of every block of the cluster arrives,
// then waits for all; release/acquire order the shared-memory writes
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// A decode block's sums for outputs e = i DEC_BN + c, i < m, c <
// DEC_BN, of the slab at column n0: `each(f)` calls f(e, sum) for every
// such output the thread holds. With one split they are scaled and
// rounded. With several, the splits of the slab form one cluster (a
// first barrier phase, arrived at the kernel's start, shows every block
// running); each block pushes its sums into the inbox of the block that
// owns the output (block r owns a share of the outputs), and after one
// barrier each block adds its share over the splits in split order, so
// the sum is the same whichever block adds it: no float atomics, no
// global partials, and no block reads another's memory after it.
template <typename OT, typename F>
__device__ __forceinline__ void dec_finish(float* inbox, F each,
                                           const float* __restrict__ scale,
                                           OT* __restrict__ out, int m,
                                           int n, int n0) {
  const int splits = gridDim.y, z = blockIdx.y, total = m * DEC_BN;
  if (splits == 1) {
    each([&](int e, float v) {
      const int col = n0 + e % DEC_BN;
      if (col < n)
        out[(size_t)(e / DEC_BN) * n + col] = to_out<OT>(v * scale[col]);
    });
    return;
  }
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int share = (total + splits - 1) / splits;
  cluster_wait();  // every block of the cluster has started
  each([&](int e, float v) {
    const int r = e / share;
    cluster.map_shared_rank(inbox, r)[z * share + e - r * share] = v;
  });
  cluster_arrive();
  cluster_wait();  // every push has landed
  const int e0 = z * share, e1 = min(total, e0 + share);
  for (int e = e0 + threadIdx.x; e < e1; e += NT) {
    const int col = n0 + e % DEC_BN;
    float s = 0.f;
    for (int zz = 0; zz < splits; ++zz) s += inbox[zz * share + e - e0];
    if (col < n) out[(size_t)(e / DEC_BN) * n + col] = to_out<OT>(s * scale[col]);
  }
}

// SIMT, for an fp32 x: each warp takes 8 rows of every stage, a lane 4
// columns and MR rows of x
template <typename OT, int MR>
__global__ void __launch_bounds__(NT, MR <= 8 ? 3 : 2)
    q8_decode_kernel(const float* __restrict__ x,
                     const int8_t* __restrict__ w,
                     const float* __restrict__ scale, OT* __restrict__ out,
                     int m, int n, int k, int vec_x, int vec_w,
                     long long xstride) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int STAGE = dec_stage<float, MR>(), XLD = dec_xld<float>();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // this block's expert (grid z): its x rows, weight, scale and output
  x += blockIdx.z * xstride;
  w += (size_t)blockIdx.z * k * n;
  scale += (size_t)blockIdx.z * n;
  out += (size_t)blockIdx.z * m * n;
  const int n0 = blockIdx.x * DEC_BN;
  const int nst = dec_nst(k);
  if (gridDim.y > 1) cluster_arrive_relaxed();  // waited for in dec_finish

#pragma unroll
  for (int s = 0; s < DEC_STAGES - 1; ++s)
    dec_load<float, MR>(smem, x, w, m, n, k, n0, nst, s, vec_x, vec_w);

  float acc[MR][4];
#pragma unroll
  for (int i = 0; i < MR; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;

  for (int t = 0; t < nst; ++t) {
    cp_wait<DEC_STAGES - 2>();  // stage t has landed
    __syncthreads();            // and every warp is done with stage t - 1
    dec_load<float, MR>(smem, x, w, m, n, k, n0, nst, t + DEC_STAGES - 1,
                        vec_x, vec_w);
    const unsigned char* st = smem + (t % DEC_STAGES) * STAGE;
    const float* xs = reinterpret_cast<const float*>(st + DEC_W);
#pragma unroll
    for (int g = 0; g < DEC_BK / DEC_WARPS / 4; ++g) {
      const int r0 = warp * (DEC_BK / DEC_WARPS) + g * 4;
      float q[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        q4_to_f32(*reinterpret_cast<const uint32_t*>(
                      st + (r0 + r) * DEC_LD + lane * 4),
                  q[r]);
#pragma unroll
      for (int i = 0; i < MR; ++i) {
        const float4 xv =
            *reinterpret_cast<const float4*>(xs + i * XLD + r0);
        const float xa[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            acc[i][c] = fmaf(xa[r], q[r][c], acc[i][c]);
      }
    }
  }

  // the warps' sums, added in warp order
  cp_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);  // [WARPS][MR][BN]
#pragma unroll
  for (int i = 0; i < MR; ++i)
    *reinterpret_cast<float4*>(red + (warp * MR + i) * DEC_BN + lane * 4) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  __syncthreads();
  dec_finish<OT>(
      reinterpret_cast<float*>(smem + dec_inbox_at<float, MR>()),
      [&](auto f) {
        for (int e = tid; e < m * DEC_BN; e += NT) {
          float s = 0.f;
#pragma unroll
          for (int wp = 0; wp < DEC_WARPS; ++wp)
            s += red[wp * MR * DEC_BN + e];
          f(e, s);
        }
      },
      scale, out, m, n, n0);
}

// tensor cores, for a bf16 x: out^T = W^T . x^T, so the weight is the A
// operand (16 output columns x 16 k) and x^T the B operand, whose n8 is
// the batch: NB tiles of 8 rows. Each warp owns 16 of the block's 128
// columns over the whole split, so the warps never meet. A is built in
// registers from the raw int8 stage: within each 16 rows of k, logical
// k pair (2t, 2t+1) is physical rows (t, t + 4) and (2t + 8, 2t + 9) is
// (t + 8, t + 12), so a lane reads its two adjacent columns (2g, 2g + 1)
// of four rows as four 16-bit words (rows 144 bytes apart: no bank
// conflict), converts them exactly to bf16 and pairs them; B reads the
// staged x with the same permutation.
template <typename OT, int NB>
__global__ void __launch_bounds__(NT, 3)
    q8_decode_tc_kernel(const uint16_t* __restrict__ x,
                        const int8_t* __restrict__ w,
                        const float* __restrict__ scale, OT* __restrict__ out,
                        int m, int n, int k, int vec_x, int vec_w,
                        long long xstride) {
  extern __shared__ __align__(16) unsigned char smem[];
  // this block's expert (grid z): its x rows, weight, scale and output
  x += blockIdx.z * xstride;
  w += (size_t)blockIdx.z * k * n;
  scale += (size_t)blockIdx.z * n;
  out += (size_t)blockIdx.z * m * n;
  constexpr int R = NB * 8, STAGE = dec_stage<uint16_t, R>();
  constexpr int XLD = dec_xld<uint16_t>();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int n0 = blockIdx.x * DEC_BN;
  const int nst = dec_nst(k);
  if (gridDim.y > 1) cluster_arrive_relaxed();  // waited for in dec_finish

#pragma unroll
  for (int s = 0; s < DEC_STAGES - 1; ++s)
    dec_load<uint16_t, R>(smem, x, w, m, n, k, n0, nst, s, vec_x, vec_w);

  float acc[NB][4];
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[b][e] = 0.f;

  const int colw = warp * 16;
  for (int t = 0; t < nst; ++t) {
    cp_wait<DEC_STAGES - 2>();
    __syncthreads();
    dec_load<uint16_t, R>(smem, x, w, m, n, k, n0, nst,
                          t + DEC_STAGES - 1, vec_x, vec_w);
    const unsigned char* st = smem + (t % DEC_STAGES) * STAGE;
    const uint16_t* xs = reinterpret_cast<const uint16_t*>(st + DEC_W);
#pragma unroll
    for (int kk = 0; kk < DEC_BK; kk += 16) {
      const unsigned char* wp = st + (kk + tig) * DEC_LD + colw + 2 * gid;
      uint32_t wr[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wr[j] = *reinterpret_cast<const uint16_t*>(wp + 4 * j * DEC_LD);
      // bytes (col 2g, col 2g + 1) of rows j, j + 1, as fp32
      float f01[4], f23[4];
      q4_to_f32(__byte_perm(wr[0], wr[1], 0x5410), f01);
      q4_to_f32(__byte_perm(wr[2], wr[3], 0x5410), f23);
      const uint32_t a[4] = {bf16_pair(f01[0], f01[2]),
                             bf16_pair(f01[1], f01[3]),
                             bf16_pair(f23[0], f23[2]),
                             bf16_pair(f23[1], f23[3])};
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        const uint16_t* xr = xs + (b * 8 + gid) * XLD + kk + tig;
        mma(acc[b], a, xr[0] | static_cast<uint32_t>(xr[4]) << 16,
            xr[8] | static_cast<uint32_t>(xr[12]) << 16);
      }
    }
  }
  // acc[b][e]: column colw + 2 gid + (e >> 1), batch row 8 b + 2 tig +
  // (e & 1)
  cp_wait<0>();
  dec_finish<OT>(
      reinterpret_cast<float*>(smem + dec_inbox_at<uint16_t, R>()),
      [&](auto f) {
#pragma unroll
        for (int b = 0; b < NB; ++b)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = b * 8 + 2 * tig + (e & 1);
            if (i < m)
              f(i * DEC_BN + colw + 2 * gid + (e >> 1), acc[b][e]);
          }
      },
      scale, out, m, n, n0);
}

// ---------------------------------------------- 1. tensor cores, bf16 x

template <typename OT>
__device__ __forceinline__ void store_pair(OT* __restrict__ out,
                                           const float* __restrict__ scale,
                                           float* __restrict__ part, int m,
                                           int n, int r, int c, float v0,
                                           float v1, int z, bool split) {
  if (r >= m) return;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int cc = c + j;
    if (cc >= n) continue;
    const float v = j ? v1 : v0;
    if (split)
      part[((size_t)z * m + r) * n + cc] = v;
    else
      out[(size_t)r * n + cc] = to_out<OT>(v * scale[cc]);
  }
}

template <typename OT>
__global__ void __launch_bounds__(NT)
    q8_tc_kernel(const uint16_t* __restrict__ x, const int8_t* __restrict__ w,
                 const float* __restrict__ scale, OT* __restrict__ out,
                 float* __restrict__ part, int m, int n, int k, int kps,
                 int vec_x, int vec_w, int splits, long long xstride) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;  // 2 x 4 warps of 64 x 32
  const int n0 = blockIdx.x * TILE_N, m0 = blockIdx.y * TILE_M;
  const int z = blockIdx.z % splits, ex = blockIdx.z / splits;
  x += ex * xstride;  // this block's expert (see the decode kernels)
  w += (size_t)ex * k * n;
  scale += (size_t)ex * n;
  out += (size_t)ex * m * n;
  const bool split = splits > 1;
  if (split) part += (size_t)ex * splits * m * n;
  const int kbeg = z * kps, kend = min(k, kbeg + kps);
  const int nkt = kend > kbeg ? (kend - kbeg + TILE_K - 1) / TILE_K : 0;
  unsigned char* wb = smem + TC_STAGES * TC_STAGE;  // bf16 [TILE_K][WLD]
  const uint32_t s_wb = smem_u32(wb);

  auto load = [&](int t) {
    if (t < nkt) {
      unsigned char* st = smem + (t % TC_STAGES) * TC_STAGE;
      const int k0 = kbeg + t * TILE_K;
#pragma unroll
      for (int it = 0; it < TILE_M * TILE_K / 8 / NT; ++it) {  // x: 8 bf16
        const int idx = tid + it * NT;
        const int r = idx / (TILE_K / 8), c = (idx % (TILE_K / 8)) * 8;
        const int row = m0 + r, kc = k0 + c;
        unsigned char* dst = st + (r * TC_XLD + c) * 2;
        if (vec_x) {
          const bool ok = row < m && kc < kend;
          cp_async16(smem_u32(dst), ok ? x + (size_t)row * k + kc : x, ok);
        } else {
          uint32_t v[4] = {0, 0, 0, 0};
#pragma unroll
          for (int j = 0; j < 8; ++j)
            if (row < m && kc + j < kend)
              v[j >> 1] |= static_cast<uint32_t>(x[(size_t)row * k + kc + j])
                           << (16 * (j & 1));
          *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
        }
      }
#pragma unroll
      for (int it = 0; it < TC_RAW / 16 / NT; ++it) {  // w: 16 int8
        const int idx = tid + it * NT;
        const int r = idx / (TILE_N / 16), c = (idx % (TILE_N / 16)) * 16;
        stage_w16(st + TC_XT + r * TILE_N + c, w, n, kend, k0 + r, n0 + c,
                  vec_w);
      }
    }
    cp_commit();
  };

  float acc[4][4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[a][b][e] = 0.f;

  // lane offsets: A (x, row-major) and B (weights [k][n], .trans)
  const uint32_t oa = ((wm * 64 + (lane & 15)) * TC_XLD + (lane >> 4) * 8) * 2;
  const uint32_t ob = (((lane & 7) + ((lane >> 3) & 1) * 8) * TC_WLD +
                       wn * 32 + (lane >> 4) * 8) * 2;

#pragma unroll
  for (int s = 0; s < TC_STAGES - 1; ++s) load(s);
  for (int t = 0; t < nkt; ++t) {
    cp_wait<TC_STAGES - 2>();  // tile t has landed
    __syncthreads();           // every warp is done with tile t - 1
    load(t + TC_STAGES - 1);
    const unsigned char* st = smem + (t % TC_STAGES) * TC_STAGE;
    {  // int8 -> bf16, exact: 16 weights a thread
      const int r = tid / (TILE_N / 16), c = (tid % (TILE_N / 16)) * 16;
      const uint4 raw =
          *reinterpret_cast<const uint4*>(st + TC_XT + r * TILE_N + c);
      const uint32_t rw[4] = {raw.x, raw.y, raw.z, raw.w};
      uint32_t o[8];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float f[4];
        q4_to_f32(rw[q], f);
        o[2 * q] = bf16_pair(f[0], f[1]);
        o[2 * q + 1] = bf16_pair(f[2], f[3]);
      }
      uint4* d = reinterpret_cast<uint4*>(wb + (r * TC_WLD + c) * 2);
      d[0] = make_uint4(o[0], o[1], o[2], o[3]);
      d[1] = make_uint4(o[4], o[5], o[6], o[7]);
    }
    __syncthreads();
    const uint32_t s_x = smem_u32(st);
#pragma unroll
    for (int kk = 0; kk < TILE_K; kk += 16) {
      uint32_t a[4][4], b[2][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldsm_x4(a[mi], s_x + oa + (mi * 16 * TC_XLD + kk) * 2);
#pragma unroll
      for (int nj = 0; nj < 2; ++nj)
        ldsm_x4_t(b[nj], s_wb + ob + (kk * TC_WLD + nj * 16) * 2);
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma(acc[mi][ni], a[mi], b[ni >> 1][(ni & 1) * 2],
              b[ni >> 1][(ni & 1) * 2 + 1]);
    }
  }
  cp_wait<0>();

  const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int r = m0 + wm * 64 + mi * 16 + gid;
      const int c = n0 + wn * 32 + ni * 8 + 2 * tig;
      store_pair<OT>(out, scale, part, m, n, r, c, acc[mi][ni][0],
                     acc[mi][ni][1], z, split);
      store_pair<OT>(out, scale, part, m, n, r + 8, c, acc[mi][ni][2],
                     acc[mi][ni][3], z, split);
    }
}

// --------------------------------------------------- 2. SIMT tile, fp32 x
// (the first port's general tile)

union V16 {
  uint4 v;
  uint32_t w[4];
};

// element j of a 16-byte vector as fp32
template <typename XT>
__device__ __forceinline__ float x_at(const V16& u, int j);
template <>
__device__ __forceinline__ float x_at<float>(const V16& u, int j) {
  return __uint_as_float(u.w[j]);
}

__device__ __forceinline__ float q_at(const V16& u, int j) {
  return static_cast<float>(
      static_cast<int8_t>(u.w[j >> 2] >> (8 * (j & 3))));
}

template <typename XT>
__device__ __forceinline__ uint32_t x_bits(XT e);
template <>
__device__ __forceinline__ uint32_t x_bits<float>(float e) {
  return __float_as_uint(e);
}

// 16 bytes of row i of x from column kc; zeros past m or kend
template <typename XT>
__device__ __forceinline__ V16 load_x(const XT* __restrict__ x, int m, int k,
                                      int kend, int i, int kc, bool vec) {
  constexpr int N = 16 / sizeof(XT);
  V16 u;
  if (vec && i < m && kc < kend) {
    u.v = __ldg(reinterpret_cast<const uint4*>(x + (size_t)i * k + kc));
    return u;
  }
  u.v = make_uint4(0, 0, 0, 0);
#pragma unroll
  for (int j = 0; j < N; ++j) {
    if (i < m && kc + j < kend) {
      const uint32_t b = x_bits<XT>(x[(size_t)i * k + kc + j]);
      u.w[j * sizeof(XT) / 4] |= b << (8 * ((j * sizeof(XT)) & 3));
    }
  }
  return u;
}

// 16 int8 weights of row kr from column c; zeros past kend or n
__device__ __forceinline__ V16 load_w(const int8_t* __restrict__ w, int n,
                                      int kend, int kr, int c, bool vec) {
  V16 u;
  if (vec && kr < kend && c < n) {
    u.v = __ldg(reinterpret_cast<const uint4*>(w + (size_t)kr * n + c));
    return u;
  }
  u.v = make_uint4(0, 0, 0, 0);
  if (kr < kend) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      if (c + j < n) {
        const uint32_t b = static_cast<uint8_t>(w[(size_t)kr * n + c + j]);
        u.w[j >> 2] |= b << (8 * (j & 3));
      }
    }
  }
  return u;
}

template <typename XT, typename OT, int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__(NT)
    q8_matmul_kernel(const XT* __restrict__ x, const int8_t* __restrict__ w,
                     const float* __restrict__ scale, OT* __restrict__ out,
                     float* __restrict__ part, int m, int n, int k, int kps,
                     int vec_x, int vec_w, int splits, long long xstride) {
  constexpr int TX = BN / TN;  // threads along n
  static_assert(TX * (BM / TM) == NT, "tile does not match the block");
  static_assert(TN % 4 == 0, "columns come in groups of 4");
  constexpr int RG = TM < 4 ? TM : 4;
  constexpr int XN = 16 / sizeof(XT);  // x elements a vector
  constexpr int XROW = BK / XN;        // x vectors a tile row
  constexpr int WROW = BN / 16;        // weight vectors a tile row
  constexpr int NXV = BM * XROW;
  constexpr int NWV = BK * WROW;
  constexpr int XPT = (NXV + NT - 1) / NT;
  constexpr int WPT = (NWV + NT - 1) / NT;
  constexpr int XS = BM + 4;  // padded row of the k-major x tile

  __shared__ __align__(16) float xs[BK][XS];
  __shared__ __align__(16) float ws[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int z = blockIdx.z % splits, ex = blockIdx.z / splits;
  x += ex * xstride;  // this block's expert (see the decode kernels)
  w += (size_t)ex * k * n;
  scale += (size_t)ex * n;
  out += (size_t)ex * m * n;
  const bool split = splits > 1;
  if (split) part += (size_t)ex * splits * m * n;
  const int kbeg = z * kps;
  const int kend = min(k, kbeg + kps);

  auto row_of = [&](int i) {
    return (i / RG) * (BM / (TM / RG)) + ty * RG + i % RG;
  };
  auto col_of = [&](int j) {
    return (j / 4) * (BN / (TN / 4)) + tx * 4 + j % 4;
  };

  bool live[TM / RG];  // row groups with a row inside m
#pragma unroll
  for (int g = 0; g < TM / RG; ++g) live[g] = m0 + row_of(g * RG) < m;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  V16 xr[XPT], wr[WPT];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int p = 0; p < XPT; ++p) {
      const int v = tid + p * NT;
      if (NXV % NT == 0 || v < NXV)
        xr[p] = load_x<XT>(x, m, k, kend, m0 + v / XROW,
                           k0 + (v % XROW) * XN, vec_x);
    }
#pragma unroll
    for (int p = 0; p < WPT; ++p) {
      const int v = tid + p * NT;
      if (NWV % NT == 0 || v < NWV)
        wr[p] = load_w(w, n, kend, k0 + v / WROW, n0 + (v % WROW) * 16,
                       vec_w);
    }
  };
  auto stash = [&]() {
#pragma unroll
    for (int p = 0; p < XPT; ++p) {
      const int v = tid + p * NT;
      if (NXV % NT == 0 || v < NXV) {
        const int r = v / XROW, kc = (v % XROW) * XN;
#pragma unroll
        for (int j = 0; j < XN; ++j) xs[kc + j][r] = x_at<XT>(xr[p], j);
      }
    }
#pragma unroll
    for (int p = 0; p < WPT; ++p) {
      const int v = tid + p * NT;
      if (NWV % NT == 0 || v < NWV) {
        const int r = v / WROW, c = (v % WROW) * 16;
#pragma unroll
        for (int q = 0; q < 4; ++q)
          *reinterpret_cast<float4*>(&ws[r][c + 4 * q]) =
              make_float4(q_at(wr[p], 4 * q), q_at(wr[p], 4 * q + 1),
                          q_at(wr[p], 4 * q + 2), q_at(wr[p], 4 * q + 3));
      }
    }
  };

  if (kbeg < kend) fetch(kbeg);
  for (int k0 = kbeg; k0 < kend; k0 += BK) {
    stash();
    __syncthreads();
    if (k0 + BK < kend) fetch(k0 + BK);  // in flight during the products
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      float b[TN];
#pragma unroll
      for (int j = 0; j < TN; j += 4) {
        const float4 f = *reinterpret_cast<const float4*>(&ws[kk][col_of(j)]);
        b[j] = f.x;
        b[j + 1] = f.y;
        b[j + 2] = f.z;
        b[j + 3] = f.w;
      }
#pragma unroll
      for (int g = 0; g < TM / RG; ++g) {
        if (!live[g]) continue;
        float a[RG];
        if constexpr (RG == 4) {
          const float4 f =
              *reinterpret_cast<const float4*>(&xs[kk][row_of(g * RG)]);
          a[0] = f.x;
          a[1] = f.y;
          a[2] = f.z;
          a[3] = f.w;
        } else {
#pragma unroll
          for (int i = 0; i < RG; ++i) a[i] = xs[kk][row_of(g * RG + i)];
        }
#pragma unroll
        for (int i = 0; i < RG; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j)
            acc[g * RG + i][j] = fmaf(a[i], b[j], acc[g * RG + i][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = m0 + row_of(i);
    if (r >= m) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = n0 + col_of(j);
      if (c >= n) continue;
      if (split)
        part[((size_t)z * m + r) * n + c] = acc[i][j];
      else
        out[(size_t)r * n + c] = to_out<OT>(acc[i][j] * scale[c]);
    }
  }
}

// routes 1 and 2: the split-K partials [experts, splits, m, n], added in
// split order, then the scale and one rounding
template <typename OT>
__global__ void __launch_bounds__(NT)
    q8_combine_kernel(const float* __restrict__ part,
                      const float* __restrict__ scale, OT* __restrict__ out,
                      int m, int n, int splits, int experts) {
  const size_t mn = (size_t)m * n, total = mn * experts;
  for (size_t e = (size_t)blockIdx.x * NT + threadIdx.x; e < total;
       e += (size_t)gridDim.x * NT) {
    const size_t ex = e / mn, r = e - ex * mn;
    const float* p = part + ex * splits * mn + r;
    float s = 0.f;
    for (int z = 0; z < splits; ++z) s += p[z * mn];
    out[e] = to_out<OT>(s * scale[ex * n + r % n]);
  }
}

// ------------------------------------------------------------ launches

template <typename K>
cudaError_t allow_smem(K kern, int smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem);
}

template <typename K>
int resources(K kern, int smem, int* smem_out, int* blocks) {
  cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  *smem_out = smem;
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kern, NT, smem));
}

// rows of x the SIMT decode kernel is instantiated for, at or above m
constexpr int dec_rows(int m) {
  return m <= 1 ? 1 : m <= 4 ? 4 : m <= 8 ? 8 : 16;
}

// a decode launch: a cluster of the K splits of each column slab
template <typename K, typename... A>
int launch_dec(K kern, int smem, int n, int splits, int experts,
               cudaStream_t st, A... args) {
  cudaError_t e = allow_smem(kern, smem);
  if (e == cudaSuccess && splits > 8)
    e = cudaFuncSetAttribute(kern,
                             cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((n + DEC_BN - 1) / DEC_BN, splits, experts);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = splits;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, kern, args...));
}

template <typename XT, typename OT>
int launch(int route, const void* xv, const void* wv, const void* sv,
           void* ov, void* pv, int experts, long long xs, int m, int n,
           int k, int splits, int kps, cudaStream_t st) {
  const XT* x = static_cast<const XT*>(xv);
  const int8_t* w = static_cast<const int8_t*>(wv);
  const float* scale = static_cast<const float*>(sv);
  OT* out = static_cast<OT*>(ov);
  float* part = static_cast<float*>(pv);
  const int vec_w =
      (n % 16 == 0) && (reinterpret_cast<uintptr_t>(w) % 16 == 0);
  const int vec_x = (k % (16 / (int)sizeof(XT)) == 0) &&
                    (reinterpret_cast<uintptr_t>(x) % 16 == 0);
  if (route == 0) {
    if (m > DEC_ROWS || splits > DEC_MAX_SPLITS) return -1;
    if constexpr (sizeof(XT) == 2) {  // bf16 x: tensor cores
      if (m <= 8)
        return launch_dec(q8_decode_tc_kernel<OT, 1>,
                          dec_smem<uint16_t, 8>(), n, splits, experts, st, x,
                          w, scale, out, m, n, k, vec_x, vec_w, xs);
      return launch_dec(q8_decode_tc_kernel<OT, 2>, dec_smem<uint16_t, 16>(),
                        n, splits, experts, st, x, w, scale, out, m, n, k,
                        vec_x, vec_w, xs);
    } else {  // fp32 x: SIMT
      switch (dec_rows(m)) {
        case 1:
          return launch_dec(q8_decode_kernel<OT, 1>, dec_smem<float, 1>(), n,
                            splits, experts, st, x, w, scale, out, m, n, k,
                            vec_x, vec_w, xs);
        case 4:
          return launch_dec(q8_decode_kernel<OT, 4>, dec_smem<float, 4>(), n,
                            splits, experts, st, x, w, scale, out, m, n, k,
                            vec_x, vec_w, xs);
        case 8:
          return launch_dec(q8_decode_kernel<OT, 8>, dec_smem<float, 8>(), n,
                            splits, experts, st, x, w, scale, out, m, n, k,
                            vec_x, vec_w, xs);
        default:
          return launch_dec(q8_decode_kernel<OT, 16>, dec_smem<float, 16>(),
                            n, splits, experts, st, x, w, scale, out, m, n,
                            k, vec_x, vec_w, xs);
      }
    }
  }
  if (kps % TILE_K != 0) return -1;
  const dim3 grid((n + TILE_N - 1) / TILE_N, (m + TILE_M - 1) / TILE_M,
                  splits * experts);
  if constexpr (sizeof(XT) == 2) {
    if (route != 1) return -1;
    auto kern = q8_tc_kernel<OT>;
    cudaError_t e = allow_smem(kern, TC_SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    kern<<<grid, NT, TC_SMEM, st>>>(x, w, scale, out, part, m, n, k, kps,
                                    vec_x, vec_w, splits, xs);
  } else {
    if (route != 2) return -1;
    q8_matmul_kernel<float, OT, TILE_M, TILE_N, TILE_K, 8, 8>
        <<<grid, NT, 0, st>>>(x, w, scale, out, part, m, n, k, kps, vec_x,
                              vec_w, splits, xs);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return static_cast<int>(e);
  const size_t total = (size_t)m * n * experts;
  const int blocks =
      (int)((total + NT - 1) / NT < 8192 ? (total + NT - 1) / NT : 8192);
  q8_combine_kernel<OT><<<blocks, NT, 0, st>>>(part, scale, out, m, n,
                                               splits, experts);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The route a call takes (x_code 0 = float32, 1 = bfloat16): 0 = decode
// (m <= DEC_ROWS), 1 = tensor cores (bf16 x above it), 2 = SIMT tile
// (fp32 x above it); -1 for an x type the kernels are not built for.
extern "C" int tony_q8_matmul_route(int x_code, int m) {
  if (x_code != 0 && x_code != 1) return -1;
  if (m <= DEC_ROWS) return 0;
  return x_code == 1 ? 1 : 2;
}

// dtype codes: 0 = float32, 1 = bfloat16. For each of `experts` experts
// e: x_e [m, k] (x + e * x_stride elements; x_stride 0 reads one x for
// every expert), w [e][k, n] int8, scale [e][n] fp32 and out [e][m, n],
// all contiguous device arrays. `route` is tony_q8_matmul_route's, with
// `splits` K splits an expert. On route 0 split z of S takes the
// DEC_BK-row stages z, z + S, ..., and S is at most DEC_MAX_SPLITS (one
// cluster); `kps` is unused. On routes 1 and 2 a split is `kps` rows, a
// multiple of TILE_K, and with splits > 1 `part` is fp32 scratch of
// experts * splits * m * n elements (else unused). One launch (two with
// the split-K combine) for every expert. Returns the launch's CUDA error
// (0 = launched), or -1 for arguments the kernels are not built for.
extern "C" int tony_q8_matmul_experts(int x_code, int out_code,
                                      const void* x, const void* w,
                                      const void* scale, void* out,
                                      void* part, int experts,
                                      long long x_stride, int m, int n,
                                      int k, int route, int splits, int kps,
                                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route != tony_q8_matmul_route(x_code, m) || splits < 1 ||
      experts < 1 || experts > 65535 || (long long)splits * experts > 65535)
    return -1;
  if (x_code == 0 && out_code == 0)
    return launch<float, float>(route, x, w, scale, out, part, experts,
                                x_stride, m, n, k, splits, kps, st);
  if (x_code == 0 && out_code == 1)
    return launch<float, __nv_bfloat16>(route, x, w, scale, out, part,
                                        experts, x_stride, m, n, k, splits,
                                        kps, st);
  if (x_code == 1 && out_code == 0)
    return launch<uint16_t, float>(route, x, w, scale, out, part, experts,
                                   x_stride, m, n, k, splits, kps, st);
  if (x_code == 1 && out_code == 1)
    return launch<uint16_t, __nv_bfloat16>(route, x, w, scale, out, part,
                                           experts, x_stride, m, n, k,
                                           splits, kps, st);
  return -1;
}

// One matrix: x [m, k], w [k, n] int8, scale [n] fp32, out [m, n]; as
// tony_q8_matmul_experts with one expert.
extern "C" int tony_q8_matmul(int x_code, int out_code, const void* x,
                              const void* w, const void* scale, void* out,
                              void* part, int m, int n, int k, int route,
                              int splits, int kps, void* stream) {
  return tony_q8_matmul_experts(x_code, out_code, x, w, scale, out, part, 1,
                                0, m, n, k, route, splits, kps, stream);
}

// The tile constants the wrapper's plan mirrors: 0 DEC_ROWS, 1 DEC_BN,
// 2 DEC_BK, 3 DEC_STAGES, 4 DEC_MAX_SPLITS, 5 TILE_M, 6 TILE_N, 7 TILE_K,
// 8 DEC_BLOCKS_PER_SM.
extern "C" int tony_q8_matmul_const(int which) {
  const int c[] = {DEC_ROWS, DEC_BN, DEC_BK, DEC_STAGES, DEC_MAX_SPLITS,
                   TILE_M, TILE_N, TILE_K, DEC_BLOCKS_PER_SM};
  return which >= 0 && which < 9 ? c[which] : -1;
}

// An instance's dynamic shared memory (bytes) and blocks per SM, each
// with a bf16 output: route 0 (decode) for an fp32 x (SIMT) with `rows`
// = 1, 4, 8 or 16 x rows, or for a bf16 x (tensor cores) with 8 or 16;
// route 1 (tensor cores, bf16 x); route 2 (SIMT tile, fp32 x). Returns a
// CUDA error, or -1 for an instance that is not built.
extern "C" int tony_q8_matmul_resources(int route, int x_code, int rows,
                                        int* smem_bytes,
                                        int* blocks_per_sm) {
  using bf16 = __nv_bfloat16;
  int* sb = smem_bytes;
  int* bp = blocks_per_sm;
  if (route == 0 && x_code == 0) {
    switch (rows) {
      case 1:
        return resources(q8_decode_kernel<bf16, 1>, dec_smem<float, 1>(), sb,
                         bp);
      case 4:
        return resources(q8_decode_kernel<bf16, 4>, dec_smem<float, 4>(), sb,
                         bp);
      case 8:
        return resources(q8_decode_kernel<bf16, 8>, dec_smem<float, 8>(), sb,
                         bp);
      case 16:
        return resources(q8_decode_kernel<bf16, 16>, dec_smem<float, 16>(),
                         sb, bp);
      default:
        return -1;
    }
  }
  if (route == 0 && x_code == 1 && rows == 8)
    return resources(q8_decode_tc_kernel<bf16, 1>, dec_smem<uint16_t, 8>(),
                     sb, bp);
  if (route == 0 && x_code == 1 && rows == 16)
    return resources(q8_decode_tc_kernel<bf16, 2>, dec_smem<uint16_t, 16>(),
                     sb, bp);
  if (route == 1 && x_code == 1)
    return resources(q8_tc_kernel<bf16>, TC_SMEM, sb, bp);
  if (route == 2 && x_code == 0)
    return resources(q8_matmul_kernel<float, bf16, TILE_M, TILE_N, TILE_K,
                                      8, 8>,
                     0, sb, bp);
  return -1;
}
