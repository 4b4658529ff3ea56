// Flash-decode on Hopper: single-query attention over a KV cache.
//
// Replaces the two Pallas TPU kernels of tony_tpu/ops/decode.py,
// _decode_kernel (the GQA form) and _decode_kernel_mha (the MHA form):
// both compute one function, so there is one function here, in two
// routes.
//
//   q [B, H, D] (fp32 or bf16), k/v [B, S, KVH, D] in the NATIVE cache
//   layout (fp32, bf16, or int8 with fp32 scales [B, S, KVH]),
//   length [B] int32  ->  out [B, H, D] in q's dtype.
//   Key p is visible iff p < length[b] and, with window > 0,
//   p >= length[b] - window; a length past S sees all S positions and a
//   negative one none. Head h reads KV head h / (H / KVH). A row with
//   length 0 gives exact zeros (the serving engine's empty and frozen
//   slots rely on it).
//
// What bounds it on an H100: bytes. Each visible K/V row (plus its two
// int8 scales) is read once per KV head; the work is ~4 flops per byte
// of bf16 cache, far below the ~295 flops/byte at which the tensor
// cores would limit. The least time is the visible extent's K+V(+scale)
// bytes over 3.35 TB/s. So the design aims at keeping loads in flight
// and the instructions per byte few.
//
// Common to both routes:
// - one block per (KV head, batch row, KV split) holding the query group
//   of that KV head (G = H / KVH rows, G = 6 for Qwen2.5-1.5B): K/V are
//   read once for the group and never repeated;
// - split-KV: B * KVH blocks alone (16 at batch 8 of Qwen2.5-1.5B) would
//   leave most of the 132 SMs idle, so each row's visible range
//   [window start, length) is cut into `nsplit` TK-aligned pieces, one
//   block each; every block writes its partial (max, sum, accumulator)
//   and a second kernel combines them in split order (flash-decoding;
//   deterministic). The wrapper picks nsplit; with nsplit == 1 the block
//   writes the output itself;
// - nothing before the window start or at/after the length is read, so
//   any S works; int8 scales fold onto the scores and the probabilities,
//   as the TPU MHA kernel folds them; p stays fp32 in precision.
//
// The tensor-core route (flash_decode_tc: a bf16 q over a bf16 or int8
// cache, D = 64 or 128):
// - Q.K^T is mma.sync.m16n8k16 (bf16, fp32 sums): the group's query rows
//   are the A operand, padded to 16 rows in registers (G > 16 takes one
//   block per 16 rows), loaded once; K is the B operand by ldmatrix;
// - K/V tiles of TK keys are double-buffered by cp.async (16 bytes a
//   thread, rows past the length zero-filled) into [TK][D + 8] bf16
//   tiles (a third buffer measured no faster); an int8 tile lands as int8
//   with its scales and is converted to bf16 in shared memory (every int8
//   value is exact in bf16);
// - each of the 4 warps owns 16 keys of every tile with its own online
//   softmax (m, l per row over the quad of lanes that shares it) and its
//   own [16 x D] accumulator in mma registers; the warps' states merge
//   once, at the end, through shared memory, in warp order;
// - P.V keeps p's fp32 precision: p (times the int8 v scale) is split
//   into three bf16 terms, p = hi + mid + lo up to 2^-24 p, and P.V is
//   three mma into one fp32 accumulator. One bf16 p (the TPU kernel's
//   cast) would move an element near 0 by up to 2^-9 max|v|, far past
//   the 1e-5 max|v| the plain version is held to;
// - barriers: one on each side of a tile (int8: one more after the
//   conversion).
//
// The SIMT route (flash_decode_kernel: an fp32 q, or a head dim the
// tensor-core route is not built for) stages each tile with 16-byte
// loads, computes scores with fp32 FMAs, runs the online softmax one
// warp per query row and keeps the accumulator in shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int TK = 64;        // keys per tile
constexpr int THREADS = 128;  // 4 warps
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(int8_t x) {
  return static_cast<float>(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename KV, typename Q>
__global__ void __launch_bounds__(THREADS)
    flash_decode_kernel(const Q* __restrict__ q, const KV* __restrict__ k,
                        const KV* __restrict__ v,
                        const float* __restrict__ k_scale,
                        const float* __restrict__ v_scale,
                        const int* __restrict__ length, Q* __restrict__ out,
                        float* __restrict__ part_ml,
                        float* __restrict__ part_acc, int H, int KVH, int S,
                        int D, int window, float scale) {
  constexpr int VEC = 16 / sizeof(KV);  // elements per 16-byte load
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int split = blockIdx.z;
  const int nsplit = gridDim.z;
  const int G = H / KVH;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const bool quant = k_scale != nullptr;

  extern __shared__ __align__(16) unsigned char smem[];
  KV* k_s = reinterpret_cast<KV*>(smem);          // [TK, D]
  KV* v_s = k_s + TK * D;                         // [TK, D]
  float* q_s = reinterpret_cast<float*>(v_s + TK * D);  // [G, D]
  float* acc_s = q_s + G * D;                     // [G, D]
  float* s_s = acc_s + G * D;                     // [G, TK]
  float* m_s = s_s + G * TK;                      // [G]
  float* l_s = m_s + G;                           // [G]
  float* corr_s = l_s + G;                        // [G]
  float* ks_s = corr_s + G;                       // [TK]
  float* vs_s = ks_s + TK;                        // [TK]

  const int len = min(max(length[b], 0), S);
  const int start = window > 0 ? max(len - window, 0) : 0;
  // this block's piece [lo, hi) of the visible range, TK-aligned
  const int per = (max(len - start, 0) + nsplit - 1) / nsplit;
  const int chunk = (per + TK - 1) / TK * TK;
  const int lo = start + split * chunk;
  const int hi = min(len, lo + chunk);
  const int h0 = kvh * G;  // the group's rows are contiguous in q/out
  const size_t qo = (static_cast<size_t>(b) * H + h0) * D;
  for (int i = tid; i < G * D; i += THREADS) {
    q_s[i] = to_f(q[qo + i]);
    acc_s[i] = 0.f;
  }
  for (int g = tid; g < G; g += THREADS) {
    m_s[g] = NEG_INF;
    l_s[g] = 0.f;
  }
  __syncthreads();

  const int cpr = D / VEC;  // 16-byte chunks per cache row
  int L = 1;                // lanes per row in the score pass
  while (L < cpr && L < 32) L <<= 1;
  const int rows_per_pass = THREADS / L;
  const int sub = tid % L;
  const int row0 = tid / L;
  const size_t pos_stride = static_cast<size_t>(KVH) * D;
  const size_t kv0 = (static_cast<size_t>(b) * S * KVH + kvh) * D;
  const KV* kb = k + kv0;
  const KV* vb = v + kv0;

  for (int t0 = lo; t0 < hi; t0 += TK) {
    const int n = min(TK, hi - t0);
    // stage the tile: 16-byte coalesced loads, nothing past length
    for (int c = tid; c < n * cpr; c += THREADS) {
      const int r = c / cpr;
      const int cc = c - r * cpr;
      const size_t off = static_cast<size_t>(t0 + r) * pos_stride +
                         static_cast<size_t>(cc) * VEC;
      reinterpret_cast<uint4*>(k_s)[c] =
          *reinterpret_cast<const uint4*>(kb + off);
      reinterpret_cast<uint4*>(v_s)[c] =
          *reinterpret_cast<const uint4*>(vb + off);
    }
    if (quant) {
      for (int r = tid; r < n; r += THREADS) {
        const size_t so = (static_cast<size_t>(b) * S + t0 + r) * KVH + kvh;
        ks_s[r] = k_scale[so];
        vs_s[r] = v_scale[so];
      }
    }
    __syncthreads();

    // scores: L lanes per key row; every thread runs the same number of
    // passes so the shuffles stay warp-uniform
    for (int base = 0; base < n; base += rows_per_pass) {
      const int r = base + row0;
      const bool act = r < n;
      for (int g = 0; g < G; ++g) {
        float dot = 0.f;
        if (act) {
          for (int cc = sub; cc < cpr; cc += L) {
            const uint4 raw =
                *reinterpret_cast<const uint4*>(k_s + r * D + cc * VEC);
            const KV* e = reinterpret_cast<const KV*>(&raw);
            const float* qq = q_s + g * D + cc * VEC;
#pragma unroll
            for (int j = 0; j < VEC; ++j) dot += qq[j] * to_f(e[j]);
          }
        }
        for (int off = L >> 1; off > 0; off >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, off);
        if (act && sub == 0)
          s_s[g * TK + r] = quant ? dot * ks_s[r] * scale : dot * scale;
      }
    }
    __syncthreads();

    // online softmax, one warp per query row; every tile read holds only
    // visible keys, so m is a real score after the first tile
    for (int g = warp; g < G; g += THREADS / 32) {
      float* sg = s_s + g * TK;
      float mx = NEG_INF;
      for (int j = lane; j < n; j += 32) mx = fmaxf(mx, sg[j]);
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int j = lane; j < n; j += 32) {
        const float p = expf(sg[j] - m_new);
        sum += p;
        sg[j] = quant ? p * vs_s[j] : p;
      }
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        corr_s[g] = corr;
        l_s[g] = l_s[g] * corr + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * corr + P . V
    for (int i = tid; i < G * D; i += THREADS) {
      const int g = i / D;
      const int d = i - g * D;
      const float* pg = s_s + g * TK;
      float a = acc_s[i] * corr_s[g];
      for (int j = 0; j < n; ++j) a += pg[j] * to_f(v_s[j * D + d]);
      acc_s[i] = a;
    }
    __syncthreads();
  }

  if (nsplit == 1) {
    for (int i = tid; i < G * D; i += THREADS) {
      const float o = len > 0 ? acc_s[i] / l_s[i / D] : 0.f;
      out[qo + i] = from_f<Q>(o);
    }
    return;
  }
  // partials for the combine pass; a piece with no keys leaves
  // m = NEG_INF, l = 0, acc = 0, which the combine weighs by exactly 0
  const size_t part = (static_cast<size_t>(b) * KVH + kvh) * nsplit + split;
  for (int g = tid; g < G; g += THREADS) {
    part_ml[(part * G + g) * 2] = m_s[g];
    part_ml[(part * G + g) * 2 + 1] = l_s[g];
  }
  for (int i = tid; i < G * D; i += THREADS)
    part_acc[part * G * D + i] = acc_s[i];
}

// ----------------------------------------- the tensor-core route (bf16 q)

constexpr int STAGES = 2;  // K/V tiles a block keeps in flight

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (or 4) bytes global -> shared, zeros where !ok (src-size 0)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 4 : 0));
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

// two fp32 rounded to bf16, the first in the low half (the lower column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// x and y each as the sum of three bf16 terms, packed in pairs: the
// rounding residual of a float is exact in fp32, so after three roundings
// x = hi + mid + lo holds to 2^-24 |x|
__device__ __forceinline__ void split3(float x, float y, uint32_t& hi,
                                       uint32_t& mid, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const float rx = x - hf.x, ry = y - hf.y;
  const __nv_bfloat162 m = __floats2bfloat162_rn(rx, ry);
  const float2 mf = __bfloat1622float2(m);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  mid = *reinterpret_cast<const uint32_t*>(&m);
  lo = pack_bf16(rx - mf.x, ry - mf.y);
}

// shared-memory layout of the tensor-core route for a KV cache type and D
template <typename KV, int D>
struct TcDec {
  static constexpr bool Q8 = std::is_same<KV, int8_t>::value;
  static constexpr int LDS = D + 8;          // bf16 tile row, elements
  static constexpr int TILE = TK * LDS * 2;  // one bf16 [TK][LDS] tile
  // a staged row in bytes: the bf16 tile's own, or D int8 + 16 of pad
  static constexpr int RAW_LD = Q8 ? D + 16 : LDS * 2;
  static constexpr int RAW = TK * RAW_LD;
  // a stage: K, V (int8: then k and v scales [TK] each)
  static constexpr int STAGE = 2 * RAW + (Q8 ? 2 * TK * 4 : 0);
  // the stages, then (int8) the converted bf16 K and V tiles
  static constexpr int SMEM = STAGES * STAGE + (Q8 ? 2 * TILE : 0);
  // the warps' final merge reuses the stages: [4][16][D] sums, [4][16]
  // (m, l), [16] (M, L)
  static_assert(SMEM >= (4 * 16 * D + 4 * 16 * 2 + 16 * 2) * 4,
                "the merge does not fit");
};

// Lane offsets (bytes) into a [TK][LDS] bf16 tile: B gives two n8 tiles of
// an operand stored [n][k] (K: keys x D), BT two n8 tiles of one stored
// [k][n] (V: keys x D, by ldmatrix.trans)
template <int LDS>
__device__ __forceinline__ uint32_t off_b(int lane) {
  return (((lane & 7) + ((lane >> 4) << 3)) * LDS + ((lane >> 3) & 1) * 8) *
         2;
}
template <int LDS>
__device__ __forceinline__ uint32_t off_bt(int lane) {
  return (((lane & 7) + ((lane >> 3) & 1) * 8) * LDS + (lane >> 4) * 8) * 2;
}

// grid (KVH x m-tiles of 16 query rows, B, nsplit), 4 warps; warp w owns
// keys 16w .. 16w + 15 of every tile
template <typename KV, int D>
__global__ void __launch_bounds__(THREADS)
    flash_decode_tc(const __nv_bfloat16* __restrict__ q,
                    const KV* __restrict__ k, const KV* __restrict__ v,
                    const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale,
                    const int* __restrict__ length,
                    __nv_bfloat16* __restrict__ out,
                    float* __restrict__ part_ml,
                    float* __restrict__ part_acc, int H, int KVH, int S,
                    int window, float scale) {
  using TT = TcDec<KV, D>;
  constexpr int KS = D / 16, NT = D / 8, LDS = TT::LDS;
  extern __shared__ __align__(16) unsigned char smem[];
  const int G = H / KVH, MT = (G + 15) / 16;
  const int kvh = blockIdx.x / MT, mt = blockIdx.x % MT;
  const int b = blockIdx.y, split = blockIdx.z, nsplit = gridDim.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, tq = lane & 3;
  const int nrows = min(16, G - 16 * mt);  // this block's query rows
  const int h0 = kvh * G + 16 * mt;        // and its first q head

  const int len = min(max(length[b], 0), S);
  const int start = window > 0 ? max(len - window, 0) : 0;
  // this block's piece [lo, hi) of the visible range, TK-aligned
  const int per = (max(len - start, 0) + nsplit - 1) / nsplit;
  const int chunk = (per + TK - 1) / TK * TK;
  const int lo = start + split * chunk;
  const int hi = min(len, lo + chunk);
  const int ntiles = hi > lo ? (hi - lo + TK - 1) / TK : 0;

  const size_t pos_stride = static_cast<size_t>(KVH) * D;
  const size_t kv0 = (static_cast<size_t>(b) * S * KVH + kvh) * D;
  const KV* kb = k + kv0;
  const KV* vb = v + kv0;
  const uint32_t s0 = smem_u32(smem);

  // tile t (keys lo + TK t ..) into stage st; nothing at or past hi is read
  auto fetch = [&](int t, int st) {
    constexpr int EL = 16 / sizeof(KV);  // elements a 16-byte chunk
    constexpr int CH = D / EL;           // chunks a row
    const int t0 = lo + t * TK;
    const uint32_t base = s0 + st * TT::STAGE;
#pragma unroll
    for (int it = 0; it < 2 * TK * CH / THREADS; ++it) {
      const int idx = tid + it * THREADS;
      const int which = idx / (TK * CH), r = idx % (TK * CH) / CH,
                c = idx % CH;
      const bool ok = t0 + r < hi;
      const KV* src = (which ? vb : kb) +
                      (ok ? (t0 + r) * pos_stride + c * EL : 0);
      cp_async16(base + which * TT::RAW + r * TT::RAW_LD + c * 16, src, ok);
    }
    if constexpr (TT::Q8) {
      const int r = tid & (TK - 1);
      const bool ok = t0 + r < hi;
      const float* src = (tid < TK ? k_scale : v_scale) +
                         (static_cast<size_t>(b) * S + (ok ? t0 + r : 0)) *
                             KVH + kvh;
      cp_async4(base + 2 * TT::RAW + (tid < TK ? 0 : TK * 4) + 4 * r, src,
                ok);
    }
  };
  // one commit group a tile, empty past the last, so wait_group counts
  // tiles
#pragma unroll
  for (int t = 0; t < STAGES; ++t) {
    if (t < ntiles) fetch(t, t);
    cp_commit();
  }

  // the query rows as A fragments, zeros past the group: rows gr, gr + 8
  uint32_t qa[KS][4];
  {
    const uint32_t* q0p = reinterpret_cast<const uint32_t*>(
        q + (static_cast<size_t>(b) * H + h0 + min(gr, nrows - 1)) * D);
    const uint32_t* q1p = reinterpret_cast<const uint32_t*>(
        q + (static_cast<size_t>(b) * H + h0 + min(gr + 8, nrows - 1)) * D);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const int c = 8 * kk + tq;  // bf16 pairs: columns 16 kk + 2 tq, +1
      qa[kk][0] = gr < nrows ? q0p[c] : 0u;
      qa[kk][1] = gr + 8 < nrows ? q1p[c] : 0u;
      qa[kk][2] = gr < nrows ? q0p[c + 4] : 0u;
      qa[kk][3] = gr + 8 < nrows ? q1p[c + 4] : 0u;
    }
  }

  const uint32_t ob = off_b<LDS>(lane), obt = off_bt<LDS>(lane);
  const int w0 = 16 * warp;  // this warp's first key in a tile
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    const int st = t % STAGES;
    cp_wait<STAGES - 1>();  // tile t has landed
    __syncthreads();
    const unsigned char* stage = smem + st * TT::STAGE;
    uint32_t sK = s0 + st * TT::STAGE, sV = sK + TT::RAW;
    if constexpr (TT::Q8) {
      // int8 -> bf16, exact: 16 values a thread and pass
      unsigned char* dst = smem + STAGES * TT::STAGE;
      constexpr int CH = D / 16;
#pragma unroll
      for (int it = 0; it < 2 * TK * CH / THREADS; ++it) {
        const int idx = tid + it * THREADS;
        const int which = idx / (TK * CH), r = idx % (TK * CH) / CH,
                  c = idx % CH;
        const int4 raw = *reinterpret_cast<const int4*>(
            stage + which * TT::RAW + r * TT::RAW_LD + c * 16);
        const int8_t* e = reinterpret_cast<const int8_t*>(&raw);
        uint32_t w[8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          w[i] = pack_bf16(static_cast<float>(e[2 * i]),
                           static_cast<float>(e[2 * i + 1]));
        uint4* d = reinterpret_cast<uint4*>(dst + which * TT::TILE +
                                            (r * LDS + c * 16) * 2);
        d[0] = make_uint4(w[0], w[1], w[2], w[3]);
        d[1] = make_uint4(w[4], w[5], w[6], w[7]);
      }
      __syncthreads();
      sK = smem_u32(dst);
      sV = sK + TT::TILE;
    }
    const float* ksc = reinterpret_cast<const float*>(stage + 2 * TT::RAW);
    const float* vsc = ksc + TK;
    const int t0 = lo + t * TK;
    if (t0 + w0 < hi) {  // warp-uniform: the warp's first key is visible
      // S = Q . K^T over the warp's 16 keys
      float s[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t kf[4];
        ldsm_x4(kf, sK + ob + w0 * LDS * 2 + kk * 32);
        mma(s[0], qa[kk], kf[0], kf[1]);
        mma(s[1], qa[kk], kf[2], kf[3]);
      }
      // scaled scores, the ragged tail masked; the online softmax
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = w0 + 8 * n + 2 * tq + (e & 1);
          float x = TT::Q8 ? s[n][e] * ksc[j] * scale : s[n][e] * scale;
          x = t0 + j < hi ? x : NEG_INF;
          s[n][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      float corr[2], rs[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        mx[r] = fmaxf(m[r], mx[r]);
        corr[r] = expf(m[r] - mx[r]);
        m[r] = mx[r];
      }
      // p (fp32; exactly 0 where masked), l sums it; P.V takes p (times
      // the int8 v scale) as three bf16 A fragments, pa[0] + pa[1] + pa[2]
      uint32_t pa[3][4];
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[e] = expf(s[n][e] - m[e >> 1]);
          rs[e >> 1] += p[e];
          if (TT::Q8) p[e] *= vsc[w0 + 8 * n + 2 * tq + (e & 1)];
        }
        split3(p[0], p[1], pa[0][2 * n], pa[1][2 * n], pa[2][2 * n]);
        split3(p[2], p[3], pa[0][2 * n + 1], pa[1][2 * n + 1],
               pa[2][2 * n + 1]);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
        rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
        l[r] = l[r] * corr[r] + rs[r];
      }
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        acc[n][0] *= corr[0];
        acc[n][1] *= corr[0];
        acc[n][2] *= corr[1];
        acc[n][3] *= corr[1];
      }
      // acc += P . V, one term of p at a time across all of D, so the
      // three products into one accumulator are D / 8 mma apart
#pragma unroll
      for (int x = 0; x < 3; ++x)
#pragma unroll
        for (int j = 0; j < D / 16; ++j) {
          uint32_t vf[4];
          ldsm_x4_t(vf, sV + obt + w0 * LDS * 2 + j * 32);
          mma(acc[2 * j], pa[x], vf[0], vf[1]);
          mma(acc[2 * j + 1], pa[x], vf[2], vf[3]);
        }
    }
    __syncthreads();  // this stage is free for the load two tiles on
    if (t + STAGES < ntiles) fetch(t + STAGES, st);
    cp_commit();
  }
  cp_wait<0>();
  __syncthreads();

  // merge the four warps' states, in warp order, through shared memory
  float* red = reinterpret_cast<float*>(smem);  // [4][16][D]
  float* wml = red + 4 * 16 * D;                // [4][16] (m, l)
  float* rml = wml + 4 * 16 * 2;                // [16] (M, L)
  if (tq == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      wml[(warp * 16 + gr + 8 * r) * 2] = m[r];
      wml[(warp * 16 + gr + 8 * r) * 2 + 1] = l[r];
    }
  }
  __syncthreads();
  if (tid < 16) {
    float M = NEG_INF, L = 0.f;
    for (int w = 0; w < 4; ++w) M = fmaxf(M, wml[(w * 16 + tid) * 2]);
    for (int w = 0; w < 4; ++w)
      L += wml[(w * 16 + tid) * 2 + 1] * expf(wml[(w * 16 + tid) * 2] - M);
    rml[2 * tid] = M;
    rml[2 * tid + 1] = L;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = gr + 8 * r;
    if (row >= nrows) continue;
    float M = NEG_INF;
    for (int w = 0; w < 4; ++w) M = fmaxf(M, wml[(w * 16 + row) * 2]);
    const float f = expf(m[r] - M);
    float2* dst = reinterpret_cast<float2*>(red + (warp * 16 + row) * D);
#pragma unroll
    for (int n = 0; n < NT; ++n)
      dst[4 * n + tq] = make_float2(f * acc[n][2 * r], f * acc[n][2 * r + 1]);
  }
  __syncthreads();
  const size_t part = (static_cast<size_t>(b) * KVH + kvh) * nsplit + split;
  for (int i = tid; i < nrows * D; i += THREADS) {
    const int row = i / D, d = i - row * D;
    const float x = red[row * D + d] + red[(16 + row) * D + d] +
                    red[(32 + row) * D + d] + red[(48 + row) * D + d];
    if (nsplit == 1)
      out[(static_cast<size_t>(b) * H + h0 + row) * D + d] =
          __float2bfloat16(len > 0 ? x / rml[2 * row + 1] : 0.f);
    else
      part_acc[(part * G + 16 * mt + row) * D + d] = x;
  }
  // a piece with no keys leaves M = NEG_INF, L = 0 and zero sums, which
  // the combine weighs by exactly 0
  if (nsplit > 1 && tid < nrows) {
    part_ml[(part * G + 16 * mt + tid) * 2] = rml[2 * tid];
    part_ml[(part * G + 16 * mt + tid) * 2 + 1] = rml[2 * tid + 1];
  }
}

// out = sum_s exp(m_s - M) acc_s / sum_s exp(m_s - M) l_s over the
// splits of one (KV head, row), in split order; a row with no visible key
// gives zeros. One thread an output element: grid (KVH, B, G * D / THREADS)
template <typename Q>
__global__ void __launch_bounds__(THREADS)
    flash_decode_combine(const float* __restrict__ part_ml,
                         const float* __restrict__ part_acc,
                         Q* __restrict__ out, int H, int KVH, int D,
                         int nsplit) {
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int G = H / KVH;
  const int i = blockIdx.z * THREADS + threadIdx.x;
  if (i >= G * D) return;
  const size_t part0 = (static_cast<size_t>(b) * KVH + kvh) * nsplit;
  const size_t qo = (static_cast<size_t>(b) * H + kvh * G) * D;
  const int g = i / D;
  float mx = NEG_INF;
  for (int s = 0; s < nsplit; ++s)
    mx = fmaxf(mx, part_ml[((part0 + s) * G + g) * 2]);
  float num = 0.f, den = 0.f;
  if (mx > 0.5f * NEG_INF) {
    for (int s = 0; s < nsplit; ++s) {
      const size_t ps = (part0 + s) * G + g;
      const float w = expf(part_ml[ps * 2] - mx);
      den += w * part_ml[ps * 2 + 1];
      num += w * part_acc[ps * D + (i - g * D)];
    }
  }
  out[qo + i] = from_f<Q>(den > 0.f ? num / den : 0.f);
}

template <typename Q>
int combine(const void* part_ml, const void* part_acc, void* out, int B,
            int H, int KVH, int D, int nsplit, cudaStream_t stream) {
  const int G = H / KVH;
  flash_decode_combine<Q>
      <<<dim3(KVH, B, (G * D + THREADS - 1) / THREADS), THREADS, 0,
         stream>>>(static_cast<const float*>(part_ml),
                   static_cast<const float*>(part_acc), static_cast<Q*>(out),
                   H, KVH, D, nsplit);
  return static_cast<int>(cudaGetLastError());
}

template <typename K>
cudaError_t allow_smem(K kern, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <typename KV, typename Q>
int launch(const void* q, const void* k, const void* v, const void* ks,
           const void* vs, const void* length, void* out, void* part_ml,
           void* part_acc, int B, int H, int KVH, int S, int D, int window,
           float scale, int nsplit, cudaStream_t stream) {
  const int G = H / KVH;
  const size_t smem = 2 * static_cast<size_t>(TK) * D * sizeof(KV) +
                      (2 * static_cast<size_t>(G) * D + G * TK + 3 * G +
                       2 * TK) * sizeof(float);
  auto kern = flash_decode_kernel<KV, Q>;
  cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kern<<<dim3(KVH, B, nsplit), THREADS, smem, stream>>>(
      static_cast<const Q*>(q), static_cast<const KV*>(k),
      static_cast<const KV*>(v), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(length),
      static_cast<Q*>(out), static_cast<float*>(part_ml),
      static_cast<float*>(part_acc), H, KVH, S, D, window, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess || nsplit == 1) return static_cast<int>(e);
  return combine<Q>(part_ml, part_acc, out, B, H, KVH, D, nsplit, stream);
}

template <typename KV, int D>
int launch_tc(const void* q, const void* k, const void* v, const void* ks,
              const void* vs, const void* length, void* out, void* part_ml,
              void* part_acc, int B, int H, int KVH, int S, int window,
              float scale, int nsplit, cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  const int MT = (H / KVH + 15) / 16;
  auto kern = flash_decode_tc<KV, D>;
  cudaError_t e = allow_smem(kern, TcDec<KV, D>::SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  kern<<<dim3(KVH * MT, B, nsplit), THREADS, TcDec<KV, D>::SMEM, stream>>>(
      static_cast<const bf16*>(q), static_cast<const KV*>(k),
      static_cast<const KV*>(v), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(length),
      static_cast<bf16*>(out), static_cast<float*>(part_ml),
      static_cast<float*>(part_acc), H, KVH, S, window, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess || nsplit == 1) return static_cast<int>(e);
  return combine<bf16>(part_ml, part_acc, out, B, H, KVH, D, nsplit,
                       stream);
}

template <typename K>
int resources(K kern, size_t smem, int* smem_out, int* blocks) {
  cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  *smem_out = static_cast<int>(smem);
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kern, THREADS,
                                                    smem);
  return static_cast<int>(e);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16, 2 = int8 (cache only). The
// route for a (cache, q) dtype pair and head dim: 1 = the tensor cores (a
// bf16 q over a bf16 or int8 cache, D = 64 or 128), 0 = SIMT (the other
// pairs the kernels are built for), -1 = not built.
extern "C" int tony_flash_decode_route(int kv_code, int q_code, int D) {
  if (q_code == 1 && (kv_code == 1 || kv_code == 2) && (D == 64 || D == 128))
    return 1;
  if ((q_code == 0 && (kv_code == 0 || kv_code == 2)) ||
      (q_code == 1 && (kv_code == 1 || kv_code == 2)))
    return 0;
  return -1;
}

// part_ml [B, KVH, nsplit, G, 2] and part_acc [B, KVH, nsplit, G, D]
// fp32 are the caller's scratch (unused when nsplit == 1). k and v must
// be 16-byte aligned. Returns cudaGetLastError() after the launches (0 =
// launched), or -1 for a dtype pair the kernels are not built for.
extern "C" int tony_flash_decode(int kv_code, int q_code, const void* q,
                                 const void* k, const void* v,
                                 const void* k_scale, const void* v_scale,
                                 const void* length, void* out,
                                 void* part_ml, void* part_acc, int B, int H,
                                 int KVH, int S, int D, int window,
                                 float scale, int nsplit, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int route = tony_flash_decode_route(kv_code, q_code, D);
  if (route == 1) {
    if (kv_code == 1 && D == 64)
      return launch_tc<__nv_bfloat16, 64>(q, k, v, nullptr, nullptr, length,
                                          out, part_ml, part_acc, B, H, KVH,
                                          S, window, scale, nsplit, st);
    if (kv_code == 1)
      return launch_tc<__nv_bfloat16, 128>(q, k, v, nullptr, nullptr,
                                           length, out, part_ml, part_acc, B,
                                           H, KVH, S, window, scale, nsplit,
                                           st);
    if (D == 64)
      return launch_tc<int8_t, 64>(q, k, v, k_scale, v_scale, length, out,
                                   part_ml, part_acc, B, H, KVH, S, window,
                                   scale, nsplit, st);
    return launch_tc<int8_t, 128>(q, k, v, k_scale, v_scale, length, out,
                                  part_ml, part_acc, B, H, KVH, S, window,
                                  scale, nsplit, st);
  }
  if (kv_code == 0 && q_code == 0)
    return launch<float, float>(q, k, v, nullptr, nullptr, length, out,
                                part_ml, part_acc, B, H, KVH, S, D, window,
                                scale, nsplit, st);
  if (kv_code == 1 && q_code == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(
        q, k, v, nullptr, nullptr, length, out, part_ml, part_acc, B, H,
        KVH, S, D, window, scale, nsplit, st);
  if (kv_code == 2 && q_code == 0)
    return launch<int8_t, float>(q, k, v, k_scale, v_scale, length, out,
                                 part_ml, part_acc, B, H, KVH, S, D, window,
                                 scale, nsplit, st);
  if (kv_code == 2 && q_code == 1)
    return launch<int8_t, __nv_bfloat16>(
        q, k, v, k_scale, v_scale, length, out, part_ml, part_acc, B, H,
        KVH, S, D, window, scale, nsplit, st);
  return -1;
}

// The tensor-core kernel for a cache dtype (1 = bf16, 2 = int8) at head
// dim D: its dynamic shared memory in bytes and how many of its blocks fit
// on one SM. Returns a CUDA error, or -1 for a kernel that is not built.
extern "C" int tony_flash_decode_resources(int kv_code, int D,
                                           int* smem_bytes,
                                           int* blocks_per_sm) {
  if (kv_code == 1 && D == 64)
    return resources(flash_decode_tc<__nv_bfloat16, 64>,
                     TcDec<__nv_bfloat16, 64>::SMEM, smem_bytes,
                     blocks_per_sm);
  if (kv_code == 1 && D == 128)
    return resources(flash_decode_tc<__nv_bfloat16, 128>,
                     TcDec<__nv_bfloat16, 128>::SMEM, smem_bytes,
                     blocks_per_sm);
  if (kv_code == 2 && D == 64)
    return resources(flash_decode_tc<int8_t, 64>, TcDec<int8_t, 64>::SMEM,
                     smem_bytes, blocks_per_sm);
  if (kv_code == 2 && D == 128)
    return resources(flash_decode_tc<int8_t, 128>, TcDec<int8_t, 128>::SMEM,
                     smem_bytes, blocks_per_sm);
  return -1;
}
