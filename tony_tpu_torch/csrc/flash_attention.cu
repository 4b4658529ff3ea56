// Flash attention on Hopper: the FlashAttention-2 forward and its two
// backward kernels (dQ, and dK/dV summed over the query-head group).
//
// Replaces the three Pallas TPU kernels of tony_tpu/ops/attention.py:
// _flash_kernel (forward, :140), _flash_bwd_dq_kernel (:204) and
// _flash_bwd_dkv_kernel (:262).
//
//   q [B, Lq, H, D], k/v [B, Lk, KVH, D] (fp32 or bf16, read through
//   their batch/sequence/head strides, the last dim contiguous; head h
//   reads KV head h / (H / KVH)), optional segment ids [B, L] int32.
//   forward: o [B, Lq, H, D] in the input dtype, lse [B*H, Lq] fp32
//   (the per-row logsumexp of the scaled scores);
//   dQ: + dO (strided like q), lse, delta = rowsum(dO*O) [B*H, Lq] fp32
//       -> dq [B, Lq, H, D];
//   dK/dV: the same inputs -> dk, dv [B, Lk, KVH, D].
//   Key j is visible to query i iff i < Lq, j < Lk and, when causal,
//   j <= i, i - j < window (window > 0) and seg[i] == seg[j] (segments).
//
// What bounds it on an H100: operations. A causal forward does
// 2*2*B*H*L^2*D/2 flops on O(B*L*H*D) bytes, far above the ~295 flops a
// byte at which the bf16 tensor cores, not memory, would limit; dQ does
// three such products and dK/dV four.
//
// Common to all kernels:
// - CUDA blocks run in no order, so the TPU grid's sequential kv axis
//   (the online softmax and the dQ / dK/dV sums carried in VMEM scratch)
//   becomes a loop inside the block, and every output is written once,
//   with no atomics (deterministic: two runs give the same bits);
// - the tile loop covers only the range that causality and the window
//   leave visible (kv_range; the q-tile range in the dK/dV kernels);
// - cast points as the TPU kernels: p is rounded to the input dtype
//   before P.V and before P^T.dO, dS before dS.K and dS^T.Q; every sum
//   is fp32; the softmax scale folds into the exp, and dQ/dK take it
//   once at the end.
//
// The fp32 kernels (fwd_kernel, dq_kernel, dkv_kernel; only their float
// instances are built): SIMT fp32 FMAs on 64x64 tiles staged in shared
// memory as fp32 (rows padded to D + 1), 16x16 threads with a 4x4 tile of
// scores each; a tile that the segments or the ragged edge leave wholly
// invisible is skipped after one vote of the block. They stay SIMT: the
// tensor cores' fp32 route (TF32, 10 mantissa bits) cannot meet the fp32
// limit of 2^-14.
//
// The bf16 kernels (fwd_kernel_tc, dq_kernel_tc, dkv_kernel_tc) run on
// the tensor cores, as FlashAttention-2 does; the bf16 forward's SIMT
// instance fwd_kernel<bf16> is retired:
// - every product is mma.sync.m16n8k16 (bf16 operands, fp32 sums); the
//   operands come from shared memory by ldmatrix (.trans where the tile
//   is stored [depth][n]), S and dP stay in accumulator registers, and P
//   and dS are rounded to bf16 in registers straight into the A-operand
//   layout of the next product (the accumulator of two n8 tiles is the A
//   fragment of one k16 step), never through shared memory;
// - 4 warps a block; a warp owns 16 rows of the block's tile (queries for
//   dQ, keys for dK/dV) and every product of those rows, so warps share
//   nothing but the opposite tile and need no barrier between products;
// - tiles are bf16 [64][D + 8] in shared memory: the 16-byte pad moves
//   each row four banks on, so ldmatrix reads without conflicts; the
//   forward holds Q plus two stages of K/V (87 KB at D = 128), dQ holds
//   Q and dO plus two stages of K/V (102 KB), dK/dV holds K and V plus two
//   stages of Q/dO with their lse/delta rows (103 KB): two blocks, 8
//   warps, an SM;
// - the forward keeps each warp's 16 query rows of Q as A fragments in
//   registers for the whole k loop (read once by ldmatrix), runs the
//   online softmax on the S accumulators (row max and sum over the four
//   lanes that share a row, exp2 with the scale folded in, l summing the
//   unrounded p) and writes o = acc / max(l, 1e-30) and the lse in the
//   fp32 kernel's units and layout, which the backward reads;
// - the opposite tiles are double-buffered: cp.async (16 bytes a thread;
//   rows past the end zero-filled) loads tile n + 1 while tile n
//   multiplies, one barrier a tile on each side;
// - forward and dQ: one block per (q head, batch, q tile of 64), the
//   latest (heaviest causal) q tiles first in launch order;
// - dK/dV: one block per (KV head x split, batch, k tile of 64), the
//   earliest (heaviest) k tiles first. One block per KV head would launch
//   256 blocks of causal work that differs 32-fold at the training call
//   (B=4, L=2048, KVH=2): under two waves of 264 slots, the heaviest
//   block setting the time. So the wrapper splits each KV head's query
//   group over the fewest blocks (a divisor of the group) that fill every
//   block slot at least once (2 at that call: 512 blocks); each block
//   then writes fp32 partial dK/dV of its heads and dkv_reduce adds them
//   in split order, scales dK and rounds;
// - the per-element mask is computed only on tiles that the diagonal,
//   the window's edge, segments or the ragged edge cut (tile_cut); there a
//   warp whose rows see no element of the tile skips its products.
// What bounds them: the tensor cores' operands. Each warp reads the whole
// opposite tile from shared memory for each of its products (about one
// ldmatrix.x4 for two mma; the forward's Q, in registers, is the one
// exception), so shared-memory bandwidth caps mma.sync near half the bf16
// peak; wgmma (64-row warpgroup products, B read by the hardware) and TMA
// loads are the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BQ = 64;        // queries per tile
constexpr int BK = 64;        // keys per tile
constexpr int THREADS = 256;  // 16 x 16
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
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

// x rounded to T and back: the value a T operand of a product holds
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const int* seg;
  const float* lse_in;
  const float* delta;
  void* out;
  float* lse_out;
  void* dq;
  void* dk;
  void* dv;
  long long sqb, sql, sqh;  // element strides of q
  long long skb, skl, skh;  // k
  long long svb, svl, svh;  // v
  long long sdb, sdl, sdh;  // dO
  int B, H, KVH, Lq, Lk, causal, window;
  float scale;
};

__device__ __forceinline__ bool visible(const Args& a, const int* segb,
                                        int i, int j) {
  if (i >= a.Lq || j >= a.Lk) return false;
  if (!a.causal) return true;
  if (j > i) return false;
  if (a.window > 0 && i - j >= a.window) return false;
  if (segb != nullptr && __ldg(segb + i) != __ldg(segb + j)) return false;
  return true;
}

// rows [row0, row0 + 64) of one head's [L, D] slice (row stride sl) into
// dst[64][ld] as fp32; rows at or past `limit` read as zeros
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, int ld,
                                          const T* __restrict__ src,
                                          long long sl, int row0,
                                          int limit) {
  for (int idx = threadIdx.x; idx < 64 * D; idx += THREADS) {
    const int r = idx / D, c = idx % D;
    const int gr = row0 + r;
    dst[r * ld + c] = gr < limit ? to_f(src[gr * sl + c]) : 0.f;
  }
}

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// k tiles [begin, end) that causality and the window leave visible to
// the queries [q0, q0 + 64)
__device__ __forceinline__ void kv_range(const Args& a, int q0, int* begin,
                                         int* end) {
  *begin = 0;
  *end = (a.Lk + BK - 1) / BK;
  if (!a.causal) return;
  const int qlast = min(q0 + BQ, a.Lq) - 1;
  *end = min(*end, qlast / BK + 1);
  if (a.window > 0) {
    const int first = q0 - a.window + 1;
    if (first > 0) *begin = first / BK;
  }
}

// ------------------------------------------------------------- forward

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) fwd_kernel(const Args a) {
  constexpr int LD = D + 1;
  constexpr int DC = D / 16;
  extern __shared__ float sm[];
  float* Qs = sm;               // [BQ][LD]
  float* Ks = Qs + BQ * LD;     // [BK][LD]
  float* Vs = Ks + BK * LD;     // [BK][D]
  float* Ps = Vs + BK * D;      // [BQ][BK + 1]
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  // heavy (late) causal tiles first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (a.H / a.KVH);
  const T* qp = static_cast<const T*>(a.q) + b * a.sqb + h * a.sqh;
  const T* kp = static_cast<const T*>(a.k) + b * a.skb + kvh * a.skh;
  const T* vp = static_cast<const T*>(a.v) + b * a.svb + kvh * a.svh;
  const int* segb = a.seg ? a.seg + static_cast<long long>(b) * a.Lk
                          : nullptr;
  load_tile<T, D>(Qs, LD, qp, a.sql, q0, a.Lq);

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[r][c] = 0.f;
  }
  int kt0, kt1;
  kv_range(a, q0, &kt0, &kt1);
  for (int kt = kt0; kt < kt1; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the last tile's readers are done
    load_tile<T, D>(Ks, LD, kp, a.skl, k0, a.Lk);
    load_tile<T, D>(Vs, D, vp, a.svl, k0, a.Lk);
    bool vis[4][4];
    bool any = false;
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        vis[r][c] = visible(a, segb, q0 + ty + 16 * r, k0 + tx + 16 * c);
        any |= vis[r][c];
      }
    if (!__syncthreads_or(any)) continue;  // also orders the tile loads
    float s[4][4] = {};
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) qv[r] = Qs[(ty + 16 * r) * LD + d];
#pragma unroll
      for (int c = 0; c < 4; ++c) kv[c] = Ks[(tx + 16 * c) * LD + d];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[r][c] += qv[r] * kv[c];
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float mx = NEG_INF;
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (vis[r][c]) mx = fmaxf(mx, s[r][c]);
      const float m_new = fmaxf(m[r], half_warp_max(mx));
      float p[4], rs = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        p[c] = vis[r][c] ? expf((s[r][c] - m_new) * a.scale) : 0.f;
        rs += p[c];
      }
      const float corr = expf((m[r] - m_new) * a.scale);
      l[r] = l[r] * corr + half_warp_sum(rs);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[r][c] *= corr;
#pragma unroll
      for (int c = 0; c < 4; ++c)
        Ps[(ty + 16 * r) * (BK + 1) + tx + 16 * c] = round_to<T>(p[c]);
    }
    __syncthreads();
    for (int j = 0; j < BK; ++j) {
      float pv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) pv[r] = Ps[(ty + 16 * r) * (BK + 1) + j];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float vv = Vs[j * D + tx + 16 * c];
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[r][c] += pv[r] * vv;
      }
    }
  }
  T* out = static_cast<T*>(a.out);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = q0 + ty + 16 * r;
    if (i >= a.Lq) continue;
    const float ls = fmaxf(l[r], 1e-30f);
    T* orow = out + ((static_cast<long long>(b) * a.Lq + i) * a.H + h) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) orow[tx + 16 * c] = from_f<T>(acc[r][c] / ls);
    if (tx == 0)
      a.lse_out[(static_cast<long long>(b) * a.H + h) * a.Lq + i] =
          m[r] * a.scale + logf(ls);
  }
}

// ------------------------------------------------------------------ dQ

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) dq_kernel(const Args a) {
  constexpr int LD = D + 1;
  constexpr int DC = D / 16;
  extern __shared__ float sm[];
  float* Qs = sm;              // [BQ][LD]
  float* Os = Qs + BQ * LD;    // dO [BQ][LD]
  float* Ks = Os + BQ * LD;    // [BK][LD]
  float* Vs = Ks + BK * LD;    // [BK][LD]
  float* Ss = Vs + BK * LD;    // dS [BQ][BK + 1]
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (a.H / a.KVH);
  const T* qp = static_cast<const T*>(a.q) + b * a.sqb + h * a.sqh;
  const T* dp_ = static_cast<const T*>(a.dout) + b * a.sdb + h * a.sdh;
  const T* kp = static_cast<const T*>(a.k) + b * a.skb + kvh * a.skh;
  const T* vp = static_cast<const T*>(a.v) + b * a.svb + kvh * a.svh;
  const int* segb = a.seg ? a.seg + static_cast<long long>(b) * a.Lk
                          : nullptr;
  load_tile<T, D>(Qs, LD, qp, a.sql, q0, a.Lq);
  load_tile<T, D>(Os, LD, dp_, a.sdl, q0, a.Lq);
  const long long row = (static_cast<long long>(b) * a.H + h) * a.Lq;
  float lse[4], dlt[4], acc[4][DC];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = q0 + ty + 16 * r;
    lse[r] = i < a.Lq ? a.lse_in[row + i] : 0.f;
    dlt[r] = i < a.Lq ? a.delta[row + i] : 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[r][c] = 0.f;
  }
  int kt0, kt1;
  kv_range(a, q0, &kt0, &kt1);
  for (int kt = kt0; kt < kt1; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();
    load_tile<T, D>(Ks, LD, kp, a.skl, k0, a.Lk);
    load_tile<T, D>(Vs, LD, vp, a.svl, k0, a.Lk);
    bool vis[4][4];
    bool any = false;
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        vis[r][c] = visible(a, segb, q0 + ty + 16 * r, k0 + tx + 16 * c);
        any |= vis[r][c];
      }
    if (!__syncthreads_or(any)) continue;
    float s[4][4] = {}, dp[4][4] = {};
#pragma unroll 2
    for (int d = 0; d < D; ++d) {
      float qv[4], ov[4], kv[4], vv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        qv[r] = Qs[(ty + 16 * r) * LD + d];
        ov[r] = Os[(ty + 16 * r) * LD + d];
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        kv[c] = Ks[(tx + 16 * c) * LD + d];
        vv[c] = Vs[(tx + 16 * c) * LD + d];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s[r][c] += qv[r] * kv[c];
          dp[r][c] += ov[r] * vv[c];
        }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = vis[r][c] ? expf(s[r][c] * a.scale - lse[r]) : 0.f;
        Ss[(ty + 16 * r) * (BK + 1) + tx + 16 * c] =
            round_to<T>(p * (dp[r][c] - dlt[r]));
      }
    __syncthreads();
    for (int j = 0; j < BK; ++j) {
      float sv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) sv[r] = Ss[(ty + 16 * r) * (BK + 1) + j];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float kv = Ks[j * LD + tx + 16 * c];
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[r][c] += sv[r] * kv;
      }
    }
  }
  T* dq = static_cast<T*>(a.dq);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = q0 + ty + 16 * r;
    if (i >= a.Lq) continue;
    T* qrow = dq + ((static_cast<long long>(b) * a.Lq + i) * a.H + h) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c)
      qrow[tx + 16 * c] = from_f<T>(acc[r][c] * a.scale);
  }
}

// --------------------------------------------------------------- dK/dV

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) dkv_kernel(const Args a) {
  constexpr int LD = D + 1;
  constexpr int DC = D / 16;
  extern __shared__ float sm[];
  float* Ks = sm;                  // [BK][LD]
  float* Vs = Ks + BK * LD;        // [BK][LD]
  float* Qs = Vs + BK * LD;        // [BQ][LD]
  float* Os = Qs + BQ * LD;        // dO [BQ][LD]
  float* Ps = Os + BQ * LD;        // P^T [BK][BQ + 1]
  float* Ss = Ps + BK * (BQ + 1);  // dS^T [BK][BQ + 1]
  float* Ls = Ss + BK * (BQ + 1);  // lse [BQ]
  float* Ds = Ls + BQ;             // delta [BQ]
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int k0 = blockIdx.x * BK;  // early (heavy) causal tiles first
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int G = a.H / a.KVH;
  const T* kp = static_cast<const T*>(a.k) + b * a.skb + kvh * a.skh;
  const T* vp = static_cast<const T*>(a.v) + b * a.svb + kvh * a.svh;
  const int* segb = a.seg ? a.seg + static_cast<long long>(b) * a.Lk
                          : nullptr;
  load_tile<T, D>(Ks, LD, kp, a.skl, k0, a.Lk);
  load_tile<T, D>(Vs, LD, vp, a.svl, k0, a.Lk);
  float dk[4][DC], dv[4][DC];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < DC; ++c) dk[r][c] = dv[r][c] = 0.f;
  // q tiles that can see a key of [k0, k0 + 64)
  const int nq = (a.Lq + BQ - 1) / BQ;
  int qt0 = 0, qt1 = nq;
  if (a.causal) {
    qt0 = k0 / BQ;
    if (a.window > 0) {
      const int klast = min(k0 + BK, a.Lk) - 1;
      qt1 = min(nq, (klast + a.window - 1) / BQ + 1);
    }
  }
  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const T* qp = static_cast<const T*>(a.q) + b * a.sqb + h * a.sqh;
    const T* dp_ = static_cast<const T*>(a.dout) + b * a.sdb + h * a.sdh;
    const long long row = (static_cast<long long>(b) * a.H + h) * a.Lq;
    for (int qt = qt0; qt < qt1; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();
      load_tile<T, D>(Qs, LD, qp, a.sql, q0, a.Lq);
      load_tile<T, D>(Os, LD, dp_, a.sdl, q0, a.Lq);
      if (tid < BQ) {
        const int i = q0 + tid;
        Ls[tid] = i < a.Lq ? a.lse_in[row + i] : 0.f;
        Ds[tid] = i < a.Lq ? a.delta[row + i] : 0.f;
      }
      // rows: keys ty + 16r; columns: queries tx + 16c
      bool vis[4][4];
      bool any = false;
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          vis[r][c] = visible(a, segb, q0 + tx + 16 * c, k0 + ty + 16 * r);
          any |= vis[r][c];
        }
      if (!__syncthreads_or(any)) continue;
      float s[4][4] = {}, dp[4][4] = {};
#pragma unroll 2
      for (int d = 0; d < D; ++d) {
        float kv[4], vv[4], qv[4], ov[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          kv[r] = Ks[(ty + 16 * r) * LD + d];
          vv[r] = Vs[(ty + 16 * r) * LD + d];
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          qv[c] = Qs[(tx + 16 * c) * LD + d];
          ov[c] = Os[(tx + 16 * c) * LD + d];
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            s[r][c] += qv[c] * kv[r];
            dp[r][c] += ov[c] * vv[r];
          }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int il = tx + 16 * c;
          const float p =
              vis[r][c] ? expf(s[r][c] * a.scale - Ls[il]) : 0.f;
          const int at = (ty + 16 * r) * (BQ + 1) + il;
          Ps[at] = round_to<T>(p);
          Ss[at] = round_to<T>(p * (dp[r][c] - Ds[il]));
        }
      __syncthreads();
      for (int i = 0; i < BQ; ++i) {
        float pv[4], sv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          pv[r] = Ps[(ty + 16 * r) * (BQ + 1) + i];
          sv[r] = Ss[(ty + 16 * r) * (BQ + 1) + i];
        }
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          const float ov = Os[i * LD + tx + 16 * c];
          const float qv = Qs[i * LD + tx + 16 * c];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            dv[r][c] += pv[r] * ov;
            dk[r][c] += sv[r] * qv;
          }
        }
      }
    }
  }
  T* dko = static_cast<T*>(a.dk);
  T* dvo = static_cast<T*>(a.dv);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int j = k0 + ty + 16 * r;
    if (j >= a.Lk) continue;
    const long long at =
        ((static_cast<long long>(b) * a.Lk + j) * a.KVH + kvh) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      dko[at + tx + 16 * c] = from_f<T>(dk[r][c] * a.scale);
      dvo[at + tx + 16 * c] = from_f<T>(dv[r][c]);
    }
  }
}

// ------------------------------------ bf16 backward on the tensor cores

// Shared-memory tiles are [64][D + 8] bf16: the 16 bytes of padding move
// each row four banks on, so the eight 16-byte rows an ldmatrix reads fall
// in distinct banks.
constexpr int TC_THREADS = 128;  // 4 warps, 16 rows of the tile each

template <int D>
struct TcTile {
  static constexpr int LDS = D + 8;             // elements a row
  static constexpr int BYTES = 64 * LDS * 2;    // one 64-row tile
  static constexpr int NT = D / 8;              // n8 tiles across D
};

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

// Lane offsets (bytes) into a [64][LDS] tile for the three ldmatrix uses:
// A: the 16x16 block at (row 0, col 0) of a row-major operand;
// B: two n8 tiles of an operand stored [n][k] (non-transposed);
// BT: two n8 tiles of an operand stored [k][n] (.trans).
template <int D>
__device__ __forceinline__ uint32_t off_a(int lane) {
  return ((lane & 15) * TcTile<D>::LDS + (lane >> 4) * 8) * 2;
}
template <int D>
__device__ __forceinline__ uint32_t off_b(int lane) {
  return (((lane & 7) + ((lane >> 4) << 3)) * TcTile<D>::LDS +
          ((lane >> 3) & 1) * 8) * 2;
}
template <int D>
__device__ __forceinline__ uint32_t off_bt(int lane) {
  return (((lane & 7) + ((lane >> 3) & 1) * 8) * TcTile<D>::LDS +
          (lane >> 4) * 8) * 2;
}

// rows [row0, row0 + 64) of one head's [L, D] bf16 slice (row stride sl,
// 16-byte aligned) into a [64][LDS] tile; rows at or past limit are zeros
template <int D>
__device__ __forceinline__ void load_tile_async(
    uint32_t dst, const __nv_bfloat16* __restrict__ src, long long sl,
    int row0, int limit) {
  constexpr int CH = D / 8;  // 16-byte chunks a row
#pragma unroll
  for (int it = 0; it < 64 * CH / TC_THREADS; ++it) {
    const int idx = threadIdx.x + it * TC_THREADS;
    const int r = idx / CH, c = idx % CH;
    const bool ok = row0 + r < limit;
    cp_async16(dst + (r * TcTile<D>::LDS + c * 8) * 2,
               ok ? src + (row0 + r) * sl + c * 8 : src, ok);
  }
}

// Does the tile [q0, q0 + 64) x [k0, k0 + 64) need the per-element mask:
// the diagonal, the window's edge, segments or the ragged edge cut it
__device__ __forceinline__ bool tile_cut(const Args& a, int q0, int k0) {
  if (a.seg != nullptr || q0 + BQ > a.Lq || k0 + BK > a.Lk) return true;
  if (!a.causal) return false;
  if (k0 + BK - 1 > q0) return true;
  return a.window > 0 && q0 + BQ - 1 - k0 >= a.window;
}

constexpr float LOG2E = 1.4426950408889634f;

// The forward: one block per (q head, batch, q tile of 64), heavy causal
// tiles first; warp w owns queries q0 + 16w .. +15, keeps their Q as A
// fragments in registers (loaded once) and walks the visible k tiles,
// K/V double-buffered by cp.async. The online softmax runs on the S
// accumulators: m (raw scores) and l per row, reduced over the quad of
// lanes that shares a row; p enters P.V as bf16 in the A-fragment layout.
template <int D>
__global__ void __launch_bounds__(TC_THREADS, 2)
    fwd_kernel_tc(const Args a) {
  using bf16 = __nv_bfloat16;
  using TT = TcTile<D>;
  constexpr int NT = TT::NT;
  constexpr int KS = D / 16;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  const uint32_t sQ = smem_u32(tc_smem);
  // stage s: K at sQ + (1 + 2s) tiles, V right after it
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gr = lane / 4, tq = lane % 4;
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;
  const int kvh = h / (a.H / a.KVH);
  const bf16* qp = static_cast<const bf16*>(a.q) + b * a.sqb + h * a.sqh;
  const bf16* kp = static_cast<const bf16*>(a.k) + b * a.skb + kvh * a.skh;
  const bf16* vp = static_cast<const bf16*>(a.v) + b * a.svb + kvh * a.svh;
  const int* segb =
      a.seg ? a.seg + static_cast<long long>(b) * a.Lk : nullptr;

  int kt0, kt1;
  kv_range(a, q0, &kt0, &kt1);
  load_tile_async<D>(sQ, qp, a.sql, q0, a.Lq);
  cp_commit();
  if (kt0 < kt1) {
    load_tile_async<D>(sQ + TT::BYTES, kp, a.skl, kt0 * BK, a.Lk);
    load_tile_async<D>(sQ + 2 * TT::BYTES, vp, a.svl, kt0 * BK, a.Lk);
  }
  cp_commit();
  cp_wait<1>();  // Q has landed (the first K/V tile may still be in flight)
  __syncthreads();
  const uint32_t oa = off_a<D>(lane) + 16 * warp * TT::LDS * 2;
  const uint32_t ob = off_b<D>(lane), obt = off_bt<D>(lane);
  uint32_t qa[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) ldsm_x4(qa[kk], sQ + oa + kk * 32);

  const int i0 = q0 + 16 * warp + gr;  // this thread's rows: i0, i0 + 8
  const float sl2 = a.scale * LOG2E;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int kt = kt0; kt < kt1; ++kt) {
    const int st = (kt - kt0) & 1;
    if (kt + 1 < kt1) {
      const uint32_t nk = sQ + (1 + 2 * (st ^ 1)) * TT::BYTES;
      load_tile_async<D>(nk, kp, a.skl, (kt + 1) * BK, a.Lk);
      load_tile_async<D>(nk + TT::BYTES, vp, a.svl, (kt + 1) * BK, a.Lk);
    }
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    const int k0 = kt * BK;
    const uint32_t sK = sQ + (1 + 2 * st) * TT::BYTES, sV = sK + TT::BYTES;
    // the mask, only where a cut crosses the tile; a warp whose 16 rows
    // see no key of it skips the tile
    const bool cut = tile_cut(a, q0, k0);
    uint32_t vis = 0xffffffffu;
    if (cut) {
      vis = 0;
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (visible(a, segb, i0 + 8 * (e >> 1), k0 + 8 * n + 2 * tq + (e & 1)))
            vis |= 1u << (4 * n + e);
    }
    if (__any_sync(0xffffffffu, vis != 0)) {
      float s[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          uint32_t kb[4];
          ldsm_x4(kb, sK + ob + j * 16 * TT::LDS * 2 + kk * 32);
          mma(s[2 * j], qa[kk], kb[0], kb[1]);
          mma(s[2 * j + 1], qa[kk], kb[2], kb[3]);
        }
      // online softmax over this tile's visible scores; a row that sees
      // none keeps m (NEG_INF is finite, so corr is exp2(0) = 1, not NaN)
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if ((vis >> (4 * n + e)) & 1u)
            mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      float corr[2], rs[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        mx[r] = fmaxf(m[r], mx[r]);
        corr[r] = exp2f((m[r] - mx[r]) * sl2);
        m[r] = mx[r];
      }
      // p = exp((s - m) * scale), summed unrounded into l and rounded to
      // bf16 in the A-fragment layout of P.V (keys are its depth)
      uint32_t pa[4][4];
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[e] = (vis >> (4 * n + e)) & 1u
                     ? exp2f((s[n][e] - m[e >> 1]) * sl2)
                     : 0.f;
          rs[e >> 1] += p[e];
        }
        pa[n / 2][2 * (n & 1)] = pack_bf16(p[0], p[1]);
        pa[n / 2][2 * (n & 1) + 1] = pack_bf16(p[2], p[3]);
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
      // O += P . V
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int j = 0; j < D / 16; ++j) {
          uint32_t vb[4];
          ldsm_x4_t(vb, sV + obt + c * 16 * TT::LDS * 2 + j * 32);
          mma(acc[2 * j], pa[c], vb[0], vb[1]);
          mma(acc[2 * j + 1], pa[c], vb[2], vb[3]);
        }
    }
    __syncthreads();  // this stage is free for the load two tiles on
  }
  cp_wait<0>();
  bf16* out = static_cast<bf16*>(a.out);
  const long long row = (static_cast<long long>(b) * a.H + h) * a.Lq;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = i0 + 8 * r;
    if (i >= a.Lq) continue;
    const float ls = fmaxf(l[r], 1e-30f);
    uint32_t* orow = reinterpret_cast<uint32_t*>(
        out + ((static_cast<long long>(b) * a.Lq + i) * a.H + h) * D);
#pragma unroll
    for (int n = 0; n < NT; ++n)
      orow[4 * n + tq] = pack_bf16(acc[n][2 * r] / ls, acc[n][2 * r + 1] / ls);
    if (tq == 0) a.lse_out[row + i] = m[r] * a.scale + logf(ls);
  }
}

// dQ: one block per (q head, batch, q tile of 64), heavy causal tiles
// first; warp w owns queries q0 + 16w .. +15 and walks the visible k tiles,
// K/V double-buffered by cp.async.
template <int D>
__global__ void __launch_bounds__(TC_THREADS, 2)
    dq_kernel_tc(const Args a) {
  using bf16 = __nv_bfloat16;
  using TT = TcTile<D>;
  constexpr int NT = TT::NT;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  const uint32_t sQ = smem_u32(tc_smem), sO = sQ + TT::BYTES;
  // stage s: K at sQ + (2 + 2s) tiles, V right after it
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gr = lane / 4, tq = lane % 4;
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;
  const int kvh = h / (a.H / a.KVH);
  const bf16* qp = static_cast<const bf16*>(a.q) + b * a.sqb + h * a.sqh;
  const bf16* op = static_cast<const bf16*>(a.dout) + b * a.sdb + h * a.sdh;
  const bf16* kp = static_cast<const bf16*>(a.k) + b * a.skb + kvh * a.skh;
  const bf16* vp = static_cast<const bf16*>(a.v) + b * a.svb + kvh * a.svh;
  const int* segb =
      a.seg ? a.seg + static_cast<long long>(b) * a.Lk : nullptr;

  int kt0, kt1;
  kv_range(a, q0, &kt0, &kt1);
  load_tile_async<D>(sQ, qp, a.sql, q0, a.Lq);
  load_tile_async<D>(sO, op, a.sdl, q0, a.Lq);
  if (kt0 < kt1) {
    load_tile_async<D>(sQ + 2 * TT::BYTES, kp, a.skl, kt0 * BK, a.Lk);
    load_tile_async<D>(sQ + 3 * TT::BYTES, vp, a.svl, kt0 * BK, a.Lk);
  }
  cp_commit();

  // this thread's two query rows: lse and delta, in log2 units
  const long long row = (static_cast<long long>(b) * a.H + h) * a.Lq;
  const int i0 = q0 + 16 * warp + gr;
  float lse2[2], dlt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = i0 + 8 * r;
    lse2[r] = i < a.Lq ? a.lse_in[row + i] * LOG2E : 0.f;
    dlt[r] = i < a.Lq ? a.delta[row + i] : 0.f;
  }
  const float sl2 = a.scale * LOG2E;
  const uint32_t oa = off_a<D>(lane) + 16 * warp * TT::LDS * 2;
  const uint32_t ob = off_b<D>(lane), obt = off_bt<D>(lane);

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int kt = kt0; kt < kt1; ++kt) {
    const int st = (kt - kt0) & 1;
    if (kt + 1 < kt1) {
      const uint32_t nk = sQ + (2 + 2 * (st ^ 1)) * TT::BYTES;
      load_tile_async<D>(nk, kp, a.skl, (kt + 1) * BK, a.Lk);
      load_tile_async<D>(nk + TT::BYTES, vp, a.svl, (kt + 1) * BK, a.Lk);
    }
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    const int k0 = kt * BK;
    const uint32_t sK = sQ + (2 + 2 * st) * TT::BYTES, sV = sK + TT::BYTES;
    // the mask, only where a cut crosses the tile; a warp whose 16 rows
    // see no key of it skips the tile
    const bool cut = tile_cut(a, q0, k0);
    uint32_t vis = 0xffffffffu;
    if (cut) {
      vis = 0;
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (visible(a, segb, i0 + 8 * (e >> 1), k0 + 8 * n + 2 * tq + (e & 1)))
            vis |= 1u << (4 * n + e);
    }
    if (__any_sync(0xffffffffu, vis != 0)) {
      float s[8][4], dp[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t qa[4], da[4];
        ldsm_x4(qa, sQ + oa + kk * 32);
        ldsm_x4(da, sO + oa + kk * 32);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          uint32_t kb[4], vb[4];
          ldsm_x4(kb, sK + ob + j * 16 * TT::LDS * 2 + kk * 32);
          ldsm_x4(vb, sV + ob + j * 16 * TT::LDS * 2 + kk * 32);
          mma(s[2 * j], qa, kb[0], kb[1]);
          mma(s[2 * j + 1], qa, kb[2], kb[3]);
          mma(dp[2 * j], da, vb[0], vb[1]);
          mma(dp[2 * j + 1], da, vb[2], vb[3]);
        }
      }
      // dS = P (dP - delta), rounded to bf16 in the A-fragment layout of
      // the next product (keys are its depth)
      uint32_t ds[4][4];
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        float x[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = (vis >> (4 * n + e)) & 1u
                              ? exp2f(s[n][e] * sl2 - lse2[e >> 1])
                              : 0.f;
          x[e] = p * (dp[n][e] - dlt[e >> 1]);
        }
        ds[n / 2][2 * (n & 1)] = pack_bf16(x[0], x[1]);
        ds[n / 2][2 * (n & 1) + 1] = pack_bf16(x[2], x[3]);
      }
      // dQ += dS . K
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int j = 0; j < D / 16; ++j) {
          uint32_t kb[4];
          ldsm_x4_t(kb, sK + obt + c * 16 * TT::LDS * 2 + j * 32);
          mma(acc[2 * j], ds[c], kb[0], kb[1]);
          mma(acc[2 * j + 1], ds[c], kb[2], kb[3]);
        }
    }
    __syncthreads();  // this stage is free for the load two tiles on
  }
  cp_wait<0>();
  bf16* dq = static_cast<bf16*>(a.dq);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = i0 + 8 * r;
    if (i >= a.Lq) continue;
    uint32_t* qrow = reinterpret_cast<uint32_t*>(
        dq + ((static_cast<long long>(b) * a.Lq + i) * a.H + h) * D);
#pragma unroll
    for (int n = 0; n < NT; ++n)
      qrow[4 * n + tq] =
          pack_bf16(acc[n][2 * r] * a.scale, acc[n][2 * r + 1] * a.scale);
  }
}

// dK/dV: one block per (KV head x split of its query group, batch, k tile
// of 64), early (heavy causal) k tiles first; warp w owns keys
// k0 + 16w .. +15 and walks (q head, q tile) pairs, Q/dO tiles and their
// lse/delta rows double-buffered by cp.async. With splits > 1 each block
// writes fp32 partial sums of its heads to part[2][splits][B, Lk, KVH, D]
// and dkv_reduce adds them in split order.
template <int D>
__global__ void __launch_bounds__(TC_THREADS, 2)
    dkv_kernel_tc(const Args a, float* __restrict__ part, int splits) {
  using bf16 = __nv_bfloat16;
  using TT = TcTile<D>;
  constexpr int NT = TT::NT;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  // K, V, then per stage s: Q, dO, lse [64], delta [64]
  constexpr int STAGE = 2 * TT::BYTES + 2 * 64 * 4;
  const uint32_t sK = smem_u32(tc_smem), sV = sK + TT::BYTES;
  const uint32_t sS0 = sK + 2 * TT::BYTES;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gr = lane / 4, tq = lane % 4;
  const int split = blockIdx.x % splits, kvh = blockIdx.x / splits;
  const int b = blockIdx.y, k0 = blockIdx.z * BK;
  const int G = a.H / a.KVH, per = G / splits, g0 = split * per;
  const bf16* kp = static_cast<const bf16*>(a.k) + b * a.skb + kvh * a.skh;
  const bf16* vp = static_cast<const bf16*>(a.v) + b * a.svb + kvh * a.svh;
  const int* segb =
      a.seg ? a.seg + static_cast<long long>(b) * a.Lk : nullptr;

  // q tiles that can see a key of [k0, k0 + 64)
  const int nq = (a.Lq + BQ - 1) / BQ;
  int qt0 = 0, qt1 = nq;
  if (a.causal) {
    qt0 = k0 / BQ;
    if (a.window > 0) {
      const int klast = min(k0 + BK, a.Lk) - 1;
      qt1 = min(nq, (klast + a.window - 1) / BQ + 1);
    }
  }
  const int nqt = max(qt1 - qt0, 0), total = per * nqt;

  // (q head, q tile) pair n into stage st
  auto issue = [&](int n, int st) {
    const int h = kvh * G + g0 + n / nqt, q0 = (qt0 + n % nqt) * BQ;
    const uint32_t base = sS0 + st * STAGE;
    load_tile_async<D>(base,
                       static_cast<const bf16*>(a.q) + b * a.sqb + h * a.sqh,
                       a.sql, q0, a.Lq);
    load_tile_async<D>(base + TT::BYTES,
                       static_cast<const bf16*>(a.dout) + b * a.sdb +
                           h * a.sdh,
                       a.sdl, q0, a.Lq);
    const long long row = (static_cast<long long>(b) * a.H + h) * a.Lq;
    const int t = tid & 63, i = q0 + t;
    const float* src = (tid < 64 ? a.lse_in : a.delta) + row;
    cp_async4(base + 2 * TT::BYTES + (tid < 64 ? 0 : 256) + 4 * t,
              i < a.Lq ? src + i : src, i < a.Lq);
  };

  load_tile_async<D>(sK, kp, a.skl, k0, a.Lk);
  load_tile_async<D>(sV, vp, a.svl, k0, a.Lk);
  if (total > 0) issue(0, 0);
  cp_commit();

  const float sl2 = a.scale * LOG2E;
  const uint32_t oa = off_a<D>(lane) + 16 * warp * TT::LDS * 2;
  const uint32_t ob = off_b<D>(lane), obt = off_bt<D>(lane);
  const int j0 = k0 + 16 * warp + gr;  // this thread's keys: j0, j0 + 8

  float dk[NT][4], dv[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  for (int n = 0; n < total; ++n) {
    const int st = n & 1;
    if (n + 1 < total) issue(n + 1, st ^ 1);
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    const int q0 = (qt0 + n % nqt) * BQ;
    const uint32_t sQ = sS0 + st * STAGE, sO = sQ + TT::BYTES;
    // past K, V and this stage's Q and dO: lse [64], then delta [64]
    const float* ls = reinterpret_cast<const float*>(
        tc_smem + 4 * TT::BYTES + st * STAGE);
    const float* dl = ls + 64;
    const bool cut = tile_cut(a, q0, k0);
    uint32_t vis = 0xffffffffu;  // rows: keys j0 (+8); columns: queries
    if (cut) {
      vis = 0;
#pragma unroll
      for (int c = 0; c < 8; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (visible(a, segb, q0 + 8 * c + 2 * tq + (e & 1),
                      j0 + 8 * (e >> 1)))
            vis |= 1u << (4 * c + e);
    }
    if (__any_sync(0xffffffffu, vis != 0)) {
      // S^T = K Q^T and dP^T = V dO^T, [16 keys x 64 queries] a warp
      float s[8][4], dp[8][4];
#pragma unroll
      for (int c = 0; c < 8; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[c][e] = dp[c][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t ka[4], va[4];
        ldsm_x4(ka, sK + oa + kk * 32);
        ldsm_x4(va, sV + oa + kk * 32);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          uint32_t qb[4], ob4[4];
          ldsm_x4(qb, sQ + ob + j * 16 * TT::LDS * 2 + kk * 32);
          ldsm_x4(ob4, sO + ob + j * 16 * TT::LDS * 2 + kk * 32);
          mma(s[2 * j], ka, qb[0], qb[1]);
          mma(s[2 * j + 1], ka, qb[2], qb[3]);
          mma(dp[2 * j], va, ob4[0], ob4[1]);
          mma(dp[2 * j + 1], va, ob4[2], ob4[3]);
        }
      }
      // P^T and dS^T = P^T (dP^T - delta), each rounded to bf16 in the
      // A-fragment layout of the next product (queries are its depth)
      uint32_t pa[4][4], sa[4][4];
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int col = 8 * c + 2 * tq;
        const float2 l2 = *reinterpret_cast<const float2*>(ls + col);
        const float2 d2 = *reinterpret_cast<const float2*>(dl + col);
        float p[4], x[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float lse = (e & 1) ? l2.y : l2.x;
          const float dlt = (e & 1) ? d2.y : d2.x;
          p[e] = (vis >> (4 * c + e)) & 1u
                     ? exp2f(s[c][e] * sl2 - lse * LOG2E)
                     : 0.f;
          x[e] = p[e] * (dp[c][e] - dlt);
        }
        pa[c / 2][2 * (c & 1)] = pack_bf16(p[0], p[1]);
        pa[c / 2][2 * (c & 1) + 1] = pack_bf16(p[2], p[3]);
        sa[c / 2][2 * (c & 1)] = pack_bf16(x[0], x[1]);
        sa[c / 2][2 * (c & 1) + 1] = pack_bf16(x[2], x[3]);
      }
      // dV += P^T dO, dK += dS^T Q
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int j = 0; j < D / 16; ++j) {
          uint32_t ob4[4], qb[4];
          ldsm_x4_t(ob4, sO + obt + c * 16 * TT::LDS * 2 + j * 32);
          ldsm_x4_t(qb, sQ + obt + c * 16 * TT::LDS * 2 + j * 32);
          mma(dv[2 * j], pa[c], ob4[0], ob4[1]);
          mma(dv[2 * j + 1], pa[c], ob4[2], ob4[3]);
          mma(dk[2 * j], sa[c], qb[0], qb[1]);
          mma(dk[2 * j + 1], sa[c], qb[2], qb[3]);
        }
    }
    __syncthreads();  // this stage is free for the load two pairs on
  }
  cp_wait<0>();
  const long long N = static_cast<long long>(a.B) * a.Lk * a.KVH * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int j = j0 + 8 * r;
    if (j >= a.Lk) continue;
    const long long at =
        ((static_cast<long long>(b) * a.Lk + j) * a.KVH + kvh) * D + 2 * tq;
    if (splits == 1) {
      uint32_t* ko = reinterpret_cast<uint32_t*>(static_cast<bf16*>(a.dk) + at);
      uint32_t* vo = reinterpret_cast<uint32_t*>(static_cast<bf16*>(a.dv) + at);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        ko[4 * n] = pack_bf16(dk[n][2 * r] * a.scale,
                              dk[n][2 * r + 1] * a.scale);
        vo[4 * n] = pack_bf16(dv[n][2 * r], dv[n][2 * r + 1]);
      }
    } else {
      float2* ko = reinterpret_cast<float2*>(part + split * N + at);
      float2* vo = reinterpret_cast<float2*>(part + (splits + split) * N + at);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        ko[4 * n] = make_float2(dk[n][2 * r], dk[n][2 * r + 1]);
        vo[4 * n] = make_float2(dv[n][2 * r], dv[n][2 * r + 1]);
      }
    }
  }
}

// dk = scale * sum_s part[0][s], dv = sum_s part[1][s], in split order
// (deterministic), four elements a thread; n4 = B * Lk * KVH * D / 4
__global__ void __launch_bounds__(256)
    dkv_reduce(const float4* __restrict__ part, int splits, long long n4,
               float scale, __nv_bfloat16* dk, __nv_bfloat16* dv) {
  for (long long i = blockIdx.x * 256ll + threadIdx.x; i < n4;
       i += gridDim.x * 256ll) {
    float4 k = make_float4(0.f, 0.f, 0.f, 0.f), v = k;
    for (int s = 0; s < splits; ++s) {
      const float4 x = part[s * n4 + i], y = part[(splits + s) * n4 + i];
      k.x += x.x, k.y += x.y, k.z += x.z, k.w += x.w;
      v.x += y.x, v.y += y.y, v.z += y.z, v.w += y.w;
    }
    uint2 ko, vo;
    ko.x = pack_bf16(k.x * scale, k.y * scale);
    ko.y = pack_bf16(k.z * scale, k.w * scale);
    vo.x = pack_bf16(v.x, v.y);
    vo.y = pack_bf16(v.z, v.w);
    reinterpret_cast<uint2*>(dk)[i] = ko;
    reinterpret_cast<uint2*>(dv)[i] = vo;
  }
}

template <int D>
constexpr size_t fwd_tc_smem() {
  return 5 * TcTile<D>::BYTES;  // Q, two stages of K and V
}
template <int D>
constexpr size_t dq_tc_smem() {
  return 6 * TcTile<D>::BYTES;  // Q, dO, two stages of K and V
}
template <int D>
constexpr size_t dkv_tc_smem() {
  return 2 * TcTile<D>::BYTES + 2 * (2 * TcTile<D>::BYTES + 2 * 64 * 4);
}

// ------------------------------------------------------------- launches

template <typename K, typename... P>
int launch(K kern, dim3 grid, int threads, size_t smem, cudaStream_t stream,
           const P&... args) {
  if (grid.x == 0 || grid.y == 0 || grid.z == 0) return 0;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  kern<<<grid, threads, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

// bf16 on the tensor cores: the forward (which 0), dQ (1), or dK/dV (2)
// with its query group split over `splits` blocks and their partials in
// `part`
template <int D>
int run_tc(int which, const Args& a, float* part, int splits,
           cudaStream_t st) {
  const unsigned nq = (a.Lq + BQ - 1) / BQ, nk = (a.Lk + BK - 1) / BK;
  if (which == 0)
    return launch(fwd_kernel_tc<D>, dim3(a.H, a.B, nq), TC_THREADS,
                  fwd_tc_smem<D>(), st, a);
  if (which == 1)
    return launch(dq_kernel_tc<D>, dim3(a.H, a.B, nq), TC_THREADS,
                  dq_tc_smem<D>(), st, a);
  if (splits < 1 || (a.H / a.KVH) % splits != 0 ||
      (splits > 1 && part == nullptr))
    return -1;
  const int e = launch(dkv_kernel_tc<D>, dim3(a.KVH * splits, a.B, nk),
                       TC_THREADS, dkv_tc_smem<D>(), st, a, part, splits);
  if (e != 0 || splits == 1 || nk == 0 || a.B == 0) return e;
  const long long n4 = static_cast<long long>(a.B) * a.Lk * a.KVH * D / 4;
  const int blocks = static_cast<int>(min(
      (n4 + 255) / 256, static_cast<long long>(132 * 16)));
  dkv_reduce<<<blocks, 256, 0, st>>>(
      reinterpret_cast<const float4*>(part), splits, n4, a.scale,
      static_cast<__nv_bfloat16*>(a.dk), static_cast<__nv_bfloat16*>(a.dv));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int run(int which, const Args& a, float* part, int splits,
        cudaStream_t st) {
  constexpr size_t LD = D + 1;
  const unsigned nq = (a.Lq + BQ - 1) / BQ, nk = (a.Lk + BK - 1) / BK;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    return run_tc<D>(which, a, part, splits, st);
  } else {
    if (which == 0)
      return launch(fwd_kernel<T, D>, dim3(nq, a.H, a.B), THREADS,
                    (BQ * LD + BK * LD + BK * D + BQ * (BK + 1)) *
                        sizeof(float),
                    st, a);
    if (which == 1)
      return launch(dq_kernel<T, D>, dim3(nq, a.H, a.B), THREADS,
                    (2 * BQ * LD + 2 * BK * LD + BQ * (BK + 1)) *
                        sizeof(float),
                    st, a);
    return launch(dkv_kernel<T, D>, dim3(nk, a.KVH, a.B), THREADS,
                  (2 * BK * LD + 2 * BQ * LD + 2 * BK * (BQ + 1) + 2 * BQ) *
                      sizeof(float),
                  st, a);
  }
}

template <typename K>
int resources(K kern, size_t smem, int* smem_out, int* blocks) {
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  *smem_out = static_cast<int>(smem);
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kern,
                                                    TC_THREADS, smem);
  return static_cast<int>(e);
}

}  // namespace

// which: 0 = forward, 1 = dQ, 2 = dK/dV. dtype: 0 = float32,
// 1 = bfloat16. strides: 12 element strides (batch, sequence, head) of
// q, k, v and dO, in that order. Pointers a kernel does not read may be
// null; seg is null without segments. For bf16 dK/dV, splits (a divisor
// of H / KVH) blocks share each KV head's query group; with splits > 1,
// part is fp32 scratch of 2 * splits * B * Lk * KVH * D elements (the
// fp32 kernels take splits = 1). The bf16 kernels read 16-byte rows: q,
// k, v and dO must be 16-byte aligned with strides that are multiples of
// 8. Returns cudaGetLastError() after the launch (0 =
// launched), or -1 for a dtype, head dim or split the kernels are not
// built for.
extern "C" int tony_flash_attention(
    int which, int dtype, int D, const void* q, const void* k, const void* v,
    const void* dout, const void* seg, const void* lse_in,
    const void* delta, void* out, void* lse_out, void* dq, void* dk,
    void* dv, void* part, const long long* strides, int B, int H, int KVH,
    int Lq, int Lk, int causal, int window, int splits, float scale,
    void* stream) {
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.seg = static_cast<const int*>(seg);
  a.lse_in = static_cast<const float*>(lse_in);
  a.delta = static_cast<const float*>(delta);
  a.out = out;
  a.lse_out = static_cast<float*>(lse_out);
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.sqb = strides[0], a.sql = strides[1], a.sqh = strides[2];
  a.skb = strides[3], a.skl = strides[4], a.skh = strides[5];
  a.svb = strides[6], a.svl = strides[7], a.svh = strides[8];
  a.sdb = strides[9], a.sdl = strides[10], a.sdh = strides[11];
  a.B = B, a.H = H, a.KVH = KVH, a.Lq = Lq, a.Lk = Lk;
  a.causal = causal, a.window = window, a.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* pf = static_cast<float*>(part);
  if (which < 0 || which > 2) return -1;
  if (dtype == 0 && D == 64) return run<float, 64>(which, a, pf, 1, st);
  if (dtype == 0 && D == 128) return run<float, 128>(which, a, pf, 1, st);
  if (dtype == 1 && D == 64)
    return run<__nv_bfloat16, 64>(which, a, pf, splits, st);
  if (dtype == 1 && D == 128)
    return run<__nv_bfloat16, 128>(which, a, pf, splits, st);
  return -1;
}

// The bf16 tensor-core kernel `which` (0 = forward, 1 = dQ, 2 = dK/dV) at
// head dim D: its dynamic shared memory in bytes and how many of its
// blocks fit on one SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
// Returns a CUDA error, or -1 for a kernel that is not built.
extern "C" int tony_flash_attention_resources(int which, int D,
                                              int* smem_bytes,
                                              int* blocks_per_sm) {
  if (which == 0 && D == 64)
    return resources(fwd_kernel_tc<64>, fwd_tc_smem<64>(), smem_bytes,
                     blocks_per_sm);
  if (which == 0 && D == 128)
    return resources(fwd_kernel_tc<128>, fwd_tc_smem<128>(), smem_bytes,
                     blocks_per_sm);
  if (which == 1 && D == 64)
    return resources(dq_kernel_tc<64>, dq_tc_smem<64>(), smem_bytes,
                     blocks_per_sm);
  if (which == 1 && D == 128)
    return resources(dq_kernel_tc<128>, dq_tc_smem<128>(), smem_bytes,
                     blocks_per_sm);
  if (which == 2 && D == 64)
    return resources(dkv_kernel_tc<64>, dkv_tc_smem<64>(), smem_bytes,
                     blocks_per_sm);
  if (which == 2 && D == 128)
    return resources(dkv_kernel_tc<128>, dkv_tc_smem<128>(), smem_bytes,
                     blocks_per_sm);
  return -1;
}
