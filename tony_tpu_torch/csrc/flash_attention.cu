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
// Design (a first kernel that is right; tensor cores, cp.async/TMA and
// pipelining are the next step, ROADMAP queue 2, K1):
// - CUDA blocks run in no order, so the TPU grid's sequential kv axis
//   (the online softmax carried in VMEM scratch) becomes a loop inside
//   the block: one block per (q tile of 64, head, batch) for the forward
//   and dQ, and one per (k tile of 64, KV head, batch) for dK/dV, which
//   loops over every q head of the group and every visible q tile and so
//   writes dK/dV once, with no atomics (deterministic);
// - tiles are staged in shared memory as fp32 (rows padded to D + 1 so
//   the 16x16 threads read without bank conflicts); each thread holds a
//   4x4 tile of scores (rows ty + 16r, columns tx + 16c) and an fp32
//   accumulator of 4 rows x D/16 columns; products are fp32 FMAs;
// - the tile loop covers only the range that causality and the window
//   leave visible, and a tile that the segments (or the ragged edge)
//   leave wholly invisible is skipped after one vote of the block;
// - cast points as the TPU kernels: p is rounded to the input dtype
//   before P.V and before P^T.dO, dS before dS.K and dS^T.Q; every sum
//   is fp32; the softmax scale folds into the exp, and dQ/dK take it
//   once at the end.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

// ------------------------------------------------------------- launches

template <typename K>
int launch(K kern, dim3 grid, size_t smem, const Args& a,
           cudaStream_t stream) {
  if (grid.x == 0 || grid.y == 0 || grid.z == 0) return 0;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  kern<<<grid, THREADS, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int run(int which, const Args& a, cudaStream_t st) {
  constexpr size_t LD = D + 1;
  const unsigned nq = (a.Lq + BQ - 1) / BQ, nk = (a.Lk + BK - 1) / BK;
  if (which == 0)
    return launch(fwd_kernel<T, D>, dim3(nq, a.H, a.B),
                  (BQ * LD + BK * LD + BK * D + BQ * (BK + 1)) *
                      sizeof(float),
                  a, st);
  if (which == 1)
    return launch(dq_kernel<T, D>, dim3(nq, a.H, a.B),
                  (2 * BQ * LD + 2 * BK * LD + BQ * (BK + 1)) *
                      sizeof(float),
                  a, st);
  return launch(dkv_kernel<T, D>, dim3(nk, a.KVH, a.B),
                (2 * BK * LD + 2 * BQ * LD + 2 * BK * (BQ + 1) + 2 * BQ) *
                    sizeof(float),
                a, st);
}

}  // namespace

// which: 0 = forward, 1 = dQ, 2 = dK/dV. dtype: 0 = float32,
// 1 = bfloat16. strides: 12 element strides (batch, sequence, head) of
// q, k, v and dO, in that order. Pointers a kernel does not read may be
// null; seg is null without segments. Returns cudaGetLastError() after
// the launch (0 = launched), or -1 for a dtype or head dim the kernels
// are not built for.
extern "C" int tony_flash_attention(
    int which, int dtype, int D, const void* q, const void* k, const void* v,
    const void* dout, const void* seg, const void* lse_in,
    const void* delta, void* out, void* lse_out, void* dq, void* dk,
    void* dv, const long long* strides, int B, int H, int KVH, int Lq,
    int Lk, int causal, int window, float scale, void* stream) {
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
  if (which < 0 || which > 2) return -1;
  if (dtype == 0 && D == 64) return run<float, 64>(which, a, st);
  if (dtype == 0 && D == 128) return run<float, 128>(which, a, st);
  if (dtype == 1 && D == 64) return run<__nv_bfloat16, 64>(which, a, st);
  if (dtype == 1 && D == 128) return run<__nv_bfloat16, 128>(which, a, st);
  return -1;
}
