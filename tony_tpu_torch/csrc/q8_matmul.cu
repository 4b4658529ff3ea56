// int8 weight-only matrix product on Hopper:
//   out[i, j] = cast((sum_k x[i, k] * q[k, j]) * scale[j])
// x [m, k] fp32 or bf16, q [k, n] int8 (row-major: n is contiguous, the
// JAX layout), scale [n] fp32, out [m, n] fp32 or bf16. Products and
// sums are fp32 FMAs (an int8 value is exact in fp32 and in bf16; a bf16
// x times an int8 q is exact in fp32), the scale is applied once per
// output, then one rounding to the output type.
//
// Replaces the Pallas TPU kernel of tony_tpu/ops/quant.py,
// _q8_matmul_kernel (:42), launched by q8_matmul (:55), which keeps the
// whole K extent of a [k, bn] weight tile in VMEM. On Hopper 8960 x 256
// int8 is 2.3 MB, ten times a block's shared memory, so here K is walked
// in BK-deep chunks staged in shared memory.
//
// What bounds it on an H100:
//  - decode (m = batch, 1-32): bytes. The weights are read once: k * n
//    bytes (13.8 MB for Qwen2.5-1.5B's wi, 4.1 us at 3.35 TB/s), against
//    2 m k n flops.
//  - prefill and scoring (m up to thousands): operations. 2 m k n flops
//    (112.7 GFLOP for wi at m = 4096) against the fp32 peak outside the
//    tensor cores (67 TFLOP/s) for an fp32 x, since the products must be
//    fp32 (a bf16 or TF32 product would round x), and against the bf16
//    tensor-core peak (989 TFLOP/s) for a bf16 x. This kernel is SIMT
//    fp32 for both; tensor cores for bf16 x are a later step.
//
// Design: a tiled SIMT GEMM, 256 threads a block, each thread TM x TN
// outputs held in registers. Per BK-deep chunk the block loads the int8
// weight tile as 16-byte vectors (neighbouring threads on neighbouring
// n, so a warp reads whole 128-byte rows), converts it to fp32 in shared
// memory, and loads the x tile likewise (transposed, k-major). The next
// chunk's loads are issued into registers before the current chunk's
// products, so they overlap. Two tile shapes: "skinny" (16 x 128, 64
// deep) for decode, where warps whose rows lie past m skip the products,
// and 128 x 128 (32 deep) otherwise. When the (m, n) tiles are too few
// to fill the card, K is split over gridDim.z blocks that write fp32
// partial sums; a second kernel adds them in split order, applies the
// scale and rounds. Any m, n, k: ragged edges load zeros, stores are
// bounds-checked, and vector loads are used only where the row stride
// and the base pointer allow them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;  // threads a block

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
template <>  // bf16 held as its raw 16 bits
__device__ __forceinline__ float x_at<uint16_t>(const V16& u, int j) {
  return __uint_as_float((u.w[j >> 1] >> (16 * (j & 1))) << 16);
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
template <>
__device__ __forceinline__ uint32_t x_bits<uint16_t>(uint16_t e) {
  return e;
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

// BM x BN outputs a block, BK-deep chunks, TM x TN outputs a thread.
// A thread's rows come in groups of RG = min(TM, 4) and its columns in
// groups of 4, the groups spread over the tile so that neighbouring
// threads read neighbouring shared-memory words.
template <typename XT, typename OT, int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__(NT)
    q8_matmul_kernel(const XT* __restrict__ x, const int8_t* __restrict__ w,
                     const float* __restrict__ scale, OT* __restrict__ out,
                     float* __restrict__ part, int m, int n, int k, int kps,
                     int vec_x, int vec_w) {
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
  const int kbeg = blockIdx.z * kps;
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

  const bool split = gridDim.z > 1;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = m0 + row_of(i);
    if (r >= m) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = n0 + col_of(j);
      if (c >= n) continue;
      if (split)
        part[((size_t)blockIdx.z * m + r) * n + c] = acc[i][j];
      else
        out[(size_t)r * n + c] = to_out<OT>(acc[i][j] * scale[c]);
    }
  }
}

// the split-K partials [splits, m, n], added in split order, then the
// scale and one rounding
template <typename OT>
__global__ void __launch_bounds__(NT)
    q8_combine_kernel(const float* __restrict__ part,
                      const float* __restrict__ scale, OT* __restrict__ out,
                      int m, int n, int splits) {
  const size_t total = (size_t)m * n;
  for (size_t e = (size_t)blockIdx.x * NT + threadIdx.x; e < total;
       e += (size_t)gridDim.x * NT) {
    float s = 0.f;
    for (int z = 0; z < splits; ++z) s += part[z * total + e];
    out[e] = to_out<OT>(s * scale[e % n]);
  }
}

// tile shapes: {BM, BN, BK}; [0] general, [1] skinny (decode)
constexpr int TILES[2][3] = {{128, 128, 32}, {16, 128, 64}};

template <typename XT, typename OT>
int launch(const void* x, const void* w, const void* scale, void* out,
           void* part, int m, int n, int k, int splits, int kps, int skinny,
           cudaStream_t st) {
  const int* t = TILES[skinny ? 1 : 0];
  const dim3 grid((n + t[1] - 1) / t[1], (m + t[0] - 1) / t[0], splits);
  const int vec_x = (k % (16 / (int)sizeof(XT)) == 0) &&
                    (reinterpret_cast<uintptr_t>(x) % 16 == 0);
  const int vec_w =
      (n % 16 == 0) && (reinterpret_cast<uintptr_t>(w) % 16 == 0);
  const XT* xp = static_cast<const XT*>(x);
  const int8_t* wp = static_cast<const int8_t*>(w);
  const float* sp = static_cast<const float*>(scale);
  OT* op = static_cast<OT*>(out);
  float* pp = static_cast<float*>(part);
  if (skinny)
    q8_matmul_kernel<XT, OT, 16, 128, 64, 2, 4><<<grid, NT, 0, st>>>(
        xp, wp, sp, op, pp, m, n, k, kps, vec_x, vec_w);
  else
    q8_matmul_kernel<XT, OT, 128, 128, 32, 8, 8><<<grid, NT, 0, st>>>(
        xp, wp, sp, op, pp, m, n, k, kps, vec_x, vec_w);
  if (splits > 1) {
    const size_t total = (size_t)m * n;
    const int blocks = (int)((total + NT - 1) / NT < 8192
                                 ? (total + NT - 1) / NT
                                 : 8192);
    q8_combine_kernel<OT><<<blocks, NT, 0, st>>>(pp, sp, op, m, n, splits);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. x [m, k], w [k, n] int8,
// scale [n] fp32 and out [m, n] are contiguous device arrays; `part` is
// fp32 scratch of splits * m * n elements when splits > 1 (else unused),
// and `kps` the K extent of a split, a multiple of the tile's BK.
// Returns cudaGetLastError() after the launches (0 = launched), or -1
// for dtypes the kernel is not built for.
extern "C" int tony_q8_matmul(int x_code, int out_code, const void* x,
                              const void* w, const void* scale, void* out,
                              void* part, int m, int n, int k, int splits,
                              int kps, int skinny, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_code == 0 && out_code == 0)
    return launch<float, float>(x, w, scale, out, part, m, n, k, splits,
                                kps, skinny, st);
  if (x_code == 0 && out_code == 1)
    return launch<float, __nv_bfloat16>(x, w, scale, out, part, m, n, k,
                                        splits, kps, skinny, st);
  if (x_code == 1 && out_code == 0)
    return launch<uint16_t, float>(x, w, scale, out, part, m, n, k, splits,
                                   kps, skinny, st);
  if (x_code == 1 && out_code == 1)
    return launch<uint16_t, __nv_bfloat16>(x, w, scale, out, part, m, n, k,
                                           splits, kps, skinny, st);
  return -1;
}

// the tile shape the wrapper plans splits with: which = 0, 1, 2 gives
// BM, BN, BK of the general (skinny = 0) or decode (skinny = 1) tile
extern "C" int tony_q8_matmul_tile(int skinny, int which) {
  return TILES[skinny ? 1 : 0][which];
}
