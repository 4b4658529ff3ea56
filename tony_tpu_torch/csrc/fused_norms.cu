// RMSNorm and residual-add + RMSNorm on Hopper, one warp a row:
//   rmsnorm:      out = x * rsqrt(mean(x^2) + eps) * scale
//   add_rmsnorm:  s = x + r (fp32); summed = cast(s);
//                 normed = s * rsqrt(mean(s^2) + eps) * scale
// over rows of D elements, in fp32, each output rounded once to x's
// type. add_rmsnorm takes the norm of the fp32 sum, not of the sum
// after it is rounded for storage.
//
// Replaces the Pallas TPU kernels of tony_tpu/ops/fused.py,
// _rmsnorm_kernel (:19, launched by rmsnorm :34) and _add_rmsnorm_kernel
// (:26, launched by add_rmsnorm :57), which normalise a block of rows in
// VMEM.
//
// What bounds it on an H100: bytes. A few flops an element against the
// element's bytes in and out: rows * D * (in + out) over 3.35 TB/s (for
// D = 1536 and 8192 bf16 rows, 50 MB in 15 us).
//
// Design: eight warps a block, one row a warp. A lane reads eight
// elements at a time with 16-byte loads (two for fp32) where D and the
// pointers allow it, else one at a time; the sum of squares is taken in
// fp32 by each lane and then across the warp with shuffles, so no shared
// memory and no block barrier. A second pass re-reads the row (from L1
// or L2, it was just read), scales it and writes the outputs. The
// operand dtypes (x, the residual and the scale: fp32 or bf16 each) are
// template parameters.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;  // rows a block
constexpr int VEC = 8;    // elements a lane loads at a time

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// VEC elements from p as fp32, by 16-byte loads (two for fp32)
template <typename T>
__device__ __forceinline__ void load8(const T* __restrict__ p,
                                      float (&f)[VEC]) {
  constexpr int PER = 16 / sizeof(T);  // elements a 16-byte load
#pragma unroll
  for (int h = 0; h < VEC / PER; ++h) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p) + h);
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int j = 0; j < PER; ++j) f[h * PER + j] = to_f(e[j]);
  }
}

template <typename T>
__device__ __forceinline__ void store8(T* __restrict__ p,
                                       const float (&f)[VEC]) {
  constexpr int PER = 16 / sizeof(T);
#pragma unroll
  for (int h = 0; h < VEC / PER; ++h) {
    uint4 u;
    T* e = reinterpret_cast<T*>(&u);
#pragma unroll
    for (int j = 0; j < PER; ++j) e[j] = from_f<T>(f[h * PER + j]);
    reinterpret_cast<uint4*>(p)[h] = u;
  }
}

// x [rows, d], r [rows, d] (ADD only), scale [d]; normed [rows, d] and
// summed [rows, d] (ADD only) in x's type. `vec`: d % 8 == 0 and every
// pointer 16-byte aligned.
template <typename XT, typename RT, typename ST, bool ADD>
__global__ void __launch_bounds__(WARPS * 32)
    norm_kernel(const XT* __restrict__ x, const RT* __restrict__ r,
                const ST* __restrict__ scale, XT* __restrict__ normed,
                XT* __restrict__ summed, int rows, int d, float eps,
                int vec) {
  const int row = blockIdx.x * WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;  // whole warps: no barrier follows
  const size_t base = (size_t)row * d;
  const int full = vec ? d : 0;  // the part read VEC at a time
  float f[VEC], g[VEC];

  float ss = 0.f;
  for (int c = lane * VEC; c < full; c += 32 * VEC) {
    load8(x + base + c, f);
    if constexpr (ADD) {
      load8(r + base + c, g);
#pragma unroll
      for (int j = 0; j < VEC; ++j) f[j] = __fadd_rn(f[j], g[j]);
      store8(summed + base + c, f);
    }
#pragma unroll
    for (int j = 0; j < VEC; ++j) ss = fmaf(f[j], f[j], ss);
  }
  for (int c = full + lane; c < d; c += 32) {
    float v = to_f(x[base + c]);
    if constexpr (ADD) {
      v = __fadd_rn(v, to_f(r[base + c]));
      summed[base + c] = from_f<XT>(v);
    }
    ss = fmaf(v, v, ss);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  const float inv = rsqrtf(__fdiv_rn(ss, (float)d) + eps);

  for (int c = lane * VEC; c < full; c += 32 * VEC) {
    load8(x + base + c, f);
    if constexpr (ADD) {
      load8(r + base + c, g);
#pragma unroll
      for (int j = 0; j < VEC; ++j) f[j] = __fadd_rn(f[j], g[j]);
    }
    load8(scale + c, g);
#pragma unroll
    for (int j = 0; j < VEC; ++j) f[j] = __fmul_rn(__fmul_rn(f[j], inv), g[j]);
    store8(normed + base + c, f);
  }
  for (int c = full + lane; c < d; c += 32) {
    float v = to_f(x[base + c]);
    if constexpr (ADD) v = __fadd_rn(v, to_f(r[base + c]));
    normed[base + c] =
        from_f<XT>(__fmul_rn(__fmul_rn(v, inv), to_f(scale[c])));
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename XT, typename RT, typename ST, bool ADD>
int launch(const void* x, const void* r, const void* scale, void* normed,
           void* summed, int rows, int d, float eps, cudaStream_t st) {
  const int vec = d % VEC == 0 && aligned16(x) && aligned16(scale) &&
                  aligned16(normed) &&
                  (!ADD || (aligned16(r) && aligned16(summed)));
  const int blocks = (rows + WARPS - 1) / WARPS;
  norm_kernel<XT, RT, ST, ADD><<<blocks, WARPS * 32, 0, st>>>(
      static_cast<const XT*>(x), static_cast<const RT*>(r),
      static_cast<const ST*>(scale), static_cast<XT*>(normed),
      static_cast<XT*>(summed), rows, d, eps, vec);
  return static_cast<int>(cudaGetLastError());
}

// dispatch on the scale's dtype code (0 = float32, 1 = bfloat16)
template <typename XT, typename RT, bool ADD>
int by_scale(int s_code, const void* x, const void* r, const void* scale,
             void* normed, void* summed, int rows, int d, float eps,
             cudaStream_t st) {
  if (s_code == 0)
    return launch<XT, RT, float, ADD>(x, r, scale, normed, summed, rows, d,
                                      eps, st);
  if (s_code == 1)
    return launch<XT, RT, __nv_bfloat16, ADD>(x, r, scale, normed, summed,
                                              rows, d, eps, st);
  return -1;
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. x [rows, d], scale [d] and
// normed [rows, d] (x's dtype) are contiguous device arrays. Returns
// cudaGetLastError() after the launch (0 = launched), or -1 for dtypes
// the kernel is not built for.
extern "C" int tony_rmsnorm(int x_code, int s_code, const void* x,
                            const void* scale, void* normed, int rows, int d,
                            float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows == 0) return 0;
  if (x_code == 0)
    return by_scale<float, float, false>(s_code, x, nullptr, scale, normed,
                                         nullptr, rows, d, eps, st);
  if (x_code == 1)
    return by_scale<__nv_bfloat16, float, false>(
        s_code, x, nullptr, scale, normed, nullptr, rows, d, eps, st);
  return -1;
}

// as tony_rmsnorm, with the residual r [rows, d] (its own dtype) added
// first and the sum written to summed [rows, d] in x's dtype
extern "C" int tony_add_rmsnorm(int x_code, int r_code, int s_code,
                                const void* x, const void* r,
                                const void* scale, void* normed,
                                void* summed, int rows, int d, float eps,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows == 0) return 0;
  if (x_code == 0 && r_code == 0)
    return by_scale<float, float, true>(s_code, x, r, scale, normed, summed,
                                        rows, d, eps, st);
  if (x_code == 0 && r_code == 1)
    return by_scale<float, __nv_bfloat16, true>(s_code, x, r, scale, normed,
                                                summed, rows, d, eps, st);
  if (x_code == 1 && r_code == 0)
    return by_scale<__nv_bfloat16, float, true>(s_code, x, r, scale, normed,
                                                summed, rows, d, eps, st);
  if (x_code == 1 && r_code == 1)
    return by_scale<__nv_bfloat16, __nv_bfloat16, true>(
        s_code, x, r, scale, normed, summed, rows, d, eps, st);
  return -1;
}
