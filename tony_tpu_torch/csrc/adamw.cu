// Fused AdamW on Hopper: one pass over (grad, master param, mu, nu) of
// every leaf of a group, writing the new master param, the moments and,
// optionally, the compute-dtype copy of the param, in one launch.
//
// Replaces the Pallas TPU kernel of tony_tpu/ops/adamw.py, _adamw_kernel
// (:74), launched per leaf by _leaf_update_kernel (:108). The math is
// the same (optax.adamw in fp32):
//   mu = b1 mu + (1 - b1) g;  nu = b2 nu + (1 - b2) g g
//   p  = p - lr ((mu c1) / (sqrt(nu c2) + eps) + wd p)
// with lr, c1 = 1 / (1 - b1^t), c2 = 1 / (1 - b2^t) read from a small
// device array (the JAX `hyp` operand), so the host never syncs.
//
// What bounds it on an H100: bytes. A few flops per element against
// 4 + 4 + 4 + 4 bytes read and 4 + 4 + 4 + 2 written for fp32 grads
// (a trainer's accumulators), fp32 master and moments and a bf16 copy:
// 30 bytes an element, 28 with bf16 grads.
//
// Design: a multi-tensor launch. The wrapper groups the leaves by their
// dtypes (grad, moments, copy) and hands each group to one launch as a
// device table of leaves (pointers, size and vector head) plus a table
// of chunks (leaf, offset) of CHUNK elements each, so a step takes one
// launch per dtype group (one for the whole model under the bf16 carry).
// Every element is updated in place.
//  - Vectors: each thread moves four elements a load or store, 16 bytes
//    of an fp32 stream (float4) and 8 of a bf16 one (uint2), and keeps
//    UNROLL = 2 such vectors of every stream in flight, so a thread has
//    eight loads of up to 16 bytes outstanding before its first product.
//  - A leaf's vector body starts at its head, the first element at which
//    every one of its arrays sits on a four-element boundary (the
//    wrapper computes it; tensors of a step usually start at 0). The
//    elements before the head and after the last whole vector, and
//    every element of a leaf whose arrays are misaligned against each
//    other (head -1), take the scalar loop. Chunk 0 of a leaf spans
//    [0, head + CHUNK), chunk j > 0 [head + j CHUNK, head + (j+1) CHUNK).
//  - Grid: one block a chunk (23.5 k blocks of 256 threads at
//    Qwen2.5-1.5B). A persistent grid (as many blocks as fit on the
//    SMs, each walking the chunk table by stride), 512 or 1024 threads,
//    four vectors a thread and streaming cache hints were tried at the
//    training call; none was ahead in every run, so the simplest stays.
// Products and sums round one at a time (__fmul_rn/__fadd_rn/__fdiv_rn/
// __fsqrt_rn, no fused multiply-add), the order of the plain PyTorch
// version, so the two agree to the bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr long long CHUNK = 65536;  // elements a chunk of the table
constexpr int VEC = 4;              // elements a vector
constexpr int UNROLL = 2;           // vectors of each stream a thread

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

// four elements from element i (a multiple of VEC past an aligned base)
__device__ __forceinline__ void load4(const float* a, long long i,
                                      float (&v)[VEC]) {
  const float4 f = *reinterpret_cast<const float4*>(a + i);
  v[0] = f.x;
  v[1] = f.y;
  v[2] = f.z;
  v[3] = f.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* a, long long i,
                                      float (&v)[VEC]) {
  const uint2 u = *reinterpret_cast<const uint2*>(a + i);
  v[0] = __uint_as_float(u.x << 16);
  v[1] = __uint_as_float(u.x & 0xffff0000u);
  v[2] = __uint_as_float(u.y << 16);
  v[3] = __uint_as_float(u.y & 0xffff0000u);
}
__device__ __forceinline__ void store4(float* a, long long i,
                                       const float (&v)[VEC]) {
  *reinterpret_cast<float4*>(a + i) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  // each rounded to nearest even, as __float2bfloat16
  const __nv_bfloat162 b = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&b);
}
__device__ __forceinline__ void store4(__nv_bfloat16* a, long long i,
                                       const float (&v)[VEC]) {
  *reinterpret_cast<uint2*>(a + i) =
      make_uint2(pack2(v[0], v[1]), pack2(v[2], v[3]));
}

struct Leaf {  // seven 64-bit words, as the wrapper packs them
  const void* g;
  float* p;
  void* mu;
  void* nu;
  void* copy;      // compute-dtype copy, or null
  long long n;
  long long head;  // first element of the vector body (0-3), -1: none
};

struct Hyper {
  float b1, b2, omb1, omb2, eps, wd;  // omb = 1 - b, rounded once on the host
};

// one element's update, in the plain version's order of roundings
__device__ __forceinline__ void update(const Hyper& hp, float lr, float c1,
                                       float c2, float g, float& m, float& v,
                                       float& p) {
  m = __fadd_rn(__fmul_rn(hp.b1, m), __fmul_rn(hp.omb1, g));
  v = __fadd_rn(__fmul_rn(hp.b2, v), __fmul_rn(__fmul_rn(hp.omb2, g), g));
  const float upd = __fadd_rn(
      __fdiv_rn(__fmul_rn(m, c1),
                __fadd_rn(__fsqrt_rn(__fmul_rn(v, c2)), hp.eps)),
      __fmul_rn(hp.wd, p));
  p = __fsub_rn(p, __fmul_rn(lr, upd));
}

template <typename G, typename M, typename C>
__global__ void __launch_bounds__(THREADS)
    adamw_kernel(const Leaf* __restrict__ leaves,
                 const long long* __restrict__ chunk_leaf,
                 const long long* __restrict__ chunk_off,
                 const float* __restrict__ hyp, const Hyper hp) {
  const float lr = hyp[0], c1 = hyp[1], c2 = hyp[2];
  const Leaf lf = leaves[chunk_leaf[blockIdx.x]];
  const bool vec = lf.head >= 0;
  const long long h = vec ? lf.head : 0;
  const long long off = chunk_off[blockIdx.x];
  const long long start = off == 0 ? 0 : off + h;
  const long long end = min(off + CHUNK + h, lf.n);
  const G* g = static_cast<const G*>(lf.g);
  float* p = lf.p;
  M* mu = static_cast<M*>(lf.mu);
  M* nu = static_cast<M*>(lf.nu);
  C* copy = static_cast<C*>(lf.copy);

  auto one = [&](long long i) {
    float m = to_f(mu[i]), v = to_f(nu[i]), pv = p[i];
    update(hp, lr, c1, c2, to_f(g[i]), m, v, pv);
    p[i] = pv;
    mu[i] = from_f<M>(m);
    nu[i] = from_f<M>(v);
    if (copy != nullptr) copy[i] = from_f<C>(pv);
  };

  // [start, vs) scalar head, then nv whole vectors, then the scalar tail
  const long long vs = vec ? max(start, h) : start;
  const long long nv = vec && end > vs ? (end - vs) / VEC : 0;
  for (long long i = start + threadIdx.x; i < min(vs, end); i += THREADS)
    one(i);
  for (long long v0 = threadIdx.x; v0 < nv; v0 += UNROLL * THREADS) {
    float gv[UNROLL][VEC], mv[UNROLL][VEC], vv[UNROLL][VEC],
        pv[UNROLL][VEC];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long e = vs + (v0 + u * THREADS) * VEC;
      if (v0 + u * THREADS < nv) {
        load4(g, e, gv[u]);
        load4(mu, e, mv[u]);
        load4(nu, e, vv[u]);
        load4(p, e, pv[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long e = vs + (v0 + u * THREADS) * VEC;
      if (v0 + u * THREADS < nv) {
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          update(hp, lr, c1, c2, gv[u][j], mv[u][j], vv[u][j], pv[u][j]);
        store4(p, e, pv[u]);
        store4(mu, e, mv[u]);
        store4(nu, e, vv[u]);
        if (copy != nullptr) store4(copy, e, pv[u]);
      }
    }
  }
  for (long long i = vs + nv * VEC + threadIdx.x; i < end; i += THREADS)
    one(i);
}

template <typename G, typename M, typename C>
int launch(const void* leaves, const void* chunk_leaf, const void* chunk_off,
           int n_chunks, const void* hyp, const Hyper& hp,
           cudaStream_t st) {
  if (n_chunks == 0) return 0;
  adamw_kernel<G, M, C><<<n_chunks, THREADS, 0, st>>>(
      static_cast<const Leaf*>(leaves),
      static_cast<const long long*>(chunk_leaf),
      static_cast<const long long*>(chunk_off),
      static_cast<const float*>(hyp), hp);
  return static_cast<int>(cudaGetLastError());
}

template <typename G, typename M>
int by_copy(int c_code, const void* leaves, const void* chunk_leaf,
            const void* chunk_off, int n_chunks, const void* hyp,
            const Hyper& hp, cudaStream_t st) {
  // c_code -1 (no copy) instantiates a bf16 copy type that is never
  // written: every leaf of such a group has copy == null
  if (c_code == 0)
    return launch<G, M, float>(leaves, chunk_leaf, chunk_off, n_chunks,
                               hyp, hp, st);
  if (c_code == 1 || c_code == -1)
    return launch<G, M, __nv_bfloat16>(leaves, chunk_leaf, chunk_off,
                                       n_chunks, hyp, hp, st);
  return -1;
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16; c_code -1 = no copy. `leaves`
// [n_leaves, 7] int64, `chunk_leaf` [n_chunks] int64 and `chunk_off`
// [n_chunks] int64 are device tables (see Leaf), `hyp` [3] fp32 on the
// device holds lr, c1, c2. Returns cudaGetLastError() after the launch
// (0 = launched), or -1 for dtypes the kernel is not built for.
extern "C" int tony_adamw(int g_code, int m_code, int c_code,
                          const void* leaves, const void* chunk_leaf,
                          const void* chunk_off, int n_chunks,
                          const void* hyp, float b1, float b2, float omb1,
                          float omb2, float eps, float wd, void* stream) {
  const Hyper hp{b1, b2, omb1, omb2, eps, wd};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (g_code == 0 && m_code == 0)
    return by_copy<float, float>(c_code, leaves, chunk_leaf, chunk_off,
                                 n_chunks, hyp, hp, st);
  if (g_code == 1 && m_code == 0)
    return by_copy<__nv_bfloat16, float>(c_code, leaves, chunk_leaf,
                                         chunk_off, n_chunks, hyp, hp,
                                         st);
  if (g_code == 0 && m_code == 1)
    return by_copy<float, __nv_bfloat16>(c_code, leaves, chunk_leaf,
                                         chunk_off, n_chunks, hyp, hp,
                                         st);
  if (g_code == 1 && m_code == 1)
    return by_copy<__nv_bfloat16, __nv_bfloat16>(
        c_code, leaves, chunk_leaf, chunk_off, n_chunks, hyp, hp, st);
  return -1;
}

// the chunk size and the vector width, for the wrapper's tables
extern "C" long long tony_adamw_chunk() { return CHUNK; }
extern "C" int tony_adamw_vec() { return VEC; }
