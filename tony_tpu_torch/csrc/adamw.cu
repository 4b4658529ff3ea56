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
// device table of leaves (pointers and sizes) plus a table of chunks
// (leaf, offset) of CHUNK elements each; block c updates chunk c, so a
// step takes one launch per dtype group (one for the whole model under
// the bf16 carry) instead of one per leaf. Every element is updated in
// place. Products and sums round one at a time (__fmul_rn/__fadd_rn,
// no fused multiply-add), the order of the plain PyTorch version, so
// the two agree to the bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 512;
constexpr long long CHUNK = 65536;  // elements a block updates

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

struct Leaf {  // six 64-bit words, as the wrapper packs them
  const void* g;
  float* p;
  void* mu;
  void* nu;
  void* copy;  // compute-dtype copy, or null
  long long n;
};

struct Hyper {
  float b1, b2, omb1, omb2, eps, wd;  // omb = 1 - b, rounded once on the host
};

template <typename G, typename M, typename C>
__global__ void __launch_bounds__(THREADS)
    adamw_kernel(const Leaf* __restrict__ leaves,
                 const long long* __restrict__ chunk_leaf,
                 const long long* __restrict__ chunk_off,
                 const float* __restrict__ hyp, const Hyper hp) {
  const Leaf lf = leaves[chunk_leaf[blockIdx.x]];
  const long long off = chunk_off[blockIdx.x];
  const long long end = min(off + CHUNK, lf.n);
  const float lr = hyp[0], c1 = hyp[1], c2 = hyp[2];
  const G* g = static_cast<const G*>(lf.g);
  M* mu = static_cast<M*>(lf.mu);
  M* nu = static_cast<M*>(lf.nu);
  C* copy = static_cast<C*>(lf.copy);
  for (long long i = off + threadIdx.x; i < end; i += THREADS) {
    const float gv = to_f(g[i]);
    const float m = __fadd_rn(__fmul_rn(hp.b1, to_f(mu[i])),
                              __fmul_rn(hp.omb1, gv));
    const float v = __fadd_rn(__fmul_rn(hp.b2, to_f(nu[i])),
                              __fmul_rn(__fmul_rn(hp.omb2, gv), gv));
    const float p = lf.p[i];
    const float upd = __fadd_rn(
        __fdiv_rn(__fmul_rn(m, c1),
                  __fadd_rn(__fsqrt_rn(__fmul_rn(v, c2)), hp.eps)),
        __fmul_rn(hp.wd, p));
    const float pn = __fsub_rn(p, __fmul_rn(lr, upd));
    lf.p[i] = pn;
    mu[i] = from_f<M>(m);
    nu[i] = from_f<M>(v);
    if (copy != nullptr) copy[i] = from_f<C>(pn);
  }
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
// [n_leaves, 6] int64, `chunk_leaf` [n_chunks] int64 and `chunk_off`
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
                                         chunk_off, n_chunks, hyp, hp, st);
  if (g_code == 0 && m_code == 1)
    return by_copy<float, __nv_bfloat16>(c_code, leaves, chunk_leaf,
                                         chunk_off, n_chunks, hyp, hp, st);
  if (g_code == 1 && m_code == 1)
    return by_copy<__nv_bfloat16, __nv_bfloat16>(
        c_code, leaves, chunk_leaf, chunk_off, n_chunks, hyp, hp, st);
  return -1;
}

// the chunk size, for the wrapper's chunk table
extern "C" long long tony_adamw_chunk() { return CHUNK; }
