// RMSNorm and residual-add + RMSNorm on Hopper, one pass from registers:
//   rmsnorm:      out = x * rsqrt(mean(x^2) + eps) * scale
//   add_rmsnorm:  s = x + r (fp32); summed = cast(s);
//                 normed = s * rsqrt(mean(s^2) + eps) * scale
// over rows of D elements, in fp32, each output rounded once to x's
// type. add_rmsnorm takes the norm of the fp32 sum, not of the sum
// after it is rounded for storage.
//
// Replaces the Pallas TPU kernels of tony_tpu/ops/fused.py,
// _rmsnorm_kernel (:19, launched by rmsnorm :43) and _add_rmsnorm_kernel
// (:26, launched by add_rmsnorm :68), which normalise a block of rows in
// VMEM.
//
// What bounds it on an H100: bytes. A few flops an element against the
// element's bytes in and out: rows * D * (in + out) over 3.35 TB/s (for
// D = 1536 and 8192 bf16 rows, 50 MB in 15 us; fp32 twice that).
//
// Design (the launch plan is ops/fused.py:plan, which mirrors the
// constants below; the wrapper passes it in and the entry points check
// it against their own rule):
// - ONE_PASS route, D <= MAX_ROW_WARPS * 32 * LANE_VALUES (8192): a row
//   belongs to W = ceil(D / (32 * LANE_VALUES)) warps, and each of its
//   lanes holds NV 16-byte vectors of x (a template parameter; VE = 8
//   bf16 or 4 fp32 elements a vector, NV * VE <= LANE_VALUES). A lane
//   issues all its loads of x (and of r) before it uses any, keeps the
//   row in fp32 registers, writes `summed` from them, takes the sum of
//   squares by warp shuffles (then, for W > 1, through shared memory in
//   warp order behind a named barrier of the row's warps), and scales
//   and writes the output from the same registers: x and r cross HBM
//   once. D = 1536 takes two warps a row, 4096 four, 8192 eight.
// - Register budget: LANE_VALUES = 32 fp32 values a lane, at most 256
//   bytes of raw loads a lane (fp32 x and r), and __launch_bounds__
//   holds a lane to 128 registers so BLOCKS_PER_SM = 2 blocks of 256
//   threads fit an SM. 32 was kept over 48 values a lane (one warp a row
//   at D = 1536): at 48 the fp32 instances need more than 128 registers
//   and spill, or hold one block an SM; over 16, which sends D = 8192
//   to the two-pass route. A bound of three blocks an SM spills the fp32
//   add; four for the bf16 rmsnorm alone measured slower.
// - Rows in flight: a block is BLOCK_WARPS (8) warps, 8 / W rows at a
//   time. A row's successor (row + grid * block_rows) is loaded as soon
//   as the row sits in registers, so its loads are in flight while the
//   row is reduced, scaled and stored. The block stages the scale in
//   shared memory as fp32, SCALE_BATCH loads a thread at once, after
//   its first row's loads are issued: the two round trips overlap (one
//   HBM round trip at 8 rows).
// - Grid: a block a row group where the scale it stages (4 bytes a
//   column) is less than what its rows load at a time; else one wave of
//   BLOCKS_PER_SM blocks an SM, looping over the rows, so the staging is
//   paid once a block (bf16 rows of 4096 and wider). Looping measured
//   slower at D = 1536 and faster at the wide bf16 rows.
// - Bytes in flight: 3.35 TB/s over 132 SMs is 25 GB/s an SM; at about
//   0.6-0.8 us of HBM latency an SM needs 15-20 KB of loads outstanding.
//   At D = 1536 a block of 256 lanes holds 12 KB (bf16 rmsnorm, 48 bytes
//   a lane) to 48 KB (fp32 add, 192 bytes a lane), and an SM at least
//   two blocks: 24-96 KB when every lane waits on its loads.
// - Cache hints: x and r are loaded with ld.global.nc.L1::no_allocate
//   and the outputs stored with __stcs (evict first): each byte is used
//   once. Kept over plain loads and stores, which measured even at
//   D = 1536 and slower for the widest add rows.
// - A row takes a scalar head (elements before x's 16-byte boundary)
//   and tail (what is left after the last whole vector) when its
//   pointers share that boundary. A row whose pointers do not (an input
//   view one element off a fresh output, say) is walked element by
//   element twice inside the same kernel (scalar_row). `summed` is the
//   same fp32 add and one rounding on every route: bit-equal to the
//   plain version.
// - TWO_PASS route, wider rows: the first port's kernel, a warp a row
//   looping over it twice (the second pass reads the row again, from L1
//   or L2).
// - Sums in a fixed order and no atomics: a rerun gives the same bits.
//   The kernels launch on the caller's stream and allocate nothing.
// The choices above were timed on an NVIDIA H100 80GB HBM3 at 700.00 W
// against each other in design trials whose readings are not kept;
// chip_smoke.py phase 9 times the kept kernel beside the bound,
// F.rms_norm and a copy_ of the same bytes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

// mirrored in ops/fused.py; tony_norm_const exports the last four
constexpr int ONE_PASS = 0, TWO_PASS = 1;
constexpr int LANE_VALUES = 32;   // fp32 values a lane holds (one pass)
constexpr int MAX_ROW_WARPS = 8;  // warps a row (one pass)
constexpr int BLOCK_WARPS = 8;    // warps a block (both routes)
constexpr int BLOCKS_PER_SM = 2;  // one-pass blocks an SM holds at least
constexpr int SCALE_BATCH = 16;   // scale loads a thread has in flight
constexpr int VEC = 8;            // two-pass: elements a lane loads at once

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

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

__device__ __forceinline__ bool aligned_dev(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// N elements of T as raw words, loaded with 16-byte (or one 8-byte)
// loads that do not allocate in L1: each byte of x and r is used once
template <typename T, int N>
struct Raw {
  static constexpr int BYTES = N * (int)sizeof(T);
  static constexpr int WORDS = BYTES >= 16 ? BYTES / 16 : 1;
  uint4 w[WORDS];

  __device__ __forceinline__ void load(const T* p) {
    if constexpr (BYTES >= 16) {
#pragma unroll
      for (int i = 0; i < WORDS; ++i)
        asm volatile(
            "ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
            : "=r"(w[i].x), "=r"(w[i].y), "=r"(w[i].z), "=r"(w[i].w)
            : "l"(reinterpret_cast<const uint4*>(p) + i));
    } else {
      static_assert(BYTES == 8, "a vector of r is 8, 16 or 32 bytes");
      asm volatile("ld.global.nc.L1::no_allocate.v2.u32 {%0, %1}, [%2];"
                   : "=r"(w[0].x), "=r"(w[0].y)
                   : "l"(p));
    }
  }
  __device__ __forceinline__ float get(int j) const {
    return to_f(reinterpret_cast<const T*>(w)[j]);
  }
};

// 16 bytes out, a streaming store: each output byte is written once
__device__ __forceinline__ void st16(void* p, uint4 u) {
  __stcs(reinterpret_cast<uint4*>(p), u);
}

// N fp32 values stored as N elements of T (16 bytes for x's type)
template <typename T, int N>
__device__ __forceinline__ void store_vec(T* p, const float* f) {
  static_assert(N * sizeof(T) == 16, "one 16-byte store");
  uint4 u;
  T* e = reinterpret_cast<T*>(&u);
#pragma unroll
  for (int j = 0; j < N; ++j) e[j] = from_f<T>(f[j]);
  st16(p, u);
}

// sum over the row's warps: each warp's total into part[], the row's
// warps meet at named barrier 1 + g, and every lane adds them in warp
// order. part is double-buffered by row parity, so one barrier a row
// keeps the next row's writes off the values still being read.
__device__ __forceinline__ float row_sum(float ss, float* part, int g,
                                         int w, int row_warps,
                                         int parity) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  if (row_warps == 1) return ss;
  float* p = part + parity * BLOCK_WARPS + g * row_warps;
  if (threadIdx.x % 32 == 0) p[w] = ss;
  asm volatile("bar.sync %0, %1;" ::"r"(1 + g), "r"(row_warps * 32)
               : "memory");
  float t = 0.f;
  for (int i = 0; i < row_warps; ++i) t += p[i];
  return t;
}

// a row whose pointers share no 16-byte boundary (an input view one
// element off a fresh output, say): the row's threads walk it element
// by element twice, forming the sum of squares (and writing summed) and
// then the output. A rolled loop, so this route adds no registers to
// the vector rows'.
template <typename XT, typename RT, bool ADD>
__device__ __forceinline__ void scalar_row(const XT* __restrict__ x,
                                        const RT* __restrict__ r,
                                        const float* sc,
                                        XT* __restrict__ normed,
                                        XT* __restrict__ summed, float* part,
                                        int d, float eps, int tid, int nt,
                                        int g, int w, int row_warps,
                                        int parity) {
  float ss = 0.f;
#pragma unroll 1
  for (int e = tid; e < d; e += nt) {
    float s = to_f(x[e]);
    if constexpr (ADD) {
      s = __fadd_rn(s, to_f(r[e]));
      summed[e] = from_f<XT>(s);
    }
    ss = fmaf(s, s, ss);
  }
  ss = row_sum(ss, part, g, w, row_warps, parity);
  const float inv = rsqrtf(__fdiv_rn(ss, (float)d) + eps);
#pragma unroll 1
  for (int e = tid; e < d; e += nt) {
    float s = to_f(x[e]);
    if constexpr (ADD) s = __fadd_rn(s, to_f(r[e]));
    normed[e] = from_f<XT>(__fmul_rn(__fmul_rn(s, inv), sc[e]));
  }
}

// the scale [d] as fp32 into shared memory, SCALE_BATCH loads a thread
// in flight at once (one round trip for d <= SCALE_BATCH * threads)
template <typename ST>
__device__ __forceinline__ void stage_scale(const ST* __restrict__ scale,
                                            float* sc, int d) {
  for (int i0 = threadIdx.x; i0 < d; i0 += SCALE_BATCH * blockDim.x) {
    float v[SCALE_BATCH];
#pragma unroll
    for (int u = 0; u < SCALE_BATCH; ++u) {
      const int i = i0 + u * blockDim.x;
      v[u] = i < d ? to_f(scale[i]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < SCALE_BATCH; ++u) {
      const int i = i0 + u * blockDim.x;
      if (i < d) sc[i] = v[u];
    }
  }
}

// a row's layout: h head elements before x's 16-byte boundary, nvb whole
// vectors, t tail elements; vec false: element by element (scalar_row)
struct Layout {
  int h, nvb, t;
  bool vec;
};

// x [rows, d], r [rows, d] (ADD only), scale [d] (fp32 or bf16 by
// s_code); normed [rows, d] and summed [rows, d] (ADD only) in x's type.
// NV: 16-byte vectors of x a lane holds. Shared memory: d fp32 (the
// scale) and 2 * BLOCK_WARPS partial sums.
template <typename XT, typename RT, bool ADD, int NV>
__global__ void __launch_bounds__(BLOCK_WARPS * 32, BLOCKS_PER_SM)
    norm_onepass(const XT* __restrict__ x, const RT* __restrict__ r,
                 const void* __restrict__ scale, int s_code,
                 XT* __restrict__ normed, XT* __restrict__ summed, int rows,
                 int d, float eps, int row_warps, int block_rows) {
  constexpr int VE = 16 / sizeof(XT);  // elements a vector of x
  constexpr int NE = NV * VE;          // values a lane
  using RX = Raw<XT, VE>;
  using RR = Raw<RT, VE>;
  extern __shared__ float4 smem4[];
  float* sc = reinterpret_cast<float*>(smem4);
  float* part = sc + ((d + 3) & ~3);

  const int warp = threadIdx.x / 32;
  const int g = warp / row_warps, w = warp % row_warps;
  const int nt = row_warps * 32;  // threads a row
  const int tid = w * 32 + threadIdx.x % 32;
  const int stride = gridDim.x * block_rows;
  int row = blockIdx.x * block_rows + g;

  auto layout = [&](size_t base) {
    const uintptr_t a = reinterpret_cast<uintptr_t>(x + base);
    Layout l;
    l.h = (int)((16 - a % 16) % 16 / sizeof(XT));
    l.vec = l.h <= d && aligned_dev(normed + base + l.h, 16);
    if constexpr (ADD)
      l.vec = l.vec && aligned_dev(summed + base + l.h, 16) &&
              aligned_dev(r + base + l.h, RR::BYTES >= 16 ? 16 : RR::BYTES);
    if (!l.vec) l.h = 0;
    l.nvb = l.vec ? (d - l.h) / VE : 0;
    l.t = l.vec ? d - l.h - l.nvb * VE : 0;
    return l;
  };
  // a row's vector loads, all issued before any is used
  RX rx[NV];
  RR rr[ADD ? NV : 1];
  auto issue = [&](const Layout& l, size_t base) {
    if (!l.vec) return;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int v = tid + k * nt;
      if (v < l.nvb) {
        rx[k].load(x + base + l.h + (size_t)v * VE);
        if constexpr (ADD) rr[k].load(r + base + l.h + (size_t)v * VE);
      }
    }
  };

  // the first row's loads go out before the scale's, so the two round
  // trips overlap
  Layout nxt{0, 0, 0, false};
  if (row < rows) {
    nxt = layout((size_t)row * d);
    issue(nxt, (size_t)row * d);
  }
  if (s_code == 0)
    stage_scale(static_cast<const float*>(scale), sc, d);
  else
    stage_scale(static_cast<const __nv_bfloat16*>(scale), sc, d);
  __syncthreads();

  int parity = 0;
  for (; row < rows; row += stride, parity ^= 1) {
    const size_t base = (size_t)row * d;
    const size_t next = (size_t)row + stride;
    const Layout l = nxt;
    // the next row's loads go out as soon as this row's are in
    // registers: they are in flight while this row is reduced, scaled
    // and stored
    auto prefetch = [&] {
      if (next < (size_t)rows) {
        nxt = layout(next * d);
        issue(nxt, next * d);
      }
    };
    if (!l.vec) {
      prefetch();
      scalar_row<XT, RT, ADD>(x + base, ADD ? r + base : r, sc,
                              normed + base, ADD ? summed + base : summed,
                              part, d, eps, tid, nt, g, w, row_warps,
                              parity);
      continue;
    }
    float f[NE];
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int v = tid + k * nt;
#pragma unroll
      for (int j = 0; j < VE; ++j) {
        float s = v < l.nvb ? rx[k].get(j) : 0.f;
        if constexpr (ADD) s = v < l.nvb ? __fadd_rn(s, rr[k].get(j)) : 0.f;
        f[k * VE + j] = s;
      }
      if constexpr (ADD)
        if (v < l.nvb)
          store_vec<XT, VE>(summed + base + l.h + (size_t)v * VE,
                            f + k * VE);
    }
    prefetch();
    float hv = 0.f, tv = 0.f;  // this lane's head and tail element
    if (tid < l.h) {
      hv = to_f(x[base + tid]);
      if constexpr (ADD) {
        hv = __fadd_rn(hv, to_f(r[base + tid]));
        summed[base + tid] = from_f<XT>(hv);
      }
    }
    if (tid < l.t) {
      const size_t c = base + l.h + (size_t)l.nvb * VE + tid;
      tv = to_f(x[c]);
      if constexpr (ADD) {
        tv = __fadd_rn(tv, to_f(r[c]));
        summed[c] = from_f<XT>(tv);
      }
    }

    float ss = 0.f;
#pragma unroll
    for (int m = 0; m < NE; ++m) ss = fmaf(f[m], f[m], ss);
    ss = fmaf(hv, hv, ss);
    ss = fmaf(tv, tv, ss);
    ss = row_sum(ss, part, g, w, row_warps, parity);
    const float inv = rsqrtf(__fdiv_rn(ss, (float)d) + eps);

#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int v = tid + k * nt;
      if (v < l.nvb) {
        const int c = l.h + v * VE;
        float o[VE];
        if (c % 4 == 0) {
#pragma unroll
          for (int q = 0; q < VE / 4; ++q) {
            const float4 s4 = reinterpret_cast<const float4*>(sc + c)[q];
            o[4 * q] = s4.x;
            o[4 * q + 1] = s4.y;
            o[4 * q + 2] = s4.z;
            o[4 * q + 3] = s4.w;
          }
        } else {
#pragma unroll
          for (int j = 0; j < VE; ++j) o[j] = sc[c + j];
        }
#pragma unroll
        for (int j = 0; j < VE; ++j)
          o[j] = __fmul_rn(__fmul_rn(f[k * VE + j], inv), o[j]);
        store_vec<XT, VE>(normed + base + c, o);
      }
    }
    if (tid < l.h)
      normed[base + tid] =
          from_f<XT>(__fmul_rn(__fmul_rn(hv, inv), sc[tid]));
    if (tid < l.t) {
      const int c = l.h + l.nvb * VE + tid;
      normed[base + c] = from_f<XT>(__fmul_rn(__fmul_rn(tv, inv), sc[c]));
    }
  }
}

// ------------------------------------------------------------ two pass
// Rows wider than the one-pass plan: a warp a row, BLOCK_WARPS rows a
// block. A lane reads eight elements at a time with 16-byte loads (two
// for fp32) where D and the pointers allow it, else one at a time, and
// forms the sum of squares; a second pass re-reads the row, scales it
// and writes the outputs. `vec`: d % 8 == 0 and every pointer 16-byte
// aligned.

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

template <typename XT, typename RT, typename ST, bool ADD>
__global__ void __launch_bounds__(BLOCK_WARPS * 32)
    norm_twopass(const XT* __restrict__ x, const RT* __restrict__ r,
                 const ST* __restrict__ scale, XT* __restrict__ normed,
                 XT* __restrict__ summed, int rows, int d, float eps,
                 int vec) {
  const int row = blockIdx.x * BLOCK_WARPS + threadIdx.x / 32;
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

// ------------------------------------------------------------- launch

// the launch plan of ops/fused.py:plan, as the entry points receive it
struct Plan {
  int route, row_warps, lane_vectors, block_rows, grid;
};

template <typename XT>
constexpr int vec_elems() {
  return 16 / (int)sizeof(XT);
}

int route_of(int d) {
  return d <= MAX_ROW_WARPS * 32 * LANE_VALUES ? ONE_PASS : TWO_PASS;
}

// the plan's rule, so a launch never runs a plan the kernel was not
// written for
template <typename XT>
bool plan_ok(const Plan& p, int rows, int d) {
  constexpr int VE = vec_elems<XT>();
  if (p.route != route_of(d) || p.grid < 1) return false;
  if (p.route == TWO_PASS)
    return p.row_warps == 1 && p.block_rows == BLOCK_WARPS &&
           p.grid == (rows + BLOCK_WARPS - 1) / BLOCK_WARPS;
  const int w = (d + 32 * LANE_VALUES - 1) / (32 * LANE_VALUES);
  const int nv = (d + 32 * w * VE - 1) / (32 * w * VE);
  const int blocks = (rows + p.block_rows - 1) / p.block_rows;
  return p.row_warps == w && p.lane_vectors == nv && p.block_rows >= 1 &&
         p.block_rows <= BLOCK_WARPS / w && p.grid <= blocks;
}

size_t onepass_smem(int d) {
  return (size_t)(((d + 3) & ~3) + 2 * BLOCK_WARPS) * sizeof(float);
}

// a kernel's dynamic shared memory above the 48 KB default (D > 12272)
template <typename K>
int allow_smem(K kern, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem));
}

// fn(norm_onepass<XT, RT, ADD, nv>), for nv = 1 .. LANE_VALUES / VE
template <typename XT, typename RT, bool ADD, int NV = 1, typename F>
int by_vectors(int nv, F&& fn) {
  if constexpr (NV * vec_elems<XT>() > LANE_VALUES) {
    return -1;
  } else {
    if (nv == NV) return fn(norm_onepass<XT, RT, ADD, NV>);
    return by_vectors<XT, RT, ADD, NV + 1>(nv, fn);
  }
}

// fn(XT{}, RT{}) for dtype codes 0 = float32, 1 = bfloat16 (RT is
// unused without ADD)
template <bool ADD, typename F>
int by_dtypes(int x_code, int r_code, F&& fn) {
  using bf16 = __nv_bfloat16;
  if (!ADD) r_code = 0;
  if (x_code == 0 && r_code == 0) return fn(float{}, float{});
  if (x_code == 1 && r_code == 0) return fn(bf16{}, float{});
  if (ADD && x_code == 0 && r_code == 1) return fn(float{}, bf16{});
  if (ADD && x_code == 1 && r_code == 1) return fn(bf16{}, bf16{});
  return -1;
}

template <typename XT, typename RT, typename ST, bool ADD>
int two_pass(const void* x, const void* r, const void* scale, void* normed,
             void* summed, int rows, int d, float eps, cudaStream_t st) {
  const int vec = d % VEC == 0 && aligned16(x) && aligned16(scale) &&
                  aligned16(normed) &&
                  (!ADD || (aligned16(r) && aligned16(summed)));
  const int blocks = (rows + BLOCK_WARPS - 1) / BLOCK_WARPS;
  norm_twopass<XT, RT, ST, ADD><<<blocks, BLOCK_WARPS * 32, 0, st>>>(
      static_cast<const XT*>(x), static_cast<const RT*>(r),
      static_cast<const ST*>(scale), static_cast<XT*>(normed),
      static_cast<XT*>(summed), rows, d, eps, vec);
  return static_cast<int>(cudaGetLastError());
}

template <bool ADD>
int launch(int x_code, int r_code, int s_code, const void* x, const void* r,
           const void* scale, void* normed, void* summed, int rows, int d,
           float eps, const Plan& p, cudaStream_t st) {
  if (rows == 0) return 0;
  if (s_code != 0 && s_code != 1) return -1;
  return by_dtypes<ADD>(x_code, r_code, [&](auto xt, auto rt) {
    using XT = decltype(xt);
    using RT = decltype(rt);
    if (!plan_ok<XT>(p, rows, d)) return -1;
    if (p.route == TWO_PASS)
      return s_code == 0
                 ? two_pass<XT, RT, float, ADD>(x, r, scale, normed, summed,
                                                rows, d, eps, st)
                 : two_pass<XT, RT, __nv_bfloat16, ADD>(
                       x, r, scale, normed, summed, rows, d, eps, st);
    const size_t smem = onepass_smem(d);
    return by_vectors<XT, RT, ADD>(p.lane_vectors, [&](auto kern) {
      const int e = allow_smem(kern, smem);
      if (e != 0) return e;
      kern<<<p.grid, p.block_rows * p.row_warps * 32, smem, st>>>(
          static_cast<const XT*>(x), static_cast<const RT*>(r), scale,
          s_code, static_cast<XT*>(normed), static_cast<XT*>(summed), rows,
          d, eps, p.row_warps, p.block_rows);
      return static_cast<int>(cudaGetLastError());
    });
  });
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. x [rows, d], scale [d] and
// normed [rows, d] (x's dtype) are contiguous device arrays; the five
// plan arguments are ops/fused.py:plan's for this call. Returns
// cudaGetLastError() after the launch (0 = launched), or -1 for dtypes
// the kernel is not built for or a plan it does not take.
extern "C" int tony_rmsnorm(int x_code, int s_code, const void* x,
                            const void* scale, void* normed, int rows, int d,
                            float eps, int route, int row_warps,
                            int lane_vectors, int block_rows, int grid,
                            void* stream) {
  const Plan p{route, row_warps, lane_vectors, block_rows, grid};
  return launch<false>(x_code, 0, s_code, x, nullptr, scale, normed,
                       nullptr, rows, d, eps, p,
                       static_cast<cudaStream_t>(stream));
}

// as tony_rmsnorm, with the residual r [rows, d] (its own dtype) added
// first and the sum written to summed [rows, d] in x's dtype
extern "C" int tony_add_rmsnorm(int x_code, int r_code, int s_code,
                                const void* x, const void* r,
                                const void* scale, void* normed,
                                void* summed, int rows, int d, float eps,
                                int route, int row_warps, int lane_vectors,
                                int block_rows, int grid, void* stream) {
  const Plan p{route, row_warps, lane_vectors, block_rows, grid};
  return launch<true>(x_code, r_code, s_code, x, r, scale, normed, summed,
                      rows, d, eps, p, static_cast<cudaStream_t>(stream));
}

// the constants ops/fused.py mirrors: 0 LANE_VALUES, 1 MAX_ROW_WARPS,
// 2 BLOCK_WARPS, 3 BLOCKS_PER_SM
extern "C" int tony_norm_const(int which) {
  const int c[] = {LANE_VALUES, MAX_ROW_WARPS, BLOCK_WARPS, BLOCKS_PER_SM};
  return which >= 0 && which < 4 ? c[which] : -1;
}

// blocks an SM holds (cudaOccupancyMaxActiveBlocksPerMultiprocessor) of
// the one-pass instance for x's and r's dtype codes (r_code -1: rmsnorm)
// and `lane_vectors`, at `threads` a block and the shared memory of
// width d. Returns a CUDA error, or -1 for an instance that is not built.
extern "C" int tony_norm_resources(int x_code, int r_code, int lane_vectors,
                                   int threads, int d, int* blocks_per_sm) {
  const size_t smem = onepass_smem(d);
  auto query = [&](auto kern) {
    const int e = allow_smem(kern, smem);
    if (e != 0) return e;
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, kern, threads, smem));
  };
  auto by_lanes = [&](auto xt, auto rt, auto add) {
    using XT = decltype(xt);
    using RT = decltype(rt);
    return by_vectors<XT, RT, decltype(add)::value>(lane_vectors, query);
  };
  if (r_code < 0)
    return by_dtypes<false>(x_code, 0, [&](auto xt, auto rt) {
      return by_lanes(xt, rt, std::false_type{});
    });
  return by_dtypes<true>(x_code, r_code, [&](auto xt, auto rt) {
    return by_lanes(xt, rt, std::true_type{});
  });
}
