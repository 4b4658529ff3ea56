"""Weight-only int8: symmetric per-output-column quantization and the
dequant matrix product, as a CUDA kernel for Hopper
(``csrc/q8_matmul.cu``) beside its plain PyTorch version.

Counterpart of ``tony_tpu/ops/quant.py``. Decode reads every weight once
a token, so int8 weights halve the bytes a step against bf16; the kernel
reads the int8 weights and dequantizes them on the chip, applying the
per-column scale once per output. ``q8_matmul`` launches the kernel for
a CUDA tensor and runs ``q8_matmul_reference`` only for a tensor on the
CPU; a CUDA call that cannot launch raises.

The kernel has three routes (``plan``, ``route_of``): DECODE streams
the weight once for m <= DEC_ROWS, TENSOR_CORES runs a bf16 x above it
on ``mma.sync``, SIMT_TILE an fp32 x above it. The launch plan is a pure
function of the shape, x's dtype and the SM count, with the kernel's
tile constants mirrored here (``tests/test_torch_q8_plan.py`` pins it).

Unlike the JAX ``q8_matmul`` it takes any m, n and k: there is no
m-padding (the kernel checks its bounds) and no XLA fallback for an n
without a divisor of at least 64 (nothing in the kernel depends on one).

``q8_matmul_experts`` is ``jax.vmap(q8_matmul)`` over a leading expert
axis (the int8 MoE expert FFN, ``tony_tpu/parallel/moe.py``): one launch
for every expert, an expert grid dimension on each route, with an x
broadcast to every expert read at expert stride 0.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the kernel's routes and tile constants (csrc/q8_matmul.cu), mirrored
# for the plan; the loaded library is checked against them
DECODE, TENSOR_CORES, SIMT_TILE = 0, 1, 2
DEC_ROWS = 16  # m at or below which the decode route runs
DEC_BN, DEC_BK, DEC_STAGES = 128, 64, 4
DEC_MAX_SPLITS = 16  # K splits of a slab: one thread-block cluster
DEC_BLOCKS_PER_SM = 3  # decode blocks an SM holds: the grid is one wave
TILE_M, TILE_N, TILE_K = 128, 128, 32
# weight bytes an SM should keep in flight on the decode route
IN_FLIGHT_BYTES = 32 * 1024
MIN_SPLIT_K = 256  # no K split shorter than this on routes 1 and 2


def quantize_q8(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """w: [in, out] float -> (w_q int8 [in, out], scale fp32 [out]).
    Symmetric absmax per output column, ``scale = max(absmax, 1e-8) /
    127``; dequant is ``w_q * scale``. ``torch.round`` rounds half to
    even, as ``jnp.round`` does; values clip to +-127, never -128."""
    w32 = w.float()
    absmax = w32.abs().amax(dim=0)
    scale = torch.clamp(absmax, min=1e-8) / 127.0
    w_q = torch.clamp(torch.round(w32 / scale), -127, 127).to(torch.int8)
    return w_q, scale


def dequantize_q8(w_q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return w_q.float() * scale[None, :]


def _check(x, w_q, scale):
    if x.dim() != 2 or w_q.dim() != 2 or x.shape[1] != w_q.shape[0] \
            or tuple(scale.shape) != (w_q.shape[1],):
        raise ValueError(f"shape mismatch: x{tuple(x.shape)} "
                         f"w{tuple(w_q.shape)} scale{tuple(scale.shape)}")
    if w_q.dtype != torch.int8:
        raise ValueError(f"weights must be int8, not {w_q.dtype}")


def q8_matmul_reference(x, w_q, scale, out_dtype=None) -> torch.Tensor:
    """Plain PyTorch ``q8_matmul``: the JAX kernel's arithmetic, an fp32
    product, then the scale, then one cast to ``out_dtype`` (default
    ``x.dtype``)."""
    _check(x, w_q, scale)
    out = (x.float() @ w_q.float()) * scale.float()
    return out.to(out_dtype or x.dtype)


def error_bound(x, w_q, scale, want) -> torch.Tensor:
    """Per-element limit on |kernel - plain|: ``2^-7 |want|`` for a bf16
    output plus ``2^-14 M``, where ``M = scale_j sum_k |x_ik| |q_kj|``
    bounds what fp32 sums taken in another order can differ by. Each
    side rounds its fp32 sum to bf16 once; when the two sums straddle a
    rounding point they land one bf16 step apart, and a step is up to
    2^-7 of the value. Takes ``q8_matmul_experts``' shapes too."""
    sc = scale.float() if w_q.dim() == 2 else scale.float()[:, None, :]
    mag = (x.float().abs() @ w_q.float().abs()) * sc
    rel = 2.0 ** -7 if want.dtype == torch.bfloat16 else 0.0
    return rel * want.float().abs() + 2.0 ** -14 * mag


def _lib():
    """The built ``csrc/q8_matmul.cu``, its entry point typed and its
    tile constants checked against the ones mirrored here."""
    from tony_tpu_torch.ops import _build

    lib = _build.load("q8_matmul")
    fn = lib.tony_q8_matmul
    if fn.argtypes is None:
        mirrored = (DEC_ROWS, DEC_BN, DEC_BK, DEC_STAGES, DEC_MAX_SPLITS,
                    TILE_M, TILE_N, TILE_K, DEC_BLOCKS_PER_SM)
        if tuple(lib.tony_q8_matmul_const(i) for i in range(9)) != mirrored:
            raise RuntimeError("csrc/q8_matmul.cu and ops/quant.py disagree "
                               "on the tile constants")
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 5 \
            + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fe = lib.tony_q8_matmul_experts
        fe.restype = ctypes.c_int
        fe.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 5 \
            + [ctypes.c_int, ctypes.c_longlong] + [ctypes.c_int] * 6 \
            + [ctypes.c_void_p]
    return lib


def kernel_route(x_dtype, m: int) -> int:
    """The route the CUDA source takes for x's dtype at m rows
    (``tony_q8_matmul_route``): DECODE, TENSOR_CORES or SIMT_TILE."""
    return _lib().tony_q8_matmul_route(_DTYPE_CODES[x_dtype], m)


def kernel_resources() -> dict:
    """Each instance's dynamic shared memory (bytes) and blocks per SM,
    as ``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` reports them,
    keyed (route, x dtype, x rows): the decode route for an fp32 x (SIMT)
    at 1, 4, 8 and 16 rows and for a bf16 x (tensor cores) at 8 and 16,
    the tensor-core route (bf16 x) and the SIMT tile (fp32 x), each with
    rows 0."""
    fn = _lib().tony_q8_matmul_resources
    cases = [(DECODE, torch.float32, r) for r in (1, 4, 8, 16)]
    cases += [(DECODE, torch.bfloat16, r) for r in (8, 16)]
    cases += [(TENSOR_CORES, torch.bfloat16, 0),
              (SIMT_TILE, torch.float32, 0)]
    out = {}
    for route, dt, rows in cases:
        smem, blocks = ctypes.c_int(), ctypes.c_int()
        err = fn(route, _DTYPE_CODES[dt], rows, ctypes.byref(smem),
                 ctypes.byref(blocks))
        if err != 0:
            raise RuntimeError(f"occupancy query for q8_matmul route "
                               f"{route} ({dt}, rows {rows}) failed: CUDA "
                               f"error {err}")
        out[(route, dt, rows)] = {"smem": smem.value, "blocks": blocks.value}
    return out


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


class Plan(NamedTuple):
    route: int  # DECODE, TENSOR_CORES or SIMT_TILE
    grid: tuple  # (column tiles, row tiles, K splits)
    splits: int
    kps: int  # K rows a split (decode: the longest), whole stages


def route_of(m: int, x_dtype) -> int:
    """DECODE for m <= DEC_ROWS, else TENSOR_CORES for a bf16 x and
    SIMT_TILE for an fp32 one (the rule of ``tony_q8_matmul_route``)."""
    if m <= DEC_ROWS:
        return DECODE
    return TENSOR_CORES if x_dtype == torch.bfloat16 else SIMT_TILE


def split_stages(z: int, splits: int, k: int) -> range:
    """The DEC_BK-row stages of k that decode split z of ``splits`` takes:
    z, z + splits, ... (``dec_load``/``dec_nst`` in the kernel)."""
    return range(z, -(-k // DEC_BK), splits)


def decode_in_flight(kps: int) -> int:
    """Weight bytes one decode block keeps in flight: up to
    DEC_STAGES - 1 of its stages."""
    return min(DEC_STAGES - 1, kps // DEC_BK) * DEC_BK * DEC_BN


def plan(m: int, n: int, k: int, x_dtype, sm_count: int,
         experts: int = 1) -> Plan:
    """The launch of one call, a pure function of its shape, x's dtype,
    the card's SM count and the number of experts (``q8_matmul_experts``;
    the grid is one expert's, and the kernel repeats it for each).

    Decode: a block a 128-column slab and K split, the splits of a slab
    one cluster: as many splits as fill DEC_BLOCKS_PER_SM blocks an SM in
    one wave, at most DEC_MAX_SPLITS and one stage a split, then evened
    out so no split takes more stages than it must. Split z of S takes
    the stages z, z + S, ... (the kernel's order); ``kps`` is the rows of
    the longest. Routes 1 and 2: 128 x 128 tiles; K split so that about
    two blocks run per SM, each split at least MIN_SPLIT_K deep and a
    whole number of TILE_K. With several experts the wave and the blocks
    an SM are shared out over the experts' slabs and tiles."""
    route = route_of(m, x_dtype)
    experts = max(1, experts)
    if route == DECODE:
        slabs = -(-n // DEC_BN)
        stages = max(1, -(-k // DEC_BK))
        splits = min(max(1, DEC_BLOCKS_PER_SM * sm_count
                         // (slabs * experts)),
                     DEC_MAX_SPLITS, stages)
        per = -(-stages // splits)
        splits = -(-stages // per)
        return Plan(route, (slabs, 1, splits), splits, per * DEC_BK)
    tiles = -(-m // TILE_M) * -(-n // TILE_N) * experts
    want = -(-2 * sm_count // tiles)
    splits = max(1, min(want, k // MIN_SPLIT_K))
    kps = -(-max(k, 1) // splits)
    kps = -(-kps // TILE_K) * TILE_K
    splits = -(-max(k, 1) // kps)
    return Plan(route, (-(-n // TILE_N), -(-m // TILE_M), splits), splits,
                kps)


def _launch(x, w_q, scale, out_dtype, experts: int, x_stride: int,
            wrapper) -> torch.Tensor:
    """One launch over ``experts`` weight matrices (1: plain
    ``q8_matmul``); ``x_stride`` is x's elements from one expert's rows
    to the next (0: every expert reads the same x)."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"q8_matmul runs on cuda or cpu, not {dev}")
    if w_q.device != dev or scale.device != dev:
        raise ValueError("x, w_q and scale must share one device")
    if x.dtype not in _DTYPE_CODES or out_dtype not in _DTYPE_CODES:
        raise ValueError(f"x and the output must be float32 or bfloat16, "
                         f"not {x.dtype} -> {out_dtype}")
    if scale.dtype != torch.float32:
        raise ValueError(f"scale must be float32, not {scale.dtype}")
    if not (x.is_contiguous() and w_q.is_contiguous()
            and scale.is_contiguous()):
        raise ValueError("q8_matmul needs contiguous x, w_q and scale")
    m, k = x.shape[-2:]
    n = w_q.shape[-1]
    shape = (m, n) if w_q.dim() == 2 else (experts, m, n)
    out = torch.empty(shape, dtype=out_dtype, device=dev)
    if m == 0 or n == 0 or experts == 0:
        return out
    p = plan(m, n, k, x.dtype, _sms(dev.index), experts)
    # split-K scratch of routes 1 and 2 (the decode route adds its splits
    # in shared memory)
    part = torch.empty(experts * p.splits * m * n if p.route != DECODE
                       and p.splits > 1 else 0, dtype=torch.float32,
                       device=dev)
    err = _lib().tony_q8_matmul_experts(
        _DTYPE_CODES[x.dtype], _DTYPE_CODES[out_dtype], x.data_ptr(),
        w_q.data_ptr(), scale.data_ptr(), out.data_ptr(),
        part.data_ptr() if part.numel() else None, experts, x_stride, m,
        n, k, p.route, p.splits, p.kps,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"q8_matmul kernel launch failed: CUDA error "
                           f"{err}")
    wrapper.launches += 1
    wrapper.route_launches[p.route] += 1
    return out


def q8_matmul(x, w_q, scale, *, out_dtype=None) -> torch.Tensor:
    """x [m, k] fp32 or bf16 @ int8 weights w_q [k, n] with per-column
    fp32 ``scale`` [n] -> [m, n] in ``out_dtype`` (fp32 or bf16;
    default x's dtype), ``cast((x @ w_q) * scale)`` with fp32 sums.

    CPU tensors run ``q8_matmul_reference``; CUDA tensors launch the
    kernel (``q8_matmul.launches`` counts the launches, and
    ``q8_matmul.route_launches`` them by route; inside a replayed CUDA
    graph ``models.graphs`` keeps the counts true) or raise."""
    _check(x, w_q, scale)
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu":
        return q8_matmul_reference(x, w_q, scale, out_dtype)
    return _launch(x, w_q, scale, out_dtype, 1, 0, q8_matmul)


q8_matmul.launches = 0
q8_matmul.route_launches = [0, 0, 0]  # by route: DECODE, TENSOR_CORES, SIMT


def _check_experts(x, w_q, scale):
    if w_q.dim() != 3 or x.dim() not in (2, 3) \
            or x.shape[-1] != w_q.shape[1] \
            or (x.dim() == 3 and x.shape[0] != w_q.shape[0]) \
            or tuple(scale.shape) != (w_q.shape[0], w_q.shape[2]):
        raise ValueError(f"shape mismatch: x{tuple(x.shape)} "
                         f"w{tuple(w_q.shape)} scale{tuple(scale.shape)}")
    if w_q.dtype != torch.int8:
        raise ValueError(f"weights must be int8, not {w_q.dtype}")


def q8_matmul_experts_reference(x, w_q, scale, out_dtype=None):
    """Plain PyTorch ``q8_matmul_experts``: for each expert e, an fp32
    product of x (or x[e]) and w_q[e], times scale[e], one cast to
    ``out_dtype`` (default x's dtype)."""
    _check_experts(x, w_q, scale)
    out = (x.float() @ w_q.float()) * scale.float()[:, None, :]
    return out.to(out_dtype or x.dtype)


def q8_matmul_experts(x, w_q, scale, *, out_dtype=None) -> torch.Tensor:
    """``jax.vmap(q8_matmul)`` over the expert axis: x [T, k] (one x for
    every expert, the dropless FFN's ``in_axes=(None, 0, 0)``) or [E, T,
    k] (each expert's own rows), int8 w_q [E, k, n], fp32 ``scale`` [E, n]
    -> [E, T, n] in ``out_dtype`` (default x's dtype).

    CPU tensors run ``q8_matmul_experts_reference``; CUDA tensors launch
    the kernel once for all E experts (``q8_matmul_experts.launches``
    and ``route_launches`` count it) or raise."""
    _check_experts(x, w_q, scale)
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu":
        return q8_matmul_experts_reference(x, w_q, scale, out_dtype)
    stride = x.shape[1] * x.shape[2] if x.dim() == 3 else 0
    return _launch(x, w_q, scale, out_dtype, w_q.shape[0], stride,
                   q8_matmul_experts)


q8_matmul_experts.launches = 0
q8_matmul_experts.route_launches = [0, 0, 0]
