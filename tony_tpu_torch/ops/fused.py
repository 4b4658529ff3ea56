"""RMSNorm and residual-add + RMSNorm as CUDA kernels for Hopper
(``csrc/fused_norms.cu``) beside their plain PyTorch versions.

Counterpart of ``tony_tpu/ops/fused.py``: public ops that the model does
not call (neither package's transformer does; its ``RMSNorm`` module
computes the same function in plain tensor code). ``rmsnorm`` and
``add_rmsnorm`` launch the kernel for a CUDA tensor and run their
``*_reference`` version only for a tensor on the CPU; a CUDA call that
cannot launch raises.

The kernel reads each row once into registers (``ONE_PASS``), a row
split over as many warps as its width needs, and keeps a two-pass
kernel for rows wider than that (``TWO_PASS``). Its launch is ``plan``,
a pure function of the call with the kernel's constants mirrored here
(``tests/test_torch_norm_plan.py`` pins it); the JAX ``block_rows`` knob
has no counterpart.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the kernel's routes and constants (csrc/fused_norms.cu), mirrored for
# the plan; the loaded library is checked against them
ONE_PASS, TWO_PASS = 0, 1
LANE_VALUES = 32  # fp32 values a lane holds on the one-pass route
MAX_ROW_WARPS = 8  # warps a row on the one-pass route
BLOCK_WARPS = 8  # warps a block
BLOCKS_PER_SM = 2  # one-pass blocks an SM holds at least; a looping grid
                   # is one such wave
# loads an SM should keep in flight (3.35 TB/s over 132 SMs, times about
# 0.6-0.8 us of HBM latency)
IN_FLIGHT_BYTES = 16 * 1024


class NormPlan(NamedTuple):
    route: int  # ONE_PASS or TWO_PASS
    row_warps: int  # warps a row
    lane_vectors: int  # 16-byte vectors of x a lane holds (0: two-pass)
    block_rows: int  # rows a block takes at a time
    grid: int  # blocks; a block's row groups loop with stride grid


def vector_elems(x_dtype) -> int:
    """Elements of x in one 16-byte vector: 4 fp32, 8 bf16."""
    return 16 // x_dtype.itemsize


def plan(rows: int, d: int, x_dtype, r_dtype, sm_count: int) -> NormPlan:
    """The launch of one call (``r_dtype`` None for rmsnorm), a pure
    function of its shape, dtypes and the card's SM count.

    ONE_PASS for d <= MAX_ROW_WARPS * 32 * LANE_VALUES: the fewest warps
    a row that keep a lane within LANE_VALUES values, the fewest vectors
    a lane that cover d with them, BLOCK_WARPS // row_warps rows a block.
    A block stages the scale (4 bytes a column) before its first row;
    where that is at least what its rows load at a time (x and r, bytes
    a column), the grid is one wave of BLOCKS_PER_SM blocks an SM that
    loop over the rows, so the staging is paid once a block; otherwise a
    block takes one row group. TWO_PASS above it: a warp a row,
    BLOCK_WARPS rows a block, a block for every BLOCK_WARPS rows."""
    if d > MAX_ROW_WARPS * 32 * LANE_VALUES:
        return NormPlan(TWO_PASS, 1, 0, BLOCK_WARPS, -(-rows // BLOCK_WARPS))
    r_bytes = 0 if r_dtype is None else r_dtype.itemsize
    warps = -(-d // (32 * LANE_VALUES))
    nv = -(-d // (32 * warps * vector_elems(x_dtype)))
    block_rows = BLOCK_WARPS // warps
    grid = -(-rows // block_rows)
    if 4 >= block_rows * (x_dtype.itemsize + r_bytes):
        grid = min(grid, BLOCKS_PER_SM * sm_count)
    return NormPlan(ONE_PASS, warps, nv, block_rows, grid)


def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def rmsnorm_reference(x, scale, eps: float = 1e-6) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps) * scale`` over the last dim, in fp32,
    rounded once to x's dtype."""
    x32 = x.float()
    var = (x32 * x32).mean(-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def add_rmsnorm_reference(x, residual, scale, eps: float = 1e-6):
    """(normed, summed): the fp32 sum ``x + residual`` stored in x's
    dtype, and the RMSNorm of the fp32 sum (not of the stored one)."""
    s = x.float() + residual.float()
    var = (s * s).mean(-1, keepdim=True)
    normed = (s * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)
    return normed, s.to(x.dtype)


def _kernels():
    from tony_tpu_torch.ops import _build

    lib = _build.load("fused_norms")
    if lib.tony_rmsnorm.argtypes is None:
        lib.tony_rmsnorm.restype = ctypes.c_int
        lib.tony_rmsnorm.argtypes = [ctypes.c_int] * 2 \
            + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 \
            + [ctypes.c_float] + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        lib.tony_add_rmsnorm.restype = ctypes.c_int
        lib.tony_add_rmsnorm.argtypes = [ctypes.c_int] * 3 \
            + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 \
            + [ctypes.c_float] + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        lib.tony_norm_resources.restype = ctypes.c_int
        lib.tony_norm_resources.argtypes = [ctypes.c_int] * 5 \
            + [ctypes.POINTER(ctypes.c_int)]
        lib.tony_norm_const.restype = ctypes.c_int
        lib.tony_norm_const.argtypes = [ctypes.c_int]
        mirrored = (LANE_VALUES, MAX_ROW_WARPS, BLOCK_WARPS, BLOCKS_PER_SM)
        built = tuple(lib.tony_norm_const(i) for i in range(4))
        if built != mirrored:
            raise RuntimeError(f"csrc/fused_norms.cu's constants {built} "
                               f"differ from ops/fused.py's {mirrored}")
    return lib


def kernel_resources(d: int) -> dict:
    """One-pass blocks an SM holds at width d, as
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` reports them, keyed
    (x dtype, r dtype or None for rmsnorm) over the dtype pairs of the
    smoke's calls."""
    lib = _kernels()
    out = {}
    for xd, rd in ((torch.float32, None), (torch.float32, torch.float32),
                   (torch.bfloat16, None), (torch.bfloat16, torch.bfloat16)):
        p = plan(8192, d, xd, rd, 1)
        blocks = ctypes.c_int()
        err = lib.tony_norm_resources(
            _DTYPE_CODES[xd], -1 if rd is None else _DTYPE_CODES[rd],
            p.lane_vectors, p.block_rows * p.row_warps * 32, d,
            ctypes.byref(blocks))
        if err != 0:
            raise RuntimeError(f"occupancy query for the norm kernel ({xd}, "
                               f"{rd}, d {d}) failed: CUDA error {err}")
        out[(xd, rd)] = blocks.value
    return out


def _check(x, scale, residual=None) -> None:
    d = x.shape[-1] if x.dim() else 0
    if x.dim() == 0 or tuple(scale.shape) != (d,):
        raise ValueError(f"shape mismatch: x{tuple(x.shape)} "
                         f"scale{tuple(scale.shape)}")
    if residual is not None and residual.shape != x.shape:
        raise ValueError(f"shape mismatch: x{tuple(x.shape)} "
                         f"residual{tuple(residual.shape)}")


def _cuda_args(name, x, scale, residual=None) -> None:
    """The kernel's conditions on CUDA inputs; raises on anything else."""
    tensors = [x, scale] + ([residual] if residual is not None else [])
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {x.device}")
    if any(t.device != x.device for t in tensors):
        raise ValueError(f"{name}: inputs must share one device")
    if any(t.dtype not in _DTYPE_CODES for t in tensors):
        raise ValueError(f"{name} takes float32 or bfloat16 inputs, not "
                         f"{[t.dtype for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} needs contiguous inputs")


def rmsnorm(x, scale, *, eps: float = 1e-6) -> torch.Tensor:
    """x: [..., D], scale: [D] -> [..., D] in x's dtype.

    CPU tensors run ``rmsnorm_reference``; CUDA tensors launch the
    kernel (``rmsnorm.launches`` counts the launches) or raise."""
    _check(x, scale)
    if x.device.type == "cpu":
        return rmsnorm_reference(x, scale, eps)
    _cuda_args("rmsnorm", x, scale)
    d = x.shape[-1]
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    rows = x.numel() // d
    p = plan(rows, d, x.dtype, None, _sms(x.device.index))
    err = _kernels().tony_rmsnorm(
        _DTYPE_CODES[x.dtype], _DTYPE_CODES[scale.dtype], x.data_ptr(),
        scale.data_ptr(), out.data_ptr(), rows, d, float(eps), *p,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rmsnorm kernel launch failed: CUDA error {err}")
    rmsnorm.launches += 1
    return out


def add_rmsnorm(x, residual, scale, *, eps: float = 1e-6):
    """Fused ``(x + residual) -> (normed, summed)``, both [..., D] in x's
    dtype; ``residual`` may have another dtype. Returns the residual
    stream's sum too, as a transformer block needs it.

    CPU tensors run ``add_rmsnorm_reference``; CUDA tensors launch the
    kernel (``add_rmsnorm.launches`` counts the launches) or raise."""
    _check(x, scale, residual)
    if x.device.type == "cpu":
        return add_rmsnorm_reference(x, residual, scale, eps)
    _cuda_args("add_rmsnorm", x, scale, residual)
    d = x.shape[-1]
    normed = torch.empty_like(x)
    summed = torch.empty_like(x)
    if x.numel() == 0:
        return normed, summed
    rows = x.numel() // d
    p = plan(rows, d, x.dtype, residual.dtype, _sms(x.device.index))
    err = _kernels().tony_add_rmsnorm(
        _DTYPE_CODES[x.dtype], _DTYPE_CODES[residual.dtype],
        _DTYPE_CODES[scale.dtype], x.data_ptr(), residual.data_ptr(),
        scale.data_ptr(), normed.data_ptr(), summed.data_ptr(), rows, d,
        float(eps), *p, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"add_rmsnorm kernel launch failed: CUDA error "
                           f"{err}")
    add_rmsnorm.launches += 1
    return normed, summed


rmsnorm.launches = 0
add_rmsnorm.launches = 0
