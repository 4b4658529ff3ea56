"""RMSNorm and residual-add + RMSNorm as CUDA kernels for Hopper
(``csrc/fused_norms.cu``) beside their plain PyTorch versions.

Counterpart of ``tony_tpu/ops/fused.py``: public ops that the model does
not call (neither package's transformer does; its ``RMSNorm`` module
computes the same function in plain tensor code). ``rmsnorm`` and
``add_rmsnorm`` launch the kernel for a CUDA tensor and run their
``*_reference`` version only for a tensor on the CPU; a CUDA call that
cannot launch raises. The JAX ``block_rows`` knob has no counterpart: a
warp normalises one row, whatever the row count.
"""

from __future__ import annotations

import ctypes

import torch

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


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
            + [ctypes.c_float, ctypes.c_void_p]
        lib.tony_add_rmsnorm.restype = ctypes.c_int
        lib.tony_add_rmsnorm.argtypes = [ctypes.c_int] * 3 \
            + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 \
            + [ctypes.c_float, ctypes.c_void_p]
    return lib


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
    err = _kernels().tony_rmsnorm(
        _DTYPE_CODES[x.dtype], _DTYPE_CODES[scale.dtype], x.data_ptr(),
        scale.data_ptr(), out.data_ptr(), x.numel() // d, d,
        float(eps), torch.cuda.current_stream(x.device).cuda_stream)
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
    err = _kernels().tony_add_rmsnorm(
        _DTYPE_CODES[x.dtype], _DTYPE_CODES[residual.dtype],
        _DTYPE_CODES[scale.dtype], x.data_ptr(), residual.data_ptr(),
        scale.data_ptr(), normed.data_ptr(), summed.data_ptr(),
        x.numel() // d, d, float(eps),
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"add_rmsnorm kernel launch failed: CUDA error "
                           f"{err}")
    add_rmsnorm.launches += 1
    return normed, summed


rmsnorm.launches = 0
add_rmsnorm.launches = 0
