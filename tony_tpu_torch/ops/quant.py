"""Weight-only int8: symmetric per-output-column quantization and the
dequant matrix product, as a CUDA kernel for Hopper
(``csrc/q8_matmul.cu``) beside its plain PyTorch version.

Counterpart of ``tony_tpu/ops/quant.py``. Decode reads every weight once
a token, so int8 weights halve the bytes a step against bf16; the kernel
reads the int8 weights and dequantizes them on the chip, applying the
per-column scale once per output. ``q8_matmul`` launches the kernel for
a CUDA tensor and runs ``q8_matmul_reference`` only for a tensor on the
CPU; a CUDA call that cannot launch raises.

Unlike the JAX ``q8_matmul`` it takes any m, n and k: there is no
m-padding (the kernel checks its bounds) and no XLA fallback for an n
without a divisor of at least 64 (nothing in the kernel depends on one).
"""

from __future__ import annotations

import ctypes
import functools

import torch

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
SKINNY_ROWS = 16  # m at or below which the decode tile runs
MIN_SPLIT_K = 256  # no K split shorter than this


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
    2^-7 of the value."""
    mag = (x.float().abs() @ w_q.float().abs()) * scale.float()
    rel = 2.0 ** -7 if want.dtype == torch.bfloat16 else 0.0
    return rel * want.float().abs() + 2.0 ** -14 * mag


def _kernel():
    from tony_tpu_torch.ops import _build

    lib = _build.load("q8_matmul")
    fn = lib.tony_q8_matmul
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 5 \
            + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        lib.tony_q8_matmul_tile.restype = ctypes.c_int
        lib.tony_q8_matmul_tile.argtypes = [ctypes.c_int, ctypes.c_int]
    return fn, lib.tony_q8_matmul_tile


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def plan(m: int, n: int, k: int, device) -> tuple[bool, int, int]:
    """(skinny, splits, k_per_split) for one call: the decode tile for
    m <= SKINNY_ROWS; K split so that about two blocks run per SM, each
    split at least MIN_SPLIT_K deep and a whole number of the tile's
    K chunks."""
    skinny = m <= SKINNY_ROWS
    tile = _kernel()[1]
    bm, bn, bk = (tile(int(skinny), i) for i in range(3))
    tiles = -(-m // bm) * -(-n // bn)
    want = -(-2 * _sms(device.index) // tiles)
    splits = max(1, min(want, k // MIN_SPLIT_K))
    kps = -(-max(k, 1) // splits)
    kps = -(-kps // bk) * bk
    return skinny, -(-max(k, 1) // kps), kps


def q8_matmul(x, w_q, scale, *, out_dtype=None) -> torch.Tensor:
    """x [m, k] fp32 or bf16 @ int8 weights w_q [k, n] with per-column
    fp32 ``scale`` [n] -> [m, n] in ``out_dtype`` (fp32 or bf16;
    default x's dtype), ``cast((x @ w_q) * scale)`` with fp32 sums.

    CPU tensors run ``q8_matmul_reference``; CUDA tensors launch the
    kernel (``q8_matmul.launches`` counts the calls) or raise."""
    _check(x, w_q, scale)
    out_dtype = out_dtype or x.dtype
    dev = x.device
    if dev.type == "cpu":
        return q8_matmul_reference(x, w_q, scale, out_dtype)
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
    m, k = x.shape
    n = w_q.shape[1]
    out = torch.empty(m, n, dtype=out_dtype, device=dev)
    if m == 0 or n == 0:
        return out
    skinny, splits, kps = plan(m, n, k, dev)
    part = torch.empty(splits * m * n if splits > 1 else 0,
                       dtype=torch.float32, device=dev)
    err = _kernel()[0](
        _DTYPE_CODES[x.dtype], _DTYPE_CODES[out_dtype], x.data_ptr(),
        w_q.data_ptr(), scale.data_ptr(), out.data_ptr(),
        part.data_ptr() if splits > 1 else None, m, n, k, splits, kps,
        int(skinny), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"q8_matmul kernel launch failed: CUDA error "
                           f"{err}")
    q8_matmul.launches += 1
    return out


q8_matmul.launches = 0
