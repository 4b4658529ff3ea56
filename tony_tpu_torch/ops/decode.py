"""Flash-decode: single-query KV-cache attention, as a CUDA kernel for
Hopper (``csrc/flash_decode.cu``) beside its plain PyTorch version.

Counterpart of ``tony_tpu/ops/decode.py``, whose two Pallas kernels
(``_decode_kernel``, the GQA form, and ``_decode_kernel_mha``) compute
the one function ported here. ``flash_decode`` launches the CUDA kernel
for a CUDA tensor and runs ``flash_decode_reference`` only for a tensor
on the CPU; a CUDA call that cannot launch raises. A bf16 q over a bf16
or int8 cache at head dim 64 or 128 takes the kernel's tensor-core route;
the other pairs take its SIMT route (the CUDA source decides; ``plan``
reports it).

``quantize_kv`` / ``dequantize_kv`` are the int8 cache's
quantize-on-write recipe, bit for bit the JAX package's.
"""

from __future__ import annotations

import ctypes
import functools

import torch

NEG_INF = -1e30
TILE_KEYS = 64  # keys per tile in csrc/flash_decode.cu (TK)
STAGES = 2      # K/V tiles a tensor-core block keeps in flight (STAGES)
TC_HEAD_DIMS = (64, 128)
# K/V bytes an SM keeps in flight to draw its share of the card's memory
# rate: 3.35 TB/s over 132 SMs is about 25 KB a microsecond, and a load
# under full traffic takes a microsecond or two, so 64 KiB leaves room
IN_FLIGHT_BYTES = 64 * 1024

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[B, L, H, D] float -> (int8 values, fp32 scales [B, L, H]).
    Symmetric absmax per (batch, position, head); dequant is
    ``q * scale[..., None]``. ``torch.round`` rounds half to even, as
    ``jnp.round`` does."""
    x32 = x.float()
    absmax = x32.abs().amax(dim=-1)
    scale = torch.clamp(absmax, min=1e-8) / 127.0
    q = torch.clamp(torch.round(x32 / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale[..., None]


def _kernel():
    from tony_tpu_torch.ops import _build

    fn = _build.load("flash_decode").tony_flash_decode
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int, ctypes.c_int] \
            + [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 \
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    return fn


@functools.lru_cache(maxsize=None)
def _kernel_route(kv_dtype, q_dtype, d: int) -> int:
    """The CUDA source's route for a dtype pair and head dim: 1 the
    tensor cores, 0 SIMT, -1 not built."""
    from tony_tpu_torch.ops import _build

    fn = _build.load("flash_decode").tony_flash_decode_route
    return fn(_DTYPE_CODES[kv_dtype], _DTYPE_CODES[q_dtype], d)


def kernel_resources() -> dict:
    """The tensor-core kernel for each cache dtype at each head dim: its
    dynamic shared memory (bytes) and blocks per SM, as
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` reports them."""
    from tony_tpu_torch.ops import _build

    fn = _build.load("flash_decode").tony_flash_decode_resources
    out = {}
    for code, name in ((1, "bf16"), (2, "int8")):
        for d in TC_HEAD_DIMS:
            smem, blocks = ctypes.c_int(), ctypes.c_int()
            err = fn(code, d, ctypes.byref(smem), ctypes.byref(blocks))
            if err != 0:
                raise RuntimeError(f"occupancy query for the {name} cache "
                                   f"at D={d} failed: CUDA error {err}")
            out[(name, d)] = {"smem": smem.value, "blocks": blocks.value}
    return out


def block_bytes(kv_dtype, d: int) -> int:
    """The K/V (and int8 scale) bytes one tensor-core block keeps in
    flight: STAGES tiles of TILE_KEYS keys."""
    scales = 2 * TILE_KEYS * 4 if kv_dtype == torch.int8 else 0
    return STAGES * (2 * TILE_KEYS * d * kv_dtype.itemsize + scales)


def n_splits(b: int, kvh: int, extent: int, sm_count: int,
             in_flight: int | None = None, mtiles: int = 1) -> int:
    """KV splits per (row, KV head, m-tile of 16 query rows), the rule of
    both routes: enough blocks that every SM holds its share of loads in
    flight, and no split shorter than one tile of the most keys a row can
    see (``extent``).

    The tensor-core route double-buffers its tiles, so an SM needs
    ceil(IN_FLIGHT_BYTES / ``in_flight``) of its blocks, ``in_flight``
    being a block's ``block_bytes``: 1 for a bf16 cache at D = 128 (64
    KiB a block), 2 for an int8 one (33 KiB). The SIMT route
    (``in_flight`` None) keeps no load in flight while it computes and
    takes two blocks an SM."""
    per_sm = 2 if in_flight is None else -(-IN_FLIGHT_BYTES // in_flight)
    want = -(-per_sm * sm_count // max(1, b * kvh * mtiles))
    return max(1, min(want, -(-extent // TILE_KEYS)))


def plan(q, k, window: int = 0) -> tuple[bool, int]:
    """(tensor-core route, KV splits) for a CUDA call on these tensors:
    ``n_splits`` with the card's SM count."""
    b, h, d = q.shape
    s, kvh = k.shape[1], k.shape[2]
    tc = _kernel_route(k.dtype, q.dtype, d) == 1
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    extent = min(s, window) if window > 0 else s
    if not tc:
        return False, n_splits(b, kvh, extent, sms)
    return True, n_splits(b, kvh, extent, sms, block_bytes(k.dtype, d),
                          mtiles=-(-(h // kvh) // 16))


def _lengths(length, b: int, device) -> torch.Tensor:
    if isinstance(length, torch.Tensor):
        length = length.to(device=device, dtype=torch.int32)
        if length.dim() == 0:
            length = length.expand(b)
        return length.reshape(b).contiguous()
    return torch.full((b,), int(length), dtype=torch.int32, device=device)


def _check(q, k, v, k_scale, v_scale) -> bool:
    """The ``tony_tpu/ops/decode.py`` shape rules; returns ``quant``."""
    if q.dim() != 3 or k.dim() != 4:
        raise ValueError(f"shape mismatch: q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)}")
    b, h, d = q.shape
    bs, _, kvh, dk = k.shape
    if bs != b or dk != d or v.shape != k.shape:
        raise ValueError(f"shape mismatch: q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)}")
    if h % kvh:
        raise ValueError(f"q heads {h} not divisible by kv heads {kvh}")
    quant = k.dtype == torch.int8
    if quant != (v.dtype == torch.int8):
        raise ValueError("k and v must both be int8 or both float")
    if quant and (k_scale is None or v_scale is None):
        raise ValueError("int8 cache needs k_scale and v_scale")
    if quant and (k_scale.shape != k.shape[:3]
                  or v_scale.shape != k.shape[:3]):
        raise ValueError(f"scale shape mismatch: k_scale"
                         f"{tuple(k_scale.shape)} v_scale"
                         f"{tuple(v_scale.shape)} for cache "
                         f"{tuple(k.shape)}")
    return quant


def flash_decode_reference(q, k, v, length, *, window: int = 0,
                           k_scale=None, v_scale=None) -> torch.Tensor:
    """Plain PyTorch flash-decode, the same function as the kernel: fp32
    scores over the visible keys, int8 scales folded onto scores and
    probabilities, exact zeros for a length-0 row. Returns [B, H, D] in
    q's dtype."""
    quant = _check(q, k, v, k_scale, v_scale)
    b, h, d = q.shape
    s, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    length = _lengths(length, b, q.device)
    qg = q.float().reshape(b, kvh, g, d)
    scores = torch.einsum("bhgd,bshd->bhgs", qg, k.float())
    if quant:
        scores = scores * k_scale.permute(0, 2, 1)[:, :, None, :]
    scores = scores * d ** -0.5
    pos = torch.arange(s, device=q.device)[None, :]
    ln = length[:, None]
    visible = pos < ln
    if window > 0:
        visible = visible & (pos >= torch.clamp(ln - window, min=0))
    scores = torch.where(visible[:, None, None, :], scores,
                         torch.full_like(scores, NEG_INF))
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    l_sum = p.sum(dim=-1, keepdim=True)
    if quant:
        p = p * v_scale.permute(0, 2, 1)[:, :, None, :]
    out = torch.einsum("bhgs,bshd->bhgd", p, v.float()) / l_sum
    out = torch.where((length > 0)[:, None, None, None], out,
                      torch.zeros_like(out))
    return out.reshape(b, h, d).to(q.dtype)


def flash_decode(q, k, v, length, *, window: int = 0, k_scale=None,
                 v_scale=None) -> torch.Tensor:
    """Single-step decode attention over a KV cache.

    q: [B, H, D] — the one new query per sequence (GQA: H a multiple of
      KVH; head h reads KV head h // (H // KVH)).
    k/v: [B, S, KVH, D] cache buffers — fp32 or bf16 matching q, or
      int8 with ``k_scale``/``v_scale`` [B, S, KVH] fp32 per-(position,
      head) scales (quantize-on-write, ``quantize_kv``).
    length: [B] int32 (or a scalar) — valid cache length per row;
      positions >= length are masked, and a length of 0 gives exact
      zeros. window: sliding window (key visible iff 0 <= q_pos - k_pos
      < window), 0 = none.
    Returns [B, H, D] in q's dtype.

    CPU tensors run ``flash_decode_reference``; CUDA tensors launch the
    kernel (``flash_decode.launches`` counts the launches; inside a
    replayed CUDA graph ``models.graphs`` keeps the count true) or
    raise."""
    quant = _check(q, k, v, k_scale, v_scale)
    dev = q.device
    if dev.type == "cpu":
        return flash_decode_reference(q, k, v, length, window=window,
                                      k_scale=k_scale, v_scale=v_scale)
    if dev.type != "cuda":
        raise ValueError(f"flash_decode runs on cuda or cpu, not {dev}")
    tensors = [k, v] + ([k_scale, v_scale] if quant else [])
    if any(t.device != dev for t in tensors):
        raise ValueError("q, k, v and the scales must share one device")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"q must be float32 or bfloat16, not {q.dtype}")
    if not quant and k.dtype != q.dtype:
        raise ValueError(f"float cache dtype {k.dtype} must match q "
                         f"dtype {q.dtype}")
    if quant and (k_scale.dtype != torch.float32
                  or v_scale.dtype != torch.float32):
        raise ValueError("int8 cache scales must be float32")
    if not all(t.is_contiguous() for t in [q] + tensors):
        raise ValueError("flash_decode needs contiguous q, k, v and "
                         "scales")
    b, h, d = q.shape
    s, kvh = k.shape[1], k.shape[2]
    vec = 16 // k.element_size()
    if d % vec:
        raise ValueError(f"head dim {d} must be a multiple of {vec} for "
                         f"16-byte loads of a {k.dtype} cache")
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("flash_decode reads k and v in 16-byte chunks: "
                         "they must be 16-byte aligned")
    # a length past the cache's S positions sees all S of them, a
    # negative one sees none (the JAX kernels' mask): the kernels clamp
    lengths = _lengths(length, b, dev)
    out = torch.empty_like(q)
    if b == 0:
        return out
    _, nsplit = plan(q, k, window)
    # the split-KV partials: (max, sum) and the accumulator per query row
    part_ml = part_acc = None
    if nsplit > 1:
        n_ml = b * kvh * nsplit * (h // kvh) * 2
        part = torch.empty(n_ml * (1 + d // 2), dtype=torch.float32,
                           device=dev)
        part_ml, part_acc = part[:n_ml], part[n_ml:]
    err = _kernel()(
        _DTYPE_CODES[k.dtype], _DTYPE_CODES[q.dtype], q.data_ptr(),
        k.data_ptr(), v.data_ptr(),
        k_scale.data_ptr() if quant else None,
        v_scale.data_ptr() if quant else None,
        lengths.data_ptr(), out.data_ptr(),
        None if part_ml is None else part_ml.data_ptr(),
        None if part_acc is None else part_acc.data_ptr(), b, h, kvh, s, d,
        int(window), float(d ** -0.5), nsplit,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_decode kernel launch failed: CUDA "
                           f"error {err}")
    flash_decode.launches += 1
    return out


flash_decode.launches = 0
