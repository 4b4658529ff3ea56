"""Flash attention: the FlashAttention-2 forward and backward as CUDA
kernels for Hopper (``csrc/flash_attention.cu``) beside their plain
PyTorch version.

Counterpart of ``tony_tpu/ops/attention.py``, whose three Pallas kernels
(``_flash_kernel``, ``_flash_bwd_dq_kernel``, ``_flash_bwd_dkv_kernel``)
become the three kernels of one CUDA source. ``flash_attention`` keeps
the JAX contract: q ``[B, L, H, D]``, k/v ``[B, L, KVH, D]`` (GQA by head
group, never repeated), causal, a sliding ``window`` and packed
``segment_ids``. On a CUDA tensor it runs ``FlashAttention``, an
``autograd.Function`` whose forward saves (q, k, v, o, lse) and whose
backward computes ``delta = rowsum(dO * O)`` in PyTorch and launches the
dQ and dK/dV kernels; on a CPU tensor it runs
``flash_attention_reference``, whose gradient comes from autograd. The
bf16 forward and backward run on the tensor cores; the fp32 build keeps
SIMT fp32 kernels (the tensor cores have no fp32 mode that meets its
limit).

Deliberate divergences from the JAX function (ROADMAP queue 3):
- the kernels take any sequence length with bounds checks, so the
  pad-and-slice path and the "no usable block" errors are gone, and
  ``block_q``/``block_k`` (TPU tile sizes) do not change the result;
- the one length error kept is the JAX one for causal attention with
  unequal lengths that its blocks do not divide, where the JAX function
  would have had to pad.
"""

from __future__ import annotations

import ctypes

import torch

NEG_INF = -1e30
HEAD_DIMS = (64, 128)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _kernel():
    from tony_tpu_torch.ops import _build

    fn = _build.load("flash_attention").tony_flash_attention
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 14 \
            + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p]
    return fn


def kernel_resources() -> dict:
    """The bf16 tensor-core kernels (forward, dQ, dK/dV) at each head
    dim: their dynamic shared memory (bytes) and blocks per SM, as
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` reports them."""
    from tony_tpu_torch.ops import _build

    fn = _build.load("flash_attention").tony_flash_attention_resources
    out = {}
    for which, name in ((0, "fwd"), (1, "dq"), (2, "dkv")):
        for d in HEAD_DIMS:
            smem, blocks = ctypes.c_int(), ctypes.c_int()
            err = fn(which, d, ctypes.byref(smem), ctypes.byref(blocks))
            if err != 0:
                raise RuntimeError(f"occupancy query for {name} D={d} "
                                   f"failed: CUDA error {err}")
            out[(name, d)] = {"smem": smem.value, "blocks": blocks.value}
    return out


def dkv_splits(b: int, lk: int, kvh: int, group: int, device) -> int:
    """How many blocks share a KV head's query group in the bf16 dK/dV
    kernel: the fewest (a divisor of the group) whose blocks fill every
    block slot of the card (two an SM) at least once, so k tiles of
    uneven causal work even out; each split beyond one adds an fp32
    partial of dK and dV that a second pass sums in split order. At the
    training call (B=4, L=2048, KVH=2, group 6) that is 2 (``chip_smoke``
    phase 6 times every split there)."""
    blocks = -(-lk // 64) * kvh * b
    slots = 2 * torch.cuda.get_device_properties(device) \
        .multi_processor_count
    return next(s for s in range(1, group + 1)
                if group % s == 0 and (blocks * s >= slots or s == group))


def _blockable(length: int, limit: int) -> bool:
    """The JAX ``_pick_block`` rule: some block <= ``limit`` that is the
    whole length or a multiple of 8 divides it."""
    b = min(limit, length)
    if length % b == 0:
        return True
    return any(length % c == 0 for c in range(b - b % 8, 7, -8))


def _check(q, k, v, causal: bool, window: int, segment_ids,
           block_q: int, block_k: int) -> None:
    """The JAX function's semantic errors."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape \
            or q.shape[0] != k.shape[0] or q.shape[3] != k.shape[3]:
        raise ValueError(f"shape mismatch: q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)}")
    lq, lk = q.shape[1], k.shape[1]
    if q.shape[2] % k.shape[2]:
        raise ValueError(f"q heads {q.shape[2]} not divisible by kv heads "
                         f"{k.shape[2]}")
    if window > 0 and not causal:
        raise ValueError("window > 0 requires causal=True (the sliding "
                         "window is defined over past keys)")
    if window > 0 and lq != lk:
        raise ValueError("window > 0 needs self-attention shapes (lq == "
                         f"lk), got ({lq}, {lk})")
    if segment_ids is not None:
        if not causal:
            raise ValueError("segment_ids require causal=True (packed-LM "
                             "masking)")
        if lq != lk:
            raise ValueError("segment_ids need self-attention shapes "
                             f"(lq == lk), got ({lq}, {lk})")
        if tuple(segment_ids.shape) != (q.shape[0], lq):
            raise ValueError(f"segment_ids shape {tuple(segment_ids.shape)}"
                             f" != (batch, seq) {(q.shape[0], lq)}")
    if causal and lq != lk and not (_blockable(lq, block_q)
                                    and _blockable(lk, block_k)):
        raise ValueError(
            f"causal flash attention with unblockable UNEQUAL seq lens "
            f"({lq}, {lk}) cannot be zero-padded safely; pad the inputs "
            f"yourself or use the blockwise backend")


def visibility(lq: int, lk: int, causal: bool, window: int = 0,
               segment_ids=None, device=None) -> torch.Tensor:
    """[B or 1, Lq, Lk] bool: key j visible to query i (the kernels'
    mask; causal is top-left aligned, as the JAX kernels' is)."""
    i = torch.arange(lq, device=device)[:, None]
    j = torch.arange(lk, device=device)[None, :]
    vis = torch.ones(lq, lk, dtype=torch.bool, device=device)
    if causal:
        vis = j <= i
        if window > 0:
            vis = vis & (i - j < window)
    vis = vis[None]
    if segment_ids is not None:
        seg = segment_ids.to(device)
        vis = vis & (seg[:, :, None] == seg[:, None, :])
    return vis


class _RoundGrad(torch.autograd.Function):
    """Identity forward; the gradient is rounded to ``dtype``: dS enters
    dS.K and dS^T.Q as an operand of the input dtype, as in the kernels."""

    @staticmethod
    def forward(ctx, x, dtype):
        ctx.dtype = dtype
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype).float(), None


def _round_value(x: torch.Tensor, dtype) -> torch.Tensor:
    """x rounded to ``dtype`` (and back to fp32) in value, with the
    gradient passed through unrounded: p enters P.V as an operand of the
    input dtype, while its gradient dP stays fp32, as in the kernels."""
    return x + (x.to(dtype).float() - x).detach()


def flash_attention_reference(q, k, v, causal: bool = True,
                              window: int = 0, segment_ids=None,
                              return_lse: bool = False):
    """The plain PyTorch version of the three kernels, on whole tensors:
    raw fp32 scores, masked to NEG_INF; p = exp((s - max) * scale) rounded
    to the input dtype before P.V; l clamped at 1e-30; lse = max * scale
    + log l. Its autograd gradient rounds dS to the input dtype, as the
    kernels do. Returns o [B, Lq, H, D] in q's dtype (and lse
    [B*H, Lq] fp32 with ``return_lse``)."""
    b, lq, h, d = q.shape
    lk, kvh = k.shape[1], k.shape[2]
    group = h // kvh
    scale = d ** -0.5
    dt = q.dtype
    kr = k.repeat_interleave(group, dim=2) if group > 1 else k
    vr = v.repeat_interleave(group, dim=2) if group > 1 else v
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kr.float())
    s = _RoundGrad.apply(s, dt)
    vis = visibility(lq, lk, causal, window, segment_ids, q.device)
    s = torch.where(vis[:, None], s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True).detach()
    p = torch.exp((s - m) * scale)
    p = torch.where(vis[:, None], p, torch.zeros_like(p))
    l = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    o = torch.einsum("bhqk,bkhd->bqhd", _round_value(p, dt), vr.float())
    o = (o / l.permute(0, 2, 1, 3)).to(dt)
    if not return_lse:
        return o
    lse = (m * scale + torch.log(l))[..., 0].reshape(b * h, lq)
    return o, lse.detach()


def flash_attention_bwd_reference(q, k, v, o, lse, do, causal: bool = True,
                                  window: int = 0, segment_ids=None):
    """The plain PyTorch version of the two backward kernels, from the
    saved (o, lse): p = exp(s * scale - lse), dS = p * (dO.V - delta)
    with delta = rowsum(dO * O), rounded to the input dtype before
    dS.K and dS^T.Q; p rounded before P^T.dO. Returns (dq, dk, dv)."""
    b, lq, h, d = q.shape
    lk, kvh = k.shape[1], k.shape[2]
    group = h // kvh
    scale = d ** -0.5
    dt = q.dtype
    kr = k.repeat_interleave(group, dim=2).float()
    vr = v.repeat_interleave(group, dim=2).float()
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kr)
    vis = visibility(lq, lk, causal, window, segment_ids, q.device)[:, None]
    lse4 = lse.reshape(b, h, lq, 1)
    p = torch.where(vis, torch.exp(s * scale - lse4), torch.zeros_like(s))
    delta = (do.float() * o.float()).sum(-1).permute(0, 2, 1)[..., None]
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), vr)
    ds = (p * (dp - delta)).to(dt).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kr) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(dt).float(), do.float())
    dk = dk.reshape(b, lk, kvh, group, d).sum(3)
    dv = dv.reshape(b, lk, kvh, group, d).sum(3)
    return dq.to(dt), dk.to(dt), dv.to(dt)


def error_bound(q, k, v, o, lse, do=None, causal: bool = True,
                window: int = 0, segment_ids=None) -> dict:
    """Per-element limits for the kernels against the plain version:
    ``{"o": .., "dq": .., "dk": .., "dv": ..}`` (the gradients only with
    ``do``), each shaped like its output, for |got - want| <= limit.

    Each output element is a sum of products; the two versions may round
    each product's input-dtype operand (p or dS) differently and sum in
    another order. So the limit is u times the element's magnitude M,
    the same sum over absolute values: M_o = sum_j p_ij |v_j| (p
    normalised), M_dv = sum_i p_ij |dO_i|, and with
    M_dS_ij = p_ij (|dO_i|.|v_j| + |dO_i|.|o_i|) (which bounds |dS| and
    the error delta = rowsum(dO * O) brings into it), M_dq = scale
    sum_j M_dS_ij |k_j| and M_dk = scale sum_i M_dS_ij |q_i|; plus u
    |want| for the rounding of the output itself. u = 2^-7 for bf16 (two
    independent roundings of 2^-9 each, with a factor two to spare) and
    2^-14 for fp32 (reordered fp32 sums over up to L terms, and the
    rounding of the scores carried through the exp). Dropping one
    64-key tile of L visible keys moves an element by about 64 / L of M,
    far above either limit."""
    b, lq, h, d = q.shape
    lk, kvh = k.shape[1], k.shape[2]
    group = h // kvh
    scale = d ** -0.5
    u = 2.0 ** -7 if q.dtype == torch.bfloat16 else 2.0 ** -14
    kr = k.repeat_interleave(group, dim=2).float()
    vr = v.repeat_interleave(group, dim=2).float()
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kr)
    vis = visibility(lq, lk, causal, window, segment_ids, q.device)[:, None]
    p = torch.where(vis, torch.exp(s * scale - lse.reshape(b, h, lq, 1)),
                    torch.zeros_like(s))
    del s
    out = {"o": u * (torch.einsum("bhqk,bkhd->bqhd", p, vr.abs())
                     + o.float().abs())}
    if do is None:
        return out
    dof = do.float().abs()
    mds = p * (torch.einsum("bqhd,bkhd->bhqk", dof, vr.abs())
               + (dof * o.float().abs()).sum(-1).permute(0, 2, 1)[..., None])
    out["dq"] = u * scale * torch.einsum("bhqk,bkhd->bqhd", mds, kr.abs())
    dk = scale * torch.einsum("bhqk,bqhd->bkhd", mds, q.float().abs())
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    out["dk"] = u * dk.reshape(b, lk, kvh, group, d).sum(3)
    out["dv"] = u * dv.reshape(b, lk, kvh, group, d).sum(3)
    return out


def _strides(t) -> list[int]:
    return [t.stride(0), t.stride(1), t.stride(2)]


def _prepare(q, k, v, segment_ids):
    dev = q.device
    if any(t.device != dev for t in (k, v)):
        raise ValueError("q, k and v must share one device")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"flash_attention takes float32 or bfloat16 q, k "
                         f"and v of one dtype, not {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if q.shape[3] not in HEAD_DIMS:
        raise ValueError(f"head dim {q.shape[3]} not in {HEAD_DIMS} (the "
                         f"kernels are built for those)")
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention needs a contiguous last dim")
    if segment_ids is not None:
        segment_ids = segment_ids.to(device=dev,
                                     dtype=torch.int32).contiguous()
    return segment_ids


def _rows16(t):
    """``t`` if the bf16 kernels' 16-byte row copies can read it (a
    16-byte aligned base, strides of 8-element multiples), else a
    contiguous copy."""
    if t.data_ptr() % 16 == 0 and all(
            st % 8 == 0 for st, n in zip(t.stride()[:3], t.shape) if n > 1):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _launch(which: int, q, k, v, seg, *, causal, window, do=None,
            lse=None, delta=None, out=None, lse_out=None, dq=None,
            dk=None, dv=None, part=None, splits: int = 1) -> None:
    """One launch of kernel ``which`` (0 forward, 1 dQ, 2 dK/dV) into
    the given output tensors; bf16 dK/dV with ``splits`` > 1 sums its
    partials in ``part``."""
    b, lq, h, d = q.shape
    lk, kvh = k.shape[1], k.shape[2]
    strides = _strides(q) + _strides(k) + _strides(v) \
        + (_strides(do) if do is not None else [0, 0, 0])

    def ptr(t):
        return None if t is None else t.data_ptr()

    err = _kernel()(
        which, _DTYPE_CODES[q.dtype], d, q.data_ptr(), k.data_ptr(),
        v.data_ptr(), ptr(do), ptr(seg), ptr(lse), ptr(delta), ptr(out),
        ptr(lse_out), ptr(dq), ptr(dk), ptr(dv), ptr(part),
        ctypes.cast((ctypes.c_longlong * 12)(*strides), ctypes.c_void_p),
        b, h, kvh, lq, lk, int(causal), int(window), int(splits),
        float(d ** -0.5), torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash attention kernel {which} launch failed: "
                           f"CUDA error {err}")


def flash_attention_fwd(q, k, v, causal: bool = True, window: int = 0,
                        segment_ids=None):
    """The forward kernel: (o [B, Lq, H, D], lse [B*H, Lq] fp32). CPU
    tensors run the plain version."""
    if q.device.type == "cpu":
        with torch.no_grad():
            return flash_attention_reference(q, k, v, causal, window,
                                             segment_ids, return_lse=True)
    seg = _prepare(q, k, v, segment_ids)
    if q.dtype == torch.bfloat16:
        q, k, v = (_rows16(t) for t in (q, k, v))
    b, lq, h, d = q.shape
    out = torch.empty(b, lq, h, d, dtype=q.dtype, device=q.device)
    lse = torch.empty(b * h, lq, dtype=torch.float32, device=q.device)
    _launch(0, q, k, v, seg, causal=causal, window=window, out=out,
            lse_out=lse)
    flash_attention_fwd.launches += 1
    return out, lse


def _delta(o, do) -> torch.Tensor:
    """delta = rowsum(dO * O) in fp32, [B*H, L] (lse's layout): one cheap
    pass in PyTorch, as XLA computes it beside the JAX kernels."""
    b, lq, h, _ = o.shape
    return (do.float() * o.float()).sum(-1).permute(0, 2, 1) \
        .reshape(b * h, lq).contiguous()


def flash_attention_bwd_dq(q, k, v, o, lse, do, causal: bool = True,
                           window: int = 0, segment_ids=None,
                           delta=None):
    """The dQ kernel: dq [B, Lq, H, D]. CPU tensors run the plain
    version."""
    if q.device.type == "cpu":
        return flash_attention_bwd_reference(q, k, v, o, lse, do, causal,
                                             window, segment_ids)[0]
    seg = _prepare(q, k, v, segment_ids)
    do = do if do.stride(3) == 1 else do.contiguous()
    delta = _delta(o, do) if delta is None else delta
    if q.dtype == torch.bfloat16:
        q, k, v, do = (_rows16(t) for t in (q, k, v, do))
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch(1, q, k, v, seg, causal=causal, window=window, do=do,
            lse=lse.contiguous(), delta=delta, dq=dq)
    flash_attention_bwd_dq.launches += 1
    return dq


def flash_attention_bwd_dkv(q, k, v, o, lse, do, causal: bool = True,
                            window: int = 0, segment_ids=None,
                            delta=None):
    """The dK/dV kernel: (dk, dv) [B, Lk, KVH, D], summed over each KV
    head's query group. CPU tensors run the plain version."""
    if q.device.type == "cpu":
        return flash_attention_bwd_reference(q, k, v, o, lse, do, causal,
                                             window, segment_ids)[1:]
    seg = _prepare(q, k, v, segment_ids)
    do = do if do.stride(3) == 1 else do.contiguous()
    delta = _delta(o, do) if delta is None else delta
    splits, part = 1, None
    if q.dtype == torch.bfloat16:
        q, k, v, do = (_rows16(t) for t in (q, k, v, do))
        splits = dkv_splits(k.shape[0], k.shape[1], k.shape[2],
                            q.shape[2] // k.shape[2], k.device)
        if splits > 1:
            part = torch.empty(2 * splits * k.numel(), dtype=torch.float32,
                               device=k.device)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    _launch(2, q, k, v, seg, causal=causal, window=window, do=do,
            lse=lse.contiguous(), delta=delta, dk=dk, dv=dv, part=part,
            splits=splits)
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


flash_attention_fwd.launches = 0
flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dkv.launches = 0


class FlashAttention(torch.autograd.Function):
    """The kernels under autograd: the forward saves (q, k, v, o, lse);
    the backward computes delta once and launches dQ and dK/dV."""

    @staticmethod
    def forward(ctx, q, k, v, segment_ids, causal, window):
        o, lse = flash_attention_fwd(q, k, v, causal, window, segment_ids)
        ctx.save_for_backward(q, k, v, o, lse, segment_ids)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, seg = ctx.saved_tensors
        kw = dict(causal=ctx.causal, window=ctx.window, segment_ids=seg)
        do = do if do.stride(-1) == 1 else do.contiguous()
        delta = _delta(o, do)
        dq = flash_attention_bwd_dq(q, k, v, o, lse, do, delta=delta, **kw)
        dk, dv = flash_attention_bwd_dkv(q, k, v, o, lse, do, delta=delta,
                                         **kw)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, causal: bool = True, block_q: int = 512,
                    block_k: int = 512, interpret=None, window: int = 0,
                    segment_ids=None):
    """Fused attention. q [B, L, H, D]; k/v [B, L, KVH, D] with
    H % KVH == 0 (head h reads KV head h // (H // KVH); K/V are never
    repeated). Returns [B, L, H, D] in q's dtype.

    window > 0: key visible iff 0 <= q_pos - k_pos < window (needs
    causal). segment_ids [B, L]: keys visible only within the query's
    segment (needs causal and lq == lk). ``block_q``/``block_k`` and
    ``interpret`` are the JAX signature's TPU knobs: the CUDA kernels
    pick their own tiles, so they change nothing but the one JAX length
    error (see the module docstring).

    CUDA tensors run the kernels (forward and backward); CPU tensors run
    ``flash_attention_reference`` under autograd."""
    _check(q, k, v, causal, window, segment_ids, block_q, block_k)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal, window,
                                         segment_ids)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not "
                         f"{q.device}")
    seg = _prepare(q, k, v, segment_ids)
    return FlashAttention.apply(q, k, v, seg, causal, int(window))
