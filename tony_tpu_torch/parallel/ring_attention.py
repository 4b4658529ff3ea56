"""Whole-sequence attention on one device: the counterparts of
``tony_tpu/parallel/ring_attention.py``'s ``blockwise_attention`` (the
default training backend, an online-softmax loop over key blocks that
never holds the [L, L] scores) and ``reference_attention`` (the O(L^2)
oracle the tests and ``chip_smoke.py`` hold the other paths against).
Ring and Ulysses sequence parallelism come with the multi-rank part of
the parallelism slice."""

from __future__ import annotations

import torch

NEG_INF = -1e30


def _block_attn(q, k, v, m, l, o, mask):
    """One online-softmax accumulation step, fp32 throughout.

    q [B, Lq, H, D]; k/v [B, Lk, H, D]; m/l [B, H, Lq]; o like q; mask
    (True = attend) [Lq, Lk] shared across the batch or [B, Lq, Lk]."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    bmask = mask[None, None] if mask.dim() == 2 else mask[:, None]
    s = s.masked_fill(~bmask, NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1))
    # a row masked so far adds exp(0) per key here; the first visible
    # key's correction exp(NEG_INF - m) wipes it, as in the reference
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m - m_new)
    l_new = l * corr + p.sum(dim=-1)
    o_new = o * corr[..., None].transpose(1, 2) + torch.einsum(
        "bhqk,bkhd->bqhd", p, v)
    return m_new, l_new, o_new


def blockwise_attention(q, k, v, *, block_size: int = 512,
                        causal: bool = True, window: int = 0,
                        segment_ids=None) -> torch.Tensor:
    """q [B, Lq, H, D], k/v [B, Lk, H, D] -> [B, Lq, H, D] in q's dtype,
    by a loop over key blocks of ``block_size`` with the running max,
    sum and output in fp32: no score tensor larger than [Lq, block] per
    head. Keys are padded to a whole block and masked out. ``window``
    > 0 keeps keys with 0 <= q_pos - k_pos < window (both bounds, also
    when ``causal`` is False); ``segment_ids`` [B, L] keeps keys of the
    query's segment (padded keys are in segment -1). The output is the
    sum over max(l, 1e-30): a row no key reaches keeps the reference's
    value, the mean of V over every key, padding included. Under
    autograd each block's probabilities are kept for the backward, as
    the reference's scan keeps them."""
    b, lq, h, d = q.shape
    lk = k.shape[1]
    block = min(block_size, lk)
    n_blocks = -(-lk // block)
    pad = n_blocks * block - lk
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    if segment_ids is not None:
        seg_q = segment_ids
        seg_k = torch.nn.functional.pad(segment_ids, (0, pad), value=-1) \
            if pad else segment_ids
    dev = q.device
    q32 = q.float()
    m = torch.full((b, h, lq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, h, lq), dtype=torch.float32, device=dev)
    o = torch.zeros((b, lq, h, d), dtype=torch.float32, device=dev)
    pos_q = torch.arange(lq, device=dev)[:, None]
    for i in range(n_blocks):
        lo = i * block
        pos_k = torch.arange(lo, lo + block, device=dev)[None, :]
        mask = (pos_k < lk).expand(lq, block)
        if causal:
            mask = mask & (pos_q >= pos_k)
        if window > 0:
            delta = pos_q - pos_k
            mask = mask & (delta >= 0) & (delta < window)
        if segment_ids is not None:
            mask = mask[None] & (seg_q[:, :, None]
                                 == seg_k[:, None, lo:lo + block])
        m, l, o = _block_attn(q32, k[:, lo:lo + block].float(),
                              v[:, lo:lo + block].float(), m, l, o, mask)
    out = o / torch.clamp(l[..., None].transpose(1, 2), min=1e-30)
    return out.to(q.dtype)


def reference_attention(q, k, v, *, causal: bool = True, window: int = 0,
                        segment_ids=None) -> torch.Tensor:
    """q/k/v [B, L, H, D] -> [B, L, H, D] in q's dtype; fp32 softmax.
    ``window`` > 0 keeps keys with 0 <= q_pos - k_pos < window;
    ``segment_ids`` [B, L] restricts attention to equal ids."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    lq, lk = q.shape[1], k.shape[1]
    pos_q = torch.arange(lq, device=q.device)[:, None]
    pos_k = torch.arange(lk, device=q.device)[None, :]
    neg = torch.full_like(s, NEG_INF)
    if causal:
        s = torch.where((pos_q >= pos_k)[None, None], s, neg)
    if window > 0:
        visible = (pos_q >= pos_k) & (pos_q - pos_k < window)
        s = torch.where(visible[None, None], s, neg)
    if segment_ids is not None:
        same = segment_ids[:, :, None] == segment_ids[:, None, :]
        s = torch.where(same[:, None], s, neg)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)
