"""Chunked-over-vocab softmax cross-entropy: the counterpart of
``tony_tpu/ops/xent.py``.

The logits ``hidden @ embedding.T`` are never materialised: the forward
streams vocab chunks through an online logsumexp and keeps only (max,
sum, label logit) per token; the backward recomputes each ``[T, chunk]``
tile (softmax minus one-hot) and accumulates dH and dE, so no ``[T, V]``
tensor exists in either direction (the JAX scan is rematerialised with
``jax.checkpoint`` for the same reason). The tile products are large
plain matmuls, left to ``torch.matmul`` as the JAX package leaves them
to XLA.

Logit precision: JAX keeps a bf16 product in fp32
(``preferred_element_type``). On a CUDA device whose PyTorch has
``torch.mm(a, b, out_dtype=torch.float32)`` the bf16 operands go to the
tensor cores with an fp32 output; elsewhere (the CPU) the operands,
already rounded to ``compute_dtype``, are upcast and multiplied in fp32,
which gives the same products (a bf16 x bf16 product is exact in fp32).
``logit_route()`` says which route a device takes.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def logit_route(device) -> str:
    """"mm_out_dtype" (bf16 operands, fp32 output on the tensor cores) or
    "upcast" (operands upcast to fp32 before the product)."""
    device = torch.device(device)
    if device.type == "cuda" and torch._C._dispatch_has_kernel_for_dispatch_key(
            "aten::mm.dtype", "CUDA"):
        return "mm_out_dtype"
    return "upcast"


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with an fp32 result for operands of one (possibly bf16)
    dtype."""
    if a.dtype == torch.float32:
        return a @ b
    if logit_route(a.device) == "mm_out_dtype":
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


class _ChunkedCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, hidden, embedding, labels, weights, bias, chunk,
                z_loss, cdt):
        v = embedding.shape[0]
        h_mm = hidden.to(cdt)
        t = h_mm.shape[0]
        dev = hidden.device
        m = torch.full((t,), NEG_INF, dtype=torch.float32, device=dev)
        s = torch.zeros(t, dtype=torch.float32, device=dev)
        lab = torch.full((t,), NEG_INF, dtype=torch.float32, device=dev)
        rows = torch.arange(t, device=dev)
        with torch.no_grad():
            for c0 in range(0, v, chunk):
                c1 = min(c0 + chunk, v)
                logits = _mm(h_mm, embedding[c0:c1].to(cdt).t())
                if bias is not None:
                    logits = logits + bias[c0:c1].float()[None, :]
                m_new = torch.maximum(m, logits.amax(dim=-1))
                s = s * torch.exp(m - m_new) + torch.exp(
                    logits - m_new[:, None]).sum(dim=-1)
                m = m_new
                idx = labels - c0
                inside = (idx >= 0) & (idx < c1 - c0)
                picked = logits[rows, idx.clamp(0, c1 - c0 - 1)]
                lab = torch.where(inside, picked, lab)
        lse = m + torch.log(s)
        per_tok = lse - lab
        if weights is None:
            loss = per_tok.mean()
            if z_loss:
                loss = loss + z_loss * (lse * lse).mean()
            denom = float(t)
        else:
            denom = torch.clamp(weights.sum(), min=1.0)
            loss = (per_tok * weights).sum() / denom
            if z_loss:
                loss = loss + z_loss * (lse * lse * weights).sum() / denom
        ctx.save_for_backward(h_mm, embedding, labels, weights, bias, lse)
        ctx.chunk, ctx.z_loss, ctx.cdt, ctx.denom = chunk, z_loss, cdt, denom
        ctx.h_dtype = hidden.dtype
        return loss

    @staticmethod
    def backward(ctx, g):
        h_mm, embedding, labels, weights, bias, lse = ctx.saved_tensors
        chunk, z_loss, cdt, denom = ctx.chunk, ctx.z_loss, ctx.cdt, ctx.denom
        v = embedding.shape[0]
        t = h_mm.shape[0]
        # d loss / d logit[t, c] = coef_t (softmax - onehot)
        #                        + coef_t 2 z_loss lse_t softmax
        coef = g.float() / denom
        if weights is not None:
            coef = coef * weights
        else:
            coef = coef.expand(t)
        p_coef = coef * (1.0 + 2.0 * z_loss * lse) if z_loss else coef
        dh = torch.zeros(h_mm.shape, dtype=torch.float32,
                         device=h_mm.device)
        de = torch.zeros(embedding.shape, dtype=torch.float32,
                         device=embedding.device) \
            if ctx.needs_input_grad[1] else None
        dbias = torch.zeros(v, dtype=torch.float32, device=h_mm.device) \
            if bias is not None and ctx.needs_input_grad[4] else None
        for c0 in range(0, v, chunk):
            c1 = min(c0 + chunk, v)
            e_chunk = embedding[c0:c1].to(cdt)
            logits = _mm(h_mm, e_chunk.t())
            if bias is not None:
                logits = logits + bias[c0:c1].float()[None, :]
            dlogits = torch.exp(logits - lse[:, None]) * p_coef[:, None]
            idx = labels - c0
            inside = (idx >= 0) & (idx < c1 - c0)
            # minus the one-hot, without a host sync: rows whose label
            # lies in another chunk add 0 to a clamped column
            dlogits.scatter_add_(1, idx.clamp(0, c1 - c0 - 1)[:, None],
                                 torch.where(inside, -coef,
                                             torch.zeros_like(coef))[:, None])
            dl = dlogits.to(cdt)
            dh += _mm(dl, e_chunk)
            if de is not None:
                de[c0:c1] = _mm(dl.t().contiguous(), h_mm)
            if dbias is not None:
                dbias[c0:c1] = dlogits.sum(dim=0)
        dh = dh.to(ctx.h_dtype)
        if de is not None:
            de = de.to(embedding.dtype)
        if dbias is not None:
            dbias = dbias.to(bias.dtype)
        return dh, de, None, None, dbias, None, None, None


def chunked_cross_entropy(hidden, embedding, labels, *,
                          chunk_size: int = 8192, z_loss: float = 0.0,
                          mask=None, bias=None, compute_dtype=None):
    """Mean token cross-entropy of ``logits = hidden @ embedding.T`` (+
    ``bias``) without materialising the logits.

    hidden [B, L, D] or [T, D]; embedding [V, D]; labels [B, L] or [T];
    ``mask`` (shaped like labels, 0/1 or bool) weights the mean;
    ``z_loss`` adds z_loss * mean(lse^2); ``compute_dtype`` is the dtype of
    the logit products' operands (accumulation and all softmax math stay
    fp32; None keeps fp32). V need not be a multiple of ``chunk_size``.
    Returns the fp32 scalar loss; differentiable in hidden, embedding and
    bias."""
    if hidden.dim() == 3:
        t = hidden.shape[0] * hidden.shape[1]
        hidden = hidden.reshape(t, hidden.shape[2])
        labels = labels.reshape(t)
        if mask is not None:
            mask = mask.reshape(t)
    weights = None if mask is None else mask.to(torch.float32)
    chunk = min(chunk_size, embedding.shape[0])
    cdt = compute_dtype or torch.float32
    return _ChunkedCE.apply(hidden, embedding, labels.long(), weights, bias,
                            chunk, float(z_loss), cdt)


def full_cross_entropy(hidden, embedding, labels):
    """Reference O(T*V)-memory computation (tests / small vocab)."""
    if hidden.dim() == 3:
        t = hidden.shape[0] * hidden.shape[1]
        hidden = hidden.reshape(t, hidden.shape[2])
        labels = labels.reshape(t)
    logits = hidden.float() @ embedding.float().t()
    lse = torch.logsumexp(logits, dim=-1)
    lab = logits.gather(-1, labels.long()[:, None])[:, 0]
    return (lse - lab).mean()
