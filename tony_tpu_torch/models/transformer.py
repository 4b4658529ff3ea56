"""Decoder-only transformer in PyTorch: the counterpart of
``tony_tpu/models/transformer.py``.

Parameters keep the JAX package's dtypes: the embedding (and an untied
``lm_head``), norm scales and ``pos_embedding`` stay fp32, dense layers
hold ``cfg.dtype`` (the JAX package stores them fp32 and casts them to
``cfg.dtype`` on every call, which gives the same values), and logits
are computed in fp32. ``models.convert.from_jax_params`` maps a JAX
param tree onto this module's ``state_dict``.

Decode runs over an explicit cache dict (``models.generate.init_cache``
or a page pool from ``serve.slots``), updated IN PLACE — the JAX
package returns a new cache tree; here the buffers are written where
they lie, which saves a cache-sized copy per step. The three cache
modes of ``_decode_attention`` are ported: the scalar index, per-slot
positions ``[b]`` / ``[b, l]``, and paged tables with sentinel entries.
Writes that the JAX package drops (negative positions, positions past
the buffer, sentinel pages) never reach a live address: every index
write covers the whole window, and a dropped entry lands on a page
pool's junk page or rewrites the bytes its address ends up holding
anyway (``WritePlan``). No write takes a host sync.

The training forward takes ``segment_ids`` and three attention
backends: ``pallas`` hands q and the grouped (unrepeated) K/V to
``ops.attention.flash_attention`` (the CUDA kernels on the GPU);
``blockwise``, the JAX default, runs
``parallel.ring_attention.blockwise_attention`` (a loop over key blocks
of ``attention_block_size`` with an online softmax, which never holds
the [L, L] scores) and ``reference`` runs ``reference_attention``, each
over K/V repeated to every query head. ``remat`` ports the three
policies of the JAX ``Block`` with ``torch.utils.checkpoint``:
``nothing`` recomputes the whole block, ``dots`` keeps matmul outputs
(selective checkpointing), ``attn_saved`` recomputes only the FFN, its
dots kept, so the flash forward never runs twice. Recomputation repeats the same operations, so
remat changes no bit of the loss or the gradients.

``quantized`` (int8 weight-only, for generation and scoring) swaps
every projection for ``QuantDense``, which holds the int8 kernel and its
per-column scale as buffers and runs ``ops.quant.q8_matmul`` (the CUDA
kernel on the GPU); ``models.quantize.quantize_for_serving`` converts a
float model.

MoE (``moe_every``): every ``moe_every``-th block holds ``MoEMLP``
(named ``moe``, as the JAX ``Block`` names it) in place of the dense
MLP: an fp32 router and expert weights [E, ...] run by
``parallel.moe.moe_layer``; with ``cfg.quantized`` the experts are int8
buffers run by the expert-batched kernel. Each MoE block's
load-balancing loss goes into the ``losses`` list a caller passes to
``forward`` (the counterpart of flax's ``sow`` into ``"losses"``), and
``moe_aux_loss`` sums it; plain inference passes none.

``scan_layers`` is the JAX package's stacked layout (``_scan_blocks``):
one ``nn.Parameter`` per block leaf with a leading ``[n_layers]`` axis,
under ``layers.block.`` (the JAX ``layers/block/...``), and a cache whose
leaves carry the same axis (``cache["layers"]``, ``models.generate.
init_cache``). The forward takes each stacked leaf's slices once
(``torch.unbind``, whose backward is one ``stack``) and runs the same
``Block`` code over each layer's slices, passed down as ``p``; nothing
is swapped into a module, so replicas sharing a model on several
threads stay safe. Each layer's cache is a dict of views of the
stacked leaves, written in place. Remat is per layer, as the JAX
package remats the scan body (``attn_saved`` inside the block). The
JAX config refuses it with ``moe_every`` (uniform layers only), and so
does this one.

Left out, refused at config construction: ``shard_activations``/
``mesh`` (so ``QuantDense`` and the experts have no sharded form yet),
and the ring and ulysses attention backends.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from tony_tpu_torch.ops.attention import flash_attention
from tony_tpu_torch.ops.decode import flash_decode, quantize_kv
from tony_tpu_torch.ops.quant import q8_matmul
from tony_tpu_torch.parallel.moe import MoEConfig, moe_layer
from tony_tpu_torch.parallel.ring_attention import (blockwise_attention,
                                                   reference_attention)

NEG_INF = -1e30


@dataclass(frozen=True)
class RopeScaling:
    """Long-context RoPE frequency rescaling. kind="linear" divides
    every frequency by ``factor``; kind="llama3" is HF's Llama-3 rule
    (low frequencies divided by ``factor``, high ones kept, a smooth
    ramp between the two wavelength thresholds)."""

    kind: str = "llama3"  # llama3 | linear
    factor: float = 8.0
    low_freq_factor: float = 1.0
    high_freq_factor: float = 4.0
    original_max_len: int = 8192

    def apply(self, freq: torch.Tensor) -> torch.Tensor:
        if self.kind == "linear":
            return freq / self.factor
        if self.kind != "llama3":
            raise ValueError(f"unknown rope scaling kind {self.kind!r}")
        wavelen = 2.0 * math.pi / freq
        low_wl = self.original_max_len / self.low_freq_factor
        high_wl = self.original_max_len / self.high_freq_factor
        smooth = (self.original_max_len / wavelen - self.low_freq_factor) / (
            self.high_freq_factor - self.low_freq_factor)
        mid = (1.0 - smooth) * freq / self.factor + smooth * freq
        scaled = torch.where(wavelen > low_wl, freq / self.factor, mid)
        return torch.where(wavelen < high_wl, freq, scaled)


_BACKENDS = ("reference", "blockwise", "pallas")
_LATER_BACKENDS = ("ring", "ulysses")


@dataclass(frozen=True)
class TransformerConfig:
    """Field for field the JAX ``TransformerConfig`` (see its comments
    for each knob), with a torch ``dtype``."""

    vocab_size: int = 32_000
    d_model: int = 512
    n_heads: int = 8
    n_kv_heads: int | None = None
    n_layers: int = 6
    d_ff: int = 2048
    max_seq_len: int = 2048
    dtype: Any = torch.bfloat16
    attention_backend: str = "blockwise"
    attention_block_size: int = 512
    attention_block_k: int = 0
    remat: bool = False
    remat_policy: str = "nothing"
    mesh: Any = None
    norm: str = "rms"
    positional: str = "rope"
    use_bias: bool = False
    qkv_bias: bool = False
    sliding_window: int = 0
    activation: str = "gelu"
    norm_eps: float = 1e-6
    rope_theta: float = 10_000.0
    rope_scaling: RopeScaling | None = None
    gated_mlp: bool = False
    explicit_head_dim: int = 0
    rotary_dims: int = 0
    parallel_residual: bool = False
    quantized: bool = False
    kv_cache_quant: bool = False
    decode_attention: str = "einsum"  # einsum | flash
    embed_scale: bool = False
    norm_unit_offset: bool = False
    tied_embeddings: bool = True
    lm_head_bias: bool = False
    moe_every: int = 0
    moe_num_experts: int = 8
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_gated: bool = False
    moe_renormalize: bool = False
    moe_dropless: bool = False
    moe_activation: str = "gelu"
    moe_d_ff: int = 0
    scan_layers: bool = False
    shard_activations: bool = False

    def __post_init__(self):
        if self.gated_mlp and self.moe_every:
            raise ValueError("gated_mlp is not implemented for MoE expert "
                             "FFNs; use moe_every with gated_mlp=False")
        if self.scan_layers and self.moe_every:
            raise ValueError("scan_layers needs uniform layers "
                             "(moe_every alternates block types)")
        if self.remat_policy not in ("nothing", "dots", "attn_saved"):
            raise ValueError(
                f"unknown remat_policy {self.remat_policy!r}; "
                "expected one of: nothing, dots, attn_saved")
        later = {
            "shard_activations": self.shard_activations,
            "mesh": self.mesh is not None,
            f"attention_backend={self.attention_backend!r}":
                self.attention_backend in _LATER_BACKENDS,
        }
        for name, on in later.items():
            if on:
                raise NotImplementedError(
                    f"{name} is not ported to PyTorch yet (see ROADMAP.md)")
        if self.attention_backend not in _BACKENDS:
            raise ValueError(
                f"unknown attention backend {self.attention_backend}")
        if self.decode_attention not in ("einsum", "flash"):
            raise ValueError(
                f"unknown decode_attention {self.decode_attention!r}")

    @property
    def head_dim(self) -> int:
        return self.explicit_head_dim or self.d_model // self.n_heads

    @property
    def kv_heads(self) -> int:
        kv = self.n_heads if self.n_kv_heads is None else self.n_kv_heads
        if kv <= 0 or self.n_heads % kv:
            raise ValueError(
                f"n_kv_heads={kv} must be positive and divide "
                f"n_heads={self.n_heads}")
        return kv


def rotary_embedding(x, positions, theta: float = 10_000.0,
                     scaling: RopeScaling | None = None,
                     rotary_dims: int = 0):
    """RoPE over the head dim of ``x`` [B, L, H, D], half-split
    convention (HF Llama's rotate_half). ``positions`` is [L] (shared)
    or [B, L] (per row). ``rotary_dims`` < D rotates only the leading
    slice. Frequencies and angles are fp32."""
    d = x.shape[-1]
    if rotary_dims and rotary_dims < d:
        rotated = rotary_embedding(x[..., :rotary_dims], positions, theta,
                                   scaling)
        return torch.cat([rotated, x[..., rotary_dims:]], dim=-1)
    half = d // 2
    exps = torch.arange(0, half, dtype=torch.float32,
                        device=x.device) / half
    freq = 1.0 / (theta ** exps)
    if scaling is not None:
        freq = scaling.apply(freq)
    angles = positions[..., None].to(torch.float32) * freq
    if angles.dim() == 3:  # per-row positions [B, L, half]
        cos = torch.cos(angles)[:, :, None, :]
        sin = torch.sin(angles)[:, :, None, :]
    else:  # shared positions [L, half]
        cos = torch.cos(angles)[None, :, None, :]
        sin = torch.sin(angles)[None, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


class RMSNorm(nn.Module):
    def __init__(self, d: int, dtype=torch.bfloat16, eps: float = 1e-6,
                 unit_offset: bool = False, device=None):
        super().__init__()
        init = torch.zeros if unit_offset else torch.ones
        self.scale = nn.Parameter(init(d, dtype=torch.float32,
                                       device=device))
        self.dtype, self.eps, self.unit_offset = dtype, eps, unit_offset

    def forward(self, x, p=None):
        """``p`` (a scanned layer's slices, ``{"scale": ...}``) stands in
        for the module's own parameter."""
        scale = self.scale if p is None else p["scale"]
        x32 = x.float()
        norm = x32 * torch.rsqrt((x32 * x32).mean(-1, keepdim=True)
                                 + self.eps)
        mult = 1.0 + scale if self.unit_offset else scale
        return (norm * mult).to(self.dtype)


class LayerNorm(nn.Module):
    """Mean-subtracting norm with bias (GPT-2 family); fp32 math."""

    def __init__(self, d: int, dtype=torch.bfloat16, eps: float = 1e-5,
                 device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(d, dtype=torch.float32,
                                             device=device))
        self.bias = nn.Parameter(torch.zeros(d, dtype=torch.float32,
                                             device=device))
        self.dtype, self.eps = dtype, eps

    def forward(self, x, p=None):
        scale, bias = (self.scale, self.bias) if p is None \
            else (p["scale"], p["bias"])
        x32 = x.float()
        mu = x32.mean(-1, keepdim=True)
        var = ((x32 - mu) ** 2).mean(-1, keepdim=True)
        return (((x32 - mu) * torch.rsqrt(var + self.eps)) * scale
                + bias).to(self.dtype)


def make_norm(cfg: TransformerConfig, device=None) -> nn.Module:
    if cfg.norm == "layer":
        if cfg.norm_unit_offset:
            raise ValueError("norm_unit_offset is an RMSNorm (Gemma) knob")
        return LayerNorm(cfg.d_model, cfg.dtype, cfg.norm_eps, device)
    if cfg.norm == "rms":
        return RMSNorm(cfg.d_model, cfg.dtype, cfg.norm_eps,
                       cfg.norm_unit_offset, device)
    raise ValueError(f"unknown norm {cfg.norm}")


def _activation(cfg: TransformerConfig):
    if cfg.activation == "gelu":
        return F.gelu
    if cfg.activation == "gelu_tanh":
        return lambda x: F.gelu(x, approximate="tanh")
    if cfg.activation == "silu":
        return F.silu
    raise ValueError(f"unknown activation {cfg.activation}")


class Dense(nn.Linear):
    """``nn.Linear`` that computes in ``cfg.dtype``, casting its input and
    (when a trainer holds them in another compute dtype) its weights to
    that dtype first, as flax's Dense does."""

    def __init__(self, *args, dtype=None, **kw):
        super().__init__(*args, dtype=dtype, **kw)
        self.compute_dtype = dtype or torch.get_default_dtype()

    def forward(self, x, p=None):
        """``p`` (a scanned layer's slices, ``{"weight", "bias"?}``)
        stands in for the module's own parameters."""
        dt = self.compute_dtype
        w, b = (self.weight, self.bias) if p is None \
            else (p["weight"], p.get("bias"))
        if w.dtype != dt:
            w = w.to(dt)
        if b is not None and b.dtype != dt:
            b = b.to(dt)
        return F.linear(x.to(dt), w, b)


class QuantDense(nn.Module):
    """int8 weight-only projection (``cfg.quantized``), the counterpart
    of the JAX ``QuantDense``: buffers ``kernel_q8`` int8 [in, out] (the
    JAX layout, so the kernel reads rows of ``out`` coalesced),
    ``scale`` fp32 [out] and, where the float layer had one, an fp32
    ``bias``. Their dtypes do not follow ``cfg.dtype``, so one quantized
    ``state_dict`` loads into a config of any compute dtype. They are
    buffers, not parameters: int8 weights have no useful gradients.
    ``models.quantize`` fills them."""

    def __init__(self, in_features: int, out_features: int, bias: bool,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.compute_dtype = dtype
        self.register_buffer("kernel_q8", torch.zeros(
            in_features, out_features, dtype=torch.int8, device=device))
        self.register_buffer("scale", torch.ones(
            out_features, dtype=torch.float32, device=device))
        if bias:
            self.register_buffer("bias", torch.zeros(
                out_features, dtype=torch.float32, device=device))
        else:
            self.bias = None

    def forward(self, x, p=None):
        # ``p`` is never given: int8 models refuse scan_layers
        dt = self.compute_dtype
        in_f, out_f = self.kernel_q8.shape
        x2 = x.reshape(-1, in_f).to(dt).contiguous()
        y = q8_matmul(x2, self.kernel_q8, self.scale)
        y = y.reshape(*x.shape[:-1], out_f)
        if self.bias is not None:
            y = y + self.bias.to(dt)
        return y


def _sub(p, name: str):
    """The entry ``name`` of a scanned layer's nested slices, or None
    (the module's own parameters)."""
    return None if p is None else p[name]


def _dense(cfg: TransformerConfig, in_features: int, out_features: int,
           bias: bool, device=None) -> nn.Module:
    if cfg.quantized:
        return QuantDense(in_features, out_features, bias, cfg.dtype,
                          device)
    return Dense(in_features, out_features, bias=bias, dtype=cfg.dtype,
                 device=device)


@dataclass
class WritePlan:
    """Where a decode window's K/V land: index tensors over all ``b x l``
    entries, built once per forward with no host sync and no shape that
    depends on the data, so a forward can be captured in a CUDA graph.
    Entries the JAX package drops still write, each to an address whose
    final value no kept entry of the same call changes (``put``).

    Paged (``page``, ``off`` [b, l]): a dropped entry writes to the
    pool's junk page, its last (``serve.slots.paged_cache`` adds it),
    which no table entry names and so no kept entry writes.

    Per-slot (``rows``, ``pos``, ``src`` [b, l], ``keep`` [b, 1]): entry
    (i, j) writes token ``src[i, j]``'s value at ``pos[i, j]``. A dropped
    entry in a row with a kept entry writes that entry's value to that
    entry's address, so the two write the same bytes; in a row with
    none (``keep``) every entry writes back the value at position 0 of
    its own row. In a one-token window an entry is its row's only one,
    so ``src`` is None: every entry writes its own token.

    ``reads`` (one-token windows): each row's visible cache length,
    ``max(pos + 1, 0)`` as int32, for flash-decode; made once a forward
    rather than once a layer."""

    page: torch.Tensor | None = None
    off: torch.Tensor | None = None
    rows: torch.Tensor | None = None
    pos: torch.Tensor | None = None
    src: torch.Tensor | None = None
    keep: torch.Tensor | None = None
    reads: torch.Tensor | None = None

    def put(self, buf: torch.Tensor, val: torch.Tensor) -> None:
        """Write ``val`` [b, l, ...] into ``buf`` in place."""
        if self.page is not None:
            buf[self.page, self.off] = val
            return
        new = val if self.src is None else val[self.rows, self.src]
        old = buf[self.rows, self.pos]
        keep = self.keep.view(*self.keep.shape, *[1] * (new.dim() - 2))
        buf[self.rows, self.pos] = torch.where(keep, old, new)


def write_plan(pos2d, page_table=None, junk_page: int = 0,
               page_size: int = 0, buf_len: int = 0) -> WritePlan:
    """The forward's ``WritePlan``. Dropped, as in the JAX package:
    negative positions (padding, empty or frozen slots), positions past
    the table's span or the buffer, and table entries at or past
    ``junk_page`` (the unallocated sentinels)."""
    b, l = pos2d.shape
    zero = torch.zeros_like(pos2d)
    reads = torch.clamp(pos2d[:, 0] + 1, min=0).to(torch.int32) \
        if l == 1 else None
    if page_table is not None:
        span = page_table.shape[1] * page_size
        valid = (pos2d >= 0) & (pos2d < span)
        safe = torch.where(valid, pos2d, zero)
        page = torch.gather(page_table, 1, safe // page_size)
        valid = valid & (page < junk_page)
        page = torch.where(valid, page, torch.full_like(page, junk_page))
        return WritePlan(page=page, off=safe % page_size, reads=reads)
    valid = (pos2d >= 0) & (pos2d < buf_len)
    rows = torch.arange(b, device=pos2d.device)[:, None].expand(b, l)
    if l == 1:
        return WritePlan(rows=rows, pos=torch.where(valid, pos2d, zero),
                         keep=~valid, reads=reads)
    kept = valid.any(dim=1, keepdim=True)
    first = torch.argmax(valid.to(torch.int32), dim=1, keepdim=True)
    to = torch.where(kept, torch.gather(pos2d, 1, first), zero[:, :1])
    toks = torch.arange(l, device=pos2d.device).expand(b, l)
    return WritePlan(rows=rows, pos=torch.where(valid, pos2d, to),
                     src=torch.where(valid, toks, first), keep=~kept,
                     reads=reads)


class Attention(nn.Module):
    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        self.cfg = cfg
        h, kvh, dh, d = cfg.n_heads, cfg.kv_heads, cfg.head_dim, cfg.d_model
        qkv_bias = cfg.use_bias or cfg.qkv_bias
        # q's output and o's input flatten [heads, head_dim] head-major,
        # as the .view(b, l, h, dh) below and the JAX kernels do
        self.q = _dense(cfg, d, h * dh, qkv_bias, device)
        self.k = _dense(cfg, d, kvh * dh, qkv_bias, device)
        self.v = _dense(cfg, d, kvh * dh, qkv_bias, device)
        self.o = _dense(cfg, h * dh, d, cfg.use_bias, device)

    def forward(self, x, decode: bool = False, segment_ids=None,
                positions=None, page_table=None, cache=None, plan=None,
                p=None):
        cfg = self.cfg
        b, l, _ = x.shape
        q = self.q(x, _sub(p, "q")).view(b, l, cfg.n_heads, cfg.head_dim)
        k = self.k(x, _sub(p, "k")).view(b, l, cfg.kv_heads, cfg.head_dim)
        v = self.v(x, _sub(p, "v")).view(b, l, cfg.kv_heads, cfg.head_dim)
        if decode:
            out = self._decode_attention(q, k, v, cache, positions,
                                         page_table, plan)
        else:
            if cfg.positional == "rope":
                pos = torch.arange(l, device=x.device)
                q = rotary_embedding(q, pos, cfg.rope_theta,
                                     cfg.rope_scaling, cfg.rotary_dims)
                k = rotary_embedding(k, pos, cfg.rope_theta,
                                     cfg.rope_scaling, cfg.rotary_dims)
            if cfg.attention_backend == "pallas":
                # grouped K/V go to the kernels as they are
                out = flash_attention(
                    q, k, v, causal=True,
                    block_q=cfg.attention_block_size,
                    block_k=cfg.attention_block_k
                    or cfg.attention_block_size,
                    window=cfg.sliding_window, segment_ids=segment_ids)
            else:
                if cfg.kv_heads != cfg.n_heads:
                    group = cfg.n_heads // cfg.kv_heads
                    k = k.repeat_interleave(group, dim=2)
                    v = v.repeat_interleave(group, dim=2)
                if cfg.attention_backend == "blockwise":
                    out = blockwise_attention(
                        q, k, v, block_size=cfg.attention_block_size,
                        causal=True, window=cfg.sliding_window,
                        segment_ids=segment_ids)
                else:
                    out = reference_attention(q, k, v, causal=True,
                                              window=cfg.sliding_window,
                                              segment_ids=segment_ids)
        return self.o(out.reshape(b, l, -1), _sub(p, "o"))

    def _decode_attention(self, q, k, v, cache: dict, positions=None,
                          page_table=None, plan: WritePlan | None = None):
        """Incremental attention over the layer's cache dict, written in
        place. Modes as in the JAX ``Attention._decode_attention``:
        scalar ``cache_index`` (all rows in lockstep), per-slot
        ``positions`` [b] or [b, l] (negative = nothing written, nothing
        visible), and ``page_table`` [b, cols] over page pools
        ``[n_pages + 1, page_size, kvh, dh]`` (the last is the junk
        page; each row attends over the gather of its own pages;
        sentinel entries clamp on the gather). ``plan`` is the forward's
        ``write_plan`` (per-slot and paged modes)."""
        cfg = self.cfg
        b, l, h, dh = q.shape
        kvh = cfg.kv_heads
        group = h // kvh
        quant = cfg.kv_cache_quant
        per_slot = positions is not None
        paged = page_table is not None
        if paged and not per_slot:
            raise ValueError("page_table requires per-slot positions")
        if per_slot:
            if positions.dim() == 1:
                if l != 1:
                    raise ValueError(
                        "per-slot decode with positions=[b] is a "
                        "single-token step; got l=%d (pass [b, l] "
                        "positions for a multi-token window)" % l)
                pos2d = positions[:, None]
            elif tuple(positions.shape) == (b, l):
                pos2d = positions
            else:
                raise ValueError(
                    f"positions shape {tuple(positions.shape)} does not "
                    f"match the token window ({b}, {l})")
        cur = cache["cache_index"]
        if cfg.positional == "rope":
            rope_pos = pos2d if per_slot else \
                cur + torch.arange(l, device=q.device)
            q = rotary_embedding(q, rope_pos, cfg.rope_theta,
                                 cfg.rope_scaling, cfg.rotary_dims)
            k = rotary_embedding(k, rope_pos, cfg.rope_theta,
                                 cfg.rope_scaling, cfg.rotary_dims)
        if quant:
            k, k_sc = quantize_kv(k)  # quantize-on-write, after RoPE
            v, v_sc = quantize_kv(v)
        ck, cv = cache["cached_key"], cache["cached_value"]
        ks = cache.get("cached_key_scale")
        vs = cache.get("cached_value_scale")
        if per_slot:
            plan.put(ck, k)
            plan.put(cv, v)
            if quant:
                plan.put(ks, k_sc)
                plan.put(vs, v_sc)
        if paged:
            n_pages, ps = ck.shape[0], ck.shape[1]
            span = page_table.shape[1] * ps
            tab = torch.clamp(page_table, 0, n_pages - 1)
            keys = ck[tab].reshape(b, span, kvh, dh)
            values = cv[tab].reshape(b, span, kvh, dh)
            if quant:
                ksc = ks[tab].reshape(b, span, kvh)
                vsc = vs[tab].reshape(b, span, kvh)
        elif per_slot:
            keys, values = ck, cv
            if quant:
                ksc, vsc = ks, vs
        else:
            if cur + l > ck.shape[1]:
                raise ValueError(
                    f"cache overflow: index {cur} + {l} tokens exceeds "
                    f"the cache's {ck.shape[1]} positions")
            ck[:, cur:cur + l] = k
            cv[:, cur:cur + l] = v
            if quant:
                ks[:, cur:cur + l] = k_sc
                vs[:, cur:cur + l] = v_sc
            cache["cache_index"] = cur + l
            keys, values = ck, cv
            if quant:
                ksc, vsc = ks, vs
        if per_slot:
            q_pos = pos2d
        else:
            q_pos = (cur + torch.arange(l, device=q.device))[None, :]
        win = cfg.sliding_window
        if l == 1 and cfg.decode_attention == "flash":
            # the decode hot loop: the hand-written kernel over the
            # (possibly int8) cache; it masks length/window itself, and
            # a length-0 row (empty or frozen slot) gives exact zeros
            length = plan.reads if per_slot else cur + 1
            out = flash_decode(q[:, 0].contiguous(), keys, values, length,
                               window=win,
                               k_scale=ksc if quant else None,
                               v_scale=vsc if quant else None)
            return out[:, None].to(q.dtype)
        max_len = cfg.max_seq_len
        if not per_slot and win > 0 and win + l <= max_len:
            # windowed scalar decode: attend over a (window + l) slice
            # ending at the newest token instead of the whole buffer
            span = win + l
            start = min(max(cur + l - span, 0), max_len - span)
            keys_att = keys[:, start:start + span]
            values_att = values[:, start:start + span]
            if quant:
                ks_att = ksc[:, start:start + span]
                vs_att = vsc[:, start:start + span]
            kv_pos = start + torch.arange(span, device=q.device)
        else:
            keys_att, values_att = keys, values
            if quant:
                ks_att, vs_att = ksc, vsc
            kv_pos = torch.arange(keys.shape[1], device=q.device)
        # grouped attention: q [b, l, kvh, group, dh] against kv
        # [b, m, kvh, dh]; int8 magnitudes are exact in fp32
        qg = q.float().reshape(b, l, kvh, group, dh)
        s = torch.einsum("bqhgd,bkhd->bhgqk", qg,
                         keys_att.float()) / math.sqrt(dh)
        if quant:
            # the per-(pos, head) scale distributes over the
            # d-contraction: fold it onto the scores
            s = s * ks_att.permute(0, 2, 1)[:, :, None, None, :]
        visible = kv_pos[None, None, :] <= q_pos[:, :, None]
        if win > 0:
            visible = visible & (q_pos[:, :, None] - kv_pos[None, None, :]
                                 < win)
        s = torch.where(visible[:, None, None, :, :], s,
                        torch.full_like(s, NEG_INF))
        p = torch.softmax(s, dim=-1)
        if quant:
            p = p * vs_att.permute(0, 2, 1)[:, :, None, None, :]
        out = torch.einsum("bhgqk,bkhd->bqhgd", p, values_att.float())
        return out.reshape(b, l, h, dh).to(q.dtype)


class MLP(nn.Module):
    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        self.cfg = cfg
        d, f, bias = cfg.d_model, cfg.d_ff, cfg.use_bias
        if cfg.gated_mlp:
            self.wg = _dense(cfg, d, f, bias, device)
        self.wi = _dense(cfg, d, f, bias, device)
        self.wo = _dense(cfg, f, d, bias, device)
        self.act = _activation(cfg)

    def forward(self, x, p=None):
        if self.cfg.gated_mlp:
            h = self.act(self.wg(x, _sub(p, "wg"))) * self.wi(x, _sub(p, "wi"))
        else:
            h = self.act(self.wi(x, _sub(p, "wi")))
        return self.wo(h, _sub(p, "wo"))


class MoEMLP(nn.Module):
    """The expert FFN (``moe_every``), the counterpart of the JAX
    ``MoEMLP``: ``router`` [D, E] fp32 (routing in bf16 flips top-k
    choices), experts ``wi``/``wg`` [E, D, F] and ``wo`` [E, F, D] held
    in ``cfg.dtype`` (the JAX package stores them fp32 and casts them on
    every call, which gives the same values), F = ``moe_d_ff`` or
    ``d_ff``. With ``cfg.quantized`` the experts are buffers ``wi_q8``
    int8 with ``wi_scale`` fp32 [E, F] (and so on), per (expert, output
    column), filled by ``models.quantize``. ``forward`` returns the
    output in ``cfg.dtype`` and the fp32 load-balancing loss."""

    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        self.cfg = cfg
        e, d = cfg.moe_num_experts, cfg.d_model
        f = cfg.moe_d_ff or cfg.d_ff
        self.moe_cfg = MoEConfig(
            num_experts=e, capacity_factor=cfg.moe_capacity_factor,
            top_k=cfg.moe_top_k, d_model=d, d_ff=f, gated=cfg.moe_gated,
            activation=cfg.moe_activation,
            renormalize_top_k=cfg.moe_renormalize,
            dropless=cfg.moe_dropless, mesh=cfg.mesh)
        self.router = nn.Parameter(torch.empty(d, e, dtype=torch.float32,
                                               device=device))
        self.names = ("wi", "wg", "wo") if cfg.moe_gated else ("wi", "wo")
        for nm in self.names:
            shp = (e, f, d) if nm == "wo" else (e, d, f)
            if cfg.quantized:
                self.register_buffer(nm + "_q8", torch.zeros(
                    shp, dtype=torch.int8, device=device))
                self.register_buffer(nm + "_scale", torch.ones(
                    shp[0], shp[2], dtype=torch.float32, device=device))
            else:
                setattr(self, nm, nn.Parameter(torch.empty(
                    shp, dtype=cfg.dtype, device=device)))

    def forward(self, x):
        cfg = self.cfg
        params = {"router": self.router}
        for nm in self.names:
            if cfg.quantized:
                params[nm + "_q8"] = getattr(self, nm + "_q8")
                params[nm + "_scale"] = getattr(self, nm + "_scale")
            else:
                w = getattr(self, nm)
                params[nm] = w if w.dtype == cfg.dtype else w.to(cfg.dtype)
        out, aux = moe_layer(params, x, self.moe_cfg)
        return out.to(cfg.dtype), aux.float()


class Block(nn.Module):
    def __init__(self, cfg: TransformerConfig, device=None,
                 use_moe: bool = False):
        super().__init__()
        self.cfg = cfg
        self.use_moe = use_moe
        self.ln1 = make_norm(cfg, device)
        self.attn = Attention(cfg, device)
        self.ln2 = make_norm(cfg, device)
        if use_moe:
            self.moe = MoEMLP(cfg, device)
        else:
            self.mlp = MLP(cfg, device)

    def forward(self, x, decode: bool = False, segment_ids=None,
                positions=None, page_table=None, cache=None, plan=None,
                losses: list | None = None, p=None):
        """The block's output; an MoE block appends its load-balancing
        loss to ``losses`` when given. Under remat the loss is an output
        of the recomputed function and is appended here, once: the
        recomputation in the backward appends nothing. ``p`` (a scanned
        layer's slices, nested as the block's submodules) stands in for
        the block's own parameters; the recomputation reads the same
        slices."""
        cfg = self.cfg
        if cfg.remat and not decode and torch.is_grad_enabled() \
                and cfg.remat_policy != "attn_saved":
            kw = {} if cfg.remat_policy == "nothing" \
                else {"context_fn": _keep_dots}
            # no module draws randomness (no dropout): nothing to stash,
            # and stashing reads the CUDA generator, which a graph
            # capture refuses
            x, aux = checkpoint(self._forward, x, False, segment_ids,
                                None, None, None, None, p,
                                use_reentrant=False,
                                preserve_rng_state=False, **kw)
        else:
            x, aux = self._forward(x, decode, segment_ids, positions,
                                   page_table, cache, plan, p)
        if aux is not None and losses is not None:
            losses.append(aux)
        return x

    def _ffn_call(self, x, p=None):
        if self.use_moe:
            return self.moe(x)
        return self.mlp(x, _sub(p, "mlp")), None

    def _ffn(self, x, decode: bool, p=None):
        cfg = self.cfg
        if cfg.remat and not decode and torch.is_grad_enabled() \
                and cfg.remat_policy == "attn_saved":
            # attention stays outside the recomputation (its kernels'
            # saved tensors are kept); only the FFN is recomputed, its
            # dot outputs kept
            return checkpoint(self._ffn_call, x, p, use_reentrant=False,
                              preserve_rng_state=False,
                              context_fn=_keep_dots)
        return self._ffn_call(x, p)

    def _forward(self, x, decode: bool = False, segment_ids=None,
                 positions=None, page_table=None, cache=None, plan=None,
                 p=None):
        """(output, the MoE loss or None)."""
        attn_out = self.attn(self.ln1(x, _sub(p, "ln1")), decode=decode,
                             segment_ids=segment_ids, positions=positions,
                             page_table=page_table, cache=cache, plan=plan,
                             p=_sub(p, "attn"))
        if self.cfg.parallel_residual:
            ffn, aux = self._ffn(self.ln2(x, _sub(p, "ln2")), decode, p)
            return x + attn_out + ffn, aux
        x = x + attn_out
        ffn, aux = self._ffn(self.ln2(x, _sub(p, "ln2")), decode, p)
        return x + ffn, aux


_DOTS = {torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
         torch.ops.aten.bmm.default, torch.ops.aten.baddbmm.default,
         torch.ops.aten.linear.default, torch.ops.aten.matmul.default}


def _dots_saveable(ctx, op, *args, **kwargs):
    """``jax.checkpoint_policies.dots_saveable``: keep the outputs of
    matrix products, recompute everything else."""
    return CheckpointPolicy.MUST_SAVE if op in _DOTS \
        else CheckpointPolicy.PREFER_RECOMPUTE


def _keep_dots():
    return create_selective_checkpoint_contexts(_dots_saveable)


class ScannedBlocks(nn.Module):
    """``scan_layers``' stack: ``block``, a ``Block`` whose every
    parameter is one ``nn.Parameter`` ``[n_layers, *shape]`` (the JAX
    ``layers/block/...`` leaves), so the state_dict reads
    ``layers.block.attn.q.weight`` [n_layers, out, in]. The block's
    code runs once a layer over that layer's slices (``layer_params``);
    its own parameters are never used as they are."""

    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        self.block = Block(cfg, device="meta")
        self.names = [n for n, _ in self.block.named_parameters()]
        for name, p in list(self.block.named_parameters()):
            mod, _, leaf = name.rpartition(".")
            setattr(self.block.get_submodule(mod), leaf, nn.Parameter(
                torch.empty((cfg.n_layers, *p.shape), dtype=p.dtype,
                            device=device)))

    def layer_params(self) -> list[dict]:
        """Each layer's parameters as nested dicts of slices of the
        stacked leaves, taken once (``torch.unbind``: its backward is
        one ``stack``, where indexing would add a full-size zero tensor
        a layer). A leaf is read by attribute, so a module that computes
        its weight (``train.lora``'s merged projection) gives the
        computed one."""
        out = [{} for _ in range(self.block.cfg.n_layers)]
        for name in self.names:
            node = self.block
            for part in name.split("."):
                node = getattr(node, part)
            *mods, leaf = name.split(".")
            for layer, t in zip(out, node.unbind(0)):
                for m in mods:
                    layer = layer.setdefault(m, {})
                layer[leaf] = t
        return out


def layer_caches(cache: dict, n_layers: int) -> list[dict]:
    """Each layer's cache dict: ``cache["block_i"]`` as it is, or for a
    scanned cache (``cache["layers"]``, leaves ``[n_layers, ...]``) a
    dict of each leaf's layer slice, views written in place, with the
    stack's ``cache_index``."""
    if "layers" not in cache:
        return [cache[f"block_{i}"] for i in range(n_layers)]
    stack = cache["layers"]
    views = [{"cache_index": stack["cache_index"]} for _ in range(n_layers)]
    for name, leaf in stack.items():
        if isinstance(leaf, torch.Tensor):
            for view, t in zip(views, leaf.unbind(0)):
                view[name] = t
    return views


class Transformer(nn.Module):
    """The decoder stack. ``forward(tokens)`` is the full causal pass;
    ``forward(tokens, decode=True, cache=...)`` runs through a KV cache
    (see ``Attention._decode_attention``). ``device`` defaults to
    ``cuda``, which must exist; pass ``device="cpu"`` for the CPU."""

    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        from tony_tpu_torch.ops.platform import resolve_device

        device = resolve_device(device)
        self.cfg = cfg
        f32 = dict(dtype=torch.float32, device=device)
        self.embedding = nn.Parameter(
            torch.empty(cfg.vocab_size, cfg.d_model, **f32))
        if cfg.positional == "learned":
            self.pos_embedding = nn.Parameter(
                torch.empty(cfg.max_seq_len, cfg.d_model, **f32))
        elif cfg.positional != "rope":
            raise ValueError(f"unknown positional {cfg.positional!r}")
        every = cfg.moe_every
        if cfg.scan_layers:
            self.layers = ScannedBlocks(cfg, device)
        else:
            self.blocks = nn.ModuleList(
                Block(cfg, device,
                      use_moe=every > 0 and (i + 1) % every == 0)
                for i in range(cfg.n_layers))
        self.ln_f = make_norm(cfg, device)
        if not cfg.tied_embeddings:
            self.lm_head = nn.Parameter(
                torch.empty(cfg.vocab_size, cfg.d_model, **f32))
        if cfg.lm_head_bias:
            self.lm_head_bias = nn.Parameter(
                torch.zeros(cfg.vocab_size, **f32))
        # generate's captured decode steps (models.graphs.GraphCache),
        # made at first use on the card
        self.graphs = None

    @property
    def device(self) -> torch.device:
        return self.embedding.device

    def init_weights(self, generator: torch.Generator) -> "Transformer":
        """Seeded random weights: N(0, 0.02) for embeddings and dense
        kernels (the JAX initializer), zero biases, unit norm scales."""
        with torch.no_grad():
            for name, p in self.named_parameters():
                leaf = name.rsplit(".", 1)[-1]
                if leaf == "bias" or name == "lm_head_bias":
                    p.zero_()
                elif leaf == "scale":
                    p.fill_(0.0 if self.cfg.norm_unit_offset else 1.0)
                else:
                    p.normal_(0.0, 0.02, generator=generator)
        return self

    def _learned_positions(self, l: int, decode: bool, positions=None,
                           cache=None):
        cfg = self.cfg
        if decode and positions is not None:
            rows = torch.clamp(positions, 0, cfg.max_seq_len - 1)
            emb = self.pos_embedding[rows]
            if positions.dim() == 1:
                emb = emb[:, None]
            return emb.to(cfg.dtype)
        start = 0
        if decode:
            start = cache["pos_index"]
            cache["pos_index"] = start + l
        pos = torch.arange(start, start + l, device=self.device)
        return self.pos_embedding[pos][None].to(cfg.dtype)

    def forward(self, tokens, decode: bool = False,
                return_hidden: bool = False, segment_ids=None,
                positions=None, page_table=None, cache: dict | None = None,
                losses: list | None = None):
        """Logits [B, L, V] in fp32 (or the final [B, L, D] activations
        with ``return_hidden``). ``positions`` [B] or [B, L] and
        ``page_table`` [B, cols] select the per-slot and paged decode
        modes, as in the JAX ``Transformer.__call__``. ``losses``, a
        list, receives each MoE block's load-balancing loss (fp32
        scalars, in block order) for ``moe_aux_loss``."""
        if segment_ids is not None and decode:
            raise ValueError("segment_ids are a training-path feature; "
                             "decode has no segment notion")
        if positions is not None and not decode:
            raise ValueError("positions (per-slot decode) requires "
                             "decode=True")
        if page_table is not None and positions is None:
            raise ValueError("page_table (paged KV cache) requires "
                             "per-slot positions")
        if decode and cache is None:
            raise ValueError("decode=True needs a cache (init_cache)")
        cfg = self.cfg
        x = self.embedding[tokens].to(cfg.dtype)
        if cfg.embed_scale:
            x = x * torch.tensor(cfg.d_model ** 0.5, dtype=cfg.dtype)
        if cfg.positional == "learned":
            x = x + self._learned_positions(tokens.shape[1], decode,
                                            positions, cache)
        n = cfg.n_layers
        caches = layer_caches(cache, n) if decode else [None] * n
        plan = None
        if decode and positions is not None:
            pos2d = positions[:, None] if positions.dim() == 1 \
                else positions
            ck = caches[0]["cached_key"]
            if page_table is not None:
                plan = write_plan(pos2d, page_table, ck.shape[0] - 1,
                                  ck.shape[1])
            else:
                plan = write_plan(pos2d, buf_len=ck.shape[1])
        if cfg.scan_layers:
            blocks = [self.layers.block] * n
            params = self.layers.layer_params()
        else:
            blocks, params = self.blocks, [None] * n
        for block, layer_cache, p in zip(blocks, caches, params):
            x = block(x, decode, segment_ids=segment_ids,
                      positions=positions, page_table=page_table,
                      cache=layer_cache, plan=plan, losses=losses, p=p)
        if decode and cfg.scan_layers:
            # the scalar-index mode advanced each layer's view
            cache["layers"]["cache_index"] = caches[-1]["cache_index"]
        x = self.ln_f(x).float()
        return x if return_hidden else self.logits(x)

    def logits(self, hidden):
        """fp32 logits [..., V] of the final fp32 activations [..., D]
        (``forward(..., return_hidden=True)``): the LM head alone, for
        a caller that needs some rows' logits and not every row's."""
        head = self.embedding if self.cfg.tied_embeddings else self.lm_head
        logits = hidden @ head.float().t()
        if self.cfg.lm_head_bias:
            logits = logits + self.lm_head_bias
        return logits


def moe_aux_loss(losses, weight: float = 0.01) -> torch.Tensor:
    """``weight`` times the sum of the MoE load-balancing losses a
    forward appended to ``losses`` (fp32; 0 when there are none)."""
    if not losses:
        return torch.zeros((), dtype=torch.float32)
    return weight * sum(torch.sum(t) for t in losses)
