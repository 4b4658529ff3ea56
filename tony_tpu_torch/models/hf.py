"""Hugging Face checkpoint import for the port: the counterpart of
``tony_tpu/models/hf.py``, for every family the reference CLI takes
(GPT-2, Llama, Mistral, Qwen2, Gemma, Mixtral, GPT-NeoX, Phi).

Works from a checkpoint directory alone — ``config.json`` read as a
plain dict and the safetensors read by the small reader below, one
``model.safetensors`` or the shards that ``model.safetensors.index.json``
names — because the machine with the card has neither ``transformers``
nor ``safetensors``. Each family is a ``Family``: the tensor names (and
shapes) its checkpoints carry, and how they become the port's
``state_dict``. HF's ``nn.Linear`` weights are already the port's
``[out, in]`` layout, so most of it is renaming; GPT-2's ``Conv1D``
weights are ``[in, out]`` and transposed, its fused ``c_attn`` split
into q, k and v; GPT-NeoX's fused ``query_key_value`` is split per head
(``[h, 3, dh]``); Phi's one input norm fills both of the block's norms;
Mixtral's experts are transposed and stacked into ``[E, in, out]``.
Every importer is strict: a tensor it does not map raises (GPT-2's
reference importer reads the names it needs and ignores the rest; this
one refuses them too). ``load_hf_dir`` picks the family by
``model_type`` and reads tensors a layer at a time, so with
``int8=True`` a model whose float weights would not fit the card (or
the host) is quantized block by block on the host and only its int8
form lands on the card.
"""

from __future__ import annotations

import itertools
import json
import os
import struct
from dataclasses import dataclass
from typing import Callable

import torch

from tony_tpu_torch.models.transformer import (
    RopeScaling,
    Transformer,
    TransformerConfig,
)

_HF_ACTIVATIONS = {"gelu_new": "gelu_tanh", "gelu_pytorch_tanh": "gelu_tanh",
                   "gelu": "gelu", "silu": "silu", "swish": "silu"}


def _effective_sliding_window(hf: dict) -> int:
    """Sliding window in force: Mistral's ``sliding_window``; Qwen2's is
    gated behind ``use_sliding_window`` and ``max_window_layers`` (only
    all-layers or no-layers windows import exactly)."""
    win = hf.get("sliding_window")
    if not win:
        return 0
    if not hf.get("use_sliding_window", True):
        return 0
    gate = hf.get("max_window_layers", 0) or 0
    if gate >= hf["num_hidden_layers"]:
        return 0
    if gate > 0:
        raise ValueError(
            f"per-layer sliding-window gating (max_window_layers={gate} of "
            f"{hf['num_hidden_layers']}) is not supported; only "
            "all-layers or no-layers windows import exactly")
    return int(win)


def _rope_scaling(hf: dict) -> RopeScaling | None:
    """HF ``rope_scaling`` -> RopeScaling (llama3 / linear); unknown
    kinds are rejected rather than imported as plain RoPE."""
    rs = hf.get("rope_scaling")
    if not rs:
        return None
    kind = rs.get("rope_type", rs.get("type", ""))
    if kind == "default":
        return None
    if kind == "linear":
        return RopeScaling(kind="linear", factor=float(rs["factor"]))
    if kind == "llama3":
        return RopeScaling(
            kind="llama3",
            factor=float(rs["factor"]),
            low_freq_factor=float(rs["low_freq_factor"]),
            high_freq_factor=float(rs["high_freq_factor"]),
            original_max_len=int(rs["original_max_position_embeddings"]))
    raise ValueError(f"unsupported rope_scaling type {kind!r} "
                     "(supported: default, linear, llama3)")


def _activation(hf: dict, key: str, default: str, family: str = "") -> str:
    act = hf.get(key, default)
    if act not in _HF_ACTIVATIONS:
        what = f"{family} {key}" if family else key
        raise ValueError(f"unsupported {what} {act!r}" + (
            f"; supported: {sorted(_HF_ACTIVATIONS)}" if family else ""))
    return _HF_ACTIVATIONS[act]


def _rotary_dims(hf: dict, key: str, default: float) -> tuple[int, int]:
    """(head_dim, rotary width) for a partial-rotary family (NeoX's
    ``rotary_pct``, Phi's ``partial_rotary_factor``): the width must be
    even for the half-split rotation."""
    head_dim = hf["hidden_size"] // hf["num_attention_heads"]
    rotary = int(head_dim * hf.get(key, default))
    if rotary % 2:
        raise ValueError(f"{key} x head_dim = {rotary} is odd; partial "
                         "rotary needs an even rotary width")
    return head_dim, rotary


def gpt2_config(hf: dict, **overrides) -> TransformerConfig:
    """TransformerConfig for a GPT-2 ``config.json`` dict: LayerNorm with
    biases, learned positions (``n_positions`` of them, which caps
    ``max_seq_len``), biased dense layers, a tied head."""
    act = _activation(hf, "activation_function", "gelu_new", "GPT-2")
    kw = dict(
        vocab_size=hf["vocab_size"],
        d_model=hf["n_embd"],
        n_heads=hf["n_head"],
        n_layers=hf["n_layer"],
        d_ff=hf.get("n_inner") or 4 * hf["n_embd"],
        max_seq_len=hf["n_positions"],
        dtype=torch.float32,
        attention_backend="reference",
        norm="layer",
        positional="learned",
        use_bias=True,
        activation=act,
        norm_eps=hf.get("layer_norm_epsilon", 1e-5),
    )
    kw.update(overrides)
    return TransformerConfig(**kw)


def llama_config(hf: dict, **overrides) -> TransformerConfig:
    """TransformerConfig for a Llama-family ``config.json`` dict (Llama,
    Mistral's sliding window, Qwen2's q/k/v biases, Llama-3 rope
    scaling). Full attention_bias/mlp_bias variants are rejected. An
    ``activation`` override (``gemma_config``) replaces the reading of
    ``hidden_act``."""
    if hf.get("attention_bias", False) or hf.get("mlp_bias", False):
        raise ValueError("attention_bias/mlp_bias Llama variants are not "
                         "supported (only Qwen2-style qkv biases are)")
    act = overrides.pop("activation", None) \
        or _activation(hf, "hidden_act", "silu")
    kw = dict(
        vocab_size=hf["vocab_size"],
        d_model=hf["hidden_size"],
        n_heads=hf["num_attention_heads"],
        n_kv_heads=hf.get("num_key_value_heads"),
        n_layers=hf["num_hidden_layers"],
        d_ff=hf["intermediate_size"],
        max_seq_len=hf["max_position_embeddings"],
        dtype=torch.float32,
        attention_backend="reference",
        norm="rms",
        positional="rope",
        use_bias=False,
        qkv_bias=hf.get("model_type", "") == "qwen2",
        sliding_window=_effective_sliding_window(hf),
        activation=act,
        norm_eps=hf["rms_norm_eps"],
        rope_theta=hf.get("rope_theta", 10_000.0),
        rope_scaling=_rope_scaling(hf),
        gated_mlp=True,
        explicit_head_dim=hf.get("head_dim") or 0,
        tied_embeddings=hf.get("tie_word_embeddings", False),
    )
    kw.update(overrides)
    return TransformerConfig(**kw)


def gemma_config(hf: dict, **overrides) -> TransformerConfig:
    """TransformerConfig for a Gemma-1 ``config.json`` dict: Llama's
    layout with an explicit ``head_dim``, embeddings scaled by
    sqrt(hidden) in the activation dtype, RMSNorm as (1 + weight), tied
    embeddings (the default when the file omits it) and a gated gelu
    MLP. The activation is read as the reference reads it:
    ``hidden_act`` first, ``hidden_activation`` as the fallback. Gemma-2
    is another architecture and is refused."""
    kind = hf.get("model_type")
    if kind not in (None, "gemma"):
        raise ValueError(
            f"gemma_config got model_type {kind!r} (gemma2's "
            "softcapping/local-attention architecture is not this model)")
    act = hf.get("hidden_act") or hf.get("hidden_activation") \
        or "gelu_pytorch_tanh"
    if act not in _HF_ACTIVATIONS:
        raise ValueError(f"unsupported Gemma activation {act!r}")
    kw = dict(
        activation=_HF_ACTIVATIONS[act],
        qkv_bias=False,
        tied_embeddings=hf.get("tie_word_embeddings", True),
        explicit_head_dim=hf.get("head_dim", 0) or 0,
        embed_scale=True,
        norm_unit_offset=True,
    )
    kw.update(overrides)
    return llama_config(hf, **kw)


def mixtral_config(hf: dict, **overrides) -> TransformerConfig:
    """TransformerConfig for a Mixtral ``config.json`` dict: Mistral's
    attention with every dense MLP replaced by a top-k MoE of SwiGLU
    experts whose gates are renormalized over the chosen k
    (``moe_every=1``), evaluated dropless (exact, no capacity drops)."""
    act = _activation(hf, "hidden_act", "silu", "Mixtral")
    kw = dict(
        gated_mlp=False,  # no dense MLP anywhere; moe_every=1 covers all
        moe_every=1,
        moe_num_experts=hf["num_local_experts"],
        moe_top_k=hf["num_experts_per_tok"],
        moe_gated=True,
        moe_renormalize=True,
        moe_dropless=True,
        moe_activation=act,
        moe_d_ff=hf["intermediate_size"],
    )
    kw.update(overrides)
    return llama_config(hf, **kw)


def neox_config(hf: dict, **overrides) -> TransformerConfig:
    """TransformerConfig for a GPT-NeoX (Pythia) ``config.json`` dict:
    LayerNorm with biases, partial rotary (``rotary_pct`` of each head),
    biased dense layers, a 2-matmul gelu MLP and, where
    ``use_parallel_residual`` (the default), the parallel residual. A
    bias-free variant is refused: its checkpoint lacks tensors this
    importer maps."""
    act = _activation(hf, "hidden_act", "gelu", "GPT-NeoX")
    if not hf.get("attention_bias", True):
        raise ValueError("attention_bias=False GPT-NeoX variants are not "
                         "supported")
    head_dim, rotary = _rotary_dims(hf, "rotary_pct", 1.0)
    kw = dict(
        vocab_size=hf["vocab_size"],
        d_model=hf["hidden_size"],
        n_heads=hf["num_attention_heads"],
        n_layers=hf["num_hidden_layers"],
        d_ff=hf["intermediate_size"],
        max_seq_len=hf["max_position_embeddings"],
        dtype=torch.float32,
        attention_backend="reference",
        norm="layer",
        positional="rope",
        use_bias=True,
        activation=act,
        norm_eps=hf.get("layer_norm_eps", 1e-5),
        rope_theta=float(hf.get("rotary_emb_base", 10_000.0)),
        rope_scaling=_rope_scaling(hf),
        rotary_dims=0 if rotary >= head_dim else rotary,
        parallel_residual=hf.get("use_parallel_residual", True),
        tied_embeddings=hf.get("tie_word_embeddings", False),
    )
    kw.update(overrides)
    return TransformerConfig(**kw)


def phi_config(hf: dict, **overrides) -> TransformerConfig:
    """TransformerConfig for a Phi-1/1.5/2 ``config.json`` dict:
    LayerNorm, partial rotary (``partial_rotary_factor``), biased dense
    layers, the parallel residual with both branches reading one input
    norm (copied into ``ln2``) and an untied head with a bias. A tied
    variant is refused: tied logits would ignore the biased head."""
    act = _activation(hf, "hidden_act", "gelu_new", "Phi")
    head_dim, rotary = _rotary_dims(hf, "partial_rotary_factor", 0.5)
    if hf.get("tie_word_embeddings", False):
        raise ValueError("tie_word_embeddings=True Phi variants are not "
                         "supported (the importer emits an untied biased "
                         "lm_head; a tied model would silently ignore it)")
    kw = dict(
        vocab_size=hf["vocab_size"],
        d_model=hf["hidden_size"],
        n_heads=hf["num_attention_heads"],
        n_kv_heads=hf.get("num_key_value_heads"),
        n_layers=hf["num_hidden_layers"],
        d_ff=hf["intermediate_size"],
        max_seq_len=hf["max_position_embeddings"],
        dtype=torch.float32,
        attention_backend="reference",
        norm="layer",
        positional="rope",
        use_bias=True,
        activation=act,
        norm_eps=hf.get("layer_norm_eps", 1e-5),
        rope_theta=float(hf.get("rope_theta", 10_000.0)),
        rope_scaling=_rope_scaling(hf),
        rotary_dims=0 if rotary >= head_dim else rotary,
        parallel_residual=True,
        tied_embeddings=False,
        lm_head_bias=True,
    )
    kw.update(overrides)
    return TransformerConfig(**kw)


# ------------------------------------------------------------ families


@dataclass(frozen=True)
class Family:
    """How one family's checkpoint tensors map onto the port.

    ``shapes(cfg)``: every tensor the importer reads, by name without
    ``prefix``, with its shape. ``top(get, cfg)`` and ``layer(get, cfg,
    i)``: the port's ``state_dict`` entries outside the blocks and of
    block ``i``, each tensor read by ``get(name)``. A checkpoint may
    also carry ``head`` when the embeddings are tied (a duplicate of the
    embedding) and buffers whose names end in one of ``buffers``; any
    other tensor is refused."""

    name: str
    prefix: str
    shapes: Callable
    top: Callable
    layer: Callable
    head: str = ""
    buffers: tuple = ("inv_freq",)
    plain: str = ""

    def known(self, cfg: TransformerConfig) -> set:
        names = set(self.shapes(cfg))
        if cfg.tied_embeddings and self.head:
            names.add(self.head)
        return names

    def check_names(self, names, cfg: TransformerConfig) -> None:
        """Strict: a tensor the importer does not map means the
        checkpoint is not the architecture the config claims."""
        known = self.known(cfg)
        leftover = {k for k in names
                    if k not in known and not k.endswith(self.buffers)}
        if leftover:
            plain = self.plain or self.name
            raise ValueError(
                f"state_dict has tensors the {self.name} importer does not "
                f"map (not a plain-{plain} architecture?): "
                f"{sorted(leftover)[:8]}")

    def strip(self, name: str) -> str:
        return name.removeprefix(self.prefix)

    def parts(self, get, cfg: TransformerConfig):
        """The port's ``state_dict`` as one dict outside the blocks,
        then one a block, each read when the iteration reaches it."""
        return itertools.chain(
            [self.top(get, cfg)],
            (self.layer(get, cfg, i) for i in range(cfg.n_layers)))

    def convert(self, state_dict: dict, cfg: TransformerConfig) -> dict:
        """An in-memory ``state_dict`` under the checkpoint's names ->
        the port's ``state_dict`` (views where renaming is all)."""
        sd = {self.strip(k): v for k, v in state_dict.items()}
        self.check_names(sd, cfg)
        out: dict = {}
        for part in self.parts(sd.__getitem__, cfg):
            out.update(part)
        return out


def _dims(cfg: TransformerConfig):
    return (cfg.d_model, cfg.n_heads * cfg.head_dim,
            cfg.kv_heads * cfg.head_dim, cfg.d_ff, cfg.vocab_size)


def _norm_shapes(pre: str, d: int, bias: bool) -> dict:
    out = {pre + ".weight": (d,)}
    if bias:
        out[pre + ".bias"] = (d,)
    return out


def _linear_shapes(pre: str, out_f: int, in_f: int, bias: bool) -> dict:
    out = {pre + ".weight": (out_f, in_f)}
    if bias:
        out[pre + ".bias"] = (out_f,)
    return out


def _take(get, names: dict) -> dict:
    """``{port name: get(checkpoint name)}`` for ``names``, a map from
    checkpoint names to port names."""
    return {dst: get(src) for src, dst in names.items()}


# Llama, Mistral, Qwen2 and Gemma (Llama's layout), and Mixtral

def _llama_shapes(cfg: TransformerConfig) -> dict:
    d, hd, kvd, f, v = _dims(cfg)
    out = {"embed_tokens.weight": (v, d), "norm.weight": (d,)}
    if not cfg.tied_embeddings:
        out["lm_head.weight"] = (v, d)
    moe = cfg.moe_every > 0
    for i in range(cfg.n_layers):
        pre = f"layers.{i}."
        for name in ("input_layernorm", "post_attention_layernorm"):
            out.update(_norm_shapes(pre + name, d, False))
        for p, rows in (("q", hd), ("k", kvd), ("v", kvd)):
            out.update(_linear_shapes(f"{pre}self_attn.{p}_proj", rows, d,
                                      cfg.qkv_bias))
        out[pre + "self_attn.o_proj.weight"] = (d, hd)
        if moe:
            ff = cfg.moe_d_ff or f
            gate = pre + "block_sparse_moe."
            out[gate + "gate.weight"] = (cfg.moe_num_experts, d)
            for x in range(cfg.moe_num_experts):
                for w, shape in (("w1", (ff, d)), ("w3", (ff, d)),
                                 ("w2", (d, ff))):
                    out[f"{gate}experts.{x}.{w}.weight"] = shape
        else:
            out.update({pre + "mlp.gate_proj.weight": (f, d),
                        pre + "mlp.up_proj.weight": (f, d),
                        pre + "mlp.down_proj.weight": (d, f)})
    return out


def _llama_top(get, cfg: TransformerConfig) -> dict:
    out = {"embedding": get("embed_tokens.weight"),
           "ln_f.scale": get("norm.weight")}
    if not cfg.tied_embeddings:
        out["lm_head"] = get("lm_head.weight")
    return out


def _llama_layer(get, cfg: TransformerConfig, i: int) -> dict:
    pre, dst = f"layers.{i}.", f"blocks.{i}."
    names = {"input_layernorm.weight": "ln1.scale",
             "post_attention_layernorm.weight": "ln2.scale",
             "self_attn.o_proj.weight": "attn.o.weight"}
    for p in "qkv":
        names[f"self_attn.{p}_proj.weight"] = f"attn.{p}.weight"
        if cfg.qkv_bias:
            names[f"self_attn.{p}_proj.bias"] = f"attn.{p}.bias"
    if cfg.moe_every == 0:
        names.update({"mlp.gate_proj.weight": "mlp.wg.weight",
                      "mlp.up_proj.weight": "mlp.wi.weight",
                      "mlp.down_proj.weight": "mlp.wo.weight"})
    out = _take(get, {pre + s: dst + d for s, d in names.items()})
    if cfg.moe_every:
        moe = pre + "block_sparse_moe."
        experts = range(cfg.moe_num_experts)

        def stack(w):  # HF [out, in] per expert -> [E, in, out]
            return torch.stack([get(f"{moe}experts.{x}.{w}.weight").t()
                                for x in experts])

        out[dst + "moe.router"] = get(moe + "gate.weight").t()  # [D, E]
        out[dst + "moe.wg"] = stack("w1")
        out[dst + "moe.wi"] = stack("w3")
        out[dst + "moe.wo"] = stack("w2")
    return out


# GPT-2: Conv1D weights [in, out], the fused c_attn [d, 3d]

def _gpt2_shapes(cfg: TransformerConfig) -> dict:
    d, _, _, f, v = _dims(cfg)
    out = {"wte.weight": (v, d), "wpe.weight": (cfg.max_seq_len, d),
           **_norm_shapes("ln_f", d, True)}
    for i in range(cfg.n_layers):
        pre = f"h.{i}."
        for name in ("ln_1", "ln_2"):
            out.update(_norm_shapes(pre + name, d, True))
        for name, shape in (("attn.c_attn", (d, 3 * d)),
                            ("attn.c_proj", (d, d)), ("mlp.c_fc", (d, f)),
                            ("mlp.c_proj", (f, d))):
            out[f"{pre}{name}.weight"] = shape
            out[f"{pre}{name}.bias"] = shape[1:]
    return out


def _gpt2_top(get, cfg: TransformerConfig) -> dict:
    return {"embedding": get("wte.weight"),
            "pos_embedding": get("wpe.weight"),
            "ln_f.scale": get("ln_f.weight"), "ln_f.bias": get("ln_f.bias")}


def _gpt2_layer(get, cfg: TransformerConfig, i: int) -> dict:
    pre, dst = f"h.{i}.", f"blocks.{i}."
    out = _take(get, {pre + "ln_1.weight": dst + "ln1.scale",
                      pre + "ln_1.bias": dst + "ln1.bias",
                      pre + "ln_2.weight": dst + "ln2.scale",
                      pre + "ln_2.bias": dst + "ln2.bias",
                      pre + "attn.c_proj.bias": dst + "attn.o.bias",
                      pre + "mlp.c_fc.bias": dst + "mlp.wi.bias",
                      pre + "mlp.c_proj.bias": dst + "mlp.wo.bias"})
    qkv_w = get(pre + "attn.c_attn.weight").t().chunk(3)  # 3 x [d, d]
    qkv_b = get(pre + "attn.c_attn.bias").chunk(3)
    for p, w, b in zip("qkv", qkv_w, qkv_b):
        out[f"{dst}attn.{p}.weight"] = w
        out[f"{dst}attn.{p}.bias"] = b
    for src, name in (("attn.c_proj", "attn.o"), ("mlp.c_fc", "mlp.wi"),
                      ("mlp.c_proj", "mlp.wo")):
        out[f"{dst}{name}.weight"] = get(f"{pre}{src}.weight").t()
    return out


# GPT-NeoX: the fused query_key_value [h * 3 * dh, d], per head [q, k, v]

def _neox_shapes(cfg: TransformerConfig) -> dict:
    d, hd, _, f, v = _dims(cfg)
    out = {"embed_in.weight": (v, d),
           **_norm_shapes("final_layer_norm", d, True)}
    if not cfg.tied_embeddings:
        out["embed_out.weight"] = (v, d)
    for i in range(cfg.n_layers):
        pre = f"layers.{i}."
        for name in ("input_layernorm", "post_attention_layernorm"):
            out.update(_norm_shapes(pre + name, d, True))
        for name, o, n in (("attention.query_key_value", 3 * hd, d),
                           ("attention.dense", d, hd),
                           ("mlp.dense_h_to_4h", f, d),
                           ("mlp.dense_4h_to_h", d, f)):
            out.update(_linear_shapes(pre + name, o, n, True))
    return out


def _neox_top(get, cfg: TransformerConfig) -> dict:
    out = {"embedding": get("embed_in.weight"),
           "ln_f.scale": get("final_layer_norm.weight"),
           "ln_f.bias": get("final_layer_norm.bias")}
    if not cfg.tied_embeddings:
        out["lm_head"] = get("embed_out.weight")
    return out


def _neox_layer(get, cfg: TransformerConfig, i: int) -> dict:
    pre, dst = f"layers.{i}.", f"blocks.{i}."
    names = {"input_layernorm": "ln1", "post_attention_layernorm": "ln2"}
    out = {}
    for src, d in names.items():
        out[dst + d + ".scale"] = get(pre + src + ".weight")
        out[dst + d + ".bias"] = get(pre + src + ".bias")
    for src, d in (("attention.dense", "attn.o"),
                   ("mlp.dense_h_to_4h", "mlp.wi"),
                   ("mlp.dense_4h_to_h", "mlp.wo")):
        out[f"{dst}{d}.weight"] = get(f"{pre}{src}.weight")
        out[f"{dst}{d}.bias"] = get(f"{pre}{src}.bias")
    h, dh = cfg.n_heads, cfg.head_dim
    w = get(pre + "attention.query_key_value.weight").view(h, 3, dh, -1)
    b = get(pre + "attention.query_key_value.bias").view(h, 3, dh)
    for j, p in enumerate("qkv"):
        out[f"{dst}attn.{p}.weight"] = w[:, j].reshape(h * dh, -1)
        out[f"{dst}attn.{p}.bias"] = b[:, j].reshape(h * dh)
    return out


# Phi: biased q/k/v/dense/fc1/fc2, one input norm, a biased head

def _phi_shapes(cfg: TransformerConfig) -> dict:
    d, hd, kvd, f, v = _dims(cfg)
    out = {"embed_tokens.weight": (v, d),
           **_norm_shapes("final_layernorm", d, True),
           **_linear_shapes("lm_head", v, d, True)}
    for i in range(cfg.n_layers):
        pre = f"layers.{i}."
        out.update(_norm_shapes(pre + "input_layernorm", d, True))
        for name, o, n in (("self_attn.q_proj", hd, d),
                           ("self_attn.k_proj", kvd, d),
                           ("self_attn.v_proj", kvd, d),
                           ("self_attn.dense", d, hd), ("mlp.fc1", f, d),
                           ("mlp.fc2", d, f)):
            out.update(_linear_shapes(pre + name, o, n, True))
    return out


def _phi_top(get, cfg: TransformerConfig) -> dict:
    return {"embedding": get("embed_tokens.weight"),
            "ln_f.scale": get("final_layernorm.weight"),
            "ln_f.bias": get("final_layernorm.bias"),
            "lm_head": get("lm_head.weight"),
            "lm_head_bias": get("lm_head.bias")}


def _phi_layer(get, cfg: TransformerConfig, i: int) -> dict:
    pre, dst = f"layers.{i}.", f"blocks.{i}."
    names = {"self_attn.q_proj": "attn.q", "self_attn.k_proj": "attn.k",
             "self_attn.v_proj": "attn.v", "self_attn.dense": "attn.o",
             "mlp.fc1": "mlp.wi", "mlp.fc2": "mlp.wo"}
    out = {}
    for src, d in names.items():
        out[f"{dst}{d}.weight"] = get(f"{pre}{src}.weight")
        out[f"{dst}{d}.bias"] = get(f"{pre}{src}.bias")
    for norm in ("ln1", "ln2"):  # both branches read the one input norm
        out[f"{dst}{norm}.scale"] = get(pre + "input_layernorm.weight")
        out[f"{dst}{norm}.bias"] = get(pre + "input_layernorm.bias")
    return out


LLAMA = Family("Llama", "model.", _llama_shapes, _llama_top, _llama_layer,
               head="lm_head.weight")
MIXTRAL = Family("Mixtral", "model.", _llama_shapes, _llama_top,
                 _llama_layer, head="lm_head.weight")
GPT2 = Family("GPT-2", "transformer.", _gpt2_shapes, _gpt2_top, _gpt2_layer,
              head="lm_head.weight", buffers=(".attn.bias",
                                              ".attn.masked_bias"))
NEOX = Family("GPT-NeoX", "gpt_neox.", _neox_shapes, _neox_top, _neox_layer,
              head="embed_out.weight",
              buffers=("inv_freq", "attention.bias",
                       "attention.masked_bias"), plain="NeoX")
PHI = Family("Phi", "model.", _phi_shapes, _phi_top, _phi_layer)

# model_type -> (config reader, family), in the reference CLI's order
FAMILIES = {
    "gpt2": (gpt2_config, GPT2),
    "llama": (llama_config, LLAMA),
    "mistral": (llama_config, LLAMA),
    "qwen2": (llama_config, LLAMA),
    "gemma": (gemma_config, LLAMA),
    "mixtral": (mixtral_config, MIXTRAL),
    "gpt_neox": (neox_config, NEOX),
    "phi": (phi_config, PHI),
}
SUPPORTED = tuple(FAMILIES)


def hf_shapes(model_type: str, cfg: TransformerConfig) -> dict:
    """Every tensor a ``model_type`` checkpoint of ``cfg`` carries, by its
    full name in the file, with its shape (a tied head left out)."""
    fam = FAMILIES[model_type][1]
    outside = {"lm_head.weight", "lm_head.bias", "embed_out.weight"}
    return {(k if k in outside else fam.prefix + k): v
            for k, v in fam.shapes(cfg).items()}


def convert_llama_state_dict(state_dict: dict,
                             cfg: TransformerConfig) -> dict:
    """HF Llama/Mistral/Qwen2/Gemma state_dict -> the port's
    ``state_dict``. Strict: a tensor the importer does not map means the
    checkpoint is not the architecture the config claims, and raises."""
    return LLAMA.convert(state_dict, cfg)


def convert_mixtral_state_dict(state_dict: dict,
                               cfg: TransformerConfig) -> dict:
    """HF Mixtral state_dict -> the port's ``state_dict``: the attention
    and norms as Llama's; each block's ``gate.weight`` [E, D] becomes
    ``moe.router`` [D, E] and ``experts.x.{w1, w3, w2}`` the stacked
    ``moe.{wg, wi, wo}`` [E, in, out]. Strict as Llama's."""
    return MIXTRAL.convert(state_dict, cfg)


def convert_gpt2_state_dict(state_dict: dict,
                            cfg: TransformerConfig) -> dict:
    """HF GPT-2 state_dict -> the port's ``state_dict``: Conv1D ``[in,
    out]`` weights transposed, ``c_attn`` split into q, k and v, ``wpe``
    the learned positions. Strict."""
    return GPT2.convert(state_dict, cfg)


def convert_neox_state_dict(state_dict: dict,
                            cfg: TransformerConfig) -> dict:
    """HF GPT-NeoX state_dict -> the port's ``state_dict``:
    ``query_key_value`` split per head into q, k and v (rows ``[h, 3,
    dh]``), ``embed_out`` the untied head. Strict, with the attention
    masks and rotary buffers of old checkpoints passed over."""
    return NEOX.convert(state_dict, cfg)


def convert_phi_state_dict(state_dict: dict, cfg: TransformerConfig) -> dict:
    """HF Phi state_dict -> the port's ``state_dict``: the one input
    LayerNorm into both ``ln1`` and ``ln2``, ``lm_head.bias`` the head's
    bias. Strict."""
    return PHI.convert(state_dict, cfg)


# ---------------------------------------------------------- safetensors

_ST_DTYPES = {"F64": torch.float64, "F32": torch.float32,
              "F16": torch.float16, "BF16": torch.bfloat16,
              "I64": torch.int64, "I32": torch.int32, "I16": torch.int16,
              "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool}
_ST_NAMES = {v: k for k, v in _ST_DTYPES.items()}


def _st_header(f) -> tuple[int, dict]:
    """(the data's offset, ``{name: {dtype, shape, data_offsets}}``) of
    an open ``.safetensors`` file: an 8-byte little-endian header
    length, then the JSON header, then the raw tensor bytes."""
    (n,) = struct.unpack("<Q", f.read(8))
    header = json.loads(f.read(n))
    header.pop("__metadata__", None)
    return 8 + n, header


def _st_read(f, base: int, name: str, meta: dict) -> torch.Tensor:
    dtype = _ST_DTYPES.get(meta["dtype"])
    if dtype is None:
        raise ValueError(f"{name}: unsupported safetensors dtype "
                         f"{meta['dtype']!r}")
    start, end = meta["data_offsets"]
    f.seek(base + start)
    raw = bytearray(f.read(end - start))
    t = torch.frombuffer(raw, dtype=dtype) if raw else \
        torch.empty(0, dtype=dtype)
    return t.reshape(meta["shape"])


def read_safetensors(path: str) -> dict[str, torch.Tensor]:
    """A ``.safetensors`` file as CPU tensors."""
    with open(path, "rb") as f:
        base, header = _st_header(f)
        return {name: _st_read(f, base, name, meta)
                for name, meta in header.items()}


class CheckpointTensors:
    """A checkpoint directory's tensors by name, each read from disk
    when asked for: one ``model.safetensors``, or the shard files that
    ``model.safetensors.index.json``'s ``weight_map`` names."""

    def __init__(self, model_dir: str):
        index = os.path.join(model_dir, "model.safetensors.index.json")
        single = os.path.join(model_dir, "model.safetensors")
        if os.path.exists(index):
            with open(index) as f:
                weight_map = json.load(f)["weight_map"]
            self.files = {k: os.path.join(model_dir, v)
                          for k, v in weight_map.items()}
        elif os.path.exists(single):
            with open(single, "rb") as f:
                self.files = dict.fromkeys(_st_header(f)[1], single)
        else:
            raise FileNotFoundError(
                f"{model_dir}: no model.safetensors or "
                "model.safetensors.index.json")
        self._headers: dict[str, tuple[int, dict]] = {}

    def names(self) -> list[str]:
        return list(self.files)

    def get(self, name: str) -> torch.Tensor:
        path = self.files[name]
        with open(path, "rb") as f:
            if path not in self._headers:
                self._headers[path] = _st_header(f)
            base, header = self._headers[path]
            return _st_read(f, base, name, header[name])


def write_safetensors(tensors: dict[str, torch.Tensor], path: str) -> None:
    """Write ``tensors`` in the safetensors layout ``read_safetensors``
    reads (and HF loaders accept)."""
    header, blobs, offset = {}, [], 0
    for name, t in tensors.items():
        t = t.detach().contiguous().cpu()
        raw = t.reshape(-1).view(torch.uint8).numpy().tobytes()
        header[name] = {"dtype": _ST_NAMES[t.dtype],
                        "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(raw)]}
        blobs.append(raw)
        offset += len(raw)
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for raw in blobs:
            f.write(raw)


def load_hf_dir(model_dir: str, device=None, int8: bool = False,
                **overrides):
    """``(Transformer, config dict)`` from a checkpoint directory
    (``config.json`` and one ``model.safetensors`` or an index over
    shards) of a supported ``model_type`` (gpt2, llama, mistral, qwen2,
    gemma, mixtral, gpt_neox, phi), on ``device`` (default cuda).
    Tensors are read a layer at a time. ``int8=True`` returns the
    ``cfg.quantized`` model: each block is built at fp32 on the host
    from the file, quantized there (``models.quantize``) and moved to
    ``device`` before the next block is read."""
    from tony_tpu_torch.ops.platform import resolve_device

    device = resolve_device(device)
    with open(os.path.join(model_dir, "config.json")) as f:
        hf = json.load(f)
    kind = hf.get("model_type")
    if kind not in FAMILIES:
        raise ValueError(f"unsupported model_type {kind!r} "
                         f"(supported: {', '.join(SUPPORTED)})")
    make, family = FAMILIES[kind]
    ckpt = CheckpointTensors(model_dir)
    real = {family.strip(k): k for k in ckpt.names()}
    cfg = make(hf, **overrides)
    family.check_names(real, cfg)

    def get(name):
        return ckpt.get(real[name])

    if int8:
        return _load_int8(cfg, get, family, device), hf
    model = Transformer(cfg, device="meta")
    model.to_empty(device=device)
    _fill(model, family.name, family.parts(get, cfg))
    return model, hf


def _fill(model, family: str, parts) -> None:
    """Load each dict of ``parts`` (an iterable, read one at a time) into
    ``model``, whose every ``state_dict`` entry must be filled."""
    loaded = set()
    for part in parts:
        _, unexpected = model.load_state_dict(part, strict=False)
        if unexpected:
            raise ValueError(f"unexpected tensors {unexpected[:8]}")
        loaded |= set(part)
    missing = set(model.state_dict()) - loaded
    if missing:
        raise ValueError(f"the {family} checkpoint leaves "
                         f"{sorted(missing)[:8]} unfilled")


def _load_int8(cfg: TransformerConfig, get, family: Family, device):
    import dataclasses

    from tony_tpu_torch.models.quantize import quantize_module
    from tony_tpu_torch.models.transformer import Block

    qmodel = Transformer(dataclasses.replace(cfg, quantized=True),
                         device="meta")
    qmodel.to_empty(device=device)
    every = cfg.moe_every
    fp32 = dataclasses.replace(cfg, dtype=torch.float32)

    def quantized(i):  # from the fp32 weights, whatever cfg.dtype says
        block = Block(fp32, device="cpu",
                      use_moe=every > 0 and (i + 1) % every == 0)
        pre = f"blocks.{i}."
        block.load_state_dict({k[len(pre):]: v for k, v in
                               family.layer(get, fp32, i).items()},
                              strict=True)
        return {pre + k: v for k, v in quantize_module(block).items()}

    _fill(qmodel, family.name, itertools.chain(
        [family.top(get, cfg)],
        (quantized(i) for i in range(cfg.n_layers))))
    return qmodel
