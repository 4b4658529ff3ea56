"""Hugging Face checkpoint import for the port: the counterpart of the
Llama/Mistral/Qwen2 and Mixtral parts of ``tony_tpu/models/hf.py``.

Works from a checkpoint directory alone — ``config.json`` read as a
plain dict and the safetensors read by the small reader below, one
``model.safetensors`` or the shards that ``model.safetensors.index.json``
names — because the machine with the card has neither ``transformers``
nor ``safetensors``. HF's ``nn.Linear`` weights are already the port's
``[out, in]`` layout, so conversion is renaming; Mixtral's experts are
transposed and stacked into ``[E, in, out]``. ``load_hf_dir`` picks the
reader by ``model_type`` and reads tensors a layer at a time, so with
``int8=True`` a model whose float weights would not fit the card (or
the host) is quantized block by block on the host and only its int8
form lands on the card. Other model families come in a later slice.
"""

from __future__ import annotations

import itertools
import json
import os
import struct

import torch

from tony_tpu_torch.models.transformer import (
    RopeScaling,
    Transformer,
    TransformerConfig,
)

_HF_ACTIVATIONS = {"gelu_new": "gelu_tanh", "gelu_pytorch_tanh": "gelu_tanh",
                   "gelu": "gelu", "silu": "silu", "swish": "silu"}

LLAMA_FAMILY = ("llama", "mistral", "qwen2")
SUPPORTED = LLAMA_FAMILY + ("mixtral",)


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


def llama_config(hf: dict, **overrides) -> TransformerConfig:
    """TransformerConfig for a Llama-family ``config.json`` dict (Llama,
    Mistral's sliding window, Qwen2's q/k/v biases, Llama-3 rope
    scaling). Full attention_bias/mlp_bias variants are rejected."""
    if hf.get("attention_bias", False) or hf.get("mlp_bias", False):
        raise ValueError("attention_bias/mlp_bias Llama variants are not "
                         "supported (only Qwen2-style qkv biases are)")
    act = hf.get("hidden_act", "silu")
    if act not in _HF_ACTIVATIONS:
        raise ValueError(f"unsupported hidden_act {act!r}")
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
        activation=_HF_ACTIVATIONS[act],
        norm_eps=hf["rms_norm_eps"],
        rope_theta=hf.get("rope_theta", 10_000.0),
        rope_scaling=_rope_scaling(hf),
        gated_mlp=True,
        explicit_head_dim=hf.get("head_dim") or 0,
        tied_embeddings=hf.get("tie_word_embeddings", False),
    )
    kw.update(overrides)
    return TransformerConfig(**kw)


def mixtral_config(hf: dict, **overrides) -> TransformerConfig:
    """TransformerConfig for a Mixtral ``config.json`` dict: Mistral's
    attention with every dense MLP replaced by a top-k MoE of SwiGLU
    experts whose gates are renormalized over the chosen k
    (``moe_every=1``), evaluated dropless (exact, no capacity drops)."""
    act = hf.get("hidden_act", "silu")
    if act not in _HF_ACTIVATIONS:
        raise ValueError(f"unsupported Mixtral hidden_act {act!r}; "
                         f"supported: {sorted(_HF_ACTIVATIONS)}")
    kw = dict(
        gated_mlp=False,  # no dense MLP anywhere; moe_every=1 covers all
        moe_every=1,
        moe_num_experts=hf["num_local_experts"],
        moe_top_k=hf["num_experts_per_tok"],
        moe_gated=True,
        moe_renormalize=True,
        moe_dropless=True,
        moe_activation=_HF_ACTIVATIONS[act],
        moe_d_ff=hf["intermediate_size"],
    )
    kw.update(overrides)
    return llama_config(hf, **kw)


def _hf_names(cfg: TransformerConfig, family: str) -> set:
    """Every tensor name (without ``model.``) the importer maps."""
    names = {"embed_tokens.weight", "norm.weight", "lm_head.weight"}
    for i in range(cfg.n_layers):
        pre = f"layers.{i}."
        names |= {pre + p + ".weight" for p in (
            "input_layernorm", "post_attention_layernorm",
            "self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj",
            "self_attn.o_proj")}
        if cfg.qkv_bias:
            names |= {f"{pre}self_attn.{p}_proj.bias" for p in "qkv"}
        if family == "Mixtral":
            moe = pre + "block_sparse_moe."
            names.add(moe + "gate.weight")
            names |= {f"{moe}experts.{x}.{w}.weight"
                      for x in range(cfg.moe_num_experts)
                      for w in ("w1", "w2", "w3")}
        else:
            names |= {f"{pre}mlp.{p}.weight"
                      for p in ("gate_proj", "up_proj", "down_proj")}
    return names


def _check_names(names, cfg: TransformerConfig, family: str) -> None:
    """Strict: a tensor the importer does not map means the checkpoint
    is not the architecture the config claims (``inv_freq`` buffers of
    old checkpoints carry no weights)."""
    known = _hf_names(cfg, family)
    leftover = {k for k in names
                if k not in known and not k.endswith("inv_freq")}
    if leftover:
        raise ValueError(
            f"state_dict has tensors the {family} importer does not map "
            f"(not a plain-{family} architecture?): {sorted(leftover)[:8]}")


def _top_tensors(get, cfg: TransformerConfig) -> dict:
    out = {"embedding": get("embed_tokens.weight"),
           "ln_f.scale": get("norm.weight")}
    if not cfg.tied_embeddings:
        out["lm_head"] = get("lm_head.weight")
    return out


def _layer_tensors(get, cfg: TransformerConfig, i: int,
                   family: str) -> dict:
    """Block ``i``'s tensors, keyed under ``blocks.{i}.`` as the port's
    ``state_dict``."""
    pre, dst = f"layers.{i}.", f"blocks.{i}."
    names = {"input_layernorm.weight": "ln1.scale",
             "post_attention_layernorm.weight": "ln2.scale",
             "self_attn.o_proj.weight": "attn.o.weight"}
    for p in "qkv":
        names[f"self_attn.{p}_proj.weight"] = f"attn.{p}.weight"
        if cfg.qkv_bias:
            names[f"self_attn.{p}_proj.bias"] = f"attn.{p}.bias"
    if family != "Mixtral":
        names.update({"mlp.gate_proj.weight": "mlp.wg.weight",
                      "mlp.up_proj.weight": "mlp.wi.weight",
                      "mlp.down_proj.weight": "mlp.wo.weight"})
    out = {dst + d: get(pre + src) for src, d in names.items()}
    if family == "Mixtral":
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


def _convert(state_dict: dict, cfg: TransformerConfig, family: str) -> dict:
    sd = {k.removeprefix("model."): v for k, v in state_dict.items()}
    _check_names(sd, cfg, family)
    out = _top_tensors(sd.__getitem__, cfg)
    for i in range(cfg.n_layers):
        out.update(_layer_tensors(sd.__getitem__, cfg, i, family))
    return out


def convert_llama_state_dict(state_dict: dict,
                             cfg: TransformerConfig) -> dict:
    """HF Llama/Qwen2 state_dict -> the port's ``state_dict``. Strict:
    a tensor the importer does not map means the checkpoint is not the
    architecture the config claims, and raises."""
    return _convert(state_dict, cfg, "Llama")


def convert_mixtral_state_dict(state_dict: dict,
                               cfg: TransformerConfig) -> dict:
    """HF Mixtral state_dict -> the port's ``state_dict``: the attention
    and norms as Llama's; each block's ``gate.weight`` [E, D] becomes
    ``moe.router`` [D, E] and ``experts.x.{w1, w3, w2}`` the stacked
    ``moe.{wg, wi, wo}`` [E, in, out]. Strict as Llama's."""
    return _convert(state_dict, cfg, "Mixtral")


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
    shards) of a supported ``model_type`` (llama, mistral, qwen2,
    mixtral), on ``device`` (default cuda). Tensors are read a layer at
    a time. ``int8=True`` returns the ``cfg.quantized`` model: each
    block is built at fp32 on the host from the file, quantized there
    (``models.quantize``) and moved to ``device`` before the next block
    is read."""
    from tony_tpu_torch.ops.platform import resolve_device

    device = resolve_device(device)
    with open(os.path.join(model_dir, "config.json")) as f:
        hf = json.load(f)
    kind = hf.get("model_type")
    if kind not in SUPPORTED:
        raise ValueError(f"unsupported model_type {kind!r} "
                         f"(supported: {', '.join(SUPPORTED)})")
    family = "Mixtral" if kind == "mixtral" else "Llama"
    make = mixtral_config if kind == "mixtral" else llama_config
    ckpt = CheckpointTensors(model_dir)
    real = {k.removeprefix("model."): k for k in ckpt.names()}
    cfg = make(hf, **overrides)
    _check_names(real, cfg, family)

    def get(name):
        return ckpt.get(real[name])

    if int8:
        return _load_int8(cfg, get, family, device), hf
    model = Transformer(cfg, device="meta")
    model.to_empty(device=device)
    _fill(model, family, itertools.chain(
        [_top_tensors(get, cfg)],
        (_layer_tensors(get, cfg, i, family) for i in range(cfg.n_layers))))
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


def _load_int8(cfg: TransformerConfig, get, family: str, device):
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
                               _layer_tensors(get, fp32, i, family).items()},
                              strict=True)
        return {pre + k: v for k, v in quantize_module(block).items()}

    _fill(qmodel, family, itertools.chain(
        [_top_tensors(get, cfg)],
        (quantized(i) for i in range(cfg.n_layers))))
    return qmodel
