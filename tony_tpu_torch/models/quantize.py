"""int8 weight-only conversion for generation and scoring: the
counterpart of ``tony_tpu/models/quantize.py``.

``quantize_for_serving(model)`` returns the model with every projection
(q, k, v, o, wg, wi, wo) held as ``{kernel_q8 int8, scale fp32}``, which
``TransformerConfig(quantized=True)``'s ``QuantDense`` runs through the
int8 kernel (``ops.quant.q8_matmul``): half the weight bytes a decode
step against bf16. Embeddings, norms, biases and the LM head stay full
precision.

The int8 values and scales are computed from the fp32 weights, bit for
bit those of ``tony_tpu.models.quantize.quantize_transformer_params`` on
the same weights. The port stores dense weights at ``cfg.dtype``, so a
model built at bf16 no longer holds them: conversion refuses it. For
bf16 activations over int8 weights, quantize at fp32 and load the
quantized ``state_dict`` into a bf16 config (``QuantDense``'s buffers do
not follow ``cfg.dtype``).

MoE experts (Mixtral): each of ``wi``, ``wg`` and ``wo`` [E, in, out]
becomes ``{name}_q8`` int8 with ``{name}_scale`` fp32 [E, out], one
scale per (expert, output column) (``quantize_expert``), run by the
expert-batched kernel; the router stays fp32. ``scan_layers`` is
refused as in the JAX package.

``quantize_module`` converts one module (a block) where it lies;
``quantize_for_serving`` and ``models.hf.load_hf_dir(int8=True)`` go
block by block with it, so a model whose float weights would not fit
the card at once is built and quantized a block at a time and only its
int8 form is kept.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from tony_tpu_torch.ops.quant import quantize_q8

# parent module names whose kernel becomes int8
_DENSE_NAMES = ("q", "k", "v", "o", "wi", "wg", "wo")
_EXPERT_NAMES = ("wi", "wg", "wo")


def quantize_expert(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Expert weights [E, in, out] -> (int8 [E, in, out], fp32 scale [E,
    out]): the absmax over the contraction axis (1) per (expert, out),
    ``scale = max(absmax, 1e-8) / 127``, values rounded half to even and
    clipped to +-127, as ``tony_tpu/models/quantize.py`` does."""
    a = w.float()
    scale = torch.clamp(a.abs().amax(dim=1), min=1e-8) / 127.0
    q = torch.clamp(torch.round(a / scale[:, None, :]), -127, 127)
    return q.to(torch.int8), scale


def _quantize_tree(node: Any, name: str = "") -> Any:
    """A JAX-layout param tree (numpy leaves): each dense kernel
    [in, *out] (o: [*in, out]) becomes {kernel_q8 [in_flat, out_flat],
    scale [out_flat]}, its bias rides along."""
    if not isinstance(node, dict):
        return node
    if "router" in node and "wi" in node:  # an MoE block's experts
        extra = set(node) - {"router", *_EXPERT_NAMES}
        if extra:
            raise ValueError(f"unexpected MoE leaves: {extra}")
        out = {"router": node["router"]}
        for nm in _EXPERT_NAMES:
            if nm in node:
                q, sc = quantize_expert(torch.from_numpy(
                    np.array(node[nm], dtype=np.float32)))
                out[nm + "_q8"], out[nm + "_scale"] = q.numpy(), sc.numpy()
        return out
    if "kernel" in node and name in _DENSE_NAMES:
        extra = set(node) - {"kernel", "bias"}
        if extra:
            raise ValueError(f"unexpected leaves under {name}: {extra}")
        arr = np.asarray(node["kernel"])
        if name == "o":  # [heads, dh, d]: the leading axes are the input
            w2 = arr.reshape(-1, arr.shape[-1])
        else:  # [in, *out]
            w2 = arr.reshape(arr.shape[0], -1)
        w_q, scale = quantize_q8(torch.from_numpy(np.array(w2)))
        out = {"kernel_q8": w_q.numpy(), "scale": scale.numpy()}
        if "bias" in node:
            out["bias"] = node["bias"]
        return out
    return {k: _quantize_tree(v, k) for k, v in node.items()}


def _quantize_state_dict(sd: dict) -> dict:
    """A port ``state_dict``: each projection's ``weight`` [out, in]
    becomes ``kernel_q8`` [in, out] and ``scale`` [out]."""
    out = {}
    for key, t in sd.items():
        mod, _, leaf = key.rpartition(".")
        if mod.rsplit(".", 1)[-1] == "moe" and leaf in _EXPERT_NAMES:
            if t.dtype != torch.float32:
                raise ValueError(
                    f"{key} is {t.dtype}: int8 conversion quantizes the "
                    "fp32 weights (build or load the model at fp32)")
            out[f"{mod}.{leaf}_q8"], out[f"{mod}.{leaf}_scale"] = \
                quantize_expert(t)
        elif leaf == "weight" and mod.rsplit(".", 1)[-1] in _DENSE_NAMES:
            if t.dtype != torch.float32:
                raise ValueError(
                    f"{key} is {t.dtype}: int8 conversion quantizes the "
                    "fp32 weights (build or load the model at fp32)")
            w_q, scale = quantize_q8(t.t())
            out[f"{mod}.kernel_q8"], out[f"{mod}.scale"] = w_q, scale
        else:  # biases (fp32, as the weights are) and every other leaf
            out[key] = t
    return out


def quantize_transformer_params(params: Any) -> Any:
    """A port ``state_dict`` (name -> tensor) or a JAX-layout param tree
    (nested dicts of numpy arrays, bare or under ``"params"``) -> the
    same with every projection quantized. Biases ride along unchanged;
    every other leaf passes through."""
    if any(isinstance(v, dict) for v in params.values()):
        return _quantize_tree(params)
    return _quantize_state_dict(params)


def quantize_module(module, prefix: str = "") -> dict:
    """One module's ``state_dict`` (keys under ``prefix``) quantized, on
    its own device: the unit ``quantize_for_serving`` converts at a
    time."""
    return _quantize_state_dict({prefix + k: v.detach()
                                 for k, v in module.state_dict().items()})


def quantize_for_serving(model):
    """model -> the quantized model (``cfg.quantized``) on the same
    device, ready for ``generate`` and ``cli.score``. The model's dense
    and expert weights must be fp32. Block by block: each block's int8
    form is made and loaded before the next block is converted."""
    from tony_tpu_torch.models.transformer import Transformer

    cfg = model.cfg
    if cfg.scan_layers:
        raise ValueError("int8 serving conversion expects per-block "
                         "params (scan_layers stacks them)")
    qmodel = Transformer(dataclasses.replace(cfg, quantized=True),
                         device="meta")
    qmodel.to_empty(device=model.device)
    rest = {k: v.detach() for k, v in model.state_dict().items()
            if not k.startswith("blocks.")}
    missing, unexpected = qmodel.load_state_dict(rest, strict=False)
    if unexpected or any(not k.startswith("blocks.") for k in missing):
        raise ValueError(f"state_dict does not match the config: missing "
                         f"{missing[:8]}, unexpected {unexpected[:8]}")
    for block, qblock in zip(model.blocks, qmodel.blocks):
        qblock.load_state_dict(quantize_module(block), strict=True)
    return qmodel
