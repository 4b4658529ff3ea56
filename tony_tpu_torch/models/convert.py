"""Map the JAX package's param tree onto the port's ``state_dict``.

``from_jax_params`` takes the tree ``tony_tpu.models.Transformer.init``
returns (``embedding``, ``ln_f``, ``lm_head``, ``block_i/{ln1, ln2,
attn/{q,k,v,o}, mlp/{wg,wi,wo}}``, and ``block_i/moe/{router, wi, wg,
wo}`` in an MoE block), each leaf a numpy array, and returns tensors
keyed as the port's ``Transformer.state_dict()``: flax kernels ``[in,
...out]`` become ``nn.Linear``'s ``[out, in]``; the expert leaves keep
their layout (``router`` [D, E], ``wi``/``wg`` [E, D, F], ``wo`` [E, F,
D]); the int8 tree ``models.quantize`` makes (``{kernel_q8, scale,
bias?}`` under each projection, ``{wi_q8, wi_scale, ...}`` beside the
router) maps onto a ``cfg.quantized`` model's buffers as it is, int8
kept int8. Strict both ways: a leaf it cannot map, or a port parameter
no leaf fills, raises. ``to_jax_params`` is the inverse: a port
``state_dict`` back to the JAX tree.

A ``scan_layers`` tree stacks every block leaf under ``layers/block/``
with a leading ``[n_layers]`` axis; each maps as its unstacked leaf
does, slice by slice, onto ``layers.block.*`` (a flax kernel
``[n_layers, in, ...out]`` becomes ``[n_layers, out, in]``).
``stack_layers`` and ``unstack_layers`` turn a port ``state_dict``
between the two layouts.

``from_jax_train_state`` carries a whole JAX ``TrainState`` across
(params, and the ``FusedAdamWState`` count, moments and compute copy),
so both packages can continue from the same non-zero state. Elementwise
optimizer leaves map exactly as their params do (a transpose is a
permutation of elements).

``from_jax_lora`` carries a ``tony_tpu.train.lora_init`` adapter tree
across as it is (the port keeps the reference's adapter shapes, see
``train.lora``), keyed as ``train.lora.LoraAdapters``' parameters;
``from_jax_resnet`` maps a ``tony_tpu.models.resnet`` model's ``params``
and ``batch_stats`` onto the port's ``ResNet.state_dict()``: HWIO
kernels become OIHW, the dense head ``[out, in]``.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from tony_tpu_torch.models.quantize import _DENSE_NAMES


# an MoE block's leaves, in the same layout in both packages
_MOE_LEAVES = ("router", "wi", "wg", "wo", "wi_q8", "wg_q8", "wo_q8",
               "wi_scale", "wg_scale", "wo_scale")


def _flatten(tree: Any, prefix: str = "") -> dict[str, np.ndarray]:
    if isinstance(tree, dict) or hasattr(tree, "items"):
        out: dict[str, np.ndarray] = {}
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def _map_leaf(path: str, x):
    parts = path.split("/")
    top = parts[0]
    if top == "layers" and len(parts) >= 3 and parts[1] == "block":
        # a scanned leaf: each layer's slice maps as block_0's would
        inner = "block_0/" + "/".join(parts[2:])
        mapped = [_map_leaf(inner, x[j]) for j in range(x.shape[0])]
        if not mapped:
            raise ValueError(f"unmapped param leaf {path!r} (no layers)")
        stack = torch.stack if isinstance(x, torch.Tensor) else np.stack
        key = "layers.block." + mapped[0][0].split(".", 2)[2]
        return key, stack([a for _, a in mapped])
    if len(parts) == 1 and top in ("embedding", "pos_embedding", "lm_head",
                                   "lm_head_bias"):
        return top, x
    if top == "ln_f" and len(parts) == 2 and parts[1] in ("scale", "bias"):
        return f"ln_f.{parts[1]}", x
    if not top.startswith("block_") or len(parts) < 3:
        raise ValueError(f"unmapped param leaf {path!r}")
    i = int(top[len("block_"):])
    sub = parts[1:]
    if len(sub) == 2 and sub[0] == "moe" and sub[1] in _MOE_LEAVES:
        return f"blocks.{i}.moe.{sub[1]}", x
    if sub[0] in ("ln1", "ln2") and len(sub) == 2 \
            and sub[1] in ("scale", "bias"):
        return f"blocks.{i}.{sub[0]}.{sub[1]}", x
    if len(sub) == 3 and sub[2] in ("kernel_q8", "scale") \
            and sub[1] in _DENSE_NAMES:
        # a quantized projection: already [in_flat, out_flat] and
        # [out_flat], the QuantDense buffers' layout
        return f"blocks.{i}.{sub[0]}.{sub[1]}.{sub[2]}", x
    if len(sub) == 3 and sub[2] in ("kernel", "bias"):
        mod, name, leaf = sub
        key = f"blocks.{i}.{mod}.{name}." + (
            "weight" if leaf == "kernel" else "bias")
        if mod == "attn" and name in ("q", "k", "v"):
            if leaf == "kernel":  # [d, heads, dh] -> [heads*dh, d]
                return key, x.reshape(x.shape[0], -1).T
            return key, x.reshape(-1)
        if mod == "attn" and name == "o":
            if leaf == "kernel":  # [heads, dh, d] -> [d, heads*dh]
                return key, x.reshape(-1, x.shape[-1]).T
            return key, x
        if mod == "mlp" and name in ("wg", "wi", "wo"):
            return key, x.T if leaf == "kernel" else x
    raise ValueError(f"unmapped param leaf {path!r}")


def _torch_dtype(x: np.ndarray) -> torch.dtype:
    return torch.bfloat16 if x.dtype.name == "bfloat16" else torch.float32


def _tensor(arr: np.ndarray, keep_dtype: bool) -> torch.Tensor:
    if arr.dtype == np.int8:  # int8 weights stay int8
        return torch.from_numpy(np.array(arr, dtype=np.int8))
    t = torch.from_numpy(np.array(arr, dtype=np.float32))
    return t.to(_torch_dtype(arr)) if keep_dtype else t


def from_jax_params(params_np: Any, cfg, keep_dtype: bool = False) \
        -> dict[str, torch.Tensor]:
    """JAX param tree (bare or under ``"params"``) -> the port's
    ``state_dict`` (fp32 CPU tensors, int8 weights int8;
    ``load_state_dict`` casts them to each entry's dtype and device).
    ``keep_dtype`` keeps a bf16 leaf bf16 (optimizer moments and compute
    copies)."""
    from tony_tpu_torch.models.transformer import Transformer

    if "params" in params_np and len(params_np) == 1:
        params_np = params_np["params"]
    out: dict[str, torch.Tensor] = {}
    for path, x in _flatten(params_np).items():
        key, arr = _map_leaf(path, x)
        out[key] = _tensor(arr, keep_dtype)
    want = Transformer(cfg, device="meta").state_dict()
    missing = sorted(set(want) - set(out))
    extra = sorted(set(out) - set(want))
    if missing or extra:
        raise ValueError(f"param tree does not match the config: missing "
                         f"{missing[:8]}, unexpected {extra[:8]}")
    for key, t in out.items():
        if tuple(t.shape) != tuple(want[key].shape):
            raise ValueError(f"{key}: shape {tuple(t.shape)}, config "
                             f"wants {tuple(want[key].shape)}")
    return out


def _unmap_key(key: str, x: np.ndarray, cfg) -> tuple[list, np.ndarray]:
    """One port ``state_dict`` entry -> (its JAX path, the JAX leaf)."""
    parts = key.split(".")
    if parts[:2] == ["layers", "block"]:
        inner = "blocks.0." + ".".join(parts[2:])
        mapped = [_unmap_key(inner, x[j], cfg) for j in range(x.shape[0])]
        return ["layers", "block", *mapped[0][0][1:]], \
            np.stack([a for _, a in mapped])
    if parts[0] != "blocks":
        if parts[0] == "ln_f":
            return ["ln_f", parts[1]], x
        return [parts[0]], x
    i, mod, *rest = parts[1:]
    path = [f"block_{i}", mod, *rest]
    if mod in ("ln1", "ln2", "moe") or rest[-1] in ("kernel_q8", "scale"):
        return path, x
    name, leaf = rest
    heads = {"q": cfg.n_heads, "k": cfg.kv_heads, "v": cfg.kv_heads}
    dh = cfg.head_dim
    if leaf == "bias":
        if mod == "attn" and name in heads:
            return path, x.reshape(heads[name], dh)
        return path, x
    path[-1] = "kernel"
    if mod == "attn" and name in heads:  # [heads*dh, d] -> [d, heads, dh]
        return path, x.T.reshape(x.shape[1], heads[name], dh)
    if mod == "attn" and name == "o":  # [d, heads*dh] -> [heads, dh, d]
        return path, x.T.reshape(cfg.n_heads, dh, x.shape[0])
    return path, x.T


def to_jax_params(state_dict: dict, cfg) -> dict:
    """The port's ``state_dict`` -> the JAX param tree (``{"params":
    ...}``, numpy leaves; bf16 as fp32): ``from_jax_params``' inverse."""
    tree: dict = {}
    for key, t in state_dict.items():
        arr = t.detach().cpu()
        arr = arr.numpy() if arr.dtype == torch.int8 else \
            arr.float().numpy()
        path, leaf = _unmap_key(key, arr, cfg)
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = leaf
    return {"params": tree}


def stack_layers(state_dict: dict, n_layers: int) -> dict:
    """An unscanned port ``state_dict`` (``blocks.i.*``) in the
    ``scan_layers`` layout: each block leaf's ``n_layers`` tensors
    stacked under ``layers.block.*``; the other entries as they are."""
    out: dict = {}
    for key, t in state_dict.items():
        parts = key.split(".")
        if parts[0] != "blocks":
            out[key] = t
        elif parts[1] == "0":
            rest = ".".join(parts[2:])
            out["layers.block." + rest] = torch.stack(
                [state_dict[f"blocks.{i}.{rest}"] for i in range(n_layers)])
    return out


def unstack_layers(state_dict: dict) -> dict:
    """``stack_layers``' inverse: each ``layers.block.*`` leaf as its
    ``blocks.i.*`` slices (views of the stacked tensor)."""
    out: dict = {}
    for key, t in state_dict.items():
        if not key.startswith("layers.block."):
            out[key] = t
            continue
        rest = key[len("layers.block."):]
        for i, layer in enumerate(t.unbind(0)):
            out[f"blocks.{i}.{rest}"] = layer
    return out


def from_jax_train_state(state_np: Any, cfg):
    """A JAX ``TrainState`` whose leaves are numpy arrays (``jax.tree.map(
    np.asarray, state)``), optimizer ``FusedAdamWState`` -> the port's
    ``TrainState`` on the CPU, ready for ``Trainer.place``: fp32 master
    params, count, mu and nu (bf16 kept bf16) and the compute copy."""
    from tony_tpu_torch.ops.adamw import FusedAdamWState
    from tony_tpu_torch.train.trainer import TrainState

    opt = state_np.opt_state
    if not all(hasattr(opt, f) for f in FusedAdamWState._fields):
        raise ValueError("from_jax_train_state takes a FusedAdamW state; "
                         f"got {type(opt).__name__}")

    def tree(t):
        return None if t is None else from_jax_params(t, cfg,
                                                      keep_dtype=True)

    return TrainState(
        step=int(np.asarray(state_np.step)),
        params=from_jax_params(state_np.params, cfg),
        opt_state=FusedAdamWState(
            count=torch.tensor(int(np.asarray(opt.count)),
                               dtype=torch.int32),
            mu=tree(opt.mu), nu=tree(opt.nu),
            compute_params=tree(opt.compute_params)))


def from_jax_lora(lora_np: Any, cfg) -> dict[str, torch.Tensor]:
    """A JAX adapter tree (``{"params": {"block_0": {"attn": {"q":
    {"kernel": {"a", "b"}}}}}}``, numpy leaves) -> fp32 CPU tensors keyed
    as the port's ``LoraAdapters`` parameters
    (``params.block_0.attn.q.kernel.a``), each shape checked against
    ``cfg``'s kernels."""
    from tony_tpu_torch.train.lora import _ab_shapes, kernel_shapes

    shapes = kernel_shapes(cfg)
    out: dict[str, torch.Tensor] = {}
    for path, x in _flatten(lora_np).items():
        kernel, leaf = path.rsplit("/", 1)
        if kernel not in shapes or leaf not in ("a", "b"):
            raise ValueError(f"unmapped adapter leaf {path!r}")
        rank = x.shape[0] if leaf == "b" else x.shape[-1]
        want = _ab_shapes(shapes[kernel], rank)[leaf == "b"]
        if tuple(x.shape) != want:
            raise ValueError(f"{path}: shape {tuple(x.shape)}, config "
                             f"wants {want}")
        out[path.replace("/", ".")] = torch.from_numpy(
            np.array(x, dtype=np.float32))
    return out


def _map_resnet_leaf(path: str, x: np.ndarray) -> tuple[str, np.ndarray]:
    parts = path.split("/")
    if parts[0] == "Dense_0":
        return ("head.weight", x.T) if parts[1] == "kernel" \
            else ("head.bias", x)
    *mods, leaf = parts
    names = []
    for m in mods:
        kind, _, idx = m.rpartition("_")
        if kind.endswith("Block"):  # ResNetBlock_i, BottleneckResNetBlock_i
            names += ["blocks", idx]
        elif kind in ("Conv", "BatchNorm"):
            names += ["convs" if kind == "Conv" else "norms", idx]
        else:  # conv_init, bn_init, conv_proj, norm_proj
            names.append(m)
    if leaf == "kernel":  # HWIO -> OIHW
        return ".".join(names + ["weight"]), x.transpose(3, 2, 0, 1)
    return ".".join(names + [leaf]), x


def from_jax_resnet(variables_np: Any) -> dict[str, torch.Tensor]:
    """A JAX ResNet's variables (``{"params", "batch_stats"}``, numpy
    leaves) -> the port's ``ResNet.state_dict()`` as fp32 CPU tensors
    (``load_state_dict`` checks every key and shape)."""
    out: dict[str, torch.Tensor] = {}
    for coll in ("params", "batch_stats"):
        for path, x in _flatten(variables_np[coll]).items():
            key, arr = _map_resnet_leaf(path, x)
            out[key] = torch.from_numpy(np.array(arr, dtype=np.float32))
    return out
