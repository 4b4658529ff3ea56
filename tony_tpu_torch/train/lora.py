"""LoRA fine-tuning: low-rank adapters over the port's transformer. The
counterpart of ``tony_tpu/train/lora.py``.

The math is the reference's merge form: each targeted kernel becomes
``W + (alpha/r)·tensordot(A, B)`` over the rank axis, recomputed inside
every step, with A and B factoring the JAX package's kernel over its
FIRST axis (``_ab_shapes``): A is ``[shape[0], r]`` and B
``[r, *shape[1:]]``. So ``attn/o``, whose JAX kernel is ``[heads, dh,
d]``, gets A ``[heads, r]`` and B ``[r, dh, d]``, not the ``[heads*dh,
r]`` a port-layout factorisation would give: the port keeps the
reference's shapes, so adapters carry across both ways. Each delta is
computed in the JAX layout and mapped onto the port's ``[out, in]``
weight by ``models.convert``'s own leaf rules.

The trained object is ``LoraAdapters``, a module whose parameters are
the adapters alone, named after their JAX paths
(``params.block_0.attn.o.kernel.a`` is ``params/block_0/attn/o/kernel/
a``), so ``Trainer`` keeps fp32 masters and optimizer state for the
adapters only and ``fit``, checkpoints and the captured step work
unchanged. The base never enters the trained set: ``wrap_apply_fn``
builds, once, a frozen view of the base model (its tensors shared, not
copied, unless ``compute_dtype`` casts them, once), in which each
targeted projection reads its weight as the merge of the base weight
and the adapters that the trainer passes in. The merge is recomputed
wherever the projection runs, a remat recomputation included, so the
gradients reach the adapters through every path. The base keeps its
storage across steps, which a captured step (keyed by the adapters'
pointers) relies on.

Typical wiring (see ``tony_tpu_torch/examples/sft_lora.py``)::

    lora = lora_init(torch.Generator().manual_seed(1), model, rank=8)
    trainer = Trainer(lora, wrap_apply_fn(base_apply, model, alpha=16.0),
                      FusedAdamW(1e-2, weight_decay=0.0))
    result = fit(trainer, None, loader)       # optimizer state LoRA-sized
    served = materialize_lora(model, result.state.params, alpha=16.0)
"""

from __future__ import annotations

import copy
from typing import Any, Callable, Mapping, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from tony_tpu_torch.models.convert import _map_leaf

# default targets: attention q/v projections, the classic LoRA recipe
DEFAULT_TARGETS = ("q", "v")


def kernel_shapes(cfg) -> dict[str, tuple]:
    """The JAX package's kernel shape of every projection of ``cfg``'s
    model, by JAX path (``params/block_i/attn/q/kernel``; scanned,
    ``params/layers/block/attn/q/kernel`` with the layer axis first), in
    the order the JAX package flattens its tree (keys sorted)."""
    d, h, kvh, dh, f = (cfg.d_model, cfg.n_heads, cfg.kv_heads,
                        cfg.head_dim, cfg.d_ff)
    per = {"attn": {"q": (d, h, dh), "k": (d, kvh, dh), "v": (d, kvh, dh),
                    "o": (h, dh, d)},
           "mlp": {"wi": (d, f), "wo": (f, d)}}
    if cfg.gated_mlp:
        per["mlp"]["wg"] = (d, f)
    if cfg.scan_layers:  # one stacked kernel a projection
        out = {f"params/layers/block/{mod}/{name}/kernel":
               (cfg.n_layers, *shape)
               for mod, names in per.items()
               for name, shape in names.items()}
    else:
        out = {f"params/block_{i}/{mod}/{name}/kernel": shape
               for i in range(cfg.n_layers) for mod, names in per.items()
               for name, shape in names.items()}
    return dict(sorted(out.items()))


def _ab_shapes(shape: tuple, rank: int) -> tuple[tuple, tuple]:
    """A: [shape[0], r]; B: [r, *shape[1:]] (the reference's rule)."""
    return (shape[0], rank), (rank,) + tuple(shape[1:])


def _tree_kernels(tree: Any, prefix: str = "") -> dict[str, tuple]:
    """Every 'kernel' leaf of a nested params tree, by path, with its
    shape (keys sorted, as JAX flattens)."""
    out: dict[str, tuple] = {}
    for k in sorted(tree):
        v, path = tree[k], f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(_tree_kernels(v, path + "/"))
        elif k == "kernel":
            out[path] = tuple(v.shape)
    return out


class _Node(nn.Module):
    """One level of the adapter tree."""


class LoraAdapters(nn.Module):
    """The trained tree: for each adapted kernel path, parameters ``a``
    and ``b`` (fp32) under nested modules named after the JAX path."""

    def __init__(self, shapes: Mapping[str, tuple], rank: int,
                 device=None):
        super().__init__()
        self._leaves: dict[str, nn.Module] = {}
        for path, shape in shapes.items():
            node = self
            for name in path.split("/"):
                if name not in node._modules:
                    node.add_module(name, _Node())
                node = node._modules[name]
            a_shape, b_shape = _ab_shapes(shape, rank)
            node.a = nn.Parameter(torch.zeros(a_shape, dtype=torch.float32,
                                              device=device))
            node.b = nn.Parameter(torch.zeros(b_shape, dtype=torch.float32,
                                              device=device))
            self._leaves[path] = node


def lora_init(generator: torch.Generator, model_or_params: Any,
              rank: int = 8, targets: Sequence[str] = DEFAULT_TARGETS
              ) -> LoraAdapters:
    """Adapters for every kernel of ``model_or_params`` whose module name
    is a target: A ~ N(0, 1) / r (standard deviation 1/r, as the
    reference divides a standard normal by ``rank``) and B zeros, so
    step 0 is exactly the base model. ``model_or_params`` is the port's
    ``Transformer`` (its config gives the JAX kernel shapes) or a nested
    JAX-shaped params tree; the adapters land on the model's device,
    else the generator's. Raises if nothing matches."""
    device = generator.device
    if isinstance(model_or_params, nn.Module):
        shapes = kernel_shapes(model_or_params.cfg)
        device = model_or_params.device
    else:
        shapes = _tree_kernels(model_or_params)
    shapes = {p: s for p, s in shapes.items()
              if len(s) >= 2 and p.split("/")[-2] in targets}
    if not shapes:
        raise ValueError(f"no kernels matched LoRA targets {targets!r}")
    lora = LoraAdapters(shapes, rank, device)
    with torch.no_grad():
        for node in lora._leaves.values():
            a = torch.randn(node.a.shape, generator=generator,
                            device=generator.device)
            node.a.copy_(a / rank)
    return lora


def _pairs(lora: Any) -> dict[str, tuple[torch.Tensor, torch.Tensor]]:
    """{JAX kernel path: (A, B)} of ``LoraAdapters`` or of a mapping
    keyed by its parameter names (a ``TrainState.params``)."""
    named = dict(lora.named_parameters()) if isinstance(lora, nn.Module) \
        else dict(lora)
    ab: dict[str, dict] = {}
    for name, t in named.items():
        path, leaf = name.rsplit(".", 1)
        ab.setdefault(path.replace(".", "/"), {})[leaf] = t
    bad = [p for p, v in ab.items() if set(v) != {"a", "b"}]
    if bad:
        raise ValueError(f"adapters without both a and b: {bad[:4]}")
    return {p: (v["a"], v["b"]) for p, v in ab.items()}


def _port_key(path: str) -> str:
    """The port ``state_dict`` key of a JAX kernel path (a scanned one's
    leaf carries the layer axis)."""
    path = path.removeprefix("params/")
    probe = torch.zeros((1,) * (3 if path.startswith("layers/") else 2))
    return _map_leaf(path, probe)[0]


def merged_weight(w: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                  alpha: float, path: str) -> torch.Tensor:
    """``w + (alpha/r)·tensordot(A, B)`` in ``w``'s dtype and layout:
    the delta is taken in the JAX kernel's layout and mapped onto the
    port's by ``models.convert``'s leaf rules."""
    delta = torch.tensordot(a.to(w.dtype), b.to(w.dtype), dims=([1], [0]))
    _, delta = _map_leaf(path.removeprefix("params/"), delta)
    return (w + (alpha / a.shape[-1]) * delta).to(w.dtype)


def merge_lora(params: Any, lora: Any, alpha: float = 16.0) -> dict:
    """``params`` (a port ``state_dict``, or a module, whose state_dict
    is taken) with every adapted weight merged; the other entries pass
    through as they are."""
    if isinstance(params, nn.Module):
        params = params.state_dict()
    out = dict(params)
    for path, (a, b) in _pairs(lora).items():
        key = _port_key(path)
        out[key] = merged_weight(params[key], a, b, alpha, path)
    return out


def materialize_lora(params: Any, lora: Any, alpha: float = 16.0) -> dict:
    """One-time bake for serving: ``merge_lora``'s math, detached, as a
    ``state_dict`` to load into a model of the base's config."""
    with torch.no_grad():
        return {k: v.detach() for k, v in
                merge_lora(params, lora, alpha).items()}


def lora_param_count(lora: Any) -> int:
    values = lora.parameters() if isinstance(lora, nn.Module) \
        else dict(lora).values()
    return sum(t.numel() for t in values)


class _Merged(nn.Module):
    """A frozen projection of the view whose ``weight`` is the merge of
    its base weight and the current adapters, recomputed at each read."""

    def __init__(self, dense: nn.Module, path: str, alpha: float,
                 current: list):
        super().__init__()
        self.dense = dense
        self.path, self.alpha = path, alpha
        self._current = current  # [{path: (A, B)}] of the running step

    @property
    def weight(self) -> torch.Tensor:
        a, b = self._current[0][self.path]
        return merged_weight(self.dense.weight, a, b, self.alpha, self.path)

    @property
    def bias(self):
        return self.dense.bias

    def forward(self, x, p=None):
        """``p``: a scanned layer's slices of the merged weight and the
        bias (``ScannedBlocks.layer_params`` reads them through this
        module's properties)."""
        dt = self.dense.compute_dtype
        w, b = (self.weight, self.bias) if p is None \
            else (p["weight"], p.get("bias"))
        return F.linear(x.to(dt), w.to(dt), None if b is None else b.to(dt))


def _frozen_view(base: nn.Module, compute_dtype=None) -> nn.Module:
    """A copy of ``base``'s module structure over its own tensors (shared;
    floating ones cast to ``compute_dtype`` once where it differs), none
    of them requiring gradients. ``base`` itself is not touched."""
    memo: dict = {id(getattr(base, "graphs", None)): None}
    for p in base.parameters():
        t = p.detach()
        if compute_dtype is not None and t.is_floating_point():
            t = t.to(compute_dtype)
        memo[id(p)] = nn.Parameter(t, requires_grad=False)
    for t in base.buffers():
        memo[id(t)] = t
    return copy.deepcopy(base, memo)


def wrap_apply_fn(base_apply: Callable[[nn.Module, Any], Any],
                  base: nn.Module, alpha: float = 16.0,
                  compute_dtype: Any = None) -> Callable[[Any, Any], Any]:
    """Lift ``base_apply(model, batch)`` into ``apply_fn(lora, batch)``
    with the base frozen inside (a ``_frozen_view``, built once; the
    returned function's ``view`` attribute).

    Mixed precision goes here, not through ``Trainer.compute_dtype``:
    the trainer's cast covers only the trained module (the adapters).
    ``compute_dtype=torch.bfloat16`` casts the frozen base's floating
    tensors once, and the merge then runs in that dtype end to end."""
    view = _frozen_view(base, compute_dtype)
    current: list = [None]

    def install(paths) -> None:
        for path in paths:
            *parent, leaf = _port_key(path).rsplit(".", 1)[0].split(".")
            owner = view.get_submodule(".".join(parent))
            setattr(owner, leaf, _Merged(getattr(owner, leaf), path, alpha,
                                         current))

    def apply_fn(lora, batch):
        pairs = _pairs(lora)
        if current[0] is None:
            install(pairs)
        elif set(pairs) != set(current[0]):
            raise ValueError("wrap_apply_fn: the adapters' paths changed "
                             "between calls")
        current[0] = pairs
        return base_apply(view, batch)

    apply_fn.view = view
    return apply_fn
