"""Sharding presets and the spec math: the counterpart of
``tony_tpu/parallel/sharding.py`` (its training half and its pure
functions), with the port's own ``PartitionSpec`` and ``NamedSharding``.

A model's arrays carry *logical* axis names ("batch", "seq", "embed",
"heads", "kv_heads", "mlp", "vocab", "expert", "layers"); a preset maps
them to mesh axes. The JAX package then lets XLA insert collectives;
here each rank holds its local shard of a tensor, ``place`` cuts it from
the whole and ``gather`` puts the whole back together
(``collectives.all_gather`` along each sharded dim), and the trainer
calls the collectives itself.

Not here yet: ``serving_shardings``, which reads logical axes off a
param tree through ``models.transformer.logical_axis_rules_tree``; it
comes with mesh serving (ROADMAP.md section 1, item 5).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from tony_tpu_torch.parallel.mesh import DATA, EXPERT, FSDP, PIPE, SEQ, TENSOR


class PartitionSpec(tuple):
    """One entry a dim: a mesh axis name, a tuple of names (the dim split
    over all of them, row-major in the order given), or None
    (replicated). Dims past the last entry are replicated. A tuple of one
    name is that name, as in JAX."""

    def __new__(cls, *parts):
        # as JAX normalizes them: a tuple of one name is that name, an
        # empty tuple is None
        parts = tuple((None if not p else p[0] if len(p) == 1 else p)
                      if isinstance(p, tuple) else p for p in parts)
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def _axis_size(mesh, assignment) -> int:
    """Total shard count an axis assignment (name | tuple | None)
    splits a dim into."""
    if assignment is None:
        return 1
    if isinstance(assignment, tuple):
        n = 1
        for a in assignment:
            n *= mesh.shape.get(a, 1)
        return n
    return mesh.shape.get(assignment, 1)


@dataclass(frozen=True)
class NamedSharding:
    """A ``PartitionSpec`` over a mesh."""

    mesh: Any
    spec: PartitionSpec

    def parts(self, ndim: int) -> list:
        return list(self.spec) + [None] * (ndim - len(self.spec))

    def shard_shape(self, shape: tuple) -> tuple:
        """The local shard's shape of a tensor of ``shape``."""
        out = []
        for dim, assignment in zip(shape, self.parts(len(shape))):
            n = _axis_size(self.mesh, assignment)
            if dim % n:
                raise ValueError(f"dim of size {dim} does not split into "
                                 f"{n} shards ({self.spec})")
            out.append(dim // n)
        return tuple(out)

    def is_sharded(self) -> bool:
        return any(_axis_size(self.mesh, a) > 1 for a in self.spec)


# logical axis -> mesh axis (or None = replicated) per strategy
RULES: dict[str, dict[str, Any]] = {
    # pure data parallelism: params replicated, batch sharded
    "dp": {
        "batch": (DATA, FSDP),
        "seq": None, "embed": None, "heads": None, "kv": None, "kv_heads": None,
        "mlp": None, "vocab": None, "expert": None, "layers": None,
    },
    # fsdp: params sharded on the fsdp axis along their largest dim
    "fsdp": {
        "batch": (DATA, FSDP),
        "embed": FSDP,
        "seq": None, "heads": None, "kv": None, "kv_heads": None, "mlp": None,
        "vocab": None, "expert": None, "layers": None,
    },
    # tensor parallelism (megatron-style): heads + mlp sharded
    "tp": {
        "batch": (DATA, FSDP),
        "heads": TENSOR, "mlp": TENSOR, "vocab": TENSOR,
        "seq": None, "embed": None, "kv": None, "kv_heads": None, "expert": None, "layers": None,
    },
    # fsdp + tp combined (the common large-model preset)
    "fsdp_tp": {
        "batch": (DATA, FSDP),
        "embed": FSDP, "heads": TENSOR, "mlp": TENSOR, "vocab": TENSOR,
        "seq": None, "kv": None, "kv_heads": None, "expert": None, "layers": None,
    },
    # sequence/context parallelism: activations sharded along seq
    "sp": {
        "batch": (DATA, FSDP),
        "act_seq": SEQ,
        "seq": None, "embed": None, "heads": None, "kv": None, "kv_heads": None,
        "mlp": None, "vocab": None, "expert": None, "layers": None,
    },
    # expert parallelism for MoE blocks
    "ep": {
        "batch": (DATA, FSDP),
        "expert": EXPERT,
        "seq": None, "embed": None, "heads": None, "kv": None, "kv_heads": None,
        "mlp": None, "vocab": None, "layers": None,
    },
    # expert + tensor combined (large MoE: experts over the expert axis,
    # each expert's ffn dim + attention heads over tensor, batch over data)
    "ep_tp": {
        "batch": (DATA, FSDP),
        "expert": EXPERT, "heads": TENSOR, "mlp": TENSOR, "vocab": TENSOR,
        "seq": None, "embed": None, "kv": None, "kv_heads": None,
        "layers": None,
    },
    # pipeline: layers sharded across stages (used with parallel.pipeline)
    "pp": {
        "batch": (DATA, FSDP),
        "layers": PIPE,
        "seq": None, "embed": None, "heads": None, "kv": None, "kv_heads": None,
        "mlp": None, "vocab": None, "expert": None,
    },
    # SERVING tensor/expert parallelism (the sharded-replica preset).
    # Differs from "tp" in three deliberate ways:
    #   - "kv_heads" CAN shard: the paged KV pools shard on the kv-head
    #     axis, so the K/V projections must produce kv-head-sharded
    #     outputs to write into them locally (``serve_spec_for``'s
    #     validation replicates any dim the tensor axis does not
    #     divide, so small-GQA models degrade to replicated pools
    #     instead of failing);
    #   - batch replicated: a serving replica's slots are its own, the
    #     mesh buys per-device capacity, not batch splitting;
    #   - NO contraction dim is ever sharded: row-parallel kernels
    #     (attention o, MLP wo — anything whose logical axes end in
    #     "embed" with a tensor-sharded "heads"/"mlp" before it) FLIP
    #     to output-dim (embed) sharding. A row-parallel layout sums
    #     per-shard partial products — a different float reduction
    #     order than one device, which would break the serving engine's
    #     token-exactness contract. Output-dim sharding keeps every
    #     arithmetic reduction whole on one device; all cross-device
    #     traffic is all-gather — pure data movement, bitwise.
    "serve": {
        "batch": None,
        "heads": TENSOR, "kv_heads": TENSOR, "mlp": TENSOR,
        "vocab": TENSOR, "expert": EXPERT,
        "seq": None, "embed": None, "kv": None, "layers": None,
    },
}

# logical names that mark a column-parallel kernel's OUTPUT-turned-
# contraction dim in the row-parallel sibling (o consumes heads, wo
# consumes mlp) — the serve preset flips these to embed-sharded
_SERVE_FLIP_AXES = ("heads", "kv_heads", "mlp")


# ------------------------------------------------------------ trees
# The port's trees are dicts (a model's state_dict is flat; caches
# nest). Dicts flatten in sorted key order, as jax.tree does.


def _map(fn, tree, *rest, is_leaf=None, path=()):
    if is_leaf is not None and is_leaf(tree):
        return fn(path, tree, *rest)
    if isinstance(tree, dict):
        return {k: _map(fn, tree[k], *(r[k] for r in rest),
                        is_leaf=is_leaf, path=path + (k,))
                for k in tree}
    if isinstance(tree, (list, tuple)) and not isinstance(
            tree, PartitionSpec):
        return type(tree)(_map(fn, t, *(r[i] for r in rest),
                               is_leaf=is_leaf, path=path + (i,))
                          for i, t in enumerate(tree))
    return fn(path, tree, *rest)


def _leaves(tree, is_leaf=None) -> list:
    if is_leaf is not None and is_leaf(tree):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k], is_leaf)]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves(t, is_leaf)]
    return [tree]


def spec_for(logical_axes: tuple[str | None, ...],
             rules: dict[str, Any]) -> PartitionSpec:
    """PartitionSpec from per-dimension logical names."""
    parts = []
    for name in logical_axes:
        if name is None:
            parts.append(None)
        else:
            parts.append(rules.get(name))
    return P(*parts)


def tree_shardings(mesh, logical_tree: Any, preset: str) -> Any:
    """Map a tree of logical-axis tuples to NamedShardings."""
    rules = RULES[preset]
    return _map(lambda _, axes: NamedSharding(mesh, spec_for(axes, rules)),
                logical_tree, is_leaf=lambda x: isinstance(x, tuple))


def shard_params_by_size(mesh, params: Any, axis: str = FSDP,
                         min_size: int = 2**14) -> Any:
    """Heuristic FSDP sharding for arbitrary param trees (when a model has
    no logical annotations): shard each large array along its largest
    dimension divisible by the axis size; replicate the rest."""
    n = mesh.shape.get(axis, 1)

    def spec(_, x):
        shape = tuple(x.shape)
        size = int(np.prod(shape))
        if n <= 1 or size < min_size:
            return NamedSharding(mesh, P())
        dims = sorted(range(len(shape)), key=lambda d: -shape[d])
        for d in dims:
            if shape[d] % n == 0:
                parts: list = [None] * len(shape)
                parts[d] = axis
                return NamedSharding(mesh, P(*parts))
        return NamedSharding(mesh, P())

    return _map(spec, params)


def batch_sharding(mesh) -> NamedSharding:
    """Inputs: batch dim sharded over (data, fsdp)."""
    axes = tuple(a for a in (DATA, FSDP) if mesh.shape.get(a, 1) > 1)
    return NamedSharding(mesh, P(axes if axes else None))


def replicated(mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def validated_spec(mesh, spec: PartitionSpec, shape: tuple) -> PartitionSpec:
    """Drop per-dim assignments the dim size does not divide — the
    shape-safe fallback (replicating that dim is always correct)."""
    parts = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for dim, assignment in zip(shape, parts):
        n = _axis_size(mesh, assignment)
        out.append(assignment if n > 1 and dim % n == 0 else None)
    return P(*out)


def serve_spec_for(logical_axes: tuple, rules: dict[str, Any]) -> PartitionSpec:
    """``spec_for`` plus the serve preset's row-parallel FLIP: a kernel
    whose logical axes END in "embed" with a tensor-sharded
    "heads"/"kv_heads"/"mlp" before it (attention o, MLP/MoE wo, and
    their int8 twins) moves its sharding to the trailing embed (output)
    dim, so every reduction stays whole on one device."""
    parts = [rules.get(name) if name is not None else None
             for name in logical_axes]
    if len(parts) >= 2 and logical_axes[-1] == "embed":
        flip = [i for i, name in enumerate(logical_axes[:-1])
                if name in _SERVE_FLIP_AXES and parts[i] == TENSOR]
        if flip:
            for i in flip:
                parts[i] = None
            parts[-1] = TENSOR
    return P(*parts)


def _kv_leaf_head_axis(path, leaf) -> int | None:
    """kv-head axis of a serving-cache leaf, by the cache name
    contract: KV buffers are [..., pages|b, len, kvh, dh], scales
    [..., pages|b, len, kvh]. None = not a KV leaf (shared counters) —
    replicated."""
    name = str(path[-1]) if path else ""
    ndim = len(leaf.shape)
    if name in ("cached_key", "cached_value"):
        return ndim - 2
    if name in ("cached_key_scale", "cached_value_scale"):
        return ndim - 1
    return None


def kv_cache_shardings(mesh, cache: Any, axis: str = TENSOR) -> Any:
    """NamedShardings for a serving KV cache tree (paged pools or
    fixed-shape rows): every KV leaf shards its KV-HEAD dim over
    ``axis``; the page/batch and position dims stay whole, so page
    tables and the allocator are untouched. Leaves whose kv-head count
    the axis does not divide replicate, as do the position counters."""
    n = mesh.shape.get(axis, 1)

    def spec(path, leaf):
        ax = _kv_leaf_head_axis(path, leaf)
        if ax is None or n <= 1 or leaf.shape[ax] % n:
            return NamedSharding(mesh, P())
        parts: list = [None] * len(leaf.shape)
        parts[ax] = axis
        return NamedSharding(mesh, P(*parts))

    return _map(spec, cache)


def kv_shard_count(mesh, cache: Any, axis: str = TENSOR) -> int:
    """How many ways ``kv_cache_shardings`` actually splits the KV
    pools (1 = replicated fallback)."""
    n = mesh.shape.get(axis, 1)
    found = []
    _map(lambda path, leaf: found.append((path, leaf)), cache)
    for path, leaf in sorted(found, key=lambda pl: [str(p) for p in pl[0]]):
        ax = _kv_leaf_head_axis(path, leaf)
        if ax is not None:
            return n if n > 1 and leaf.shape[ax] % n == 0 else 1
    return 1


def _itemsize(leaf) -> int:
    if isinstance(leaf, torch.Tensor):
        return leaf.element_size()
    return np.dtype(leaf.dtype).itemsize


def tree_shard_bytes(tree: Any, shardings: Any) -> int:
    """PER-DEVICE bytes of ``tree`` placed under ``shardings`` — each
    leaf contributes its shard's bytes (replicated leaves their whole
    size)."""
    leaves = _leaves(tree)
    shards = _leaves(shardings, is_leaf=lambda x: isinstance(
        x, NamedSharding))
    total = 0
    for leaf, sh in zip(leaves, shards):
        shape = sh.shard_shape(tuple(leaf.shape))
        total += int(np.prod(shape)) * _itemsize(leaf)
    return total


def tree_shard_count(tree: Any, shardings: Any) -> int:
    """PER-DEVICE element count under ``shardings``."""
    leaves = _leaves(tree)
    shards = _leaves(shardings, is_leaf=lambda x: isinstance(
        x, NamedSharding))
    return sum(int(np.prod(sh.shard_shape(tuple(leaf.shape))))
               for leaf, sh in zip(leaves, shards))


# ------------------------------------------------- local shards


def place(full: torch.Tensor, sharding: NamedSharding) -> torch.Tensor:
    """This rank's shard of ``full``: each sharded dim cut at the rank's
    coordinate along the dim's axes, as a contiguous tensor of its own."""
    mesh = sharding.mesh
    view = full
    for d, assignment in enumerate(sharding.parts(full.ndim)):
        n = _axis_size(mesh, assignment)
        if n > 1:
            k = full.shape[d] // n
            view = view.narrow(d, mesh.axis_index(assignment) * k, k)
    sharding.shard_shape(tuple(full.shape))  # checks divisibility
    return view.clone(memory_format=torch.contiguous_format)


def gather(local: torch.Tensor, sharding: NamedSharding,
           out: torch.Tensor | None = None) -> torch.Tensor:
    """The whole tensor from every rank's ``local`` shard (all-gathers
    along each sharded dim); written into ``out`` when given."""
    from tony_tpu_torch.parallel.collectives import all_gather

    mesh = sharding.mesh
    whole = local
    for d, assignment in enumerate(sharding.parts(local.ndim)):
        if _axis_size(mesh, assignment) > 1:
            whole = all_gather(whole, assignment, mesh, axis=d)
    if out is None:
        return whole if whole is not local else local.clone()
    out.copy_(whole)
    return out
