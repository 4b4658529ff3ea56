"""Fused AdamW: one pass over (grad, param, mu, nu) a leaf, as a CUDA
kernel for Hopper (``csrc/adamw.cu``) beside its plain PyTorch version.

Counterpart of ``tony_tpu/ops/adamw.py``: ``FusedAdamW`` (the config),
``FusedAdamWState`` (count, mu, nu, compute_params) and
``fused_adamw_update``, with the same math (``optax.adamw`` in fp32: bias
correction by count + 1, decoupled weight decay, a callable learning rate
evaluated at the pre-increment count), reduced-precision moments
(``moment_dtype``) and the compute-dtype copy of the params written by
the same pass. Params, grads and moments are dicts of tensors keyed
alike (a model's ``state_dict`` names); params are fp32 masters.

Differences from the JAX module, each deliberate:
- On the GPU every float leaf goes through the kernel. The JAX package
  sends a leaf to its Pallas kernel only above
  ``TONY_FUSED_ADAMW_MIN_ELEMS`` (default 2^62, i.e. never: a v5e
  measurement of the fixed cost of a ``pallas_call`` that does not carry
  over to this card). Here the leaves are grouped by dtypes and each
  group is one multi-tensor launch, so a step costs a launch or two,
  not one a leaf. The plain version runs only on CPU tensors.
- The update is in place: params, moments and the compute copies are
  written where they lie, and the compute copy may be a model's own
  parameter (``Trainer`` writes it straight into the module).
- lr, c1 and c2 reach the kernel in a 3-float device tensor, as the JAX
  ``hyp`` operand does: no host sync. A schedule (``learning_rate`` a
  callable of ``count``) that returns a Python number is refused inside
  a CUDA-graph capture, which would bake the number in.
- The step count advances in place, so a captured call (the training
  step, replayed as a CUDA graph) reads the count the previous replay
  wrote; a device table missed inside a capture raises (its upload
  would be replayed from freed page-locked memory), and a table hit
  inside one is held past the cache's eviction (``_captured``): the
  graph reads it on every replay.
- A non-float leaf carries its updated value into the compute copy, as
  the JAX package's does (``tony_tpu/ops/adamw.py:262-266``).
- Sharded (``mesh`` and ``param_specs``): the JAX function runs a sharded
  leaf's kernel under ``shard_map`` on each device's shard of a global
  array. A rank of the port holds only its shard (``parallel.sharding.
  place``), so the leaves it is given are local: a sharded leaf's
  gradient, master, moments and compute copy are its contiguous local
  shards (never a strided view of a whole tensor: a shard along a
  non-leading dim is not one), updated by the same one-launch-per-dtype
  table as the replicated leaves. The whole leaf's element count is the
  local count times every named axis of each spec entry, a tuple entry
  counting each of its axes (:232-241); ``fused_adamw_update.elements``
  records both sums of the last call.
"""

from __future__ import annotations

import ctypes
from collections import OrderedDict
from typing import Any, NamedTuple

import numpy as np
import torch

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


class FusedAdamWState(NamedTuple):
    count: torch.Tensor  # int32 step counter, on the params' device
    mu: Any
    nu: Any
    # the compute-dtype copy of the params, written by the same pass as
    # the fp32 master (None when the caller runs full precision)
    compute_params: Any = None


class FusedAdamW(NamedTuple):
    """AdamW config consumed by ``fused_adamw_update`` and recognised by
    ``train.Trainer`` as the fused-optimizer flag. Hyperparameters mirror
    ``optax.adamw``; ``moment_dtype`` (e.g. ``torch.bfloat16``) stores
    mu/nu at reduced precision."""

    learning_rate: Any = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 1e-4
    moment_dtype: Any = None

    def init(self, params: dict, compute_dtype=None) -> FusedAdamWState:
        def zeros():
            return {n: torch.zeros_like(p, dtype=self.moment_dtype or p.dtype)
                    for n, p in params.items()}

        compute = None
        if compute_dtype is not None:
            compute = {n: p.to(compute_dtype) if p.is_floating_point()
                       else p.clone() for n, p in params.items()}
        dev = next(iter(params.values())).device
        return FusedAdamWState(
            count=torch.zeros((), dtype=torch.int32, device=dev),
            mu=zeros(), nu=zeros(), compute_params=compute)


def _hyper(opt: FusedAdamW, count: torch.Tensor):
    """(lr, c1, c2) as fp32 device scalars, computed where count lies."""
    dev = count.device

    def const(x):  # filled on the device: a host-to-device copy would sync
        return torch.full((), x, dtype=torch.float32, device=dev)

    t = (count + 1).to(torch.float32)
    c1 = const(1.0) / (const(1.0) - torch.pow(const(opt.b1), t))
    c2 = const(1.0) / (const(1.0) - torch.pow(const(opt.b2), t))
    lr = opt.learning_rate(count) if callable(opt.learning_rate) \
        else opt.learning_rate
    if callable(opt.learning_rate) and not torch.is_tensor(lr) \
            and _capturing(dev):
        raise ValueError("a learning-rate schedule inside a CUDA-graph "
                         "capture must return a tensor computed from "
                         "count on the device, not a Python number")
    lr = lr.to(device=dev, dtype=torch.float32) if torch.is_tensor(lr) \
        else const(float(lr))
    return lr, c1, c2


def _capturing(dev: torch.device) -> bool:
    """Whether the current stream of ``dev`` is being captured."""
    return dev.type == "cuda" and torch.cuda.is_current_stream_capturing()


def leaf_update_reference(g, p, mu, nu, lr, c1, c2, *, b1, b2, eps, wd,
                          copy=None) -> None:
    """The plain version of the kernel on one leaf, in place: the same
    fp32 operations in the same order, each rounded on its own."""
    omb1, omb2 = 1.0 - b1, 1.0 - b2
    g32 = g.to(torch.float32)
    mu_n = mu.to(torch.float32) * b1 + g32 * omb1
    nu_n = nu.to(torch.float32) * b2 + (g32 * omb2) * g32
    p32 = p.to(torch.float32)
    upd = (mu_n * c1) / (torch.sqrt(nu_n * c2) + eps) + p32 * wd
    p_new = p32 - lr * upd
    p.copy_(p_new.to(p.dtype))
    mu.copy_(mu_n.to(mu.dtype))
    nu.copy_(nu_n.to(nu.dtype))
    if copy is not None:
        copy.copy_(p_new.to(copy.dtype) if copy.is_floating_point()
                   else p)


# the kernel's constants (csrc/adamw.cu), mirrored for the tables; the
# loaded library is checked against them
CHUNK = 65536  # elements a chunk of the table
VEC = 4  # elements a vector load
_TABLE_CACHE = 8  # device tables kept, by the group's pointers and sizes


def _kernel():
    from tony_tpu_torch.ops import _build

    lib = _build.load("adamw")
    fn = lib.tony_adamw
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3 \
            + [ctypes.c_int, ctypes.c_void_p] + [ctypes.c_float] * 6 \
            + [ctypes.c_void_p]
        lib.tony_adamw_chunk.restype = ctypes.c_longlong
        if (lib.tony_adamw_chunk(), lib.tony_adamw_vec()) != (CHUNK, VEC):
            raise RuntimeError("csrc/adamw.cu and ops/adamw.py disagree on "
                               "CHUNK or VEC")
    return fn, CHUNK


def vector_head(arrays: list[tuple[int, int]]) -> int:
    """The first element at which every array of a leaf, given as (data
    pointer, element size), sits on a VEC-element boundary: the start of
    the kernel's vector body. -1 when no element does (arrays misaligned
    against each other); the whole leaf then takes the scalar loop."""
    heads = {(-(ptr // size)) % VEC for ptr, size in arrays}
    if len(heads) != 1 or any(ptr % size for ptr, size in arrays):
        return -1
    return heads.pop()


def chunk_table(sizes, heads) -> tuple[np.ndarray, np.ndarray]:
    """(leaf, offset) of every chunk of a group: a leaf of n elements
    with vector head h takes max(1, ceil((n - h) / CHUNK)) chunks (none
    if n is 0), at offsets 0, CHUNK, 2 CHUNK, ... (see ``chunk_span``)."""
    sizes = np.asarray(sizes, dtype=np.int64)
    h = np.maximum(np.asarray(heads, dtype=np.int64), 0)
    counts = np.where(sizes > 0,
                      np.maximum(1, -(-(sizes - h) // CHUNK)), 0)
    n_chunks = int(counts.sum())
    leaf_of = np.repeat(np.arange(len(sizes), dtype=np.int64), counts)
    first = np.cumsum(counts) - counts
    offset = (np.arange(n_chunks, dtype=np.int64) - first[leaf_of]) * CHUNK
    return leaf_of, offset


def chunk_span(offset: int, head: int, n: int) -> tuple[int, int, int, int]:
    """The kernel's split of one chunk of a leaf (n elements, vector head
    ``head`` or -1): (start, vector start, whole vectors, end). The
    chunk covers [start, end); [start, vector start) and what follows
    the vectors run the scalar loop."""
    h = max(head, 0)
    start = 0 if offset == 0 else offset + h
    end = min(offset + CHUNK + h, n)
    vs = max(start, h) if head >= 0 else start
    nv = (end - vs) // VEC if head >= 0 and end > vs else 0
    return start, vs, nv, end


_tables: OrderedDict = OrderedDict()
# the tables a CUDA graph captured, held for the graphs' lifetime
_captured: dict = {}


def _check_group(group: list) -> None:
    """The kernel's rules for one dtype group's leaves: fp32 masters,
    fp32/bf16 grads, moments and copies, one device and one shape a
    leaf, all contiguous."""
    g, p, mu, nu, c = group[0]
    if p.dtype != torch.float32:
        raise ValueError(f"fused AdamW keeps fp32 master params, got "
                         f"{p.dtype}")
    if g.dtype not in _DTYPE_CODES or mu.dtype not in _DTYPE_CODES \
            or nu.dtype != mu.dtype \
            or (c is not None and c.dtype not in _DTYPE_CODES):
        raise ValueError(f"fused AdamW takes fp32/bf16 grads, moments "
                         f"and copies, got {g.dtype}, {mu.dtype}, "
                         f"{nu.dtype}, {None if c is None else c.dtype}")
    for leaf in group:
        p = leaf[1]
        ts = [t for t in leaf if t is not None]
        if any(t.device != p.device for t in ts):
            raise ValueError("a leaf's grad, param, moments and copy must "
                             "share one device")
        if any(t.shape != p.shape or not t.is_contiguous() for t in ts):
            raise ValueError("fused AdamW needs contiguous leaves of one "
                             "shape")


def table_key(key: tuple, group: list) -> tuple[tuple, tuple]:
    """(cache key, words) of one dtype group: ``words`` holds each leaf's
    pointers and size, as the device table does; the key adds the shape
    of every array, so a key seen before names the very group that
    passed ``_check_group`` then (device pointers are unique across
    devices), but for contiguity, which a view at the same address can
    lose."""
    words = tuple((g.data_ptr(), p.data_ptr(), mu.data_ptr(), nu.data_ptr(),
                   0 if c is None else c.data_ptr(), p.numel())
                  for g, p, mu, nu, c in group)
    shapes = tuple(t.shape for leaf in group for t in leaf if t is not None)
    return (group[0][1].device, key, words, shapes), words


def _table(key: tuple, group: list) -> tuple[torch.Tensor, int]:
    """(device table, chunk count) for one launch, in one int64 tensor:
    seven words a leaf (its pointers, size and vector head, as ``Leaf``
    in the kernel), then each chunk's leaf, then each chunk's offset in
    its leaf. A table is kept by ``table_key``, which fixes all it holds
    and all ``_check_group`` checks but contiguity, so a step whose
    tensors did not move checks only that, and builds and uploads
    nothing; a new one goes up by one asynchronous copy from page-locked
    memory, so the host does not wait for the card."""
    key, words = table_key(key, group)
    hit = _tables.get(key)
    if hit is not None and all(t.is_contiguous() for leaf in group
                               for t in leaf if t is not None):
        _tables.move_to_end(key)
        if _capturing(group[0][1].device):
            # a graph reads this table on every replay: keep it alive
            # past the cache's eviction
            _captured[key] = hit
        return hit
    if _capturing(group[0][1].device):
        # a new table goes up by a copy from a page-locked buffer that
        # is freed after the call: a graph would replay that copy
        raise RuntimeError(
            "fused AdamW's device table missed its cache during a CUDA-"
            "graph capture: the first call at the graph's key must run on "
            "the same tensors (static gradient buffers)")
    _check_group(group)
    heads = [vector_head([(t.data_ptr(), t.element_size())
                          for t in leaf if t is not None]) for leaf in group]
    leaf_of, offset = chunk_table([w[5] for w in words], heads)
    leaves = np.array([w + (h,) for w, h in zip(words, heads)],
                      dtype=np.int64)
    host = torch.from_numpy(np.concatenate([leaves.ravel(), leaf_of,
                                            offset])).pin_memory()
    _tables[key] = hit = (host.to(key[0], non_blocking=True), len(leaf_of))
    if len(_tables) > _TABLE_CACHE:
        _tables.popitem(last=False)
    return hit


def _launch_groups(opt: FusedAdamW, items: list, hyp: torch.Tensor) -> None:
    """One kernel launch per (grad, moment, copy) dtype group of float
    leaves on the GPU."""
    groups: dict[tuple, list] = {}
    for leaf in items:
        g, p, mu, nu, c = leaf
        key = (g.dtype, p.dtype, mu.dtype, nu.dtype,
               None if c is None else c.dtype)
        groups.setdefault(key, []).append(leaf)
    if not groups:
        return
    fn = _kernel()[0]
    omb1, omb2 = 1.0 - opt.b1, 1.0 - opt.b2
    for key, group in groups.items():
        table, n_chunks = _table(key, group)
        gdt, _, mdt, _, cdt = key
        at = table.data_ptr()
        chunk_leaf = at + 8 * 7 * len(group)
        err = fn(_DTYPE_CODES[gdt], _DTYPE_CODES[mdt],
                 -1 if cdt is None else _DTYPE_CODES[cdt], at, chunk_leaf,
                 chunk_leaf + 8 * n_chunks, n_chunks, hyp.data_ptr(), opt.b1,
                 opt.b2, omb1, omb2, opt.eps, opt.weight_decay,
                 torch.cuda.current_stream(table.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"fused AdamW kernel launch failed: CUDA "
                               f"error {err}")
        fused_adamw_update.launches += 1


def fused_adamw_update(opt: FusedAdamW, grads: dict, state: FusedAdamWState,
                       params: dict, *, mesh=None, param_specs=None,
                       compute_dtype=None):
    """One fused AdamW step, in place: returns (params, state), the same
    param, moment and compute-copy tensors updated and ``state.count``
    advanced in place (the JAX function returns a new count; a CUDA
    graph that captured this call must see its count move).

    ``compute_dtype`` (JAX signature) asks for the compute copy;
    ``state.compute_params`` must then hold it (``FusedAdamW.init`` with
    the same dtype). A leaf present in ``state.compute_params`` gets its
    copy written whether or not ``compute_dtype`` is given, so a caller
    may point the copies at other tensors (a model's parameters). CUDA
    leaves run the kernel (``fused_adamw_update.launches`` counts the
    launches); CPU leaves and non-float leaves run the plain version.

    ``mesh`` and ``param_specs`` (name -> ``PartitionSpec``): the leaves
    of a spec that names an axis are this rank's local shards (the
    module docstring); the spec's axes must be the mesh's."""
    local, whole = 0, 0
    for name, p in params.items():
        n = p.numel()
        local += n
        whole += n * _shard_factor(mesh, None if param_specs is None
                                   else param_specs.get(name))
    fused_adamw_update.elements = (local, whole)
    if compute_dtype is not None and state.compute_params is None:
        raise ValueError("compute_dtype needs state.compute_params "
                         "(FusedAdamW.init(params, compute_dtype))")
    copies = state.compute_params or {}
    lr, c1, c2 = _hyper(opt, state.count)
    static = dict(b1=opt.b1, b2=opt.b2, eps=opt.eps, wd=opt.weight_decay)
    on_card = []
    for name, g in grads.items():
        p, mu, nu = params[name], state.mu[name], state.nu[name]
        c = copies.get(name)
        if p.device.type == "cuda" and p.is_floating_point():
            on_card.append((g, p, mu, nu, c))
        else:
            leaf_update_reference(g, p, mu, nu, lr.to(p.device),
                                  c1.to(p.device), c2.to(p.device),
                                  copy=c, **static)
    if on_card:
        hyp = torch.stack([lr, c1, c2]).to(on_card[0][1].device)
        _launch_groups(opt, on_card, hyp)
    # in place, so a CUDA graph's replay advances the count it reads
    state.count.add_(1)
    return params, state


fused_adamw_update.launches = 0
# (local, whole) elements of the last call's params: equal unless sharded
fused_adamw_update.elements = (0, 0)


def _shard_factor(mesh, spec) -> int:
    """How many shards a leaf of ``spec`` is cut into over ``mesh``: the
    product of every named axis of every entry, a tuple entry splitting
    its dim over each of its axes (``tony_tpu/ops/adamw.py:232-241``)."""
    if spec is None or not any(ax is not None for ax in spec):
        return 1
    if mesh is None:
        raise ValueError(f"param spec {spec} names axes but no mesh was "
                         "given")
    n = 1
    for ax in spec:
        if ax is None:
            continue
        for a in (ax if isinstance(ax, tuple) else (ax,)):
            if a not in mesh.shape:
                raise ValueError(f"param spec {spec} names {a!r}, not an "
                                 f"axis of the mesh {mesh.shape}")
            n *= mesh.shape[a]
    return n
