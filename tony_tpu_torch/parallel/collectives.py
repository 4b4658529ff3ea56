"""Named-axis collectives on local tensors: the counterpart of
``tony_tpu/parallel/collectives.py``.

The JAX helpers run inside ``shard_map`` over a named mesh axis; these
run in every rank's process over the process group of one named mesh
dim, or of a tuple of dims (``Mesh.axis_group``), on the rank's local
tensor, and return a new tensor. Shards are laid out in the flattened
coordinate order of the axes, as JAX lays them out. Gathers and
scatters work along any dim: the tensor is cut along it and the result
is contiguous.

Transport. ``gloo`` runs the collectives on CUDA tensors itself (it
copies them to the host inside the call): read on an H100 with torch
2.11 by ``tests/torch_gloo_cuda_probe.py``, all-reduce, all-gather,
reduce-scatter and broadcast give the right result. Its send/recv
aborts the process on a CUDA tensor (gloo writes from the device
pointer), so ``ring_shift`` on a gloo group stages CUDA tensors through
page-locked host buffers: copied off the card, sent and received on the
host, copied back. ``nccl`` takes every collective on the card. The
compute stays on the card either way; the host only carries the bytes.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _pinned(t: torch.Tensor) -> torch.Tensor:
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    return host


def _order(group, members: list) -> list[int]:
    """For each rank of ``group`` (in the group's own order), its
    position in ``members`` (the flattened coordinate order)."""
    ranks = dist.get_process_group_ranks(group)
    return [members.index(r) for r in ranks]


def all_reduce_sum(x: torch.Tensor, axis_name, mesh) -> torch.Tensor:
    group, _ = mesh.axis_group(axis_name)
    out = x.clone(memory_format=torch.contiguous_format)
    if group is not None:
        dist.all_reduce(out, group=group)
    return out


def all_reduce_mean(x: torch.Tensor, axis_name, mesh) -> torch.Tensor:
    """Gradient averaging for data parallelism (the Horovod-ring
    analog): the sum, then divided by the ranks."""
    return all_reduce_sum(x, axis_name, mesh) / mesh.axis_size(axis_name)


def all_gather(x: torch.Tensor, axis_name, mesh, axis: int = 0,
               tiled: bool = True) -> torch.Tensor:
    """Every rank's ``x`` in coordinate order: concatenated along
    ``axis`` (``tiled``) or stacked on a new ``axis``."""
    group, members = mesh.axis_group(axis_name)
    x = x.contiguous()
    if group is None:
        parts = [x]
    else:
        got = [torch.empty_like(x) for _ in members]
        dist.all_gather(got, x, group=group)
        parts = [None] * len(members)
        for i, t in zip(_order(group, members), got):
            parts[i] = t
    if tiled:
        return torch.cat(parts, dim=axis)
    return torch.stack(parts, dim=axis)


def reduce_scatter(x: torch.Tensor, axis_name, mesh,
                   axis: int = 0) -> torch.Tensor:
    """The sum over the ranks of ``x``, cut along ``axis`` into one
    piece a rank: this rank keeps the piece at its coordinate."""
    group, members = mesh.axis_group(axis_name)
    if group is None:
        return x.clone(memory_format=torch.contiguous_format)
    n = len(members)
    if x.shape[axis] % n:
        raise ValueError(f"dim {axis} of {tuple(x.shape)} does not split "
                         f"into {n} pieces")
    pieces = [p.contiguous() for p in torch.chunk(x, n, dim=axis)]
    inputs = [pieces[i] for i in _order(group, members)]
    out = torch.empty_like(inputs[0])
    dist.reduce_scatter(out, inputs, group=group)
    return out


def ring_shift(x: torch.Tensor, axis_name, mesh,
               shift: int = 1) -> torch.Tensor:
    """Rotate shards around the axis ring: the rank at coordinate c
    receives the shard of coordinate c - shift (the building block of
    ring attention and pipeline flow)."""
    group, members = mesh.axis_group(axis_name)
    x = x.contiguous()
    if group is None:
        return x.clone()
    n = len(members)
    me = mesh.axis_index(axis_name)
    # gloo's send/recv aborts on a CUDA tensor (the probe): stage it
    staged = x.is_cuda and dist.get_backend(group) == "gloo"
    src = _pinned(x) if staged else x
    out = torch.empty_like(src)
    ops = [dist.P2POp(dist.isend, src, members[(me + shift) % n], group),
           dist.P2POp(dist.irecv, out, members[(me - shift) % n], group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return out.to(x.device) if staged else out


def grad_sync_tree(grads: dict, axis_name, mesh) -> dict:
    """The mean of every leaf of a gradient dict over ``axis_name``, in
    one all-reduce a dtype (the leaves packed into one buffer)."""
    out = {}
    by_dtype: dict = {}
    for name, g in grads.items():
        by_dtype.setdefault(g.dtype, []).append(name)
    for names in by_dtype.values():
        flat = torch.cat([grads[n].reshape(-1) for n in names])
        flat = all_reduce_mean(flat, axis_name, mesh)
        at = 0
        for n in names:
            k = grads[n].numel()
            out[n] = flat[at:at + k].view(grads[n].shape)
            at += k
    return {n: out[n] for n in grads}
