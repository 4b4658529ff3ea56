"""The named device mesh: the counterpart of ``tony_tpu/parallel/mesh.py``.

The canonical axis names and ``MeshSpec`` are the JAX package's. A mesh
is a ``torch.distributed.device_mesh.DeviceMesh`` over the world's ranks
(each rank drives one device), its dims named in ``ALL_AXES`` order, the
outer axes the slower links. ``mesh.shape`` reads as the JAX ``Mesh``'s
does, a dict of axis sizes; ``mesh.devices`` is the array of ranks.

  data    - data parallelism (batch sharding; gradient sum)
  fsdp    - fully-sharded data parallelism (param/optimizer sharding)
  tensor  - tensor/model parallelism (head & mlp sharding)
  pipe    - pipeline stages
  seq     - sequence/context parallelism (ring attention)
  expert  - expert parallelism (MoE all-to-all)

A mesh over a world of one process (no process group) is a mesh of size
1 on its one device and talks to nobody. A mesh larger than the world
can be built without a process group too, for the spec math of
``sharding.py`` (as the JAX tests build meshes over virtual devices);
its collectives then raise. ``axis_group`` gives the process group of a
named axis or of a tuple of axes, with its members in the order of the
flattened coordinate (row-major over the axes as given), which is the
order in which ``collectives.py`` lays out shards.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

DATA, FSDP, TENSOR, PIPE, SEQ, EXPERT = "data", "fsdp", "tensor", "pipe", "seq", "expert"
ALL_AXES = (DATA, FSDP, TENSOR, PIPE, SEQ, EXPERT)


@dataclass
class MeshSpec:
    """Sizes per logical axis; -1 on exactly one axis means "absorb the
    remaining devices" (like a reshape wildcard)."""

    data: int = -1
    fsdp: int = 1
    tensor: int = 1
    pipe: int = 1
    seq: int = 1
    expert: int = 1

    def sizes(self) -> dict[str, int]:
        return {
            DATA: self.data,
            FSDP: self.fsdp,
            TENSOR: self.tensor,
            PIPE: self.pipe,
            SEQ: self.seq,
            EXPERT: self.expert,
        }

    def resolve(self, n_devices: int) -> dict[str, int]:
        sizes = self.sizes()
        wild = [a for a, s in sizes.items() if s == -1]
        if len(wild) > 1:
            raise ValueError(f"at most one wildcard axis, got {wild}")
        fixed = math.prod(s for s in sizes.values() if s != -1)
        if wild:
            if n_devices % fixed != 0:
                raise ValueError(
                    f"{n_devices} devices not divisible by fixed axes product {fixed}")
            sizes[wild[0]] = n_devices // fixed
        elif fixed != n_devices:
            raise ValueError(
                f"mesh axes product {fixed} != device count {n_devices}")
        return sizes


def _world() -> tuple[int, int]:
    """(rank, world size) of the default process group, or (0, 1)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class Mesh(DeviceMesh):
    """A ``DeviceMesh`` whose ``shape`` is a dict of axis sizes (the JAX
    ``Mesh``'s), with the process groups of axes and tuples of axes."""

    def __init__(self, ranks: np.ndarray, axis_names: tuple[str, ...],
                 device_type: str | None = None):
        ranks = np.asarray(ranks, dtype=np.int64)
        _, world = _world()
        # the world's groups exist only over a process group that the
        # mesh covers; otherwise the mesh is spec math (or one process)
        live = world > 1
        if live and ranks.size != world:
            raise ValueError(f"a mesh of {ranks.size} ranks over a world "
                             f"of {world}")
        # without a process group there is no rank to ask: name one
        kw = {} if live else {"_rank": int(ranks.flat[0])}
        super().__init__(device_type or "cuda",
                         torch.from_numpy(ranks), mesh_dim_names=axis_names,
                         _init_backend=live, **kw)
        self.axis_names = tuple(axis_names)
        self.devices = ranks
        self._sizes = dict(zip(self.axis_names, ranks.shape))
        self._live = live
        self._groups: dict[tuple, tuple] = {}

    @property
    def shape(self) -> dict[str, int]:  # the JAX Mesh's: name -> size
        return dict(self._sizes)

    def axis_size(self, axes) -> int:
        """Ranks along a name, a tuple of names, or None (1)."""
        if axes is None:
            return 1
        axes = axes if isinstance(axes, tuple) else (axes,)
        return math.prod(self._sizes.get(a, 1) for a in axes)

    def _rows(self, axes: tuple) -> np.ndarray:
        """Every group of ``axes`` as a row of ranks in flattened
        coordinate order (row-major over ``axes`` as given)."""
        dims = [self.axis_names.index(a) for a in axes
                if a in self.axis_names]
        rest = [d for d in range(self.devices.ndim) if d not in dims]
        moved = np.transpose(self.devices, rest + dims)
        return moved.reshape(-1, self.axis_size(axes))

    def axis_index(self, axes) -> int:
        """This rank's flattened coordinate along ``axes``."""
        if self.axis_size(axes) == 1:
            return 0
        axes = axes if isinstance(axes, tuple) else (axes,)
        rank, _ = _world()
        rows = self._rows(axes)
        where = np.argwhere(rows == rank)
        if len(where) != 1:
            raise RuntimeError(f"rank {rank} is not in this mesh")
        return int(where[0][1])

    def axis_group(self, axes):
        """(process group, members) of ``axes`` for this rank: the
        members are global ranks in flattened coordinate order. None for
        the group when the axes hold one rank. Every rank must ask for the
        same axes in the same order (a new group is collective)."""
        axes = axes if isinstance(axes, tuple) else (axes,)
        rank, _ = _world()
        if self.axis_size(axes) == 1:
            return None, [rank]
        if axes not in self._groups:
            if not self._live:
                raise RuntimeError(
                    "this mesh has no process group (a world of one "
                    "process): its collectives cannot run")
            import torch.distributed as dist

            mine = None
            named = [a for a in axes if self._sizes.get(a, 1) > 1]
            if len(named) == 1 and named[0] in self.axis_names:
                group = self.get_group(named[0])
                mine = (group, next(r.tolist() for r in self._rows(axes)
                                    if rank in r))
            else:
                for row in self._rows(axes):
                    group = dist.new_group(row.tolist())
                    if rank in row:
                        mine = (group, row.tolist())
            self._groups[axes] = mine
        return self._groups[axes]

    def __repr__(self) -> str:
        return f"Mesh({self._sizes})"


def make_mesh(spec: MeshSpec | None = None, devices=None,
              drop_trivial: bool = False, *,
              device_type: str | None = None) -> Mesh:
    """Build the named mesh over ``devices`` (ranks; default every rank of
    the world). Axis order is (data, fsdp, tensor, pipe, seq, expert):
    outer axes map to the slower links."""
    devices = list(devices if devices is not None else range(_world()[1]))
    spec = spec or MeshSpec()
    sizes = spec.resolve(len(devices))
    names = [a for a in ALL_AXES if not (drop_trivial and sizes[a] == 1)]
    shape = [sizes[a] for a in names]
    arr = np.array(devices).reshape(shape)
    return Mesh(arr, tuple(names), device_type)


def data_parallel_mesh(devices=None, *,
                       device_type: str | None = None) -> Mesh:
    devices = list(devices if devices is not None else range(_world()[1]))
    return Mesh(np.array(devices), (DATA,), device_type)


def mesh_axis_size(mesh: Mesh, axis: str) -> int:
    return mesh.shape.get(axis, 1)


# ---------------------------------------------------------------------------
# Multi-slice meshes. The JAX package's slices are TPU slices joined by
# DCN; here a slice is a group of ranks on fast links (a host's NVLink
# domain) joined by the network. Ranks carry no slice index, so a job
# names its slice count (``n_slices``), and consecutive groups of ranks
# stand for slices, stacked along ``dcn_axis`` (the JAX package's
# virtual-slice branch, which its tests and multichip dry run use).
# ---------------------------------------------------------------------------


def num_slices(devices=None) -> int:
    """Slices this job's ranks are detected to span: always 1 (a rank
    carries no slice index; pass ``n_slices`` to ``multislice_mesh``)."""
    return 1


def multislice_mesh(spec: MeshSpec | None = None, *, devices=None,
                    dcn_axis: str = DATA, n_slices: int | None = None,
                    device_type: str | None = None) -> Mesh:
    """Mesh whose ``dcn_axis`` additionally spans slices while every other
    axis stays within a slice. ``spec`` is resolved against the
    per-slice rank count, then ``dcn_axis`` is multiplied by the slice
    count: 2 slices of 16 ranks with MeshSpec(data=-1, tensor=4) give
    data=8 x tensor=4. One slice degenerates to ``make_mesh``."""
    devices = list(devices if devices is not None else range(_world()[1]))
    n = n_slices or num_slices(devices)
    spec = spec or MeshSpec()
    if n == 1:
        return make_mesh(spec, devices=devices, device_type=device_type)
    if len(devices) % n:
        raise ValueError(f"{len(devices)} devices not divisible into {n} slices")
    per_slice = len(devices) // n
    ici_sizes = spec.resolve(per_slice)
    axis_idx = ALL_AXES.index(dcn_axis)
    shape = [ici_sizes[a] for a in ALL_AXES]
    subs = [np.array(devices[i * per_slice:(i + 1) * per_slice])
            .reshape(shape) for i in range(n)]
    return Mesh(np.concatenate(subs, axis=axis_idx), ALL_AXES, device_type)
