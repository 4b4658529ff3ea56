"""The rendezvous contract on the port: initialize ``torch.distributed``
over gloo from the injected env, build the default 1-D mesh, all_reduce
each rank's ``rank + 1`` and check the sum on every rank (the counterpart
of ``tests/scripts/check_jax_psum.py``). Exits non-zero on any
mismatch."""

import sys

import torch
import torch.distributed as dist

from tony_tpu_torch import distributed

spec = distributed.initialize(timeout_s=120, device="cpu")
if spec is None:
    print("not in a gang")
    sys.exit(5)
n = spec["num_processes"]
if not dist.is_initialized() or dist.get_world_size() != n \
        or dist.get_rank() != spec["process_id"]:
    print("bad process group", dist.is_initialized(), spec)
    sys.exit(6)
mesh = distributed.default_mesh(device="cpu")
if mesh.mesh_dim_names != ("data",) or mesh.size() != n:
    print("bad mesh", mesh)
    sys.exit(7)
t = torch.tensor([float(spec["process_id"] + 1)])
dist.all_reduce(t)
if t.item() != n * (n + 1) / 2:
    print("bad global sum", t.item())
    sys.exit(8)
print("global sum ok:", t.item())
sys.exit(0)  # initialize's exit handler tears the group down
