"""JAX runtime: the flagship, TPU-native rendezvous.

The PyTorch port's copy of ``tony_tpu/runtime/jax_runtime.py``.

This is the in-tree replacement for the reference's HorovodRuntime + NCCL
path (runtime/HorovodRuntime.java, 357 LoC + HorovodDriver + rendezvous
server): on TPU there is no rendezvous *server* at all — the chief task's
registered host:port becomes the jax.distributed coordinator address, each
task's global process id is its flat index in the cluster spec, and all
collectives are XLA over ICI/DCN. The entire HorovodDriver/slot-plan
machinery collapses into env injection (SURVEY.md section 5.8).

User scripts call ``tony_tpu_torch.distributed.initialize()`` (reads this env) or
``jax.distributed.initialize()`` with the values below.
"""

from __future__ import annotations


from tony_tpu_torch import constants as C
from tony_tpu_torch.config import ConfError, TonyConf
from tony_tpu_torch.runtime.base import AMAdapter, Runtime, TaskAdapter, TaskContext


def coordinator_address(cluster_spec: dict[str, list[str]]) -> str:
    """The chief's host:port doubles as the jax coordinator address: chief
    role's task 0 if present, else the first role's task 0."""
    for role in (C.CHIEF_JOB_NAME, C.WORKER_JOB_NAME):
        slots = cluster_spec.get(role)
        if slots and slots[0]:
            return slots[0]
    for slots in cluster_spec.values():
        if slots and slots[0]:
            return slots[0]
    raise ValueError("empty cluster spec: no coordinator candidate")


class JaxAMAdapter(AMAdapter):
    def validate_and_update_config(self, conf: TonyConf) -> None:
        if conf.get("tony.application.distributed-mode") != C.GANG:
            # jax.distributed barrier-initializes: every process must attend
            raise ConfError("jax runtime requires GANG distributed mode")


def flat_slots(cluster_spec: dict[str, list[str]]) -> list[str]:
    """All host:port slots in flat-index order (the same role-order walk
    as TaskContext.flat_index — the two MUST agree for slice grouping)."""
    out: list[str] = []
    for slots in cluster_spec.values():
        out.extend(slots)
    return out


def multislice_env(conf, cluster_spec: dict[str, list[str]], pid: int,
                   num: int) -> dict[str, str]:
    """The real multi-slice Cloud TPU env contract (VERDICT r2 #4).

    A >1 ``tony.tpu.num-slices`` job groups its processes into contiguous
    equal slices: within a slice, collectives ride ICI; across slices,
    libtpu's megascale transport rides DCN, discovered via the
    ``MEGASCALE_*`` env (the TPU-native analog of the reference's
    NCCL/Gloo rendezvous env, SURVEY.md section 2.5):

    - ``MEGASCALE_COORDINATOR_ADDRESS``: slice-0 host 0 at the megascale
      port — every slice dials it to exchange DCN endpoints;
    - ``MEGASCALE_NUM_SLICES`` / ``MEGASCALE_SLICE_ID``: the DCN mesh
      shape, consumed by jax as ``jax.devices()[i].slice_index`` which
      ``parallel.mesh.multislice_mesh`` lays out over the dcn axis;
    - ``TPU_WORKER_HOSTNAMES`` / ``TPU_WORKER_ID``: libtpu's WITHIN-slice
      host list (ICI ring bring-up) — per slice, not global.
    """
    n_slices = conf.get_int("tony.tpu.num-slices", 1)
    if n_slices <= 1:
        return {}
    if num % n_slices:
        raise ConfError(
            f"tony.tpu.num-slices={n_slices} does not divide the "
            f"{num}-process gang into equal slices")
    per = num // n_slices
    slots = flat_slots(cluster_spec)
    hosts = [s.rsplit(":", 1)[0] for s in slots]
    mport = conf.get_int("tony.tpu.megascale-port", 8080)
    slice_id = pid // per
    return {
        "MEGASCALE_COORDINATOR_ADDRESS": f"{hosts[0]}:{mport}",
        "MEGASCALE_NUM_SLICES": str(n_slices),
        "MEGASCALE_SLICE_ID": str(slice_id),
        "TPU_WORKER_HOSTNAMES": ",".join(
            hosts[slice_id * per:(slice_id + 1) * per]),
        "TPU_WORKER_ID": str(pid % per),
    }


class JaxTaskAdapter(TaskAdapter):
    def build_task_env(self, ctx: TaskContext) -> dict[str, str]:
        env = super().build_task_env(ctx)
        addr = coordinator_address(ctx.cluster_spec)
        pid = ctx.flat_index()
        num = ctx.total_tasks()
        env[C.COORDINATOR_ADDRESS] = addr
        env[C.PROCESS_ID] = str(pid)
        env[C.NUM_PROCESSES] = str(num)
        # ICI-topology hints for multi-host TPU slices
        topology = str(ctx.conf.get("tony.tpu.topology", ""))
        if topology:
            env["TONY_TPU_TOPOLOGY"] = topology
        env.update(multislice_env(ctx.conf, ctx.cluster_spec, pid, num))
        return env


class JaxRuntime(Runtime):
    name = "jax"
    am_adapter_cls = JaxAMAdapter
    task_adapter_cls = JaxTaskAdapter
