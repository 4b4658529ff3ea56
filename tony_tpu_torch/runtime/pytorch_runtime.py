"""PyTorch runtime: DDP env rendezvous.

The PyTorch port's copy of ``tony_tpu/runtime/pytorch_runtime.py``.

Reference: runtime/PyTorchRuntime.java:45-57 + Utils.parseClusterSpecForPytorch
(util/Utils.java:598-609): INIT_METHOD = tcp://<worker:0 host:port>, RANK =
this task's flat index, WORLD = total task count.
"""

from __future__ import annotations

from tony_tpu_torch import constants as C
from tony_tpu_torch.runtime.base import Runtime, TaskAdapter, TaskContext


class PyTorchTaskAdapter(TaskAdapter):
    def build_task_env(self, ctx: TaskContext) -> dict[str, str]:
        env = super().build_task_env(ctx)
        worker0 = None
        slots = ctx.cluster_spec.get(C.WORKER_JOB_NAME)
        if slots and slots[0]:
            worker0 = slots[0]
        else:  # single-role jobs under other names
            for s in ctx.cluster_spec.values():
                if s and s[0]:
                    worker0 = s[0]
                    break
        if worker0:
            env[C.PT_INIT_METHOD] = f"tcp://{worker0}"
            # torchrun-style aliases for scripts using MASTER_ADDR/PORT
            host, _, port = worker0.rpartition(":")
            env["MASTER_ADDR"] = host
            env["MASTER_PORT"] = port
        env[C.PT_RANK] = str(ctx.flat_index())
        env[C.PT_WORLD] = str(ctx.total_tasks())
        env["WORLD_SIZE"] = str(ctx.total_tasks())
        return env


class PyTorchRuntime(Runtime):
    name = "pytorch"
    task_adapter_cls = PyTorchTaskAdapter
