"""Ray runtime: head + workers discovering each other via CLUSTER_SPEC.

The PyTorch port's copy of ``tony_tpu/runtime/ray_runtime.py``.

Reference: tony-examples/ray-on-tony (README.md:17-41 + discovery.py) runs
ray as plain TonY roles with custom commands, reading the CLUSTER_SPEC env
to find the head. Promoted here to a first-class runtime: the head's
address is exported directly so worker commands can
``ray start --address=$RAY_HEAD_ADDRESS``.
"""

from __future__ import annotations

from tony_tpu_torch.config import ConfError, TonyConf
from tony_tpu_torch.runtime.base import AMAdapter, Runtime, TaskAdapter, TaskContext

HEAD = "head"


class RayAMAdapter(AMAdapter):
    def validate_and_update_config(self, conf: TonyConf) -> None:
        roles = conf.roles()
        if HEAD not in roles:
            raise ConfError("ray runtime requires a 'head' role")
        if int(conf.role_get(HEAD, "instances")) != 1:
            raise ConfError("ray runtime requires exactly one head instance")


class RayTaskAdapter(TaskAdapter):
    def build_task_env(self, ctx: TaskContext) -> dict[str, str]:
        env = super().build_task_env(ctx)
        head = ctx.cluster_spec.get(HEAD)
        if head and head[0]:
            env["RAY_HEAD_ADDRESS"] = head[0]
            host, _, port = head[0].rpartition(":")
            env["RAY_HEAD_IP"] = host
            env["RAY_HEAD_PORT"] = port
        return env


class RayRuntime(Runtime):
    name = "ray"
    am_adapter_cls = RayAMAdapter
    task_adapter_cls = RayTaskAdapter
