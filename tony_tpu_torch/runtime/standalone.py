"""Standalone runtime: single task, no rendezvous env.

The PyTorch port's copy of ``tony_tpu/runtime/standalone.py``.

Reference: runtime/StandaloneRuntime.java:29-101 — validate enforces exactly
one task instance total; no TB port, no framework env.
"""

from __future__ import annotations

from tony_tpu_torch.config import ConfError, TonyConf
from tony_tpu_torch.runtime.base import AMAdapter, Runtime, TaskAdapter, TaskContext


class StandaloneAMAdapter(AMAdapter):
    def validate_and_update_config(self, conf: TonyConf) -> None:
        total = sum(int(conf.role_get(r, "instances")) for r in conf.roles())
        if total != 1:
            raise ConfError(f"standalone runtime requires exactly 1 task, got {total}")


class StandaloneTaskAdapter(TaskAdapter):
    def need_reserve_rdzv_port(self, ctx_role: str, conf: TonyConf) -> bool:
        return False

    def need_reserve_tb_port(self, ctx_role: str, is_chief: bool, conf: TonyConf) -> bool:
        return False

    def build_task_env(self, ctx: TaskContext) -> dict[str, str]:
        return super().build_task_env(ctx)


class StandaloneRuntime(Runtime):
    name = "standalone"
    am_adapter_cls = StandaloneAMAdapter
    task_adapter_cls = StandaloneTaskAdapter
