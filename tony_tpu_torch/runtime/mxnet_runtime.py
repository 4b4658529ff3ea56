"""MXNet runtime: DMLC parameter-server env.

The PyTorch port's copy of ``tony_tpu/runtime/mxnet_runtime.py``.

Reference: runtime/MXNetRuntime.java:44-66 + Utils.parseClusterSpecForMXNet
(util/Utils.java:610-633): resolves the ``scheduler`` role's host to an
address, sets DMLC_PS_ROOT_URI/PORT, server/worker counts, DMLC_ROLE,
DMLC_LOCAL=0.
"""

from __future__ import annotations

import socket

from tony_tpu_torch import constants as C
from tony_tpu_torch.config import ConfError, TonyConf
from tony_tpu_torch.runtime.base import AMAdapter, Runtime, TaskAdapter, TaskContext

SCHEDULER = "scheduler"
SERVER = "server"


class MXNetAMAdapter(AMAdapter):
    def validate_and_update_config(self, conf: TonyConf) -> None:
        roles = conf.roles()
        if SCHEDULER in roles and int(conf.role_get(SCHEDULER, "instances")) > 1:
            raise ConfError("mxnet runtime allows at most one scheduler")


class MXNetTaskAdapter(TaskAdapter):
    def build_task_env(self, ctx: TaskContext) -> dict[str, str]:
        env = super().build_task_env(ctx)
        sched = ctx.cluster_spec.get(SCHEDULER)
        if sched and sched[0]:
            host, _, port = sched[0].rpartition(":")
            try:
                host = socket.gethostbyname(host)  # ref resolves to IP
            except OSError:
                pass
            env[C.MX_DMLC_PS_ROOT_URI] = host
            env[C.MX_DMLC_PS_ROOT_PORT] = port
        env[C.MX_DMLC_ROLE] = ctx.role
        env[C.MX_DMLC_NUM_SERVER] = str(len(ctx.cluster_spec.get(SERVER, [])))
        env[C.MX_DMLC_NUM_WORKER] = str(len(ctx.cluster_spec.get(C.WORKER_JOB_NAME, [])))
        env[C.MX_DMLC_LOCAL] = "0"
        return env


class MXNetRuntime(Runtime):
    name = "mxnet"
    am_adapter_cls = MXNetAMAdapter
    task_adapter_cls = MXNetTaskAdapter
