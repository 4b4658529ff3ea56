"""Framework runtime SPI: the two-sided plugin interface.

The PyTorch port's copy of ``tony_tpu/runtime/base.py``.

Reference: Framework.java:33-67 — an AM-side adapter (cluster-spec
construction, start gating, config validation, callback-info sink) and an
executor-side adapter (env building + user-process exec). MLGenericRuntime
(runtime/MLGenericRuntime.java) supplies the shared GANG/FCFS gating and
exec logic; concrete runtimes mostly override ``build_task_env``.
"""

from __future__ import annotations

import json
import logging
import os
import time
from dataclasses import dataclass, field
from typing import Callable

from tony_tpu_torch import constants as C
from tony_tpu_torch.config import TonyConf
from tony_tpu_torch.session import Session
from tony_tpu_torch.utils import execute_shell

log = logging.getLogger(__name__)


@dataclass
class TaskContext:
    """Everything an executor-side adapter needs to build env + exec
    (ref: TaskExecutor fields handed to Framework.TaskExecutorAdapter)."""

    conf: TonyConf
    role: str
    index: int
    task_num: int
    is_chief: bool
    cluster_spec: dict[str, list[str]]  # role -> ["host:port", ...]
    command: str
    app_id: str = ""
    session_id: int = 0
    rdzv_port: int = -1
    tb_port: int = -1
    log_path: str | None = None
    workdir: str | None = None
    extra_env: dict[str, str] = field(default_factory=dict)
    # runtime-private payload the AM adapter attached to the cluster spec
    # under "__aux__" (ref: HorovodClusterSpec carried alongside the task
    # spec, runtime/HorovodRuntime.java:87-120)
    aux: dict = field(default_factory=dict)
    # channel back to the coordinator's receive_task_callback_info (ref:
    # TaskExecutor.callbackInfoToAM -> rpc registerCallbackInfo)
    callback_to_am: Callable[[str], None] | None = None

    def flat_index(self) -> int:
        """Global process index: offset of this role in config order + local
        index. Deterministic across hosts because cluster_spec preserves the
        conf's role order (the rendezvous contract)."""
        offset = 0
        for role, slots in self.cluster_spec.items():
            if role == self.role:
                return offset + self.index
            offset += len(slots)
        return self.index

    def total_tasks(self) -> int:
        return sum(len(s) for s in self.cluster_spec.values())


class AMAdapter:
    """Coordinator-side adapter (ref: Framework.ApplicationMasterAdapter +
    MLGenericRuntime.AM :57-144)."""

    def __init__(self) -> None:
        self.session: Session | None = None

    def set_session(self, session: Session) -> None:
        self.session = session

    def validate_and_update_config(self, conf: TonyConf) -> None:
        """Raise ConfError on illegal conf; may inject hidden roles
        (ref: validateAndUpdateConfig :100-124)."""

    def can_start_task(self, mode: str, task_id: str) -> bool:
        """GANG: gate until every task registered; FCFS: start immediately
        (ref: MLGenericRuntime.AM.canStartTask :79-99)."""
        assert self.session is not None
        if mode == C.FCFS:
            return True
        return self.session.all_registered()

    def construct_cluster_spec(self, task_id: str) -> str:
        """JSON spec handed to a ready task (ref: :57-62)."""
        assert self.session is not None
        return json.dumps(self.session.cluster_spec())

    def receive_task_callback_info(self, task_id: str, info: str) -> None:
        """Ref: HorovodRuntime's driver callback; generic runtimes ignore."""

    def destroy(self) -> None:
        pass


class TaskAdapter:
    """Executor-side adapter (ref: Framework.TaskExecutorAdapter +
    MLGenericRuntime.Task :180-186)."""

    def need_reserve_rdzv_port(self, ctx_role: str, conf: TonyConf) -> bool:
        """Whether the agent should reserve a rendezvous port before
        registering (ref: rpcPort always reserved, TaskExecutor.java:89)."""
        return True

    def need_reserve_tb_port(self, ctx_role: str, is_chief: bool, conf: TonyConf) -> bool:
        """TensorBoard port policy: reserve on the chief, or on a sidecar
        ``tensorboard`` role's executor (ref: MLGenericRuntime :161-178)."""
        if ctx_role == C.TENSORBOARD_JOB_NAME:
            return True
        sidecars = conf.get_list("tony.application.sidecar.jobtypes")
        has_tb_role = C.TENSORBOARD_JOB_NAME in conf.roles()
        return is_chief and not (has_tb_role and C.TENSORBOARD_JOB_NAME in sidecars)

    def build_task_env(self, ctx: TaskContext) -> dict[str, str]:
        """Framework-specific rendezvous env. Base provides the common
        contract every runtime shares (ref: MLGenericRuntime base env:
        JOB_NAME/TASK_INDEX/TASK_NUM/CLUSTER_SPEC)."""
        env = {
            C.JOB_NAME: ctx.role,
            C.TASK_INDEX: str(ctx.index),
            C.TASK_NUM: str(ctx.task_num),
            C.IS_CHIEF: "true" if ctx.is_chief else "false",
            C.CLUSTER_SPEC: json.dumps(ctx.cluster_spec),
        }
        for pair in str(ctx.conf.get("tony.application.shell-env", "")).split(","):
            if "=" in pair:
                k, _, v = pair.partition("=")
                env[k.strip()] = v
        if ctx.workdir:
            env["TONY_PROFILE_DIR"] = os.path.join(
                ctx.workdir, "profiles", f"{ctx.role}-{ctx.index}")
        profiler_base = ctx.conf.get_int("tony.task.profiler-port", 0)
        if profiler_base > 0:  # unique per task on a shared host
            env["TONY_PROFILER_PORT"] = str(profiler_base + ctx.flat_index())
        if ctx.tb_port > 0:
            env[C.TB_PORT] = str(ctx.tb_port)
        tb_log_dir = str(ctx.conf.get("tony.application.tensorboard-log-dir", ""))
        if tb_log_dir:
            env[C.TB_LOG_DIR] = tb_log_dir
        return env

    def run(self, ctx: TaskContext) -> int:
        """Build env + exec the user process (ref: MLGenericRuntime.Task.run
        = buildTaskEnv + executorPythonShell -> Utils.executeShell)."""
        env = dict(ctx.extra_env)
        env.update(self.build_task_env(ctx))
        timeout_ms = ctx.conf.get_int("tony.task.executor.execution-timeout-ms", 0)
        log.info("exec [%s:%d]: %s", ctx.role, ctx.index, ctx.command)
        start = time.time()
        code = execute_shell(ctx.command, timeout_ms, env, ctx.log_path, ctx.workdir)
        log.info("[%s:%d] exited %d after %.1fs", ctx.role, ctx.index, code,
                 time.time() - start)
        return code


class Runtime:
    """One pluggable framework runtime (ref: AbstractFrameworkRuntime)."""

    name = "abstract"
    am_adapter_cls: type[AMAdapter] = AMAdapter
    task_adapter_cls: type[TaskAdapter] = TaskAdapter

    @classmethod
    def get_am_adapter(cls) -> AMAdapter:
        return cls.am_adapter_cls()

    @classmethod
    def get_task_adapter(cls) -> TaskAdapter:
        return cls.task_adapter_cls()
