"""Session: the coordinator's in-memory cluster-state model.

The PyTorch port's copy of ``tony_tpu/session/session.py``.

Reference: tensorflow/TonySession.java (633 LoC) — role->task arrays,
registration set, cluster-spec construction, chief semantics, and the
per-task exit-status -> final-application-status policy
(TonySession.java:262-398). Pure logic, no I/O: fully unit-testable.
"""

from __future__ import annotations

import enum
import logging
from dataclasses import dataclass, field

from tony_tpu_torch import constants as C
from tony_tpu_torch.config import TonyConf
from tony_tpu_torch.session.task import Task, TaskInfo, TaskStatus

log = logging.getLogger(__name__)


class SessionStatus(enum.Enum):
    RUNNING = "RUNNING"
    SUCCEEDED = "SUCCEEDED"
    FAILED = "FAILED"


@dataclass
class RoleRequest:
    """Resources for one role (ref: tensorflow/JobContainerRequest.java)."""

    role: str
    instances: int
    chips: int = 0
    memory: str = "2g"
    vcores: int = 1
    node_label: str = ""
    depends_on: list[str] = field(default_factory=list)
    command: str = ""

    @classmethod
    def from_conf(cls, conf: TonyConf, role: str) -> "RoleRequest":
        return cls(
            role=role,
            instances=int(conf.role_get(role, "instances")),
            chips=int(conf.role_get(role, "chips")),
            memory=str(conf.role_get(role, "memory")),
            vcores=int(conf.role_get(role, "vcores")),
            node_label=str(conf.role_get(role, "node-label"))
            or str(conf.get("tony.application.node-label", "")),
            depends_on=[
                s.strip()
                for s in str(conf.role_get(role, "depends-on")).split(",")
                if s.strip()
            ],
            command=str(conf.role_get(role, "command")),
        )


class Session:
    """Cluster state for one coordinator attempt (session epoch)."""

    def __init__(self, conf: TonyConf, session_id: int = 0):
        self.conf = conf
        self.session_id = session_id
        self.status = SessionStatus.RUNNING
        self.failure_reason: str | None = None
        # role -> list[Task | None], allocated lazily like the reference's
        # getAndInitMatchingTaskByPriority (TonySession.java:219)
        self.tasks: dict[str, list[Task | None]] = {}
        self.requests: dict[str, RoleRequest] = {}
        # expected tasks = instances of *scheduled* roles; the GANG gate
        # compares registrations against this, not the full config, so DAG
        # stages each form their own gang (ref: TonySession.numExpectedTasks
        # :69,204-210 incremented as the scheduler requests containers)
        self.num_expected = 0
        self.untracked = set(conf.get_list("tony.application.untracked.jobtypes"))
        self.sidecars = set(conf.get_list("tony.application.sidecar.jobtypes"))
        self.stop_on_failure = set(
            conf.get_list("tony.application.stop-on-failure.jobtypes")
        )
        self.fail_on_any_worker = conf.get_bool(
            "tony.application.fail-on-worker-failure-enabled"
        )
        for role in conf.roles():
            req = RoleRequest.from_conf(conf, role)
            self.requests[role] = req
            self.tasks[role] = [None] * req.instances

    # -- allocation ---------------------------------------------------------
    def init_task(self, role: str, index: int | None = None) -> Task | None:
        """Bind the next free slot of ``role`` (ref: TonySession.java:219)."""
        slots = self.tasks.get(role)
        if slots is None:
            return None
        if index is None:
            for i, t in enumerate(slots):
                if t is None:
                    index = i
                    break
            else:
                return None
        if index < 0 or index >= len(slots):
            return None
        if slots[index] is not None:
            return slots[index]
        task = Task(role=role, index=index, session_id=self.session_id)
        slots[index] = task
        return task

    def get_task(self, role: str, index: int) -> Task | None:
        slots = self.tasks.get(role)
        if slots is None or index < 0 or index >= len(slots):
            return None
        return slots[index]

    def has_slot(self, task_id: str) -> bool:
        """Whether ``task_id`` names a configured slot (allocated or not)."""
        role, _, idx = task_id.rpartition(":")
        slots = self.tasks.get(role)
        return slots is not None and idx.isdigit() and int(idx) < len(slots)

    def get_task_by_id(self, task_id: str) -> Task | None:
        role, _, idx = task_id.rpartition(":")
        if not role or not idx.isdigit():
            return None
        return self.get_task(role, int(idx))

    def all_tasks(self) -> list[Task]:
        return [t for slots in self.tasks.values() for t in slots if t is not None]

    # -- registration / spec (ref: getClusterSpec TonySession.java:237) -----
    def register(self, task_id: str, host_port: str) -> Task | None:
        task = self.get_task_by_id(task_id)
        if task is None:
            return None
        if task.completed:
            # late/duplicate registration must not erase a terminal status
            log.warning("ignoring registration for completed task %s", task_id)
            return None
        try:
            task.set_host_port(host_port)
        except ValueError:
            log.warning("rejecting malformed host:port %r from %s", host_port, task_id)
            return None
        task.registered = True
        task.status = TaskStatus.READY
        return task

    @property
    def total_expected(self) -> int:
        return sum(len(s) for s in self.tasks.values())

    @property
    def num_registered(self) -> int:
        return sum(1 for t in self.all_tasks() if t.registered)

    def add_expected(self, n: int) -> None:
        """Ref: TonySession.addNumExpectedTask :208."""
        self.num_expected += n

    def all_registered(self) -> bool:
        """All *scheduled* tasks registered (ref: MLGenericRuntime GANG gate
        compares getNumRegisteredTasks to getNumExpectedTasks :83-87)."""
        return self.num_expected > 0 and self.num_registered >= self.num_expected

    def cluster_spec(self) -> dict[str, list[str]]:
        """{role: ["host:port" per index]} — the rendezvous contract."""
        spec: dict[str, list[str]] = {}
        for role, slots in self.tasks.items():
            spec[role] = [
                t.host_port if t is not None and t.registered else "" for t in slots
            ]
        return spec

    # -- chief semantics (ref: TonySession.isChief :383) --------------------
    def is_chief(self, role: str, index: int) -> bool:
        """chief:0 if a chief role exists, else worker:0 (else master:0)."""
        if C.CHIEF_JOB_NAME in self.tasks:
            return role == C.CHIEF_JOB_NAME and index == 0
        if C.WORKER_JOB_NAME in self.tasks:
            return role == C.WORKER_JOB_NAME and index == 0
        if "master" in self.tasks:
            return role == "master" and index == 0
        # single-role jobs: index 0 of the first role is chief
        roles = list(self.tasks)
        return bool(roles) and role == roles[0] and index == 0

    def is_untracked(self, role: str) -> bool:
        return role in self.untracked or role in self.sidecars

    def is_sidecar(self, role: str) -> bool:
        return role in self.sidecars

    # -- completion policy (ref: TonySession.onTaskCompleted :262-349) ------
    def on_task_completed(self, role: str, index: int, exit_code: int) -> None:
        task = self.get_task(role, index)
        if task is None:
            log.warning("completion for unknown task %s:%s", role, index)
            return
        task.set_exit_status(exit_code)
        if exit_code == 0:
            return
        # failure policy short-circuits (ref: :276-285)
        if self.is_sidecar(role):
            log.info("sidecar %s:%d failed (exit %d); tolerated", role, index, exit_code)
            return
        if self.is_chief(role, index):
            self._fail(f"chief task {role}:{index} failed with exit code {exit_code}")
        elif role in self.stop_on_failure:
            self._fail(f"stop-on-failure role task {role}:{index} failed ({exit_code})")
        elif self.fail_on_any_worker and not self.is_untracked(role):
            self._fail(f"tracked task {role}:{index} failed ({exit_code})")
        elif self.is_untracked(role):
            # untracked non-sidecar failure fails the app fast
            # (ref: ApplicationMaster.java:1260-1264)
            self._fail(f"untracked task {role}:{index} failed ({exit_code})")

    def fail(self, reason: str) -> None:
        """External failure injection point: liveness expiry, registration
        timeout, startup failure (ref: onTaskDeemedDead / registrationTimeout
        / startupFailed in ApplicationMaster.java)."""
        self._fail(reason)

    def _fail(self, reason: str) -> None:
        if self.status == SessionStatus.RUNNING:
            self.status = SessionStatus.FAILED
            self.failure_reason = reason
            log.error("session failed: %s", reason)

    def tracked_tasks(self) -> list[Task]:
        return [t for t in self.all_tasks() if not self.is_untracked(t.role)]

    def training_finished(self) -> bool:
        """All tracked tasks reached a terminal state (ref: updateSessionStatus)."""
        tracked = [
            t
            for role, slots in self.tasks.items()
            if not self.is_untracked(role)
            for t in slots
        ]
        if not tracked:
            return False
        return all(t is not None and t.completed for t in tracked)

    def update_session_status(self) -> SessionStatus:
        """Final reducer (ref: TonySession.updateSessionStatus :295): succeed
        iff not already failed and at least one tracked task succeeded and no
        tracked task failed the policy above."""
        if self.status != SessionStatus.RUNNING:
            return self.status
        tracked = self.tracked_tasks()
        failed = [t for t in tracked if t.status == TaskStatus.FAILED]
        succeeded = [t for t in tracked if t.status == TaskStatus.FINISHED]
        if failed and not succeeded:
            self._fail(f"all tracked completions failed (e.g. {failed[0].id})")
        elif failed and self.fail_on_any_worker:
            self._fail(f"tracked task {failed[0].id} failed")
        elif succeeded:
            self.status = SessionStatus.SUCCEEDED
        else:
            self._fail("no tracked task succeeded")
        return self.status

    # -- views --------------------------------------------------------------
    def task_infos(self) -> list[TaskInfo]:
        infos = [t.to_info() for t in self.all_tasks()]
        infos.sort(key=lambda i: (i.attention, i.name, i.index))
        return infos
