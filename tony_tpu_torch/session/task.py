"""Task state: status enum, per-task record, client-visible TaskInfo.

The PyTorch port's copy of ``tony_tpu/session/task.py``.

Reference: rpc/impl/TaskStatus.java (attention-sorted order preserved below),
rpc/TaskInfo.java, TonySession.TonyTask (tensorflow/TonySession.java:436).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field


class TaskStatus(enum.IntEnum):
    """Ordered by display attention (ref: TaskStatus attention sort)."""

    FAILED = 0
    FINISHED = 1
    RUNNING = 2
    READY = 3
    NEW = 4

    @property
    def terminal(self) -> bool:
        return self in (TaskStatus.FAILED, TaskStatus.FINISHED)


@dataclass
class Task:
    """One task instance of a role (ref: TonySession.TonyTask)."""

    role: str
    index: int
    session_id: int = 0
    host: str = ""
    port: int = -1
    status: TaskStatus = TaskStatus.NEW
    exit_code: int | None = None
    registered: bool = False
    completed: bool = False
    log_url: str = ""
    metrics: dict[str, float] = field(default_factory=dict)

    @property
    def id(self) -> str:
        """Canonical "role:index" id (ref: task id format "job:idx")."""
        return f"{self.role}:{self.index}"

    @property
    def host_port(self) -> str:
        return f"{self.host}:{self.port}"

    def set_host_port(self, host_port: str) -> None:
        host, sep, port = host_port.rpartition(":")
        if not sep or not host or not port.isdigit():
            raise ValueError(f"malformed host:port: {host_port!r}")
        self.host = host
        self.port = int(port)

    def set_exit_status(self, exit_code: int) -> None:
        """Exit code -> status mapping (ref: TonySession.java:506-523)."""
        if self.completed:
            return
        self.completed = True
        self.exit_code = exit_code
        self.status = TaskStatus.FINISHED if exit_code == 0 else TaskStatus.FAILED

    def to_info(self) -> "TaskInfo":
        return TaskInfo(
            name=self.role,
            index=self.index,
            status=self.status.name,
            url=self.log_url,
            host=self.host,
            metrics=dict(self.metrics),
        )


@dataclass
class TaskInfo:
    """Client-facing task view (ref: rpc/TaskInfo.java)."""

    name: str
    index: int
    status: str
    url: str = ""
    host: str = ""
    metrics: dict[str, float] = field(default_factory=dict)

    @property
    def attention(self) -> int:
        return TaskStatus[self.status].value

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "index": self.index,
            "status": self.status,
            "url": self.url,
            "host": self.host,
            "metrics": self.metrics,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "TaskInfo":
        return cls(**d)
