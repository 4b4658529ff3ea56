"""Job-history event schema.

The PyTorch port's copy of ``tony_tpu/events/event.py``.

Reference: src/main/avro/*.avsc (Event, ApplicationInited, ApplicationFinished,
TaskStarted, TaskFinished + metadata) serialized as an Avro container file.
The rebuild uses JSON-lines with an explicit ``type`` tag — same record
fields, human-greppable, no Avro dependency in the image.
"""

from __future__ import annotations

import enum
import time
from dataclasses import asdict, dataclass, field
from typing import Any


class EventType(enum.Enum):
    APPLICATION_INITED = "APPLICATION_INITED"
    APPLICATION_FINISHED = "APPLICATION_FINISHED"
    TASK_STARTED = "TASK_STARTED"
    TASK_FINISHED = "TASK_FINISHED"
    # rebuild extra: elastic resize epochs (no reference analog)
    SESSION_RESIZED = "SESSION_RESIZED"


@dataclass
class Event:
    type: EventType
    payload: dict[str, Any]
    timestamp_ms: int = field(default_factory=lambda: int(time.time() * 1000))

    def to_dict(self) -> dict:
        return {
            "type": self.type.value,
            "timestamp": self.timestamp_ms,
            "event": self.payload,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Event":
        return cls(
            type=EventType(d["type"]),
            payload=d.get("event", {}),
            timestamp_ms=int(d.get("timestamp", 0)),
        )


def application_inited(app_id: str, num_tasks: int, host: str) -> Event:
    """Ref: ApplicationInited.avsc, emitted at ApplicationMaster.java:397-399."""
    return Event(EventType.APPLICATION_INITED,
                 {"applicationId": app_id, "numTasks": num_tasks, "host": host})


def application_finished(app_id: str, status: str, num_failed_tasks: int,
                         metrics: dict | None = None) -> Event:
    """Ref: ApplicationFinished.avsc, emitted at ApplicationMaster.java:427-430."""
    return Event(EventType.APPLICATION_FINISHED,
                 {"applicationId": app_id, "status": status,
                  "numFailedTasks": num_failed_tasks, "metrics": metrics or {}})


def task_started(role: str, index: int, host: str) -> Event:
    """Ref: TaskStarted.avsc, emitted at ApplicationMaster.java:1216-1221."""
    return Event(EventType.TASK_STARTED,
                 {"taskType": role, "taskIndex": index, "host": host})


def task_finished(role: str, index: int, status: str,
                  metrics: dict | None = None) -> Event:
    """Ref: TaskFinished.avsc, emitted at ApplicationMaster.java:1246-1258
    with TaskMonitor metrics attached."""
    return Event(EventType.TASK_FINISHED,
                 {"taskType": role, "taskIndex": index, "status": status,
                  "metrics": metrics or {}})


@dataclass
class JobMetadata:
    """Ref: models/JobMetadata.java (143 LoC)."""

    id: str
    user: str
    started: int
    completed: int = -1
    status: str = "RUNNING"
    conf_path: str = ""

    def to_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "JobMetadata":
        return cls(**{k: d[k] for k in
                      ("id", "user", "started", "completed", "status", "conf_path")
                      if k in d})


def session_resized(app_id: str, new_session_id: int,
                    sizes: dict[str, int]) -> Event:
    """Elastic resize epoch (rebuild extra; reference stubs elasticity)."""
    return Event(EventType.SESSION_RESIZED,
                 {"applicationId": app_id, "sessionId": new_session_id,
                  "sizes": dict(sizes)})
