from tony_tpu_torch.events.event import (
    Event,
    EventType,
    JobMetadata,
    application_finished,
    application_inited,
    session_resized,
    task_finished,
    task_started,
)
from tony_tpu_torch.events.handler import EventHandler

__all__ = [
    "Event",
    "EventType",
    "EventHandler",
    "JobMetadata",
    "application_finished",
    "application_inited",
    "session_resized",
    "task_finished",
    "task_started",
]
