from tony_tpu_torch.session.session import RoleRequest, Session, SessionStatus
from tony_tpu_torch.session.task import Task, TaskInfo, TaskStatus

__all__ = ["Session", "SessionStatus", "RoleRequest", "Task", "TaskInfo", "TaskStatus"]
