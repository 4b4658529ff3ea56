from tony_tpu_torch.runtime.base import AMAdapter, Runtime, TaskAdapter, TaskContext
from tony_tpu_torch.runtime.registry import (
    get_am_adapter,
    get_runtime,
    get_task_adapter,
    register,
)

__all__ = [
    "AMAdapter",
    "Runtime",
    "TaskAdapter",
    "TaskContext",
    "get_am_adapter",
    "get_runtime",
    "get_task_adapter",
    "register",
]
