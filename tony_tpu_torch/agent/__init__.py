from tony_tpu_torch.agent.executor import Heartbeater, TaskAgent

__all__ = ["Heartbeater", "TaskAgent"]
