from tony_tpu_torch.client.client import TaskUpdateListener, TonyClient

__all__ = ["TonyClient", "TaskUpdateListener"]
