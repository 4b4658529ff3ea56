from tony_tpu_torch.scheduler.dag import CycleError, TaskScheduler

__all__ = ["TaskScheduler", "CycleError"]
