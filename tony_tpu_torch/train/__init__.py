"""Training on one device: the train step (``trainer``), the loop
(``loop``), checkpoints (``checkpoint``), and the fused optimizer of
``ops.adamw``."""

from tony_tpu_torch.ops.adamw import FusedAdamW, FusedAdamWState
from tony_tpu_torch.train.checkpoint import (CheckpointManager, auto_resume,
                                             job_checkpoint_dir,
                                             restore_or_init,
                                             scan_latest_step)
from tony_tpu_torch.train.loop import FitResult, JsonlMetricsLogger, fit
from tony_tpu_torch.train.trainer import (Trainer, TrainState,
                                          build_train_step,
                                          cross_entropy_loss)

__all__ = ["CheckpointManager", "FitResult", "FusedAdamW",
           "FusedAdamWState", "JsonlMetricsLogger", "TrainState", "Trainer",
           "auto_resume", "build_train_step", "cross_entropy_loss", "fit",
           "job_checkpoint_dir", "restore_or_init", "scan_latest_step"]
