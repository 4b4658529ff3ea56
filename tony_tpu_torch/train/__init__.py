"""Training on one device: the train step (``trainer``), the loop
(``loop``), checkpoints (``checkpoint``), and the fused optimizer of
``ops.adamw``."""

from tony_tpu_torch.ops.adamw import FusedAdamW, FusedAdamWState
from tony_tpu_torch.train.checkpoint import (CheckpointManager,
                                             job_checkpoint_dir)
from tony_tpu_torch.train.loop import FitResult, JsonlMetricsLogger, fit
from tony_tpu_torch.train.trainer import (Trainer, TrainState,
                                          build_train_step,
                                          cross_entropy_loss)

__all__ = ["CheckpointManager", "FitResult", "FusedAdamW",
           "FusedAdamWState", "JsonlMetricsLogger", "TrainState", "Trainer",
           "build_train_step", "cross_entropy_loss", "fit",
           "job_checkpoint_dir"]
