"""Training on one device: the train step (``trainer``), the loop
(``loop``), checkpoints (``checkpoint``), LoRA adapters (``lora``), and
the fused optimizer of ``ops.adamw``."""

from tony_tpu_torch.ops.adamw import FusedAdamW, FusedAdamWState
from tony_tpu_torch.train.checkpoint import (CheckpointManager, auto_resume,
                                             job_checkpoint_dir,
                                             restore_or_init,
                                             scan_latest_step)
from tony_tpu_torch.train.lora import (DEFAULT_TARGETS, LoraAdapters,
                                       lora_init, lora_param_count,
                                       materialize_lora, merge_lora,
                                       wrap_apply_fn)
from tony_tpu_torch.train.loop import FitResult, JsonlMetricsLogger, fit
from tony_tpu_torch.train.trainer import (Trainer, TrainState,
                                          build_train_step,
                                          cross_entropy_loss)

__all__ = ["CheckpointManager", "DEFAULT_TARGETS", "FitResult",
           "FusedAdamW", "FusedAdamWState", "JsonlMetricsLogger",
           "LoraAdapters", "TrainState", "Trainer", "auto_resume",
           "build_train_step", "cross_entropy_loss", "fit",
           "job_checkpoint_dir", "lora_init", "lora_param_count",
           "materialize_lora", "merge_lora", "restore_or_init",
           "scan_latest_step", "wrap_apply_fn"]
