"""Checkpoint and resume over ``torch.save``: the counterpart of
``tony_tpu/train/checkpoint.py``.

Numbered step directories (``<dir>/<step>/state.pt``), the newest
``max_to_keep`` kept, a save written under a temporary name and renamed
into place, so a crash mid-save leaves no step that looks complete.
The JAX package writes orbax checkpoints; this manager cannot read them
(a deliberate divergence, ROADMAP queue 3): carry a JAX state across
with ``models.convert.from_jax_train_state`` instead.
"""

from __future__ import annotations

import logging
import os
import shutil

import torch

from tony_tpu_torch.ops.adamw import FusedAdamWState
from tony_tpu_torch.train.trainer import TrainState

log = logging.getLogger(__name__)

# the coordinator-injected checkpoint directory (tony_tpu/constants.py
# names the same variable)
TONY_CHECKPOINT_DIR = "TONY_CHECKPOINT_DIR"


def job_checkpoint_dir() -> str | None:
    """The coordinator-injected checkpoint dir for this task, if any."""
    return os.environ.get(TONY_CHECKPOINT_DIR) or None


def _payload(state: TrainState) -> dict:
    opt = state.opt_state
    if isinstance(opt, FusedAdamWState):
        opt = {"count": opt.count, "mu": opt.mu, "nu": opt.nu,
               "compute_params": opt.compute_params}
    elif isinstance(opt, torch.optim.Optimizer):
        opt = opt.state_dict()
    return {"step": int(state.step), "params": state.params,
            "opt_state": opt}


class CheckpointManager:
    """Numbered step checkpoints and latest-restore."""

    def __init__(self, directory: str, max_to_keep: int = 3,
                 save_interval_steps: int = 1):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.save_interval_steps = save_interval_steps

    def steps(self) -> list[int]:
        return sorted(int(n) for n in os.listdir(self.directory)
                      if n.isdigit() and os.path.exists(
                          os.path.join(self.directory, n, "state.pt")))

    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: TrainState, force: bool = False) \
            -> bool:
        """Write ``state`` as step ``step``; off the save interval (or
        onto an existing step) only with ``force``. Returns whether it
        wrote."""
        final = os.path.join(self.directory, str(step))
        if not force and (step % self.save_interval_steps
                          or os.path.exists(final)):
            return False
        tmp = f"{final}.tmp-{os.getpid()}"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(_payload(state), os.path.join(tmp, "state.pt"))
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)
        log.info("checkpoint saved at step %d", step)
        if self.max_to_keep:
            for old in self.steps()[:-self.max_to_keep]:
                shutil.rmtree(os.path.join(self.directory, str(old)),
                              ignore_errors=True)
        return True

    def restore(self, step: int | None = None) -> TrainState | None:
        """The saved state of ``step`` (default the latest), on the CPU;
        ``Trainer.place`` puts it on the device."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        doc = torch.load(os.path.join(self.directory, str(step),
                                      "state.pt"), map_location="cpu",
                         weights_only=True)
        log.info("restored checkpoint step %d", step)
        return TrainState(step=doc["step"], params=doc["params"],
                          opt_state=doc["opt_state"])
