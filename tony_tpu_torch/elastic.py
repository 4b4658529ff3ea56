"""Elastic training — real, where the reference only stubbed it.

The PyTorch port's copy of ``tony_tpu/elastic.py``: the control-file
protocol that the agent and the coordinator use (``cli/resize.py`` is not
ported yet). A ``torch.distributed`` group's size is fixed at
``init_process_group`` too, so the same gang restart serves the port.

Reference state: horovod_driver.py's ``elastic_driver_fn()`` is ``pass``
(resources/horovod_driver.py:28-29) and the proposal doc defers elasticity
(docs/proposals/horovod-on-tony.md:15-17). TPU semantics make in-place
membership change impossible anyway — an XLA gang's size is fixed at
``jax.distributed.initialize`` — so tony-tpu implements elasticity the
TPU-native way: **checkpoint-aware gang restart**.

Flow:
1. anyone calls the coordinator's ``resize_role(role, instances)`` RPC
   verb (client API or ``tony-tpu resize`` CLI);
2. the coordinator queues a ``save_and_exit`` command to every task
   (delivered on heartbeats), waits a grace period, then rebuilds the
   session at the new size (session epoch++), relaunching all tasks;
3. the user loop polls ``save_and_exit_requested()`` each step; when set
   it checkpoints (``tony_tpu_torch.train.checkpoint``) and exits with
   ``EXIT_RESIZE``;
4. relaunched tasks see a bumped ``TONY_SESSION_ID`` and resume via
   ``restore_or_init``.

Tasks that ignore the request are killed at the end of the grace period —
correctness then rests on their last periodic checkpoint.
"""

from __future__ import annotations

import os

from tony_tpu_torch.utils.controlfile import (
    control_file_path,
    current_task_id,
    write_control_file,
)

# EX_TEMPFAIL: a cooperative elastic exit, not a failure
EXIT_RESIZE = 75

CONTROL_FILENAME = ".tony_save_and_exit"


def control_path(workdir: str, task_id: str = "") -> str:
    return control_file_path(workdir, CONTROL_FILENAME, task_id)


def write_save_and_exit(workdir: str, task_id: str = "",
                        reason: str = "resize") -> str:
    """Agent side: ask the user process to checkpoint and exit."""
    return write_control_file(control_path(workdir, task_id),
                              {"reason": reason})


def save_and_exit_requested(workdir: str | None = None,
                            task_id: str | None = None) -> bool:
    """User side: poll once per step (one ``os.path.exists`` when idle).
    The file is not consumed — exit is expected to follow."""
    workdir = workdir or os.getcwd()
    task_id = current_task_id() if task_id is None else task_id
    return os.path.exists(control_path(workdir, task_id))


def session_epoch() -> int:
    """The gang generation this process belongs to; bumps on every elastic
    resize or coordinator retry."""
    return int(os.environ.get("TONY_SESSION_ID", "0"))
