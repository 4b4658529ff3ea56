"""Shared agent→user-process control-file protocol.

The PyTorch port's copy of ``tony_tpu/utils/controlfile.py``.

Both on-demand channels (profiler triggers, elastic save_and_exit) drop a
small JSON file in the task's workdir, suffixed with the task id because
tasks can share a job dir on one host. Atomic tmp-write + rename so a
poller never reads a partial file.
"""

from __future__ import annotations

import json
import os


def task_suffix(task_id: str) -> str:
    return f".{task_id.replace(':', '-')}" if task_id else ""


def current_task_id() -> str:
    """This process's task id from the injected env, or '' standalone."""
    role = os.environ.get("TONY_JOB_NAME", "")
    return f"{role}:{os.environ.get('TONY_TASK_INDEX', '0')}" if role else ""


def control_file_path(workdir: str, name: str, task_id: str = "") -> str:
    return os.path.join(workdir, name + task_suffix(task_id))


def write_control_file(path: str, payload: dict) -> str:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f)
    os.replace(tmp, path)
    return path
