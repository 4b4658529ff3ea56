"""History mover + purger.

The PyTorch port's copy of ``tony_tpu/events/mover.py``.

Reference: tony-portal/app/history/HistoryFileMover.java:35-120 (moves
completed jobs intermediate/ -> finished/yyyy/mm/dd/<app>/, finalizes
killed apps' inprogress files) and HistoryFilePurger.java:26-101 (deletes
finished history older than tony.history.retention-sec).
"""

from __future__ import annotations

import logging
import os
import shutil
import time

from tony_tpu_torch.events import history

log = logging.getLogger(__name__)


def move_finished_jobs(history_root: str, stale_after_s: float = 3600) -> list[str]:
    """Move every intermediate job with a finalized jhist into finished/.
    Inprogress jobs whose files have not been touched for ``stale_after_s``
    are treated as killed and finalized as KILLED first (ref: mover's
    YARN-state poll for killed apps — no RM here, so staleness stands in)."""
    moved = []
    inter = os.path.join(history_root, "intermediate")
    if not os.path.isdir(inter):
        return moved
    for app_id in os.listdir(inter):
        job_dir = os.path.join(inter, app_id)
        entries = history._scan_job_dir(job_dir)
        if not entries:
            continue
        entry = entries[0]
        if entry["inprogress"]:
            age = time.time() - os.path.getmtime(entry["jhist"])
            if age < stale_after_s:
                continue
            completed_ms = int(os.path.getmtime(entry["jhist"]) * 1000)
            final = os.path.join(
                job_dir,
                history.finished_name(app_id, entry["started"], completed_ms,
                                      "unknown", "KILLED"),
            )
            os.rename(entry["jhist"], final)
            entry = {**entry, "completed": completed_ms, "jhist": final}
        dest = history.finished_dir(history_root, entry["completed"], app_id)
        os.makedirs(os.path.dirname(dest), exist_ok=True)
        shutil.move(job_dir, dest)
        moved.append(dest)
        log.info("moved history %s -> %s", app_id, dest)
    return moved


def purge_old_history(history_root: str, retention_sec: int) -> list[str]:
    """Delete finished job dirs older than retention (ref: HistoryFilePurger)."""
    purged = []
    cutoff_ms = (time.time() - retention_sec) * 1000
    for entry in history.list_jobs(history_root):
        if entry["inprogress"] or entry["completed"] < 0:
            continue
        if entry["completed"] < cutoff_ms:
            shutil.rmtree(entry["dir"], ignore_errors=True)
            purged.append(entry["dir"])
            log.info("purged history %s", entry["dir"])
    # clean now-empty yyyy/mm/dd parents
    fin = os.path.join(history_root, "finished")
    for root, dirs, files in os.walk(fin, topdown=False) if os.path.isdir(fin) else []:
        if not dirs and not files and root != fin:
            os.rmdir(root)
    return purged
