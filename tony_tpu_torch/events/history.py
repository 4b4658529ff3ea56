"""History file naming + parsing.

The PyTorch port's copy of ``tony_tpu/events/history.py``.

Reference: util/HistoryFileUtils.java (name codec) + util/ParserUtils.java
(isValidHistFileName :67, parseMetadata :153, parseConfig :181,
parseEvents :258). Layout (ref: EventHandler + portal HistoryFileMover):

  <history>/intermediate/<app_id>/<app_id>-<started>.jhist.jsonl.inprogress
  <history>/finished/yyyy/mm/dd/<app_id>/<app_id>-<started>-<completed>-<user>-<STATUS>.jhist.jsonl

plus ``tony-final.json`` and ``metadata.json`` alongside.
"""

from __future__ import annotations

import json
import os
import re
import time

from tony_tpu_torch import constants as C
from tony_tpu_torch.events.event import Event, JobMetadata

_FINAL_RE = re.compile(
    r"^(?P<app>application_[A-Za-z0-9_]+)-(?P<started>\d+)-(?P<completed>\d+)"
    r"-(?P<user>[^-]+)-(?P<status>SUCCEEDED|FAILED|KILLED)"
    + re.escape(C.JHIST_SUFFIX)
    + r"$"
)
_INPROGRESS_RE = re.compile(
    r"^(?P<app>application_[A-Za-z0-9_]+)-(?P<started>\d+)"
    + re.escape(C.JHIST_SUFFIX)
    + re.escape(C.INPROGRESS_SUFFIX)
    + r"$"
)


def inprogress_name(app_id: str, started_ms: int) -> str:
    return f"{app_id}-{started_ms}{C.JHIST_SUFFIX}{C.INPROGRESS_SUFFIX}"


def finished_name(app_id: str, started_ms: int, completed_ms: int, user: str,
                  status: str) -> str:
    return f"{app_id}-{started_ms}-{completed_ms}-{user}-{status}{C.JHIST_SUFFIX}"


def is_valid_history_name(name: str) -> bool:
    return bool(_FINAL_RE.match(name) or _INPROGRESS_RE.match(name))


def parse_history_name(name: str) -> dict | None:
    m = _FINAL_RE.match(name)
    if m:
        d = m.groupdict()
        return {
            "app_id": d["app"],
            "started": int(d["started"]),
            "completed": int(d["completed"]),
            "user": d["user"],
            "status": d["status"],
            "inprogress": False,
        }
    m = _INPROGRESS_RE.match(name)
    if m:
        d = m.groupdict()
        return {
            "app_id": d["app"],
            "started": int(d["started"]),
            "completed": -1,
            "user": "",
            "status": "RUNNING",
            "inprogress": True,
        }
    return None


def intermediate_dir(history_root: str, app_id: str) -> str:
    return os.path.join(history_root, C.HISTORY_INTERMEDIATE, app_id)


def finished_dir(history_root: str, completed_ms: int, app_id: str) -> str:
    t = time.localtime(completed_ms / 1000)
    return os.path.join(
        history_root,
        C.HISTORY_FINISHED,
        f"{t.tm_year:04d}",
        f"{t.tm_mon:02d}",
        f"{t.tm_mday:02d}",
        app_id,
    )


def parse_events(jhist_path: str) -> list[Event]:
    events = []
    with open(jhist_path) as f:
        for line in f:
            line = line.strip()
            if line:
                events.append(Event.from_dict(json.loads(line)))
    return events


def parse_metadata(job_dir: str) -> JobMetadata | None:
    p = os.path.join(job_dir, C.METADATA_FILE)
    if not os.path.isfile(p):
        return None
    with open(p) as f:
        return JobMetadata.from_dict(json.load(f))


def parse_config(job_dir: str) -> dict | None:
    p = os.path.join(job_dir, C.TONY_FINAL_CONF)
    if not os.path.isfile(p):
        return None
    with open(p) as f:
        return json.load(f)


def list_jobs(history_root: str) -> list[dict]:
    """Scan intermediate/ + finished/**/ for job dirs, newest first
    (ref: portal jobs index via CacheWrapper + ParserUtils)."""
    out = []
    inter = os.path.join(history_root, C.HISTORY_INTERMEDIATE)
    if os.path.isdir(inter):
        for app in os.listdir(inter):
            out.extend(_scan_job_dir(os.path.join(inter, app)))
    fin = os.path.join(history_root, C.HISTORY_FINISHED)
    for root, _dirs, files in os.walk(fin) if os.path.isdir(fin) else []:
        if any(is_valid_history_name(f) for f in files):
            out.extend(_scan_job_dir(root))
    out.sort(key=lambda d: d["started"], reverse=True)
    return out


def _scan_job_dir(job_dir: str) -> list[dict]:
    found = []
    if not os.path.isdir(job_dir):
        return found
    for name in os.listdir(job_dir):
        parsed = parse_history_name(name)
        if parsed:
            parsed["dir"] = job_dir
            parsed["jhist"] = os.path.join(job_dir, name)
            found.append(parsed)
    return found
