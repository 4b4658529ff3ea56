"""Remote-scheme (``gs://``) inputs for confs, resources, and checkpoints.

The PyTorch port's copy of ``tony_tpu/utils/remotefs.py``.

Reference: TonyClient accepts remote-scheme ``--conf_file`` and resource
paths and round-trips them through HDFS (TonyClient.java:657-691;
LocalizableResource.java:30-114 remote branch downloads into staging).
TPU-native, the remote store is GCS:

- client-side FETCHES (conf files, ``tony.<role>.resources``, venv zips,
  src dirs) shell out to ``gsutil`` / ``gcloud storage`` — present on
  every TPU-VM image — so no GCS SDK dependency enters the tree;
- checkpoint WRITES need no copier at all: orbax/tensorstore speak
  ``gs://`` natively, the framework only has to pass such paths through
  untouched (no ``os.makedirs``, no step scans).

Tests point ``TONY_GSUTIL`` at a fake that serves a local directory.
"""

from __future__ import annotations

import logging
import os
import shlex
import shutil
import subprocess

log = logging.getLogger(__name__)

REMOTE_SCHEMES = ("gs://",)


def is_remote(path: str) -> bool:
    return str(path).startswith(REMOTE_SCHEMES)


def _copier() -> list[str]:
    override = os.environ.get("TONY_GSUTIL", "")
    if override:
        return shlex.split(override)
    if shutil.which("gsutil"):
        return ["gsutil"]
    if shutil.which("gcloud"):
        return ["gcloud", "storage"]
    raise RuntimeError(
        "gs:// input given but neither gsutil nor gcloud is on PATH "
        "(set TONY_GSUTIL to an equivalent copier)")


def fetch(remote: str, dest: str, recursive: bool = False) -> str:
    """Copy ``remote`` (gs://...) to local path ``dest``. ``dest`` is the
    target file/dir itself, not its parent. Raises on copier failure."""
    os.makedirs(os.path.dirname(os.path.abspath(dest)), exist_ok=True)
    argv = [*_copier(), "cp", *(["-r"] if recursive else []), remote, dest]
    proc = subprocess.run(argv, capture_output=True, text=True,
                          timeout=float(os.environ.get(
                              "TONY_GSUTIL_TIMEOUT_S", "600")))
    if proc.returncode != 0:
        raise RuntimeError(
            f"fetch {remote} failed (rc {proc.returncode}): "
            f"{proc.stderr.strip()[-500:]}")
    log.info("fetched %s -> %s", remote, dest)
    return dest


def fetch_to_dir(remote: str, dest_dir: str, recursive: bool = False) -> str:
    """Copy ``remote`` into ``dest_dir`` keeping its basename."""
    return fetch(remote,
                 os.path.join(dest_dir, os.path.basename(remote.rstrip("/"))),
                 recursive=recursive)
