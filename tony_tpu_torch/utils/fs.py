"""Staging filesystem helpers: zip/unzip, job dirs, localizable resources.

The PyTorch port's copy of ``tony_tpu/utils/fs.py``.

Reference: util/Utils.java zipFolder/unzipArchive (:165-178),
extractResources (:750), uploadFileAndSetConfResources (:684);
LocalizableResource.java (path[::localName][#archive] parsing). HDFS is
replaced by a shared filesystem path (NFS/GCS-fuse on TPU-VMs); staging
layout mirrors ~/.tony/<app_id>/.
"""

from __future__ import annotations

import os
import shutil
import uuid
import zipfile
from dataclasses import dataclass

from tony_tpu_torch import constants as C


def zip_dir(src_dir: str, dest_zip: str) -> str:
    os.makedirs(os.path.dirname(dest_zip) or ".", exist_ok=True)
    with zipfile.ZipFile(dest_zip, "w", zipfile.ZIP_DEFLATED) as zf:
        for root, _, files in os.walk(src_dir):
            for name in files:
                full = os.path.join(root, name)
                zf.write(full, os.path.relpath(full, src_dir))
    return dest_zip


def unzip(archive: str, dest_dir: str) -> str:
    os.makedirs(dest_dir, exist_ok=True)
    with zipfile.ZipFile(archive) as zf:
        zf.extractall(dest_dir)
    return dest_dir


def staging_root(conf_value: str = "") -> str:
    return conf_value or os.path.join(os.path.expanduser("~"), C.TONY_STAGING_PREFIX)


def new_app_id() -> str:
    """application_<uuid> (ref: YARN appId; uuid keeps it collision-free
    without a central RM)."""
    return f"application_{uuid.uuid4().hex[:12]}"


def app_staging_dir(root: str, app_id: str) -> str:
    d = os.path.join(root, app_id)
    os.makedirs(d, exist_ok=True)
    return d


@dataclass
class LocalizableResource:
    """One ``path[::localName][#archive]`` resource spec
    (ref: LocalizableResource.java:30-114)."""

    source: str
    local_name: str
    is_archive: bool

    @classmethod
    def parse(cls, spec: str) -> "LocalizableResource":
        spec = spec.strip()
        is_archive = spec.endswith("#archive")
        if is_archive:
            spec = spec[: -len("#archive")]
        if "::" in spec:
            source, local_name = spec.split("::", 1)
        else:
            source, local_name = spec, os.path.basename(spec.rstrip("/"))
        return cls(source=source, local_name=local_name, is_archive=is_archive)

    def localize(self, dest_dir: str) -> str:
        """Materialize into ``dest_dir`` (dirs are zipped by the client;
        archives are extracted, ref: Utils.extractResources). ``gs://``
        sources are fetched first (ref: LocalizableResource.java:30-114
        remote branch — HDFS download becomes a GCS copy)."""
        from tony_tpu_torch.utils import remotefs

        os.makedirs(dest_dir, exist_ok=True)
        dest = os.path.join(dest_dir, self.local_name)
        if remotefs.is_remote(self.source):
            if self.is_archive:
                fetched = remotefs.fetch(self.source, dest + ".fetch.zip")
                try:
                    return unzip(fetched, dest)
                finally:
                    os.remove(fetched)
            # Directory-prefix resources (the remote analog of the local
            # isdir/copytree branch below; ref HDFS dir localization):
            # a trailing slash is an explicit dir, otherwise fall back to
            # a recursive fetch ONLY when the flat copy reports a
            # miss/dir-shaped error — auth or network failures must
            # surface as-is, not be masked by a doomed -r retry.
            if self.source.endswith("/"):
                return remotefs.fetch(self.source.rstrip("/"), dest,
                                      recursive=True)
            try:
                return remotefs.fetch(self.source, dest)
            except RuntimeError as e:
                msg = str(e).lower()
                dir_shaped = any(s in msg for s in (
                    "no such", "not found", "matched no objects",
                    "no urls matched", "omitting directory",
                    "is a directory"))
                if not dir_shaped:
                    raise
                return remotefs.fetch(self.source, dest, recursive=True)
        if self.is_archive:
            return unzip(self.source, dest)
        if os.path.isdir(self.source):
            if os.path.abspath(self.source) != os.path.abspath(dest):
                shutil.copytree(self.source, dest, dirs_exist_ok=True)
            return dest
        shutil.copy2(self.source, dest)
        return dest


def parse_resources(spec: str) -> list[LocalizableResource]:
    return [LocalizableResource.parse(s) for s in spec.split(",") if s.strip()]


# the file a complete step directory of ``train.checkpoint`` holds: a save
# is written under a temporary name and renamed into place, so a step
# directory without it is not complete
CHECKPOINT_STATE_FILE = "state.pt"


def checkpoint_steps(directory: str) -> list[int]:
    """The complete checkpoint steps under ``directory``, ascending: its
    numbered subdirectories that hold ``CHECKPOINT_STATE_FILE``. Imports
    no ``torch``: the coordinator (which must stay light) reads it."""
    try:
        names = os.listdir(directory)
    except OSError:
        return []
    return sorted(int(n) for n in names if n.isdigit() and os.path.exists(
        os.path.join(directory, n, CHECKPOINT_STATE_FILE)))


def scan_latest_step(directory: str) -> int | None:
    """Newest complete checkpoint step under ``directory``, or None (the
    counterpart of ``tony_tpu/train/checkpoint.py`` ``scan_latest_step``,
    which reads orbax's layout). The coordinator advertises it as
    ``TONY_RESUME_STEP``."""
    steps = checkpoint_steps(directory)
    return steps[-1] if steps else None
