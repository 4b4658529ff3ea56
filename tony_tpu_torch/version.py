"""Build/version info.

The PyTorch port's copy of ``tony_tpu/version.py``.

Reference: tony-core util/VersionInfo.java (149 LoC) injects
version/revision/branch/user/date into the job conf; the port reads
``__version__`` and ``_git`` for ``/metrics``' build info.
"""

from __future__ import annotations

import getpass
import os
import subprocess
import time

__version__ = "0.1.0"


def _git(*args: str) -> str:
    try:
        out = subprocess.run(
            ["git", *args],
            capture_output=True,
            text=True,
            timeout=5,
            cwd=os.path.dirname(os.path.abspath(__file__)),
        )
        return out.stdout.strip() if out.returncode == 0 else "unknown"
    except Exception:
        return "unknown"


def version_info() -> dict:
    """Version metadata injected into the final job conf.

    Mirrors the keys of TonyConfigurationKeys.java:34-41 (tony.version,
    tony.revision, tony.branch, tony.user, tony.date).
    """
    return {
        "tony.version": __version__,
        "tony.revision": _git("rev-parse", "HEAD"),
        "tony.branch": _git("rev-parse", "--abbrev-ref", "HEAD"),
        "tony.user": getpass.getuser(),
        "tony.date": time.strftime("%Y-%m-%dT%H:%M:%S%z"),
    }
