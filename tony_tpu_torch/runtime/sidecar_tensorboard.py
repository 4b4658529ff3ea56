"""Built-in sidecar TensorBoard launcher.

The PyTorch port's copy of ``tony_tpu/runtime/sidecar_tensorboard.py``.

Reference: resources/sidecar_tensorboard.py:1-31 — a tiny bootstrap the
client ships automatically for a ``tensorboard`` role with no user command
(TonyClient.setSidecarTBResources :571-600). Reads ``TB_LOG_DIR`` and
``TB_PORT`` from the env injected by the agent and launches TensorBoard
bound to all interfaces; the agent registers the URL with the coordinator.
Test mode (``TONY_TEST_TB_SLEEP``) sleeps instead so e2e tests can run
without tensorboard installed — same trick as the reference's test flag.

Deliberately standalone (stdlib only, no tony_tpu_torch imports): the client
copies this file into the job dir at stage time, mirroring the reference's
resource-localization of its launcher script, so it runs under any task
interpreter in local/ssh/docker launch modes.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
import time


def main() -> int:
    log_dir = os.environ.get("TB_LOG_DIR", "")
    port = os.environ.get("TB_PORT", "")
    test_sleep = os.environ.get("TONY_TEST_TB_SLEEP", "")
    if test_sleep:
        # e2e mode: pretend to serve until the coordinator reaps us
        time.sleep(float(test_sleep))
        return 0
    if not log_dir:
        print("sidecar_tensorboard: TB_LOG_DIR not set", file=sys.stderr)
        return 1
    cmd = [sys.executable, "-m", "tensorboard.main"]
    if shutil.which("tensorboard"):
        cmd = ["tensorboard"]
    cmd += ["--logdir", log_dir, "--host", "0.0.0.0"]
    if port:
        cmd += ["--port", port]
    try:
        return subprocess.call(cmd)
    except FileNotFoundError:
        print("sidecar_tensorboard: tensorboard not installed", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
