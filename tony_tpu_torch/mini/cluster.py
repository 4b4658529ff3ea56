"""In-process test cluster harness — tony-mini MiniCluster equivalent.

The PyTorch port's copy of ``tony_tpu/mini/cluster.py``.

Reference: tony-mini MiniCluster.java:24-87 boots MiniYARNCluster +
MiniDFSCluster in-process so E2E tests submit real jobs without a cluster.
Here there is no RM/NM to fake: the local launcher already runs agents as
subprocesses, so the harness provides (a) an isolated staging/history root,
(b) fast control-plane timings, (c) a ``submit`` helper mirroring
TestTonyE2E's client usage, and (d), on request, a device-hiding env.

The port's cluster hides no device by default: its jobs run on the card.
``device="cpu"`` sets ``CUDA_VISIBLE_DEVICES=""`` for the job's
processes (the JAX package's cluster forces ``JAX_PLATFORMS=cpu``
instead), and the CPU tests pass it. ``root`` keeps the staging and
history tree in a directory the caller owns, which outlives the cluster.
"""

from __future__ import annotations

import os
import shutil
import tempfile

from tony_tpu_torch import constants as C
from tony_tpu_torch.client import TonyClient
from tony_tpu_torch.config import TonyConf


class MiniTonyCluster:
    def __init__(self, fast_ms: int = 100, device: str | None = None,
                 root: str | None = None):
        self.fast_ms = fast_ms
        self.device = device
        self.root: str = root or ""
        self._owns_root = root is None
        self._saved_env: str | None = None

    def __enter__(self) -> "MiniTonyCluster":
        if self._owns_root:
            self.root = tempfile.mkdtemp(prefix="minitony_")
        else:
            os.makedirs(self.root, exist_ok=True)
        if self.device == "cpu":
            # the job's processes inherit this process's env (the client
            # spawns the coordinator, which spawns the agents)
            self._saved_env = os.environ.get(C.CUDA_VISIBLE_DEVICES)
            os.environ[C.CUDA_VISIBLE_DEVICES] = ""
        return self

    def __exit__(self, *exc) -> None:
        if self.device == "cpu":
            if self._saved_env is None:
                os.environ.pop(C.CUDA_VISIBLE_DEVICES, None)
            else:
                os.environ[C.CUDA_VISIBLE_DEVICES] = self._saved_env
        if self._owns_root:
            shutil.rmtree(self.root, ignore_errors=True)

    def base_conf(self) -> TonyConf:
        conf = TonyConf()
        conf.set("tony.staging-dir", os.path.join(self.root, "staging"))
        conf.set("tony.history.location", os.path.join(self.root, "history"))
        conf.set("tony.task.heartbeat-interval-ms", self.fast_ms)
        conf.set("tony.coordinator.monitor-interval-ms", self.fast_ms)
        conf.set("tony.client.poll-interval-ms", self.fast_ms)
        conf.set("tony.coordinator.registration-timeout-ms", 60_000)
        return conf

    def adopt(self, conf: TonyConf) -> TonyConf:
        """Overlay this cluster's staging/history/timing keys onto an
        externally-built conf (the one merge both `tony-tpu local` and the
        test harness use)."""
        base = self.base_conf()
        for key in ("tony.staging-dir", "tony.history.location",
                    "tony.task.heartbeat-interval-ms",
                    "tony.coordinator.monitor-interval-ms",
                    "tony.client.poll-interval-ms",
                    "tony.coordinator.registration-timeout-ms"):
            conf.set(key, base.get(key))
        return conf

    def make_client(self, conf: TonyConf) -> TonyClient:
        return TonyClient(conf)

    def submit(self, conf: TonyConf) -> TonyClient:
        """Run a job to completion; returns the client (check
        ``client.final_status``)."""
        client = self.make_client(conf)
        client.run()
        return client


def script_conf(cluster: MiniTonyCluster, script: str, roles: dict[str, int],
                framework: str = "jax", **extra) -> TonyConf:
    """Conf for a payload-script job (TestTonyE2E helper shape)."""
    conf = cluster.base_conf()
    conf.set("tony.application.executes", script)
    conf.set("tony.application.framework", framework)
    for role, n in roles.items():
        conf.set(f"tony.{role}.instances", n)
    for k, v in extra.items():
        conf.set(k, v)
    return conf
