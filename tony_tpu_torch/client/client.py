"""Job-submission client — TonyClient equivalent.

The PyTorch port's copy of ``tony_tpu/client/client.py``.

Reference: TonyClient.java (1417 LoC): merges config layers, stages the
user's src dir / venv / resources into the job dir, writes tony-final.json,
launches the coordinator (YARN AM submission becomes a subprocess or remote
exec), polls application status + task infos on a 1 s cadence, streams
status tables to the console and listeners, and signals the coordinator to
finish (ref: monitorApplication :1031-1099, signalAMToFinish :1101-1111).
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import secrets as pysecrets
import shutil
import signal
import subprocess
import sys
import time
from typing import Callable

from tony_tpu_torch import constants as C
from tony_tpu_torch.config import TonyConf
from tony_tpu_torch.rpc import RpcClient
from tony_tpu_torch.runtime import get_am_adapter
from tony_tpu_torch.session import TaskInfo
from tony_tpu_torch.utils import (
    app_staging_dir,
    new_app_id,
    parse_resources,
    staging_root,
    unzip,
    zip_dir,
)

log = logging.getLogger(__name__)

TaskUpdateListener = Callable[[list[TaskInfo]], None]
"""Ref: client/TaskUpdateListener.java:11."""


class TonyClient:
    def __init__(self, conf: TonyConf):
        self.conf = conf
        self.app_id: str = ""
        self.job_dir: str = ""
        self.secret: str | None = None
        self.listeners: list[TaskUpdateListener] = []
        self.coordinator_proc: subprocess.Popen | None = None
        self.rpc: RpcClient | None = None
        self.final_status: dict | None = None
        self.tensorboard_url = ""
        self.tls_fingerprint: str | None = None

    def add_listener(self, listener: TaskUpdateListener) -> None:
        self.listeners.append(listener)

    # ------------------------------------------------------------ submission
    def init(self) -> None:
        """Validate conf + runtime preflight (ref: TonyClient.init :442 /
        validateTonyConf :788)."""
        self.conf.validate()
        self._validate_sidecar_tb()
        framework = str(self.conf.get("tony.application.framework"))
        get_am_adapter(framework).validate_and_update_config(self.conf)

    def _sidecar_tb_mode(self) -> str:
        """How a configured ``tensorboard`` role gets its command:
        ``user`` (explicit tony.tensorboard.command), ``builtin`` (log dir
        set -> ship the built-in launcher; ref: the reference gates sidecar
        TB on its log-dir flag, TonyClient.java:560-600), ``fallback``
        (tony.application.executes serves the role, the pre-existing
        entrypoint-switches-on-JOB_NAME pattern), or ``none``."""
        role = C.TENSORBOARD_JOB_NAME
        if role not in self.conf.roles():
            return "none"
        if str(self.conf.role_get(role, "command")):
            return "user"
        if str(self.conf.get("tony.application.tensorboard-log-dir", "")):
            return "builtin"
        if str(self.conf.get("tony.application.executes", "")):
            return "fallback"
        return "error"

    def _validate_sidecar_tb(self) -> None:
        """A ``tensorboard`` role with nothing to run fails at submit time,
        not as a silently tolerated sidecar crash."""
        if self._sidecar_tb_mode() == "error":
            from tony_tpu_torch.config import ConfError
            raise ConfError(
                "tony.tensorboard.instances is set with no "
                "tony.tensorboard.command; the built-in sidecar launcher "
                "needs tony.application.tensorboard-log-dir")

    def _set_sidecar_tb_command(self) -> None:
        """Ship the built-in sidecar launcher into the job dir and point the
        command-less ``tensorboard`` role at it (ref: setSidecarTBResources
        TonyClient.java:571-600 localizing resources/sidecar_tensorboard.py).
        The script is stdlib-only, so it runs under the shipped venv's
        python when present, else the task host's python3 — never the
        client's interpreter, which may not exist under ssh/docker launch
        modes."""
        if self._sidecar_tb_mode() != "builtin":
            return
        from tony_tpu_torch.runtime import sidecar_tensorboard
        script = os.path.join(self.job_dir, "sidecar_tensorboard.py")
        shutil.copyfile(sidecar_tensorboard.__file__, script)
        venv_python = os.path.join(self.job_dir, "venv", "bin", "python")
        interp = venv_python if os.path.exists(venv_python) else "python3"
        self.conf.set(f"tony.{C.TENSORBOARD_JOB_NAME}.command",
                      f"{interp} {script}")

    def stage(self) -> str:
        """Create the job dir and localize src/venv/resources into it
        (ref: processFinalTonyConf :229-310 + processTonyConfResources
        :701-780 — HDFS upload becomes shared-filesystem copy)."""
        self.app_id = new_app_id()
        root = staging_root(str(self.conf.get("tony.staging-dir", "")))
        self.job_dir = app_staging_dir(root, self.app_id)
        from tony_tpu_torch.utils import remotefs

        src_dir = str(self.conf.get("tony.application.src-dir", ""))
        if src_dir and remotefs.is_remote(src_dir):
            # gs:// src tree lands directly in the job dir (the local-path
            # zip/unzip below exists only to filter + flatten a local dir)
            remotefs.fetch(src_dir.rstrip("/") + "/*", self.job_dir,
                           recursive=True)
        elif src_dir:
            z = zip_dir(src_dir, os.path.join(self.job_dir, C.TONY_SRC_ZIP))
            unzip(z, self.job_dir)  # agents exec with cwd=job_dir
        else:
            # no staging AT ALL (neither src-dir nor role resources): a
            # relative `executes` that resolves from the SUBMITTER's cwd
            # (the `--conf_file examples/x/job.toml` shape) would
            # otherwise be re-resolved against the task's cwd (the job
            # dir) and break; pin it to the client-side file. When
            # anything IS staged, a relative executes names the staged
            # copy inside the job dir — it must stay relative so the
            # ssh launcher's shipped/rewritten job dir resolves it.
            any_resources = any(
                str(self.conf.role_get(role, "resources"))
                for role in self.conf.roles())
            executes = str(self.conf.get("tony.application.executes", ""))
            if executes and not any_resources and \
                    not os.path.isabs(executes) and os.path.exists(executes):
                self.conf.set("tony.application.executes",
                              os.path.abspath(executes))
        venv = str(self.conf.get("tony.application.python-venv", ""))
        if venv and remotefs.is_remote(venv):
            if venv.endswith(".zip"):
                fetched = remotefs.fetch(
                    venv, os.path.join(self.job_dir, C.TONY_VENV_ZIP))
                unzip(fetched, os.path.join(self.job_dir, "venv"))
            else:  # a directory prefix, like the local copytree branch
                dest = os.path.join(self.job_dir, "venv")
                os.makedirs(dest, exist_ok=True)
                remotefs.fetch(venv.rstrip("/") + "/*", dest,
                               recursive=True)
        elif venv:
            if venv.endswith(".zip"):
                unzip(venv, os.path.join(self.job_dir, "venv"))
            else:
                shutil.copytree(venv, os.path.join(self.job_dir, "venv"),
                                dirs_exist_ok=True)
        for role in self.conf.roles():
            spec = str(self.conf.role_get(role, "resources"))
            for res in parse_resources(spec):
                res.localize(self.job_dir)
        self._set_sidecar_tb_command()
        if self.conf.get_bool("tony.application.security.enabled"):
            self.secret = pysecrets.token_hex(32)
        if self.conf.get_bool("tony.application.security.tls"):
            # per-job self-signed cert minted at staging (the TokenCache
            # analog); the coordinator serves it, all peers pin it
            from tony_tpu_torch.rpc.tls import cert_fingerprint, mint_self_signed

            cert, _key = mint_self_signed(self.job_dir,
                                          f"tony-{self.app_id}")
            self.tls_fingerprint = cert_fingerprint(cert)
        self.conf.write_final(os.path.join(self.job_dir, C.TONY_FINAL_CONF))
        return self.job_dir

    def start_coordinator(self, attempt: int = 0) -> None:
        """Launch the coordinator process (ref: submitApplication :314-349 +
        buildCommand :900-919 — the AM container spec becomes a subprocess).
        ``attempt`` is the client-side respawn index (YARN AM-attempt
        analog), exported so fault injections can target one attempt."""
        # a respawn must not connect to the dead generation's endpoint
        for stale in ("coordinator.json", "status.json"):
            with contextlib.suppress(OSError):
                os.remove(os.path.join(self.job_dir, stale))
        env = dict(os.environ)
        env[C.COORD_CLIENT_ATTEMPT] = str(attempt)
        if self.secret:
            env[C.JOB_TOKEN] = self.secret
        repo_root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
        log_path = os.path.join(self.job_dir, "logs", "coordinator.log")
        os.makedirs(os.path.dirname(log_path), exist_ok=True)
        out = open(log_path, "ab", buffering=0)
        try:
            self.coordinator_proc = subprocess.Popen(
                [sys.executable, "-m", "tony_tpu_torch.coordinator",
                 "--conf", os.path.join(self.job_dir, C.TONY_FINAL_CONF),
                 "--app-id", self.app_id,
                 "--job-dir", self.job_dir],
                env=env,
                stdout=out,
                stderr=subprocess.STDOUT,
                start_new_session=True,
            )
        finally:
            out.close()
        log.info("coordinator launched for %s (pid %d)", self.app_id,
                 self.coordinator_proc.pid)

    # ------------------------------------------------------------ monitoring
    def _connect_rpc(self, timeout_s: float = 60) -> RpcClient:
        """Poll for coordinator.json then connect (ref: initRpcClientAndLog-
        AMUrl :1208-1229 — RPC port appears in the application report)."""
        path = os.path.join(self.job_dir, "coordinator.json")
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if os.path.exists(path):
                with open(path) as f:
                    info = json.load(f)
                return RpcClient(info["host"], info["port"],
                                 secret=self.secret,
                                 tls_fingerprint=self.tls_fingerprint)
            if self.coordinator_proc and self.coordinator_proc.poll() is not None:
                raise RuntimeError(
                    f"coordinator exited ({self.coordinator_proc.returncode}) "
                    f"before serving RPC; see {self.job_dir}/logs/coordinator.log")
            time.sleep(0.2)
        raise TimeoutError("coordinator endpoint never appeared")

    def monitor(self) -> bool:
        """Poll status until terminal (ref: monitorApplication :1031-1099).
        Returns True on SUCCEEDED.

        A coordinator process that dies WITHOUT a terminal status is
        respawned up to tony.client.coordinator-max-attempts times (the
        YARN AM-restart analog, ref: tony.am.retry handled by RM attempts)
        — checkpoint-dir jobs then resume from the last checkpoint."""
        self.rpc = self._connect_rpc()
        interval = self.conf.get_int("tony.client.poll-interval-ms", 1000) / 1000
        max_attempts = max(
            self.conf.get_int("tony.client.coordinator-max-attempts", 1), 1)
        attempt = 0
        last_rendered = ""
        status: dict = {"status": "RUNNING"}
        while True:
            try:
                status = self.rpc.call("get_application_status")
                infos = [TaskInfo.from_dict(d) for d in self.rpc.call("get_task_infos")]
            except (ConnectionError, TimeoutError):
                if self.coordinator_proc and self.coordinator_proc.poll() is not None:
                    terminal = self._status_from_file()
                    if terminal is None and attempt + 1 < max_attempts:
                        attempt += 1
                        fence_s = self._respawn_fence_s()
                        log.warning(
                            "coordinator died (exit %s) with no terminal "
                            "status; fencing %.0fs then respawning "
                            "(attempt %d/%d)",
                            self.coordinator_proc.returncode, fence_s,
                            attempt + 1, max_attempts)
                        time.sleep(fence_s)
                        self.start_coordinator(attempt=attempt)
                        try:
                            self.rpc = self._connect_rpc()
                        except (RuntimeError, TimeoutError, ConnectionError):
                            # either it died again (the death branch above
                            # consumes the next attempt) or it is alive but
                            # slow to serve — keep re-trying the connect
                            # while the process lives so a late endpoint
                            # is still picked up
                            log.warning("respawned coordinator not "
                                        "reachable yet; will keep trying")
                            while self.coordinator_proc.poll() is None:
                                try:
                                    self.rpc = self._connect_rpc(
                                        timeout_s=10)
                                    break
                                except (RuntimeError, TimeoutError,
                                        ConnectionError):
                                    continue
                        continue
                    status = terminal or {
                        "status": "FAILED",
                        "reason": "coordinator process died",
                    }
                    break
                time.sleep(interval)
                continue
            rendered = self._render_tasks(infos)
            if not infos and status.get("phase") not in (None, "", "READY"):
                # slice allocation in flight: show WHY there are no tasks
                rendered = f"Provisioning TPU capacity: {status['phase']}"
            if rendered != last_rendered:
                print(rendered)
                last_rendered = rendered
            for listener in self.listeners:
                try:
                    listener(infos)
                except Exception:
                    log.exception("task update listener failed")
            if status.get("tensorboard_url"):
                self.tensorboard_url = status["tensorboard_url"]
            if status["status"] != "RUNNING":
                break
            time.sleep(interval)
        self.final_status = status
        self._signal_finish()
        ok = status["status"] == "SUCCEEDED"
        log.info("application %s: %s (%s)", self.app_id, status["status"],
                 status.get("reason") or "ok")
        return ok

    def _respawn_fence_s(self) -> float:
        """How long to wait before respawning a dead coordinator so the old
        gang is certainly off the chips. Worst-case agent exit after the
        coordinator dies: the outage clock starts only after the FIRST
        failed ping returns (one interval wait + one RPC timeout,
        uncounted), the horizon check fires at the completion of a later
        ping (one more interval + timeout of granularity), then the
        checkpoint grace and the agent's +2 s SIGKILL-backstop sleep run.
        Budget all of it, plus margin."""
        from tony_tpu_torch.coordinator.liveness import (
            heartbeat_rpc_timeout_s,
            liveness_expiry_s,
        )

        hb_s = self.conf.get_int("tony.task.heartbeat-interval-ms",
                                 1000) / 1000
        grace_s = self.conf.get_int("tony.task.preemption-grace-ms",
                                    15_000) / 1000
        lag = 2 * (hb_s + heartbeat_rpc_timeout_s(self.conf))
        return liveness_expiry_s(self.conf) + lag + grace_s + 2 + 3

    def _status_from_file(self) -> dict | None:
        path = os.path.join(self.job_dir, "status.json")
        if os.path.exists(path):
            with open(path) as f:
                return json.load(f)
        return None

    def _signal_finish(self) -> None:
        """Ref: signalAMToFinish :1101-1111."""
        if self.rpc is None:
            return
        try:
            self.rpc.call("finish_application", retries=0)
        except (ConnectionError, TimeoutError, Exception):
            pass
        if self.coordinator_proc:
            try:
                self.coordinator_proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                log.warning("coordinator slow to exit; killing")
                self.force_kill()
        self.rpc.close()

    @staticmethod
    def _render_tasks(infos: list[TaskInfo]) -> str:
        """Ref: client status tables TonyClient.java:1123-1183."""
        if not infos:
            return "(no tasks scheduled yet)"
        width = max(len(f"{i.name}:{i.index}") for i in infos)
        lines = [f"  {f'{i.name}:{i.index}'.ljust(width)}  {i.status:<9} {i.url}"
                 for i in infos]
        return "\n".join(["Task status:"] + lines)

    # ---------------------------------------------------------------- control
    def force_kill(self) -> None:
        """Ref: forceKillApplication :1268."""
        if self.rpc is not None:
            try:
                self.rpc.call("force_kill", retries=0)
            except Exception:
                pass
        if self.coordinator_proc and self.coordinator_proc.poll() is None:
            try:
                os.killpg(self.coordinator_proc.pid, signal.SIGKILL)
            except (ProcessLookupError, PermissionError):
                self.coordinator_proc.kill()

    def run(self) -> bool:
        """Full submission flow (ref: TonyClient.run :195 / start :1290)."""
        self.init()
        self.stage()
        self.start_coordinator()
        try:
            return self.monitor()
        except BaseException:
            self.force_kill()
            raise
