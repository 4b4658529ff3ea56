"""The coordinator process — ApplicationMaster equivalent.

The PyTorch port's copy of ``tony_tpu/coordinator/coordinator.py``.

Reference: ApplicationMaster.java (1347 LoC): registers control-plane RPC +
metrics RPC servers, builds the session, gang-schedules tasks through the
DAG scheduler, launches per-task agents, runs a heartbeat liveness monitor
and a monitor loop (timeout / registration-timeout / startup-failure /
training-finished / client stop), retries the whole session on failure
(session epoch++), emits history events, and supports a preprocess /
single-node mode where the coordinator itself hosts the user process
(doPreprocessingJob :780-832).

Process entry: ``python -m tony_tpu_torch.coordinator --conf <tony-final.json>
--app-id <id> --job-dir <dir>``. The client discovers the RPC endpoint via
``coordinator.json`` written into the job dir (stands in for the YARN
application report's host:port).
"""

from __future__ import annotations

import argparse
import contextlib
import glob
import json
import logging
import os
import shutil
import shlex
import threading
import time

from tony_tpu_torch import constants as C
from tony_tpu_torch.config import ConfError, TonyConf
from tony_tpu_torch.coordinator.chips import ChipAllocator
from tony_tpu_torch.coordinator.launcher import Launcher, LocalProcessLauncher
from tony_tpu_torch.coordinator.liveness import LivenessMonitor
from tony_tpu_torch.coordinator.provisioner import (
    ProvisioningError,
    StaticProvisioner,
    preflight_chips,
    provisioner_from_conf,
)
from tony_tpu_torch.events import (
    EventHandler,
    application_finished,
    application_inited,
    task_finished,
    task_started,
)
from tony_tpu_torch.metrics import MetricsStore
from tony_tpu_torch.rpc import RpcServer
from tony_tpu_torch.runtime import get_am_adapter
from tony_tpu_torch.scheduler import TaskScheduler
from tony_tpu_torch.session import Session, SessionStatus
from tony_tpu_torch.utils import execute_shell, local_host_name, python_interpreter

log = logging.getLogger(__name__)


class ClientRpcHandler:
    """The 8 control-plane verbs (ref: inner RpcForClient,
    ApplicationMaster.java:854-970; proto service
    tensorflow_cluster_service_protos.proto:11-20)."""

    def __init__(self, coord: "Coordinator"):
        self._coord = coord

    def get_task_infos(self):
        return [i.to_dict() for i in self._coord.session.task_infos()]

    def get_cluster_spec(self, task_id: str):
        return self._coord.cluster_spec_if_ready(task_id)

    def register_worker_spec(self, task_id: str, spec: str):
        """Ref: registerWorkerSpec :907-926 — returns the cluster spec only
        once the runtime's gate opens; agents poll until non-null."""
        return self._coord.register_worker_spec(task_id, spec)

    def register_tensorboard_url(self, url: str):
        self._coord.tensorboard_url = url
        log.info("TensorBoard registered at %s", url)
        return True

    def register_execution_result(self, task_id: str, exit_code: int,
                                  session_id: int = -1,
                                  preempted: bool = False):
        return self._coord.register_execution_result(
            task_id, int(exit_code), int(session_id), bool(preempted))

    def finish_application(self):
        self._coord.client_done.set()
        return self._coord.application_status()

    def task_executor_heartbeat(self, task_id: str):
        """Liveness ping; the response piggybacks queued coordinator->agent
        commands (profile requests etc.) — the rebuild's channel for
        on-demand actions the reference lacks."""
        self._coord.liveness.ping(task_id)
        return {"commands": self._coord.drain_commands(task_id)}

    def request_profile(self, task_id: str, num_steps: int = 5):
        """Queue an on-demand xplane trace of a task (greenfield vs the
        reference; SURVEY.md section 5.1)."""
        return self._coord.queue_command(
            task_id, {"type": "profile", "num_steps": int(num_steps)})

    def resize_role(self, role: str, instances: int):
        """Elastic resize: checkpoint-aware gang restart at the new size
        (real elasticity where the reference stubs it — see
        tony_tpu_torch/elastic.py)."""
        return self._coord.request_resize(role, int(instances))

    def register_callback_info(self, task_id: str, info: str):
        self._coord.am_adapter.receive_task_callback_info(task_id, info)
        return True

    # rebuild extra: no RM exists to serve the application report, so status
    # is a first-class verb (ref: client polls YarnClient.getApplicationReport)
    def get_application_status(self):
        return self._coord.application_status()

    def force_kill(self):
        log.warning("client requested force kill")
        self._coord.killed.set()
        return True


class Coordinator:
    def __init__(self, conf: TonyConf, app_id: str, job_dir: str,
                 launcher: Launcher | None = None):
        self.conf = conf
        self.app_id = app_id
        self.job_dir = job_dir
        os.makedirs(job_dir, exist_ok=True)
        self.secret = os.environ.get(C.JOB_TOKEN) or None
        if not conf.get_bool("tony.application.security.enabled"):
            self.secret = None
        # preprocess-stage stdout params fed to training containers
        # (ref: containerEnv[TASK_PARAM_KEY], ApplicationMaster.java:826)
        self._model_params: str | None = None
        self.framework = str(conf.get("tony.application.framework"))
        self.mode = str(conf.get("tony.application.distributed-mode"))
        self.am_adapter = get_am_adapter(self.framework)
        self.am_adapter.validate_and_update_config(conf)
        self.session = Session(conf, session_id=0)
        self.scheduler: TaskScheduler | None = None
        self.provisioner = provisioner_from_conf(conf, app_id)
        # launcher construction is deferred until after provisioning: in
        # ssh mode the host list may only exist once the slice is READY —
        # but misconfig must still kill the process at startup (ref:
        # validateAndUpdateConfig fails the submission, not the session)
        self._launcher: Launcher | None = launcher
        if launcher is None:
            self._validate_launcher_conf()
        self._chips: ChipAllocator | None = None
        self.metrics = MetricsStore()
        self.liveness = LivenessMonitor(
            conf.get_int("tony.task.heartbeat-interval-ms", 1000),
            conf.get_int("tony.task.max-missed-heartbeats", 25),
            self._on_task_deemed_dead,
        )
        host = str(conf.get("tony.coordinator.host", "127.0.0.1"))
        self.tls: tuple[str, str] | None = None
        self._tls_fp = ""
        if conf.get_bool("tony.application.security.tls"):
            from tony_tpu_torch.rpc.tls import cert_fingerprint, mint_self_signed

            # normally minted by the client at staging; mint here too so a
            # directly-constructed coordinator (tests, tony-mini) works
            self.tls = mint_self_signed(job_dir, f"tony-{app_id}")
            self._tls_fp = cert_fingerprint(self.tls[0])
        self.rpc = RpcServer(ClientRpcHandler(self), host=host,
                             secret=self.secret, tls=self.tls)
        self.metrics_rpc = RpcServer(self.metrics, host=host,
                                     secret=self.secret, tls=self.tls)
        history_root = str(conf.get("tony.history.location") or
                           os.path.join(job_dir, "history"))
        self.events = EventHandler(history_root, app_id)
        self.client_done = threading.Event()
        self.killed = threading.Event()
        self.tensorboard_url = ""
        self.attempt = 0
        self._launch_time: dict[str, float] = {}
        self._lock = threading.Lock()
        self._worker_termination_done = False
        self._pending_commands: dict[str, list[dict]] = {}
        self._pending_resize: dict[str, int] = {}
        self._resizing = False

    # -------------------------------------------------- agent command queue
    def queue_command(self, task_id: str, command: dict) -> bool:
        """Queue a command for delivery on the task's next heartbeat."""
        with self._lock:
            if not self.session.has_slot(task_id):
                return False
            self._pending_commands.setdefault(task_id, []).append(command)
        return True

    def drain_commands(self, task_id: str) -> list[dict]:
        with self._lock:
            return self._pending_commands.pop(task_id, [])

    # ------------------------------------------------------- elastic resize
    def request_resize(self, role: str, instances: int) -> bool:
        """Validate + queue an elastic resize; the monitor loop performs it
        (see tony_tpu_torch/elastic.py for the protocol)."""
        if instances < 1:
            return False
        with self._lock:
            if role not in self.session.tasks:
                return False
            self._pending_resize[role] = instances
        return True

    def _take_pending_resize(self) -> dict[str, int]:
        with self._lock:
            resize, self._pending_resize = self._pending_resize, {}
            return resize

    def _perform_resize(self, resize: dict[str, int]) -> None:
        """Checkpoint-aware gang restart: notify tasks, grace, rebuild the
        session at the new sizes, relaunch."""
        from tony_tpu_torch.events import session_resized

        self._resizing = True
        try:
            grace_s = self.conf.get_int("tony.elastic.grace-ms", 15_000) / 1000
            with self._lock:
                live = [t for t in self.session.all_tasks() if not t.completed]
                for task in live:
                    self._pending_commands.setdefault(task.id, []).append(
                        {"type": "save_and_exit"})
            log.info("elastic resize to %s: notified %d tasks, grace %.1fs",
                     resize, len(live), grace_s)
            deadline = time.monotonic() + grace_s
            while time.monotonic() < deadline:
                if all(t.completed for t in self.session.all_tasks()):
                    break
                time.sleep(0.1)
            for role, n in resize.items():
                self.conf.set(f"tony.{role}.instances", n)
            self._reset_session()
            # stale control files must not make the next epoch exit at step
            # 0 — cleaned after the old agents are dead so none can rewrite
            # one (agents also self-clean at startup, covering ssh hosts)
            from tony_tpu_torch.elastic import CONTROL_FILENAME

            for path in glob.glob(os.path.join(
                    self.job_dir, CONTROL_FILENAME + "*")):
                with contextlib.suppress(OSError):
                    os.remove(path)
            self.events.emit(session_resized(
                self.app_id, self.session.session_id, resize))
            self._start_attempt()
        finally:
            self._resizing = False

    # ------------------------------------------------------------------ rpc
    def cluster_spec_if_ready(self, task_id: str) -> str | None:
        if self.am_adapter.can_start_task(self.mode, task_id):
            return self.am_adapter.construct_cluster_spec(task_id)
        return None

    def register_worker_spec(self, task_id: str, spec: str) -> str | None:
        task = self.session.register(task_id, spec)
        if task is None:
            log.warning("registration for unknown task %s", task_id)
            return None
        self.liveness.register(task_id)
        log.info("registered %s at %s (%d/%d)", task_id, spec,
                 self.session.num_registered, self.session.total_expected)
        return self.cluster_spec_if_ready(task_id)

    def register_execution_result(self, task_id: str, exit_code: int,
                                  session_id: int = -1,
                                  preempted: bool = False) -> bool:
        """A result from a previous session epoch (pre-resize/retry gang)
        must not complete the current epoch's task of the same id (ref:
        sessionId guard on TonySession results)."""
        if session_id >= 0 and session_id != self.session.session_id:
            log.info("ignoring stale result %s (epoch %d != %d)", task_id,
                     session_id, self.session.session_id)
            return False
        log.info("task %s registered exit code %d%s", task_id, exit_code,
                 " (preempted)" if preempted else "")
        self._complete_task(task_id, exit_code, preempted=preempted)
        return True

    # ---------------------------------------------------------- completions
    def _complete_task(self, task_id: str, exit_code: int,
                       preempted: bool = False) -> None:
        delay = os.environ.get(C.TEST_COMPLETION_DELAY)
        if delay:  # fault injection (ref: ApplicationMaster.java:1074-1083)
            time.sleep(int(delay) / 1000)
        if self._resizing:
            # the gang is being torn down for an elastic restart; exits in
            # this window (EXIT_RESIZE or kills) are not failures — record
            # completion so the grace loop can finish early, skip the
            # session's exit-status policy
            from tony_tpu_torch.elastic import EXIT_RESIZE

            self.liveness.unregister(task_id)
            if self._chips is not None:
                self._chips.release(task_id)
            with self._lock:
                task = self.session.get_task_by_id(task_id)
                if task is not None:
                    # a cooperative EXIT_RESIZE is a clean exit, not a failure
                    task.set_exit_status(
                        0 if exit_code == EXIT_RESIZE else exit_code)
            return
        with self._lock:
            task = self.session.get_task_by_id(task_id)
            if task is None or task.completed:
                return
            # unregister first: a completed task must not expire later
            # (ref: 3-way race comment, ApplicationMaster.java:928-956)
            self.liveness.unregister(task_id)
            if self._chips is not None:
                self._chips.release(task_id)
            was_registered = task.registered
            self.session.on_task_completed(task.role, task.index, exit_code)
            if preempted and exit_code != 0 and \
                    self.session.status == SessionStatus.FAILED and \
                    self.session.failure_reason and \
                    f"task {task_id} failed" in self.session.failure_reason:
                # annotate so operators (and the history) see this was the
                # platform reclaiming capacity, not the training failing —
                # but only when THIS task's failure is the recorded reason
                # (a preempted worker arriving after a genuine chief crash
                # must not clobber the real first-failure reason)
                self.session.failure_reason += \
                    " [preempted: spot reclaim / maintenance]"
            self.events.emit(task_finished(
                task.role, task.index, task.status.name,
                self.metrics.get_metrics(task_id)))
            if not was_registered:
                # completed without ever registering -> startup failure
                # (ref: startupFailed :1271-1301)
                self.session.fail(
                    f"task {task_id} exited ({exit_code}) before registering")
        if self.scheduler is not None:
            self.scheduler.on_role_instance_completed(task.role)

    @property
    def launcher(self) -> Launcher:
        if self._launcher is None:
            self._launcher = self._launcher_from_conf()
        return self._launcher

    def _validate_launcher_conf(self) -> None:
        """The subset of _launcher_from_conf's checks that need no
        provisioned hosts, run eagerly at construction."""
        mode = str(self.conf.get("tony.application.launch-mode", "local"))
        docker_on = self.conf.get("tony.docker.enabled")
        if docker_on and mode not in ("local", "docker"):
            raise ValueError(
                f"tony.docker.enabled conflicts with launch-mode={mode}: "
                "docker launch runs containers on this host only")
        if (mode == "docker" or docker_on) and \
                not str(self.conf.get("tony.docker.image", "")):
            raise ValueError("docker launch requires tony.docker.image")
        if mode not in ("local", "docker", "ssh"):
            raise ValueError(f"unknown tony.application.launch-mode: {mode}")
        if mode == "ssh" and isinstance(self.provisioner, StaticProvisioner) \
                and not self.provisioner.hosts:
            raise ValueError(
                "launch-mode=ssh requires tony.application.hosts or a "
                "provisioner (tony.provisioner.mode)")

    def _provision(self) -> None:
        """Acquire capacity before the gang (the RM conversation — ref:
        TonyClient.submitApplication :314-349). Static mode only preflights
        local chip demand; tpu-vm/queued modes create/adopt the slice and
        feed its hosts to the ssh launcher."""
        mode = str(self.conf.get("tony.application.launch-mode", "local"))
        if isinstance(self.provisioner, StaticProvisioner):
            if mode in ("local", "docker"):
                # both modes share THIS host's chips (_task_env enforces
                # the same pair) — over-demand must die here, not mid-gang
                err = preflight_chips(self.conf)
                if err:
                    raise ProvisioningError(err)
            return
        hosts = self.provisioner.provision()
        if mode == "ssh" and hosts:
            # provisioned hosts replace any statically configured list —
            # the slice we just created IS the capacity for this job
            self.conf.set("tony.application.hosts", ",".join(hosts))

    def _launcher_from_conf(self) -> Launcher:
        """Pick agent placement from tony.application.launch-mode (local
        subprocesses, or ssh onto the slice's TPU-VM hosts)."""
        mode = str(self.conf.get("tony.application.launch-mode", "local"))
        if self.conf.get("tony.docker.enabled") and mode not in ("local", "docker"):
            raise ValueError(
                f"tony.docker.enabled conflicts with launch-mode={mode}: "
                "docker launch runs containers on this host only")
        if mode == "docker" or self.conf.get("tony.docker.enabled"):
            from tony_tpu_torch.coordinator.launcher import DockerLauncher

            image = str(self.conf.get("tony.docker.image", ""))
            if not image:
                raise ValueError("docker launch requires tony.docker.image")
            mounts = [m.strip() for m in
                      str(self.conf.get("tony.docker.mounts", "")).split(",")
                      if m.strip()]
            extra = shlex.split(str(self.conf.get("tony.docker.run-args", "")))
            return DockerLauncher(
                image, self._on_task_process_exit, mounts=mounts,
                extra_args=extra,
                docker_bin=str(self.conf.get("tony.docker.bin", "docker")),
                workdir=self.job_dir)
        if mode == "ssh":
            from tony_tpu_torch.coordinator.launcher import SshLauncher

            hosts = [h.strip() for h in
                     str(self.conf.get("tony.application.hosts", "")).split(",")
                     if h.strip()]
            if not hosts:
                raise ValueError(
                    "launch-mode=ssh requires tony.application.hosts")
            return SshLauncher(
                hosts, self._on_task_process_exit,
                remote_pythonpath=str(
                    self.conf.get("tony.application.remote-pythonpath", "")),
                ssh_bin=str(self.conf.get("tony.application.ssh-bin", "ssh")),
                app_id=self.app_id,
                chips_per_host=self.conf.get_int("tony.tpu.chips-per-host",
                                                 0),
                ship_job_dir=self.job_dir
                if self.conf.get_bool("tony.ssh.ship-job-dir") else "",
                remote_job_root=str(
                    self.conf.get("tony.ssh.remote-job-root", "")))
        if mode != "local":
            raise ValueError(f"unknown tony.application.launch-mode: {mode}")
        return LocalProcessLauncher(self._on_task_process_exit,
                                    workdir=self.job_dir)

    def _on_task_process_exit(self, task_id: str, exit_code: int) -> None:
        """Launcher backup path (ref: onContainersCompleted ->
        processFinishedContainer :1234-1268). Idempotent with the RPC result
        registration."""
        self._complete_task(task_id, exit_code)

    def _on_task_deemed_dead(self, task_id: str) -> None:
        """Ref: onTaskDeemedDead :1225-1232 — fail the application."""
        self.session.fail(f"task {task_id} missed heartbeats; deemed dead")
        self.launcher.kill_task(task_id)

    # ------------------------------------------------------------ lifecycle
    def prepare(self) -> None:
        """Ref: prepare :443-527."""
        self.rpc.start()
        self.metrics_rpc.start()
        self.liveness.start()
        self.events.start()
        self._write_endpoint_file()
        log.info("coordinator for %s listening on %s:%d (metrics %d)",
                 self.app_id, self.rpc.host, self.rpc.port, self.metrics_rpc.port)

    def _write_endpoint_file(self) -> None:
        info = {
            "app_id": self.app_id,
            "host": self.rpc.host,
            "port": self.rpc.port,
            "metrics_port": self.metrics_rpc.port,
            "pid": os.getpid(),
        }
        path = os.path.join(self.job_dir, "coordinator.json")
        with open(path + ".tmp", "w") as f:
            json.dump(info, f)
        os.replace(path + ".tmp", path)

    def _start_attempt(self) -> None:
        """Ref: start() :578-609 — build session, schedule the gang.
        With enable-preprocess AND training roles, the preprocess command
        runs first on the coordinator and its scraped stdout params feed
        the training containers (ref: run() :578-609 calls
        doPreprocessingJob then falls through to buildTonySession)."""
        if os.environ.get(C.TEST_COORD_THROW) and self.attempt == 0:
            raise RuntimeError("injected coordinator exception (TEST_COORD_THROW)")
        single_node = not self.session.requests
        if self.conf.get_bool("tony.application.enable-preprocess") or \
                single_node:
            ok = self._run_preprocess(single_node=single_node)
            if single_node or not ok:
                return  # terminal: status set by _run_preprocess
        self.am_adapter.set_session(self.session)
        self.scheduler = TaskScheduler(self.session, self._allocate_role, self.conf)
        self.events.emit(application_inited(
            self.app_id, self.session.total_expected, local_host_name()))
        self.scheduler.schedule()

    def _allocate_role(self, req) -> None:
        """Launch every instance of a role (ref: RMCallbackHandler +
        ContainerLauncher collapsed: no container negotiation on TPU)."""
        for i in range(req.instances):
            task = self.session.init_task(req.role, i)
            if task is None:
                continue
            env = self._task_env(req, task)
            log_path = os.path.join(self.job_dir, "logs",
                                    f"{task.role}-{task.index}{C.LOG_SUFFIX}")
            task.log_url = log_path
            self._launch_time[task.id] = time.monotonic()
            self.launcher.launch(task, env, log_path)
            self.events.emit(task_started(task.role, task.index, local_host_name()))

    @property
    def chips(self) -> ChipAllocator:
        """This host's chip pool for tasks sharing the coordinator host
        (local/docker launch modes). Sized from DISCOVERY only: when the
        host shows no chips, requests stay advisory (same stance as
        preflight_chips — a CPU CI host must run, not fail mid-launch;
        tony.tpu.chips-per-host is a slice-sizing hint, not a claim about
        this host)."""
        if self._chips is None:
            total = 0
            from tony_tpu_torch.utils.gpu_info import GpuDiscoverer

            try:
                total = len(GpuDiscoverer(str(self.conf.get(
                    "tony.tpu.info-exec-path", "")))
                    .get_device_information().chips)
            except Exception:
                log.exception("chip discovery failed; chips advisory")
            self._chips = ChipAllocator(total)
        return self._chips

    def _task_env(self, req, task) -> dict[str, str]:
        """Agent env (ref: ContainerLauncher env :1168-1188)."""
        retries = self.conf.get_int("tony.coordinator.retry-count", 0)
        env = {
            C.JOB_NAME: task.role,
            C.TASK_INDEX: str(task.index),
            C.TASK_NUM: str(req.instances),
            C.IS_CHIEF: "true" if self.session.is_chief(task.role, task.index) else "false",
            C.JOB_ID: self.app_id,
            C.SESSION_ID: str(self.session.session_id),
            C.DISTRIBUTED_MODE: self.mode,
            C.ATTEMPT_NUMBER: str(self.attempt),
            C.NUM_AM_RETRIES: str(retries),
            C.COORDINATOR_HOST: self.rpc.host,
            C.COORDINATOR_PORT: str(self.rpc.port),
            C.METRICS_PORT: str(self.metrics_rpc.port),
            "TONY_CONF_PATH": os.path.join(self.job_dir, C.TONY_FINAL_CONF),
            C.JOB_DIR: self.job_dir,
            # the job-scoped cache dir of the env contract; the port
            # has no XLA compile cache and nothing of it reads the dir
            C.COMPILE_CACHE_DIR: os.path.join(self.job_dir, "compile-cache"),
            "TONY_TASK_COMMAND": self._task_command(req),
        }
        mode = str(self.conf.get("tony.application.launch-mode", "local"))
        if req.chips > 0 and mode in ("local", "docker") \
                and self.chips.total > 0:
            # shared host: disjoint device subsets per task (ref: YARN
            # hands each container its own GPU set, util/Utils.java:393-419)
            ids = self.chips.allocate(task.id, req.chips)
            env[C.CUDA_VISIBLE_DEVICES] = ",".join(str(i) for i in ids)
            env[C.CUDA_DEVICE_ORDER] = C.PCI_BUS_ID
        elif req.chips > 0 and mode == "ssh":
            # the ssh launcher owns placement, so it also owns the
            # per-host chip pools: ship the demand, it packs + assigns
            env[C.TASK_CHIPS] = str(req.chips)
        # memory/vcores reach the launcher ONLY when explicitly configured
        # for the role: the schema default (2g) must not impose an rlimit
        # on jax processes that map far more address space than they touch
        if f"tony.{req.role}.memory" in self.conf:
            env[C.TASK_MEMORY] = str(req.memory)
        if f"tony.{req.role}.vcores" in self.conf:
            env[C.TASK_VCORES] = str(req.vcores)
        if self.secret:
            env[C.JOB_TOKEN] = self.secret
        if self._tls_fp:
            env[C.TLS_FINGERPRINT] = self._tls_fp
        if self._model_params is not None:
            env[C.MODEL_PARAMS] = self._model_params
        ckpt = self._checkpoint_dir()
        if ckpt:
            # restart-with-resume (no ref analog — TonY's AM retry restarts
            # user scripts cold, SURVEY 5.4): every attempt gets the same
            # checkpoint root; on retry we also advertise the newest step
            # found so the task can log/assert what it resumes from
            env[C.CHECKPOINT_DIR] = ckpt
            from tony_tpu_torch.utils.fs import scan_latest_step

            step = scan_latest_step(ckpt)
            if step is not None:
                env[C.RESUME_STEP] = str(step)
        return env

    def _checkpoint_dir(self) -> str | None:
        path = str(self.conf.get("tony.application.checkpoint-dir", ""))
        if not path:
            return None
        from tony_tpu_torch.utils.remotefs import is_remote

        if is_remote(path):
            # gs:// checkpoint roots pass through untouched;
            # scan_latest_step simply reports no local steps
            return path
        if not os.path.isabs(path):
            path = os.path.join(self.job_dir, path)
        os.makedirs(path, exist_ok=True)
        return path

    def _task_command(self, req) -> str:
        """Ref: TonyClient.buildTaskCommand :618-635 — role command override,
        else venv python + executes + task params."""
        if req.command:
            return req.command
        executes = str(self.conf.get("tony.application.executes", ""))
        if not executes:
            return ""
        params = str(self.conf.get("tony.application.task-params", ""))
        venv = str(self.conf.get("tony.application.python-command", "")) or \
            python_interpreter(os.path.join(self.job_dir, "venv"))
        if executes.endswith(".py"):
            return f"{venv} {executes} {params}".strip()
        return f"{executes} {params}".strip()

    def _run_preprocess(self, single_node: bool = True) -> bool:
        """Single-node / preprocess mode: the coordinator hosts the user
        process itself (ref: doPreprocessingJob :780-832). Returns True on
        success. In preprocess-then-train mode (``single_node=False``) a
        success is NOT terminal: the task's stdout is scraped for a
        ``Model parameters: <params>`` line and the remainder is exported
        to every training container as ``MODEL_PARAMS`` (ref:
        :819-832 scraping amstdout.log into Constants.TASK_PARAM_KEY)."""
        cmd = str(self.conf.get("tony.coordinator.command", "")) \
            if not single_node else ""
        cmd = cmd or self._task_command_single()
        log.info("running preprocess/single-node command: %s", cmd)
        task_log = os.path.join(self.job_dir, "logs", "coordinator-task.log")
        code = execute_shell(
            cmd,
            self.conf.get_int("tony.task.executor.execution-timeout-ms", 0),
            env={C.JOB_ID: self.app_id, C.JOB_NAME: "coordinator",
                 C.PREPROCESSING_JOB: "true"},
            log_path=task_log,
        )
        if code != 0:
            self.session.fail(f"preprocess/single-node task exited {code}")
            self._preprocess_ran = True
            return False
        if single_node:
            self.session.status = SessionStatus.SUCCEEDED
            self._preprocess_ran = True
            return True
        self._model_params = self._scrape_model_params(task_log)
        return True

    @staticmethod
    def _scrape_model_params(task_log: str) -> str | None:
        """First ``Model parameters: `` stdout line's remainder, or None
        (ref: ApplicationMaster.java:819-832)."""
        marker = "Model parameters: "
        try:
            with open(task_log, errors="replace") as f:
                for line in f:
                    if marker in line:
                        return line.split(marker, 1)[1].rstrip("\n")
        except OSError:
            log.warning("preprocess log %s unreadable; no MODEL_PARAMS",
                        task_log)
        return None

    def _task_command_single(self) -> str:
        executes = str(self.conf.get("tony.application.executes", ""))
        params = str(self.conf.get("tony.application.task-params", ""))
        if executes.endswith(".py"):
            return f"{python_interpreter(None)} {executes} {params}".strip()
        return f"{executes} {params}".strip()

    # --------------------------------------------------------------- monitor
    def _monitor(self) -> SessionStatus:
        """Ref: monitor() :634-715."""
        interval = self.conf.get_int("tony.coordinator.monitor-interval-ms", 1000) / 1000
        timeout_ms = self.conf.get_int("tony.application.timeout-ms", 0)
        reg_timeout_s = self.conf.get_int(
            "tony.coordinator.registration-timeout-ms", 900_000) / 1000
        start = time.monotonic()
        while True:
            if getattr(self, "_preprocess_ran", False):
                return self.session.status
            if self.killed.is_set():
                self.session.fail("killed by client")
                return self.session.status
            if timeout_ms and (time.monotonic() - start) * 1000 > timeout_ms:
                self.session.fail(f"application timed out after {timeout_ms} ms")
                return self.session.status
            if self.session.status != SessionStatus.RUNNING:
                return self.session.status
            resize = self._take_pending_resize()
            if resize:
                self._perform_resize(resize)
                continue
            if self.session.training_finished():
                return self.session.update_session_status()
            self._check_registration_timeouts(reg_timeout_s)
            self._maybe_kill_chief_for_test()
            time.sleep(interval)

    def _check_registration_timeouts(self, reg_timeout_s: float) -> None:
        """Ref: registrationTimeout :1309-1329."""
        now = time.monotonic()
        for task in self.session.all_tasks():
            if task.registered or task.completed:
                continue
            launched = self._launch_time.get(task.id)
            if launched is not None and now - launched > reg_timeout_s:
                self.session.fail(
                    f"task {task.id} failed to register within {reg_timeout_s:.0f}s")
                return

    def _maybe_kill_chief_for_test(self) -> None:
        """Fault injection (ref: killChiefWorkerIfTesting :1333-1344)."""
        if self._worker_termination_done or not os.environ.get(C.TEST_WORKER_TERMINATION):
            return
        if not self.session.all_registered():
            return
        for task in self.session.all_tasks():
            if self.session.is_chief(task.role, task.index):
                log.warning("TEST_WORKER_TERMINATION: killing chief %s", task.id)
                self.launcher.kill_task(task.id)
                self._worker_termination_done = True
                return

    # ------------------------------------------------------------------ run
    def run(self) -> bool:
        """Ref: run() :357-435 with the retry loop :382-422."""
        self.prepare()
        retries = self.conf.get_int("tony.coordinator.retry-count", 0)
        status = SessionStatus.FAILED
        try:
            try:
                self._provision()
            except (ProvisioningError, ConfError) as e:
                log.error("provisioning failed: %s", e)
                self.session.fail(f"provisioning failed: {e}")
                return self._stop(SessionStatus.FAILED)
            for self.attempt in range(retries + 1):
                try:
                    self._start_attempt()
                    if os.environ.get(C.TEST_COORD_CRASH) \
                            and self.attempt == 0 \
                            and os.environ.get(C.COORD_CLIENT_ATTEMPT,
                                               "0") == "0":
                        # crash exactly once: a client-respawned coordinator
                        # (attempt env > 0) proceeds, so respawn is testable
                        log.error("TEST_COORD_CRASH: hard-exiting coordinator")
                        os._exit(1)
                    status = self._monitor()
                except ConfError:
                    raise
                except Exception as e:
                    log.exception("coordinator attempt %d crashed", self.attempt)
                    self.session.fail(f"coordinator exception: {e}")
                    status = SessionStatus.FAILED
                if status == SessionStatus.SUCCEEDED or self.killed.is_set():
                    break
                if self.attempt < retries:
                    log.warning("attempt %d failed (%s); retrying",
                                self.attempt, self.session.failure_reason)
                    self._reset_session()
            return self._stop(status)
        finally:
            self.rpc.stop()
            self.metrics_rpc.stop()
            self.liveness.stop()

    def _reset_session(self) -> None:
        """Ref: reset() :612-628 — stop containers, rebuild session epoch."""
        self.launcher.stop_all()
        # a killed task from the old epoch never reports a result, so its
        # liveness entry would expire against the healthy new session
        self.liveness.clear()
        if self._chips is not None:
            self._chips.reset()
        old_id = self.session.session_id
        self.session = Session(self.conf, session_id=old_id + 1)
        self._launch_time.clear()
        self._worker_termination_done = False
        # a failed preprocess must not poison the retry: the flag would
        # make _monitor return before the fresh attempt's gang runs
        self._preprocess_ran = False
        self._model_params = None
        with self._lock:
            # undrained commands must not leak into the new epoch's tasks
            self._pending_commands.clear()
        self.am_adapter = get_am_adapter(self.framework)
        self.am_adapter.validate_and_update_config(self.conf)

    def _stop(self, status: SessionStatus) -> bool:
        """Ref: stop() :735-777 — stop containers, emit final event, wait
        briefly for the client's finish signal, finalize history."""
        if self._launcher is not None:  # never constructed if provisioning failed
            self._launcher.stop_all()
        self.provisioner.deprovision()
        final = "SUCCEEDED" if status == SessionStatus.SUCCEEDED else "FAILED"
        failed = sum(1 for t in self.session.all_tasks() if t.status.name == "FAILED")
        self.events.emit(application_finished(self.app_id, final, failed))
        self._archive_metrics()
        self._write_status_file(final)
        self.am_adapter.destroy()
        self.client_done.wait(timeout=30)
        self.events.stop(final)
        log.info("application %s finished: %s (%s)", self.app_id, final,
                 self.session.failure_reason or "ok")
        return status == SessionStatus.SUCCEEDED

    def _archive_metrics(self) -> None:
        """Copy training-metric jsonl files (written by train.fit sinks into
        <job_dir>/metrics/) into the history dir so the portal can serve
        them after the job dir is gone (no reference analog: TonY's history
        holds only events + config, SURVEY.md 5.5)."""
        src = os.path.join(self.job_dir, "metrics")
        if not os.path.isdir(src):
            return
        # wholly best-effort: a full/read-only history mount must not abort
        # _stop() (status file, adapter destroy, jhist finalize come after)
        try:
            dst = os.path.join(self.events.job_dir, "metrics")
            os.makedirs(dst, exist_ok=True)
            names = os.listdir(src)
        except OSError:
            log.exception("failed to create metrics archive dir")
            return
        for name in names:
            if name.endswith(".jsonl"):
                try:
                    shutil.copy2(os.path.join(src, name),
                                 os.path.join(dst, name))
                except OSError:
                    log.exception("failed to archive metrics file %s", name)

    def _write_status_file(self, final: str) -> None:
        path = os.path.join(self.job_dir, "status.json")
        with open(path + ".tmp", "w") as f:
            json.dump({
                "status": final,
                "reason": self.session.failure_reason,
                "tensorboard_url": self.tensorboard_url,
                "tasks": [i.to_dict() for i in self.session.task_infos()],
            }, f, indent=2)
        os.replace(path + ".tmp", path)

    def application_status(self) -> dict:
        status = self.session.status
        # Ref semantics: the client polls the *application* report, which
        # stays RUNNING across AM retries (YARN only finalizes at app end).
        # Without this, the client's poll can observe the transient FAILED
        # between a crashed attempt and _reset_session() and signal finish,
        # suppressing the retry (race window is up to one monitor interval).
        retries = self.conf.get_int("tony.coordinator.retry-count", 0)
        if status == SessionStatus.FAILED and self.attempt < retries \
                and not self.killed.is_set():
            return {
                "status": SessionStatus.RUNNING.value,
                "reason": f"attempt {self.attempt} failed "
                          f"({self.session.failure_reason}); retrying",
                "session_id": self.session.session_id,
                "attempt": self.attempt,
                "tensorboard_url": self.tensorboard_url,
                "phase": self.provisioner.state,
            }
        return {
            "status": status.value,
            "reason": self.session.failure_reason,
            "session_id": self.session.session_id,
            "attempt": self.attempt,
            "tensorboard_url": self.tensorboard_url,
            # provisioning state (CREATING/WAITING/READY/...) so the client
            # can show why no tasks exist yet during slice allocation
            "phase": self.provisioner.state,
        }


def main(argv: list[str] | None = None) -> int:
    """Ref: ApplicationMaster.main :332."""
    parser = argparse.ArgumentParser(prog="tony-tpu-coordinator")
    parser.add_argument("--conf", required=True, help="path to tony-final.json")
    parser.add_argument("--app-id", required=True)
    parser.add_argument("--job-dir", required=True)
    args = parser.parse_args(argv)
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    conf = TonyConf.from_final(args.conf)
    coord = Coordinator(conf, args.app_id, args.job_dir)
    ok = coord.run()
    return C.EXIT_SUCCESS if ok else C.EXIT_FAIL


if __name__ == "__main__":
    raise SystemExit(main())
