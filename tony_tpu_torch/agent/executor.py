"""Per-task agent process — TaskExecutor equivalent.

The PyTorch port's copy of ``tony_tpu/agent/executor.py``.

Reference: TaskExecutor.java (452 LoC): reads identity env, connects the
control-plane + metrics RPC proxies, reserves rendezvous/TensorBoard ports,
registers its worker spec and polls until the runtime's gate opens, runs a
heartbeater thread (with fault-injected miss support) and the metrics
sampler, releases ports, delegates to the runtime task adapter to exec the
user process, and registers the exit code back to the coordinator.

Process entry: ``python -m tony_tpu_torch.agent`` with env injected by the
coordinator's launcher (ref: TaskExecutor.main :189 / initConfigs :240-281).
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time

from tony_tpu_torch import constants as C
from tony_tpu_torch.config import TonyConf
from tony_tpu_torch.metrics import TaskMetricsMonitor
from tony_tpu_torch.rpc import RpcClient
from tony_tpu_torch.runtime import TaskContext, get_task_adapter
from tony_tpu_torch.utils import local_host_name, reserve_port
from tony_tpu_torch.utils.gpu_info import GpuDiscoverer

log = logging.getLogger(__name__)


class Heartbeater(threading.Thread):
    """Ref: inner Heartbeater (TaskExecutor.java:322-362): pings every
    interval, tolerates 5 consecutive send failures, supports the
    TEST_TONY_NUM_HB_MISS injection that skips N pings."""

    MAX_SEND_FAILURES = 5

    def __init__(self, client: RpcClient, task_id: str, interval_ms: int,
                 workdir: str | None = None, on_lost=None,
                 lost_after_s: float | None = None):
        super().__init__(name="heartbeater", daemon=True)
        self.client = client
        self.task_id = task_id
        self.interval_s = max(interval_ms, 50) / 1000
        self.misses_to_skip = int(os.environ.get(C.TEST_TASK_NUM_HB_MISS, "0"))
        self.workdir = workdir
        self.on_lost = on_lost
        # keep pinging through failures until this much time has passed
        # (the coordinator-side expiry horizon); only then declare it lost
        self.lost_after_s = lost_after_s
        self._stop = threading.Event()

    def _handle_commands(self, response) -> None:
        """Coordinator->agent commands piggybacked on the heartbeat ack."""
        if not isinstance(response, dict):
            return
        for cmd in response.get("commands") or []:
            if cmd.get("type") == "profile" and self.workdir:
                from tony_tpu_torch.profiler import write_trigger

                write_trigger(self.workdir, int(cmd.get("num_steps", 5)),
                              task_id=self.task_id)
                log.info("profile trigger dropped for %s", self.task_id)
            elif cmd.get("type") == "save_and_exit" and self.workdir:
                from tony_tpu_torch.elastic import write_save_and_exit

                write_save_and_exit(self.workdir, task_id=self.task_id,
                                    reason=str(cmd.get("reason", "resize")))
                log.info("save_and_exit requested for %s", self.task_id)
            else:
                log.warning("unknown coordinator command: %s", cmd)

    def run(self) -> None:
        failures = 0
        outage_start: float | None = None
        while not self._stop.wait(self.interval_s):
            if self.misses_to_skip > 0:
                self.misses_to_skip -= 1
                log.info("skipping heartbeat (fault injection, %d left)",
                         self.misses_to_skip)
                continue
            try:
                response = self.client.call("task_executor_heartbeat",
                                            retries=0, task_id=self.task_id)
                failures = 0
                outage_start = None
                try:
                    self._handle_commands(response)
                except Exception:
                    # a bad command must not count against liveness — the
                    # ping itself already landed
                    log.exception("coordinator command failed")
            except Exception:
                failures += 1
                if outage_start is None:
                    outage_start = time.monotonic()
                log.warning("heartbeat send failure %d/%d", failures,
                            self.MAX_SEND_FAILURES)
                if self.on_lost is not None and self.lost_after_s:
                    # keep pinging through the outage; only past the
                    # coordinator's own expiry horizon is it truly gone.
                    # WALL-CLOCK since the first consecutive failure, not
                    # failures x interval: a blackholed host makes each
                    # failed RPC block for its own connect timeout, which
                    # would stretch a count-based horizon far past the
                    # client's respawn fence
                    outage_s = time.monotonic() - outage_start
                    if outage_s >= self.lost_after_s:
                        log.error("coordinator lost (unreachable for "
                                  "%.0fs)", outage_s)
                        self.on_lost()
                        return
                elif failures >= self.MAX_SEND_FAILURES:
                    log.error("too many heartbeat failures; giving up")
                    return

    def stop(self) -> None:
        self._stop.set()


class TaskAgent:
    def __init__(self, env: dict[str, str] | None = None):
        e = env or os.environ
        self.role = e[C.JOB_NAME]
        self.index = int(e[C.TASK_INDEX])
        self.task_num = int(e.get(C.TASK_NUM, "1"))
        self.is_chief = e.get(C.IS_CHIEF, "false") == "true"
        self.app_id = e.get(C.JOB_ID, "")
        self.session_id = int(e.get(C.SESSION_ID, "0"))
        self.mode = e.get(C.DISTRIBUTED_MODE, C.GANG)
        self.coord_host = e[C.COORDINATOR_HOST]
        self.coord_port = int(e[C.COORDINATOR_PORT])
        self.metrics_port = int(e.get(C.METRICS_PORT, "0"))
        self.secret = e.get(C.JOB_TOKEN) or None
        self.command = e.get("TONY_TASK_COMMAND", "")
        self.job_dir = e.get("TONY_JOB_DIR", ".")
        conf_path = e.get("TONY_CONF_PATH", "")
        self.conf = TonyConf.from_final(conf_path) if conf_path and \
            os.path.exists(conf_path) else TonyConf()
        self.task_id = f"{self.role}:{self.index}"
        tls_fp = e.get(C.TLS_FINGERPRINT) or None
        self.client = RpcClient(self.coord_host, self.coord_port,
                                secret=self.secret, tls_fingerprint=tls_fp)
        self.metrics_client = RpcClient(
            self.coord_host, self.metrics_port, secret=self.secret,
            tls_fingerprint=tls_fp) if self.metrics_port else None
        self.adapter = get_task_adapter(str(self.conf.get("tony.application.framework")))
        self._user_pid: int | None = None
        self.preempted = False

    def _install_preemption_handler(self) -> None:
        """SIGTERM = TPU spot preemption / maintenance notice (the
        heartbeat-expiry analog of SURVEY 7.9b): forward it to the user
        process group with a checkpoint grace window, and report the exit
        as preempted so the coordinator retry can resume from checkpoint.
        Main-thread only (signal module restriction); launch modes that run
        the agent off the main thread just skip it."""
        import signal as _signal

        from tony_tpu_torch.utils.shell import request_graceful_shutdown

        grace = self.conf.get_int("tony.task.preemption-grace-ms", 15_000)

        def forward():
            # runs on a worker thread: request_graceful_shutdown (and
            # logging) take locks, which a handler on the interrupted main
            # thread could self-deadlock on
            log.warning("SIGTERM: preemption/maintenance — forwarding to "
                        "user process with %d ms checkpoint grace", grace)
            if request_graceful_shutdown(grace) == 0:
                # nothing registered to forward to (e.g. an adapter that
                # spawns children outside the exec registry, or between
                # exec points): don't swallow the signal and hang — die
                # like the default disposition would have (128+SIGTERM;
                # signal.signal can't be called off the main thread)
                log.warning("no active user process; exiting on SIGTERM")
                os._exit(143)

        def on_sigterm(signum, frame):
            self.preempted = True
            threading.Thread(target=forward, daemon=True).start()

        try:
            _signal.signal(_signal.SIGTERM, on_sigterm)
        except ValueError:  # not on the main thread
            log.debug("not main thread; preemption handler not installed")

    def _clean_stale_control_files(self) -> None:
        """A previous epoch's save_and_exit/profile file for this task id
        must not fire at step 0 of the new epoch. Runs on the task's own
        host, so it also covers ssh launch mode where the coordinator's
        job-dir cleanup can't reach."""
        import contextlib

        from tony_tpu_torch.elastic import control_path
        from tony_tpu_torch.profiler import trigger_path

        for path in (control_path(self.job_dir, self.task_id),
                     trigger_path(self.job_dir, self.task_id)):
            with contextlib.suppress(OSError):
                os.remove(path)

    # -- fault injection (ref: skewAndHangIfTesting :364-384) ---------------
    def _skew_if_testing(self) -> None:
        spec = os.environ.get(C.TEST_TASK_SKEW, "")
        if not spec:
            return
        try:
            role, idx, ms = spec.split("#")
            if role == self.role and int(idx) == self.index:
                log.info("skew injection: sleeping %s ms", ms)
                time.sleep(int(ms) / 1000)
        except ValueError:
            log.warning("bad skew spec %r", spec)

    # -- main flow ----------------------------------------------------------
    def run(self) -> int:
        """Ref: TaskExecutor.main :189-237."""
        self._skew_if_testing()
        self._clean_stale_control_files()
        reuse = self.conf.get_bool("tony.task.reuse-port", False)
        rdzv = None
        tb = None
        if self.adapter.need_reserve_rdzv_port(self.role, self.conf):
            rdzv = reserve_port(reuse=reuse)
        if self.adapter.need_reserve_tb_port(self.role, self.is_chief, self.conf):
            tb = reserve_port(reuse=reuse)

        def coordinator_lost():
            # the gang's brain is gone: a replacement coordinator will
            # relaunch this task, so finish the orphan instead of leaving
            # two generations of user processes running side by side
            from tony_tpu_torch.utils.shell import request_graceful_shutdown

            grace = self.conf.get_int("tony.task.preemption-grace-ms", 15_000)
            log.error("coordinator unreachable; shutting down task (grace "
                      "%d ms)", grace)
            request_graceful_shutdown(grace)
            # the SIGKILL backstop runs on a daemon thread — exiting now
            # would kill it and orphan a SIGTERM-ignoring user process on
            # the chip; outlive the grace window before dying
            time.sleep(grace / 1000 + 2)
            os._exit(1)

        hb_interval_ms = self.conf.get_int("tony.task.heartbeat-interval-ms",
                                           1000)
        # only kill the task once the coordinator's OWN liveness horizon
        # has passed (shared formula in coordinator/liveness.py): a shorter
        # fuse would hard-fail healthy jobs on a transient RPC blip the
        # coordinator itself tolerates
        from tony_tpu_torch.coordinator.liveness import (
            heartbeat_rpc_timeout_s,
            liveness_expiry_s,
        )

        # dedicated short-timeout channel: a blackholed coordinator must
        # not block each ping for the default 30 s RPC timeout, which
        # would push loss detection far past the client's respawn fence
        hb_client = RpcClient(
            self.coord_host, self.coord_port, secret=self.secret,
            timeout=heartbeat_rpc_timeout_s(self.conf),
            tls_fingerprint=os.environ.get(C.TLS_FINGERPRINT) or None)
        hb = Heartbeater(
            hb_client, self.task_id, hb_interval_ms,
            workdir=self.job_dir, on_lost=coordinator_lost,
            lost_after_s=liveness_expiry_s(self.conf))
        hb.start()
        monitor = None
        if self.metrics_client is not None:
            monitor = TaskMetricsMonitor(
                lambda: self._user_pid or os.getpid(),
                lambda m: self.metrics_client.call(
                    "update_metrics", retries=0, task_id=self.task_id, metrics=m),
                self.conf.get_int("tony.task.metrics-interval-ms", 5000),
                # nvidia-smi, not torch: the agent must not open a CUDA
                # context on the card its payload trains on
                device_fn=GpuDiscoverer(str(self.conf.get(
                    "tony.tpu.info-exec-path", ""))).device_metrics,
            ).start()

        host = local_host_name()
        port = rdzv.port if rdzv else 0
        spec_str = f"{host}:{port}"
        log.info("registering %s at %s", self.task_id, spec_str)
        cluster_spec_json = self.client.poll_till_non_null(
            lambda: self.client.call("register_worker_spec",
                                     task_id=self.task_id, spec=spec_str),
            interval_s=0.3,
        )
        cluster_spec = json.loads(cluster_spec_json)
        # runtime-private payload rides the spec under "__aux__" (e.g. the
        # horovod rendezvous/slot plan); strip it so role->hosts stays pure
        aux = cluster_spec.pop("__aux__", {})
        log.info("gang ready; cluster spec: %s", cluster_spec)

        # release before exec so the user process can bind (ref:
        # TaskExecutor.java:202-215; SO_REUSEPORT mode skips the release)
        if rdzv and not reuse:
            rdzv.release()
        if tb and not reuse:
            tb.release()
        if tb:
            # ref: TaskExecutor.registerTensorBoardUrl :303-311 -> AM
            # registerTensorBoardUrlToRM; here it lands in the app status
            try:
                self.client.call("register_tensorboard_url",
                                 url=f"http://{host}:{tb.port}")
            except Exception:
                log.warning("failed to register tensorboard url", exc_info=True)

        ctx = TaskContext(
            conf=self.conf,
            role=self.role,
            index=self.index,
            task_num=self.task_num,
            is_chief=self.is_chief,
            cluster_spec=cluster_spec,
            command=self.command,
            app_id=self.app_id,
            session_id=self.session_id,
            rdzv_port=port,
            tb_port=tb.port if tb else -1,
            log_path=os.path.join(self.job_dir, "logs",
                                  f"{self.role}-{self.index}-user{C.LOG_SUFFIX}"),
            workdir=self.job_dir,
            aux=aux,
            callback_to_am=lambda info: self.client.call(
                "register_callback_info", task_id=self.task_id, info=info),
            extra_env={
                C.JOB_ID: self.app_id,
                C.SESSION_ID: str(self.session_id),
                C.DISTRIBUTED_MODE: self.mode,
                C.ATTEMPT_NUMBER: os.environ.get(C.ATTEMPT_NUMBER, "0"),
                C.AGENT_PID: str(os.getpid()),
            },
        )
        self._install_preemption_handler()
        try:
            exit_code = self.adapter.run(ctx)
        except Exception:
            log.exception("task adapter run failed")
            exit_code = C.EXIT_FAIL
        finally:
            if monitor:
                monitor.stop()
            hb.stop()
            if rdzv:
                rdzv.release()
            if tb:
                tb.release()

        try:
            self.client.call("register_execution_result",
                             task_id=self.task_id, exit_code=exit_code,
                             session_id=self.session_id,
                             preempted=self.preempted)
        except Exception:
            # coordinator's launcher exit-watch is the backup path
            log.exception("failed to register execution result")
        self.client.close()
        if self.metrics_client:
            self.metrics_client.close()
        return exit_code


def main() -> int:
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    agent = TaskAgent()
    code = agent.run()
    log.info("agent for %s exiting with %d", agent.task_id, code)
    return code


if __name__ == "__main__":
    raise SystemExit(main())
