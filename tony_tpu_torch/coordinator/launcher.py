"""Task launchers: how the coordinator places agent processes on hosts.

The PyTorch port's copy of ``tony_tpu/coordinator/launcher.py``.

Reference split: YARN RM allocates containers (TaskScheduler ->
amRMClient.addContainerRequest) and the AM's ContainerLauncher starts the
TaskExecutor on the NM (ApplicationMaster.ContainerLauncher.run :1154-1222).
On TPU there is no incremental container negotiation — a slice's hosts are
created *together* (SURVEY.md section 7.9a) — so a Launcher simply places
one agent process per task instance:

- ``LocalProcessLauncher``: agents as local subprocesses (MiniCluster-style
  in-process cluster; also the single-TPU-VM mode where every task shares
  the host and gets a device subset).
- ``SshLauncher``: agents on remote TPU-VM hosts over ssh, one host per
  task round-robin (the gcloud `tpu-vm ssh --worker=all` shape).

Launchers also watch for process exit so a task that dies before
registering its result is still detected (the onContainersCompleted
backup path, ApplicationMaster.java:1050-1068).
"""

from __future__ import annotations

import logging
import os
import shlex
import signal
import subprocess
import sys
import threading
from typing import Callable

from tony_tpu_torch import constants as C
from tony_tpu_torch.session import Task

log = logging.getLogger(__name__)

OnExit = Callable[[str, int], None]  # (task_id, exit_code)

# agent argv; module-level so launcher tests can swap in a stand-in
AGENT_ARGV = [sys.executable, "-m", "tony_tpu_torch.agent"]


def parse_memory_bytes(spec: str) -> int:
    """'2g' / '512m' / '1024k' / plain bytes -> int bytes; 0 when blank or
    unparseable (caller skips enforcement)."""
    s = str(spec or "").strip().lower()
    if not s:
        return 0
    try:
        if s[-1] in "kmgt":
            mult = {"k": 1024, "m": 1024 ** 2, "g": 1024 ** 3,
                    "t": 1024 ** 4}[s[-1]]
            return int(float(s[:-1]) * mult)
        return int(s)
    except ValueError:
        log.warning("unparseable memory spec %r; not enforcing", spec)
        return 0


def _memory_preexec(env: dict[str, str]):
    """preexec_fn applying the role's memory as RLIMIT_AS, when (and only
    when) the coordinator exported TONY_TASK_MEMORY — i.e. the user set
    tony.<role>.memory explicitly (ref: YARN enforces the container
    resource; TonyClient.java:788-857 validates it at submit). Address-
    space rlimit is the strictest portable analog: jax maps large arenas
    (and a CUDA context reserves far more address space than it touches),
    which is exactly why the schema default never reaches here."""
    limit = parse_memory_bytes(env.get(C.TASK_MEMORY, ""))
    if limit <= 0:
        return None

    def preexec():
        import resource

        resource.setrlimit(resource.RLIMIT_AS, (limit, limit))

    return preexec


class Launcher:
    def launch(self, task: Task, env: dict[str, str], log_path: str) -> None:
        raise NotImplementedError

    def stop_all(self) -> None:
        raise NotImplementedError

    def kill_task(self, task_id: str) -> bool:
        raise NotImplementedError


class LocalProcessLauncher(Launcher):
    """Spawn ``python -m tony_tpu_torch.agent`` per task on this host."""

    def __init__(self, on_exit: OnExit, workdir: str | None = None):
        self.on_exit = on_exit
        self.workdir = workdir
        self._procs: dict[str, subprocess.Popen] = {}
        self._lock = threading.Lock()
        # stop_all bumps the generation: exits from a torn-down generation
        # never reach on_exit, while relaunches (coordinator retry, elastic
        # resize) keep working exit detection
        self._gen = 0

    def launch(self, task: Task, env: dict[str, str], log_path: str) -> None:
        full_env = dict(os.environ)
        full_env.update(env)
        os.makedirs(os.path.dirname(log_path) or ".", exist_ok=True)
        out = open(log_path, "ab", buffering=0)
        try:
            proc = subprocess.Popen(
                AGENT_ARGV,
                env=full_env,
                cwd=self.workdir,
                stdout=out,
                stderr=subprocess.STDOUT,
                start_new_session=True,
                preexec_fn=_memory_preexec(env),
            )
        finally:
            out.close()
        with self._lock:
            self._procs[task.id] = proc
            gen = self._gen
        threading.Thread(
            target=self._wait, args=(task.id, proc, gen), daemon=True,
            name=f"wait-{task.id}",
        ).start()
        log.info("launched %s as pid %d (log: %s)", task.id, proc.pid, log_path)

    def pause_exits(self) -> None:
        """Bump the generation so in-flight process exits never reach
        on_exit — wrapper launchers (docker) call this before their own
        teardown kills complete the attached processes."""
        with self._lock:
            self._gen += 1

    def attach(self, task_id: str, proc: subprocess.Popen) -> None:
        """Register an externally-spawned process (ssh/docker wrapper) for
        exit detection under this launcher's generation handshake."""
        with self._lock:
            self._procs[task_id] = proc
            gen = self._gen
        threading.Thread(target=self._wait, args=(task_id, proc, gen),
                         daemon=True, name=f"wait-{task_id}").start()

    def _wait(self, task_id: str, proc: subprocess.Popen, gen: int) -> None:
        code = proc.wait()
        with self._lock:
            if self._procs.get(task_id) is proc:
                self._procs.pop(task_id)
            if gen != self._gen:
                return
        self.on_exit(task_id, code)

    def kill_task(self, task_id: str) -> bool:
        with self._lock:
            proc = self._procs.get(task_id)
        if proc is None:
            return False
        _kill_tree(proc)
        return True

    def stop_all(self) -> None:
        with self._lock:
            self._gen += 1
            procs = list(self._procs.values())
        for proc in procs:
            _kill_tree(proc)


def _kill_tree(proc: subprocess.Popen) -> None:
    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except (ProcessLookupError, PermissionError):
        try:
            proc.kill()
        except ProcessLookupError:
            pass


def docker_container_name(task: Task) -> str:
    """Epoch-qualified name: a relaunch after resize/retry must not race
    the async ``--rm`` cleanup of the previous epoch's same-id container."""
    return f"tony-s{task.session_id}-{task.id.replace(':', '-')}"


def build_docker_command(task: Task, env: dict[str, str], image: str,
                         mounts: list[str] | None = None,
                         extra_args: list[str] | None = None,
                         docker_bin: str = "docker",
                         workdir: str = "") -> list[str]:
    """Build the ``docker run`` argv that hosts one agent.

    Reference analog: YARN docker containers via env injection
    (HadoopCompatibleAdapter.getContainerEnvForDocker — ENV_CONTAINER_TYPE,
    image, mounts). On TPU-VMs the accelerator needs ``--privileged`` +
    host networking so the container sees /dev/accel* and the ICI NICs;
    mounts use docker's ``host:container[:ro]`` syntax directly.
    """
    argv = [docker_bin, "run", "--rm", "--name", docker_container_name(task),
            "--net=host", "--privileged"]
    # container paths already covered by user mounts — docker rejects
    # duplicate mount points, so the implicit workdir mount must yield
    user_targets = {m.split(":")[1] for m in mounts or [] if ":" in m}
    if workdir and workdir not in user_targets:
        # the job dir carries the payload script, localized resources, and
        # venv — mount it at the same path and start there, mirroring
        # LocalProcessLauncher's workdir=job_dir
        argv += ["-v", f"{workdir}:{workdir}"]
    if workdir:
        argv += ["-w", workdir]
    for mount in mounts or []:
        argv += ["-v", mount]
    # role resources become docker's enforced limits (ref: YARN enforces
    # the container resource; docker accepts the same '2g' spelling)
    if env.get(C.TASK_MEMORY):
        argv += ["--memory", str(env[C.TASK_MEMORY])]
    if env.get(C.TASK_VCORES):
        argv += ["--cpus", str(env[C.TASK_VCORES])]
    for k, v in env.items():
        argv += ["-e", f"{k}={v}"]
    argv += extra_args or []
    argv += [image, "python3", "-m", "tony_tpu_torch.agent"]
    return argv


class DockerLauncher(Launcher):
    """Run each agent inside a docker container on this host.

    Reference: tony.docker.enabled/tony.docker.containers.image keys +
    docker env injection (TonyConfigurationKeys DOCKER_*,
    HadoopCompatibleAdapter.getContainerEnvForDocker). Exit detection rides
    the local ``docker run`` process (it stays attached); kill goes through
    ``docker kill`` so the in-container process group dies with it.
    """

    def __init__(self, image: str, on_exit: OnExit,
                 mounts: list[str] | None = None,
                 extra_args: list[str] | None = None,
                 docker_bin: str = "docker", workdir: str = ""):
        if not image:
            raise ValueError("DockerLauncher needs an image")
        self.image = image
        self.mounts = mounts or []
        self.extra_args = extra_args or []
        self.docker_bin = docker_bin
        self.workdir = workdir
        self._local = LocalProcessLauncher(on_exit)
        self._names: dict[str, str] = {}
        self._names_lock = threading.Lock()

    def launch(self, task: Task, env: dict[str, str], log_path: str) -> None:
        argv = build_docker_command(task, env, self.image, self.mounts,
                                    self.extra_args, self.docker_bin,
                                    workdir=self.workdir)
        os.makedirs(os.path.dirname(log_path) or ".", exist_ok=True)
        out = open(log_path, "ab", buffering=0)
        try:
            proc = subprocess.Popen(argv, stdout=out,
                                    stderr=subprocess.STDOUT,
                                    start_new_session=True)
        finally:
            out.close()
        with self._names_lock:
            self._names[task.id] = docker_container_name(task)
        self._local.attach(task.id, proc)
        log.info("launched %s in docker image %s (pid %d)", task.id,
                 self.image, proc.pid)

    def _docker_kill(self, name: str) -> None:
        subprocess.run([self.docker_bin, "kill", name],
                       stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
                       check=False)

    def kill_task(self, task_id: str) -> bool:
        with self._names_lock:
            name = self._names.get(task_id)
        if name:
            self._docker_kill(name)
        return self._local.kill_task(task_id)

    def stop_all(self) -> None:
        # bump the generation FIRST so teardown exits never reach on_exit
        # (the docker kills below complete each attached `docker run`)
        self._local.pause_exits()
        with self._names_lock:
            names = list(self._names.values())
            self._names.clear()
        for name in names:
            self._docker_kill(name)
        self._local.stop_all()


# the remote agent entrypoint; module-level so launcher tests can swap in a
# long-running stand-in (env-contract pattern, see tests/test_launcher.py)
REMOTE_AGENT_CMD = "python3 -m tony_tpu_torch.agent"


def remote_pgid_file(task: Task, app_id: str = "") -> str:
    """Job- and epoch-qualified pgid path on the REMOTE host (same
    rationale as docker_container_name, plus the app id: two jobs sharing
    a static host list must never read each other's pgid records)."""
    app = f"-{app_id}" if app_id else ""
    return f"/tmp/tony{app}-s{task.session_id}-{task.id.replace(':', '-')}.pgid"


class SshLauncher(Launcher):
    """Place agents on remote hosts over ssh, round-robin per task.

    The remote host needs the same repo importable at ``remote_pythonpath``
    (TPU-VM images share a disk image). Exit detection rides the local ssh
    process's exit code.

    **Job-file distribution** (``ship_job_dir``): before the first launch
    on each host, the job dir — the client already staged src, venv,
    resources, and tony-final.json into it — is tar-piped over ssh to
    the host. The reference uploads zipped src/venv/confs to HDFS and
    every container downloads + extracts them (TonyClient.java:229-310,
    util/Utils.java:750 extractResources); tony-tpu's client stages the
    EXTRACTED tree, so the per-host analog is one stream of that tree
    over the same ssh channel the launch uses — no DFS round trip, no
    per-container unzip, and a host that already sees the job dir (NFS /
    GCS-fuse shared mount) is detected and skipped. With
    ``remote_job_root`` set, the tree lands under
    ``<root>/<basename(job_dir)>`` instead of the identical absolute
    path, and every job-dir path in the task env (TONY_JOB_DIR, conf
    path, venv interpreter in the task command, compile cache,
    checkpoint dir) is rewritten for the remote side.

    Kill is REMOTE-first: the agent runs as a ``setsid`` session leader
    whose pgid is written to a per-task file on the remote host, and
    ``kill_task``/``stop_all`` ssh back in to ``kill -- -PGID`` the whole
    tree (ref analog: the NM kills the container cgroup,
    ApplicationMaster.java:735-777). Killing only the local ssh client
    would orphan the remote tree until its coordinator-lost horizon —
    leaving a window where two gangs overlap after elastic resize/retry.
    """

    def __init__(self, hosts: list[str], on_exit: OnExit,
                 remote_pythonpath: str = "",
                 ssh_opts: list[str] | None = None, ssh_bin: str = "ssh",
                 app_id: str = "", chips_per_host: int = 0,
                 ship_job_dir: str = "", remote_job_root: str = ""):
        if not hosts:
            raise ValueError("SshLauncher needs at least one host")
        self.hosts = hosts
        self.on_exit = on_exit
        self.remote_pythonpath = remote_pythonpath
        self.ssh_opts = ssh_opts or ["-o", "StrictHostKeyChecking=no",
                                     "-o", "BatchMode=yes"]
        self.ssh_bin = ssh_bin
        self.app_id = app_id
        self.ship_job_dir = os.path.abspath(ship_job_dir) if ship_job_dir \
            else ""
        self.remote_job_dir = ""
        if self.ship_job_dir:
            self.remote_job_dir = os.path.join(
                remote_job_root, os.path.basename(self.ship_job_dir)) \
                if remote_job_root else self.ship_job_dir
        self._shipped: set[str] = set()
        # one lock per host: ships to different hosts run concurrently,
        # and a launch headed to an already-shipped host never waits on
        # an in-flight multi-GB stream to another host
        self._ship_locks = {h: threading.Lock() for h in hosts}
        self._shipped_lock = threading.Lock()
        self._next = 0
        self._local = LocalProcessLauncher(self._on_local_exit)
        self._remote: dict[str, tuple[str, str]] = {}  # task -> (host, pgid file)
        self._remote_lock = threading.Lock()
        # capacity-aware packing: when tasks declare a chip demand
        # (TONY_TASK_CHIPS) and hosts have a known chip count, place each
        # task on the host with the most free chips and hand it a disjoint
        # CUDA_VISIBLE_DEVICES subset (the pod-wide analog of the
        # coordinator-host ChipAllocator; ref: per-container GPU sets,
        # util/Utils.java:393-419). chips_per_host=0 -> plain round-robin.
        self._pools: dict[str, "ChipAllocator"] | None = None
        if chips_per_host > 0:
            from tony_tpu_torch.coordinator.chips import ChipAllocator

            self._pools = {h: ChipAllocator(chips_per_host) for h in hosts}

    def _on_local_exit(self, task_id: str, code: int) -> None:
        """Natural exit: retire the remote record BEFORE reporting, so a
        later kill_task/stop_all can never fire a stale pgid at a recycled
        pid on the shared host. The remote pgid-file removal is async —
        an unreachable host must not delay completion detection (gang
        finish, DAG release) by the ssh timeout."""
        with self._remote_lock:
            info = self._remote.pop(task_id, None)
        if info and self._pools:
            self._pools[info[0]].release(task_id)
        self.on_exit(task_id, code)
        if info:
            threading.Thread(target=self._rm_pgid_file, args=info,
                             daemon=True,
                             name=f"pgid-cleanup-{task_id}").start()

    def _rm_pgid_file(self, host: str, pgid_file: str) -> None:
        try:
            subprocess.run(
                [self.ssh_bin, *self.ssh_opts, host,
                 f"rm -f {shlex.quote(pgid_file)}"],
                stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
                timeout=20, check=False)
        except subprocess.SubprocessError:
            log.debug("stale pgid file cleanup on %s failed", host)

    def _place(self, task: Task, env: dict[str, str]) -> tuple[str, dict]:
        """Pick the host (and chip subset) for a task. With pools + a chip
        demand: most-free-chips host (packing); else round-robin."""
        chips = int(env.get(C.TASK_CHIPS, "0") or 0)
        if self._pools and chips > 0:
            host = max(self.hosts,
                       key=lambda h: self._pools[h].free_count)
            ids = self._pools[host].allocate(task.id, chips)
            env = dict(env)
            env[C.CUDA_VISIBLE_DEVICES] = ",".join(str(i) for i in ids)
            env[C.CUDA_DEVICE_ORDER] = C.PCI_BUS_ID
            return host, env
        host = self.hosts[self._next % len(self.hosts)]
        self._next += 1
        return host, env

    def launch(self, task: Task, env: dict[str, str], log_path: str) -> None:
        host, env = self._place(task, env)
        try:
            self._launch_on(host, task, env, log_path)
        except BaseException:
            # the task never registered in _remote, so no exit path would
            # ever return its chips — release the placement hold here
            if self._pools:
                self._pools[host].release(task.id)
            raise

    def _ensure_shipped(self, host: str) -> None:
        """Ship the job dir to ``host`` exactly once per launcher (probe
        first: a shared mount already carrying the files is skipped). A
        failed ship raises, failing the task launch — the same contract
        as the reference's failed resource localization, which fails the
        container (ApplicationMaster onStartContainerError)."""
        if not self.ship_job_dir:
            return
        with self._shipped_lock:
            if host in self._shipped:
                return
            lock = self._ship_locks.setdefault(host, threading.Lock())
        with lock:
            with self._shipped_lock:
                if host in self._shipped:
                    return
            marker = os.path.join(self.remote_job_dir, C.TONY_FINAL_CONF)
            try:
                probe = subprocess.run(
                    [self.ssh_bin, *self.ssh_opts, host,
                     f"test -e {shlex.quote(marker)}"],
                    stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
                    timeout=30, check=False)
            except subprocess.SubprocessError as e:
                # an unreachable probe must FAIL the launch, not default
                # to shipping: on a shared mount (the case the probe
                # detects) a blind tar would overwrite the live job dir
                # this coordinator is reading
                raise RuntimeError(
                    f"job-dir probe on {host} failed; refusing to ship "
                    f"blindly over a possibly-shared mount: {e}") from e
            if probe.returncode not in (0, 1):
                # `test -e` answers only 0/1; 255 etc. is ssh transport
                # failure — same blind-ship hazard as the timeout above
                raise RuntimeError(
                    f"job-dir probe on {host} exited {probe.returncode} "
                    "(ssh transport error); refusing to ship blindly")
            if probe.returncode == 1:
                self._ship(host)
            with self._shipped_lock:
                self._shipped.add(host)

    def _ship(self, host: str) -> None:
        qd = shlex.quote(self.remote_job_dir)
        # logs/ is excluded: already-launched tasks' ssh clients append to
        # coordinator-side log files while this tar reads the dir (each
        # host writes its own logs anyway). GNU tar rc 1 = "file changed
        # as we read it" (status/event files churn) — the snapshot of the
        # static payload (src/venv/conf/resources) is still complete;
        # only rc >= 2 is a real failure.
        tar = subprocess.Popen(
            ["tar", "-C", self.ship_job_dir, "--exclude=./logs",
             "--exclude=./compile-cache", "-czf", "-", "."],
            stdout=subprocess.PIPE)
        try:
            recv = subprocess.run(
                [self.ssh_bin, *self.ssh_opts, host,
                 f"mkdir -p {qd} && tar -C {qd} -xzf -"],
                stdin=tar.stdout, stdout=subprocess.DEVNULL,
                stderr=subprocess.PIPE,
                timeout=float(os.environ.get("TONY_SHIP_TIMEOUT_S", "600")),
                check=False)
        finally:
            if tar.stdout:
                tar.stdout.close()
            tar_rc = tar.wait()
        if recv.returncode or tar_rc > 1:
            raise RuntimeError(
                f"shipping job dir to {host}:{self.remote_job_dir} failed "
                f"(tar rc {tar_rc}, ssh rc {recv.returncode}): "
                f"{recv.stderr.decode(errors='replace')[-500:]}")
        log.info("shipped job dir %s -> %s:%s", self.ship_job_dir, host,
                 self.remote_job_dir)

    def _remote_env(self, env: dict[str, str]) -> dict[str, str]:
        """Rewrite job-dir paths in env values for a remote placement that
        does NOT mirror the local absolute path (remote_job_root mode).
        Covers TONY_JOB_DIR, the conf path, the venv interpreter inside
        TONY_TASK_COMMAND, compile-cache and checkpoint dirs — every
        value the coordinator derived from its own job dir."""
        if not self.remote_job_dir or self.remote_job_dir == self.ship_job_dir:
            return env
        return {k: str(v).replace(self.ship_job_dir, self.remote_job_dir)
                for k, v in env.items()}

    def _launch_on(self, host: str, task: Task, env: dict[str, str],
                   log_path: str) -> None:
        self._ensure_shipped(host)
        env = self._remote_env(env)
        exports = " ".join(
            f"export {k}={shlex.quote(str(v))};" for k, v in env.items()
        )
        pp = f"export PYTHONPATH={shlex.quote(self.remote_pythonpath)}:$PYTHONPATH;" \
            if self.remote_pythonpath else ""
        pgid_file = remote_pgid_file(task, self.app_id)
        # setsid makes the wrapper sh the session/group leader; it records
        # its pid (== the agent's after exec, == the remote pgid) then
        # becomes the agent, so kill -- -PGID reaps agent + user process.
        # -w: setsid forks when already a group leader (always, under sshd)
        # and would otherwise exit 0 instantly — the local ssh client must
        # stay attached and carry the agent's real exit code
        mem_kb = parse_memory_bytes(env.get(C.TASK_MEMORY, "")) // 1024
        ulimit = f"ulimit -v {mem_kb} 2>/dev/null; " if mem_kb > 0 else ""
        inner = (f"echo $$ > {shlex.quote(pgid_file)}; {ulimit}{exports} "
                 f"{pp} exec {REMOTE_AGENT_CMD}")
        remote_cmd = f"exec setsid -w sh -c {shlex.quote(inner)}"
        os.makedirs(os.path.dirname(log_path) or ".", exist_ok=True)
        out = open(log_path, "ab", buffering=0)
        try:
            proc = subprocess.Popen(
                [self.ssh_bin, *self.ssh_opts, host, remote_cmd],
                stdout=out,
                stderr=subprocess.STDOUT,
                start_new_session=True,
            )
        finally:
            out.close()
        with self._remote_lock:
            self._remote[task.id] = (host, pgid_file)
        self._local.attach(task.id, proc)
        log.info("launched %s on %s via ssh (pid %d)", task.id, host, proc.pid)

    def _remote_kill(self, host: str, pgid_file: str) -> None:
        qf = shlex.quote(pgid_file)
        cmd = (f'p=$(cat {qf} 2>/dev/null); if [ -n "$p" ]; then '
               f'kill -KILL -- -"$p" 2>/dev/null || kill -KILL "$p" '
               f'2>/dev/null; fi; rm -f {qf}')
        try:
            subprocess.run([self.ssh_bin, *self.ssh_opts, host, cmd],
                           stdout=subprocess.DEVNULL,
                           stderr=subprocess.DEVNULL, timeout=20, check=False)
        except subprocess.SubprocessError:
            log.warning("remote kill on %s timed out/failed (pgid file %s); "
                        "the agent's coordinator-lost horizon is the backstop",
                        host, pgid_file)

    def kill_task(self, task_id: str) -> bool:
        # keep the _remote record: the chip hold is released only by
        # _on_local_exit once the ssh client confirms the remote tree is
        # gone — releasing here would let a relaunch share devices with a
        # kill that timed out (unreachable host keeps its agent until the
        # coordinator-lost horizon)
        with self._remote_lock:
            info = self._remote.get(task_id)
        if info:
            self._remote_kill(*info)
        # the remote kill usually completes the local ssh client before
        # the local kill runs — a vanished local proc is still a kill
        killed_local = self._local.kill_task(task_id)
        return killed_local or info is not None

    def stop_all(self) -> None:
        # silence local exit detection FIRST: the remote kills below
        # complete each attached ssh client, which must not re-enter on_exit
        self._local.pause_exits()
        with self._remote_lock:
            remote = list(self._remote.values())
            self._remote.clear()
        if self._pools:
            for pool in self._pools.values():
                pool.reset()
        for host, pgid_file in remote:
            self._remote_kill(host, pgid_file)
        self._local.stop_all()
