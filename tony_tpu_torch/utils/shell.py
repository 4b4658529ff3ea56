"""User-process execution — the single exec point for task commands.

The PyTorch port's copy of ``tony_tpu/utils/shell.py``.

Reference: Utils.executeShell (util/Utils.java:299-329): ``bash -c <cmd>``
with injected env, optional timeout, output streamed to the task log.
"""

from __future__ import annotations

import logging
import os
import signal
import subprocess
import sys
import threading
import time

log = logging.getLogger(__name__)

# live children of this process (pgid leaders), for preemption forwarding
_ACTIVE: set = set()
_ACTIVE_LOCK = threading.Lock()


def register_external_process(proc) -> None:
    """Track a Popen started outside execute_shell (e.g. the horovod
    rendezvous driver) so preemption forwarding reaches it too."""
    with _ACTIVE_LOCK:
        _ACTIVE.add(proc)


def unregister_external_process(proc) -> None:
    with _ACTIVE_LOCK:
        _ACTIVE.discard(proc)


def request_graceful_shutdown(grace_ms: int = 15_000) -> int:
    """TPU preemption/maintenance path: forward SIGTERM to every active
    user-process group so training can checkpoint-and-exit, then SIGKILL
    whatever is still alive after the grace period. Returns the number of
    process groups signalled, immediately (the killer runs on a daemon
    thread); callers keep waiting on the child, which exits with 143
    (SIGTERM) or 137 (SIGKILL). NOT async-signal-safe (takes locks): call
    from a worker thread, never directly inside a signal handler."""
    with _ACTIVE_LOCK:
        procs = list(_ACTIVE)

    def signal_proc(proc, sig) -> None:
        # registered processes are USUALLY their own group leaders
        # (execute_shell children run under start_new_session), but not
        # always — the horovod rendezvous server deliberately stays in
        # the agent's group so the launcher's group kill reaps it. killpg
        # on a non-leader pid raises ProcessLookupError; fall back to
        # signalling the process itself rather than silently skipping it
        try:
            os.killpg(proc.pid, sig)
        except ProcessLookupError:
            try:
                proc.send_signal(sig)
            except (ProcessLookupError, OSError):
                pass

    for proc in procs:
        signal_proc(proc, signal.SIGTERM)

    def kill_after_grace():
        # one shared deadline: per-proc fresh timeouts would compound to
        # N x grace and outlive the platform's actual reclaim window
        deadline = time.monotonic() + grace_ms / 1000
        for proc in procs:
            try:
                proc.wait(timeout=max(0.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                log.warning("grace period (%d ms) expired; SIGKILL pgid %d",
                            grace_ms, proc.pid)
                signal_proc(proc, signal.SIGKILL)

    threading.Thread(target=kill_after_grace, daemon=True).start()
    return len(procs)


def execute_shell(
    command: str,
    timeout_ms: int = 0,
    env: dict[str, str] | None = None,
    log_path: str | None = None,
    cwd: str | None = None,
) -> int:
    """Run ``bash -c command``; returns the exit code (124 on timeout, like
    coreutils timeout). The child gets its own process group so a timeout
    kills the whole user-process tree."""
    full_env = dict(os.environ)
    if env:
        full_env.update({k: str(v) for k, v in env.items()})
    if log_path:
        # a shipped job dir arrives without logs/ (excluded from the tar
        # stream); the exec point owns creating its own log home
        os.makedirs(os.path.dirname(os.path.abspath(log_path)),
                    exist_ok=True)
    out = open(log_path, "ab", buffering=0) if log_path else None
    try:
        proc = subprocess.Popen(
            ["bash", "-c", command],
            env=full_env,
            cwd=cwd,
            stdout=out if out else None,
            stderr=subprocess.STDOUT if out else None,
            start_new_session=True,
        )
        with _ACTIVE_LOCK:
            _ACTIVE.add(proc)
        try:
            return proc.wait(timeout=timeout_ms / 1000 if timeout_ms > 0 else None)
        except subprocess.TimeoutExpired:
            log.error("command timed out after %d ms: %s", timeout_ms, command)
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            proc.wait()
            return 124
        finally:
            with _ACTIVE_LOCK:
                _ACTIVE.discard(proc)
    finally:
        if out:
            out.close()


def tee_output(proc: subprocess.Popen, log_path: str, scan=None) -> threading.Thread:
    """Stream a child's stdout to a log file (and optionally a scanner
    callback per line — used by the preprocessing path that scrapes
    output, ref: ApplicationMaster.doPreprocessingJob :780-832)."""

    def pump():
        with open(log_path, "ab", buffering=0) as f:
            assert proc.stdout is not None
            for line in proc.stdout:
                f.write(line)
                if scan is not None:
                    try:
                        scan(line.decode(errors="replace"))
                    except Exception:
                        log.exception("output scanner failed")

    t = threading.Thread(target=pump, daemon=True)
    t.start()
    return t


def python_interpreter(venv_dir: str | None = None) -> str:
    """Pick the task python: shipped venv's bin/python if present, else the
    current interpreter (ref: TonyClient.buildTaskCommand :618-635)."""
    if venv_dir:
        cand = os.path.join(venv_dir, "bin", "python")
        if os.path.exists(cand):
            return cand
    return sys.executable
