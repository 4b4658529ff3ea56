"""Tracing: on-demand ``torch.profiler`` captures of training and
serving loops, the counterpart of ``tony_tpu/profiler/profiler.py``
(there over ``jax.profiler``).

- On-demand capture without a profiler UI: the coordinator queues a
  ``profile`` command for a task, the agent drops a trigger file in the
  task workdir, and the user process (any loop that calls
  ``StepProfiler.poll()`` once a step) traces the next N steps into a
  Chrome-trace JSON file under the trigger's logdir
  (``<host>.<pid>.<ms>.pt.trace.json``, what ``torch.profiler``'s
  TensorBoard handler names its files). ``profiler.chrome_trace`` reads
  those files.
- ``ServeProfiler`` is the same request/poll protocol for the gateway's
  replica threads (``POST /debug/profile``).

A trace records the host's operators, and on the card its kernels and
copies too. The JAX package's profiler server for remote TensorBoard
captures has no ``torch.profiler`` counterpart: ``maybe_start_server``
only logs that. Starting and stopping a capture on the card holds
``models.graphs.DEVICE`` exclusively: it must not meet a CUDA-graph
capture on another replica's thread.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import socket
import threading
import time

from tony_tpu_torch.utils.controlfile import (
    control_file_path,
    current_task_id,
    write_control_file,
)

log = logging.getLogger(__name__)

TRIGGER_FILENAME = ".tony_profile_request"
PROFILER_PORT_ENV = "TONY_PROFILER_PORT"
PROFILE_DIR_ENV = "TONY_PROFILE_DIR"


def trigger_path(workdir: str, task_id: str = "") -> str:
    """Per-task trigger file (tasks can share a job dir on one host)."""
    return control_file_path(workdir, TRIGGER_FILENAME, task_id)


def write_trigger(workdir: str, num_steps: int = 5,
                  logdir: str | None = None, task_id: str = "") -> str:
    """Agent side: request a trace from the user process in ``workdir``."""
    return write_control_file(
        trigger_path(workdir, task_id),
        {"num_steps": int(num_steps), "logdir": logdir})


_no_server_logged = False


def maybe_start_server() -> int:
    """Where the JAX package starts ``jax.profiler``'s server for remote
    TensorBoard captures when ``TONY_PROFILER_PORT`` is set (called from
    ``tony_tpu_torch.distributed.initialize``): ``torch.profiler`` has no
    such server, so this logs that once and returns 0. Captures reach a
    task through the coordinator's ``profile`` command, which the agent
    turns into ``write_trigger``."""
    global _no_server_logged
    port = int(os.environ.get(PROFILER_PORT_ENV, "0") or "0")
    if port > 0 and not _no_server_logged:
        _no_server_logged = True
        log.info("%s=%d: torch.profiler has no remote-capture server; "
                 "request traces through the coordinator's profile "
                 "command", PROFILER_PORT_ENV, port)
    return 0


def start_trace(logdir: str):
    """Start a ``torch.profiler`` session writing into ``logdir``: host
    operators, and on the card its kernels and copies. Returns the
    session for ``stop_trace``."""
    import torch

    from tony_tpu_torch.models.graphs import DEVICE

    os.makedirs(logdir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    with DEVICE.exclusive():
        prof.start()
    prof.tony_logdir = logdir
    return prof


def stop_trace(prof) -> str:
    """Stop ``prof`` and write its Chrome-trace JSON file into the
    session's logdir; returns the file's path."""
    from tony_tpu_torch.models.graphs import DEVICE

    with DEVICE.exclusive():
        prof.stop()
    path = os.path.join(prof.tony_logdir, "%s.%d.%d.pt.trace.json" % (
        socket.gethostname(), os.getpid(), int(time.time() * 1000)))
    prof.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def trace(logdir: str):
    """Programmatic trace of a code region into ``logdir``."""
    prof = start_trace(logdir)
    try:
        yield logdir
    finally:
        stop_trace(prof)


class StepProfiler:
    """Poll-per-step on-demand tracing for training loops.

    ``poll()`` is one ``os.path.exists`` when idle — cheap enough to call
    every step. When a trigger file appears, the next ``num_steps`` steps
    are traced to the trigger's logdir (default: ``$TONY_PROFILE_DIR`` or
    ``<workdir>/profiles``).
    """

    def __init__(self, workdir: str | None = None,
                 default_logdir: str | None = None,
                 task_id: str | None = None):
        self.workdir = workdir or os.getcwd()
        self.task_id = current_task_id() if task_id is None else task_id
        self.default_logdir = (default_logdir
                               or os.environ.get(PROFILE_DIR_ENV)
                               or os.path.join(self.workdir, "profiles"))
        self.active_steps_left = 0
        self.captures = 0
        self._logdir = ""
        self._prof = None

    def poll(self) -> bool:
        """Call once per training step. Returns True while tracing."""
        if self.active_steps_left > 0:
            self.active_steps_left -= 1
            if self.active_steps_left == 0:
                self._stop()
            return self.active_steps_left > 0
        path = trigger_path(self.workdir, self.task_id)
        if not os.path.exists(path):
            return False
        try:
            with open(path) as f:
                req = json.load(f)
        except (OSError, json.JSONDecodeError):
            req = {}
        finally:
            with contextlib.suppress(OSError):
                os.remove(path)  # consume: one trigger, one capture
        self._start(req.get("logdir") or self.default_logdir,
                    int(req.get("num_steps", 5)))
        return True

    def _start(self, logdir: str, num_steps: int) -> None:
        try:
            self._prof = start_trace(logdir)
        except Exception:
            log.exception("profile trigger ignored: start_trace failed")
            return
        self._logdir = logdir
        self.active_steps_left = max(num_steps, 1)
        log.info("profiling next %d steps -> %s", self.active_steps_left, logdir)

    def _stop(self) -> None:
        try:
            prof, self._prof = self._prof, None
            stop_trace(prof)
            self.captures += 1
            log.info("profile capture #%d written to %s", self.captures,
                     self._logdir)
        except Exception:
            log.exception("stop_trace failed")

    def close(self) -> None:
        if self.active_steps_left > 0:
            self.active_steps_left = 0
            self._stop()


class ServeProfiler:
    """On-demand ``torch.profiler`` capture for SERVING loops — the
    request/poll protocol of ``StepProfiler`` without the trigger file,
    safe under many scheduler threads.

    The gateway's ``POST /debug/profile?steps=N`` calls ``request()``;
    every replica scheduler thread calls ``poll()`` once per WORKING
    iteration (idle waits don't count — profiling an idle fleet would
    capture nothing and never finish; the capture simply waits for
    traffic). The first poll after arming starts the trace; each
    subsequent poll burns one step; the Nth stops it and stamps
    ``last_logdir``. Steps are counted FLEET-WIDE (one session traces
    the whole process), so with R busy replicas ``steps=N`` spans ~N/R
    iterations of each.

    ``poll()``'s idle path is a single attribute read (no lock): the
    arming thread publishes ``_armed`` last, and a replica that misses
    the flag by a race picks it up on its next iteration — fine for a
    debug trigger, free for the hot loop.

    The first start of a process loads the profiler's tracing library
    on a replica scheduler thread, which stops heartbeating meanwhile:
    keep the gateway's ``--stall-timeout`` above that (the default 30 s
    is).
    """

    def __init__(self, default_logdir: str | None = None):
        self.default_logdir = (default_logdir
                               or os.environ.get(PROFILE_DIR_ENV)
                               or os.path.join(os.getcwd(), "profiles"))
        self._lock = threading.Lock()
        self._armed = False        # lock-free fast-path flag
        self._pending: tuple[int, str] | None = None
        self._starting = False     # a poller is inside start_trace
        self._closed = False       # terminal (gateway drained)
        self._steps_left = 0
        self._active_logdir = ""
        self._prof = None
        self.captures = 0
        self.last_logdir = ""
        self.last_error = ""

    @property
    def busy(self) -> bool:
        return self._armed

    def request(self, num_steps: int, logdir: str | None = None) -> str:
        """Arm a capture of the next ``num_steps`` scheduler iterations.
        Returns the logdir the trace file will land in. Raises
        ``RuntimeError`` while a capture is pending/active (one session
        at a time — queueing would silently serialize debug sessions
        against each other)."""
        num_steps = int(num_steps)
        if num_steps < 1:
            raise ValueError("steps must be >= 1")
        with self._lock:
            if self._closed:
                raise RuntimeError("profiler closed (gateway drained)")
            if self._armed:
                raise RuntimeError(
                    "a profile capture is already pending or active")
            logdir = logdir or os.path.join(
                self.default_logdir,
                f"profile-{int(time.time() * 1000)}")
            self._pending = (num_steps, logdir)
            self.last_error = ""
            self._armed = True  # published LAST: poll()'s lock-free
            #                     read must never see armed without the
            #                     pending tuple in place
        log.info("serving profile armed: next %d scheduler steps -> %s",
                 num_steps, logdir)
        return logdir

    def poll(self) -> None:
        """One working scheduler iteration. Near-free when idle."""
        if not self._armed:
            return
        finish = False
        with self._lock:
            pending, self._pending = self._pending, None
            if pending is not None:
                self._starting = True  # other pollers skip counting
                # until the trace is actually running
            elif self._starting:
                return  # another poller is mid start/stop transition
            elif self._steps_left > 0:
                self._steps_left -= 1
                if self._steps_left == 0:
                    self._starting = True  # hold pollers off the stop
                    finish = True
            if pending is None and not finish:
                return
        if finish:
            self._stop_outside_lock()
            return
        num_steps, logdir = pending
        # start_trace OUTSIDE the lock: its first call can block >10 s
        # (plugin spin-up), and every OTHER replica's poll() would pile
        # up on the lock and stop heartbeating — one slow replica is
        # the documented footgun, a fleet-wide stall is not. Same
        # discipline for stop_trace (_stop_outside_lock), whose capture
        # write-out scales with trace size.
        try:
            prof = start_trace(logdir)
        except Exception as e:  # noqa: BLE001 — a broken
            # profiler must not take the serving loop with it
            log.exception("profile request ignored: start_trace failed")
            with self._lock:
                self.last_error = f"{type(e).__name__}: {e}"
                self._starting = False
                self._armed = False
            return
        abandoned = False
        with self._lock:
            self._starting = False
            self._active_logdir = logdir
            self._prof = prof
            if self._closed or not self._armed:
                # close() raced the spin-up (gateway drain): finalize
                # right away so the global session is not left running
                abandoned = True
                self._starting = True
            else:
                self._steps_left = num_steps
        if abandoned:
            self._stop_outside_lock()

    def _stop_outside_lock(self) -> None:
        """Finish the capture with the LOCK RELEASED (the caller set
        ``_starting`` so concurrent pollers skip, not block): the
        write-out scales with capture size and must stall at most the
        one thread driving it."""
        err = ""
        try:
            prof, self._prof = self._prof, None
            stop_trace(prof)
        except Exception as e:  # noqa: BLE001 — see poll()
            log.exception("stop_trace failed")
            err = f"{type(e).__name__}: {e}"
        with self._lock:
            if err:
                self.last_error = err
            else:
                self.captures += 1
                self.last_logdir = self._active_logdir
                log.info("serving profile capture #%d written to %s",
                         self.captures, self.last_logdir)
            self._active_logdir = ""
            self._starting = False
            self._armed = False

    def status(self) -> dict:
        """The ``GET /debug/profile`` payload."""
        with self._lock:
            return {
                "active": self._armed,
                "starting": self._starting,
                "steps_left": (self._pending[0] if self._pending
                               else self._steps_left),
                "captures": self.captures,
                "last_logdir": self.last_logdir,
                "last_error": self.last_error,
            }

    def close(self) -> None:
        """Terminal stop (gateway shutdown): finalize a capture left
        running and refuse all future ``request()``s. A capture still
        inside start_trace on another thread finalizes itself when the
        spin-up returns and finds ``_closed`` set."""
        with self._lock:
            self._closed = True  # terminal: request() refuses from
            # here on, so nothing can arm a capture that would collide
            # with an in-flight start/stop (one session at a time)
            self._pending = None
            stop = self._steps_left > 0
            self._steps_left = 0
            if stop:
                # hold pollers off the stop; _armed stays True until
                # _stop_outside_lock completes
                self._starting = True
            elif not self._starting:
                # a start/stop still in flight on a poller thread keeps
                # _armed until ITS completion path (which sees _closed)
                # finalizes; clearing it here would only widen races
                self._armed = False
        if stop:
            self._stop_outside_lock()
