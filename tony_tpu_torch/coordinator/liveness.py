"""Heartbeat liveness monitor.

The PyTorch port's copy of ``tony_tpu/coordinator/liveness.py``.

Reference: Hadoop AbstractLivelinessMonitor wired in
ApplicationMaster.java:202-222 — a task expires after
``heartbeat-interval * max(3, max-missed-heartbeats)`` without a ping;
expiry fires ``onTaskDeemedDead`` (:1225-1232) which fails the app.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable

log = logging.getLogger(__name__)


def _expiry_s(interval_ms: int, max_missed: int) -> float:
    return (interval_ms / 1000) * max(3, max_missed)


def liveness_expiry_s(conf) -> float:
    """The ONE expiry-horizon formula. The coordinator expires a silent
    task after this long; the agent self-terminates after being unable to
    reach the coordinator for this long; the client fences a coordinator
    respawn past this + the checkpoint grace. All three must agree or
    task generations can overlap on the chips — change _expiry_s only."""
    return _expiry_s(conf.get_int("tony.task.heartbeat-interval-ms", 1000),
                     conf.get_int("tony.task.max-missed-heartbeats", 25))


def heartbeat_rpc_timeout_s(conf) -> float:
    """Per-ping RPC timeout on the agent's dedicated heartbeat channel —
    shared with the client's respawn-fence budget (a split copy of this
    formula would silently shorten the fence)."""
    hb_s = conf.get_int("tony.task.heartbeat-interval-ms", 1000) / 1000
    return max(2 * hb_s, 2.0)


class LivenessMonitor:
    def __init__(self, interval_ms: int, max_missed: int,
                 on_expired: Callable[[str], None]):
        self.expiry_s = _expiry_s(interval_ms, max_missed)
        self.check_s = max(interval_ms / 1000, 0.05)
        self.on_expired = on_expired
        self._last: dict[str, float] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def register(self, task_id: str) -> None:
        with self._lock:
            self._last[task_id] = time.monotonic()

    def clear(self) -> None:
        """Drop every watched task — session reset/resize must not let a
        previous epoch's entries expire against the new session."""
        with self._lock:
            self._last.clear()

    def unregister(self, task_id: str) -> None:
        """Stop watching a task — called when its result is registered, to
        close the completion-vs-heartbeat race (ref: ApplicationMaster.java
        :928-956 three-way race comment)."""
        with self._lock:
            self._last.pop(task_id, None)

    def ping(self, task_id: str) -> None:
        with self._lock:
            if task_id in self._last:
                self._last[task_id] = time.monotonic()

    def _loop(self) -> None:
        while not self._stop.wait(self.check_s):
            now = time.monotonic()
            expired = []
            with self._lock:
                for task_id, last in list(self._last.items()):
                    if now - last > self.expiry_s:
                        expired.append(task_id)
                        del self._last[task_id]
            for task_id in expired:
                log.error("task %s missed heartbeats for %.1fs; deemed dead",
                          task_id, self.expiry_s)
                try:
                    self.on_expired(task_id)
                except Exception:
                    log.exception("on_expired callback failed for %s", task_id)

    def start(self) -> "LivenessMonitor":
        self._thread = threading.Thread(target=self._loop, name="liveness",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2)
