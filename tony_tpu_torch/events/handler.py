"""Event handler: queue + writer thread + inprogress->final rename.

The PyTorch port's copy of ``tony_tpu/events/handler.py``.

Reference: events/EventHandler.java:22 — AM emits events into a
BlockingQueue drained by a writer thread into an in-progress history file
under intermediate/<app>/; on stop, drains the queue and renames the file to
the final name encoding completion time + status (:137-155).
"""

from __future__ import annotations

import getpass
import json
import logging
import os
import queue
import threading
import time

from tony_tpu_torch import constants as C
from tony_tpu_torch.events import history
from tony_tpu_torch.events.event import Event, JobMetadata

log = logging.getLogger(__name__)


class EventHandler:
    def __init__(self, history_root: str, app_id: str, user: str | None = None):
        self.history_root = history_root
        self.app_id = app_id
        self.user = user or getpass.getuser()
        self.started_ms = int(time.time() * 1000)
        self.queue: "queue.Queue[Event | None]" = queue.Queue()
        self.job_dir = history.intermediate_dir(history_root, app_id)
        os.makedirs(self.job_dir, exist_ok=True)
        self.inprogress_path = os.path.join(
            self.job_dir, history.inprogress_name(app_id, self.started_ms)
        )
        self._thread: threading.Thread | None = None
        self._stopped = threading.Event()
        self._write_metadata("RUNNING", -1)

    # -- lifecycle (ref: setUpThread :43 / start) ---------------------------
    def start(self) -> "EventHandler":
        self._thread = threading.Thread(target=self._drain, name="event-writer",
                                        daemon=True)
        self._thread.start()
        return self

    def emit(self, event: Event) -> None:
        """Ref: emitEvent :88 — never blocks the coordinator."""
        if not self._stopped.is_set():
            self.queue.put(event)

    def _drain(self) -> None:
        with open(self.inprogress_path, "a", buffering=1) as f:
            while True:
                ev = self.queue.get()
                if ev is None:
                    return
                try:
                    f.write(json.dumps(ev.to_dict()) + "\n")
                except Exception:
                    log.exception("failed writing event %s", ev.type)

    def stop(self, final_status: str) -> str:
        """Drain, write final metadata, rename inprogress -> final
        (ref: stop + rename :137-155). Returns the final jhist path."""
        self._stopped.set()
        self.queue.put(None)
        if self._thread:
            self._thread.join(timeout=10)
        completed_ms = int(time.time() * 1000)
        final = os.path.join(
            self.job_dir,
            history.finished_name(self.app_id, self.started_ms, completed_ms,
                                  self.user, final_status),
        )
        try:
            os.rename(self.inprogress_path, final)
        except FileNotFoundError:
            open(final, "a").close()
        self._write_metadata(final_status, completed_ms)
        return final

    def _write_metadata(self, status: str, completed_ms: int) -> None:
        meta = JobMetadata(
            id=self.app_id,
            user=self.user,
            started=self.started_ms,
            completed=completed_ms,
            status=status,
            conf_path=os.path.join(self.job_dir, C.TONY_FINAL_CONF),
        )
        with open(os.path.join(self.job_dir, C.METADATA_FILE), "w") as f:
            json.dump(meta.to_dict(), f, indent=2)
