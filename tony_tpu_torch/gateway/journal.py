"""Durable ticket journal: the gateway's write-ahead log.

The PyTorch port's copy of ``tony_tpu/gateway/journal.py``.

TonY's control plane survives a resource-manager restart because the
job-history record outlives the ApplicationMaster process — a restarted
coordinator replays it and re-adopts its running containers instead of
killing the job. This module is that record for the gateway: one
NDJSON file under the history job_dir, appended on the same paths that
already build ``requests.jsonl`` rows, recording per request id

  {"ev": "admit", "rid", "t", "prompt": [ids], "max_new_tokens",
   "temperature", "top_k", "seed", "stream"}     admission accepted
  {"ev": "route", "rid", "replica": i, "host": "h:p"|null}
                                                 placed on a replica
                                                 (null host = local,
                                                 in-process engine)
  {"ev": "emit", "rid", "off": N}                N tokens delivered to
                                                 the client so far
                                                 (absolute offset)
  {"ev": "done", "rid"} / {"ev": "shed", "rid", "status": 503}
                                                 terminal

On boot with ``--recover`` the gateway replays the newest journal it
can find and learns exactly which requests were in flight, where they
were running, and how many tokens each client already received — the
three facts restart recovery needs (gateway/core.py adopts the parked
remote sessions and re-runs the local ones from the prompt; the
journaled offset seeds the absolute-offset emit dedup so resumed
client streams carry exactly the missing suffix).

Durability knob (``--journal-fsync``): "always" fsyncs every append
(each admitted request survives a power cut, at a syscall per token
batch), "batch" (default) fsyncs terminals and admits but lets emit
offsets ride the OS page cache (a crash forgets at most the last few
offsets — recovery then re-emits a suffix the client's own resume
offset dedups), "off" never fsyncs (throughput benches).

The journal COMPACTS on clean drain: every request that reached a
terminal is dropped and the file is rewritten atomically (tmp +
rename), so a cleanly-drained gateway leaves an empty journal and
``--recover`` on the next boot finds nothing to do. A torn final line
(the append a crash cut mid-write) is tolerated on replay: NDJSON's
framing makes every complete line independently decodable, and the
torn tail by construction holds the least information in the file.
"""

from __future__ import annotations

import json
import logging
import os
import threading

log = logging.getLogger(__name__)

FSYNC_POLICIES = ("always", "batch", "off")


class JournalEntry:
    """One request's replayed state: everything recovery needs."""

    __slots__ = ("rid", "request", "replica", "host", "offset",
                 "terminal", "t_admit")

    def __init__(self, rid):
        self.rid = rid
        self.request: dict | None = None   # the admit row's params
        self.replica: int | None = None    # replica index at crash
        self.host: str | None = None       # "h:p" for remote, None local
        self.offset = 0                    # tokens the client received
        self.terminal: str | None = None   # "done" / "shed" / None=live
        self.t_admit = 0.0

    @property
    def live(self) -> bool:
        return self.terminal is None and self.request is not None


class TicketJournal:
    """Append-side of the WAL. Thread-safe: admits land from handler
    threads, emit offsets from replica loops, terminals from both."""

    def __init__(self, path: str, fsync: str = "batch"):
        if fsync not in FSYNC_POLICIES:
            raise ValueError(
                f"fsync policy {fsync!r} not in {FSYNC_POLICIES}")
        self.path = path
        self.fsync = fsync
        self._lock = threading.Lock()
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        # append mode: a recovered gateway keeps journaling into the
        # journal it replayed — the live entries it re-admitted get
        # fresh route/emit rows under their original rids
        self._f = open(path, "a", encoding="utf-8")
        self._closed = False

    # ------------------------------------------------------- appends

    def _append(self, doc: dict, *, sync: bool) -> None:
        line = json.dumps(doc, separators=(",", ":")) + "\n"
        with self._lock:
            if self._closed:
                return
            self._f.write(line)
            self._f.flush()
            if self.fsync == "always" or (sync and self.fsync == "batch"):
                os.fsync(self._f.fileno())

    def admit(self, rid, request_doc: dict, t_wall: float) -> None:
        """The moment admission accepted the request — before any
        token exists. ``request_doc`` must carry enough to re-run from
        the prompt (prompt/max_new_tokens/temperature/top_k/seed)."""
        self._append({"ev": "admit", "rid": rid, "t": t_wall,
                      **request_doc}, sync=True)

    def route(self, rid, replica: int, host: str | None) -> None:
        self._append({"ev": "route", "rid": rid, "replica": replica,
                      "host": host}, sync=False)

    def emit(self, rid, offset: int) -> None:
        """Absolute client-delivered offset — the high-rate row; under
        the "batch" policy it rides the page cache (see module doc)."""
        self._append({"ev": "emit", "rid": rid, "off": int(offset)},
                     sync=False)

    def done(self, rid) -> None:
        self._append({"ev": "done", "rid": rid}, sync=True)

    def shed(self, rid, status: int) -> None:
        self._append({"ev": "shed", "rid": rid, "status": int(status)},
                     sync=True)

    # ---------------------------------------------------- compaction

    def compact(self) -> int:
        """Drop every terminated request; atomic rewrite. Returns the
        number of LIVE entries kept (0 after a clean drain)."""
        with self._lock:
            if not self._closed:
                self._f.flush()
            entries = _replay_lines(self.path)
            live = [e for e in entries.values() if e.live]
            tmp = self.path + ".tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                for e in live:
                    f.write(json.dumps(
                        {"ev": "admit", "rid": e.rid, "t": e.t_admit,
                         **(e.request or {})},
                        separators=(",", ":")) + "\n")
                    if e.replica is not None:
                        f.write(json.dumps(
                            {"ev": "route", "rid": e.rid,
                             "replica": e.replica, "host": e.host},
                            separators=(",", ":")) + "\n")
                    if e.offset:
                        f.write(json.dumps(
                            {"ev": "emit", "rid": e.rid,
                             "off": e.offset},
                            separators=(",", ":")) + "\n")
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.path)
            if not self._closed:
                self._f.close()
                self._f = open(self.path, "a", encoding="utf-8")
            return len(live)

    def close(self, *, compact: bool = False) -> None:
        if compact:
            self.compact()
        with self._lock:
            if not self._closed:
                self._closed = True
                self._f.flush()
                if self.fsync != "off":
                    os.fsync(self._f.fileno())
                self._f.close()

    # -------------------------------------------------------- replay


def _replay_lines(path: str) -> dict:
    entries: dict = {}
    try:
        f = open(path, "r", encoding="utf-8")
    except FileNotFoundError:
        return entries
    with f:
        for i, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            try:
                doc = json.loads(line)
            except ValueError:
                # the torn tail a crash cut mid-append — every complete
                # line before it already decoded, and a torn line can
                # only be the file's LAST append, so skipping it loses
                # at most one emit offset (recovery over-resends a
                # suffix the client-side offset dedup drops)
                log.warning("journal %s: skipping torn line %d",
                            path, i + 1)
                continue
            rid = doc.get("rid")
            if rid is None:
                continue
            e = entries.get(rid)
            if e is None:
                e = entries[rid] = JournalEntry(rid)
            ev = doc.get("ev")
            if ev == "admit":
                e.t_admit = float(doc.get("t", 0.0))
                e.request = {k: v for k, v in doc.items()
                             if k not in ("ev", "rid", "t")}
            elif ev == "route":
                e.replica = doc.get("replica")
                e.host = doc.get("host")
            elif ev == "emit":
                e.offset = max(e.offset, int(doc.get("off", 0)))
            elif ev in ("done", "shed"):
                e.terminal = ev
    return entries


def replay(path: str) -> dict:
    """Replay a journal into ``{rid: JournalEntry}``. Idempotent (a
    second replay of the same file returns the same map) and tolerant
    of a torn final line. Missing file -> empty map: ``--recover`` on
    a fresh deployment is a no-op, not an error."""
    return _replay_lines(path)


def find_latest(history_root: str) -> str | None:
    """The newest ``journal.ndjson`` under ``<root>/intermediate/*/``
    — a restarted gateway gets a NEW timestamped job_dir, so recovery
    must look at the previous boots' dirs, not its own."""
    inter = os.path.join(history_root, "intermediate")
    best: tuple[float, str] | None = None
    try:
        apps = os.listdir(inter)
    except OSError:
        return None
    for app in apps:
        p = os.path.join(inter, app, "journal.ndjson")
        try:
            mt = os.path.getmtime(p)
        except OSError:
            continue
        if best is None or mt > best[0]:
            best = (mt, p)
    return best[1] if best else None
