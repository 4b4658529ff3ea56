"""Per-request trace model: spans, attempts, Chrome trace-event export.

The PyTorch port's copy of ``tony_tpu/obs/trace.py``.

The serving analog of TonY's per-task history record (PAPER.md L4/L6:
every job leaves an inspectable trail), at request granularity: a
``RequestTrace`` is a tree of timed spans accumulated while a request
moves through the gateway — http-receive, route, then one ATTEMPT span
per engine run (a failover produces a second attempt on a different
replica, fenced by its epoch), each holding queue-wait, admit
(prefix-lookup / prefill with its bucket / hit-admit), and one span per
decode dispatch the request rode (chunk vs spec-verify). The trace
answers the question counters cannot: *where did this request's time
go* — and for a failed-over request, *both* attempts live in ONE trace.

Design constraints, in order:

- **Always-on-cheap**: span append is a lock + a dataclass. No string
  formatting, no export work, nothing proportional to trace size on
  the hot path; export cost is paid only when somebody asks
  (``/debug/trace/<id>``).
- **Failover-safe**: the replica thread appending decode spans and the
  supervisor ending an attempt (steal) race; all structural mutation
  runs under the trace's own lock, and a span appended to an attempt
  that was already ended is DROPPED — the tracing analog of the epoch
  fence discarding a dead epoch's output. A dropped span can only come
  from a stale owner, and its tokens were re-run (and re-traced) on
  the failover attempt.
- **One clock**: spans record ``time.monotonic()`` (the clock every
  gateway timestamp already uses); the trace stores a wall-clock
  anchor at creation so export converts to epoch microseconds — the
  Chrome/Perfetto ``ts`` convention — without ever mixing clocks
  inside the invariants.

Export is standard Chrome trace-event JSON (``{"traceEvents": [...]}``,
"X" complete events): ``chrome://tracing`` and https://ui.perfetto.dev
load it directly. ``pid`` is the replica that ran the span's attempt,
``tid`` the attempt ordinal — a failover renders as the request
hopping rows mid-flight.
"""

from __future__ import annotations

import json
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any


@dataclass
class Span:
    """One timed region. ``t0``/``t1`` are ``time.monotonic()`` seconds
    (``t1`` None while open); ``tags`` is a small flat dict of
    JSON-able values; children nest strictly inside the parent."""

    name: str
    t0: float
    t1: float | None = None
    tags: dict = field(default_factory=dict)
    children: list["Span"] = field(default_factory=list)

    @property
    def dur_s(self) -> float:
        return (self.t1 - self.t0) if self.t1 is not None else 0.0


class RequestTrace:
    """Span accumulator for one request's whole life, failovers
    included. All mutation is serialized by an internal lock (the
    replica thread, the supervisor's steal path, and the delivery path
    all write). See the module docstring for the drop rule."""

    def __init__(self, request_id: Any, t0: float | None = None,
                 max_spans: int = 4096):
        self._lock = threading.Lock()
        self.request_id = request_id
        t0 = time.monotonic() if t0 is None else t0
        # wall anchor: export maps monotonic -> epoch microseconds
        self._wall0 = time.time() - (time.monotonic() - t0)
        self.root = Span("request", t0,
                         tags={"request_id": str(request_id)})
        self._attempt: Span | None = None  # the open attempt, if any
        self.n_attempts = 0
        self.dropped = 0  # spans discarded as stale (see module doc)
        # memory bound: a 2048-token generation at chunk_steps=1 rides
        # ~2048 decode dispatches; past the cap further spans are
        # counted, not stored, so a trace ring of marathon requests
        # cannot grow without bound
        self.max_spans = max(1, max_spans)
        self._n_spans = 0
        self.truncated = 0  # spans past max_spans (counted, not kept)
        self.done = False

    # ------------------------------------------------------- recording

    def add(self, name: str, t0: float, t1: float | None = None,
            *, attempt: bool | None = None,
            attempt_key: tuple | None = None, clamp: bool = False,
            **tags) -> None:
        """Append a span. ``attempt=True`` targets the OPEN attempt
        (dropped when none is open — a stale owner's late record);
        default targets the open attempt when one exists, else the
        root. ``t1`` defaults to ``t0`` (instant event).

        ``attempt_key=(replica, epoch)`` is the airtight form of the
        drop rule: the span lands only if the open attempt carries
        exactly those tags, checked ATOMICALLY under the trace lock —
        a stale owner whose snapshot raced a steal + re-placement
        (attempt already re-opened on the survivor) is dropped instead
        of mis-attributed to the new attempt.

        ``clamp=True`` clamps the span into its parent's window and
        behind the previous sibling's start, preserving the structural
        invariants (children nest, siblings monotonic) for timestamps
        that arrive from ANOTHER CLOCK: remote dispatch records are
        offset-corrected by an RTT-midpoint estimate whose error can
        legitimately place a span a few ms outside the attempt — the
        correction is honest-but-uncertain, and a debug surface must
        stay well-formed under that uncertainty."""
        span = Span(name, t0, t0 if t1 is None else t1, tags)
        with self._lock:
            if self.done:
                self.dropped += 1
                return
            if attempt_key is not None:
                parent = self._attempt
                if parent is None or attempt_key != (
                        parent.tags.get("replica"),
                        parent.tags.get("epoch")):
                    self.dropped += 1
                    return
            elif attempt is False:
                parent = self.root
            else:
                parent = self._attempt
                if parent is None:
                    if attempt:  # attempt-only span with no open attempt
                        self.dropped += 1
                        return
                    parent = self.root
            if self._n_spans >= self.max_spans:
                self.truncated += 1
                return
            if clamp:
                lo = parent.t0
                if parent.children:
                    lo = max(lo, parent.children[-1].t0)
                span.t0 = max(span.t0, lo)
                span.t1 = max(span.t1, span.t0)
                if parent.t1 is not None:
                    span.t0 = min(span.t0, parent.t1)
                    span.t1 = min(span.t1, parent.t1)
            self._n_spans += 1
            parent.children.append(span)

    def begin_attempt(self, replica: int, epoch: int,
                      t0: float | None = None, **tags) -> None:
        """Open attempt N on ``replica`` (its epoch is the fencing tag
        the failover story revolves around). Extra ``tags`` (the
        placement's ``host``, say) ride on the attempt span. An
        attempt already open is ended first — belt and braces; the
        supervisor normally ends it at the steal."""
        t0 = time.monotonic() if t0 is None else t0
        with self._lock:
            if self.done:
                self.dropped += 1
                return
            if self._attempt is not None and self._attempt.t1 is None:
                self._attempt.t1 = self._cover(self._attempt, t0)
            self.n_attempts += 1
            span = Span(f"attempt-{self.n_attempts}", t0,
                        tags={"replica": replica, "epoch": epoch,
                              **tags})
            self.root.children.append(span)
            self._attempt = span

    @staticmethod
    def _cover(span: Span, t1: float) -> float:
        """A close time that COVERS the span's children: remote spans
        carry offset-corrected timestamps whose estimation error can
        place a dispatch's end a fraction of a ms past the gateway's
        own delivery instant — the attempt genuinely covered that
        dispatch, so the close extends rather than orphaning it."""
        for c in span.children:
            t1 = max(t1, c.t0 if c.t1 is None else c.t1)
        return t1

    def end_attempt(self, t1: float | None = None, **tags) -> None:
        """Close the open attempt (delivery, shed, or the supervisor's
        steal). No-op when none is open."""
        t1 = time.monotonic() if t1 is None else t1
        with self._lock:
            if self._attempt is not None and self._attempt.t1 is None:
                self._attempt.t1 = self._cover(self._attempt, t1)
                self._attempt.tags.update(tags)
            self._attempt = None

    def finish(self, t1: float | None = None, **tags) -> None:
        """Terminal: close the open attempt and the root. After this
        every further append is dropped — a late span must never mutate
        an exported trace."""
        t1 = time.monotonic() if t1 is None else t1
        with self._lock:
            if self.done:
                return
            if self._attempt is not None and self._attempt.t1 is None:
                self._attempt.t1 = self._cover(self._attempt, t1)
            self._attempt = None
            self.root.t1 = self._cover(self.root, t1)
            self.root.tags.update(tags)
            self.done = True

    # --------------------------------------------------------- export

    def _us(self, t: float) -> float:
        return (self._wall0 + t) * 1e6

    def to_chrome(self) -> dict:
        """Chrome trace-event JSON (the dict; ``json.dumps`` it). Every
        span becomes an "X" complete event; open spans (an in-flight
        request inspected early) are clamped to the latest timestamp
        seen so the export is always well-formed."""
        with self._lock:
            events: list[dict] = []
            threads: dict[int, int] = {}  # tid -> replica (pid)

            def clamp(span: Span) -> float:
                end = span.t0 if span.t1 is None else span.t1
                for c in span.children:
                    end = max(end, clamp(c))
                return end

            def walk(span: Span, pid: int, tid: int) -> None:
                t1 = clamp(span)
                events.append({
                    "name": span.name, "ph": "X", "cat": "serving",
                    "ts": self._us(span.t0),
                    "dur": max(0.0, (t1 - span.t0) * 1e6),
                    "pid": pid, "tid": tid,
                    "args": dict(span.tags),
                })
                for c in span.children:
                    walk(c, pid, tid)

            tid = 0
            threads[0] = -1
            walk_children = list(self.root.children)
            # the root + non-attempt children render on tid 0; each
            # attempt gets its own tid and its replica as pid
            root_end = clamp(self.root)
            events.append({
                "name": self.root.name, "ph": "X", "cat": "serving",
                "ts": self._us(self.root.t0),
                "dur": max(0.0, (root_end - self.root.t0) * 1e6),
                "pid": -1, "tid": 0, "args": dict(self.root.tags),
            })
            hosts: dict[int, str] = {-1: "gateway"}
            for child in walk_children:
                if child.name.startswith("attempt-"):
                    tid += 1
                    pid = int(child.tags.get("replica", -1))
                    threads[tid] = pid
                    # the placement's host (agent address | "local")
                    # names the pid row: a fleet trace must say WHICH
                    # MACHINE each attempt ran on, not just the index
                    host = child.tags.get("host")
                    if host is not None:
                        hosts[pid] = f"replica {pid} ({host})"
                    walk(child, pid, tid)
                else:
                    walk(child, -1, 0)
            meta = [{"name": "thread_name", "ph": "M", "pid": pid,
                     "tid": t, "args": {"name": "request" if t == 0
                                        else f"attempt-{t}"}}
                    for t, pid in threads.items()]
            meta.extend({"name": "process_name", "ph": "M", "pid": pid,
                         "tid": 0, "args": {"name": name}}
                        for pid, name in sorted(hosts.items()))
            return {
                "displayTimeUnit": "ms",
                "otherData": {"request_id": str(self.request_id),
                              "attempts": self.n_attempts,
                              "dropped_spans": self.dropped,
                              "truncated_spans": self.truncated},
                "traceEvents": meta + events,
            }

    def to_json(self) -> str:
        return json.dumps(self.to_chrome())


def check_invariants(trace: RequestTrace) -> list[str]:
    """Structural validation, used by tests and debug tooling. Returns
    a list of problems (empty = healthy):

    - every span is closed with ``t1 >= t0``;
    - children lie inside their parent's window;
    - siblings appear in monotonic ``t0`` order (spans are appended in
      wall order by construction — a violation means a clock or
      locking bug).
    """
    problems: list[str] = []

    def walk(span: Span, path: str) -> None:
        here = f"{path}/{span.name}"
        if span.t1 is None:
            problems.append(f"{here}: span never closed")
            return
        if span.t1 < span.t0:
            problems.append(f"{here}: t1 {span.t1} < t0 {span.t0}")
        prev = None
        for c in span.children:
            if c.t0 < span.t0 - 1e-9 or (
                    c.t1 is not None and span.t1 is not None
                    and c.t1 > span.t1 + 1e-9):
                problems.append(
                    f"{here}/{c.name}: child [{c.t0}, {c.t1}] outside "
                    f"parent [{span.t0}, {span.t1}]")
            if prev is not None and c.t0 < prev - 1e-9:
                problems.append(
                    f"{here}/{c.name}: sibling t0 {c.t0} before "
                    f"previous sibling t0 {prev}")
            prev = c.t0
            walk(c, here)

    walk(trace.root, "")
    return problems


class TraceBuffer:
    """Bounded ring of recently finished traces, keyed by request id
    (stringified — the id a client passes or the UUID the front door
    minted). ``put`` evicts the oldest past ``capacity``; a re-used id
    replaces its old trace (last-writer-wins, matching /stats rows)."""

    def __init__(self, capacity: int = 256):
        self.capacity = max(1, capacity)
        self._lock = threading.Lock()
        self._traces: OrderedDict[str, RequestTrace] = OrderedDict()

    def put(self, trace: RequestTrace) -> None:
        key = str(trace.request_id)
        with self._lock:
            self._traces.pop(key, None)
            self._traces[key] = trace
            while len(self._traces) > self.capacity:
                self._traces.popitem(last=False)

    def get(self, request_id: Any) -> RequestTrace | None:
        with self._lock:
            return self._traces.get(str(request_id))

    def ids(self) -> list[str]:
        with self._lock:
            return list(self._traces)

    def summaries(self) -> list[dict]:
        """The ``GET /debug/traces`` listing: one row per buffered
        trace — request id, attempt count, and the TERMINAL tags the
        root span carries (outcome, finish_reason/status, token
        counts, latency) — so an operator can find the trace worth
        opening without already knowing its request_id."""
        with self._lock:
            traces = list(self._traces.values())
        out = []
        for t in traces:
            tags = {k: v for k, v in t.root.tags.items()
                    if k != "request_id"}
            # "host": which machine(s) the request's placements ran on
            # (agent address | "local"), matching the ``host`` field
            # requests.jsonl rows carry — without it a listing cannot
            # tell two hosts' requests apart
            hosts = [c.tags.get("host") for c in t.root.children
                     if c.name.startswith("attempt-")
                     and c.tags.get("host") is not None]
            # "placements": replica placements (attempt spans) — the
            # root's own "attempts" terminal tag keeps its metrics
            # meaning (FAILED engine runs) and must not be clobbered
            out.append({"request_id": str(t.request_id),
                        "placements": t.n_attempts,
                        "host": hosts[-1] if hosts else None,
                        "done": t.done, **tags})
        return out

    def __len__(self) -> int:
        with self._lock:
            return len(self._traces)
