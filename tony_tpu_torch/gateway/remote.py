"""Remote replicas: the gateway-side stub over a replica agent.

The other half of ``serve/agent.py`` — the piece that closes the TonY
loop for serving: the ApplicationMaster doesn't run the work, it
acquires hosts and SUPERVISES the TaskExecutors running there.
``RemoteServer`` presents the exact ``serve.Server`` surface the
in-process ``_Replica`` scheduler drives (``submit`` / ``step`` /
``live_progress`` / ``counters`` / ``reset`` / ``slots``), so
routing, WFQ admission, deadlines, autoscaling and the stats rollups
work UNCHANGED over a replica that lives on another machine. What
changes is only what a network adds:

- **Lease heartbeats**: a heartbeat thread GETs the agent's
  ``/healthz`` every ``heartbeat_interval_s``; each success pings a
  ``coordinator/liveness.LivenessMonitor`` lease (the same expiry
  machinery TonY's AM runs over its task heartbeats). No successful
  heartbeat for the lease horizon — dead process, network partition,
  black hole, it cannot matter which — expires the lease, and the
  bound supervisor callback funnels into the gateway's existing
  ``_fail_replica`` -> token-exact failover. A dead host is just a
  wedged replica.
- **The epoch fence, over the wire**: every call carries the stub's
  epoch and every agent response echoes one. ``reset()`` (the
  breaker's recovery step) bumps the epoch; readers discard any line
  carrying an older echo (``stale_epoch_drops``), and the agent
  itself refuses calls older than what it has adopted (409) — a
  wedged-then-revived host can neither deliver stale tokens nor
  accept stale work.
- **Resume, not failover, for connection blips**: every in-flight
  request streams at absolute token offsets, so a dropped connection
  to a HEALTHY agent reconnects at ``offset = tokens already held``
  and the stream continues exactly — no retry budget charged, no
  replica failed. Connect errors retry with capped exponential
  backoff + jitter *within* the lease (a transient blip is not a
  failover); only the lease decides death.
- **ONE multiplexed channel per replica**:
  all of a replica's ticket streams ride a single long-lived
  ``POST /v1/channel`` connection as tagged NDJSON frames
  (``{"rid", "off", "token_ids"}`` / ``{"rid", "done", "result"}``),
  demuxed by ONE thread — connections and reader threads stop
  scaling with the replica's batch size. Reconnect re-establishes
  every in-flight stream at its offset in one round trip (the resume
  map rides the request body); the epoch fence and the obs
  batches ride the same frames. ``agent_channel="per-ticket"``
  (``--agent-channel`` in the CLI) keeps the original
  one-connection-per-stream path as the A/B control.
- **Typed refusals**: the agent maps engine refusals to ``kind`` tags
  and the stub re-raises the real types (``QueueFull``,
  ``PoolExhausted``, ``ValueError``), so the gateway's admission
  paths cannot tell local from remote.
- **Live migration, over the wire**: ``submit`` ships a
  frozen session (``request.migrate``) to ``POST /v1/migrate_in``,
  and ``extract_session`` freezes a live slot OUT of the agent via
  ``POST /v1/migrate_out``. Owner-swap payloads (shared-pool page
  ids from a co-located source) are gathered to page CONTENT here —
  in place, consuming the transfer ref exactly once, so a retried or
  requeued ticket ships the gathered copy instead of dangling ids.
  The agent's bounded radix summary rides every heartbeat, and
  ``prefix_match_len`` scores it with the same grain-grid probe the
  local store uses — prefix affinity can now prefer a REMOTE replica
  that holds the prompt's prefix over a cold local one.
- **The observability plane, pulled over the wire**: an
  obs-puller rides the heartbeat cadence — after each successful
  ``/healthz`` it GETs ``/v1/obs?cursor=`` and lands the agent's
  incremental dispatch-timeline records, lifetime per-kind summary,
  and goodput ledger into a ``RemoteTimeline``/``goodput()`` that
  present the exact ``server.timeline``/``server.goodput()`` surface
  a local engine has, so ``/stats engine.dispatch``, the fleet
  goodput rollup, ``/debug/goodput``, the ``goodput_collapse`` alert,
  and per-request trace grafting work UNCHANGED over a remote
  replica. Record timestamps arrive in the AGENT's monotonic clock
  and are corrected by an RTT-midpoint offset estimate (EWMA over
  heartbeats: ``offset = agent_t_mono - heartbeat midpoint``,
  uncertainty = RTT/2) — honest-but-uncertain, so the offset AND its
  uncertainty ride every grafted span and export as
  ``tony_transport_clock_offset_ms``. A pull that fails degrades to
  staleness (``obs.lag_s`` grows, ``pull_errors`` counts), never to a
  replica failure: observability must not be able to take serving
  down.

Transport fault injection (``serve/faults.py`` transport ops, armed
via ``TONY_SERVE_FAULTS`` -> ``FaultPlan.transport_from_env``) hooks
the two choke points here — once per HTTP call, once per stream read
— so refuse / black-hole / delay / disconnect-mid-stream / half-open
are all deterministic, testable failure modes instead of hardware
folklore.
"""

from __future__ import annotations

import http.client
import json
import logging
import random
import subprocess
import sys
import threading
import time
from collections import deque
from types import SimpleNamespace

from tony_tpu_torch.obs.timeline import record_from_doc
from tony_tpu_torch.serve.agent import result_from_doc
from tony_tpu_torch.serve.engine import PoolExhausted, QueueFull, Request
from tony_tpu_torch.serve.prefix import summary_match_len

log = logging.getLogger(__name__)


def close_server(server, what: str) -> None:
    """Best-effort close of a replica server's remote machinery
    (lease/heartbeat threads, launched agent reaping) — a no-op for
    local engines, which have no ``close``. The ONE teardown helper
    every retire/destroy/drain path shares: teardown trouble is a
    logged event, never a dead caller."""
    close = getattr(server, "close", None)
    if close is None:
        return
    try:
        close()
    except Exception:
        log.exception("%s: remote server close failed", what)


class AgentHTTPError(RuntimeError):
    """A non-200 the agent answered deliberately (vs a transport
    error): carries the status and the parsed body."""

    def __init__(self, status: int, doc: dict):
        super().__init__(f"agent answered {status}: "
                         f"{doc.get('error', '(no error body)')}")
        self.status = status
        self.doc = doc


class AgentTransport:
    """One agent's HTTP client: JSON calls + NDJSON streams, an epoch
    header on everything, fault hooks at the choke points, and capped
    exponential backoff with jitter on CONNECT errors (refused/reset
    before a response) — the in-lease transient-blip absorber. Read
    timeouts are never retried here: the caller already paid the
    wait, and the lease is the authority on death.

    Control calls (``call()``: healthz / obs / submit / reset / drain)
    ride ONE persistent keep-alive connection: a heartbeat
    every second used to pay a TCP handshake every second, and under
    load the submits compounded that. The connection is rebuilt on any
    error; a REUSED connection that fails is the classic stale-keep-
    alive race (the agent closed it between our calls), so those
    failures stay in the retryable class — one backoff lap gets a
    fresh socket. Per-call timeout bounds still apply (the socket's
    deadline is set per request), so the obs pull's lease-slack bound
    carries over unchanged."""

    def __init__(self, address: str, *, connect_timeout_s: float = 2.0,
                 read_timeout_s: float = 5.0, connect_retries: int = 3,
                 backoff_base_s: float = 0.05, backoff_max_s: float = 0.5,
                 fault_plan=None):
        host, _, port = address.rpartition(":")
        if not host or not port.isdigit():
            raise ValueError(f"agent address must be host:port, "
                             f"got {address!r}")
        self.address = address
        self.host, self.port = host, int(port)
        self.connect_timeout_s = connect_timeout_s
        self.read_timeout_s = read_timeout_s
        self.connect_retries = max(0, connect_retries)
        self.backoff_base_s = backoff_base_s
        self.backoff_max_s = backoff_max_s
        self.fault_plan = fault_plan
        # transport observability (the /stats ``transport`` block)
        self.retries = 0         # connect-error retries that happened
        self.connect_errors = 0  # connect errors seen (pre-retry)
        self._lock = threading.Lock()
        self._rng = random.Random(0xA9E27 ^ hash(address))
        # the persistent control connection: all call()s serialize on
        # it (they are small and bounded; streams get their own
        # sockets). None = rebuild on next use.
        self._ctrl: http.client.HTTPConnection | None = None
        self._ctrl_lock = threading.Lock()

    def _backoff(self, attempt: int) -> float:
        base = min(self.backoff_max_s,
                   self.backoff_base_s * (2 ** attempt))
        # full jitter (half to full of the computed backoff): retries
        # from many stubs against one recovering host must not arrive
        # in lockstep
        with self._lock:
            return base * (0.5 + 0.5 * self._rng.random())

    def close(self) -> None:
        """Drop the persistent control connection (stub shutdown)."""
        with self._ctrl_lock:
            self._drop_ctrl()

    def _drop_ctrl(self) -> None:
        # caller holds _ctrl_lock
        if self._ctrl is not None:
            try:
                self._ctrl.close()
            except Exception:  # noqa: BLE001 — closing a broken socket
                pass
            self._ctrl = None

    def _ctrl_roundtrip(self, method: str, path: str,
                        body: bytes | None, epoch: int,
                        timeout: float) -> tuple[int, bytes]:
        """One request/response on the persistent control connection.
        Caller holds ``_ctrl_lock``."""
        if self._ctrl is None:
            self._ctrl = http.client.HTTPConnection(
                self.host, self.port, timeout=self.connect_timeout_s)
            self._ctrl.connect()
        conn = self._ctrl
        if conn.sock is not None:
            # the per-call deadline (heartbeat bound, obs lease-slack
            # bound, drain budget) applies to THIS round trip, not the
            # connection's construction default
            conn.sock.settimeout(timeout)
        conn.request(method, path, body=body, headers={
            "X-Tony-Epoch": str(epoch),
            "Content-Type": "application/json"})
        resp = conn.getresponse()
        data = resp.read()
        if resp.will_close:
            # the agent asked to close (its >=400 replies do): honor it
            # now rather than discovering a dead socket next call
            self._drop_ctrl()
        return resp.status, data

    def call(self, method: str, path: str, doc: dict | None = None,
             *, epoch: int = 0, request=None,
             timeout: float | None = None) -> dict:
        """One JSON request/response over the persistent control
        connection. Raises ``AgentHTTPError`` on a non-200,
        ``ConnectionError``/``TimeoutError`` on transport failure
        (after in-lease connect retries)."""
        attempt = 0
        tmo = timeout if timeout is not None else self.read_timeout_s
        body = None if doc is None else json.dumps(doc).encode()
        while True:
            reused = False
            try:
                # the fault hook INSIDE the retry scope: an injected
                # refusal must exercise the same backoff path a real
                # one would, or the chaos tests prove nothing
                if self.fault_plan is not None:
                    self.fault_plan.on_call(f"{method} {path}",
                                            request=request)
                with self._ctrl_lock:
                    reused = self._ctrl is not None
                    try:
                        status, data = self._ctrl_roundtrip(
                            method, path, body, epoch, tmo)
                    except BaseException:
                        self._drop_ctrl()  # never reuse a socket in an
                        raise              # unknown protocol state
                out = json.loads(data) if data else {}
                if status != 200:
                    raise AgentHTTPError(status, out)
                return out
            except (ConnectionError, TimeoutError, OSError,
                    http.client.HTTPException) as e:
                # retryable: refused-class (dead port mid-restart), or
                # ANY non-timeout failure on a REUSED connection — the
                # agent may simply have closed the idle keep-alive
                # under us (HTTPException covers the garbled half-read
                # that race can leave). Timeouts are never retried:
                # the caller already paid the wait.
                retryable = isinstance(e, (ConnectionRefusedError,
                                           ConnectionResetError,
                                           BrokenPipeError)) \
                    or (reused and not isinstance(e, TimeoutError))
                with self._lock:
                    self.connect_errors += 1
                if not retryable or attempt >= self.connect_retries:
                    if isinstance(e, http.client.HTTPException) and \
                            not isinstance(e, ConnectionError):
                        # callers catch the ConnectionError family;
                        # a garbled response is transport trouble too
                        raise ConnectionError(
                            f"garbled agent response: {e!r}") from e
                    raise
                with self._lock:
                    self.retries += 1
                time.sleep(self._backoff(attempt))
                attempt += 1

    def stream_lines(self, path: str, *, epoch: int = 0, request=None,
                     method: str = "GET", doc: dict | None = None):
        """Generator over one NDJSON stream's parsed docs (its own
        dedicated socket — never the control connection). Transport
        trouble mid-stream raises; a clean server-side close just ends
        the generator (the reader's resume logic treats both as a
        disconnect). No internal retry — resume-by-offset IS the
        retry, and it needs the caller's current offset.

        A line that fails to parse is NOT fatal: it yields a
        ``{"_garbled": true}`` sentinel so the reader can count it and
        resync (reconnect at the offsets it holds) instead of dying —
        one corrupt frame on a multiplexed channel must not take down
        every stream riding it."""
        if self.fault_plan is not None:
            self.fault_plan.on_call(f"{method} {path}", request=request)
        conn = http.client.HTTPConnection(self.host, self.port,
                                          timeout=self.read_timeout_s)
        try:
            body = None if doc is None else json.dumps(doc).encode()
            conn.request(method, path, body=body,
                         headers={"X-Tony-Epoch": str(epoch),
                                  "Content-Type": "application/json"})
            resp = conn.getresponse()
            if resp.status != 200:
                raise AgentHTTPError(resp.status,
                                     json.loads(resp.read() or b"{}"))
            while True:
                if self.fault_plan is not None:
                    self.fault_plan.on_stream(path, request=request)
                line = resp.readline()
                if not line:
                    return
                try:
                    yield json.loads(line)
                except json.JSONDecodeError:
                    yield {"_garbled": True}
        except (ConnectionError, TimeoutError, OSError):
            with self._lock:
                self.connect_errors += 1
            raise
        finally:
            conn.close()


class RemoteTimeline:
    """The pulled twin of ``obs.timeline.DispatchTimeline``: holds the
    agent's timeline as the obs-puller lands it, presenting the two
    methods the gateway reads — ``take_new`` (the replica thread's
    trace attacher drains pulled records exactly like a local ring)
    and ``summary`` (the agent's LIFETIME per-kind aggregates,
    relayed verbatim so ``/stats`` dispatch blocks and the
    ``DispatchTimeline.merge`` fleet rollup cannot tell local from
    remote). Sequence numbers are LOCAL (assigned at push): the
    agent's own seq space restarts when the agent does, and the
    consumer-side cursor must never rewind."""

    def __init__(self, pending_capacity: int = 4096):
        self._lock = threading.Lock()
        # BOUNDED like the local ring: the consumer (the replica
        # thread's trace attacher) never drains when gateway tracing
        # is off (--trace-capacity 0) or while the replica is parked
        # broken, and an unbounded pending queue would turn the obs
        # puller into a slow memory leak. Overflow drops the OLDEST
        # records — lost debug spans, never lost memory.
        self._pending: deque = deque(maxlen=max(1, pending_capacity))
        self._summary: dict = {}
        self._seq = 0

    def push(self, records: list, summary: dict) -> None:
        """Obs-puller entry: append offset-corrected records, adopt
        the newest lifetime summary."""
        with self._lock:
            for rec in records:
                self._seq += 1
                rec.seq = self._seq
                self._pending.append(rec)
            if summary:
                self._summary = summary

    def take_new(self, cursor: int) -> tuple[list, int]:
        with self._lock:
            new = [r for r in self._pending if r.seq > cursor]
            self._pending.clear()
            return new, self._seq

    def summary(self) -> dict:
        with self._lock:
            return dict(self._summary)


class _RemoteTicket:
    """One in-flight request's stub-side record: the absolute token
    sequence received so far plus the terminal result doc.

    ``confirmed`` = the agent's submit response has been read. In mux
    mode tickets register BEFORE the submit POST (the channel can race
    a fast engine and deliver frames before the POST returns — they
    must find the ticket), so an agent-side ``gone`` frame is only
    believed for confirmed tickets: before confirmation it just means
    the channel's resume raced our in-flight submit."""

    __slots__ = ("id", "epoch", "tokens", "result", "confirmed")

    def __init__(self, request_id, epoch: int, confirmed: bool = True):
        self.id = request_id
        self.epoch = epoch
        self.tokens: list[int] = []
        self.result: dict | None = None
        self.confirmed = confirmed


class _RemoteSlots:
    """The ``server.slots`` view the ``_Replica`` scheduler reads:
    slot occupancy mirrors the agent's batch, tracked stub-side as
    in-flight tickets (the stub never over-admits past it)."""

    def __init__(self, remote: "RemoteServer", batch_size: int):
        self._remote = remote
        self.batch_size = batch_size

    @property
    def n_active(self) -> int:
        return len(self._remote._tickets)

    def free_slots(self) -> list[int]:
        return list(range(max(0, self.batch_size - self.n_active)))


class RemoteServer:
    """The ``serve.Server``-shaped stub over one replica agent. See
    the module docstring; the ``_Replica`` scheduler drives this
    exactly like a local engine."""

    # surface parity with serve.Server attributes the gateway reads
    fault_plan = None  # engine faults live on the AGENT's engine

    # the obs channel's path — an attribute so tests (and an operator
    # against an older agent) can point it at nothing and watch
    # the degrade-to-staleness contract instead of a failure
    _OBS_PATH = "/v1/obs"

    def __init__(self, address: str, *, heartbeat_interval_s: float = 1.0,
                 lease_misses: int = 5, connect_timeout_s: float = 2.0,
                 read_timeout_s: float = 5.0, boot_timeout_s: float = 60.0,
                 stall_timeout_s: float = 30.0, obs_pull: bool = True,
                 agent_channel: str = "mux", migrate_delta: bool = True,
                 transport_faults=None, agent_proc=None):
        if agent_channel not in ("mux", "per-ticket"):
            raise ValueError(f"agent_channel must be 'mux' or "
                             f"'per-ticket', got {agent_channel!r}")
        self.transport = AgentTransport(
            address, connect_timeout_s=connect_timeout_s,
            read_timeout_s=read_timeout_s, fault_plan=transport_faults)
        self.transport_faults = transport_faults
        self.host_addr = address
        # "mux" (default) carries every ticket's stream +
        # the obs batches over ONE long-lived /v1/channel connection
        # demuxed by a single thread; "per-ticket" is the original
        # one-connection-one-thread-per-stream path, kept for A/B
        self.agent_channel = agent_channel
        self._channel_thread: threading.Thread | None = None
        self.heartbeat_interval_s = max(0.05, heartbeat_interval_s)
        self.lease_misses = max(1, lease_misses)
        self.stall_timeout_s = stall_timeout_s
        self.agent_proc = agent_proc  # a subprocess we launched (owned)
        self.epoch = 0
        self._tickets: dict = {}
        self._cond = threading.Condition()
        self._progress = False
        self._dead: str | None = None
        self._closed = False
        self._on_dead = None
        self._monitor = None
        self._lease_paused = False  # recovery masks expiries
        self._hb_thread: threading.Thread | None = None
        # transport observability
        self._stats_lock = threading.Lock()
        self.reconnects = 0
        self.stale_epoch_drops = 0
        self.lease_expiries = 0
        self.heartbeat_failures = 0
        self.garbled_frames = 0  # corrupt NDJSON frames survived
        # prefix-delta wire migration: trim migrate docs
        # against the agent's heartbeat radix summary; a StaleDelta
        # refusal re-ships the full payload once
        self.migrate_delta = bool(migrate_delta)
        self.migrate_delta_trims = 0      # docs shipped suffix-only
        self.migrate_delta_fallbacks = 0  # stale summary -> full re-ship
        self._rtt_ms = 0.0  # EMA over heartbeat round trips
        self._last_hb = time.monotonic()
        # fleet observability: the pulled timeline/ledger +
        # the clock-offset model. offset = agent monotonic - gateway
        # monotonic, EWMA'd over heartbeat RTT midpoints; uncertainty
        # is the EWMA'd half-RTT — the honest error bar every grafted
        # span carries.
        self.timeline = RemoteTimeline()
        # _obs_enabled is the configuration (what obs_stats reports);
        # _obs_pull is the live gate (tests freeze it to compare the
        # two scrape surfaces against one immutable pulled state)
        self._obs_enabled = bool(obs_pull)
        self._obs_pull = bool(obs_pull)
        self._obs_cursor = 0
        # agent seqs landed via stream terminal lines (pruned to
        # > cursor at every successful pull): the dedup between the
        # two record paths — cursor pulls and per-request fragments
        self._obs_stream_seen: set[int] = set()
        self.obs_pulls = 0
        self.obs_pull_errors = 0
        self._last_obs: float | None = None
        self._obs_goodput: dict | None = None
        self._clock_off_ms = 0.0
        self._clock_unc_ms = 0.0
        self._clock_samples = 0
        info = self._wait_ready(boot_timeout_s)
        self.agent_id = info.get("agent_id", "?")
        self.model = SimpleNamespace(cfg=SimpleNamespace(
            max_seq_len=int(info["max_seq_len"])))
        self.slots = _RemoteSlots(self, int(info["batch_size"]))
        self.paged = bool(info.get("paged", False))
        self.speculate_k = int(info.get("speculate_k", 0))
        # the engine-summary probe reads ``prefix is not None``
        self.prefix = True if info.get("prefix") else None
        self._counters = dict(info.get("counters", {}))
        # the agent's bounded radix summary ([[n_tokens, crc32], ...]),
        # refreshed on every heartbeat — what prefix_match_len scores
        self._prefix_summary = list(info.get("prefix_summary") or [])

    # ------------------------------------------------------------ boot

    def _wait_ready(self, timeout_s: float) -> dict:
        deadline = time.monotonic() + timeout_s
        last: Exception | None = None
        while time.monotonic() < deadline:
            try:
                doc = self.transport.call("GET", "/healthz",
                                          epoch=self.epoch)
                if doc.get("ok"):
                    return doc
                last = RuntimeError(f"agent not ok: "
                                    f"{doc.get('failed') or 'draining'}")
            except (ConnectionError, TimeoutError, OSError,
                    AgentHTTPError) as e:
                last = e
            time.sleep(0.1)
        raise RuntimeError(
            f"replica agent at {self.host_addr} not ready after "
            f"{timeout_s:.0f}s: {type(last).__name__}: {last}")

    # ----------------------------------------------------- supervision

    def bind_supervisor(self, on_dead) -> None:
        """Called by ``_Replica``: arms the lease. ``on_dead(reason)``
        is the funnel into ``Gateway._fail_replica`` — fired (at most
        once per outage) when the agent misses a whole lease of
        heartbeats. Re-binding replaces the callback (the heartbeat
        machinery starts once)."""
        from tony_tpu_torch.coordinator.liveness import LivenessMonitor

        self._on_dead = on_dead
        if self._monitor is None:
            self._monitor = LivenessMonitor(
                interval_ms=max(1, int(self.heartbeat_interval_s * 1000)),
                max_missed=self.lease_misses,
                on_expired=self._lease_expired).start()
            self._monitor.register("agent")
            self._hb_thread = threading.Thread(
                target=self._hb_loop,
                name=f"agent-hb-{self.host_addr}", daemon=True)
            self._hb_thread.start()

    @property
    def lease_s(self) -> float:
        """The lease horizon (the LivenessMonitor expiry formula)."""
        return self.heartbeat_interval_s * max(3, self.lease_misses)

    def _hb_loop(self) -> None:
        while not self._closed:
            t0 = time.monotonic()
            reachable = False
            try:
                doc = self.transport.call(
                    "GET", "/healthz", epoch=self.epoch,
                    timeout=max(self.heartbeat_interval_s, 2.0))
                t1 = time.monotonic()
                reachable = True
                # clock-offset model: the agent read its monotonic
                # clock somewhere inside [t0, t1]; the midpoint is the
                # unbiased estimate and half the RTT bounds the error.
                # EWMA'd like the rtt so one jittery round trip cannot
                # whipsaw every span correction.
                agent_t = doc.get("t_mono")
                if isinstance(agent_t, (int, float)):
                    off_ms = (float(agent_t) - (t0 + t1) / 2.0) * 1e3
                    unc_ms = (t1 - t0) / 2.0 * 1e3
                    with self._stats_lock:
                        if self._clock_samples == 0:
                            self._clock_off_ms = off_ms
                            self._clock_unc_ms = unc_ms
                        else:
                            self._clock_off_ms = 0.8 * self._clock_off_ms \
                                + 0.2 * off_ms
                            self._clock_unc_ms = 0.8 * self._clock_unc_ms \
                                + 0.2 * unc_ms
                        self._clock_samples += 1
                busy = doc.get("n_active", 0) or doc.get("n_pending", 0)
                wedged = bool(busy) and \
                    doc.get("stepper_age_s", 0.0) > self.stall_timeout_s
                if doc.get("ok") and not wedged:
                    rtt_ms = (t1 - t0) * 1e3
                    with self._stats_lock:
                        self._rtt_ms = rtt_ms if self._rtt_ms == 0.0 \
                            else 0.8 * self._rtt_ms + 0.2 * rtt_ms
                        self._last_hb = time.monotonic()
                    counters = doc.get("counters")
                    if isinstance(counters, dict):
                        self._counters = counters
                    summary = doc.get("prefix_summary")
                    if isinstance(summary, list):
                        # atomic swap; readers never see a partial list
                        self._prefix_summary = summary
                    # register (not ping): also RESURRECTS the lease
                    # entry after an expiry once the agent is back
                    if self._monitor is not None:
                        self._monitor.register("agent")
                else:
                    # the agent process answered but its engine is
                    # failed/draining — or busy with a stepper that
                    # stopped beating (a WEDGED dispatch behind a
                    # healthy HTTP face): alive on the network, dead
                    # for serving — no lease ping, same as silence
                    with self._stats_lock:
                        self.heartbeat_failures += 1
            except (ConnectionError, TimeoutError, OSError,
                    AgentHTTPError, ValueError,
                    http.client.HTTPException):
                with self._stats_lock:
                    self.heartbeat_failures += 1
            if reachable and self._obs_pull:
                # the obs-puller rides the heartbeat cadence, but only
                # when the host just answered: an unreachable host
                # must cost ONE timeout per beat, not two. Pulled even
                # when the engine is failed/draining — a failing agent
                # is the one whose timeline an operator wants most.
                # Belt-and-braces except: ANY escape here would kill
                # the heartbeat thread and fail a healthy replica via
                # lease expiry — the exact inversion of the channel's
                # degrade-to-staleness contract.
                try:
                    self._pull_obs()
                except Exception:  # noqa: BLE001 — see above
                    log.exception("obs pull failed unexpectedly")
                    with self._stats_lock:
                        self.obs_pull_errors += 1
            left = self.heartbeat_interval_s - (time.monotonic() - t0)
            if left > 0:
                time.sleep(left)

    def _pull_obs(self) -> None:
        """One incremental observability pull (see the module
        docstring). ANY failure degrades to staleness — counted in
        ``pull_errors``, visible as a growing ``obs.lag_s`` — and
        never touches the lease or the dead marker: the obs channel
        must not be able to fail a serving replica."""
        try:
            # timeout bounded by the LEASE SLACK, not the read
            # timeout: the pull shares the heartbeat thread, and an
            # agent that answers /healthz promptly but stalls on
            # /v1/obs must not delay the next lease ping past the
            # horizon — a slow obs channel degrades to a failed pull,
            # never to a false lease expiry on a healthy replica
            doc = self.transport.call(
                "GET", f"{self._OBS_PATH}?cursor={self._obs_cursor}",
                epoch=self.epoch,
                timeout=max(0.1, min(max(self.heartbeat_interval_s,
                                         2.0), self.lease_s / 3.0)))
        except (ConnectionError, TimeoutError, OSError,
                AgentHTTPError, ValueError,
                http.client.HTTPException):
            # HTTPException too: a garbled response (BadStatusLine,
            # IncompleteRead mid-restart) is neither an OSError nor a
            # ValueError, and it must degrade like any other bad pull
            with self._stats_lock:
                self.obs_pull_errors += 1
            return
        self._ingest_obs_batch(doc)

    def _ingest_obs_batch(self, doc: dict) -> None:
        """Land one /v1/obs document — from the heartbeat-cadence GET
        or from an ``obs`` frame riding the multiplexed channel. The
        two producers dedup against each other by cursor/seq inside
        ``_ingest_obs_records``."""
        if not isinstance(doc, dict):
            return
        try:
            cursor = int(doc.get("cursor", self._obs_cursor))
        except (TypeError, ValueError):
            cursor = self._obs_cursor
        summary = doc.get("summary")
        self._ingest_obs_records(doc.get("records") or (),
                                 new_cursor=cursor,
                                 summary=summary
                                 if isinstance(summary, dict) else {})
        goodput = doc.get("goodput")
        with self._stats_lock:
            if isinstance(goodput, dict):
                self._obs_goodput = goodput
            self.obs_pulls += 1
            self._last_obs = time.monotonic()

    def _ingest_obs_records(self, docs, *, new_cursor: int | None = None,
                            summary: dict | None = None) -> None:
        """Convert wire record docs to gateway-clock ``DispatchRecord``s
        and land them in the ``RemoteTimeline``. Two producers feed
        this — the cursor pull (``new_cursor`` set) and a stream's
        terminal-line fragments (``new_cursor`` None) — deduplicated
        by AGENT sequence number: fragments remember their seqs in
        ``_obs_stream_seen`` until a pull's cursor passes them; pulls
        skip seqs a fragment already landed. An agent restart (cursor
        regression) resets the seq space."""
        with self._stats_lock:
            regressed = new_cursor is not None \
                and new_cursor < self._obs_cursor
            if regressed:
                # agent restarted: its seq space began again — and so,
                # possibly, did its CLOCK (a host reboot restarts
                # CLOCK_MONOTONIC): the offset EWMA re-seeds from the
                # next heartbeat (samples==0 assigns directly) instead
                # of blending a wildly stale correction 20% at a time.
                # This batch lands offset-0 (uncorrected); the trace
                # clamp keeps it well-formed.
                self._obs_stream_seen.clear()
                self._clock_off_ms = 0.0
                self._clock_unc_ms = 0.0
                self._clock_samples = 0
            off_s = self._clock_off_ms / 1e3
            off_ms = round(self._clock_off_ms, 3)
            unc_ms = round(self._clock_unc_ms, 3)
            records = []
            for rd in docs:
                try:
                    rec = record_from_doc(rd)
                except (TypeError, ValueError):
                    continue  # one malformed record must not drop all
                if rec.seq in self._obs_stream_seen:
                    continue  # pulled twin of a landed fragment
                if new_cursor is None:
                    if rec.seq <= self._obs_cursor:
                        continue  # the puller already landed it
                    self._obs_stream_seen.add(rec.seq)
                elif not regressed and rec.seq <= self._obs_cursor:
                    # TWO pull producers exist now (the heartbeat GET
                    # and the channel's obs frames): whichever lands a
                    # window second must not re-land its records
                    continue
                # agent monotonic -> gateway monotonic, with the
                # honest error bar stamped on the record (and thus on
                # any trace span grafted from it)
                rec.t0 -= off_s
                rec.tags.setdefault("host", self.host_addr)
                rec.tags["clock_offset_ms"] = off_ms
                rec.tags["clock_offset_unc_ms"] = unc_ms
                records.append(rec)
            if new_cursor is not None:
                self._obs_cursor = new_cursor
                self._obs_stream_seen = {
                    s for s in self._obs_stream_seen if s > new_cursor}
            elif len(self._obs_stream_seen) > 65536:
                # pulls failing for a long time (degraded channel)
                # must not grow the dedup set without bound: keep the
                # most recent window — worst case a long-dead seq
                # re-lands as a duplicate span in a debug trace
                self._obs_stream_seen = set(sorted(
                    self._obs_stream_seen)[-4096:])
        self.timeline.push(records, summary or {})

    def pause_lease(self) -> None:
        """Mask lease expiries — crash recovery's adopt calls can hold
        the ONE control connection for whole seconds (a freeze-for-
        adopt waits out the engine's current dispatch), starving the
        heartbeat GETs behind them; expiring the lease for that would
        fail over the very replica recovery is adopting from. Paused
        expiries re-arm the entry instead of firing the supervisor."""
        self._lease_paused = True

    def resume_lease(self) -> None:
        self._lease_paused = False
        if self._monitor is not None:
            self._monitor.register("agent")

    def _lease_expired(self, task_id: str) -> None:
        if getattr(self, "_lease_paused", False):
            log.info("agent %s lease lapsed during recovery — masked "
                     "(control connection busy with adopts)",
                     self.host_addr)
            if self._monitor is not None:
                self._monitor.register("agent")
            return
        reason = (f"agent {self.host_addr} lease expired: no heartbeat "
                  f"for {self.lease_s:.1f}s")
        with self._stats_lock:
            self.lease_expiries += 1
        self._note_dead(reason)

    def _note_dead(self, reason: str) -> None:
        """Mark the transport dead (``step``/``submit`` raise until the
        next ``reset``) and fire the supervisor funnel."""
        if self._closed:
            return
        with self._cond:
            if self._dead is None:
                self._dead = reason
            self._cond.notify_all()
        cb = self._on_dead
        if cb is not None:
            try:
                cb(reason)
            except Exception:
                log.exception("remote supervisor callback failed")

    # ------------------------------------------------- engine surface

    @property
    def n_pending(self) -> int:
        return 0  # admission maps 1:1 onto agent slots (no stub queue)

    @property
    def n_active(self) -> int:
        return len(self._tickets)

    @property
    def done(self) -> bool:
        return not self._tickets

    def submit(self, request: Request):
        if self._dead:
            raise ConnectionError(self._dead)
        doc = {
            "id": request.id, "prompt": list(request.prompt),
            "max_new_tokens": request.max_new_tokens,
            "temperature": request.temperature, "top_k": request.top_k,
            "seed": request.seed, "epoch": self.epoch,
        }
        # the GATEWAY request id, distinct from the
        # per-replica engine id above: the agent parks orphaned
        # sessions under it, so a RESTARTED gateway — which only
        # remembers its own journal's ids — can adopt them back
        rid = getattr(request, "rid", None)
        if rid is not None:
            doc["rid"] = rid
        path = "/v1/submit"
        if request.prefill_only:
            doc["prefill_only"] = True
        if request.handoff is not None:
            # the decode pool's remote intake: ship the page payload
            # base64-leaf-encoded (a pure-router gateway holds it in
            # wire form already; a local prefill replica's device
            # pytree is encoded here) — the agent's engine scatters it
            # into its own pool and the round trip is bitwise
            from tony_tpu_torch.serve.tier import encode_array, encode_payload

            ho = request.handoff
            if "page_ids" in ho:
                # an owner-swap payload (shared-pool page ids) routed
                # off-host after all: gather the content — consuming
                # the transfer ref — and rewrite the dict IN PLACE
                # (ticket and request alias it, so a requeue ships the
                # gathered copy, never dangling ids)
                from tony_tpu_torch.serve.migrate import gather_local

                ho["pages"] = encode_payload(
                    gather_local(ho.pop("pool"), ho.pop("page_ids")))
                if not isinstance(ho["logits"], dict):
                    ho["logits"] = encode_array(ho["logits"])
            pages = ho["pages"]
            logits = ho["logits"]
            doc["handoff"] = {
                "n_tokens": int(ho["n_tokens"]),
                "pages": encode_payload(pages),
                "logits": logits if isinstance(logits, dict)
                else encode_array(logits),
            }
            path = "/v1/handoff"
        mig_full = None
        if request.migrate is not None:
            # live migration intake: a frozen session rides
            # /v1/submit's contract to /v1/migrate_in. A LOCAL snapshot
            # (owner-swap page ids) is gathered to wire form first —
            # mutated in place for the same requeue-safety reason as
            # the handoff above: the transfer ref is consumed exactly
            # once, and retries re-ship the encoded content.
            from tony_tpu_torch.serve.migrate import SessionSnapshot, \
                delta_trim_doc, gather_local, snapshot_to_doc
            from tony_tpu_torch.serve.tier import encode_payload

            mig = request.migrate
            if isinstance(mig, SessionSnapshot):
                if mig.local:
                    pool, ids = mig.pool, mig.pages
                    mig.pages = encode_payload(gather_local(pool, ids))
                    mig.local = False
                    mig.pool = None
                mig_full = snapshot_to_doc(mig)
            else:
                mig_full = mig  # already wire form (remote hop)
            # prefix-delta trim: when the agent's heartbeat
            # radix summary says it already holds a prefix of this
            # session's context, ship only the uncovered suffix pages.
            # Advisory — a stale summary comes back kind=StaleDelta
            # and the full doc re-ships below.
            trimmed = delta_trim_doc(mig_full, self._prefix_summary) \
                if self.migrate_delta else None
            if trimmed is not None:
                with self._stats_lock:
                    self.migrate_delta_trims += 1
            doc["migrate"] = trimmed if trimmed is not None \
                else mig_full
            path = "/v1/migrate_in"
        # Mux mode pre-registers the ticket: a warm engine can finish
        # the request and the channel deliver every frame BEFORE this
        # submit POST returns — the demux must find the ticket or the
        # result is dropped on the floor. The ticket stays unconfirmed
        # until the response lands so a racing ``gone`` frame (the
        # channel resumed before the agent saw the submit) is ignored.
        pre = self.agent_channel == "mux" and request.id is not None
        if pre:
            with self._cond:
                ticket = _RemoteTicket(request.id, self.epoch,
                                       confirmed=False)
                self._tickets[request.id] = ticket
                self._cond.notify_all()  # wake a parked channel loop
            self._ensure_channel()
        try:
            try:
                resp = self.transport.call("POST", path, doc,
                                           epoch=self.epoch,
                                           request=request.id)
            except AgentHTTPError as e:
                # stale-summary fallback: the adopter no
                # longer holds the prefix the trim assumed — re-ship
                # the FULL payload once. Correctness never rests on
                # summary freshness; only the wire-byte win does.
                if e.doc.get("kind", "") != "StaleDelta" \
                        or mig_full is None \
                        or doc.get("migrate") is mig_full:
                    raise
                with self._stats_lock:
                    self.migrate_delta_fallbacks += 1
                doc["migrate"] = mig_full
                resp = self.transport.call("POST", path, doc,
                                           epoch=self.epoch,
                                           request=request.id)
        except AgentHTTPError as e:
            if pre:
                self._unregister(request.id)
            kind = e.doc.get("kind", "")
            if kind == "StaleDelta":
                # a full payload refused as stale is an agent bug —
                # surface it as the invalid-request it claims to be
                raise ValueError(e.doc.get("error", str(e))) from None
            if kind == "QueueFull":
                raise QueueFull(e.doc.get("error", str(e))) from None
            if kind == "PoolExhausted":
                raise PoolExhausted(e.doc.get("error", str(e))) from None
            if e.status == 400 or kind == "ValueError":
                raise ValueError(e.doc.get("error", str(e))) from None
            if e.status == 409:
                with self._stats_lock:
                    self.stale_epoch_drops += 1
            # 409 stale epoch / 503 draining-or-failed: this replica
            # cannot take work right now — surface as a transport
            # failure so the scheduler's failover path owns it
            raise ConnectionError(str(e)) from e
        except Exception:
            if pre:
                self._unregister(request.id)
            raise
        rid = resp.get("id", request.id)
        with self._cond:
            ticket = self._tickets.get(rid) if pre and rid == request.id \
                else None
            if ticket is None or ticket.epoch != self.epoch:
                ticket = _RemoteTicket(rid, self.epoch)
                self._tickets[rid] = ticket
            ticket.confirmed = True
            self._cond.notify_all()  # wake a parked channel loop
        if self.agent_channel == "mux":
            # the multiplexed channel: one demux loop carries every
            # ticket — the agent discovers new tickets automatically,
            # so a submit is just bookkeeping plus (once) the thread
            self._ensure_channel()
        else:
            threading.Thread(target=self._read_stream, args=(ticket,),
                             name=f"agent-stream-{self.host_addr}",
                             daemon=True).start()
        return rid

    def _unregister(self, rid) -> None:
        """Drop a pre-registered ticket whose submit never landed (the
        POST failed) — unless frames already carried a result to it."""
        with self._cond:
            t = self._tickets.get(rid)
            if t is not None and t.result is None and not t.confirmed:
                del self._tickets[rid]

    def extract_session(self, request_id, *, wire: bool = True):
        """Freeze one live session OUT of the agent: POST
        /v1/migrate_out returns the wire snapshot of the request's
        decode slot, or ``None`` when the agent holds no live slot for
        the id (finished, still pending, mid-prefill — nothing worth
        moving). Remote snapshots are always wire form; ``wire`` is
        accepted for surface parity with ``serve.Server`` and ignored.

        While the call is in flight the stub ticket is marked
        unconfirmed, so a ``gone`` frame racing on the mux channel
        (the agent drops its ticket the moment the freeze lands) is
        not read as an agent restart. On success the ticket leaves
        with the session — its stream continues from the adopting
        replica at the absolute offset the gateway already holds; on
        anything else it is restored and the stream resumes here."""
        from tony_tpu_torch.serve.migrate import snapshot_from_doc

        if self._dead:
            raise ConnectionError(self._dead)
        with self._cond:
            ticket = self._tickets.get(request_id)
            was_confirmed = True if ticket is None else ticket.confirmed
            if ticket is not None:
                ticket.confirmed = False
        try:
            resp = self.transport.call(
                "POST", "/v1/migrate_out",
                {"id": request_id, "epoch": self.epoch},
                epoch=self.epoch, request=request_id,
                timeout=max(self.transport.read_timeout_s, 30.0))
        except AgentHTTPError as e:
            self._unfreeze(request_id, was_confirmed)
            if e.status == 409:
                with self._stats_lock:
                    self.stale_epoch_drops += 1
            raise ConnectionError(str(e)) from e
        except Exception:
            self._unfreeze(request_id, was_confirmed)
            raise
        if not resp.get("found"):
            self._unfreeze(request_id, was_confirmed)
            return None
        with self._cond:
            self._tickets.pop(request_id, None)
            self._cond.notify_all()
        return snapshot_from_doc(resp["snapshot"])

    def _unfreeze(self, rid, confirmed: bool) -> None:
        """Undo ``extract_session``'s gone-frame suppression when the
        session did NOT leave: the ticket stays live here."""
        with self._cond:
            t = self._tickets.get(rid)
            if t is not None:
                t.confirmed = confirmed
                self._cond.notify_all()

    # ------------------------------------- restart recovery

    def list_parked(self) -> list:
        """GET /v1/parked: the sessions this agent would hand a
        (re)connecting gateway — parked orphan snapshots plus
        finished-but-undelivered results. Read-only, no epoch fence."""
        resp = self.transport.call("GET", "/v1/parked", None,
                                   epoch=self.epoch)
        return list(resp.get("parked") or [])

    def adopt_parked(self, rid):
        """POST /v1/adopt: take one parked session back by GATEWAY
        request id. Returns the raw response doc — ``snapshot`` (wire
        form, feed it to a requeue as ``request.migrate``) or
        ``finished`` + ``result`` — or None on 404 (unknown/reaped:
        the caller re-runs from the prompt). 409 (a second adopter on
        a stale epoch) raises ConnectionError like every other fenced
        call."""
        try:
            resp = self.transport.call(
                "POST", "/v1/adopt", {"id": rid, "epoch": self.epoch},
                epoch=self.epoch, request=rid,
                timeout=max(self.transport.read_timeout_s, 30.0))
        except AgentHTTPError as e:
            if e.status == 404:
                return None
            if e.status == 409:
                with self._stats_lock:
                    self.stale_epoch_drops += 1
            raise ConnectionError(str(e)) from e
        return resp if resp.get("found") else None

    def sync_recovery_epoch(self) -> int:
        """Fence out the PREVIOUS gateway incarnation: read the
        agent's current epoch off /healthz and adopt one past it, so
        our first fenced call bumps the agent forward and any stale
        stream line (or a second recovering gateway racing us on the
        old epoch) is refused by the ordinary epoch-fence and lease machinery. A
        recovering gateway must NOT ``reset()`` — that would wipe the
        very tickets and parked sessions it came back for."""
        hz = self.transport.call("GET", "/healthz", None)
        self.epoch = max(self.epoch, int(hz.get("epoch", 0)) + 1)
        return self.epoch

    def _ensure_channel(self) -> None:
        with self._stats_lock:
            if self._channel_thread is not None:
                return
            self._channel_thread = threading.Thread(
                target=self._channel_loop,
                name=f"agent-channel-{self.host_addr}", daemon=True)
        self._channel_thread.start()

    def step(self) -> list:
        """One scheduler beat: wait briefly for stream progress, then
        hand back any finished results. Raises when the transport has
        been declared dead — the scheduler's exception route."""
        with self._cond:
            if self._dead:
                raise ConnectionError(self._dead)
            ready = [t for t in self._tickets.values()
                     if t.result is not None]
            if not ready and not self._progress:
                self._cond.wait(timeout=0.05)
                if self._dead:
                    raise ConnectionError(self._dead)
                ready = [t for t in self._tickets.values()
                         if t.result is not None]
            self._progress = False
            for t in ready:
                del self._tickets[t.id]
        return [result_from_doc(t.result) for t in ready]

    def live_progress(self, since: dict | None = None) -> dict:
        with self._cond:
            out = {}
            for t in self._tickets.values():
                start = since.get(t.id, 0) if since else 0
                out[t.id] = t.tokens[start:]
            return out

    def counters(self) -> dict:
        return dict(self._counters)

    def prefix_match_len(self, tokens) -> int:
        """The router's affinity probe, remote flavor:
        scored against the radix summary the agent ships on every
        heartbeat — the same grain-grid ``[[n_tokens, crc32], ...]``
        convention the device store and host tier publish, so a
        REMOTE replica holding the prompt's prefix can win routing
        over a cold local one. Staleness is bounded by the heartbeat
        interval; a stale hit costs one suboptimal preference, never
        correctness (the engine re-probes its own store on admit)."""
        return summary_match_len(self._prefix_summary, tokens)

    def goodput(self):
        """The agent engine's goodput ledger, as of the last obs pull
        (None until one lands — an UNOBSERVED replica, distinct from
        an idle one). A copy: ``goodput_report`` annotates rows in
        place and must not mutate the pulled snapshot."""
        with self._stats_lock:
            g = self._obs_goodput
        return dict(g) if g is not None else None

    def reset(self) -> None:
        """The breaker's recovery step, remote flavor: bump the epoch
        (fencing off every outstanding stream and any late agent
        output), drop local tickets, clear the dead marker so probes
        can try again, and hard-reset the AGENT's engine under the new
        epoch (ghost requests on a wedged-then-revived host die
        here). Raises when the agent is unreachable — the recovery
        loop logs and laps."""
        with self._cond:
            self.epoch += 1
            epoch = self.epoch
            self._tickets.clear()
            self._dead = None
            self._progress = False
            self._cond.notify_all()
        try:
            self.transport.call("POST", "/v1/reset", {"epoch": epoch},
                                epoch=epoch, timeout=10.0)
        except (ConnectionError, TimeoutError, OSError) as e:
            raise ConnectionError(
                f"agent {self.host_addr} reset failed: {e}") from e
        except AgentHTTPError as e:
            raise ConnectionError(str(e)) from e

    # -------------------------------------------------- stream reader

    def _channel_loop(self) -> None:
        """The multiplexed channel's ONE demux thread: a
        long-lived POST /v1/channel connection carries every ticket's
        stream as tagged frames plus the incremental obs batches; this
        loop places token windows by absolute offset, lands results,
        and on ANY disconnect reconnects with the full resume map —
        every in-flight stream re-established at its offset in one
        round trip. A garbled frame degrades (counted, resynced via
        reconnect — absolute offsets make the resume exact), never
        kills the loop. Parks while the replica is marked dead; the
        breaker's reset() revives it under the bumped epoch."""
        attempt = 0
        while not self._closed:
            with self._cond:
                if self._dead is not None:
                    self._cond.wait(timeout=0.25)
                    continue
                epoch = self.epoch
                resume = [[t.id, len(t.tokens)]
                          for t in self._tickets.values()
                          if t.result is None and t.epoch == epoch]
            body = {"epoch": epoch, "streams": resume}
            if self._obs_enabled:
                with self._stats_lock:
                    body["obs_cursor"] = self._obs_cursor
            # ``resync``: the channel ended deliberately (stale epoch,
            # garbled frame, gap) — reconnect immediately, without the
            # disconnect counter or backoff a NETWORK failure gets
            resync = False
            try:
                for doc in self.transport.stream_lines(
                        "/v1/channel", epoch=epoch, method="POST",
                        doc=body):
                    if self._closed:
                        return
                    if doc.get("_garbled"):
                        with self._stats_lock:
                            self.garbled_frames += 1
                        resync = True
                        break
                    if doc.get("stale") or doc.get("epoch") != epoch:
                        # the fence: the agent (or we) moved on — drop
                        # the channel, reconnect under the current epoch
                        with self._stats_lock:
                            self.stale_epoch_drops += 1
                        resync = True
                        break
                    if doc.get("keepalive") or doc.get("channel"):
                        attempt = 0
                        continue
                    try:
                        if "obs" in doc and "rid" not in doc:
                            # the obs pull, riding the channel
                            if self._obs_pull:
                                self._ingest_obs_batch(doc["obs"])
                            attempt = 0
                            continue
                        if "error" in doc and "rid" not in doc:
                            # the agent's ENGINE failed: same funnel
                            # as a dead dispatch
                            self._note_dead(
                                f"agent {self.host_addr} reported: "
                                f"{doc['error']}")
                            break
                        rid = doc.get("rid")
                        with self._cond:
                            ticket = self._tickets.get(rid)
                        if ticket is None or ticket.epoch != epoch:
                            continue  # collected, or a late frame
                        if doc.get("gone"):
                            if not ticket.confirmed:
                                # channel resume raced an in-flight
                                # submit: the agent hasn't seen the
                                # ticket *yet* — its discovery loop
                                # picks it up once the POST lands
                                continue
                            # the agent no longer knows an in-flight
                            # ticket: it restarted (state gone) —
                            # everything it held must fail over
                            self._note_dead(
                                f"agent {self.host_addr} lost request "
                                f"{rid!r} (agent restart?)")
                            break
                        if "token_ids" in doc:
                            self._place(ticket, int(doc["off"]),
                                        [int(x) for x in
                                         doc["token_ids"]])
                            attempt = 0
                        if doc.get("done"):
                            obs = doc.get("obs")
                            if obs and self._obs_enabled:
                                self._ingest_obs_records(obs)
                            with self._cond:
                                if ticket.epoch == self.epoch:
                                    ticket.result = doc["result"]
                                    self._progress = True
                                    self._cond.notify_all()
                    except Exception as e:
                        # ANY malformed frame — a gap RuntimeError
                        # from _place (a garbled frame HID a window),
                        # a done frame missing its result, an obs
                        # batch that fails to parse — degrades: count
                        # it and resync-reconnect (absolute offsets
                        # make the resume exact). The demux thread
                        # must never die to one bad frame.
                        log.warning("agent %s channel frame rejected "
                                    "(%r) — resyncing",
                                    self.host_addr, e)
                        with self._stats_lock:
                            self.garbled_frames += 1
                        resync = True
                        break
                # EOF without a terminal frame: mid-stream disconnect
            except AgentHTTPError as e:
                if e.status == 409:
                    with self._stats_lock:
                        self.stale_epoch_drops += 1
                    resync = True  # re-open under the adopted epoch
                else:
                    log.warning("agent %s channel error: %s",
                                self.host_addr, e)
            except (ConnectionError, TimeoutError, OSError) as e:
                log.debug("agent %s channel disconnect: %r",
                          self.host_addr, e)
            if self._closed:
                return
            if resync:
                time.sleep(0.01)  # bounds a pathological 409 spin
            else:
                with self._stats_lock:
                    self.reconnects += 1
                time.sleep(self.transport._backoff(attempt))
                attempt = min(attempt + 1, 8)

    def _read_stream(self, ticket: _RemoteTicket) -> None:
        """One in-flight request's reader: follow the agent's NDJSON
        stream, placing token windows by ABSOLUTE offset; on any
        disconnect, resume at the offset already held (reconnect, not
        failover) with capped backoff — until the ticket finishes, the
        epoch moves on, or the replica is declared dead."""
        attempt = 0
        while True:
            with self._cond:
                if (self._closed or self._dead is not None
                        or ticket.result is not None
                        or ticket.epoch != self.epoch
                        or self._tickets.get(ticket.id) is not ticket):
                    return
                offset = len(ticket.tokens)
            path = (f"/v1/stream/{ticket.id}?offset={offset}"
                    f"&epoch={ticket.epoch}")
            try:
                for doc in self.transport.stream_lines(
                        path, epoch=ticket.epoch, request=ticket.id):
                    if doc.get("_garbled"):
                        # corrupt frame: count it and resync by
                        # reconnecting at the offset already held
                        with self._stats_lock:
                            self.garbled_frames += 1
                        break
                    if doc.get("epoch") != ticket.epoch:
                        # a revived host talking from another epoch:
                        # the fence — count and drop the whole stream
                        with self._stats_lock:
                            self.stale_epoch_drops += 1
                        return
                    if doc.get("keepalive"):
                        continue
                    if doc.get("stale"):
                        with self._stats_lock:
                            self.stale_epoch_drops += 1
                        return
                    if "error" in doc:
                        # the agent's ENGINE failed under our request:
                        # same funnel as a dead dispatch
                        self._note_dead(
                            f"agent {self.host_addr} reported: "
                            f"{doc['error']}")
                        return
                    if "token_ids" in doc:
                        self._place(ticket, int(doc["offset"]),
                                    [int(x) for x in doc["token_ids"]])
                        attempt = 0  # progress resets the backoff
                    if doc.get("done"):
                        # the terminal line's per-request dispatch
                        # fragments land BEFORE the result becomes
                        # visible: the scheduler iteration that
                        # delivers this request grafts them first, so
                        # even a shorter-than-one-heartbeat request
                        # finishes with its complete span set
                        obs = doc.get("obs")
                        if obs and self._obs_enabled:
                            self._ingest_obs_records(obs)
                        with self._cond:
                            if ticket.epoch == self.epoch:
                                ticket.result = doc["result"]
                                self._progress = True
                                self._cond.notify_all()
                        return
                # EOF without a terminal line: mid-stream disconnect
            except AgentHTTPError as e:
                if e.status == 409:
                    with self._stats_lock:
                        self.stale_epoch_drops += 1
                    return
                if e.status == 404:
                    # the agent no longer knows this ticket: it
                    # restarted (state gone) — everything it held must
                    # fail over
                    self._note_dead(
                        f"agent {self.host_addr} lost request "
                        f"{ticket.id!r} (agent restart?)")
                    return
                log.warning("agent %s stream error: %s",
                            self.host_addr, e)
            except (ConnectionError, TimeoutError, OSError) as e:
                log.debug("agent %s stream disconnect for %r: %r",
                          self.host_addr, ticket.id, e)
            with self._stats_lock:
                self.reconnects += 1
            time.sleep(self.transport._backoff(attempt))
            attempt = min(attempt + 1, 8)

    def _place(self, ticket: _RemoteTicket, offset: int,
               tokens: list) -> None:
        """Append the absolute window [offset, offset+len) — overlap
        with what we already hold is dropped (resumes may re-send),
        and a gap (can't happen with an honest agent) fails loudly
        rather than corrupting the stream."""
        with self._cond:
            have = len(ticket.tokens)
            if offset > have:
                raise RuntimeError(
                    f"stream gap for {ticket.id!r}: offset {offset} "
                    f"past {have} tokens held")
            new = tokens[have - offset:]
            if new:
                ticket.tokens.extend(new)
                self._progress = True
                self._cond.notify_all()

    # --------------------------------------------------- observability

    def transport_stats(self) -> dict:
        """The per-replica ``transport`` block (/stats, /metrics):
        where the time goes between this gateway and that host."""
        with self._stats_lock:
            return {
                "address": self.host_addr,
                "agent_id": self.agent_id,
                "rtt_ms": round(self._rtt_ms, 3),
                "heartbeat_age_s": round(
                    time.monotonic() - self._last_hb, 3),
                "lease_s": round(self.lease_s, 3),
                # which stream carrier this stub runs ("mux" = one
                # multiplexed /v1/channel connection; "per-ticket" =
                # the A/B control) and the demux loop's resilience
                # counter — a non-zero garbled_frames with healthy
                # streams IS the degrade-don't-die contract working
                "channel": self.agent_channel,
                "garbled_frames": self.garbled_frames,
                "reconnects": self.reconnects,
                "retries": self.transport.retries,
                "connect_errors": self.transport.connect_errors,
                "heartbeat_failures": self.heartbeat_failures,
                "stale_epoch_drops": self.stale_epoch_drops,
                "lease_expiries": self.lease_expiries,
                # prefix-delta wire migration
                "migrate_delta_trims": self.migrate_delta_trims,
                "migrate_delta_fallbacks": self.migrate_delta_fallbacks,
                # the clock-offset model: what remote span
                # timestamps were corrected by, and how far off that
                # correction could honestly be
                "clock_offset_ms": round(self._clock_off_ms, 3),
                "clock_offset_unc_ms": round(self._clock_unc_ms, 3),
            }

    def obs_stats(self) -> dict:
        """The per-replica ``obs`` block: the pull channel's health —
        an explicit surface, so a dashboard can tell an IDLE remote
        replica (fresh lag, zero counts) from an UNOBSERVED one
        (growing lag / pull errors / ``lag_s: null`` never pulled)."""
        with self._stats_lock:
            return {
                "enabled": self._obs_enabled,
                "cursor": self._obs_cursor,
                "pulls": self.obs_pulls,
                "pull_errors": self.obs_pull_errors,
                "lag_s": round(time.monotonic() - self._last_obs, 3)
                if self._last_obs is not None else None,
            }

    # ------------------------------------------------------- shutdown

    def close(self, drain_agent: bool | None = None,
              timeout_s: float = 10.0) -> None:
        """Stop the lease/heartbeat machinery and the readers. With
        ``drain_agent`` (default: only for agents this stub LAUNCHED)
        also politely drain the agent and stop its process — the
        scale-down/deprovision path; attached agents are left running
        (they belong to whoever started them)."""
        if self._closed:
            return
        self._closed = True
        if self._monitor is not None:
            self._monitor.stop()
        with self._cond:
            self._cond.notify_all()
        own = self.agent_proc is not None
        if drain_agent is None:
            drain_agent = own
        if drain_agent:
            try:
                self.transport.call("POST", "/v1/drain",
                                    {"timeout_s": timeout_s},
                                    epoch=self.epoch,
                                    timeout=timeout_s + 5.0)
            except (ConnectionError, TimeoutError, OSError,
                    AgentHTTPError) as e:
                log.debug("agent %s drain on close failed: %r",
                          self.host_addr, e)
        if own:
            proc = self.agent_proc
            proc.terminate()
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                proc.kill()
        self.transport.close()  # drop the persistent control conn


def launch_local_agent(agent_args: list[str], *, port_file: str,
                       env: dict | None = None,
                       boot_timeout_s: float = 120.0):
    """Launch ``python -m tony_tpu_torch.cli.replica`` as a local subprocess
    and wait for its bound address. The localhost member of the
    launcher family (coordinator/launcher.py): the provisioned-host
    story runs the same CLI via the slice's own channel; a
    StaticProvisioner's localhost "hosts" and the smoke/chaos rounds
    run it here. Returns ``(proc, "host:port")``; the caller owns the
    process (hand it to ``RemoteServer(agent_proc=...)`` so close()
    reaps it)."""
    import os

    cmd = [sys.executable, "-m", "tony_tpu_torch.cli.replica",
           *agent_args, "--port-file", port_file]
    proc = subprocess.Popen(cmd, env=env)
    deadline = time.monotonic() + boot_timeout_s
    while time.monotonic() < deadline:
        if proc.poll() is not None:
            raise RuntimeError(
                f"replica agent exited {proc.returncode} before "
                f"binding (cmd: {' '.join(cmd)})")
        if os.path.exists(port_file):
            with open(port_file) as f:
                parts = f.read().split()
            if len(parts) == 2:
                return proc, f"{parts[0]}:{parts[1]}"
        time.sleep(0.1)
    proc.terminate()
    raise RuntimeError(f"replica agent did not bind within "
                       f"{boot_timeout_s:.0f}s")
