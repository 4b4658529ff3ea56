"""Multi-replica serving front door: admission, deadlines, routing, drain.

The PyTorch port's copy of ``tony_tpu/gateway/core.py``, in front of
the port's ``serve.Server`` (in-process replicas, each stepped by its
own thread) and of ``gateway.remote.RemoteServer`` stubs over replica
agents (``serve/agent.py``). Several in-process replicas share the card
under the rule ``models.graphs.DEVICE`` states (a replica's step holds
it shared, a CUDA-graph capture exclusively). The ``/stats`` host block
reads the memory that torch's allocator holds on the card.

The layer above ``tony_tpu_torch.serve``: the ``Server`` multiplexes many
requests onto ONE resident KV cache; this module multiplexes many
CLIENTS onto N such servers (data-parallel replicas, one scheduler
thread each — the serving analog of TonY's coordinator packing a fleet
of role tasks onto a container pool). The pieces, front to back:

- ``Gateway.submit()`` is the ADMISSION gate: a bounded queue (past
  ``max_queue`` waiting requests it sheds with ``GatewayQueueFull`` ->
  HTTP 429) with a per-request deadline (``ttl_s``); requests whose
  deadline passes while they wait are shed with ``DeadlineExceeded``
  (-> 504) BEFORE they ever occupy a cache slot — a dead client's
  request must not spend decode steps nobody will read.
- Routing picks the replica with the LEAST OUTSTANDING TOKENS
  (queued + in-flight prompt+budget estimate — queue-length routing
  would park a burst of 512-token requests behind one another while a
  replica full of 8-token requests sits idle). A ``session`` key opts
  into affinity (hash -> replica), keeping a conversation's requests
  on one replica.
- Each ``_Replica`` owns a ``serve.Server`` and drives it on its own
  thread: admit from its queue (deadline-checked at the moment a slot
  is actually free), ``step()``, stream per-token deltas to tickets,
  deliver results. The engine's lock-protected ``submit()`` plus this
  single-owner step loop is the whole concurrency story — no lock is
  ever held across a device dispatch.
- ``drain()`` is the SIGTERM story: close the front door (new submits
  shed with ``GatewayClosed`` -> 503), let every replica finish its
  queue and in-flight slots, then join the threads — zero accepted
  requests lost.
- Every finished request records queue-wait / TTFT / TPOT / tokens
  in+out: into the rolling ``/stats`` window (p50/p99), into lifetime
  fixed-bucket histograms (the ``/metrics`` exposition), into a
  ``metrics.MetricsStore`` under ``gateway:replica-<i>`` (the
  coordinator-side sink TaskMetricsMonitor pushes to), and optionally
  into a portal-browsable history job (``GatewayHistory``).
- OBSERVABILITY (the TonY every-job-leaves-a-record story, request
  granularity — ``tony_tpu_torch.obs``, docs/OBSERVABILITY.md): every ticket
  accumulates a span trace (attempt per replica placement, queue-wait,
  the engine dispatches it rode; a failover's both attempts in ONE
  trace) exported as Chrome trace-event JSON via ``/debug/trace/<id>``
  and history ``metrics/traces.jsonl``; the engines' per-dispatch
  timelines surface as ``/stats`` dispatch blocks; ``/metrics`` renders
  everything as Prometheus text; ``POST /debug/profile`` arms an
  on-demand ``torch.profiler`` capture polled by the replica threads.
- ADMISSION TIERS (``gateway/admission.py``, docs/SERVING.md): each
  replica's queue is a weighted fair queue over priority tiers
  (``interactive``/``standard``/``batch``) — a saturating batch flood
  cannot starve interactive requests, an idle fleet still gives batch
  its full throughput — with per-tenant token-rate quotas priced as
  immediate 429 + ``Retry-After`` (``QuotaExceeded``), and
  deadline-first ordering within a tier. Stolen (failover) tickets
  keep their tier and are never re-charged quota.
- ELASTICITY (``gateway/autoscale.py`` — the TonY
  acquire-and-release-to-match-the-job loop, serving flavor):
  ``add_replica()`` grows the fleet at runtime, with the newcomer
  entering through the circuit breaker's PROBE path — it joins
  routing only after a real probe generation (which also pays its
  compile warmup off the traffic path); ``remove_replica()`` shrinks
  it over the existing zero-loss drain (the retiring replica leaves
  routing immediately, finishes its queue and in-flight slots, then
  parks RETIRED with its engine released). The ``AutoScaler`` drives
  both from the fleet's own signals (queue depth + oldest wait, shed
  rate, TTFT SLO burn, KV-page pressure) behind hysteresis, cooldowns
  and min/max bounds.
- SUPERVISION (the TonY ApplicationMaster story, ported to serving):
  every replica thread heartbeats per scheduler iteration; a
  ``LivenessMonitor`` watchdog declares a replica failed when its
  beats stop for ``stall_timeout_s`` (a wedged dispatch, not just a
  raised one). Either failure route — exception or stall — bumps the
  replica's EPOCH, steals every ticket it holds, and FAILS THEM OVER:
  queued tickets (which never touched the failed engine) move to a
  healthy replica untouched; engine-admitted tickets are charged one
  attempt, exclude the failed replica, and RE-RUN from their prompt —
  greedy and seeded-sampling decodes are deterministic, so the retry
  reproduces the exact token sequence and the stream emits only the
  tokens past what the client already received (the analog of TonY's
  task retries, token-exact). A ticket out of budget
  (``max_attempts``) or with no healthy replica left sheds **503**
  (retriable) — never 500. The failed replica resets its engine and
  enters the CIRCUIT BREAKER: exponential backoff
  (``breaker_base_s`` doubling to ``breaker_max_s``), then a probe
  generation; success rejoins it to the routing set, repeated failures
  (``quarantine_after`` consecutive) quarantine it. ``/healthz``
  exposes per-replica heartbeat age + breaker state, ``/readyz`` flips
  503 when zero replicas are healthy, and every failure / retry /
  probe / rejoin counts into ``/stats`` ``supervision``.
- REMOTE REPLICAS (``gateway/remote.py``, docs/SERVING.md): a replica
  whose ``server`` is a ``RemoteServer`` stub runs its engine on
  another host behind a replica agent (``serve/agent.py``). The same
  ``_Replica`` scheduler drives it — routing, WFQ, deadlines,
  failover, the breaker and every stats rollup are identical — while
  the stub adds the network layer: a heartbeat LEASE (reusing
  ``coordinator/liveness.LivenessMonitor``) whose expiry funnels into
  ``_fail_replica`` exactly like a watchdog stall, the epoch
  fence carried on every call and echoed in every response (stale
  either way is discarded), resumable per-request token streams (a
  dropped connection to a healthy agent is a reconnect at the held
  offset, not a failover), and in-lease connect retries with capped
  jittered backoff. A dead host is just a wedged replica.
- LIVE MIGRATION (``serve/migrate.py``): every PLANNED
  topology change — ``remove_replica()`` retirement, the autoscaler's
  scale-down, a ``migrate_session()`` rebalance — moves in-flight
  decode sessions to the survivors instead of finishing or re-running
  them: the source engine freezes each live slot at a dispatch
  boundary into a ``SessionSnapshot`` (pages + sampler/PRNG state +
  absolute emitted offset) and the ticket re-routes carrying it, so
  the stream resumes mid-flight on its new replica, token-exact.
  Between co-located replicas lent one SHARED ``PagePool`` the
  transfer is a zero-copy refcount owner swap (page ids, no KV bytes
  moved); to a remote replica the snapshot rides the agent wire
  (``POST /v1/migrate_in``) over the multiplexed channel. Failures
  mid-migration fall back to the crash path above — re-run from the
  prompt, still token-exact.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import queue
import threading
import time
import uuid
import zlib
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable

from tony_tpu_torch.gateway.admission import (DEFAULT_TIER, WFQueue, TenantQuotas,
                                        parse_tier_weights)
from tony_tpu_torch.gateway.admission import DEFAULT_TIER_WEIGHTS as _DEFAULT_WEIGHTS
from tony_tpu_torch.obs import Histogram, RequestTrace, TraceBuffer
from tony_tpu_torch.obs.alerts import AlertBus, default_rules
from tony_tpu_torch.obs.goodput import merge_ledgers
from tony_tpu_torch.obs.timeline import DispatchTimeline
from tony_tpu_torch.serve import PoolExhausted, QueueFull, Request, Server

log = logging.getLogger(__name__)


class Shed(Exception):
    """A request the gateway refused or gave up on; ``http_status`` is
    the status the front door maps it to."""

    http_status = 500

    def __init__(self, reason: str):
        super().__init__(reason)
        self.reason = reason


class BadRequest(Shed):
    http_status = 400


class GatewayQueueFull(Shed):
    http_status = 429


class QuotaExceeded(Shed):
    """The tenant's token bucket can't cover this request right now:
    429 with an honest ``Retry-After`` (seconds until the bucket
    refills enough). Priced at submit, never queued — a tenant's
    overrun cannot occupy queue slots other tenants need."""

    http_status = 429

    def __init__(self, reason: str, retry_after_s: float = 1.0):
        super().__init__(reason)
        self.retry_after_s = max(0.0, retry_after_s)


class GatewayClosed(Shed):
    http_status = 503


class DeadlineExceeded(Shed):
    http_status = 504


class NoHealthyReplicas(Shed):
    """Every replica's breaker is open (or quarantined): the gateway
    sheds clean 503s — retriable service-unavailable, the load
    balancer's signal to back off — until a probe rejoins a replica."""

    http_status = 503


class RetryBudgetExhausted(Shed):
    """The request burned ``max_attempts`` failed engine runs across
    replica failures: shed 503 — retriable (the request was fine, the
    fleet was not), and distinct from ``GatewayClosed`` so a client can
    tell transient fleet trouble from a shutdown in progress."""

    http_status = 503


class _ReplicaUnhealthy(Exception):
    """Internal routing signal: the chosen replica flipped unhealthy
    between route and enqueue — re-route, never queue onto a broken
    replica."""


@dataclass
class GenRequest:
    """One client request. ``ttl_s`` bounds its whole life (queue wait
    included): ``None`` = no deadline. ``session`` opts into replica
    affinity. Sampling knobs mirror ``serve.Request``."""

    prompt: list
    max_new_tokens: int = 64
    temperature: float = 0.0
    top_k: int = 0
    seed: int = 0
    id: Any = None
    ttl_s: float | None = None
    session: str | None = None
    # multi-tenant admission (gateway/admission.py): ``priority`` names
    # a WFQ tier (None -> "standard"; unknown names are a 400),
    # ``tenant`` keys the token-rate quota bucket (None -> the shared
    # anonymous bucket when quotas are on)
    tenant: str | None = None
    priority: str | None = None
    # set by the HTTP layer: when the front door read the request off
    # the wire (time.monotonic()); the trace's http_receive span —
    # None for in-process submits, whose trace starts at submit
    t_receive: float | None = None


# ticket lifecycle states
QUEUED, RUNNING, DONE, SHED = "QUEUED", "RUNNING", "DONE", "SHED"

# replica health states (the circuit-breaker cycle): HEALTHY routable,
# BROKEN waiting out its breaker backoff, PROBING running the probe
# generation, QUARANTINED out of the rotation for good, RETIRED
# scale-down finished its zero-loss drain and released the engine
HEALTHY, BROKEN, PROBING, QUARANTINED, RETIRED = (
    "healthy", "broken", "probing", "quarantined", "retired")

# window for the per-replica recent-enqueue-rate sensor (queue block)
_ENQ_RATE_WINDOW_S = 10.0


class Ticket:
    """The caller's handle on a submitted request: an event stream plus
    a blocking ``result()``.

    Events (also forwarded to ``on_event`` from the replica thread):
      ("tokens", [ids])          newly generated tokens (streaming)
      ("done", Result, metrics)  finished; metrics = the per-request
                                 observability record (queue_wait_ms,
                                 ttft_ms, tpot_ms, tokens_in/out, ...)
      ("shed", status, reason)   refused after admission (deadline hit
                                 in queue, retry budget / fleet health
                                 exhausted after replica failures)

    On replica failure the ticket is REQUEUED, not shed (see
    ``Gateway._failover``): ``attempts`` counts engine runs that
    failed, ``excluded`` the replicas that failed it. The retry re-runs
    from the prompt; because greedy and seeded-sampling decodes are
    deterministic, the regenerated stream is byte-identical, and
    ``_n_emitted`` makes the replica emit only tokens the client has
    not already received — a mid-stream failover is invisible apart
    from latency.
    """

    def __init__(self, request: GenRequest, ttl_s: float | None,
                 on_event: Callable | None = None):
        self.request = request
        self.ttl_s = ttl_s
        self.t_submit = time.monotonic()
        self.t_queued = self.t_submit  # refreshed per enqueue (failover)
        self.t_admit: float | None = None
        self.t_first: float | None = None
        self.trace: RequestTrace | None = None  # set by Gateway.submit
        self.replica: int | None = None
        self.state = QUEUED
        # admission-tier bookkeeping (set by Gateway.submit): the WFQ
        # tier travels WITH the ticket, so a failover re-enqueue keeps
        # its priority; quota was charged once at submit and never
        # again. queue_pos is the position it joined its (last) queue
        # at — the after-the-fact tier-behavior audit trail.
        self.tier = DEFAULT_TIER
        self.tenant: str | None = None
        self.queue_pos = -1
        # disaggregation state (roles mode only): ``phase`` routes the
        # ticket to its pool ("prefill" until the handoff, "decode"
        # after; None = roleless fleet); ``handoff`` carries the page
        # payload between pools; ``_prefill_meta`` the prefill half's
        # stats, merged into the final request metrics
        self.phase: str | None = None
        self.handoff: Any = None
        self._prefill_meta: dict | None = None
        # live migration: the frozen ``SessionSnapshot`` a
        # planned move carries between replicas — set by
        # _relay_migration, consumed (and CLEARED: the payload is
        # one-shot, its transfer ref moves into the adopting slot) by
        # the admission that resumes it. A ticket whose snapshot is
        # gone falls back to the crash path: re-run from the prompt,
        # token-exact.
        self.migrate: Any = None
        self._wfq_key: tuple | None = None  # set by WFQueue.push
        self.metrics: dict | None = None  # the done-event record
        self.events: queue.Queue = queue.Queue()
        self.attempts = 0  # engine runs that FAILED (retry budget)
        self.excluded: set[int] = set()  # replicas that failed it
        self._on_event = on_event
        self._n_emitted = 0  # tokens already streamed out
        self._emit_lock = threading.Lock()  # serializes token emission
        self._shed_exc_cls: type | None = None  # result()'s exception
        #                                         class, when the status
        #                                         alone is ambiguous
        # crash-safe control plane: the absolute token
        # sequence emitted so far — what GET /v1/stream/<id>?offset=
        # serves a client that reconnects (possibly across a gateway
        # restart). Invariant: len(_tokens) == _n_emitted, both
        # advanced together under _emit_lock; recovery seeds both from
        # an adopted snapshot's ``generated`` prefix. ``_journal`` is
        # the gateway's write-ahead log when one is armed; ``t_terminal``
        # stamps done/shed so the resume registry can reap the ticket
        # after the park TTL.
        self._tokens: list[int] = []
        self._journal = None
        self.t_terminal: float | None = None
        # the terminal shed, replayable: a client that reconnects
        # after its request was shed gets the same status/reason the
        # live stream carried, not a 404
        self._shed_status: int | None = None
        self._shed_reason = ""

    # estimate used by least-outstanding-tokens routing: the work a
    # replica signs up for when it accepts this ticket
    @property
    def cost(self) -> int:
        return len(self.request.prompt) + self.request.max_new_tokens

    @property
    def deadline(self) -> float | None:
        """Absolute deadline, DERIVED from the original submit time so
        it is structurally impossible for a failover re-enqueue (which
        refreshes ``t_queued``) to extend it: a request gets ``ttl_s``
        of wall clock from submit, across however many replicas it
        visits."""
        return None if self.ttl_s is None else self.t_submit + self.ttl_s

    def _emit(self, event: tuple) -> None:
        self.events.put(event)
        if self._on_event is not None:
            try:
                self._on_event(self, event)
            except Exception:
                log.exception("ticket on_event callback failed")

    def _emit_tokens(self, start: int, tokens: list, now: float) -> None:
        """Emit the absolute window ``[start, start + len(tokens))`` of
        this request's generated sequence, skipping whatever the client
        already has. Advance-and-emit are atomic under a PER-TICKET
        lock, so a failed replica's late delta and its failover
        successor's resumed stream serialize into one exactly-ordered,
        gap-free, duplicate-free client stream (decoding is
        deterministic, so overlapping windows carry identical values —
        whoever wins the lock emits them). A ticket-scoped lock on
        purpose: no replica lock is held across the ``on_event``
        callback, so a slow consumer stalls only its own request."""
        with self._emit_lock:
            if self.state == SHED:
                return  # terminal shed already delivered: no tokens
                #         after the final event
            cur = self._n_emitted
            if cur >= start + len(tokens):
                return
            new = tokens[cur - start:]
            self._n_emitted = cur + len(new)
            self._tokens.extend(new)  # the resume buffer
            if self.t_first is None:
                self.t_first = now
            self._emit(("tokens", new))
        j = self._journal
        if j is not None:
            # outside the emit lock (the journal has its own): the
            # cumulative offset row is idempotent — replay takes the max
            j.emit(self.request.id, self._n_emitted)

    def result(self, timeout: float | None = None):
        """Block until the request finishes; returns the
        ``serve.Result``. Raises the mapped ``Shed`` subclass if the
        gateway gave up on it. Token events are drained silently (use
        ``on_event`` or read ``events`` yourself to stream)."""
        t_end = None if timeout is None else time.monotonic() + timeout
        while True:
            left = None if t_end is None else max(0.0, t_end - time.monotonic())
            try:
                kind, *rest = self.events.get(timeout=left)
            except queue.Empty:
                raise TimeoutError(
                    f"request {self.request.id!r} not finished after "
                    f"{timeout}s (state {self.state})") from None
            if kind == "done":
                return rest[0]
            if kind == "shed":
                status, reason = rest
                cls = self._shed_exc_cls or {
                    429: GatewayQueueFull, 503: GatewayClosed,
                    504: DeadlineExceeded}.get(status, Shed)
                exc = cls(reason)
                exc.http_status = status
                raise exc


def _release_snapshot(snap) -> None:
    """Give back the shared-pool transfer ref a LOCAL (owner-swap)
    ``SessionSnapshot`` still holds. Wire snapshots carry content, not
    references — nothing to release."""
    if snap is None or isinstance(snap, dict):
        return
    pool = getattr(snap, "pool", None)
    if not getattr(snap, "local", False) or pool is None:
        return
    try:
        with pool.lock:
            pool.unref([int(p) for p in snap.pages])
    except Exception:
        log.exception("migrate snapshot page release failed")
    snap.local = False
    snap.pool = None


class _SnapLease:
    """The extract-vs-steal handshake (this PR): registered by
    ``_migrate_ticket`` BEFORE it freezes a session, claimed by
    ``_failover`` when the source replica dies with the extract still
    in flight. Without it, a SIGKILL between freeze and ship abandons
    the frozen snapshot — failover re-runs the victim from its prompt
    even when a complete, token-exact snapshot materializes a moment
    later (a remote agent can answer ``/v1/migrate_out`` and die
    before the relay). With it, failover waits a SHORT lease for the
    in-flight extract: complete -> adopt the snapshot (no recompute),
    timeout -> mark it abandoned so the extractor releases it, crash
    path proceeds. All fields are mutated under the gateway's
    ``_lease_lock``; ``done`` doubles as the claimer's wakeup."""

    __slots__ = ("done", "snap", "abandoned", "t0")

    def __init__(self):
        self.done = threading.Event()
        self.snap = None
        self.abandoned = False
        self.t0 = time.monotonic()


def _lease_key(ticket) -> object:
    """Lease key: the gateway request id (what migrate_session is
    addressed by), falling back to the ticket's identity for requests
    submitted without one — extractor and claimer must compute the
    SAME key from the same ticket."""
    rid = ticket.request.id
    return rid if rid is not None else id(ticket)


def _release_ticket_payload(ticket) -> None:
    """Drop (and, for owner-swap forms, unref) the one-shot payloads a
    ticket still carries — run on every terminal path and on the
    refused-payload fallback, so a shed or re-run mid-migration can
    never leak shared-pool pages. Wire payloads hold no references and
    device-tree handoffs stay reusable, so only the id-carrying forms
    are touched."""
    snap, ticket.migrate = ticket.migrate, None
    _release_snapshot(snap)
    ho = ticket.handoff
    if isinstance(ho, dict) and "page_ids" in ho:
        ticket.handoff = None
        pool = ho.get("pool")
        try:
            if pool is not None:
                with pool.lock:
                    pool.unref([int(p) for p in ho["page_ids"]])
        except Exception:
            log.exception("handoff page release failed")


class _Replica:
    """One ``serve.Server`` + the thread that drives it, under
    supervision: the thread heartbeats (``last_beat``) every scheduler
    iteration; ``epoch`` is the fencing token — every failure
    (exception OR watchdog-declared stall) bumps it, and any state the
    thread computed under the old epoch is discarded, so a wedged step
    that eventually returns cannot deliver results for tickets that
    were already failed over to another replica."""

    def __init__(self, index: int, server: Server, gateway: "Gateway"):
        self.index = index
        self.server = server
        self.gateway = gateway
        # disaggregation role (gateway ``roles=``): "any" = generalist
        # (the default), "prefill" = admission/chunked-prefill only
        # (requests leave as page-list handoffs), "decode" = receives
        # handoffs and decodes them
        self.role = "any"
        # REMOTE replicas (gateway/remote.RemoteServer): the server is
        # a stub over an agent on another host — bind its lease
        # machinery into the gateway's failure funnel, and carry the
        # host address so per-request records can name the machine
        # that served them ("local" for in-process thread replicas)
        self.host = getattr(server, "host_addr", "local")
        bind = getattr(server, "bind_supervisor", None)
        if bind is not None:
            bind(lambda reason, _r=self: gateway._fail_remote(_r, reason))
        self.queue = WFQueue(gateway.tier_weights)
        self.cv = threading.Condition()
        self.outstanding = 0  # token-cost estimate: queued + in-flight
        self.completed = 0
        self.shed = 0
        # queue sensors (the /stats "queue" block — the autoscaler's
        # primary pressure signal): lifetime enqueue counter plus a
        # short timestamp ring for the recent enqueue rate
        self.enqueued = 0
        self._enq_times: deque[float] = deque(maxlen=256)
        # scale-down (Gateway.remove_replica): ``retiring`` leaves the
        # routing set immediately while the thread finishes its queue
        # and in-flight slots; ``retired`` marks the drain complete and
        # the engine released
        self.retiring = False
        self.retired = False
        self.spawned = False  # added by add_replica (vs boot-time)
        # supervision / breaker state (all mutated under self.cv except
        # the plain counters, which only this thread or the gateway's
        # failure path touch)
        self.state = HEALTHY
        self.epoch = 0
        self.last_beat = time.monotonic()
        self.failures = 0              # breaker trips, lifetime
        self.consecutive_failures = 0  # since the last delivered result
        self.probes = 0
        self.rejoins = 0
        self._stop = False
        self._exited = False  # the thread left _loop: nothing enqueued
        #                       after this is ever processed
        self._tickets: dict[int, Ticket] = {}  # engine id -> ticket
        self._next_id = 0
        self._tl_cursor = 0  # dispatch-timeline read position (tracing)
        self._probe_first = False  # scale-up: earn admission via probe
        # orders the failure-claim against the breaker:
        # _fail_replica holds this across the ticket steal + failover
        # (including the park-adoption probe of the agent), and
        # _recover takes it before its hard engine reset — without the
        # handshake, a lease expiry detected on the monitor thread
        # races the replica thread's breaker entry, and the reset
        # wipes the very agent session _claim_parked came to adopt
        self.fail_lock = threading.Lock()
        self._thread = threading.Thread(target=self._loop,
                                        name=f"gateway-replica-{index}",
                                        daemon=True)

    # ---------------------------------------------------------- intake

    def enqueue(self, ticket: Ticket, force: bool = False) -> None:
        """``force=True`` is the FAILOVER entry: a stolen ticket must be
        allowed in even mid-drain (the drain promise covers it), as long
        as this thread is still alive to process it."""
        with self.cv:
            if (self._stop and not force) or self._exited:
                # closes the submit-vs-drain race: a ticket landing
                # after the stop signal could otherwise strand forever
                # on a thread that already exited
                raise GatewayClosed("gateway is draining")
            if self.state != HEALTHY or self.retiring:
                # closes the route-vs-fail race: the router saw this
                # replica healthy, the breaker opened (or a scale-down
                # started retiring it) before the enqueue landed — the
                # caller re-routes
                raise _ReplicaUnhealthy(
                    f"replica {self.index} is "
                    f"{'retiring' if self.retiring else self.state}")
            ticket.replica = self.index
            ticket.t_queued = time.monotonic()
            if ticket.trace is not None:
                # one attempt span per placement on a replica; its
                # epoch is the fencing tag the failover story pivots
                # on, its host names the machine (agent address |
                # "local") — the Chrome export's process row
                ticket.trace.begin_attempt(self.index, self.epoch,
                                           t0=ticket.t_queued,
                                           host=self.host)
            ticket.queue_pos = self.queue.push(ticket)
            self.enqueued += 1
            self._enq_times.append(ticket.t_queued)
            self.outstanding += ticket.cost
            self.cv.notify()
        j = ticket._journal
        if j is not None:
            # WAL route row: which replica — and for remote
            # ones, which HOST — this placement landed on, so a
            # recovering gateway knows where to look for the parked
            # session. Outside the cv (the journal has its own lock).
            j.route(ticket.request.id, self.index,
                    None if self.host == "local" else self.host)

    @property
    def n_queued(self) -> int:
        return len(self.queue)

    @property
    def busy(self) -> bool:
        return bool(self._server_busy() or self.queue)

    def queue_signals(self, now: float | None = None) -> dict:
        """The per-replica queue block: depth, oldest-wait age, recent
        enqueue rate, per-tier depths — the autoscaler's primary
        sensor, exported per replica on /stats and /metrics."""
        if now is None:
            now = time.monotonic()
        with self.cv:
            depth = len(self.queue)
            oldest = self.queue.oldest_t_queued()
            recent = sum(1 for t in self._enq_times
                         if now - t <= _ENQ_RATE_WINDOW_S)
            span = _ENQ_RATE_WINDOW_S
            if recent == self._enq_times.maxlen:
                # the ring saturated inside the window: rate over the
                # span actually retained, else heavy bursts (the exact
                # loads this sensor exists for) read as a flat ceiling
                span = max(1e-3, now - self._enq_times[0])
            by_tier = self.queue.depth_by_tier()
        return {
            "depth": depth,
            "oldest_wait_s": round(max(0.0, now - oldest), 3)
            if oldest is not None else 0.0,
            "enqueue_rate_per_s": round(recent / span, 3),
            "by_tier": by_tier,
        }

    # ------------------------------------------------------------ loop

    def start(self, probe_first: bool = False) -> None:
        """``probe_first=True`` is the SCALE-UP entry (add_replica):
        the replica starts BROKEN and runs the circuit breaker's probe
        cycle before it ever joins routing — a new replica earns
        admission exactly the way a recovered one does, and its first
        compiles happen on the probe, off the traffic path."""
        self._probe_first = probe_first
        self._thread.start()

    def signal_stop(self) -> None:
        with self.cv:
            self._stop = True
            self.cv.notify()

    def join(self, timeout: float | None = None) -> None:
        if self._thread.ident is not None:  # join pre-start is an error
            self._thread.join(timeout)

    def _loop(self) -> None:
        if self._probe_first:
            # scale-up path: prove the engine works (and pay its first
            # compiles) through a real probe generation before joining
            # routing — _recover() ends with the rejoin that registers
            # us with the watchdog and flips us HEALTHY
            self._probe_first = False
            if not self._recover():
                return
        while True:
            with self.cv:
                epoch = self.epoch
                while not self.queue and not self._server_busy() \
                        and not self._stop and self.epoch == epoch:
                    self.cv.wait(timeout=self.gateway._beat_interval_s)
                    # beat WHILE idle too — an idle replica that only
                    # beat on work would look stalled to the watchdog
                    self.gateway._beat(self)
                if self._stop and not self.queue \
                        and not self._server_busy():
                    self._exited = True
                    # stop being watched: the watchdog now outlives the
                    # join (it must — a step that wedges DURING drain
                    # still needs its tickets failed over), so a
                    # cleanly-exited thread going silent must not read
                    # as a stall
                    self.gateway._unwatch(self)
                    return
                stale = self.epoch != epoch
            self.gateway._beat(self)
            if stale:
                # the watchdog (or a probe race) declared us failed
                # while we were idle — clean up and re-earn admission
                if not self._recover():
                    return
                continue
            if self.retiring:
                # planned exit: hand the work to survivors
                # instead of finishing it here — every loop iteration,
                # so a request that was still mid-prefill last round
                # migrates the moment it reaches a live decode slot
                self._migrate_out(epoch)
            try:
                self._admit_from_queue(epoch)
                with self.cv:
                    stale = self.epoch != epoch
                # declared failed during admission: the engine holds
                # only ghosts now — stepping it would burn a full
                # (multi-dispatch) round whose output is guaranteed to
                # be discarded. _stream_deltas/_deliver fence
                # internally, so the stale flag only skips the step.
                if not stale:
                    busy = self._server_busy()
                    finished = self.server.step() if busy else []
                    if busy:
                        # one WORKING iteration: the on-demand serving
                        # profiler counts it (near-free attribute read
                        # while no capture is armed)
                        self.gateway.profiler.poll()
                    now = time.monotonic()
                    # INSIDE the try: an exception in the delivery half
                    # (a metrics/history consumer, say) must take the
                    # same failover path as a dead dispatch — outside,
                    # it would kill this thread with state still
                    # HEALTHY, a permanently-lost replica no probe can
                    # ever resurrect
                    self._attach_dispatch_spans(epoch)
                    self._stream_deltas(now, epoch)
                    self._deliver(finished, now, epoch)
            except Exception as e:
                # a failed replica must not strand its tickets with no
                # terminal event — but unlike the old shed-everything
                # response, failure here means FAILOVER: the gateway
                # steals every ticket we hold and requeues it on a
                # healthy replica (token-exact re-run); we reset and
                # enter the breaker
                log.exception("replica %d step failed", self.index)
                self.gateway._fail_replica(
                    self, epoch, f"replica {self.index} step failed: "
                    f"{type(e).__name__}: {e}")
                if not self._recover():
                    return
                continue
            with self.cv:
                stale = self.epoch != epoch
            if stale:
                # the step wedged long enough for the watchdog to fire:
                # our tickets are already re-running elsewhere — any
                # output was a previous epoch's and was discarded by
                # the internal fences; re-earn admission
                if not self._recover():
                    return

    def _migrate_out(self, epoch: int) -> None:
        """Retirement accelerator, on this replica's own
        thread: a retiring replica moves its work to the survivors
        instead of decoding it to completion. Queued tickets simply
        re-route (they never started); live decode slots freeze into
        ``SessionSnapshot``s and resume mid-stream elsewhere,
        token-exact. Whatever cannot move — no healthy taker, an
        unpaged engine, a request still mid-prefill — keeps running
        here, so the zero-loss drain promise is unchanged; migration
        only makes the drain fast."""
        gw = self.gateway
        # queued first: a ticket that re-routes before admission costs
        # nothing to move
        while True:
            with self.cv:
                if self.epoch != epoch:
                    return
                ticket = self.queue.pop()
            if ticket is None:
                break
            try:
                target = gw._route(ticket,
                                   ticket.excluded | {self.index})
            except NoHealthyReplicas:
                # nobody can take work: keep it and run it here
                with self.cv:
                    if self.epoch == epoch:
                        self.queue.unpop(ticket)
                break
            with self.cv:
                if self.epoch == epoch:
                    self.outstanding = max(
                        0, self.outstanding - ticket.cost)
            if ticket.trace is not None:
                ticket.trace.end_attempt(time.monotonic(),
                                         outcome="moved")
            ticket.state = QUEUED
            ticket.replica = None
            try:
                target.enqueue(ticket, force=True)
            except (GatewayClosed, _ReplicaUnhealthy):
                gw._requeue(self, ticket,
                            f"replica {self.index} retiring")
        # then the live slots: freeze + relay, one at a time
        with self.cv:
            if self.epoch != epoch:
                return
            live = list(self._tickets.items())
        for engine_id, ticket in live:
            gw._migrate_ticket(self, engine_id, ticket, epoch)

    def _server_busy(self) -> bool:
        server = self.server  # single read vs concurrent retirement
        if server is None:  # retired: engine released
            return False
        # n_active, not slots.n_active: a slot parked mid-chunked-
        # prefill holds a request the loop must keep driving
        return bool(server.n_active or server.n_pending)

    def _admit_from_queue(self, epoch: int) -> None:
        """Move tickets into the engine, AT MOST as many as there are
        free slots — the deadline check runs at the moment a slot is
        genuinely available, so an expired request is shed having never
        occupied one (and never cost a prefill dispatch)."""
        free = len(self.server.slots.free_slots()) \
            - self.server.n_pending \
            - getattr(self.server, "n_prefilling", 0)
        while free > 0:
            with self.cv:
                ticket = self.queue.pop()  # the WFQ decision: least
                # virtual work among non-empty tiers, deadline-first
                # within the tier
                if ticket is None:
                    return
            now = time.monotonic()
            if ticket.deadline is not None and now >= ticket.deadline:
                self._shed(ticket, 504,
                           f"deadline exceeded after "
                           f"{now - ticket.t_submit:.3f}s in queue",
                           epoch=epoch)
                continue
            req = ticket.request
            engine_id = self._next_id
            self._next_id += 1
            engine_req = Request(
                list(req.prompt), req.max_new_tokens,
                temperature=req.temperature, top_k=req.top_k,
                seed=req.seed, id=engine_id,
                # role-split plumbing: a prefill-pool replica runs
                # admission/prefill only (the result is a page
                # handoff); a ticket carrying a handoff payload
                # admits it instead of prefilling
                prefill_only=self.role == "prefill",
                handoff=ticket.handoff,
                # a migrated-in session resumes mid-stream: the
                # engine arms a slot from the snapshot instead of
                # prefilling (serve/migrate.py)
                migrate=ticket.migrate)
            # the GATEWAY request id rides along: remote
            # stubs ship it so the agent can park an orphaned session
            # under the one id a restarted gateway still knows
            engine_req.rid = req.id
            try:
                self.server.submit(engine_req)
            except QueueFull:
                # engine bound hit (shouldn't happen: we feed at most
                # free-slot many) — put it back and stop admitting.
                # Epoch-fenced like every other path here: appending to
                # a replica whose steal already ran would park the
                # ticket on a BROKEN queue forever
                with self.cv:
                    if self.epoch == epoch:
                        self.queue.unpop(ticket)  # back at its old
                        # position, tier charge refunded
                        return
                self.gateway._failover(
                    self, [], [ticket],
                    f"replica {self.index} failed during admission")
                return
            except PoolExhausted as e:
                # capacity, not malformation: the request can never fit
                # this replica's KV page pool — 503 so a caller against
                # a bigger deployment may legitimately retry
                self._shed(ticket, 503, str(e), epoch=epoch)
                continue
            except ValueError as e:
                if ticket.migrate is not None or (
                        isinstance(ticket.handoff, dict)
                        and "page_ids" in ticket.handoff):
                    # this engine refused the CARRIED state (owner-swap
                    # payload from a pool it does not hold, codec
                    # drift after a topology change) — that is a
                    # placement mistake, not the client's: drop the
                    # payload (refs released) and fall back to the
                    # crash path, a token-exact re-run from the prompt
                    log.warning(
                        "replica %d refused a migrated payload (%s); "
                        "falling back to re-run", self.index, e)
                    _release_ticket_payload(ticket)
                    with self.cv:
                        if self.epoch == epoch:
                            self.queue.unpop(ticket)
                            continue
                    self.gateway._failover(
                        self, [], [ticket],
                        f"replica {self.index} failed during admission")
                    return
                self._shed(ticket, 400, str(e), epoch=epoch)
                continue
            except (ConnectionError, TimeoutError, OSError):
                # REMOTE submit failed in transit (the stub's in-lease
                # retries already ran): put the popped ticket back
                # where the failover steal can find it, then let the
                # raise take the scheduler's exception route into
                # _fail_replica. Epoch-fenced like the QueueFull path:
                # if the steal already ran, this ticket was missed by
                # it and must be failed over directly.
                with self.cv:
                    if self.epoch == epoch:
                        self.queue.unpop(ticket)
                        raise
                self.gateway._failover(
                    self, [], [ticket],
                    f"replica {self.index} transport failed during "
                    f"admission")
                return
            # one-shot payloads are CONSUMED by the submit that
            # succeeded (their transfer ref moved into the engine), so
            # they must not survive on the ticket: a later failover
            # re-submitting a spent owner-swap doc would install
            # dangling page ids. Clearing them degrades that failover
            # to the crash path — re-run from the prompt, token-exact.
            if ticket.migrate is not None:
                ticket.migrate = None
            if isinstance(ticket.handoff, dict) \
                    and "page_ids" in ticket.handoff:
                ticket.handoff = None
            with self.cv:
                if self.epoch != epoch:
                    # declared failed mid-admission: the ticket we just
                    # popped was missed by the steal — requeue it
                    # untouched (the engine ghost dies in the reset)
                    stray = ticket
                else:
                    ticket.t_admit = now
                    ticket.state = RUNNING
                    self._tickets[engine_id] = ticket
                    stray = None
            if stray is not None:
                self.gateway._failover(
                    self, [], [stray],
                    f"replica {self.index} failed during admission")
                return
            if ticket.trace is not None:
                ticket.trace.add("queue_wait", ticket.t_queued, now,
                                 attempt_key=(self.index, epoch),
                                 engine_id=engine_id)
            free -= 1

    def _attach_dispatch_spans(self, epoch: int) -> None:
        """Fold the engine's new ``DispatchRecord``s into the traces of
        the requests that rode them: admit records (prefill/hit_admit/
        cow_admit) carry the engine id they admitted; decode/verify
        records carry
        the engine ids live at dispatch time. Runs on the replica
        thread after each step. Records for tickets already stolen are
        DROPPED by the trace's ``attempt_key`` fence — checked against
        the open attempt's (replica, epoch) tags atomically under the
        trace lock, so even a steal + re-placement racing this snapshot
        cannot mis-attribute a dead replica's dispatch to the
        survivor's attempt.

        REMOTE replicas take this exact path: the stub's
        obs-puller lands the agent's dispatch records — offset-
        corrected to this gateway's clock, tagged with the host and
        the offset±uncertainty — in a ``RemoteTimeline`` whose
        ``take_new`` this method drains like any local ring, so one
        trace spans both hosts of a remote failover with zero special
        casing here. Spans attach CLAMPED: the offset correction is an
        estimate, and a few ms of clock error must bend into the
        attempt window rather than corrupt the trace invariants."""
        tl = self.server.timeline
        if tl is None or self.gateway.traces is None:
            return
        new, self._tl_cursor = tl.take_new(self._tl_cursor)
        if not new:
            return
        with self.cv:
            tickets = dict(self._tickets)
        key = (self.index, epoch)
        for rec in new:
            if rec.kind in ("prefill", "prefill_chunk", "hit_admit",
                            "cow_admit", "handoff_admit",
                            "handoff_out", "migrate_out",
                            "migrate_in"):
                targets = [tickets.get(rec.request_id)]
            else:
                targets = [tickets.get(eid)
                           for eid in rec.tags.get("requests", ())]
            t1 = rec.t0 + rec.dur_ms / 1e3
            tags = {k: v for k, v in rec.tags.items() if k != "requests"}
            tags.update(occupancy=rec.occupancy, bucket=rec.bucket,
                        tokens=rec.tokens)
            if rec.compile:
                tags["compile"] = True
            for ticket in targets:
                if ticket is not None and ticket.trace is not None:
                    ticket.trace.add(rec.kind, rec.t0, t1,
                                     attempt_key=key, clamp=True,
                                     **tags)

    def _stream_deltas(self, now: float, epoch: int) -> None:
        with self.cv:
            if self.epoch != epoch:
                return
            tickets = dict(self._tickets)
            emitted = {eid: t._n_emitted for eid, t in tickets.items()}
        progress = self.server.live_progress(emitted)
        # no second epoch fence: emission is offset-based and
        # per-ticket-serialized (Ticket._emit_tokens), so even a delta
        # computed just before a steal lands exactly — the failover
        # replica's resumed stream skips whatever this emit covered,
        # and vice versa. No replica lock is held across the emits.
        for engine_id, new in progress.items():
            ticket = tickets.get(engine_id)
            if ticket is not None and new:
                ticket._emit_tokens(emitted[engine_id], new, now)

    def _deliver(self, finished, now: float, epoch: int) -> None:
        for res in finished:
            with self.cv:
                if self.epoch != epoch:
                    # failed mid-delivery: remaining tickets were
                    # stolen and will re-run token-exactly elsewhere
                    return
                ticket = self._tickets.pop(res.id, None)
                if ticket is not None:
                    self.outstanding = max(0,
                                           self.outstanding - ticket.cost)
                    self.consecutive_failures = 0  # real work
                    # delivered: the breaker's failure streak is over.
                    # Reset INSIDE the fence: unfenced, it could race a
                    # concurrent _fail_replica increment and wipe the
                    # streak a flapping replica needs to reach
                    # quarantine_after
            if ticket is None:
                continue
            if res.finish_reason == "handoff" \
                    and getattr(res, "handoff", None) is not None:
                # the prefill pool's half is done: not a completion —
                # the ticket moves to a decode replica carrying the
                # page payload, and the client sees nothing yet
                self.gateway._relay_handoff(self, ticket, res, now)
                continue
            # the whole sequence as one absolute window: _emit_tokens
            # dedups past the client's cursor, so this emits exactly
            # the un-streamed tail (all of it, for unary requests)
            ticket._emit_tokens(0, res.tokens, now)
            ticket.state = DONE
            self.completed += 1
            metrics = self._request_metrics(ticket, res, now)
            ticket.metrics = metrics  # unary responders read it after
            # result(); same record the stream's final line carries
            res = type(res)(ticket.request.id, res.prompt, res.tokens,
                            res.finish_reason, res.prefix_hit_tokens,
                            res.prefill_tokens_saved,
                            res.drafted, res.accepted,
                            getattr(res, "prefill_chunks", 0))
            if ticket.trace is not None:
                ticket.trace.end_attempt(now, outcome="done")
                ticket.trace.finish(
                    now, outcome="done",
                    finish_reason=res.finish_reason,
                    tokens_in=metrics["tokens_in"],
                    tokens_out=metrics["tokens_out"],
                    ttft_ms=metrics["ttft_ms"],
                    tpot_ms=metrics["tpot_ms"],
                    attempts=ticket.attempts)
                self.gateway._export_trace(ticket)
            self.gateway._record_done(self, metrics)
            ticket.t_terminal = now
            ticket._emit(("done", res, metrics))
            if ticket._journal is not None:
                ticket._journal.done(ticket.request.id)

    def _request_metrics(self, ticket: Ticket, res, now: float) -> dict:
        n_out = len(res.tokens)
        ttft = (ticket.t_first - ticket.t_submit) if ticket.t_first else 0.0
        tpot = ((now - ticket.t_first) / (n_out - 1)
                if n_out > 1 and ticket.t_first else 0.0)
        # role-split requests: the prefill half's savings/chunk counts
        # rode over in the handoff relay; the decode-side Result knows
        # nothing about them
        meta = ticket._prefill_meta or {}
        return {
            **({"prefill_replica": meta["prefill_replica"]}
               if meta else {}),
            "id": ticket.request.id,
            "replica": self.index,
            # WHICH MACHINE served it (agent address for remote
            # replicas, "local" for in-process threads): the field
            # that lets an operator attribute a bad TTFT to a host
            # from the /stats window or history requests.jsonl
            "host": self.host,
            "queue_wait_ms": round(
                (ticket.t_admit - ticket.t_submit) * 1e3, 3),
            "ttft_ms": round(ttft * 1e3, 3),
            "tpot_ms": round(tpot * 1e3, 3),
            "e2e_ms": round((now - ticket.t_submit) * 1e3, 3),
            "tokens_in": len(res.prompt),
            "tokens_out": n_out,
            "prefix_hit_tokens": meta.get("prefix_hit_tokens",
                                          res.prefix_hit_tokens),
            "prefill_tokens_saved": meta.get("prefill_tokens_saved",
                                             res.prefill_tokens_saved),
            "prefill_chunks": meta.get(
                "prefill_chunks", getattr(res, "prefill_chunks", 0)),
            "drafted": res.drafted,
            "accepted": res.accepted,
            "draft_hit_rate": round(res.draft_hit_rate, 4),
            "attempts": ticket.attempts,  # failed engine runs this
            # request survived (0 = no failover; latency fields span
            # the whole life, retries included)
            # tier audit trail: which tenant/tier this ran
            # as and the queue position it joined its (last) queue at
            # — so WFQ behavior is checkable after the fact from the
            # /stats window and history requests.jsonl
            "tenant": ticket.tenant,
            "priority": ticket.tier,
            "queue_pos": ticket.queue_pos,
            "finish_reason": res.finish_reason,
        }

    def _shed(self, ticket: Ticket, status: int, reason: str,
              epoch: int | None = None) -> None:
        self.shed += 1
        _release_ticket_payload(ticket)  # a dead ticket must not pin
        #                                  shared-pool pages
        with self.cv:
            if epoch is None or self.epoch == epoch:
                # fenced + clamped: a steal that raced the caller's
                # queue pop already zeroed outstanding wholesale —
                # subtracting again would drive it negative and skew
                # least-outstanding routing forever after rejoin
                self.outstanding = max(0, self.outstanding - ticket.cost)
        self.gateway._record_shed(self, status, tier=ticket.tier)
        if ticket.trace is not None:
            ticket.trace.finish(outcome="shed", status=status,
                                reason=reason)
            self.gateway._export_trace(ticket)
        with ticket._emit_lock:
            # state flip + terminal emit together: a previous owner's
            # late token delta can't land after the final shed event
            ticket.state = SHED
            ticket.t_terminal = time.monotonic()
            ticket._shed_status = status
            ticket._shed_reason = reason
            ticket._emit(("shed", status, reason))
        if ticket._journal is not None:
            ticket._journal.shed(ticket.request.id, status)

    # ------------------------------------------------- breaker recovery

    def _recover(self) -> bool:
        """The circuit-breaker cycle, on this replica's own thread,
        entered after a declared failure (exception or watchdog stall;
        tickets already stolen and failed over by the gateway): reset
        the engine, wait out the exponential backoff, run a PROBE
        generation, and either rejoin the routing set (re-earning the
        watchdog's watch) or go around again. ``quarantine_after``
        consecutive failures (probe failures included) quarantine the
        replica — parked out of the rotation until shutdown. Returns
        False when the gateway is stopping: the thread exits."""
        gw = self.gateway
        first = True
        while True:
            try:
                # first lap: wait out any in-flight _fail_replica (the
                # lease-expiry route runs on the monitor thread) — its
                # _claim_parked must adopt the agent-side session
                # BEFORE this hard reset wipes it
                with self.fail_lock if first \
                        else contextlib.nullcontext():
                    self.server.reset()  # pending + _live + slots
                # together: slots alone would leave engine ghosts
                # decoding phantom results for tickets now re-running
                # elsewhere
            except Exception:
                log.exception("replica %d engine reset failed", self.index)
            first = False
            if self.consecutive_failures >= gw.quarantine_after:
                with self.cv:
                    if self.state != QUARANTINED:
                        self.state = QUARANTINED
                        gw._note_quarantine(self)
                    while not self._stop:  # out of the rotation for
                        # good; park so drain() can still join us
                        self.cv.wait(timeout=gw._beat_interval_s)
                        # refresh like the backoff loop: the thread is
                        # alive and parked BY DESIGN — /healthz must
                        # not show an unboundedly climbing age that
                        # reads as a dead thread
                        self.last_beat = time.monotonic()
                    self._exited = True
                return False
            backoff = min(gw.breaker_max_s, gw.breaker_base_s
                          * (2 ** max(0, self.consecutive_failures - 1)))
            deadline = time.monotonic() + backoff
            with self.cv:
                while not self._stop and time.monotonic() < deadline:
                    self.cv.wait(timeout=min(gw._beat_interval_s,
                                             backoff))
                    self.last_beat = time.monotonic()
                if self._stop:
                    self._exited = True
                    return False
                self.state = PROBING
            self.probes += 1
            gw._note_probe(self)
            t0 = time.monotonic()
            try:
                # a real (tiny) generation through the same engine paths
                # traffic takes — prefill, decode, evict. The fault
                # plan's hooks fire here too, so a ``times=-1`` fault
                # keeps a replica down through every probe.
                self.server.submit(Request([1], max_new_tokens=2,
                                           id="__probe__"))
                for _ in range(64):
                    self.server.step()
                    if self.server.done:
                        break
                else:
                    raise RuntimeError("probe did not finish in 64 steps")
                took = time.monotonic() - t0
                if took > gw.stall_timeout_s:
                    # a wedged-but-eventually-returning probe is a
                    # failed probe: real traffic would have stalled
                    raise RuntimeError(f"probe wedged for {took:.1f}s")
                self.server.reset()
            except Exception as e:  # noqa: BLE001 — ANY probe failure
                # means another breaker lap, never a crashed supervisor
                log.warning("replica %d probe failed: %s: %s",
                            self.index, type(e).__name__, e)
                self.consecutive_failures += 1
                with self.cv:
                    self.state = BROKEN
                continue
            with self.cv:
                self.state = HEALTHY
                self.last_beat = time.monotonic()
            self.rejoins += 1
            gw._note_rejoin(self)
            log.warning("replica %d probe succeeded: rejoining the "
                        "routing set", self.index)
            return True

    def stats(self, include_dispatch: bool = False) -> dict:
        # NOTE: no queue_signals() here — stats() runs on the
        # per-request MetricsStore push (every completion/shed), and
        # the oldest-wait scan is O(queue depth) under the cv. The
        # snapshot path merges the queue block in itself, once per
        # scrape (Gateway.snapshot).
        server = self.server  # single read: remove_replica nulls the
        # attribute concurrently, and a check-then-access would race
        out = {
            "replica": self.index,
            "role": self.role,
            "queued": self.n_queued,
            "enqueued": self.enqueued,
            "active_slots": server.slots.n_active
            if server is not None else 0,
            "batch_size": server.slots.batch_size
            if server is not None else 0,
            "outstanding_tokens": self.outstanding,
            "completed": self.completed,
            "shed": self.shed,
            # supervision: state is a string (MetricsStore's numeric
            # filter drops it; /stats and /healthz carry it)
            "state": self.state,
            "epoch": self.epoch,
            "heartbeat_age_s": round(time.monotonic() - self.last_beat, 3),
            "failures": self.failures,
            "consecutive_failures": self.consecutive_failures,
            "probes": self.probes,
            "rejoins": self.rejoins,
        }
        # engine counters (prefills, decode_steps, dispatches, the
        # prefix_* family) flat, so the MetricsStore numeric filter and
        # /stats both carry them per replica
        if server is not None:
            out.update(server.counters())
        # remote replicas: the transport block (rtt, heartbeat age,
        # reconnects, retries, stale-epoch drops) — nested, so the
        # MetricsStore numeric filter skips it while /stats and
        # /metrics carry it
        ts = getattr(server, "transport_stats", None)
        if ts is not None:
            out["transport"] = ts()
            # the obs-pull channel's health (remote stubs only) — an
            # EXPLICIT block, so "idle replica" and "unobserved
            # replica" are distinguishable from a dashboard
            obs = getattr(server, "obs_stats", None)
            if callable(obs):
                out["obs"] = obs()
        # sharded replicas: mesh topology + per-chip
        # residency — nested, so the MetricsStore numeric filter skips
        # it while /stats carries it (the flat mesh_* counters above
        # feed MetricsStore). Remote stubs have no mesh_info; their
        # agents' counters carry the flat twins over the wire.
        mi = getattr(server, "mesh_info", None)
        if callable(mi):
            m = mi()
            if m is not None:
                out["mesh"] = m
        # the per-replica radix summary (nested — the MetricsStore
        # numeric filter skips it): entry/byte/shape counts the
        # affinity router's decisions can be audited against. Behind
        # include_dispatch like the timeline block: the nodes/depth
        # walk is O(tree) and must not run on every completion's
        # metrics push. Remote stubs carry ``prefix = True`` (a
        # bool), hence the stats() duck check.
        if include_dispatch and server is not None:
            prefix = getattr(server, "prefix", None)
            if prefix is not None and hasattr(prefix, "stats"):
                out["prefix"] = prefix.stats()
            tier = getattr(server, "host_tier", None)
            if tier is not None:
                out["kv_host"] = tier.stats()
        # per-dispatch timeline aggregates (kind -> count/ms/compile
        # split/tokens) — opt-in: snapshot() wants it, but the
        # per-request MetricsStore push (whose numeric filter would
        # drop the nested dict anyway) must not pay a summary build on
        # every completion
        if include_dispatch and server is not None \
                and server.timeline is not None:
            out["dispatch"] = server.timeline.summary()
        return out


def _percentile(sorted_vals: list, q: float) -> float:
    if not sorted_vals:
        return 0.0
    i = min(len(sorted_vals) - 1, int(q * (len(sorted_vals) - 1) + 0.5))
    return sorted_vals[i]


class _Stats:
    """Rolling per-request window + monotonic counters behind /stats."""

    def __init__(self, window: int = 1024):
        self.lock = threading.Lock()
        self.window: deque[dict] = deque(maxlen=window)
        # LIFETIME latency distributions in fixed buckets (seconds) —
        # the /metrics form a scraper can rate() and aggregate, where
        # the rolling window's exact percentiles cannot; both are fed
        # from the same per-request record so they can never disagree
        self.hist = {key: Histogram()
                     for key in ("queue_wait", "ttft", "tpot", "e2e")}
        self.accepted = 0
        self.completed = 0
        self.shed_by_status: dict[int, int] = {}
        # per-tier admission accounting (WFQ observability): lifetime
        # completed/shed counts plus a queue-wait histogram per tier —
        # the surface that proves batch cannot starve interactive
        self.completed_by_tier: dict[str, int] = {}
        self.shed_by_tier: dict[str, int] = {}
        self.tier_wait: dict[str, Histogram] = {}
        self.quota_rejections = 0
        self.tokens_in = 0
        self.tokens_out = 0
        self.prefix_hit_tokens = 0
        self.prefill_tokens_saved = 0
        self.drafted = 0
        self.draft_accepted = 0
        # supervision (the TonY retry-counter analog)
        self.replica_failures = 0  # HEALTHY -> BROKEN transitions
        self.failovers = 0         # tickets requeued onto another replica
        self.retries = 0           # failed engine runs charged to tickets
        self.probes = 0
        self.rejoins = 0
        self.quarantines = 0
        # elasticity (the TonY acquire/release loop): runtime
        # membership changes, however triggered (autoscaler or a
        # direct add_replica/remove_replica call)
        self.replicas_added = 0
        self.replicas_removed = 0
        # disaggregation: routing decisions won by the
        # prefix-affinity probe, and prefill->decode handoffs relayed
        self.prefix_routed = 0
        self.handoffs = 0
        # live migration: sessions relayed mid-stream to a
        # new replica (retirement drain, scale-down defrag, or a
        # migrate_session rebalance). ``migrate_carry`` holds the
        # migration counters of replicas that RETIRED — the out-side
        # of a retirement drain lives on the engine being released, so
        # without the carry every scale-down would erase its own
        # ledger from /stats
        self.migrations = 0
        self.migrate_carry: dict[str, float] = {}
        # frozen snapshots a FAILOVER adopted instead of re-running
        # from the prompt (the extract-vs-steal lease, this PR): each
        # one is a mid-stream crash whose victim resumed token-exact
        # with no recompute
        self.migrate_lease_adoptions = 0
        # crash recovery: ``--recover`` boots that replayed
        # a journal, and what happened to each live entry — adopted
        # mid-stream off a parked agent session (zero re-prefill),
        # re-run from the prompt (local engine died with the process),
        # or materialized from a finished-but-undelivered result.
        # ``park_adoptions`` counts the FAILOVER flavor: a live-crash
        # failover that found the victim's session parked on its agent
        # and resumed it instead of re-running.
        self.recoveries = 0
        self.sessions_adopted = 0
        self.sessions_rerun = 0
        self.recovered_finished = 0
        self.recovery_wall_ms = 0.0
        self.park_adoptions = 0
        # the flight recorder: alert-triggered debug
        # bundles dumped into the history job dir
        self.bundles_written = 0
        self.last_bundle = ""

    def snapshot(self) -> dict:
        with self.lock:
            recent = list(self.window)
            out = {
                "accepted": self.accepted,
                "completed": self.completed,
                "shed": dict(self.shed_by_status),
                "tokens_in": self.tokens_in,
                "tokens_out": self.tokens_out,
                "prefix_hit_tokens": self.prefix_hit_tokens,
                "prefill_tokens_saved": self.prefill_tokens_saved,
                "drafted": self.drafted,
                "draft_accepted": self.draft_accepted,
            }
        for key in ("queue_wait_ms", "ttft_ms", "tpot_ms", "e2e_ms"):
            vals = sorted(r[key] for r in recent)
            out[key] = {"p50": _percentile(vals, 0.50),
                        "p95": _percentile(vals, 0.95),
                        "p99": _percentile(vals, 0.99)}
        out["window"] = len(recent)
        return out


class GatewayHistory:
    """Portal hookup: the gateway as a browsable history job.

    Writes the coordinator's on-disk layout (``events/history.py``)
    under ``<history>/intermediate/<app_id>/``: an in-progress
    ``.jhist.jsonl`` event log (inited/finished) plus per-request
    metric rows in ``metrics/requests.jsonl`` — the portal's existing
    /job/<id>/metrics page renders them with zero portal changes, and
    the history mover/purger manage the directory like any other job's.
    """

    def __init__(self, history_root: str, app_id: str = "",
                 n_replicas: int = 1):
        from tony_tpu_torch.events import history
        from tony_tpu_torch.events.event import application_inited

        self._lock = threading.Lock()
        started = int(time.time() * 1000)
        self.app_id = app_id or f"application_gateway_{started}"
        self.started = started
        self.job_dir = history.intermediate_dir(history_root, self.app_id)
        os.makedirs(os.path.join(self.job_dir, "metrics"), exist_ok=True)
        self.jhist = os.path.join(
            self.job_dir, history.inprogress_name(self.app_id, started))
        self._append_event(application_inited(
            self.app_id, n_replicas, os.uname().nodename))
        self._metrics_path = os.path.join(self.job_dir, "metrics",
                                          "requests.jsonl")
        self._traces_path = os.path.join(self.job_dir, "metrics",
                                         "traces.jsonl")
        self._scaling_path = os.path.join(self.job_dir, "metrics",
                                          "scaling.jsonl")
        self._alerts_path = os.path.join(self.job_dir, "metrics",
                                         "alerts.jsonl")
        self._autotune_path = os.path.join(self.job_dir, "metrics",
                                           "autotune.jsonl")
        self._bundles_path = os.path.join(self.job_dir, "metrics",
                                          "bundles.jsonl")
        self._rebalance_path = os.path.join(self.job_dir, "metrics",
                                            "rebalance.jsonl")

    def _append_event(self, event) -> None:
        with self._lock, open(self.jhist, "a") as f:
            f.write(json.dumps(event.to_dict()) + "\n")

    def record(self, row: dict) -> None:
        with self._lock, open(self._metrics_path, "a") as f:
            f.write(json.dumps(row) + "\n")

    def record_trace(self, doc: dict) -> None:
        """One finished request's Chrome trace-event doc, one JSON doc
        per line — keyed by the same request id requests.jsonl rows
        carry, so the portal (or an operator's jq) links them."""
        with self._lock, open(self._traces_path, "a") as f:
            f.write(json.dumps(doc) + "\n")

    def record_scaling(self, row: dict) -> None:
        """One autoscaler decision (action, reason, the signals it
        read) in ``metrics/scaling.jsonl`` — rendered by the portal's
        metrics page next to requests.jsonl, so an operator can answer
        "why did the fleet grow at 14:02" from the job history."""
        with self._lock, open(self._scaling_path, "a") as f:
            f.write(json.dumps(row) + "\n")

    def record_alert(self, row: dict) -> None:
        """One alert fire/resolve transition in
        ``metrics/alerts.jsonl`` — the portal's metrics page renders
        it next to requests/scaling, so "what was alerting at 14:02"
        is answerable from the job history."""
        with self._lock, open(self._alerts_path, "a") as f:
            f.write(json.dumps(row) + "\n")

    def record_autotune(self, row: dict) -> None:
        """One shape-controller actuation (knob, from -> to, the
        ledger signals that justified it, whether it paid a new
        compile) in ``metrics/autotune.jsonl`` — "why did chunk depth
        change at 14:02" is answerable from the job history."""
        with self._lock, open(self._autotune_path, "a") as f:
            f.write(json.dumps(row) + "\n")

    def record_rebalance(self, row: dict) -> None:
        """One rebalancer decision (move/no_victim/move_failed, the
        occupancy it saw) in ``metrics/rebalance.jsonl`` — "why did
        request 17 jump replicas at 14:02" is answerable from the job
        history."""
        with self._lock, open(self._rebalance_path, "a") as f:
            f.write(json.dumps(row) + "\n")

    def write_bundle(self, doc: dict) -> str:
        """One debug bundle (the flight recorder: active
        alerts, recent traces incl. remote spans, per-replica
        dispatch/goodput/transport/obs blocks, scale signals) as a
        SINGLE self-contained JSON file under ``<job dir>/bundles/``
        — the TonY job-history story at incident granularity: a 3 a.m.
        alert leaves a record the portal (or plain jq) can browse
        after the fleet is long gone. Named by wall-clock ms + the
        triggering alerts, written atomically (tmp + rename) so a
        reader never sees a torn bundle."""
        bundles = os.path.join(self.job_dir, "bundles")
        os.makedirs(bundles, exist_ok=True)
        slug = "-".join(str(t) for t in doc.get("trigger") or ()) \
            or doc.get("reason", "manual")
        slug = "".join(c if c.isalnum() or c in "-_" else "_"
                       for c in slug)[:64]
        path = os.path.join(
            bundles, f"bundle-{int(time.time() * 1000)}-{slug}.json")
        tmp = path + ".tmp"
        with self._lock:
            with open(tmp, "w") as f:
                json.dump(doc, f)
            os.replace(tmp, path)
        # one POINTER row in metrics/bundles.jsonl per dump: the
        # portal's metrics page renders metrics/*.jsonl with zero
        # portal changes (the alerts.jsonl pattern), so the 3 a.m.
        # incident shows up in the job's browsable history with its
        # trigger, headline numbers, and the bundle file to open
        alerts = doc.get("alerts") or {}
        with self._lock, open(self._bundles_path, "a") as f:
            f.write(json.dumps({
                "t": doc.get("t_wall"),
                "reason": doc.get("reason"),
                "trigger": ",".join(str(t) for t in
                                    doc.get("trigger") or ()),
                "active_alerts": len(alerts.get("active") or ()),
                "replicas": len(doc.get("replicas") or ()),
                "traces": (doc.get("traces") or {}).get("count", 0),
                "path": path,
            }) + "\n")
        return path

    def close(self, status: str = "SUCCEEDED",
              metrics: dict | None = None) -> None:
        from tony_tpu_torch.events import history
        from tony_tpu_torch.events.event import application_finished

        self._append_event(application_finished(
            self.app_id, status, 0, metrics or {}))
        completed = int(time.time() * 1000)
        final = os.path.join(self.job_dir, history.finished_name(
            self.app_id, self.started, completed,
            os.environ.get("USER", "unknown"), status))
        with self._lock:
            os.replace(self.jhist, final)


class _AlertLoop(threading.Thread):
    """The alert bus's evaluation cadence: one consistent
    ``Gateway.alert_signals()`` read per tick through
    ``AlertBus.evaluate()``, transitions logged and appended to
    history ``metrics/alerts.jsonl``. Daemon + stop-event so drain()
    shuts it down before the fleet join (an alert evaluated against a
    half-drained fleet would be noise)."""

    def __init__(self, gateway: "Gateway", interval_s: float):
        super().__init__(name="gateway-alerts", daemon=True)
        self.gateway = gateway
        self.interval_s = max(0.05, interval_s)
        self._stop = threading.Event()

    def stop(self) -> None:
        self._stop.set()

    def run(self) -> None:
        gw = self.gateway
        while not self._stop.wait(self.interval_s):
            try:
                events = gw.alerts.evaluate(gw.alert_signals())
            except Exception:
                log.exception("alert evaluation failed")
                continue
            for ev in events:
                (log.warning if ev.state == "firing" else log.info)(
                    "alert %s %s: %s %s", ev.alert, ev.state.upper(),
                    ev.message, ev.detail)
                if gw.history is not None:
                    try:
                        gw.history.record_alert(ev.to_row())
                    except Exception:
                        log.exception("history alert write failed")
            # the flight recorder: a FIRING transition dumps
            # one self-contained debug bundle into the history job dir
            # — the bus's fire-once dedup is the debounce (no re-dump
            # while the alert stays active), and dump failures are
            # logged, never allowed to take the alert loop down
            firing = [ev.alert for ev in events if ev.state == "firing"]
            if firing and gw.bundle_on_alert:
                gw.dump_bundle(reason="alert", trigger=firing)


class _AutotuneLoop(threading.Thread):
    """The adaptive shape controller's cadence (serve/autotune.py):
    one ``AutotuneController.tick()`` per interval over the LIVE local
    replicas, actuations logged and appended to history
    ``metrics/autotune.jsonl``. Daemon + stop-event, stopped by
    drain() before the fleet join — an actuation mid-shutdown would
    only churn compile state the process is about to drop."""

    def __init__(self, gateway: "Gateway", interval_s: float):
        super().__init__(name="gateway-autotune", daemon=True)
        self.gateway = gateway
        self.interval_s = max(0.05, interval_s)
        self._stop = threading.Event()

    def stop(self) -> None:
        self._stop.set()

    def run(self) -> None:
        gw = self.gateway
        while not self._stop.wait(self.interval_s):
            try:
                replicas = [(r.index, r.server)
                            for r in gw.live_replicas]
                decisions = gw.autotune.tick(replicas)
            except Exception:
                log.exception("autotune tick failed")
                continue
            for row in decisions:
                if gw.history is not None:
                    try:
                        gw.history.record_autotune(row)
                    except Exception:
                        log.exception("history autotune write failed")


class Gateway:
    """The front door over N replica servers. See the module docstring
    for the full story; the API surface:

    - ``submit(req, on_event=None) -> Ticket`` (raises ``Shed``)
    - ``drain()`` then ``stop()`` — or just ``stop()`` (drains)
    - ``snapshot()`` — the /stats payload
    - ``ready`` / ``draining`` — the /readyz signal
    """

    def __init__(self, servers: list[Server], *, max_queue: int = 128,
                 default_ttl_s: float | None = None,
                 metrics_store=None, history: GatewayHistory | None = None,
                 max_attempts: int = 3, stall_timeout_s: float = 30.0,
                 breaker_base_s: float = 0.25, breaker_max_s: float = 8.0,
                 quarantine_after: int = 5, tracing: bool = True,
                 trace_capacity: int = 256,
                 profile_dir: str | None = None,
                 tier_weights: dict[str, float] | str | None = None,
                 tenant_quota_rate: float = 0.0,
                 tenant_quota_burst: float = 0.0,
                 alerts: bool = True, alert_interval_s: float = 1.0,
                 alert_thresholds: dict | None = None,
                 bundle_on_alert: bool = True,
                 roles: list | None = None,
                 prefix_affinity: bool = True,
                 autotune: bool = False,
                 autotune_interval_s: float = 1.0,
                 autotune_config: dict | None = None,
                 journal=None, park_ttl_s: float = 60.0):
        if not servers:
            raise ValueError("gateway needs at least one replica server")
        # disaggregated prefill/decode: ``roles`` names each
        # replica's pool ("prefill" runs admission/chunked-prefill only
        # and hands finished page lists to "decode" replicas). The
        # handoff unit is a page list, so every role-split replica must
        # serve the paged cache.
        self.roles = list(roles) if roles else None
        if self.roles:
            if len(self.roles) != len(servers):
                raise ValueError(
                    f"roles names {len(self.roles)} replicas, gateway "
                    f"has {len(servers)}")
            bad = set(self.roles) - {"prefill", "decode"}
            if bad:
                raise ValueError(f"unknown roles {sorted(bad)} "
                                 "(valid: prefill, decode)")
            if "prefill" not in self.roles or "decode" not in self.roles:
                raise ValueError("role split needs at least one "
                                 "prefill AND one decode replica")
            unpaged = [i for i, s in enumerate(servers)
                       if not getattr(s, "paged", False)]
            if unpaged:
                raise ValueError(
                    f"role split needs the paged KV cache on every "
                    f"replica (unpaged: {unpaged})")
        # prefix-affinity routing: send a request to the replica whose
        # radix tree holds its longest cached prefix (generalizes crc32
        # session affinity; degrades to least-outstanding). Off is the
        # A/B control for bench extras.disagg.
        self.prefix_affinity = bool(prefix_affinity)
        # admission tiers + quotas (gateway/admission.py): weights may
        # arrive as the CLI's "name=w,..." spec; quotas default OFF
        if isinstance(tier_weights, str):
            tier_weights = parse_tier_weights(tier_weights)
        self.tier_weights = dict(tier_weights) if tier_weights \
            else None  # None -> WFQueue's defaults
        if self.tier_weights is not None \
                and DEFAULT_TIER not in self.tier_weights:
            raise ValueError(
                f"tier weights must include the default tier "
                f"{DEFAULT_TIER!r} (got {sorted(self.tier_weights)})")
        self.quotas = TenantQuotas(tenant_quota_rate, tenant_quota_burst)
        self.replicas = [_Replica(i, s, self) for i, s in enumerate(servers)]
        if self.roles:
            for replica, role in zip(self.replicas, self.roles):
                replica.role = role
        # model bound captured once: replicas share the model config,
        # and a retired replica's released engine must not be the
        # thing submit() validates against
        self._max_seq_len = servers[0].model.cfg.max_seq_len
        self.max_queue = max(1, max_queue)
        self.default_ttl_s = default_ttl_s
        self.metrics_store = metrics_store
        self.history = history
        # supervision knobs (the TonY AM's heartbeat/retry settings,
        # serving flavor). stall_timeout_s must comfortably exceed one
        # step's WORST dispatch time (first-compile included when the
        # compile cache is cold) or healthy replicas get declared dead.
        self.max_attempts = max(1, max_attempts)
        self.stall_timeout_s = stall_timeout_s
        self.breaker_base_s = breaker_base_s
        self.breaker_max_s = breaker_max_s
        self.quarantine_after = max(1, quarantine_after)
        self._beat_interval_s = max(0.05, stall_timeout_s / 10)
        self._watchdog = None
        self.stats = _Stats()
        # request tracing (obs/trace.py): a bounded ring of finished
        # traces behind GET /debug/trace/<id>, optionally mirrored into
        # the history dir's metrics/traces.jsonl. tracing=False is the
        # overhead A/B knob (bench extras.obs) — the layer is cheap
        # enough to stay on in production.
        self.traces = TraceBuffer(trace_capacity) if tracing else None
        # on-demand serving profiles (profiler.ServeProfiler): armed by
        # POST /debug/profile, burned down by replica threads' working
        # iterations. Always constructed — an un-armed poll() is one
        # attribute read.
        from tony_tpu_torch.profiler import ServeProfiler

        if profile_dir is None and history is not None:
            profile_dir = os.path.join(history.job_dir, "profiles")
        self.profiler = ServeProfiler(profile_dir)
        self._lock = threading.Lock()
        self._drain_lock = threading.Lock()
        # in-flight frozen-snapshot leases (_SnapLease): keyed by
        # gateway request id, registered before every migrate extract,
        # claimed by _failover when the source dies mid-move
        self._snap_leases: dict = {}
        self._lease_lock = threading.Lock()
        self.migrate_lease_s = 5.0  # how long a failover waits for an
        #                             in-flight extract before falling
        #                             back to re-run-from-prompt
        self._drain_done: bool | None = None
        # crash-safe control plane: ``journal`` is the
        # write-ahead TicketJournal every admit/route/emit/terminal
        # rides (None = off); ``_resume`` is the request-id -> Ticket
        # registry behind GET /v1/stream/<id>?offset= — every admitted
        # ticket registers, terminals stay fetchable for ``park_ttl_s``
        # (the client-side twin of the agent's park TTL), then reap.
        self.journal = journal
        self.park_ttl_s = max(1.0, float(park_ttl_s))
        self._resume: dict = {}
        self._resume_lock = threading.Lock()
        self._t_recovered: float | None = None  # alert signal stamp
        self._host_cache: tuple[float, dict] | None = None
        self._started = False
        self._closed = False
        # an attached AutoScaler (autoscale.AutoScaler registers
        # itself): snapshot() surfaces its status block, drain() stops
        # its loop before closing the fleet
        self.scaler = None
        # an attached Rebalancer (gateway/rebalance.py registers
        # itself): the pressure-driven session-packing loop — same
        # snapshot/drain contract as the scaler
        self.rebalancer = None
        # the network face's connection-plane stats provider
        # (gateway/edge.py registers its snapshot fn) — the gateway core
        # knows nothing about sockets, but /stats and /metrics are the
        # one pane of glass, so the edge block rides the same snapshot
        self._edge_stats: Callable | None = None
        # the alert/event bus (obs/alerts.py): a rule engine evaluated
        # on the same consistent snapshot the autoscaler reads, firing
        # deduplicated fire/resolve events into /stats ``alerts``,
        # /metrics ``tony_alerts_*``, and history metrics/alerts.jsonl.
        # alerts=False is the A/B knob (bench extras.goodput).
        self.alerts = AlertBus(default_rules(alert_thresholds)) \
            if alerts else None
        self._alert_loop = _AlertLoop(self, alert_interval_s) \
            if alerts else None
        # the flight recorder: a firing alert dumps one
        # debug bundle into the history job dir (needs history for a
        # place to land; GET /debug/bundle works regardless)
        self.bundle_on_alert = bool(bundle_on_alert)
        # the adaptive shape controller (serve/autotune.py):
        # samples each local replica's goodput/timeline deltas and
        # steers chunk_steps / speculate_k / prefill_chunk within
        # bounds. Off by default — it is the --autotune opt-in; every
        # decision lands in /stats engine.autotune, tony_autotune_*
        # metrics, and history metrics/autotune.jsonl.
        from tony_tpu_torch.serve.autotune import AutotuneController

        self.autotune = AutotuneController(**(autotune_config or {})) \
            if autotune else None
        self._autotune_loop = _AutotuneLoop(self, autotune_interval_s) \
            if autotune else None

    # --------------------------------------------------------- lifecycle

    def start(self) -> "Gateway":
        from tony_tpu_torch.coordinator.liveness import LivenessMonitor

        # the watchdog IS the coordinator's LivenessMonitor (the TonY
        # AM heartbeat expiry machinery): expiry = stall_timeout_s,
        # checked at a 1/5 cadence. It catches the failure exceptions
        # cannot: a dispatch that WEDGES instead of raising.
        self._watchdog = LivenessMonitor(
            interval_ms=max(1, int(self.stall_timeout_s * 1000 / 5)),
            max_missed=5, on_expired=self._on_stall).start()
        for r in self.replicas:
            self._watchdog.register(str(r.index))
            r.start()
        if self._alert_loop is not None:
            self._alert_loop.start()
        if self._autotune_loop is not None:
            self._autotune_loop.start()
        self._started = True
        return self

    @property
    def ready(self) -> bool:
        return self._started and not self._closed

    @property
    def draining(self) -> bool:
        return self._closed

    def drain(self, timeout: float | None = None) -> bool:
        """Graceful shutdown: stop admitting (submit -> 503), let every
        replica finish its queue and in-flight slots, join the threads.
        Returns True when everything drained inside ``timeout``.
        Idempotent — a second call (stop() after drain()) returns the
        first outcome instead of re-finalizing the history job."""
        scaler = self.scaler
        if scaler is not None:
            # stop the control loop FIRST: a scale-up racing the drain
            # would find _closed and fail, but there is no reason to
            # let it try — and a scale-down's remove_replica must not
            # interleave with the fleet-wide join below
            scaler.stop()
        rebalancer = self.rebalancer
        if rebalancer is not None:
            # same reasoning: migrating sessions around a fleet that
            # is about to join is churn at best, a stranded frozen
            # snapshot at worst
            rebalancer.stop()
        if self._alert_loop is not None:
            # same reasoning: an alert evaluated over a half-joined
            # fleet is noise, and the history file is about to close
            self._alert_loop.stop()
        if self._autotune_loop is not None:
            # actuating shapes on a fleet about to join is pure churn
            self._autotune_loop.stop()
        with self._drain_lock:
            if self._drain_done is not None:
                return self._drain_done
            self._closed = True
            for r in self.replicas:
                r.signal_stop()
            deadline = None if timeout is None \
                else time.monotonic() + timeout
            ok = True
            for r in self.replicas:
                left = None if deadline is None \
                    else max(0.0, deadline - time.monotonic())
                r.join(left)
                ok = ok and not r._thread.is_alive()
            # stop the watchdog only AFTER the join: a dispatch that
            # wedges while its replica drains still gets declared
            # stalled and its tickets failed over (or terminal-shed
            # 503 once every other replica has exited) — the
            # no-stranded-ticket promise holds through shutdown. A
            # replica that finishes its queue and exits unregisters
            # itself, so a busy-but-progressing final join is never
            # misread as a stall.
            wd = self._watchdog
            self._watchdog = None
            if wd is not None:
                wd.stop()
            # remote replicas: stop lease/heartbeat machinery after
            # the fleet join (attached agents keep running — they
            # belong to whoever started them; launched agents are
            # drained and reaped)
            from tony_tpu_torch.gateway.remote import close_server

            for r in self.replicas:
                close_server(r.server, f"replica {r.index} drain")
            # a profile capture left mid-flight (operator armed it,
            # traffic stopped) is finalized so its trace file lands
            self.profiler.close()
            if self.journal is not None:
                # clean drain COMPACTS the WAL (every request reached
                # a terminal -> empty file; the next --recover finds
                # nothing to do); a drain that timed out leaves the
                # journal whole — those stragglers are exactly what
                # recovery should see
                try:
                    self.journal.close(compact=ok)
                except Exception:
                    log.exception("journal close failed")
            if self.history is not None:
                self.history.close("SUCCEEDED" if ok else "KILLED",
                                   self.stats.snapshot())
            self._drain_done = ok
            return ok

    def stop(self, timeout: float | None = None) -> bool:
        return self.drain(timeout)

    # -------------------------------------------------------- elasticity

    @property
    def live_replicas(self) -> list[_Replica]:
        """Replicas that are part of the fleet: not retired, not mid
        scale-down drain. (Routability is stricter — see ``_route``.)"""
        return [r for r in self.replicas
                if not r.retired and not r.retiring]

    def add_replica(self, server: Server, *, probe: bool = True) -> int:
        """Grow the fleet at runtime (the autoscaler's scale-up
        primitive; also a valid operator call). With ``probe=True``
        (the default, and the only setting the autoscaler uses) the
        new replica enters through the circuit breaker's PROBE path:
        it starts BROKEN, runs a real tiny generation through the
        traffic code paths — paying its first compiles off the traffic
        path — and joins routing only when that probe succeeds,
        exactly the way a recovered replica re-earns admission.
        Returns the new replica's index."""
        if not self._started:
            raise RuntimeError("add_replica() needs a started gateway")
        with self._lock:
            if self._closed:
                raise GatewayClosed("gateway is draining")
            replica = _Replica(len(self.replicas), server, self)
            replica.spawned = True
            if probe:
                replica.state = BROKEN  # joins routing via _recover()
            self.replicas.append(replica)
        if not probe:
            wd = self._watchdog  # snapshot (see _beat)
            if wd is not None:
                wd.register(str(replica.index))
        replica.start(probe_first=probe)
        with self.stats.lock:
            self.stats.replicas_added += 1
        log.warning("replica %d added (%s)", replica.index,
                    "probe admission" if probe else "immediate")
        return replica.index

    def remove_replica(self, index: int,
                       timeout: float | None = None) -> bool:
        """Shrink the fleet at runtime over the existing ZERO-LOSS
        drain: the replica leaves routing immediately (``retiring`` —
        new submits re-route, the enqueue race re-routes), MIGRATES
        its work to the survivors — queued tickets re-route untouched,
        live decode slots freeze into ``SessionSnapshot``s and resume
        mid-stream elsewhere, token-exact — then parks
        RETIRED with its engine released (the KV cache's memory goes
        back to the provisioner's account). What cannot migrate (an
        unpaged engine, a request mid-prefill, no healthy taker) is
        finished here, so the drain time is bounded by the slowest
        FREEZE rather than the longest remaining generation whenever
        migration applies. A dispatch that wedges during the drain
        still fails over: the watchdog keeps watching until the
        thread is joined. Refuses to remove the last live replica.
        Returns True when the drain completed inside ``timeout``."""
        replica = self.replicas[index]  # IndexError = caller bug
        with self._lock:
            if replica.retired:
                return True
            live = self.live_replicas
            if replica in live and len(live) <= 1:
                raise ValueError(
                    "cannot remove the last live replica (drain() the "
                    "gateway instead)")
            with replica.cv:
                replica.retiring = True
                replica.cv.notify_all()
        replica.signal_stop()
        replica.join(timeout)
        if replica._thread.is_alive():
            # still draining past the deadline: leave it retiring (out
            # of routing, still finishing work) — the caller may retry
            return False
        self._unwatch(replica)
        with replica.cv:
            replica.retired = True
            replica.state = RETIRED
            # release the engine: the whole point of scale-down is
            # giving the KV cache + weights references back; stats()
            # and busy() guard against the None
            server = replica.server
            replica.server = None
        # fold the departing engine's migration ledger into the carry
        # before the reference is dropped — the out-side of the drain
        # it just performed is counted on IT
        try:
            counts = server.counters() if server is not None else {}
        except Exception:
            counts = {}
        with self.stats.lock:
            for key in ("migrations_out", "migrations_in",
                        "migrations_local", "migrations_remote",
                        "migrate_pages_moved", "migrate_bytes_avoided",
                        "migrate_bytes_wire", "migrate_delta_in",
                        "migrate_freeze_resume_ms"):
                if counts.get(key):
                    self.stats.migrate_carry[key] = \
                        self.stats.migrate_carry.get(key, 0) \
                        + counts[key]
        # remote replicas: stop the stub's lease/heartbeat machinery
        # (and, for agents the stub launched, drain + reap the agent
        # process) — a retired replica must not keep pinging a host
        from tony_tpu_torch.gateway.remote import close_server

        close_server(server, f"replica {index} retire")
        with self.stats.lock:
            self.stats.replicas_removed += 1
        log.warning("replica %d retired (zero-loss drain complete)",
                    index)
        return True

    def scale_signals(self) -> dict:
        """One consistent read of everything the autoscaler watches:
        queue pressure (depth / oldest wait / enqueue rate), capacity
        sheds, the TTFT histogram (SLO burn is computed from deltas of
        it), occupancy, and KV page pressure. Also the source of the
        /stats ``queue`` block, so the autoscaler and a human reading
        /stats see the same numbers."""
        now = time.monotonic()
        live = self.live_replicas
        queue = self._queue_block(live, now)
        servers = [s for s in (r.server for r in live) if s is not None]
        counts = [s.counters() for s in servers]
        with self.stats.lock:
            # capacity sheds only: quota 429s are policy, not pressure
            # — an autoscaler feeding on them would grow the fleet to
            # chase a tenant's rate limit
            shed_capacity = sum(
                n for status, n in self.stats.shed_by_status.items()
                if status in (429, 503, 504)) - self.stats.quota_rejections
        return {
            "now": now,
            "replicas_live": len(live),
            "replicas_routable": sum(1 for r in live
                                     if r.state == HEALTHY),
            **queue,
            "active_slots": sum(s.slots.n_active for s in servers),
            "slots": sum(s.slots.batch_size for s in servers),
            "shed_capacity_total": max(0, shed_capacity),
            "ttft_hist": self.stats.hist["ttft"].snapshot(),
            "kv_pages_total": sum(c.get("kv_pages_total", 0)
                                  for c in counts),
            "kv_pages_free": sum(c.get("kv_pages_free", 0)
                                 for c in counts),
            "kv_pages_reserved": sum(c.get("kv_pages_reserved", 0)
                                     for c in counts),
            # host-tier restore traffic (cumulative bytes): the
            # kv_host_thrash alert diffs this per tick against the
            # pressure condition above
            "kv_host_page_in_bytes": sum(
                c.get("kv_host_page_in_bytes", 0) for c in counts),
        }

    def rebalance_signals(self) -> dict:
        """One consistent read of everything the rebalancer watches:
        per-replica slot occupancy, queue depth, and the in-flight
        ticket set (request id, prompt for the prefix-heat probe,
        remaining work for the tie-break). Only HEALTHY replicas with
        a live engine appear — a broken or retiring replica is the
        failover/retirement machinery's problem, not a packing
        target."""
        now = time.monotonic()
        rows = []
        for r in self.live_replicas:
            server = r.server  # single read vs concurrent retirement
            if server is None or r.state != HEALTHY:
                continue
            with r.cv:
                tickets = [
                    {"rid": t.request.id,
                     "prompt": list(t.request.prompt),
                     "remaining": max(
                         0, t.request.max_new_tokens - t._n_emitted)}
                    for t in r._tickets.values()
                    if t.request.id is not None]
            rows.append({
                "index": r.index,
                "active": server.slots.n_active,
                "slots": server.slots.batch_size,
                "depth": r.queue_signals(now)["depth"],
                "outstanding": r.outstanding,
                "tickets": tickets,
            })
        return {"now": now, "replicas": rows}

    def alert_signals(self) -> dict:
        """``scale_signals()`` plus what the alert rules additionally
        watch (breaker failure counts, replica states, fleet goodput,
        token flow) — ONE consistent read, so an alert and a scale
        decision can never disagree about the fleet they saw."""
        sig = self.scale_signals()
        live = self.live_replicas
        with self.stats.lock:
            sig["replica_failures"] = self.stats.replica_failures
            sig["completed"] = self.stats.completed
            sig["tokens_out"] = self.stats.tokens_out
        sig["states"] = [r.state for r in live]
        # the connection-plane's sheds (closing a
        # ROADMAP gap): 429s the EDGE refused at its connection cap
        # never reached admission, so without this row a pure
        # connection storm was invisible to the shed-storm alert
        edge = self._edge_stats
        conn_sheds = 0
        if edge is not None:
            try:
                conn_sheds = int(
                    (edge() or {}).get("conn_limit_sheds", 0))
            except Exception:
                conn_sheds = 0
        sig["edge_conn_limit_sheds"] = conn_sheds
        # a recent --recover boot (fires the one-shot recovery alert:
        # operators should KNOW the gateway came back from a crash)
        t_rec = self._t_recovered
        sig["recovered_ago_s"] = None if t_rec is None \
            else round(time.monotonic() - t_rec, 3)
        fleet = self.fleet_goodput(live)
        if fleet:
            sig["goodput_useful"] = fleet.get("useful_fraction")
            # raw milliseconds, not fractions: the collapse rule
            # needs per-tick DELTAS of useful vs dispatch time (a
            # cumulative fraction decays during idle lulls with
            # nothing wrong; a wall denominator reads trickle traffic
            # as collapse)
            sig["goodput_dispatch_ms"] = fleet.get("dispatch_ms")
            sig["goodput_useful_ms"] = sum(
                v for k, v in fleet.get("ms", {}).items()
                if k.startswith("useful."))
        else:
            sig["goodput_useful"] = None
            sig["goodput_dispatch_ms"] = None
            sig["goodput_useful_ms"] = None
        return sig

    def fleet_goodput(self, live: list | None = None) -> dict:
        """Fleet goodput ledger: per-replica ledgers merged weighted
        by wall clock (obs/goodput.merge_ledgers). Empty dict when no
        replica runs a timeline."""
        replicas = live if live is not None else self.live_replicas
        ledgers = []
        for r in replicas:
            server = r.server  # single read vs concurrent retirement
            if server is not None:
                ledgers.append(server.goodput())
        return merge_ledgers(ledgers)

    def goodput_report(self) -> dict:
        """The ``GET /debug/goodput`` payload: the fleet ledger with
        its single largest waste bucket named, plus each replica's own
        ledger (per-kind bytes/FLOPs and HBM-BW%/MFU where a roofline
        reference exists — null on CPU)."""
        live = self.live_replicas
        per_replica = []
        for r in live:
            server = r.server
            if server is None:
                continue
            g = server.goodput()
            if g is not None:
                g["replica"] = r.index
                per_replica.append(g)
        fleet = merge_ledgers(per_replica)
        return {
            "enabled": bool(per_replica),
            "fleet": fleet,
            "largest_waste": fleet.get("largest_waste"),
            "replicas": per_replica,
        }

    # --------------------------------------- fleet observability (15)

    @property
    def has_local_replicas(self) -> bool:
        """True when any live replica's engine runs IN THIS process —
        the gate for arming the gateway's own ``ServeProfiler``: a
        pure-router fleet (every replica remote) has no local device work
        worth capturing, and a stuck local arm must not be able to
        409-block the remote fan-out forever."""
        return any(getattr(r.server, "transport", None) is None
                   for r in self.live_replicas if r.server is not None)

    @property
    def has_remote_replicas(self) -> bool:
        return any(getattr(r.server, "transport", None) is not None
                   for r in self.live_replicas)

    def _remote_profile_fanout(self, call) -> dict:
        """Run ``call(server) -> dict`` against every remote replica
        CONCURRENTLY (each call handles its own errors): the per-host
        results are independent, and N sequential timeouts against a
        half-dead fleet — exactly when an operator profiles — would
        tie a gateway handler thread up for N x timeout."""
        import concurrent.futures

        targets = [r.server for r in self.live_replicas
                   if getattr(r.server, "transport", None) is not None]
        if not targets:
            return {}
        with concurrent.futures.ThreadPoolExecutor(
                max_workers=min(8, len(targets))) as pool:
            futures = [(s.host_addr, pool.submit(call, s))
                       for s in targets]
            return {addr: fut.result() for addr, fut in futures}

    def arm_remote_profiles(self, steps: int) -> dict:
        """The remote half of ``POST /debug/profile``: fan
        the capture request out to every remote replica's agent
        (``POST /v1/profile``), so one operator curl profiles the
        WHOLE fleet — local replicas through this process's
        ``ServeProfiler``, each agent host through its own (trace
        files land on that host, under the agent's profile dir).
        Best-effort per host: an unreachable or already-capturing
        agent reports its error in the returned map and never blocks
        the rest. Empty map = no remote replicas."""
        from tony_tpu_torch.gateway.remote import AgentHTTPError

        def arm(server) -> dict:
            try:
                doc = server.transport.call(
                    "POST", "/v1/profile", {"steps": int(steps)},
                    epoch=server.epoch, timeout=3.0)
                return {"armed": True, "logdir": doc.get("logdir")}
            except AgentHTTPError as e:
                return {"armed": False, "status": e.status,
                        "error": e.doc.get("error", str(e))}
            except Exception as e:  # noqa: BLE001 — best-effort PER
                # HOST is the contract: json.loads ValueErrors,
                # http.client garbled-response exceptions, anything —
                # one bad agent reports its error, never 500s the
                # whole fan-out
                return {"armed": False,
                        "error": f"{type(e).__name__}: {e}"}

        return self._remote_profile_fanout(arm)

    def remote_profile_status(self) -> dict:
        """Per-agent ``GET /v1/profile`` statuses for the fleet view
        behind ``GET /debug/profile`` — best-effort (a debug read
        must not 5xx because one host is down)."""
        from tony_tpu_torch.gateway.remote import AgentHTTPError

        def status(server) -> dict:
            try:
                return server.transport.call(
                    "GET", "/v1/profile", epoch=server.epoch,
                    timeout=3.0)
            except Exception as e:  # noqa: BLE001 — see arm(): a
                # debug read is best-effort per host, never a 5xx
                return {"error": f"{type(e).__name__}: {e}"}

        return self._remote_profile_fanout(status)

    def debug_bundle(self, reason: str = "manual",
                     trigger: list | None = None,
                     trace_limit: int = 8) -> dict:
        """The flight recorder's payload (``GET /debug/bundle``, and
        what a firing alert dumps to disk): ONE self-contained JSON
        document an operator can read after the incident — active +
        recent alerts, the signal snapshot the rules judged, the
        fleet/per-replica goodput report, every replica's stats row
        (dispatch timeline, transport + obs blocks for remote hosts),
        supervision counters, the autoscaler's status, and the most
        recent request traces (full Chrome docs for the last
        ``trace_limit``, summaries for the rest) — remote spans, with
        their clock-offset tags, included."""
        live = [r for r in self.replicas if not r.retired]
        replicas = []
        for r in live:
            row = r.stats(include_dispatch=True)
            server = r.server
            if server is not None:
                row["goodput"] = server.goodput()
            replicas.append(row)
        traces: dict = {"count": 0, "summaries": [], "recent": []}
        if self.traces is not None:
            traces["summaries"] = self.traces.summaries()
            traces["count"] = len(traces["summaries"])
            recent_ids = self.traces.ids()[-trace_limit:] \
                if trace_limit > 0 else []  # [-0:] would mean ALL
            for rid in recent_ids:
                tr = self.traces.get(rid)
                if tr is not None:
                    traces["recent"].append(tr.to_chrome())
        try:
            signals = self.alert_signals()
        except Exception:  # noqa: BLE001 — a half-drained fleet must
            # still bundle what it can, not crash the recorder
            log.exception("bundle signal read failed")
            signals = {}
        with self.stats.lock:
            supervision = {
                "replica_failures": self.stats.replica_failures,
                "failovers": self.stats.failovers,
                "retries": self.stats.retries,
                "probes": self.stats.probes,
                "rejoins": self.stats.rejoins,
                "quarantines": self.stats.quarantines,
                "replicas_added": self.stats.replicas_added,
                "replicas_removed": self.stats.replicas_removed,
            }
            bundles = {"written": self.stats.bundles_written,
                       "last_path": self.stats.last_bundle}
        scaler = self.scaler
        return {
            "t_wall": round(time.time(), 3),
            "reason": reason,
            "trigger": list(trigger) if trigger else [],
            "app_id": self.history.app_id
            if self.history is not None else None,
            "alerts": {"enabled": True, **self.alerts.snapshot()}
            if self.alerts is not None else {"enabled": False},
            "signals": signals,
            "goodput": self.goodput_report(),
            "supervision": supervision,
            "replicas": replicas,
            "scaler": scaler.status() if scaler is not None else None,
            "traces": traces,
            "bundles": bundles,
        }

    def dump_bundle(self, reason: str = "manual",
                    trigger: list | None = None) -> str | None:
        """Write ``debug_bundle()`` into the history job dir. Returns
        the path, or None when there is no history (nowhere to land)
        or the write failed — the recorder degrades, it never raises
        into its caller (the alert loop)."""
        history = self.history
        if history is None:
            return None
        try:
            path = history.write_bundle(
                self.debug_bundle(reason=reason, trigger=trigger))
        except Exception:
            log.exception("debug bundle dump failed")
            return None
        with self.stats.lock:
            self.stats.bundles_written += 1
            self.stats.last_bundle = path
        log.warning("debug bundle (%s: %s) -> %s", reason,
                    ",".join(trigger) if trigger else "-", path)
        return path

    def _queue_block(self, replicas: list[_Replica], now: float) -> dict:
        """The queue-pressure block, ONE implementation for both
        consumers — the autoscaler's ``scale_signals()`` and the
        /stats ``queue`` block — so they cannot drift apart."""
        per_replica = []
        by_tier: dict[str, int] = {}
        for r in replicas:
            sig = r.queue_signals(now)
            sig["replica"] = r.index
            per_replica.append(sig)
            for tier, n in sig["by_tier"].items():
                by_tier[tier] = by_tier.get(tier, 0) + n
        return {
            "depth": sum(s["depth"] for s in per_replica),
            "oldest_wait_s": max((s["oldest_wait_s"]
                                  for s in per_replica), default=0.0),
            "enqueue_rate_per_s": round(
                sum(s["enqueue_rate_per_s"] for s in per_replica), 3),
            "by_tier": by_tier,
            "per_replica": per_replica,
        }

    # --------------------------------------------------------- admission

    def submit(self, request: GenRequest,
               on_event: Callable | None = None) -> Ticket:
        """Admission gate + router. Raises ``GatewayClosed`` (503) when
        draining, ``BadRequest`` (400) on invalid shapes,
        ``GatewayQueueFull`` (429) past ``max_queue`` waiting requests,
        ``DeadlineExceeded`` (504) for an already-dead ttl,
        ``NoHealthyReplicas`` (503) when every replica's breaker is
        open."""
        if self._closed:
            self.stats_shed(503)
            raise GatewayClosed("gateway is draining")
        prompt = list(request.prompt)
        max_len = self._max_seq_len
        if not prompt:
            self.stats_shed(400)
            raise BadRequest("empty prompt")
        if len(prompt) >= max_len:
            self.stats_shed(400)
            raise BadRequest(f"prompt ({len(prompt)}) leaves no room for "
                             f"generation in max_seq_len ({max_len})")
        if request.max_new_tokens < 1:
            self.stats_shed(400)
            raise BadRequest("max_new_tokens must be >= 1")
        tier = request.priority if request.priority is not None \
            else DEFAULT_TIER
        weights = self.tier_weights if self.tier_weights is not None \
            else _DEFAULT_WEIGHTS
        if tier not in weights:
            self.stats_shed(400)
            raise BadRequest(f"unknown priority {tier!r} "
                             f"(tiers: {', '.join(weights)})")
        ttl = request.ttl_s if request.ttl_s is not None \
            else self.default_ttl_s
        if ttl is not None and ttl <= 0:
            self.stats_shed(504)
            raise DeadlineExceeded("ttl_s already expired at submit")
        cost = len(prompt) + request.max_new_tokens
        if request.id is None:
            # server-minted UUID (clients may supply their own): echoed
            # in responses, /stats window rows, history requests.jsonl,
            # and keying the request's trace — the correlation handle
            # TonY's per-task history gives every job
            request.id = uuid.uuid4().hex
        with self._lock:
            if sum(r.n_queued for r in self.replicas
                   if not r.retired) >= self.max_queue:
                self.stats_shed(429)
                raise GatewayQueueFull(
                    f"admission queue at max_queue={self.max_queue}")
            # tenant quota AFTER validation + the queue bound (a
            # request the gateway can't even queue must not drain the
            # tenant's bucket), BEFORE the ticket exists. Charged
            # exactly once — failover re-enqueues never re-pass this
            # gate — and refunded on the no-service exits below.
            retry_after = self.quotas.admit(request.tenant, cost)
            if retry_after is not None:
                with self.stats.lock:
                    self.stats.quota_rejections += 1
                    self.stats.shed_by_tier[tier] = \
                        self.stats.shed_by_tier.get(tier, 0) + 1
                self.stats_shed(429)
                raise QuotaExceeded(
                    f"tenant {request.tenant or '(anonymous)'!r} over "
                    f"its token rate ({self.quotas.rate:g}/s, burst "
                    f"{self.quotas.burst:g}); retry in {retry_after:.2f}s",
                    retry_after_s=retry_after)
            ticket = Ticket(request, ttl, on_event)
            ticket.tier = tier
            ticket.tenant = request.tenant
            # role-split fleets: every new request enters through the
            # prefill pool; the handoff relay moves it to decode
            ticket.phase = "prefill" if self.roles else None
            if self.traces is not None:
                t0 = request.t_receive if request.t_receive is not None \
                    else ticket.t_submit
                trace = RequestTrace(request.id, t0=t0)
                trace.root.tags.update(
                    prompt_len=len(prompt),
                    max_new_tokens=request.max_new_tokens,
                    priority=tier,
                    **({"tenant": request.tenant}
                       if request.tenant else {}))
                if request.t_receive is not None:
                    trace.add("http_receive", request.t_receive,
                              ticket.t_submit, attempt=False)
                ticket.trace = trace
            # WAL + resume registry: the admit row lands
            # BEFORE the enqueue so the journal never misses a routed
            # request, and the ticket registers for client resume —
            # GET /v1/stream/<id>?offset= works for every admitted
            # request, crash or no crash
            if self.journal is not None:
                ticket._journal = self.journal
                self.journal.admit(request.id, {
                    "prompt": prompt,
                    "max_new_tokens": request.max_new_tokens,
                    "temperature": request.temperature,
                    "top_k": request.top_k, "seed": request.seed,
                    **({"session": request.session}
                       if request.session else {}),
                    **({"tenant": request.tenant}
                       if request.tenant else {}),
                    **({"priority": request.priority}
                       if request.priority else {}),
                }, time.time())
            self._register_resume(ticket)
            tried: set[int] = set()
            while True:
                try:
                    replica = self._route(ticket, tried)
                except NoHealthyReplicas:
                    self.quotas.refund(request.tenant, cost)  # zero
                    # service delivered: the bucket must not pay
                    self.stats_shed(503)
                    self._abandon_resume(ticket, 503)
                    raise
                try:
                    # enqueue INSIDE the gateway lock: the bound check
                    # and the depth increment must be atomic or two
                    # concurrent submits both pass at max_queue - 1 and
                    # overshoot. Lock order gateway._lock -> replica.cv
                    # is safe: no replica-thread path takes the gateway
                    # lock.
                    replica.enqueue(ticket)
                    break
                except _ReplicaUnhealthy:
                    tried.add(replica.index)  # flipped between route
                    # and enqueue: re-route among the others
                except GatewayClosed:  # the drain race
                    self.quotas.refund(request.tenant, cost)
                    self.stats_shed(503)
                    self._abandon_resume(ticket, 503)
                    raise
        with self.stats.lock:
            self.stats.accepted += 1
        return ticket

    # a prefix-affinity match shorter than this (and shorter than the
    # whole prompt) is not worth overriding load balance for: seeding
    # a few tokens saves less than an imbalanced queue costs
    _AFFINITY_MIN_TOKENS = 8

    def _route(self, ticket: Ticket,
               excluded: set | frozenset = frozenset()) -> _Replica:
        """Routing, in preference order: (1) the ticket's ROLE pool
        (role-split fleets: "prefill" tickets only ever land on
        prefill replicas, handoffs on decode replicas); (2) PREFIX
        AFFINITY — the replica whose radix tree (device store or host
        tier) holds the longest cached prefix of this prompt, the
        generalization of session affinity that makes a fleet-wide hot
        system prompt prefill ONCE instead of once per replica; (3)
        crc32 session affinity when the request asks; (4) least
        outstanding tokens (ties -> lowest index, deterministic).
        Every preference degrades to the next — affinity is a cache
        preference, never a correctness requirement. Only HEALTHY
        replicas outside ``excluded`` are candidates; none left raises
        ``NoHealthyReplicas`` (503, retriable)."""
        request, phase = ticket.request, ticket.phase
        healthy = [r for r in self.replicas
                   if r.state == HEALTHY and not r.retiring
                   and r.index not in excluded
                   and (phase is None or r.role == phase)]
        if not healthy:
            pool = f"{phase} " if phase else ""
            raise NoHealthyReplicas(
                f"no healthy {pool}replica (states: "
                + ", ".join(r.state + ("/retiring" if r.retiring else "")
                            for r in self.replicas if not r.retired) + ")")
        if self.prefix_affinity and phase != "decode":
            pinned = self._prefix_match(request.prompt, healthy)
            if pinned is not None:
                with self.stats.lock:
                    self.stats.prefix_routed += 1
                return pinned
        if request.session is not None:
            # affinity hashes over the CURRENT membership (retired
            # replicas excluded; role-split fleets hash within the
            # ticket's pool): a scale event remaps sessions — a cache
            # preference reshuffle, never a correctness issue
            candidates = [r for r in self.replicas
                          if not r.retired and not r.retiring
                          and (phase is None or r.role == phase)]
            key = zlib.crc32(str(request.session).encode())
            pinned = candidates[key % len(candidates)] if candidates \
                else None
            if pinned in healthy:
                return pinned
        return min(healthy, key=lambda r: (r.outstanding, r.index))

    def _prefix_match(self, prompt: list,
                      healthy: list) -> _Replica | None:
        """The affinity probe: ask each candidate's engine for its
        longest cached prefix of ``prompt`` (a lock-protected radix
        walk, no device work, no counters moved) and pin to the
        longest match when it is worth it. Ties break by least
        outstanding work, so two equally-warm replicas still balance.
        Remote stubs answer from the bounded radix summary their
        agent ships on every heartbeat — no per-request
        network probe, staleness bounded by the heartbeat interval,
        and a stale hit costs a suboptimal preference, never
        correctness — so a REMOTE replica holding the prefix can win
        over a cold local one."""
        best, best_len = None, 0
        for r in healthy:
            probe = getattr(r.server, "prefix_match_len", None)
            if probe is None:
                continue
            try:
                n = probe(prompt)
            except Exception:
                log.exception("prefix affinity probe failed on "
                              "replica %d", r.index)
                continue
            if n > best_len or (n == best_len and n > 0
                                and best is not None
                                and r.outstanding < best.outstanding):
                best, best_len = r, n
        if best is None or best_len < min(len(prompt),
                                          self._AFFINITY_MIN_TOKENS):
            return None
        return best

    # ------------------------------------------------------- supervision

    def _beat(self, replica: _Replica) -> None:
        """One heartbeat from a replica's scheduler thread (once per
        iteration, including idle waits)."""
        replica.last_beat = time.monotonic()
        wd = self._watchdog  # snapshot: drain() nulls the attribute
        # concurrently, and an AttributeError here would kill the
        # replica thread mid-drain with tickets still queued
        if wd is not None:
            wd.ping(str(replica.index))

    def _unwatch(self, replica: _Replica) -> None:
        """A replica thread exiting cleanly (drain finished its queue)
        takes itself off the watchdog's list — its silence is not a
        stall."""
        wd = self._watchdog  # snapshot (see _beat)
        if wd is not None:
            wd.unregister(str(replica.index))

    def _fail_remote(self, replica: _Replica, reason: str) -> None:
        """A remote replica's lease expired (or its agent reported a
        terminal condition mid-stream): the network-side analog of the
        watchdog's stall — same funnel, same token-exact failover.
        Runs on the stub's lease-monitor (or stream-reader) thread;
        ``_fail_replica``'s epoch/state fence makes a duplicate report
        (lease expiry racing a reader's dead-agent discovery) a
        no-op."""
        with replica.cv:
            epoch = replica.epoch
        self._fail_replica(replica, epoch,
                           f"replica {replica.index} ({replica.host}): "
                           f"{reason}")

    def _on_stall(self, task_id: str) -> None:
        """Watchdog expiry: the replica's thread stopped beating —
        a WEDGED dispatch (the failure exceptions cannot catch). Runs
        on the monitor thread; the wedged thread finds the bumped epoch
        whenever its dispatch finally returns and discards the stale
        output."""
        replica = self.replicas[int(task_id)]
        with replica.cv:
            epoch = replica.epoch
        self._fail_replica(
            replica, epoch,
            f"replica {replica.index} stalled: no heartbeat for "
            f"{self.stall_timeout_s:.1f}s")

    def _fail_replica(self, replica: _Replica, epoch: int,
                      reason: str) -> None:
        """Declare a replica failed (exception route from its own
        thread, stall route from the watchdog): bump its epoch (the
        fencing token — stale output from the old epoch is discarded),
        steal EVERY ticket it holds, and fail them over. Idempotent
        under the race of both routes firing: the epoch check makes the
        second caller a no-op. ``fail_lock`` is held through the whole
        steal + failover so the replica thread's breaker entry
        (``_recover``'s hard engine reset) cannot wipe the agent-side
        sessions while ``_claim_parked`` is still adopting them."""
        with replica.fail_lock:
            with replica.cv:
                if replica.epoch != epoch or replica.state != HEALTHY:
                    return  # already handled (exception-vs-watchdog
                    #         race)
                replica.epoch += 1
                replica.state = BROKEN
                replica.failures += 1
                replica.consecutive_failures += 1
                admitted = list(replica._tickets.values())
                replica._tickets.clear()
                queued = replica.queue.steal_all()  # WFQ service
                # order; tickets keep their tier, so the survivor's
                # queue re-applies the same fairness
                replica.outstanding = 0
                replica.cv.notify_all()
            wd = self._watchdog  # snapshot (see _beat)
            if wd is not None:
                wd.unregister(str(replica.index))
            with self.stats.lock:
                self.stats.replica_failures += 1
            log.error("%s: failing over %d admitted + %d queued "
                      "ticket(s)", reason, len(admitted), len(queued))
            self._failover(replica, admitted, queued, reason)

    def _failover(self, replica: _Replica, admitted: list,
                  queued: list, reason: str) -> None:
        """The TonY task-retry analog, token-exact: ``admitted``
        tickets ran on the failed engine — charge one attempt, exclude
        the replica, re-run from the prompt (deterministic decode +
        ``_n_emitted`` make the retried stream byte-identical past what
        the client already has). ``queued`` tickets never touched the
        engine: moved untouched, no attempt charged, no exclusion.
        Budget or fleet exhaustion sheds 503 (retriable) — never 500."""
        now = time.monotonic()
        for ticket in admitted:
            ticket.attempts += 1
            ticket.excluded.add(replica.index)
        if admitted:
            with self.stats.lock:
                self.stats.retries += len(admitted)
        for ticket in admitted + queued:
            if ticket.trace is not None:
                # close the failed attempt and mark the epoch fence:
                # a chaos-path trace shows BOTH engine runs, with the
                # failover instant between them (admitted=False means
                # the ticket was still queued — moved, never charged)
                admitted_here = any(ticket is t for t in admitted)
                ticket.trace.end_attempt(
                    now, outcome="failed" if admitted_here else "moved",
                    reason=reason)
                ticket.trace.add("failover", now, attempt=False,
                                 from_replica=replica.index,
                                 new_epoch=replica.epoch,
                                 admitted=admitted_here)
            ticket.state = QUEUED
            ticket.replica = None
            if ticket.attempts >= self.max_attempts:
                self._shed_ticket(
                    replica, ticket, 503,
                    f"retry budget exhausted: {ticket.attempts} failed "
                    f"run(s) on replicas {sorted(ticket.excluded)} "
                    f"({reason})", exc=RetryBudgetExhausted)
                continue
            if any(ticket is t for t in admitted):
                self._claim_snapshot(ticket)
                if ticket.migrate is None:
                    self._claim_parked(replica, ticket)
            self._requeue(replica, ticket, reason)

    def _claim_snapshot(self, ticket: Ticket) -> None:
        """The lease's claim half: if a migrate extract for this
        ticket is in flight (the source died mid-move), wait up to
        ``migrate_lease_s`` for the frozen snapshot and attach it —
        the requeue then resumes the session token-exact with NO
        recompute. Timeout or a failed extract falls through to the
        ordinary crash path (re-run from the prompt, still
        token-exact, just slower); the abandoned flag tells the
        extractor its late snapshot belongs to nobody."""
        with self._lease_lock:
            lease = self._snap_leases.pop(_lease_key(ticket), None)
        if lease is None:
            return
        if not lease.done.wait(self.migrate_lease_s):
            with self._lease_lock:
                if not lease.done.is_set():
                    # expired with the extract still running: the
                    # extractor sees abandoned=True and releases the
                    # snapshot when (if) it completes
                    lease.abandoned = True
                    log.warning("migrate snapshot lease expired after "
                                "%.1fs; re-running from prompt",
                                self.migrate_lease_s)
                    return
        if lease.snap is None:
            return  # the extract failed: nothing to adopt
        ticket.migrate = lease.snap
        with self.stats.lock:
            self.stats.migrate_lease_adoptions += 1
            self.stats.migrations += 1
        if ticket.trace is not None:
            ticket.trace.add("migrate_lease_adopt", time.monotonic(),
                             attempt=False,
                             waited_s=round(
                                 time.monotonic() - lease.t0, 3))
        log.warning("failover adopted an in-flight migrate snapshot "
                    "(token-exact resume, no recompute)")

    def _claim_parked(self, replica: _Replica, ticket: Ticket) -> None:
        """The parked-session check (closing the ROADMAP
        residue): before a failover re-runs an admitted ticket from
        its prompt, ask the failed replica's AGENT for the session —
        a lease that expired because the gateway-side transport
        flapped (not because the agent died) leaves the agent holding
        a perfectly good live slot or parked snapshot. Adopting it
        pins the invariants the chaos rounds check: ONE attempt
        charged (the failover already did), ZERO re-prefill, and a
        token-exact resumed stream. Any error falls through to the
        ordinary re-run — still token-exact, just slower."""
        server = replica.server
        adopt = getattr(server, "adopt_parked", None) \
            if server is not None else None
        if adopt is None:
            return  # local replica: its engine died with its slots
        try:
            resp = adopt(ticket.request.id)
        except Exception as e:
            log.debug("failover park check for %r on %s failed: %r",
                      ticket.request.id, replica.host, e)
            return
        if resp is None or resp.get("snapshot") is None:
            return  # unknown / reaped / finished-elsewhere: re-run
        ticket.migrate = resp["snapshot"]
        with self.stats.lock:
            self.stats.park_adoptions += 1
            self.stats.migrations += 1
        if ticket.trace is not None:
            ticket.trace.add("park_adopt", time.monotonic(),
                             attempt=False, host=replica.host,
                             offset=resp.get("offset"))
        log.warning("failover adopted the PARKED session for %r off "
                    "agent %s (token-exact resume, no re-prefill)",
                    ticket.request.id, replica.host)

    def _requeue(self, replica: _Replica, ticket: Ticket,
                 reason: str) -> None:
        """Land a stolen ticket on a healthy replica (outside its
        excluded set), or shed it 503. ``force=True`` bypasses the
        drain gate — the zero-loss drain promise covers stolen tickets
        too, as long as a live thread can still run them."""
        tried: set[int] = set()
        while True:
            try:
                target = self._route(ticket, ticket.excluded | tried)
            except NoHealthyReplicas:
                self._shed_ticket(
                    replica, ticket, 503,
                    f"no healthy replica left ({reason})",
                    exc=NoHealthyReplicas)
                return
            try:
                target.enqueue(ticket, force=True)
            except (GatewayClosed, _ReplicaUnhealthy):
                tried.add(target.index)  # raced its own failure/exit
                continue
            with self.stats.lock:
                self.stats.failovers += 1
            return

    def _relay_handoff(self, replica: _Replica, ticket: Ticket, res,
                       now: float) -> None:
        """The disaggregation hinge, run on the PREFILL replica's
        thread out of ``_deliver``: the prefill half finished (pages +
        last-position logits in ``res.handoff``), so move the ticket
        to a decode replica carrying the payload. Not a failover (no
        attempt charged, no exclusion — the prefill engine did its job)
        and not a completion (the client has seen nothing). A fleet
        with no healthy decode replica sheds 503, retriable."""
        with self.stats.lock:
            self.stats.handoffs += 1
        ticket._prefill_meta = {
            "prefill_replica": replica.index,
            "prefix_hit_tokens": res.prefix_hit_tokens,
            "prefill_tokens_saved": res.prefill_tokens_saved,
            "prefill_chunks": getattr(res, "prefill_chunks", 0),
        }
        ticket.handoff = res.handoff
        ticket.phase = "decode"
        ticket.state = QUEUED
        ticket.replica = None
        if ticket.trace is not None:
            ticket.trace.end_attempt(now, outcome="handoff")
            ticket.trace.add("handoff", now, attempt=False,
                             from_replica=replica.index,
                             n_tokens=res.handoff.get("n_tokens"))
        tried: set[int] = set()
        while True:
            try:
                target = self._route(ticket, ticket.excluded | tried)
            except NoHealthyReplicas:
                self._shed_ticket(
                    replica, ticket, 503,
                    "no healthy decode replica to receive the "
                    "prefill handoff", exc=NoHealthyReplicas)
                return
            try:
                # force=True: the drain promise covers a request whose
                # prefill half already ran, same as a stolen ticket
                target.enqueue(ticket, force=True)
            except (GatewayClosed, _ReplicaUnhealthy):
                tried.add(target.index)
                continue
            return

    # ------------------------------------------------ live migration

    def _migrate_ticket(self, replica: _Replica, engine_id: int,
                        ticket: Ticket, epoch: int) -> bool:
        """Freeze one live decode slot off ``replica`` and relay it to
        another replica. False means the session did NOT
        move and keeps running where it is — not-live-yet (pending or
        mid-prefill), unpaged engine, no healthy taker, or the extract
        lost a race; every one of those leaves the old behavior (decode
        to completion, or crash-path failover) intact."""
        server = replica.server
        if server is None or not getattr(server, "paged", False):
            return False
        if getattr(server, "extract_session", None) is None:
            return False
        # probe for a taker BEFORE freezing: with nobody to adopt it, a
        # freeze would degrade the session to a re-run from the prompt
        # for nothing
        try:
            self._route(ticket, ticket.excluded | {replica.index})
        except NoHealthyReplicas:
            return False
        # owner-swap extract (page ids, zero bytes moved) whenever the
        # engine's pool is shared — if routing then lands the ticket on
        # a REMOTE replica, the stub gathers the content late
        # (serve/migrate.gather_local); otherwise gather to wire now
        pool = getattr(getattr(server, "slots", None), "pool", None)
        wire = not (pool is not None and getattr(pool, "shared", False))
        # register the lease BEFORE the freeze: if the source replica
        # dies while the extract is in flight (remote migrate_out over
        # a SIGKILLed agent, a wedged local scheduler), _failover finds
        # this lease and waits a bounded time for the snapshot instead
        # of instantly degrading the session to re-run-from-prompt
        key = _lease_key(ticket)
        lease = _SnapLease()
        with self._lease_lock:
            self._snap_leases[key] = lease
        try:
            snap = server.extract_session(engine_id, wire=wire)
        except Exception:
            log.exception("migrate-out extract failed on replica %d",
                          replica.index)
            snap = None
        if snap is None:
            # failed or not in a live slot (pending, prefilling, or it
            # finished under us): wake any waiting claimer with
            # nothing — it proceeds down the crash path immediately
            with self._lease_lock:
                self._snap_leases.pop(key, None)
                lease.done.set()
            return False
        with self._lease_lock:
            lease.snap = snap
            lease.done.set()
            claimed = self._snap_leases.pop(key, None) is None
            abandoned = lease.abandoned
        if abandoned:
            # the claimer's lease expired before the extract finished:
            # the ticket already re-ran from its prompt — the late
            # snapshot is a duplicate of a stream someone else owns
            _release_snapshot(snap)
            return False
        if claimed:
            # _failover took the lease and is adopting the snapshot
            # (it sets ticket.migrate and requeues): the session moves
            # token-exact with no recompute — the move happened, just
            # through the crash funnel instead of the relay below
            return True
        with replica.cv:
            owned = replica.epoch == epoch \
                and replica._tickets.pop(engine_id, None) is not None
            if owned:
                replica.outstanding = max(
                    0, replica.outstanding - ticket.cost)
        if not owned:
            # the watchdog's steal raced the freeze: failover owns the
            # ticket now (re-run from prompt) — drop the frozen copy
            _release_snapshot(snap)
            return False
        self._relay_migration(replica, ticket, snap, time.monotonic())
        return True

    def _relay_migration(self, replica: _Replica, ticket: Ticket,
                         snap, now: float) -> None:
        """The planned-move hinge, the migration analog of
        ``_relay_handoff``: a frozen live session leaves ``replica``
        carrying its ``SessionSnapshot`` and resumes mid-stream on
        whichever replica routing picks — prefix affinity included.
        Not a failover (no attempt charged, no exclusion — the source
        did nothing wrong) and not a completion (the stream continues;
        the absolute-offset emit dedup keeps the client gap/dup-free).
        Both attempts land in ONE trace, fenced by the ``migrate``
        span. No taker left — a narrow race, callers probe before
        freezing — falls back to the crash path: drop the snapshot
        (refs released) and requeue an ordinary re-run from the
        prompt, token-exact."""
        with self.stats.lock:
            self.stats.migrations += 1
        ticket.migrate = snap
        ticket.state = QUEUED
        ticket.replica = None
        if ticket.trace is not None:
            local = not isinstance(snap, dict) \
                and bool(getattr(snap, "local", False))
            n_tok = snap.get("n_tokens") if isinstance(snap, dict) \
                else snap.n_tokens
            ticket.trace.end_attempt(now, outcome="migrate")
            ticket.trace.add("migrate", now, attempt=False,
                             from_replica=replica.index,
                             n_tokens=int(n_tok), local=local)
        tried = {replica.index}
        while True:
            try:
                target = self._route(ticket, ticket.excluded | tried)
            except NoHealthyReplicas:
                _release_ticket_payload(ticket)
                self._requeue(
                    replica, ticket,
                    "no replica left to adopt the migrated session")
                return
            try:
                target.enqueue(ticket, force=True)
            except (GatewayClosed, _ReplicaUnhealthy):
                tried.add(target.index)
                continue
            return

    def migrate_session(self, request_id) -> bool:
        """Move one in-flight request to another replica, mid-stream
        and token-exact — the operator/rebalancer entry to the same
        machinery retirement uses. The new placement goes through the
        ordinary routing stack, so with prefix affinity on, a hot
        session migrates TOWARD the replica already holding its
        prefix. Returns False when the request is not currently in a
        live decode slot (queued, mid-prefill, finished, unknown) or
        nothing could adopt it; the request is unharmed either way.

        Safe from any thread: the freeze itself serializes against the
        source's decode loop under the engine dispatch lock (local) or
        happens on the agent's scheduler (remote)."""
        for r in self.replicas:
            if r.retired or r.server is None:
                continue
            with r.cv:
                epoch = r.epoch
                found = [(eid, t) for eid, t in r._tickets.items()
                         if t.request.id == request_id]
            if found:
                return self._migrate_ticket(r, found[0][0],
                                            found[0][1], epoch)
        return False

    # ------------------------------------- restart recovery

    def _register_resume(self, ticket: Ticket) -> None:
        """Every admitted ticket joins the resume registry behind
        ``GET /v1/stream/<id>?offset=`` — reconnects work crash or no
        crash. Terminal tickets stay fetchable for ``park_ttl_s``
        (the client-side twin of the agent's park TTL) and are reaped
        opportunistically here: registrations happen at traffic rate,
        so the registry can never grow past traffic + one TTL."""
        now = time.monotonic()
        with self._resume_lock:
            dead = [rid for rid, t in self._resume.items()
                    if t.t_terminal is not None
                    and now - t.t_terminal > self.park_ttl_s]
            for rid in dead:
                del self._resume[rid]
            self._resume[ticket.request.id] = ticket

    def _abandon_resume(self, ticket: Ticket, status: int) -> None:
        """A submit that sheds AFTER its admit row landed (no healthy
        replica, the drain race): close the WAL entry and drop the
        registration — the client got a synchronous error, there is
        nothing to resume and nothing for ``--recover`` to re-run."""
        with ticket._emit_lock:
            ticket.state = SHED
            ticket.t_terminal = time.monotonic()
            ticket._shed_status = status
        if ticket._journal is not None:
            ticket._journal.shed(ticket.request.id, status)
        with self._resume_lock:
            self._resume.pop(ticket.request.id, None)

    def resume_ticket(self, rid) -> Ticket | None:
        with self._resume_lock:
            return self._resume.get(rid)

    def resume_events(self, rid, offset: int = 0,
                      keepalive_s: float = 15.0):
        """The resumable-stream generator behind
        ``GET /v1/stream/<request_id>?offset=N`` (both edges frame
        it): yield the absolute token windows past the client's own
        cursor, then the terminal line. Reads the ticket's resume
        buffer (``_tokens``) under its emit lock instead of consuming
        the single-consumer ``events`` queue, so a resumed stream
        never races the original consumer — N watchers of one request
        all see the same bytes. First yield is ``{"gone": True}`` for
        an unknown/reaped id (the edge 404s); a client whose request
        finished while it was away gets the buffered suffix plus the
        terminal immediately."""
        ticket = self.resume_ticket(rid)
        if ticket is None:
            yield {"gone": True}
            return
        sent = max(0, int(offset))
        last = time.monotonic()
        while True:
            with ticket._emit_lock:
                total = len(ticket._tokens)
                state = ticket.state
                window = list(ticket._tokens[sent:]) if sent < total \
                    else None
                metrics = ticket.metrics
                shed = (ticket._shed_status, ticket._shed_reason)
            if window:
                yield {"offset": sent, "token_ids": window}
                sent += len(window)
                last = time.monotonic()
                continue
            if state == SHED:
                yield {"shed": True, "status": shed[0] or 503,
                       "reason": shed[1]}
                return
            if state == DONE and metrics is not None:
                yield {"done": True, "metrics": metrics}
                return
            now = time.monotonic()
            if keepalive_s and now - last >= keepalive_s:
                yield {"keepalive": True}
                last = now
            time.sleep(0.02)

    def recover_from_journal(self, entries: dict) -> dict:
        """Boot-time crash recovery (``--recover``): the TonY-AM-
        restart analog for serving. ``entries`` is a replayed journal
        (``journal.replay``); every LIVE entry — admitted, never
        terminal — is re-admitted under its ORIGINAL request id:

        - remote replicas first sync epochs PAST the dead gateway's
          (``sync_recovery_epoch`` — never ``reset()``, which would
          wipe the very sessions we came back for), so the first
          adopt fences out any stale second adopter;
        - a session the journaled host PARKED (or still runs — the
          agent freezes it on the spot) is adopted and resumes
          mid-stream, token-exact, zero re-prefill, no attempt
          charged;
        - a request that FINISHED into the void comes back as its
          buffered result, immediately terminal;
        - everything else re-runs from the prompt, charged one
          attempt — deterministic decode makes the re-run
          byte-identical, and the resume buffer serves whatever
          suffix the client is missing.

        Call after ``start()``. Returns the recovery report (also
        folded into stats/alerts)."""
        t0 = time.monotonic()
        live = sorted((e for e in entries.values() if e.live),
                      key=lambda e: e.t_admit)
        report = {"live": len(live), "adopted": 0, "rerun": 0,
                  "finished": 0, "shed": 0}
        by_host: dict[str, _Replica] = {}
        for r in self.replicas:
            if r.retired or r.server is None:
                continue
            sync = getattr(r.server, "sync_recovery_epoch", None)
            if sync is not None:
                try:
                    sync()
                except Exception as e:
                    log.warning("recovery epoch sync failed for "
                                "replica %d (%s): %r", r.index,
                                r.host, e)
                by_host[r.host] = r
        # adopts can hold an agent's control connection for seconds
        # (freeze-for-adopt waits out the current dispatch), starving
        # the heartbeats queued behind them — mask lease expiries for
        # the duration so recovery can't fail over the very replicas
        # it is adopting from
        for r in by_host.values():
            pause = getattr(r.server, "pause_lease", None)
            if pause is not None:
                pause()
        for e in live:
            doc = e.request or {}
            request = GenRequest(
                prompt=list(doc.get("prompt", [])),
                max_new_tokens=int(doc.get("max_new_tokens", 64)),
                temperature=float(doc.get("temperature", 0.0)),
                top_k=int(doc.get("top_k", 0)),
                seed=int(doc.get("seed", 0)),
                id=e.rid,
                session=doc.get("session"),
                tenant=doc.get("tenant"),
                priority=doc.get("priority"))
            resp = None
            replica = by_host.get(e.host) if e.host else None
            if replica is not None:
                try:
                    resp = replica.server.adopt_parked(e.rid)
                except Exception as exc:
                    log.warning("recovery adopt of %r from %s failed "
                                "(%r); re-running from the prompt",
                                e.rid, e.host, exc)
            if resp is not None and resp.get("finished"):
                self._recover_finished(request, resp, e)
                report["finished"] += 1
                continue
            snap = resp.get("snapshot") if resp is not None else None
            mode = "adopt" if snap is not None else "rerun"
            ticket = Ticket(request, None)
            weights = self.tier_weights if self.tier_weights \
                is not None else _DEFAULT_WEIGHTS
            ticket.tier = request.priority \
                if request.priority in weights else DEFAULT_TIER
            ticket.tenant = request.tenant
            if snap is not None:
                # resume mid-stream: the wire snapshot carries the
                # full generated prefix — seed the resume buffer AND
                # the emit cursor from it, so the engine's re-emission
                # of the absolute window dedups exactly and a client
                # resuming at any offset <= the journaled one finds
                # its suffix in the buffer (the journal may be AHEAD
                # of what the client's socket actually delivered)
                gen = [int(t) for t in snap.get("generated", [])]
                ticket.migrate = snap
                ticket._tokens = list(gen)
                ticket._n_emitted = len(gen)
            else:
                # token-exact re-run from the prompt, charged one
                # attempt — the journaled offset is NOT seeded: the
                # engine regenerates from 0 and the buffer refills
                # byte-identically (deterministic decode)
                ticket.attempts = 1
            if self.traces is not None:
                trace = RequestTrace(request.id, t0=ticket.t_submit)
                trace.root.tags.update(
                    prompt_len=len(request.prompt),
                    max_new_tokens=request.max_new_tokens,
                    priority=ticket.tier, recovered=True)
                trace.add("recover", ticket.t_submit, attempt=False,
                          mode=mode, journal_offset=e.offset,
                          host=e.host)
                ticket.trace = trace
            if self.journal is not None:
                # fresh WAL rows in the NEW journal: a second crash
                # recovers from THIS boot's record (find_latest picks
                # the newest journal; the old one is left stale)
                ticket._journal = self.journal
                self.journal.admit(e.rid, doc, time.time())
            self._register_resume(ticket)
            tried: set[int] = set()
            while True:
                try:
                    target = self._route(ticket, tried)
                except NoHealthyReplicas:
                    self._shed_ticket(
                        self.replicas[0], ticket, 503,
                        "no healthy replica at recovery",
                        exc=NoHealthyReplicas)
                    report["shed"] += 1
                    break
                try:
                    target.enqueue(ticket, force=True)
                except (GatewayClosed, _ReplicaUnhealthy):
                    tried.add(target.index)
                    continue
                report["adopted" if mode == "adopt" else "rerun"] += 1
                break
        for r in by_host.values():
            resume_lease = getattr(r.server, "resume_lease", None)
            if resume_lease is not None:
                resume_lease()
        wall_ms = round((time.monotonic() - t0) * 1e3, 3)
        report["wall_ms"] = wall_ms
        self._t_recovered = time.monotonic()
        with self.stats.lock:
            self.stats.recoveries += 1
            self.stats.accepted += report["adopted"] + report["rerun"]
            self.stats.sessions_adopted += report["adopted"]
            self.stats.sessions_rerun += report["rerun"]
            self.stats.recovered_finished += report["finished"]
            self.stats.recovery_wall_ms += wall_ms
        if live:
            log.warning(
                "recovered %d journaled request(s) in %.0fms: "
                "%d adopted mid-stream, %d re-run from prompt, "
                "%d finished results, %d shed", len(live), wall_ms,
                report["adopted"], report["rerun"],
                report["finished"], report["shed"])
        return report

    def _recover_finished(self, request: GenRequest, resp: dict,
                          entry) -> None:
        """A request that FINISHED while the gateway was dead: the
        agent buffered the undelivered result — materialize it as an
        immediately-terminal ticket so the client's resume fetches the
        whole stream + done line. Bypasses ``_record_done`` on
        purpose: the latency fields a live completion carries
        (queue_wait/ttft/tpot) do not exist for a result that crossed
        a crash, and a fabricated zero would poison the histograms."""
        from tony_tpu_torch.serve.agent import result_from_doc

        res = result_from_doc({**resp["result"], "id": request.id})
        ticket = Ticket(request, None)
        ticket.tier = request.priority if request.priority \
            else DEFAULT_TIER
        ticket.tenant = request.tenant
        metrics = {
            "id": request.id, "recovered": True,
            "tokens_in": len(res.prompt),
            "tokens_out": len(res.tokens),
            "finish_reason": res.finish_reason,
            "attempts": 0,
        }
        with ticket._emit_lock:
            ticket._tokens = list(res.tokens)
            ticket._n_emitted = len(res.tokens)
            ticket.metrics = metrics
            ticket.state = DONE
            ticket.t_terminal = time.monotonic()
            ticket._emit(("done", res, metrics))
        self._register_resume(ticket)
        if self.journal is not None:
            # admit + done into the NEW journal: a second crash must
            # not try to adopt a session this boot already closed
            self.journal.admit(request.id, entry.request or {},
                               time.time())
            self.journal.done(request.id)

    def kill(self) -> None:
        """Die the way SIGKILL would — for chaos harnesses that crash
        an IN-PROCESS gateway (bench extras.recovery): no drain, no
        journal compaction (the WAL must survive exactly as the crash
        left it), and above all NO agent resets or epoch bumps — a
        dead process cannot POST /v1/reset, so neither may this path,
        or it would wipe the very parked sessions recovery exists to
        adopt. Remote transports are closed FIRST so any replica
        thread racing into its breaker sees a dead wire (logged,
        harmless), exactly like the real thing."""
        for loop in (self.scaler, self.rebalancer, self._alert_loop,
                     self._autotune_loop):
            if loop is not None:
                try:
                    loop.stop()
                except Exception:
                    pass
        wd = self._watchdog
        self._watchdog = None
        if wd is not None:
            wd.stop()
        self._closed = True
        for r in self.replicas:
            server = r.server
            if server is not None \
                    and getattr(server, "transport", None) is not None:
                try:
                    server.close(drain_agent=False)
                except Exception:
                    pass
        for r in self.replicas:
            with r.cv:
                r._stop = True
                r._tickets.clear()
                r.queue.steal_all()
                r.outstanding = 0
                r.cv.notify_all()
        for r in self.replicas:
            r.join(2.0)
        if self.journal is not None:
            self.journal.close()  # flush, never compact
        with self._resume_lock:
            self._resume.clear()
        self._drain_done = False

    def _shed_ticket(self, replica: _Replica, ticket: Ticket,
                     status: int, reason: str,
                     exc: type | None = None) -> None:
        """Terminal-event a stolen ticket the gateway gave up on,
        charged to the FAILED replica's shed count so per-replica
        /stats reconciles with ``shed_by_status`` (its ``outstanding``
        was already zeroed wholesale by the steal, so that is NOT
        touched). ``exc`` tells ``Ticket.result()`` which Shed subclass
        to raise when the bare status is ambiguous (the 503 family)."""
        _release_ticket_payload(ticket)  # a dead ticket must not pin
        #                                  shared-pool pages
        if ticket.trace is not None:
            ticket.trace.finish(outcome="shed", status=status,
                                reason=reason)
            self._export_trace(ticket)
        with ticket._emit_lock:
            # state flip + terminal emit under the emit lock: a failed
            # replica's late token delta can't slip in AFTER the shed
            # event the client treats as final
            ticket.state = SHED
            ticket._shed_exc_cls = exc
            ticket.t_terminal = time.monotonic()
            ticket._shed_status = status
            ticket._shed_reason = reason
            replica.shed += 1
            self._record_shed(replica, status, tier=ticket.tier)
            ticket._emit(("shed", status, reason))
        if ticket._journal is not None:
            ticket._journal.shed(ticket.request.id, status)

    def _note_probe(self, replica: _Replica) -> None:
        with self.stats.lock:
            self.stats.probes += 1

    def _note_rejoin(self, replica: _Replica) -> None:
        wd = self._watchdog  # snapshot (see _beat)
        if wd is not None:
            wd.register(str(replica.index))
        with self.stats.lock:
            self.stats.rejoins += 1

    def _note_quarantine(self, replica: _Replica) -> None:
        log.error("replica %d quarantined after %d consecutive "
                  "failures", replica.index, replica.consecutive_failures)
        with self.stats.lock:
            self.stats.quarantines += 1

    @property
    def n_healthy(self) -> int:
        return sum(1 for r in self.replicas if r.state == HEALTHY)

    def health(self) -> dict:
        """The /healthz payload: per-replica breaker state + heartbeat
        age, so a load balancer sees a DEGRADED gateway (one replica
        down, still serving) before anything 503s."""
        now = time.monotonic()
        live = [r for r in self.replicas if not r.retired]
        n = self.n_healthy
        return {
            "status": "ok" if n == len(live)
            else ("degraded" if n else "down"),
            "healthy": n,
            "replicas": [{
                "replica": r.index,
                "state": r.state,
                "retiring": r.retiring,
                "heartbeat_age_s": round(now - r.last_beat, 3),
                "consecutive_failures": r.consecutive_failures,
            } for r in live],
        }

    # ----------------------------------------------------- observability

    def _export_trace(self, ticket: Ticket) -> None:
        """A finished (done or shed) trace goes into the debug ring
        (``GET /debug/trace/<id>``) and — with history on — as one
        Chrome trace-event JSON doc per line in
        ``metrics/traces.jsonl``, next to the requests.jsonl rows the
        same request id keys."""
        if self.traces is None or ticket.trace is None:
            return
        self.traces.put(ticket.trace)
        if self.history is not None:
            try:
                self.history.record_trace(ticket.trace.to_chrome())
            except Exception:
                # same contract as the requests.jsonl write: a dropped
                # trace row must never cost the client its terminal
                # event
                log.exception("history trace write failed")

    def _host_sample(self) -> dict:
        """Host resource gauges: process-tree RSS from /proc, and the
        card's memory that torch's allocator holds (absent without
        CUDA).
        TTL-cached so the /proc walk runs per snapshot-second, not per
        request. Replicas are threads of THIS process, so the block is
        process-level truth attached to every replica row (documented
        in docs/OBSERVABILITY.md)."""
        now = time.monotonic()
        if self._host_cache is not None \
                and now - self._host_cache[0] < 1.0:
            return self._host_cache[1]
        from tony_tpu_torch.metrics.sampler import process_tree_rss_bytes

        host: dict = {"rss_bytes": process_tree_rss_bytes(os.getpid())}
        import torch

        if torch.cuda.is_available():
            # allocator bookkeeping only: no CUDA call, so it cannot
            # meet a replica's graph capture
            host["gpu_mem_bytes"] = int(torch.cuda.memory_allocated())
        self._host_cache = (now, host)
        return host

    # -------------------------------------------------------- accounting

    def stats_shed(self, status: int) -> None:
        with self.stats.lock:
            self.stats.shed_by_status[status] = \
                self.stats.shed_by_status.get(status, 0) + 1

    def _record_shed(self, replica: _Replica, status: int,
                     tier: str | None = None) -> None:
        self.stats_shed(status)
        if tier is not None:
            with self.stats.lock:
                self.stats.shed_by_tier[tier] = \
                    self.stats.shed_by_tier.get(tier, 0) + 1
        self._push_replica_metrics(replica)

    def _record_done(self, replica: _Replica, metrics: dict) -> None:
        with self.stats.lock:
            self.stats.completed += 1
            self.stats.tokens_in += metrics["tokens_in"]
            self.stats.tokens_out += metrics["tokens_out"]
            self.stats.prefix_hit_tokens += \
                metrics.get("prefix_hit_tokens", 0)
            self.stats.prefill_tokens_saved += \
                metrics.get("prefill_tokens_saved", 0)
            self.stats.drafted += metrics.get("drafted", 0)
            self.stats.draft_accepted += metrics.get("accepted", 0)
            tier = metrics.get("priority") or DEFAULT_TIER
            self.stats.completed_by_tier[tier] = \
                self.stats.completed_by_tier.get(tier, 0) + 1
            if tier not in self.stats.tier_wait:
                self.stats.tier_wait[tier] = Histogram()
            self.stats.window.append(metrics)
        # per-tier queue-wait histogram: the lifetime surface that
        # proves WFQ's no-starvation promise on /metrics
        self.stats.tier_wait[tier].observe(metrics["queue_wait_ms"] / 1e3)
        for key, ms_key in (("queue_wait", "queue_wait_ms"),
                            ("ttft", "ttft_ms"), ("tpot", "tpot_ms"),
                            ("e2e", "e2e_ms")):
            self.stats.hist[key].observe(metrics[ms_key] / 1e3)
        if self.history is not None:
            try:
                self.history.record(metrics)
            except Exception:
                # ANY failure (disk, or a request id json can't take):
                # a dropped history row must never cost the client its
                # done event — the ticket was already popped from
                # _tickets, so it is invisible to the failover steal
                # and a raise here would strand it terminal-event-less
                log.exception("history metrics write failed")
        self._push_replica_metrics(replica)

    def _push_replica_metrics(self, replica: _Replica) -> None:
        if self.metrics_store is None:
            return
        try:
            self.metrics_store.update_metrics(
                f"gateway:replica-{replica.index}",
                {k: v for k, v in replica.stats().items()
                 if isinstance(v, (int, float))})
        except Exception:
            log.exception("metrics store push failed")

    def snapshot(self) -> dict:
        out = self.stats.snapshot()
        out["ready"] = self.ready
        out["draining"] = self.draining
        # retired replicas drop out of the per-replica rows (and their
        # engine counters out of the fleet rollup — per-replica series
        # end when a replica does, like any scraped pod's); the
        # gateway-level request counters above are lifetime
        now = time.monotonic()
        live = [r for r in self.replicas if not r.retired]
        # one queue_signals per replica per scrape (the O(depth)
        # oldest-wait scan runs here, never on the per-request metrics
        # push), via the same helper scale_signals() uses — the
        # autoscaler and a human reading /stats see the same numbers
        queue = self._queue_block(live, now)
        sig_by_index = {s["replica"]: s for s in queue["per_replica"]}
        rows = []
        host = self._host_sample()
        for r in live:
            row = r.stats(include_dispatch=True)
            sig = sig_by_index[r.index]
            row["oldest_wait_s"] = sig["oldest_wait_s"]
            row["enqueue_rate_per_s"] = sig["enqueue_rate_per_s"]
            row["queued_by_tier"] = sig["by_tier"]
            row["host"] = host
            server = r.server  # single read vs concurrent retirement
            if server is not None:
                g = server.goodput()
                if g is not None:
                    row["goodput"] = g
                elif hasattr(server, "transport_stats"):
                    # a remote replica whose ledger has not been
                    # pulled yet reports an EXPLICIT null — silently
                    # omitting the key made "unobserved" look like a
                    # local engine with the timeline off
                    row["goodput"] = None
            rows.append(row)
        out["replicas"] = rows
        out["queued"] = queue["depth"]
        out["max_queue"] = self.max_queue
        # the queue block: fleet + per-replica queue sensors
        # (depth, oldest-wait age, enqueue rate) — the autoscaler's
        # primary input, useful standalone on /stats and /metrics
        out["queue"] = queue
        out["engine"] = self._engine_summary(rows, live)
        with self.stats.lock:
            out["routing"] = {
                "prefix_affinity": self.prefix_affinity,
                "prefix_routed": self.stats.prefix_routed,
                "handoffs": self.stats.handoffs,
                "migrations": self.stats.migrations,
                "migrate_lease_adoptions":
                    self.stats.migrate_lease_adoptions,
                "park_adoptions": self.stats.park_adoptions,
                "roles": {r.index: r.role for r in live}
                if self.roles else None,
            }
            # crash recovery: journaling state + what the
            # last --recover boot did — always present so a dashboard
            # can pin "journal on, 0 recoveries" as the healthy shape
            with self._resume_lock:
                n_resume = len(self._resume)
            out["recovery"] = {
                "journal": self.journal is not None,
                "resumable": n_resume,
                "recoveries": self.stats.recoveries,
                "sessions_adopted": self.stats.sessions_adopted,
                "sessions_rerun": self.stats.sessions_rerun,
                "recovered_finished": self.stats.recovered_finished,
                "recovery_wall_ms": round(
                    self.stats.recovery_wall_ms, 3),
            }
        with self.stats.lock:
            tiers = sorted(set(self.stats.completed_by_tier)
                           | set(self.stats.shed_by_tier)
                           | set(queue["by_tier"]))
            tier_rows = {}
            for tier in tiers:
                waits = sorted(
                    r["queue_wait_ms"] for r in self.stats.window
                    if (r.get("priority") or DEFAULT_TIER) == tier)
                tier_rows[tier] = {
                    "queued": queue["by_tier"].get(tier, 0),
                    "completed": self.stats.completed_by_tier.get(tier, 0),
                    "shed": self.stats.shed_by_tier.get(tier, 0),
                    "queue_wait_ms": {
                        "p50": _percentile(waits, 0.50),
                        "p99": _percentile(waits, 0.99)},
                }
            out["admission"] = {
                "tiers": dict(self.tier_weights if self.tier_weights
                              is not None else _DEFAULT_WEIGHTS),
                "by_tier": tier_rows,
                "quota": {**self.quotas.stats(),
                          "rejections": self.stats.quota_rejections},
            }
            out["supervision"] = {
                "healthy_replicas": self.n_healthy,
                "replicas": len(live),
                "retired": len(self.replicas) - len(live),
                "replicas_added": self.stats.replicas_added,
                "replicas_removed": self.stats.replicas_removed,
                "max_attempts": self.max_attempts,
                "stall_timeout_s": self.stall_timeout_s,
                "replica_failures": self.stats.replica_failures,
                "failovers": self.stats.failovers,
                "retries": self.stats.retries,
                "probes": self.stats.probes,
                "rejoins": self.stats.rejoins,
                "quarantines": self.stats.quarantines,
            }
            # the flight recorder's own trail: how many alert-triggered
            # bundles landed, and where the latest one is
            out["bundles"] = {
                "on_alert": self.bundle_on_alert
                and self.history is not None,
                "written": self.stats.bundles_written,
                "last_path": self.stats.last_bundle,
            }
        # fleet goodput ledger, merged from the per-replica ledgers
        # the rows above already computed (wall-clock weighted)
        out["engine"]["goodput"] = merge_ledgers(
            [row.get("goodput") for row in rows])
        # the adaptive shape controller (serve/autotune.py): status +
        # the live knob values it steers, per replica
        if self.autotune is not None:
            auto = self.autotune.snapshot()
            auto["replicas"] = self.autotune.knob_values(
                [(r.index, r.server) for r in live])
            out["engine"]["autotune"] = auto
        else:
            out["engine"]["autotune"] = {"enabled": False}
        if self.alerts is not None:
            out["alerts"] = {"enabled": True, **self.alerts.snapshot()}
        else:
            out["alerts"] = {"enabled": False}
        scaler = self.scaler
        if scaler is not None:
            out["scaler"] = scaler.status()
        rebalancer = self.rebalancer
        out["rebalance"] = rebalancer.status() \
            if rebalancer is not None else {"enabled": False}
        edge = self._edge_stats
        if edge is not None:
            try:
                out["edge"] = edge()
            except Exception:  # a dying edge must not break /stats
                log.exception("edge stats provider failed")
        return out

    def register_edge(self, stats_fn: Callable | None) -> None:
        """Attach the serving edge's connection-plane stats callable
        (-> dict); its block appears as snapshot()["edge"] and the
        ``tony_edge_*`` /metrics families. None detaches."""
        self._edge_stats = stats_fn

    def _engine_summary(self, replica_rows: list | None = None,
                        live: list | None = None) -> dict:
        """Fleet-level engine counters: the device work behind the
        request percentiles (prefills run, decode rounds, occupancy,
        overshoot waste) plus the speculative-decoding and prefix-cache
        effectiveness blocks, summed across replicas — so /stats shows
        savings NEXT TO the work they avoided. ``replica_rows`` (the
        per-replica stats rows snapshot() just built) donates its
        ``dispatch`` blocks so one scrape takes each timeline's lock
        once, not twice."""
        replicas = live if live is not None \
            else [r for r in self.replicas if not r.retired]
        servers = [r.server for r in replicas if r.server is not None]
        counts = [s.counters() for s in servers]
        total = lambda key: sum(c.get(key, 0) for c in counts)  # noqa: E731
        # migration totals include the retired replicas' carry — see
        # _Stats.migrate_carry
        carry = dict(self.stats.migrate_carry)
        mtotal = lambda key: total(key) + carry.get(key, 0)  # noqa: E731
        lookups = total("prefix_lookups")
        drafted = total("spec_drafted")
        if replica_rows is not None:
            dispatch_blocks = [row["dispatch"] for row in replica_rows
                               if "dispatch" in row]
        else:
            dispatch_blocks = [s.timeline.summary() for s in servers
                               if s.timeline is not None]
        return {
            # fleet dispatch timeline: per-kind count / host-wall ms /
            # compile split / tokens, merged across replicas — the
            # /stats block ROADMAP 4's dispatch-overhead work reads
            "dispatch": DispatchTimeline.merge(dispatch_blocks),
            "prefills": total("prefills"),
            "decode_steps": total("decode_steps"),
            "dispatches": total("dispatches"),
            "wasted_steps": total("wasted_steps"),
            "active_slots": sum(s.slots.n_active for s in servers),
            "slots": sum(s.slots.batch_size for s in servers),
            "spec": {
                "enabled": any(s.speculate_k > 0 for s in servers),
                "rounds": total("spec_rounds"),
                "drafted": drafted,
                "accepted": total("spec_accepted"),
                "acceptance_rate": round(
                    total("spec_accepted") / drafted, 4)
                if drafted else 0.0,
            },
            "prefix": {
                "enabled": any(s.prefix is not None for s in servers),
                "lookups": lookups,
                "hits": total("prefix_hits"),
                "hit_rate": round(total("prefix_hits") / lookups, 4)
                if lookups else 0.0,
                "hit_tokens": total("prefix_hit_tokens"),
                "prefill_tokens_saved": total("prefill_tokens_saved"),
                "entries": total("prefix_entries"),
                "bytes": total("prefix_bytes"),
                "budget_bytes": total("prefix_budget_bytes"),
                "evictions": total("prefix_evictions"),
            },
            # disaggregation: chunked-prefill volume and
            # prefill->decode handoffs, fleet-wide
            "prefill_chunks": {
                "enabled": any(getattr(s, "prefill_chunk", 0) > 0
                               for s in servers),
                "dispatches": total("prefill_chunk_dispatches"),
                "requests": total("prefill_chunked_requests"),
            },
            "handoffs": {
                "out": total("handoffs_out"),
                "in": total("handoffs_in"),
            },
            # live migration: sessions frozen out / adopted
            # in, split by HOW the pages moved — owner swap (shared
            # pool, ids only) vs gathered content — plus the bytes the
            # swaps did NOT copy and the freeze->resume stall the
            # moved streams actually saw
            "migrations": {
                "out": mtotal("migrations_out"),
                "in": mtotal("migrations_in"),
                "local": mtotal("migrations_local"),
                "remote": mtotal("migrations_remote"),
                "pages_moved": mtotal("migrate_pages_moved"),
                "bytes_avoided": mtotal("migrate_bytes_avoided"),
                "bytes_wire": mtotal("migrate_bytes_wire"),
                "delta_in": mtotal("migrate_delta_in"),
                "freeze_resume_ms": round(
                    mtotal("migrate_freeze_resume_ms"), 3),
            },
            # sharded replicas: mesh topology rollup —
            # device/shard counts ride the flat counters (so remote
            # agents report too); the axis layout comes from the first
            # local sharded engine
            "mesh": {
                "enabled": any("mesh_devices" in c for c in counts),
                "devices": max((c.get("mesh_devices", 1)
                                for c in counts), default=1),
                "kv_shards": max((c.get("mesh_kv_shards", 1)
                                  for c in counts), default=1),
                "param_bytes_per_chip": max(
                    (c.get("mesh_param_bytes_per_chip", 0)
                     for c in counts), default=0),
                "topology": next(
                    (s.mesh_info()["axes"] for s in servers
                     if callable(getattr(s, "mesh_info", None))
                     and getattr(s, "mesh", None) is not None), {}),
            },
            # the host-RAM page tier (serve/tier.py): spill/restore
            # volume and residency — page_ins > 0 under prefix traffic
            # is the tier paying for itself, page_ins high while
            # kv_pages is pressured is the kv_host_thrash alert
            "kv_host": {
                "enabled": any(getattr(s, "host_tier", None) is not None
                               for s in servers),
                "entries": total("kv_host_entries"),
                "bytes": total("kv_host_bytes"),
                "budget_bytes": total("kv_host_budget_bytes"),
                "tokens": total("kv_host_tokens"),
                "spills": total("kv_host_spills"),
                "page_ins": total("kv_host_page_ins"),
                "spill_bytes": total("kv_host_spill_bytes"),
                "page_in_bytes": total("kv_host_page_in_bytes"),
                "evictions": total("kv_host_evictions"),
            },
            # the paged-KV utilization block (ROADMAP 4's fixed-shape-
            # waste sensor): how many pages exist / hold tokens / are
            # shared copy-on-write, and how many bytes that keeps
            # resident vs the tokens actually living in them
            "kv_pages": {
                "enabled": any(s.paged for s in servers),
                "total": total("kv_pages_total"),
                "used": total("kv_pages_used"),
                "free": total("kv_pages_free"),
                "reserved": total("kv_pages_reserved"),
                "cow_shared": total("kv_cow_shared"),
                "cow_forks": total("kv_cow_forks"),
                "page_size": max((c.get("kv_page_size", 0)
                                  for c in counts), default=0),
                "bytes_resident": total("kv_bytes_resident"),
                "tokens_resident": total("kv_tokens_resident"),
            },
        }
