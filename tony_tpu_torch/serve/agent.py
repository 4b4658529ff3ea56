"""The replica agent: one ``serve.Server`` behind a thin HTTP shim.

The remote half of the TonY container story, serving flavor: the
gateway (the ApplicationMaster analog) acquires hosts through
``coordinator/provisioner.py`` and the work runs THERE — this module
is the TaskExecutor it launches on each host (``python -m
tony_tpu_torch.cli.replica``). It deliberately knows nothing about routing,
admission tiers, failover or supervision; all of that stays in the
gateway, which drives the agent through four endpoints (the wire
behind ``gateway/remote.RemoteServer``):

  POST /v1/submit     one engine request: ``{"id", "prompt": [ids],
                      "max_new_tokens", "temperature", "top_k",
                      "seed", "epoch"}``. Engine refusals keep their
                      types over the wire (``kind`` = "QueueFull" /
                      "PoolExhausted" / "ValueError") so the stub can
                      re-raise them and the gateway's admission paths
                      behave identically local or remote.
  GET  /v1/stream/<id>?offset=N&epoch=E
                      resumable NDJSON: ``{"offset", "token_ids",
                      "epoch"}`` lines at ABSOLUTE token offsets, a
                      ``{"keepalive": true}`` line at least every
                      ``keepalive_s`` while idle (so a healthy-but-
                      quiet stream never trips the client's read
                      timeout), and a final ``{"done": true,
                      "result": {...}}`` line. A dropped connection
                      costs nothing: reconnect with ``offset`` =
                      tokens already received and the stream resumes
                      exactly there — reconnect, not failover. The
                      terminal line additionally carries ``obs``: the
                      dispatch-timeline record fragments THIS request
                      rode (admits by request_id, decode/verify by the
                      ``requests`` tag) — so the gateway can graft the
                      request's complete span set into its trace
                      BEFORE delivering, instead of losing the tail
                      of a short request to the next obs-pull's lag.
                      (The puller dedups against these by agent seq.)
  POST /v1/migrate_in live migration, adopt half: the
                      /v1/submit contract plus ``migrate``, a frozen
                      session's wire snapshot (serve/migrate.py) —
                      pages ride the same base64 leaf codec as
                      /v1/handoff; the engine resumes decode at the
                      exact position with no prefill.
  POST /v1/migrate_out
                      live migration, freeze half: ``{"id", "epoch"}``
                      -> ``{"found", "snapshot"}``; the agent freezes
                      the live slot at a dispatch boundary, drops its
                      ticket (the stream continues from the adopting
                      replica), and the session's pages/sampler state
                      leave in wire form.
  GET  /v1/parked     orphaned-session parking: every
                      session a (re)connecting gateway can adopt —
                      in-flight slots frozen by the gateway-liveness
                      watchdog (the gateway's heartbeat went silent
                      past ``gateway_grace_s``) plus finished-but-
                      undelivered results, each held ``park_ttl_s``.
  POST /v1/adopt      ``{"id": rid, "epoch"}`` -> the parked session's
                      wire snapshot (or its finished result) — the
                      restart-recovery hand-off. The epoch fence is
                      the double-adopt guard: a second gateway on a
                      stale epoch gets 409, never a second copy; an
                      unknown/reaped rid gets 404 and the caller
                      re-runs from the prompt.
  POST /v1/reset      ``{"epoch"}``: adopt the (newer) epoch, hard-
                      reset the engine, drop every ticket — the
                      gateway's breaker recovery calls this before a
                      probe, so a wedged-then-revived agent sheds its
                      ghost requests instead of decoding for tickets
                      that re-ran elsewhere long ago.
  POST /v1/drain      stop admitting (submit -> 503), finish every
                      in-flight and pending request, reply
                      ``{"drained": true}``. SIGTERM in the CLI takes
                      this path too — the agent deregisters by
                      draining, never by vanishing.
  GET  /healthz       the heartbeat target: engine counters, epoch,
                      slots, ``ok``/``failed``/``draining``, and
                      ``t_mono`` (this process's monotonic clock — the
                      gateway's RTT-midpoint clock-offset estimate
                      reads it) — one cheap GET the gateway's lease
                      rides on.
  GET  /v1/obs?cursor=N
                      the fleet observability channel: the
                      engine's dispatch-timeline records with
                      ``seq > cursor`` still in the ring (wire form of
                      ``obs.timeline.DispatchRecord``, timestamps in
                      THIS process's monotonic clock), the lifetime
                      per-kind timeline summary, and the goodput
                      ledger — everything the gateway's obs-puller
                      needs to make this host as observable as an
                      in-process replica. Pull-based and cursor-
                      incremental so a slow gateway costs the agent
                      nothing but the GET; records evicted before
                      being pulled are simply gone (bounded memory
                      beats completeness for a debug channel). No
                      epoch fence: reading records cannot corrupt
                      state, and a fence would only blind the gateway
                      during the exact recoveries it most wants to see.
  POST /v1/profile    ``{"steps": N}``: arm a torch.profiler capture of
                      THIS agent's next N working stepper iterations
                      (the remote half of the gateway's
                      ``POST /debug/profile`` fan-out); the trace
                      files land on THIS host under the agent's
                      profile dir. GET /v1/profile reports status.

EPOCH FENCE, agent side (the gateway's fencing token carried over the
wire): every call carries the gateway's epoch for this replica and
every response echoes the epoch the agent is on. The agent adopts any
NEWER epoch it sees and answers 409 to any OLDER one — so once the
gateway has failed this replica over (bumping the epoch), a revived
agent's stale submissions are refused and its stale stream lines are
discarded client-side by the echo check. Neither side ever acts on
the other's past.

Engine faults (``TONY_SERVE_FAULTS``, serve/faults.py) arm the
agent's OWN engine via its environment — a ``step()`` that raises
marks the agent ``failed`` (healthz ok=false, streams end with an
error line, submits 503) until a reset revives it, which is exactly
the wedged-replica shape the gateway's breaker knows how to probe.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qsl, unquote

from tony_tpu_torch.serve.engine import Request, Result, Server

log = logging.getLogger(__name__)

# how long a finished ticket's tokens+result stay fetchable, so a
# client that lost its connection right before the done line can
# reconnect and still collect the result (resume-by-offset covers the
# tokens; this covers the terminal line). The agent generalizes this
# into the agent's PARK TTL: orphaned in-flight sessions (gateway
# lease gone silent) freeze into wire snapshots and stay adoptable
# for the same window.
FINISHED_KEEP_S = 60.0


class _StaleEpoch(Exception):
    """A call carried an epoch older than the one this agent adopted."""


class _Ticket:
    """One live-or-recently-finished request's agent-side record.
    ``seq0`` is the engine timeline's sequence number at submit time:
    every dispatch record this request rode has ``seq > seq0``, so the
    terminal-line fragment gather scans only the request's own tail of
    the ring, never the whole ring."""

    __slots__ = ("id", "tokens", "result", "t_done", "seq0", "rid",
                 "epoch")

    def __init__(self, request_id, seq0: int = 0, rid=None,
                 epoch: int = 0):
        self.id = request_id
        self.tokens: list[int] = []
        self.result: dict | None = None
        self.t_done: float | None = None
        self.seq0 = seq0
        # the GATEWAY's request id, when the submit carried
        # one — the agent keys tickets by the gateway's per-replica
        # engine id, but parking must be addressable by the id a
        # RESTARTED gateway still knows: the one in its journal
        self.rid = rid
        # the epoch the submit arrived under: the idempotence guard is
        # scoped to it, because a RESTARTED gateway's engine-id counter
        # starts over — its id 1 colliding with the dead incarnation's
        # finished-but-retained id 1 is a fresh request, not a retry
        self.epoch = epoch


def result_doc(res: Result) -> dict:
    """A ``serve.Result`` as its wire form (and back via
    ``result_from_doc``) — the exact fields the gateway's ``_deliver``
    reads. A prefill-pool HANDOFF result additionally carries the page
    payload + last-position logits, base64-encoded leaf-by-leaf
    (serve/tier.py codec, bitwise)."""
    out = {
        "id": res.id,
        "prompt": list(res.prompt),
        "tokens": list(res.tokens),
        "finish_reason": res.finish_reason,
        "prefix_hit_tokens": res.prefix_hit_tokens,
        "prefill_tokens_saved": res.prefill_tokens_saved,
        "drafted": res.drafted,
        "accepted": res.accepted,
        "prefill_chunks": res.prefill_chunks,
    }
    if res.handoff is not None:
        from tony_tpu_torch.serve.tier import encode_array, encode_payload

        out["handoff"] = {
            "n_tokens": int(res.handoff["n_tokens"]),
            "pages": encode_payload(res.handoff["pages"]),
            "logits": encode_array(res.handoff["logits"]),
        }
    return out


def result_from_doc(doc: dict) -> Result:
    res = Result(
        id=doc["id"], prompt=list(doc["prompt"]),
        tokens=list(doc["tokens"]), finish_reason=doc["finish_reason"],
        prefix_hit_tokens=int(doc.get("prefix_hit_tokens", 0)),
        prefill_tokens_saved=int(doc.get("prefill_tokens_saved", 0)),
        drafted=int(doc.get("drafted", 0)),
        accepted=int(doc.get("accepted", 0)),
        prefill_chunks=int(doc.get("prefill_chunks", 0)))
    # the payload stays in WIRE form: a pure-router gateway relays it
    # to the decode replica verbatim, and the receiving ENGINE decodes
    # against its own cache treedef (local engines take it directly;
    # remote stubs pass it through /v1/handoff untouched)
    res.handoff = doc.get("handoff")
    return res


class ReplicaAgent:
    """Owns the engine and the ONE thread allowed to ``step()`` it.

    HTTP handler threads only ever call the engine's thread-safe
    ``submit()``; everything else (step, reset, drain) runs on the
    stepper thread, fed through a small command list — the same
    single-owner step contract the in-process ``_Replica`` keeps."""

    def __init__(self, server: Server, *, agent_id: str | None = None,
                 keepalive_s: float = 0.5,
                 profile_dir: str | None = None,
                 park_ttl_s: float | None = None,
                 gateway_grace_s: float = 0.0):
        from tony_tpu_torch.profiler import ServeProfiler

        self.server = server
        self.agent_id = agent_id or f"agent-{uuid.uuid4().hex[:8]}"
        self.keepalive_s = max(0.05, keepalive_s)
        # orphaned-session parking: how long a parked
        # snapshot or finished-but-undelivered result stays adoptable
        # (generalizes FINISHED_KEEP_S), and how long the gateway may
        # go silent before in-flight slots freeze into parked
        # snapshots instead of decoding into the void (0 = watchdog
        # off: slots run to completion and park as finished results)
        self.park_ttl_s = FINISHED_KEEP_S if park_ttl_s is None \
            else max(1.0, float(park_ttl_s))
        self.gateway_grace_s = max(0.0, float(gateway_grace_s))
        self._last_contact = time.monotonic()
        self._parked: dict = {}  # rid -> {snapshot, epoch, offset, t_park}
        # on-demand torch.profiler captures (POST /v1/profile — the remote half
        # of the gateway's /debug/profile fan-out): polled once per
        # WORKING stepper iteration; an un-armed poll is one attribute
        # read
        self.profiler = ServeProfiler(profile_dir)
        self.epoch = 0
        self.failed: str | None = None
        self.draining = False
        self.drained = threading.Event()  # the CLI's exit signal
        self._tickets: dict = {}
        self._cmds: list = []  # (kind, done_event) for the stepper
        # stepper heartbeat: refreshed once per loop iteration (idle
        # waits included). A dispatch that WEDGES inside step() stops
        # it — /healthz exposes the age so the gateway's lease can
        # treat a wedged-but-network-healthy agent as dead for serving
        self.last_step_beat = time.monotonic()
        self._cond = threading.Condition()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop,
                                        name="replica-agent-step",
                                        daemon=True)

    # ------------------------------------------------------- lifecycle

    def start(self) -> "ReplicaAgent":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        with self._cond:
            self._cond.notify_all()
        self._thread.join(timeout=5)
        # finalize a capture left mid-flight (operator armed it, the
        # agent drained) so its trace files land
        self.profiler.close()

    # ------------------------------------------------------- the wire

    def check_epoch(self, epoch: int) -> None:
        """Adopt a newer epoch, refuse an older one (409 upstream).
        Under the condition lock so adopt-vs-adopt can't interleave."""
        # every epoch-carrying call is gateway contact: the parking
        # watchdog's liveness signal. A STALE call counts
        # too — a gateway on an old epoch is alive, just fenced.
        self._last_contact = time.monotonic()
        with self._cond:
            if epoch < self.epoch:
                raise _StaleEpoch(
                    f"stale epoch {epoch} (agent is on {self.epoch})")
            if epoch > self.epoch:
                log.info("agent %s adopting epoch %d (was %d)",
                         self.agent_id, epoch, self.epoch)
                self.epoch = epoch

    def submit(self, doc: dict) -> dict:
        """POST /v1/submit body -> response doc. Raises the engine's
        own refusal types (handler maps them to status + ``kind``)."""
        self.check_epoch(int(doc.get("epoch", 0)))
        if self.draining:
            raise RuntimeError("agent is draining")
        if self.failed is not None:
            raise RuntimeError(f"agent failed: {self.failed}")
        req = Request(
            prompt=[int(t) for t in doc["prompt"]],
            max_new_tokens=int(doc.get("max_new_tokens", 64)),
            temperature=float(doc.get("temperature", 0.0)),
            top_k=int(doc.get("top_k", 0)),
            seed=int(doc.get("seed", 0)),
            id=doc.get("id"),
            # disaggregation over the wire: prefill_only rides
            # /v1/submit; a handoff payload arrives via /v1/handoff
            # (same body + the encoded pages) — the engine decodes it
            prefill_only=bool(doc.get("prefill_only", False)),
            handoff=doc.get("handoff"),
            # live migration: a frozen session's wire doc
            # arrives via /v1/migrate_in — the engine adopts it with no
            # prefill and resumes decode at the exact position
            migrate=doc.get("migrate"))
        with self._cond:
            # IDEMPOTENT on the request id WITHIN the epoch: the stub
            # retries connect errors, and a reset that lands after the
            # agent processed the submit but before the stub read the
            # 200 would otherwise enqueue the same request twice
            # (double slot + page consumption under one id). A
            # colliding id under an OLDER epoch is a different gateway
            # incarnation (a restarted gateway's engine-id
            # counter starts over, and finished tickets of the dead
            # one linger for the reconnect grace) — evict the stale
            # record and admit fresh, or the recovered dispatch would
            # stream a dead gateway's result
            held = self._tickets.get(req.id)
            if held is not None and held.epoch >= self.epoch:
                return {"ok": True, "id": req.id, "epoch": self.epoch,
                        "duplicate": True}
            if held is not None:
                del self._tickets[req.id]
            # ticket registered UNDER the lock before the engine sees
            # the request: a stream connecting right after the 200 must
            # find it. seq0 read BEFORE the engine submit: any record
            # this request rides has a later sequence number.
            tl = self.server.timeline
            seq0 = tl.seq if tl is not None else 0
            self.server.submit(req)  # engine submit() is thread-safe;
            # inside our lock only to pair with the ticket insert
            self._tickets[req.id] = _Ticket(req.id, seq0,
                                            rid=doc.get("rid"),
                                            epoch=self.epoch)
            self._cond.notify_all()
        return {"ok": True, "id": req.id, "epoch": self.epoch}

    def reset(self, epoch: int) -> dict:
        """POST /v1/reset: adopt the epoch, hard-reset the engine on
        the stepper thread, drop every ticket."""
        self.check_epoch(int(epoch))
        done = threading.Event()
        with self._cond:
            self._cmds.append(("reset", done))
            self._cond.notify_all()
        if not done.wait(timeout=10):
            raise RuntimeError("reset did not complete in 10s")
        return {"ok": True, "epoch": self.epoch}

    def drain(self, timeout_s: float = 120.0) -> dict:
        """POST /v1/drain: stop admitting, finish everything."""
        self.draining = True
        with self._cond:
            self._cond.notify_all()
        deadline = time.monotonic() + max(0.0, timeout_s)
        with self._cond:
            while not self.server.done and self.failed is None \
                    and time.monotonic() < deadline:
                self._cond.wait(timeout=0.1)
            ok = self.server.done
        self.drained.set()
        return {"drained": bool(ok), "epoch": self.epoch}

    def healthz(self) -> dict:
        # the heartbeat IS the gateway's liveness signal to us: the
        # inverse of the gateway's lease (they watch our stepper_age_s,
        # we watch their heartbeat cadence)
        self._last_contact = time.monotonic()
        server = self.server
        return {
            "ok": self.failed is None,
            "failed": self.failed,
            "draining": self.draining,
            "agent_id": self.agent_id,
            "pid": os.getpid(),
            "epoch": self.epoch,
            "batch_size": server.slots.batch_size,
            "max_seq_len": server.model.cfg.max_seq_len,
            "n_active": server.n_active,
            "n_pending": server.n_pending,
            "stepper_age_s": round(
                time.monotonic() - self.last_step_beat, 3),
            "paged": bool(server.paged),
            "speculate_k": server.speculate_k,
            "prefix": server.prefix is not None,
            # bounded radix summary: [[n_tokens, crc32],
            # ...] of cached prefixes, so the gateway's prefix-affinity
            # probe can score THIS remote replica instead of assuming 0
            "prefix_summary": server.prefix_summary(),
            "n_parked": len(self._parked),
            "park_ttl_s": self.park_ttl_s,
            "counters": server.counters(),
            # this process's monotonic clock, read in-handler: the
            # gateway brackets the call and estimates the clock offset
            # as t_mono - RTT midpoint (uncertainty = RTT/2)
            "t_mono": time.monotonic(),
        }

    def migrate_out(self, doc: dict) -> dict:
        """POST /v1/migrate_out: freeze one live session into its wire
        snapshot and drop its ticket — the source half of a remote
        migration. The engine's dispatch lock lands the
        freeze at a dispatch boundary, so the snapshot is token-exact
        no matter where the stepper was. ``found: false`` when the
        request is not in a live decode slot (still pending or
        mid-prefill — nothing worth moving; the caller re-runs it as
        an ordinary request)."""
        from tony_tpu_torch.serve.migrate import snapshot_to_doc

        self.check_epoch(int(doc.get("epoch", 0)))
        if self.failed is not None:
            raise RuntimeError(f"agent failed: {self.failed}")
        rid = doc.get("id")
        snap = self.server.extract_session(rid, wire=True)
        if snap is None:
            return {"found": False, "epoch": self.epoch}
        with self._cond:
            # the ticket moves with the session: its stream continues
            # from the ADOPTING replica, and leaving it here would
            # park a never-finishing entry on the mux channel
            self._tickets.pop(rid, None)
            self._cond.notify_all()
        return {"found": True, "snapshot": snapshot_to_doc(snap),
                "epoch": self.epoch}

    # ------------------------------------- orphan parking

    def parked(self) -> dict:
        """GET /v1/parked: every session a (re)connecting gateway can
        adopt — frozen in-flight snapshots AND finished-but-undelivered
        results (both held through the park TTL). No epoch fence:
        listing is read-only, and a recovering gateway needs it BEFORE
        it knows what epoch to adopt with."""
        now = time.monotonic()
        with self._cond:
            rows = [{"rid": rid, "epoch": p["epoch"],
                     "offset": p["offset"], "finished": False,
                     "age_s": round(now - p["t_park"], 3)}
                    for rid, p in self._parked.items()]
            rows += [{"rid": t.rid if t.rid is not None else t.id,
                      "epoch": self.epoch, "offset": len(t.tokens),
                      "finished": True,
                      "age_s": round(now - t.t_done, 3)}
                     for t in self._tickets.values()
                     if t.result is not None]
        return {"parked": rows, "epoch": self.epoch,
                "park_ttl_s": self.park_ttl_s}

    def adopt(self, doc: dict) -> dict:
        """POST /v1/adopt ``{"id": rid, "epoch"}``: hand one parked
        session to the calling gateway. The epoch fence IS the
        double-adopt guard: the first adopter arrives with a bumped
        epoch the agent adopts; a second gateway still on the old one
        gets 409, never a second copy. Resolution order — a parked
        snapshot, then a still-live slot (frozen on the spot, so a
        recovering gateway never waits out the watchdog grace), then a
        finished-but-undelivered result; ``found: false`` (404
        upstream) when the rid is unknown or the TTL already reaped
        it, and the caller re-runs from the prompt."""
        from tony_tpu_torch.serve.migrate import snapshot_to_doc

        self.check_epoch(int(doc.get("epoch", 0)))
        rid = doc.get("id")
        with self._cond:
            p = self._parked.pop(rid, None)
        if p is not None:
            return {"found": True, "snapshot": p["snapshot"],
                    "offset": p["offset"], "epoch": self.epoch}
        engine_id = finished = None
        with self._cond:
            for t in self._tickets.values():
                if t.rid == rid or t.id == rid:
                    if t.result is not None:
                        finished = t
                    else:
                        engine_id = t.id
                    break
        if finished is not None:
            with self._cond:
                self._tickets.pop(finished.id, None)
                self._cond.notify_all()
            return {"found": True, "finished": True,
                    "result": finished.result, "epoch": self.epoch}
        if engine_id is not None:
            snap = self.server.extract_session(engine_id, wire=True)
            if snap is not None:
                with self._cond:
                    self._tickets.pop(engine_id, None)
                    self._cond.notify_all()
                return {"found": True,
                        "snapshot": snapshot_to_doc(snap),
                        "offset": len(snap.generated),
                        "epoch": self.epoch}
        return {"found": False, "epoch": self.epoch}

    def _watchdog_tick(self) -> None:
        """One stepper-loop beat of the parking machinery: reap parked
        entries past the TTL (the pages they held were gathered to
        host memory at freeze time — reaping is a dict delete), then
        freeze orphans once the gateway has been silent past the
        grace."""
        now = time.monotonic()
        with self._cond:
            dead = [rid for rid, p in self._parked.items()
                    if now - p["t_park"] > self.park_ttl_s]
            for rid in dead:
                del self._parked[rid]
        if dead:
            log.info("agent %s reaped %d parked session(s) past the "
                     "%.0fs park TTL", self.agent_id, len(dead),
                     self.park_ttl_s)
        if self.gateway_grace_s <= 0 or self.draining \
                or self.failed is not None:
            return
        if now - self._last_contact <= self.gateway_grace_s:
            return
        self._park_orphans()

    def _park_orphans(self) -> None:
        """Freeze every live decode slot into a parked wire snapshot —
        the gateway lease went silent, so instead of decoding into the
        void (and then aborting), the sessions park token-exact and
        wait for a recovering gateway's /v1/adopt. Runs on the stepper
        thread; ``extract_session`` lands each freeze at a dispatch
        boundary. Requests still pending (no slot yet) keep running
        and park later — as live slots on a future tick, or as
        finished-but-undelivered results."""
        from tony_tpu_torch.serve.migrate import snapshot_to_doc

        with self._cond:
            live = [(t.id, t.rid) for t in self._tickets.values()
                    if t.result is None]
        n = 0
        for engine_id, rid in live:
            try:
                snap = self.server.extract_session(engine_id, wire=True)
            except Exception:
                log.exception("freeze-for-parking failed (%r)",
                              engine_id)
                continue
            if snap is None:
                continue  # pending / mid-prefill: nothing frozen yet
            key = rid if rid is not None else engine_id
            with self._cond:
                self._parked[key] = {
                    "snapshot": snapshot_to_doc(snap),
                    "epoch": self.epoch,
                    "offset": len(snap.generated),
                    "t_park": time.monotonic(),
                }
                self._tickets.pop(engine_id, None)
                self._cond.notify_all()
            n += 1
        if n:
            log.warning(
                "agent %s: gateway silent %.1fs — parked %d in-flight "
                "session(s) (TTL %.0fs)", self.agent_id,
                time.monotonic() - self._last_contact, n,
                self.park_ttl_s)

    def obs(self, cursor: int) -> dict:
        """GET /v1/obs payload: incremental timeline records past
        ``cursor``, the lifetime summary, and the goodput ledger.
        Degrades to an empty channel with the timeline off — an agent
        booted ``timeline=False`` is unobservable, not broken."""
        from tony_tpu_torch.obs.timeline import record_doc

        tl = self.server.timeline
        if tl is None:
            return {"cursor": 0, "records": [], "summary": {},
                    "goodput": None, "epoch": self.epoch,
                    "t_mono": time.monotonic()}
        new, new_cursor = tl.take_new(max(0, int(cursor)))
        return {
            "cursor": new_cursor,
            "records": [record_doc(r) for r in new],
            "summary": tl.summary(),
            "goodput": self.server.goodput(),
            "epoch": self.epoch,
            "t_mono": time.monotonic(),
        }

    def request_obs(self, request_id) -> list:
        """The dispatch-record fragments one request rode (wire form),
        scanned from the timeline ring at stream end: admit records by
        ``request_id``, decode/verify records by the ``requests`` tag.
        Rides the stream's terminal line so the gateway grafts a
        finished request's COMPLETE span set before delivery — the
        cursor pull alone would lose the tail of any request shorter
        than one heartbeat. The scan anchors at the ticket's
        submit-time seq (``since(seq0)``) — the request's own slice of
        the ring, not the whole ring, so the gather cannot contend
        O(ring) work per finished request against the engine's hot
        ``record()`` lock. Ring-bounded like everything else here:
        records already evicted are gone, which only happens to
        requests that outlived the whole ring."""
        tl = self.server.timeline
        if tl is None:
            return []
        from tony_tpu_torch.obs.timeline import record_doc

        with self._cond:
            ticket = self._tickets.get(request_id)
            seq0 = ticket.seq0 if ticket is not None else 0
        out = []
        for rec in tl.since(seq0):
            if rec.request_id == request_id or request_id in (
                    rec.tags.get("requests") or ()):
                out.append(record_doc(rec))
        return out

    # -------------------------------------------------------- stepper

    def _loop(self) -> None:
        while not self._stop.is_set():
            self.last_step_beat = time.monotonic()
            # BEFORE the idle short-circuit: a fully-parked agent is
            # idle (its slots were extracted), but the TTL reap and
            # the gateway-liveness watchdog must still run
            self._watchdog_tick()
            with self._cond:
                cmds, self._cmds = self._cmds, []
                busy = bool(self.server.n_active or self.server.n_pending)
                if not cmds and (not busy or self.failed is not None):
                    self._cond.wait(timeout=0.05)
                    continue
            for kind, done in cmds:
                if kind == "reset":
                    try:
                        self.server.reset()
                    except Exception:
                        log.exception("agent engine reset failed")
                    with self._cond:
                        self._tickets.clear()
                        self.failed = None
                        self._cond.notify_all()
                    done.set()
            if self.failed is not None:
                continue
            if not (self.server.n_active or self.server.n_pending):
                continue
            try:
                finished = self.server.step()
                # one WORKING iteration: the on-demand profile capture
                # counts it (near-free attribute read while un-armed) —
                # the agent-side twin of the gateway replica loop's poll
                self.profiler.poll()
                with self._cond:  # snapshot: submits mutate the dict
                    seen = {t.id: len(t.tokens)
                            for t in self._tickets.values()
                            if t.result is None}
                progress = self.server.live_progress(seen)
            except Exception as e:  # noqa: BLE001 — an engine failure
                # (injected or real) must not kill the agent process:
                # mark failed, end the streams, let the GATEWAY's
                # supervision decide (its heartbeat sees ok=false, its
                # breaker revives us through /v1/reset + probe)
                log.exception("agent engine step failed")
                try:
                    self.server.reset()
                except Exception:
                    log.exception("agent engine reset after failure")
                with self._cond:
                    self.failed = f"{type(e).__name__}: {e}"
                    self._tickets.clear()
                    self._cond.notify_all()
                continue
            now = time.monotonic()
            with self._cond:
                for rid, new in progress.items():
                    t = self._tickets.get(rid)
                    # ``new`` is the TAIL past what we already hold
                    # (live_progress(since=held)): append it — only
                    # this thread mutates tokens, so held counts taken
                    # above are still exact here
                    if t is not None and t.result is None and new:
                        t.tokens.extend(new)
                for res in finished:
                    t = self._tickets.get(res.id)
                    if t is None:  # e.g. the breaker probe driven by
                        continue   # run()? every submit makes a ticket
                    t.tokens = list(res.tokens)
                    t.result = result_doc(res)
                    t.t_done = now
                # prune finished tickets past the reconnect grace
                # (the park TTL — FINISHED_KEEP_S default)
                for rid in [rid for rid, t in self._tickets.items()
                            if t.t_done is not None
                            and now - t.t_done > self.park_ttl_s]:
                    del self._tickets[rid]
                self._cond.notify_all()

    # --------------------------------------------------------- streams

    def stream_events(self, request_id, offset: int, epoch: int):
        """Generator of NDJSON docs for GET /v1/stream/<id>: token
        windows at absolute offsets from ``offset`` on, keepalives
        while idle, one terminal doc (done / error), then ends. Runs
        on the HTTP handler's own thread; only reads agent state under
        the condition."""
        self.check_epoch(epoch)
        offset = max(0, int(offset))
        last_emit = time.monotonic()
        while True:
            # each lap follows a frame the caller consumed (or is the
            # first): a gateway actively reading this stream is NOT
            # silent — refresh the parking watchdog's liveness signal
            self._last_contact = time.monotonic()
            with self._cond:
                t = self._tickets.get(request_id)
                if t is None:
                    yield {"error": f"unknown ticket {request_id!r}",
                           "gone": True, "epoch": self.epoch}
                    return
                if self.epoch != epoch:
                    # the gateway moved on mid-stream (reset/adopt):
                    # this stream is a previous epoch's — end it
                    yield {"error": "epoch superseded", "stale": True,
                           "epoch": self.epoch}
                    return
                if self.failed is not None:
                    yield {"error": self.failed, "failed": True,
                           "epoch": self.epoch}
                    return
                if t.epoch != epoch:
                    # a DEAD incarnation's leftover still holds this
                    # engine id (restarted gateways restart their id
                    # counters; finished tickets are retained a park
                    # TTL for reconnects): serving ITS tokens would
                    # hand the caller another request's output. The
                    # fresh submit that evicts it is in flight — wait.
                    self._cond.wait(timeout=self.keepalive_s)
                    tokens, result = [], None
                else:
                    tokens = t.tokens[offset:]
                    result = t.result
                    if not tokens and result is None:
                        self._cond.wait(timeout=self.keepalive_s)
                        tokens = t.tokens[offset:]
                        result = t.result
            if tokens:
                yield {"offset": offset, "token_ids": tokens,
                       "epoch": self.epoch}
                offset += len(tokens)
                last_emit = time.monotonic()
            if result is not None:
                yield {"done": True, "result": result,
                       "obs": self.request_obs(request_id),
                       "epoch": self.epoch}
                return
            if time.monotonic() - last_emit >= self.keepalive_s:
                yield {"keepalive": True, "epoch": self.epoch}
                last_emit = time.monotonic()

    def channel_events(self, resume: dict, epoch: int,
                       obs_cursor: int | None = None):
        """Generator of tagged NDJSON frames for POST /v1/channel — the
        MULTIPLEXED form of ``stream_events``: ONE long-lived
        connection carries every ticket's stream, each frame tagged with
        its request id:

          {"channel": true, "resumed": N, "epoch"}     the accept frame
          {"rid", "off", "token_ids", "epoch"}         token window at
                                                       absolute offset
          {"rid", "done": true, "result", "obs", "epoch"}  terminal
          {"rid", "gone": true, "epoch"}               unknown ticket
                                                       (agent restart)
          {"keepalive": true, "epoch"}                 idle heartbeat
          {"obs": <v1/obs doc>, "epoch"}               incremental obs
                                                       batch (when the
                                                       caller sent
                                                       obs_cursor)
          {"stale": true, ...} / {"failed": true, ...} channel over

        ``resume`` maps request id -> tokens the caller already holds;
        a reconnect re-establishes EVERY in-flight stream at its
        absolute offset in this one round trip. Tickets the agent
        finished that the caller did NOT name in ``resume`` were fully
        delivered on a previous channel incarnation — they are skipped,
        never double-delivered. Tickets submitted while the channel is
        live join it automatically from offset 0.

        With ``obs_cursor`` the observability pull rides the same
        wire: whenever the timeline holds records past the cursor, a
        full /v1/obs document goes out as an ``obs`` frame (the stub
        ingests it exactly like a pull response; its seq-dedup makes
        the occasional overlap with a GET pull harmless)."""
        self.check_epoch(epoch)
        offsets = {rid: max(0, int(off)) for rid, off in resume.items()}
        with self._cond:
            # finished tickets the caller did not ask to resume were
            # delivered before this channel opened — never re-stream.
            # Epoch-scoped: a DEAD incarnation's finished ticket under
            # a colliding id must not block the fresh ticket that will
            # evict it from ever joining this channel.
            done_sent = {rid for rid, t in self._tickets.items()
                         if t.result is not None and rid not in offsets
                         and t.epoch == epoch}
        yield {"channel": True, "resumed": len(offsets),
               "epoch": self.epoch}
        last_emit = time.monotonic()
        while True:
            # each lap follows frames the gateway's demux consumed: an
            # actively-read channel IS gateway contact — refresh the
            # parking watchdog so slow control calls (a wedged adopt
            # monopolizing the control connection) can't orphan
            # sessions the gateway is demonstrably streaming
            self._last_contact = time.monotonic()
            token_frames: list = []
            done_rids: list = []
            terminal: dict | None = None
            with self._cond:
                if self.epoch != epoch:
                    terminal = {"error": "epoch superseded",
                                "stale": True, "epoch": self.epoch}
                elif self.failed is not None:
                    terminal = {"error": self.failed, "failed": True,
                                "epoch": self.epoch}
                else:
                    # new submits join the channel from offset 0 —
                    # only THIS epoch's; a dead incarnation's retained
                    # tickets are adopt/reconnect state, not streams
                    for rid, t in self._tickets.items():
                        if rid not in offsets and rid not in done_sent \
                                and t.epoch == epoch:
                            offsets[rid] = 0
                    for rid in list(offsets):
                        t = self._tickets.get(rid)
                        if t is None:
                            # resume named a ticket the agent no longer
                            # holds (restart / pruned): the stub's
                            # restart-detection case, per stream
                            token_frames.append(
                                {"rid": rid, "gone": True,
                                 "epoch": self.epoch})
                            del offsets[rid]
                            continue
                        if t.epoch != epoch:
                            # a stale-incarnation leftover under an id
                            # the stub's resume named: the in-flight
                            # submit that evicts it hasn't landed yet.
                            # Serving its tokens/result would deliver
                            # ANOTHER request's output onto this one —
                            # skip the lap; the fresh ticket replaces
                            # it at this same id momentarily.
                            continue
                        off = offsets[rid]
                        tokens = t.tokens[off:]
                        if tokens:
                            token_frames.append(
                                {"rid": rid, "off": off,
                                 "token_ids": tokens,
                                 "epoch": self.epoch})
                            offsets[rid] = off + len(tokens)
                        if t.result is not None:
                            done_rids.append((rid, t.result))
                            del offsets[rid]
                            done_sent.add(rid)
                    if not token_frames and not done_rids:
                        self._cond.wait(timeout=self.keepalive_s)
            if terminal is not None:
                yield terminal
                return
            for frame in token_frames:
                yield frame
                last_emit = time.monotonic()
            for rid, result in done_rids:
                # request_obs takes the condition lock itself — the
                # gather runs OUTSIDE the lock held above
                yield {"rid": rid, "done": True, "result": result,
                       "obs": self.request_obs(rid),
                       "epoch": self.epoch}
                last_emit = time.monotonic()
            if obs_cursor is not None:
                tl = self.server.timeline
                if tl is not None and tl.seq > obs_cursor:
                    doc = self.obs(obs_cursor)
                    obs_cursor = doc["cursor"]
                    yield {"obs": doc, "epoch": self.epoch}
                    last_emit = time.monotonic()
            if time.monotonic() - last_emit >= self.keepalive_s:
                yield {"keepalive": True, "epoch": self.epoch}
                last_emit = time.monotonic()


class AgentHandler(BaseHTTPRequestHandler):
    agent: ReplicaAgent
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):
        log.debug(fmt, *args)

    # chaos hook (AgentHTTP.kill): when set, every handler aborts at
    # its next loop point and the socket dies without an HTTP goodbye —
    # the network face of SIGKILL, for in-process chaos tests
    killed = False

    def _check_killed(self) -> None:
        if type(self).killed:
            raise ConnectionAbortedError("agent killed")

    def do_GET(self):
        self._check_killed()
        path, _, query = self.path.partition("?")
        if path == "/healthz":
            return self._send(200, self.agent.healthz())
        if path == "/v1/obs":
            try:
                cursor = int(dict(parse_qsl(query)).get("cursor", 0))
            except ValueError as e:
                return self._send(400, {"error": str(e)})
            return self._send(200, self.agent.obs(cursor))
        if path == "/v1/profile":
            return self._send(200, self.agent.profiler.status())
        if path == "/v1/parked":
            return self._send(200, self.agent.parked())
        if path.startswith("/v1/stream/"):
            return self._stream(unquote(path[len("/v1/stream/"):]),
                                dict(parse_qsl(query)))
        return self._send(404, {"error": "not found"})

    def do_POST(self):
        self._check_killed()
        path = self.path.partition("?")[0]
        try:
            length = int(self.headers.get("Content-Length") or 0)
            body = json.loads(self.rfile.read(length)) if length else {}
            if not isinstance(body, dict):
                raise ValueError("request must be a JSON object")
        except (ValueError, TypeError) as e:
            return self._send(400, {"error": str(e)})
        if path == "/v1/channel":
            return self._channel(body)
        if path == "/v1/submit":
            return self._submit(body)
        if path == "/v1/handoff":
            # the decode pool's intake: same contract as /v1/submit
            # but the body carries a prefill pool's page payload —
            # separated so an operator's access log tells admission
            # traffic from page migration, and so the (much larger)
            # handoff bodies can grow their own limits later
            if "handoff" not in body:
                return self._send(400, {"error": "handoff body needs "
                                        "a 'handoff' payload"})
            return self._submit(body)
        if path == "/v1/migrate_in":
            # the adopt half of live migration: /v1/submit's
            # contract, body carries a frozen session's wire snapshot —
            # the engine resumes it with no prefill, no first-token draw
            if "migrate" not in body:
                return self._send(400, {"error": "migrate_in body "
                                        "needs a 'migrate' snapshot"})
            return self._submit(body)
        if path == "/v1/adopt":
            # restart recovery's hand-off: a parked (or
            # still-live, or finished-undelivered) session leaves for
            # the calling gateway. 404 = unknown/reaped (caller
            # re-runs from the prompt); 409 = the epoch fence caught
            # a second adopter on a stale epoch
            try:
                out = self.agent.adopt(body)
            except _StaleEpoch as e:
                return self._send(409, {"error": str(e),
                                        "epoch": self.agent.epoch})
            except (ValueError, TypeError, KeyError) as e:
                return self._send(400, {"error": str(e),
                                        "kind": "ValueError"})
            except RuntimeError as e:
                return self._send(503, {"error": str(e),
                                        "kind": "Unavailable"})
            return self._send(200 if out.get("found") else 404, out)
        if path == "/v1/migrate_out":
            try:
                return self._send(200, self.agent.migrate_out(body))
            except _StaleEpoch as e:
                return self._send(409, {"error": str(e),
                                        "epoch": self.agent.epoch})
            except (ValueError, TypeError, KeyError) as e:
                return self._send(400, {"error": str(e),
                                        "kind": "ValueError"})
            except RuntimeError as e:
                return self._send(503, {"error": str(e),
                                        "kind": "Unavailable"})
        if path == "/v1/reset":
            try:
                return self._send(200,
                                  self.agent.reset(body.get("epoch", 0)))
            except _StaleEpoch as e:
                return self._send(409, {"error": str(e),
                                        "epoch": self.agent.epoch})
            except (RuntimeError, TypeError, ValueError) as e:
                return self._send(500, {"error": str(e)})
        if path == "/v1/drain":
            timeout = float(body.get("timeout_s", 120.0))
            return self._send(200, self.agent.drain(timeout))
        if path == "/v1/profile":
            # the remote half of the gateway's /debug/profile fan-out:
            # arm a capture of this agent's next N working iterations.
            # Same status mapping as the gateway's own endpoint — 409
            # while one is pending/active (the profiler has ONE session a process)
            try:
                steps = int(body.get("steps", 10))
                logdir = self.agent.profiler.request(steps)
            except ValueError as e:
                return self._send(400, {"error": str(e)})
            except RuntimeError as e:
                return self._send(409, {"error": str(e)})
            return self._send(200, {"armed": True, "steps": steps,
                                    "logdir": logdir})
        return self._send(404, {"error": "not found"})

    def _submit(self, body: dict) -> None:
        from tony_tpu_torch.serve.engine import PoolExhausted, QueueFull
        from tony_tpu_torch.serve.migrate import StaleDelta

        try:
            return self._send(200, self.agent.submit(body))
        except _StaleEpoch as e:
            return self._send(409, {"error": str(e),
                                    "epoch": self.agent.epoch})
        except QueueFull as e:
            return self._send(429, {"error": str(e), "kind": "QueueFull"})
        except PoolExhausted as e:
            return self._send(503, {"error": str(e),
                                    "kind": "PoolExhausted"})
        except StaleDelta as e:
            # must precede ValueError (StaleDelta subclasses it): the
            # sender retries ONCE with the full snapshot on this kind
            return self._send(400, {"error": str(e), "kind": "StaleDelta"})
        except (ValueError, TypeError, KeyError) as e:
            return self._send(400, {"error": str(e),
                                    "kind": "ValueError"})
        except RuntimeError as e:  # draining / failed
            return self._send(503, {"error": str(e), "kind": "Unavailable"})

    def _channel(self, body: dict) -> None:
        """POST /v1/channel: the multiplexed stream carrier. Body
        ``{"epoch": E, "streams": [[rid, off], ...], "obs_cursor": N}``
        (streams as PAIRS, not an object — JSON object keys are always
        strings and rids can be ints). Responds with an endless chunked
        NDJSON of tagged frames (see channel_events)."""
        try:
            epoch = int(body.get("epoch", 0))
            resume = {rid: int(off)
                      for rid, off in body.get("streams") or []}
            cursor = body.get("obs_cursor")
            cursor = int(cursor) if cursor is not None else None
        except (TypeError, ValueError) as e:
            return self._send(400, {"error": str(e)})
        try:
            events = self.agent.channel_events(resume, epoch, cursor)
            first = next(events)
        except _StaleEpoch as e:
            return self._send(409, {"error": str(e),
                                    "epoch": self.agent.epoch})
        except StopIteration:
            return self._send(500, {"error": "empty channel"})
        self.send_response(200)
        self.send_header("Content-Type", "application/x-ndjson")
        self.send_header("Transfer-Encoding", "chunked")
        self.send_header("Cache-Control", "no-store")
        self.end_headers()
        self._chunk(first)
        for doc in events:
            self._check_killed()
            self._chunk(doc)
        self.wfile.write(b"0\r\n\r\n")

    def _stream(self, rid: str, params: dict) -> None:
        request_id: object = int(rid) if rid.lstrip("-").isdigit() else rid
        try:
            offset = int(params.get("offset", 0))
            epoch = int(params.get("epoch", 0))
        except ValueError as e:
            return self._send(400, {"error": str(e)})
        try:
            events = self.agent.stream_events(request_id, offset, epoch)
            first = next(events)
        except _StaleEpoch as e:
            return self._send(409, {"error": str(e),
                                    "epoch": self.agent.epoch})
        except StopIteration:  # generator contract: never empty
            return self._send(500, {"error": "empty stream"})
        # a missing ticket is a clean 404 BEFORE the stream commits:
        # the stub treats it as "the agent lost my request" (restart)
        if first.get("gone"):
            return self._send(404, first)
        self.send_response(200)
        self.send_header("Content-Type", "application/x-ndjson")
        self.send_header("Transfer-Encoding", "chunked")
        self.send_header("Cache-Control", "no-store")
        self.end_headers()
        self._chunk(first)
        for doc in events:
            self._check_killed()
            self._chunk(doc)
        self.wfile.write(b"0\r\n\r\n")

    def _chunk(self, doc: dict) -> None:
        data = (json.dumps(doc) + "\n").encode()
        self.wfile.write(f"{len(data):X}\r\n".encode() + data + b"\r\n")
        self.wfile.flush()

    def _send(self, code: int, doc: dict) -> None:
        data = json.dumps(doc).encode()
        if code >= 400:
            self.close_connection = True
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        if code >= 400:
            self.send_header("Connection", "close")
        self.end_headers()
        self.wfile.write(data)


class _AgentHTTPServer(ThreadingHTTPServer):
    def handle_error(self, request, client_address):
        # disconnects (client gone mid-stream) and the kill() chaos
        # abort are expected request endings, not tracebacks on stderr
        import sys

        exc = sys.exc_info()[1]
        if isinstance(exc, (ConnectionError, TimeoutError)):
            log.debug("agent connection ended: %r", exc)
            return
        super().handle_error(request, client_address)


class AgentHTTP:
    """Binds a ReplicaAgent to a ThreadingHTTPServer (start/stop),
    plus the ``kill()`` chaos helper: from the network's point of view
    the agent is SIGKILLed — open streams die mid-line, new
    connections are refused — while the test process lives on."""

    def __init__(self, agent: ReplicaAgent, host: str = "127.0.0.1",
                 port: int = 0):
        handler = type("BoundAgentHandler", (AgentHandler,),
                       {"agent": agent})
        self._handler = handler
        self.server = _AgentHTTPServer((host, port), handler)
        self.server.daemon_threads = True
        self.host, self.port = self.server.server_address[:2]
        self.address = f"{self.host}:{self.port}"
        self._thread: threading.Thread | None = None

    def start(self) -> "AgentHTTP":
        self.agent = self._handler.agent.start()
        self._thread = threading.Thread(target=self.server.serve_forever,
                                        name="replica-agent-http",
                                        daemon=True)
        self._thread.start()
        log.info("replica agent %s at http://%s", self.agent.agent_id,
                 self.address)
        return self

    def stop(self) -> None:
        self.server.shutdown()
        self.server.server_close()
        self._handler.agent.stop()
        # a stopped server must also stop ANSWERING: daemon handler
        # threads still hold accepted keep-alive sockets (incl. the
        # mux channel), and a persistent client connection would keep
        # landing requests on the corpse — in-process restarts on the
        # same port would then feed a stub's control connection from
        # the DEAD agent while the live one never sees the request
        # (a real process exit RSTs these sockets; emulate that)
        self._handler.killed = True
        with self._handler.agent._cond:
            self._handler.agent._cond.notify_all()

    def kill(self) -> None:
        """Chaos: drop off the network like a SIGKILLed process."""
        self._handler.killed = True
        # wake stream handlers parked on the agent condition so they
        # hit the killed check now, not a keepalive later
        with self._handler.agent._cond:
            self._handler.agent._cond.notify_all()
        self.server.shutdown()
        self.server.server_close()
