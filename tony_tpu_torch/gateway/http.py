"""The gateway's network face: route logic + the threaded HTTP server.

The PyTorch port's copy of ``tony_tpu/gateway/http.py``.

Two servers share the route logic in this module:

- ``GatewayHTTP`` (here): the original stdlib ``ThreadingHTTPServer``
  face — one handler thread per connection. Kept as the
  ``--edge threaded`` A/B control: a slow reader stalls only its own
  thread, but ten thousand readers are ten thousand OS threads.
- ``GatewayEdge`` (gateway/edge.py): the event-driven face — tens of
  thousands of concurrent connections on one loop thread plus a small
  fixed worker pool (``--edge event``, the default).

Both serve the SAME contracts through the module-level helpers
(``get_route`` / ``parse_generate`` / ``finish_doc`` /
``profile_request``), so every test and smoke round carries over
between them. Endpoints:

  POST /v1/generate   submit one request; JSON body (see parse_generate)
                      {"stream": true} -> chunked NDJSON: one
                      {"id", "token_ids": [delta...]} line per step,
                      a {"keepalive": true} line when the stream idles
                      past the keepalive interval (clients filter these
                      out of token reassembly), then a final line with
                      finish_reason/metrics. Otherwise one JSON object
                      when done.
  GET  /healthz       liveness: 200 while the process serves at all;
                      body = per-replica breaker state + heartbeat age
                      ("ok" / "degraded" / "down" — the early-warning
                      signal before /readyz flips)
  GET  /readyz        admission: 200 accepting / 503 draining OR zero
                      healthy replicas (the load-balancer signal
                      during graceful shutdown and total outage)
  GET  /stats         the Gateway.snapshot() JSON (counters, queue
                      depths, p50/p95/p99 queue-wait/TTFT/TPOT, the
                      engine rollup, and — behind the event edge — the
                      ``edge`` connection-plane block)
  GET  /metrics       Prometheus text exposition (0.0.4) of the same
                      numbers /stats carries: counters, gauges, and
                      lifetime TTFT/TPOT/queue-wait/e2e histograms —
                      what an autoscaler or scrape agent consumes
  GET  /v1/stream/<request_id>?offset=N   resume a stream:
                      chunked NDJSON of the request's ABSOLUTE token
                      sequence from offset N — {"request_id",
                      "offset", "token_ids"} windows, keepalives, then
                      the terminal {"done": true, "metrics"} line (or
                      the shed line with its status/reason). Works for
                      any admitted request — a dropped connection, a
                      second watcher, or a client reconnecting after a
                      gateway crash+--recover all land here; finished
                      requests stay resumable for --park-ttl. Unknown
                      or reaped ids 404.
  GET  /debug/trace   {"request_ids": [...]} — recently traced requests
  GET  /debug/traces  the browsable listing: buffered trace ids PLUS
                      terminal tags (outcome, finish_reason, tokens,
                      attempts) — how you find the trace worth opening
  GET  /debug/trace/<id>  one request's span tree as Chrome trace-event
                      JSON (load it in chrome://tracing or Perfetto);
                      failovers show as the request hopping attempt rows
  GET  /debug/goodput the roofline ledger report: wall clock decomposed
                      into useful/compile/padding/overshoot/
                      spec-rejected/idle bucket fractions (sum <= 1),
                      fleet + per replica, largest waste bucket named;
                      per-kind HBM-BW%/MFU where a roofline reference
                      is known (null on CPU)
  POST /debug/profile?steps=N  arm a torch.profiler capture of the
                      fleet's next N working scheduler iterations;
                      returns the logdir its trace file lands in (409
                      while a capture is already pending/active). With
                      remote replicas (not ported) the request FANS
                      OUT: each agent host arms its own capture (POST
                      /v1/profile) and the response's
                      "remote" map reports per-host armed/logdir/error
  GET  /debug/profile capture status (active/steps_left/captures/
                      last_logdir/last_error), plus a per-agent
                      "remote" status map when the fleet has remote
                      replicas
  GET  /debug/bundle  the flight recorder: one self-
                      contained JSON debug bundle — active/recent
                      alerts, the judged signal snapshot, fleet +
                      per-replica goodput, per-replica stats rows
                      (dispatch timeline; transport/obs blocks for
                      remote hosts), supervision counters, recent
                      traces (remote spans included). The same
                      document a FIRING alert dumps automatically
                      into the history job dir (bundles/*.json)

Multi-tenant admission fields on POST /v1/generate (docs/SERVING.md):
``priority`` names a weighted-fair-queuing tier (``interactive`` /
``standard`` / ``batch`` by default; unknown -> 400) and ``tenant``
keys the per-tenant token-rate quota — a tenant past its rate gets an
immediate 429 whose ``Retry-After`` header says when its bucket
refills (``core.QuotaExceeded``), distinct from the queue-bound 429.

Shed mapping (core.Shed.http_status): 400 bad request, 429 admission
queue full OR tenant quota (the quota flavor carries Retry-After),
503 draining, 504 deadline exceeded. In streaming mode the status
line is only committed at the FIRST event, so a request shed while
queued still gets its real status code, not a 200 with an error
trailer.

Stream keepalives: the agent already emits idle NDJSON keepalive lines
on its resumable stream (serve/agent.py); the client-facing stream
used to go silent between tokens, so a slow decode behind a proxy/LB
idle timeout dropped healthy streams. Both edges now emit the same
``{"keepalive": true}`` doc once the COMMITTED stream idles past the
keepalive interval (pre-commit silence is preserved — the lazy status
contract needs it). Clients reassembling tokens must skip keepalive
lines (tests pin this).
"""

from __future__ import annotations

import itertools
import json
import logging
import math
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable
from urllib.parse import parse_qsl, unquote

from tony_tpu_torch.gateway.core import Gateway, GenRequest, Shed

log = logging.getLogger(__name__)

# the client-facing stream keepalive cadence (seconds of committed-
# stream silence before a {"keepalive": true} line) — generous enough
# to be invisible in normal traffic, tight enough to beat common LB
# idle timeouts; both edges and the CLI knob default to it
STREAM_KEEPALIVE_S = 15.0


# --------------------------------------------------------------------
# shared route logic (both network faces serve exactly this)
# --------------------------------------------------------------------

def readyz_doc(gateway: Gateway) -> tuple[int, dict]:
    """The /readyz contract: 200 accepting; 503 draining/starting OR
    zero healthy replicas (every breaker open — shed clean 503s until
    a probe rejoins one)."""
    if gateway.ready and gateway.n_healthy > 0:
        return 200, {"status": "ready"}
    if gateway.ready:
        return 503, {"status": "no healthy replicas"}
    return 503, {"status": "draining" if gateway.draining
                 else "starting"}


def get_route(gateway: Gateway, path: str) -> tuple[int, dict] | None:
    """Dispatch one JSON GET route; None = not a JSON GET route here
    (/metrics is text and stays with the caller; unknown paths 404 at
    the caller too, after it checks its own extras)."""
    if path == "/healthz":
        return 200, gateway.health()
    if path == "/readyz":
        return readyz_doc(gateway)
    if path == "/stats":
        return 200, gateway.snapshot()
    if path == "/debug/trace":
        if gateway.traces is None:
            return 404, {"error": "tracing disabled"}
        return 200, {"request_ids": gateway.traces.ids()}
    if path == "/debug/traces":
        # the browsable listing: ids PLUS terminal tags (outcome,
        # finish_reason, tokens, attempts) — /debug/trace/<id>
        # required already knowing the id; this is how you find it
        if gateway.traces is None:
            return 404, {"error": "tracing disabled"}
        return 200, {"capacity": gateway.traces.capacity,
                     "traces": gateway.traces.summaries()}
    if path == "/debug/goodput":
        return 200, gateway.goodput_report()
    if path.startswith("/debug/trace/"):
        if gateway.traces is None:
            return 404, {"error": "tracing disabled"}
        rid = unquote(path[len("/debug/trace/"):])
        trace = gateway.traces.get(rid)
        if trace is None:
            return 404, {"error": f"no trace for request_id {rid!r} "
                         f"(buffer keeps the most recent "
                         f"{gateway.traces.capacity})"}
        return 200, trace.to_chrome()
    if path == "/debug/profile":
        status = gateway.profiler.status()
        remote = gateway.remote_profile_status()
        if remote:
            status["remote"] = remote
        return 200, status
    if path == "/debug/bundle":
        return 200, gateway.debug_bundle()
    return None


def profile_request(gateway: Gateway, query: str) -> tuple[int, dict]:
    """POST /debug/profile?steps=N[&logdir=<subdir>] — arm an
    on-demand serving profile (profiler.ServeProfiler). The body is
    ignored; the knobs ride the query string so `curl -XPOST
    .../debug/profile?steps=20` is the whole interface. ``logdir``
    is a RELATIVE name under the server's configured profile dir —
    an absolute or traversing path would hand any HTTP client an
    arbitrary-directory write primitive, so it 400s instead."""
    import os

    params = dict(parse_qsl(query))
    logdir = None
    sub = params.get("logdir")
    if sub:
        base = os.path.realpath(gateway.profiler.default_logdir)
        logdir = os.path.realpath(os.path.join(base, sub))
        if logdir != base and not logdir.startswith(base + os.sep):
            return 400, {"error": "logdir must be a relative subpath "
                                  "of the server's profile dir "
                                  "(--profile-dir)"}
        # fresh timestamped dir per capture: the trace readers sum
        # every trace file under a logdir, so re-using a name would
        # silently double-count across captures
        logdir = os.path.join(logdir,
                              f"profile-{int(time.time() * 1000)}")
    try:
        steps = int(params.get("steps", 10))
        if steps < 1:
            raise ValueError("steps must be >= 1")
    except ValueError as e:
        return 400, {"error": str(e)}
    has_remote = gateway.has_remote_replicas
    local_error = None
    armed_logdir = None
    if gateway.has_local_replicas:
        # mixed/local fleets arm this process's profiler too; a
        # PURE-ROUTER fleet skips it — there is no local device work
        # worth capturing. The one-session-at-a-time constraint is
        # PER PROCESS, so a local capture already in flight must
        # not block arming the agents (separate processes): on a
        # fleet with remotes the local refusal is reported in the
        # response instead of 409ing the whole fan-out; a
        # local-only fleet keeps the 409 contract.
        try:
            armed_logdir = gateway.profiler.request(steps, logdir)
        except RuntimeError as e:  # a capture is already in flight
            if not has_remote:
                return 409, {"error": str(e)}
            local_error = str(e)
        except ValueError as e:
            return 400, {"error": str(e)}
    out = {"armed": armed_logdir is not None, "steps": steps,
           "logdir": armed_logdir}
    if local_error is not None:
        out["local_error"] = local_error
    # remote replicas: fan the capture out to every agent host
    # — best-effort per host, reported per host; the
    # trace files land on each agent's own machine
    remote = gateway.arm_remote_profiles(steps)
    if remote:
        out["remote"] = remote
        out["armed"] = out["armed"] or any(
            v.get("armed") for v in remote.values())
    return 200, out


def parse_generate(d: dict,
                   encode: Callable | None) -> tuple[GenRequest, bool]:
    """POST /v1/generate body -> (GenRequest, stream flag). Raises
    ValueError/TypeError on anything malformed — both edges map that
    to a 400."""
    if not isinstance(d, dict):
        raise ValueError("request must be a JSON object")
    if "token_ids" in d:
        ids = [int(x) for x in d["token_ids"]]
    elif "prompt" in d:
        if encode is None:
            raise ValueError(
                "text prompt needs a tokenizer in the model dir; "
                "send token_ids instead")
        ids = encode(str(d["prompt"]))
    else:
        raise ValueError("request needs token_ids or prompt")
    ttl = d.get("ttl_s", d.get("timeout_s"))
    # "request_id" is the documented spelling; "id" accepted for
    # back-compat. Absent -> the gateway mints a UUID, echoed in
    # every response/stats/history/trace surface so the client can
    # correlate its request with the server-side records.
    rid = d.get("request_id", d.get("id"))
    tenant = d.get("tenant")
    priority = d.get("priority")
    return GenRequest(
        ids,
        max_new_tokens=int(d.get("max_new_tokens", 64)),
        temperature=float(d.get("temperature", 0.0)),
        top_k=int(d.get("top_k", 0)),
        seed=int(d.get("seed", 0)),
        id=rid,
        ttl_s=float(ttl) if ttl is not None else None,
        session=d.get("session"),
        # multi-tenant admission: tier + quota identity (validated
        # by the gateway — unknown priority names are a 400)
        tenant=str(tenant) if tenant is not None else None,
        priority=str(priority) if priority is not None else None,
    ), bool(d.get("stream", False))


def finish_doc(res, metrics: dict, decode: Callable | None) -> dict:
    """The terminal response document (unary body / stream last line)."""
    out = {"id": res.id, "request_id": res.id,
           "token_ids": list(res.prompt) + list(res.tokens),
           "finish_reason": res.finish_reason, "metrics": metrics}
    if decode is not None:
        out["text"] = decode(out["token_ids"])
    return out


def shed_headers(e: Shed) -> dict | None:
    """Retry-After for the quota 429: an honest machine-readable
    backoff (whole seconds, ceil'd, floor 1 — "0" reads as "now")."""
    retry = getattr(e, "retry_after_s", None)
    if retry is None:
        return None
    return {"Retry-After": str(max(1, math.ceil(retry)))}


# --------------------------------------------------------------------
# the threaded face (--edge threaded; the A/B control)
# --------------------------------------------------------------------

class GatewayHandler(BaseHTTPRequestHandler):
    # bound by GatewayHTTP: the shared Gateway plus optional tokenizer
    # hooks (encode: str -> [ids]; decode: [ids] -> str)
    gateway: Gateway
    encode: Callable | None = None
    decode: Callable | None = None
    keepalive_s: float = STREAM_KEEPALIVE_S
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # quiet: requests are metrics,
        log.debug(fmt, *args)  # not stderr noise

    # ------------------------------------------------------------- GET

    def do_GET(self):
        path, _, query = self.path.partition("?")
        if path == "/metrics":
            from tony_tpu_torch.obs import prometheus_text

            return self._send_text(200, prometheus_text(self.gateway))
        if path.startswith("/v1/stream/"):
            return self._respond_resume(path, query)
        route = get_route(self.gateway, path)
        if route is None:
            return self._send(404, {"error": "not found"})
        return self._send(*route)

    # ------------------------------------------------------------ POST

    def do_POST(self):
        t_receive = time.monotonic()
        path, _, query = self.path.partition("?")
        if path == "/debug/profile":
            return self._profile_request(query)
        if path != "/v1/generate":
            return self._send(404, {"error": "not found"})
        try:
            body = self._read_body()
            req, stream = parse_generate(body, self.encode)
            req.t_receive = t_receive  # the trace's http_receive span
        except (TypeError, ValueError) as e:
            # TypeError too: int()/float()/iteration over wrong-typed
            # JSON values ({"token_ids": 123}, {"temperature": null})
            # must be a 400, not a handler-thread crash + reset socket
            return self._send(400, {"error": str(e)})
        try:
            ticket = self.gateway.submit(req)
        except Shed as e:
            return self._send(e.http_status, {"error": e.reason},
                              headers=shed_headers(e))
        try:
            if stream:
                self._respond_stream(ticket)
            else:
                self._respond_unary(ticket)
        except (BrokenPipeError, ConnectionResetError):
            pass  # client went away; the request finishes server-side
            # and its deadline/shed path handles abandoned successors

    def _profile_request(self, query: str) -> None:
        length = int(self.headers.get("Content-Length") or 0)
        if length > 1 << 20:
            # refusing to drain an arbitrarily large body; 413 closes
            # the connection (the _send >=400 path), so the unread tail
            # can never desync a keep-alive socket
            return self._send(413, {"error": "request body too large"})
        if length > 0:  # drain: unread body bytes would desync a
            self.rfile.read(length)  # keep-alive socket
        return self._send(*profile_request(self.gateway, query))

    def _read_body(self) -> dict:
        length = int(self.headers.get("Content-Length") or 0)
        if length <= 0:
            raise ValueError("missing request body")
        if length > 8 << 20:
            raise ValueError("request body too large")
        raw = self.rfile.read(length)
        try:
            body = json.loads(raw)
        except json.JSONDecodeError as e:
            raise ValueError(f"invalid JSON: {e}") from None
        if not isinstance(body, dict):
            raise ValueError("request must be a JSON object")
        return body

    # -------------------------------------------------------- responses

    def _respond_unary(self, ticket) -> None:
        try:
            res = ticket.result()
        except Shed as e:
            return self._send(e.http_status, {"error": e.reason})
        # ticket.metrics is the replica's canonical per-request record
        # (same dict the stream's final line and /stats window carry)
        self._send(200, finish_doc(res, ticket.metrics or {},
                                   self.decode))

    def _respond_stream(self, ticket) -> None:
        """Chunked NDJSON. Headers are sent lazily at the first event
        so sheds keep their real status code; once committed, idle
        gaps longer than the keepalive interval emit a keepalive line
        (filtered by clients) so slow decodes survive LB idle
        timeouts."""
        import queue as _queue

        headers_sent = False
        while True:
            try:
                # pre-commit: block without keepalives (nothing may be
                # written before the status line)
                kind, *rest = ticket.events.get(
                    timeout=self.keepalive_s if headers_sent else None)
            except _queue.Empty:
                self._chunk({"keepalive": True})
                continue
            if kind == "tokens":
                if not headers_sent:
                    self._start_stream()
                    headers_sent = True
                self._chunk({"id": ticket.request.id,
                             "request_id": ticket.request.id,
                             "token_ids": rest[0]})
            elif kind == "done":
                res, metrics = rest
                if not headers_sent:
                    self._start_stream()
                    headers_sent = True
                self._chunk(finish_doc(res, metrics, self.decode))
                self.wfile.write(b"0\r\n\r\n")
                return
            elif kind == "shed":
                status, reason = rest
                if headers_sent:  # mid-stream shed: error line + close
                    self._chunk({"id": ticket.request.id, "error": reason,
                                 "status": status})
                    self.wfile.write(b"0\r\n\r\n")
                else:
                    self._send(status, {"error": reason})
                return

    def _respond_resume(self, path: str, query: str) -> None:
        """GET /v1/stream/<request_id>?offset=N — re-attach to a live
        (or recently finished) request's ABSOLUTE token sequence from
        offset N. Unlike _respond_stream this never consumes the
        ticket's single-consumer event queue: it polls the resume
        buffer, so any number of watchers (including a client
        reconnecting after a gateway crash + --recover) can follow the
        same request without stealing each other's deltas."""
        rid = unquote(path[len("/v1/stream/"):])
        if not rid:
            return self._send(404, {"error": "not found"})
        offset = 0
        for key, val in parse_qsl(query):
            if key == "offset":
                try:
                    offset = int(val)
                except ValueError:
                    return self._send(
                        400, {"error": "offset must be an integer"})
        if offset < 0:
            return self._send(400, {"error": "offset must be >= 0"})
        gen = self.gateway.resume_events(rid, offset,
                                         keepalive_s=self.keepalive_s)
        first = next(gen)
        if first.get("gone"):
            return self._send(
                404, {"error": f"unknown or reaped request {rid!r}"})
        try:
            self._start_stream()
            for doc in itertools.chain([first], gen):
                if doc.get("shed"):
                    self._chunk({"id": rid, "request_id": rid,
                                 "error": doc.get("reason", "shed"),
                                 "status": doc.get("status", 503)})
                    break
                if doc.get("done"):
                    self._chunk({"id": rid, "request_id": rid,
                                 "done": True,
                                 "metrics": doc.get("metrics") or {}})
                    break
                doc.setdefault("id", rid)
                doc.setdefault("request_id", rid)
                self._chunk(doc)
            self.wfile.write(b"0\r\n\r\n")
        except (BrokenPipeError, ConnectionResetError):
            pass  # watcher went away; the request itself is unaffected

    def _start_stream(self) -> None:
        self.send_response(200)
        self.send_header("Content-Type", "application/x-ndjson")
        self.send_header("Transfer-Encoding", "chunked")
        self.send_header("Cache-Control", "no-store")
        self.end_headers()

    def _chunk(self, doc: dict) -> None:
        data = (json.dumps(doc) + "\n").encode()
        self.wfile.write(f"{len(data):X}\r\n".encode() + data + b"\r\n")
        self.wfile.flush()

    def _send_text(self, code: int, text: str) -> None:
        """Plain-text response — the Prometheus exposition format
        (which is NOT JSON; scrapers parse the text format directly)."""
        data = text.encode()
        self.send_response(code)
        self.send_header("Content-Type",
                         "text/plain; version=0.0.4; charset=utf-8")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _send(self, code: int, doc: dict,
              headers: dict | None = None) -> None:
        data = json.dumps(doc).encode()
        if code >= 400:
            # error replies may leave a POST body unread; under
            # HTTP/1.1 keep-alive those bytes would be parsed as the
            # NEXT request line — close instead of desyncing
            self.close_connection = True
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        if code >= 400:
            self.send_header("Connection", "close")
        self.end_headers()
        self.wfile.write(data)


class GatewayHTTP:
    """Binds a Gateway to a ThreadingHTTPServer; start()/stop()."""

    def __init__(self, gateway: Gateway, host: str = "127.0.0.1",
                 port: int = 0, encode: Callable | None = None,
                 decode: Callable | None = None,
                 keepalive_s: float = STREAM_KEEPALIVE_S):
        handler = type("BoundGatewayHandler", (GatewayHandler,),
                       {"gateway": gateway, "encode": staticmethod(encode)
                        if encode else None,
                        "decode": staticmethod(decode) if decode else None,
                        "keepalive_s": max(0.05, keepalive_s)})
        self.server = ThreadingHTTPServer((host, port), handler)
        self.server.daemon_threads = True
        self.host, self.port = self.server.server_address[:2]
        self._thread: threading.Thread | None = None

    def start(self) -> "GatewayHTTP":
        self._thread = threading.Thread(target=self.server.serve_forever,
                                        name="gateway-http", daemon=True)
        self._thread.start()
        log.info("gateway http at http://%s:%d", self.host, self.port)
        return self

    def stop(self) -> None:
        self.server.shutdown()
        self.server.server_close()
