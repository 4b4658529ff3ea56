"""The event-driven serving edge: tens of thousands of concurrent

The PyTorch port's copy of ``tony_tpu/gateway/edge.py``.
streams on a few threads.

TonY's AM serves its whole cluster — heartbeats, registrations, the
portal — from a handful of event-driven server threads (PAPER.md); the
thread-per-connection ``GatewayHTTP`` inverted that, so the fleet
behind the queue could scale while the front door could not. This
module is the re-inversion: ``GatewayEdge`` serves the exact same
routes (gateway/http.py's shared helpers) from

  - ONE asyncio loop thread doing all accept/read/parse/write I/O,
  - a small FIXED ThreadPoolExecutor (default 4) for the blocking
    gateway calls (submit, snapshot, result) — sized to the route
    work, never to the connection count.

Concurrency model
-----------------
Every connection is one coroutine parsing HTTP/1.1 requests
sequentially off its reader (keep-alive + pipelining-safe by
construction: a connection's responses go out in request order because
the coroutine handles one request at a time). Blocking work hops to
the executor via ``run_in_executor``; token events flow back from the
replica threads via ``loop.call_soon_threadsafe`` into a per-request
``asyncio.Queue`` — no thread ever blocks on a client's readiness.
An idle COMMITTED stream emits ``{"keepalive": true}`` lines on the
same cadence as the threaded edge (http.STREAM_KEEPALIVE_S).

Slow-client policy
------------------
A reader that stops draining its socket gets bounded buffering, then a
clean abort — never a pinned worker thread or an unbounded buffer:
the transport's write buffer is capped (``write_buffer_kb``), writes
await ``drain()`` under ``drain_timeout_s``, and a drain that times
out aborts the transport, counts ``slow_client_aborts``, and detaches
the event callback so the replica's remaining events for that request
are dropped on the floor (the request itself finishes server-side;
its tokens just have no reader). ``write_buffer_hwm`` records the
worst buffered-bytes watermark observed at write time.

Connection-limit breaker
------------------------
Past ``max_connections`` the edge sheds NEW connections with an
immediate 503 + ``Retry-After`` and closes — before the accept
backlog melts or fds run out — counted as ``conn_limit_sheds``. The
limit defaults under the typical fd budget (ulimit -n) rather than at
it, leaving room for the agent channels and history files.

A ``GatewayEdge`` is drop-in for ``GatewayHTTP``: same constructor
shape, ``.host``/``.port``/``.start()``/``.stop()``; the CLI's
``--edge event`` (default) / ``--edge threaded`` picks between them.
On start it registers its connection-plane stats with the gateway
(``Gateway.register_edge``), so /stats grows an ``edge`` block and
/metrics the ``tony_edge_*`` families.
"""

from __future__ import annotations

import asyncio
import json
import logging
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable
from urllib.parse import parse_qsl, unquote

from tony_tpu_torch.gateway.core import Gateway, Shed
from tony_tpu_torch.gateway.http import (STREAM_KEEPALIVE_S, finish_doc,
                                   get_route, parse_generate,
                                   profile_request, shed_headers)

log = logging.getLogger(__name__)

_MAX_HEADER = 16 << 10  # request line + headers cap (8K is the common
#                         server default; 16K leaves margin)
_MAX_BODY = 8 << 20  # same POST body cap as the threaded edge

_CLOSE = object()  # queue sentinel: response complete, close allowed


class _EdgeStats:
    """Connection-plane counters. Mutated ONLY on the loop thread;
    snapshot() is read cross-thread from /stats scrapes — plain int
    reads are atomic under the GIL, and a torn multi-field view is
    acceptable for monitoring, so no lock."""

    def __init__(self, workers: int, max_connections: int):
        self.workers = workers
        self.max_connections = max_connections
        self.open_connections = 0
        self.active_streams = 0
        self.accepts = 0
        self.requests = 0
        self.slow_client_aborts = 0
        self.conn_limit_sheds = 0
        self.client_disconnects = 0
        self.keepalives_sent = 0
        self.write_buffer_hwm = 0
        self.t_start = time.monotonic()
        # accepts/s over a short sliding window (deque of accept
        # timestamps would be O(rate); a two-sample rate is enough)
        self._rate_t = self.t_start
        self._rate_n = 0
        self.accept_rate = 0.0

    def on_accept(self) -> None:
        self.accepts += 1
        now = time.monotonic()
        if now - self._rate_t >= 1.0:
            self.accept_rate = ((self.accepts - self._rate_n)
                                / (now - self._rate_t))
            self._rate_t, self._rate_n = now, self.accepts

    def snapshot(self) -> dict:
        now = time.monotonic()
        # refresh the rate when accepts stopped (else it freezes at
        # the last burst's value forever)
        rate = self.accept_rate
        if now - self._rate_t >= 5.0:
            rate = (self.accepts - self._rate_n) / (now - self._rate_t)
        return {
            "kind": "event",
            "threads": 1 + self.workers,  # the loop + the pool: FIXED
            "workers": self.workers,
            "max_connections": self.max_connections,
            "open_connections": self.open_connections,
            "active_streams": self.active_streams,
            "accepts": self.accepts,
            "accepts_per_s": round(rate, 3),
            "requests": self.requests,
            "slow_client_aborts": self.slow_client_aborts,
            "conn_limit_sheds": self.conn_limit_sheds,
            "client_disconnects": self.client_disconnects,
            "keepalives_sent": self.keepalives_sent,
            "write_buffer_hwm_bytes": self.write_buffer_hwm,
            "uptime_s": round(now - self.t_start, 3),
        }


class _HTTPError(Exception):
    """Protocol-level refusal: (status, message)."""

    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status


class _SlowClientAbort(ConnectionResetError):
    """A drain() deadline fired: the client stopped reading. Distinct
    from an ordinary disconnect so the counters stay honest."""


async def _read_request(reader: asyncio.StreamReader,
                        io_timeout_s: float):
    """Parse one HTTP/1.1 request head + Content-Length body.
    Returns (method, path, headers, body) or None on clean EOF before
    a request line (keep-alive close).

    An IDLE keep-alive connection (zero bytes of the next request) is
    free to sit — that is the 10k-idle-connections case, and it costs
    one coroutine + buffers, no deadline. The moment the first byte
    arrives, the REST of the head and the whole body read under
    ``io_timeout_s``: a client trickling bytes one per second cannot
    hold the parser hostage — it costs at most the deadline and the
    bytes buffered so far, then a clean 408."""
    try:
        first = await reader.readexactly(1)  # idle: no deadline
    except asyncio.IncompleteReadError:
        return None  # clean EOF between requests
    try:
        head = first + await asyncio.wait_for(
            reader.readuntil(b"\r\n\r\n"), timeout=io_timeout_s)
    except asyncio.IncompleteReadError:
        raise _HTTPError(400, "truncated request head") from None
    except asyncio.LimitOverrunError:
        raise _HTTPError(431, "request head too large") from None
    except asyncio.TimeoutError:
        raise _HTTPError(408, "request head read timed out") from None
    lines = head.decode("latin-1").split("\r\n")
    try:
        method, target, _version = lines[0].split(" ", 2)
    except ValueError:
        raise _HTTPError(400, "malformed request line") from None
    headers = {}
    for line in lines[1:]:
        if not line:
            continue
        name, _, value = line.partition(":")
        headers[name.strip().lower()] = value.strip()
    body = b""
    length = headers.get("content-length")
    if length is not None:
        try:
            n = int(length)
        except ValueError:
            raise _HTTPError(400, "bad Content-Length") from None
        if n > _MAX_BODY:
            raise _HTTPError(413, "request body too large")
        if n > 0:
            try:
                body = await asyncio.wait_for(
                    reader.readexactly(n), timeout=io_timeout_s)
            except asyncio.IncompleteReadError:
                raise _HTTPError(400, "truncated request body") from None
            except asyncio.TimeoutError:
                # the trickled-POST case: bounded cost, clean refusal
                raise _HTTPError(408, "request body read timed out") \
                    from None
    elif headers.get("transfer-encoding", "").lower() == "chunked":
        raise _HTTPError(411, "chunked request bodies not supported; "
                              "send Content-Length")
    return method, target, headers, body


def _response(status: int, body: bytes, content_type: str,
              extra: dict | None = None, close: bool = False) -> bytes:
    reason = {200: "OK", 400: "Bad Request", 404: "Not Found",
              408: "Request Timeout", 409: "Conflict",
              411: "Length Required", 413: "Payload Too Large",
              429: "Too Many Requests", 431: "Request Header Fields "
              "Too Large", 500: "Internal Server Error",
              503: "Service Unavailable",
              504: "Gateway Timeout"}.get(status, "")
    head = [f"HTTP/1.1 {status} {reason}",
            f"Content-Type: {content_type}",
            f"Content-Length: {len(body)}"]
    for k, v in (extra or {}).items():
        head.append(f"{k}: {v}")
    if close:
        head.append("Connection: close")
    return ("\r\n".join(head) + "\r\n\r\n").encode() + body


def _json_response(status: int, doc: dict,
                   extra: dict | None = None) -> bytes:
    # error replies may leave pipelined/keep-alive state ambiguous
    # (e.g. an unparsed body) — close on >=400, same as the threaded
    # edge's _send contract
    return _response(status, json.dumps(doc).encode(),
                     "application/json", extra=extra, close=status >= 400)


def _chunk(doc: dict) -> bytes:
    data = (json.dumps(doc) + "\n").encode()
    return f"{len(data):X}\r\n".encode() + data + b"\r\n"


_STREAM_HEAD = (b"HTTP/1.1 200 OK\r\n"
                b"Content-Type: application/x-ndjson\r\n"
                b"Transfer-Encoding: chunked\r\n"
                b"Cache-Control: no-store\r\n\r\n")


class GatewayEdge:
    """The event-driven network face. Drop-in for ``GatewayHTTP``."""

    def __init__(self, gateway: Gateway, host: str = "127.0.0.1",
                 port: int = 0, encode: Callable | None = None,
                 decode: Callable | None = None,
                 keepalive_s: float = STREAM_KEEPALIVE_S,
                 max_connections: int = 16384, workers: int = 4,
                 write_buffer_kb: int = 256,
                 drain_timeout_s: float = 10.0,
                 io_timeout_s: float = 30.0):
        self.gateway = gateway
        self.encode = encode
        self.decode = decode
        self.keepalive_s = max(0.05, keepalive_s)
        self.max_connections = max(1, max_connections)
        self.write_buffer = max(1, write_buffer_kb) << 10
        self.drain_timeout_s = max(0.05, drain_timeout_s)
        self.io_timeout_s = max(0.1, io_timeout_s)
        self.stats = _EdgeStats(max(1, workers), self.max_connections)
        self._bind_host, self._bind_port = host, port
        self.host: str = host
        self.port: int = port
        self._loop: asyncio.AbstractEventLoop | None = None
        self._server: asyncio.base_events.Server | None = None
        self._pool = ThreadPoolExecutor(
            max_workers=max(1, workers), thread_name_prefix="edge-worker")
        self._thread: threading.Thread | None = None
        self._started = threading.Event()
        self._start_error: BaseException | None = None

    # ------------------------------------------------------- lifecycle

    def start(self) -> "GatewayEdge":
        self._thread = threading.Thread(target=self._run,
                                        name="gateway-edge", daemon=True)
        self._thread.start()
        self._started.wait(timeout=30.0)
        if self._start_error is not None:
            raise self._start_error
        if not self._started.is_set():
            raise RuntimeError("edge failed to start within 30s")
        self.gateway.register_edge(self.stats.snapshot)
        log.info("gateway edge (event) at http://%s:%d "
                 "(%d workers, max %d connections)", self.host,
                 self.port, self.stats.workers, self.max_connections)
        return self

    def stop(self) -> None:
        loop = self._loop
        if loop is None or not loop.is_running():
            return
        self.gateway.register_edge(None)
        asyncio.run_coroutine_threadsafe(self._shutdown(), loop)
        if self._thread is not None:
            self._thread.join(timeout=10.0)
        self._pool.shutdown(wait=False)

    async def _shutdown(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
        # cancel every live connection coroutine, then stop the loop
        for task in asyncio.all_tasks():
            if task is not asyncio.current_task():
                task.cancel()
        self._loop.stop()

    def _run(self) -> None:
        loop = asyncio.new_event_loop()
        asyncio.set_event_loop(loop)
        self._loop = loop
        try:
            self._server = loop.run_until_complete(asyncio.start_server(
                self._on_connection, self._bind_host, self._bind_port,
                limit=_MAX_HEADER, backlog=1024))
            addr = self._server.sockets[0].getsockname()
            self.host, self.port = addr[0], addr[1]
        except BaseException as e:  # surfaced in start()
            self._start_error = e
            self._started.set()
            loop.close()
            return
        self._started.set()
        try:
            loop.run_forever()
        finally:
            try:
                loop.run_until_complete(loop.shutdown_asyncgens())
            except Exception:
                pass
            loop.close()

    # ----------------------------------------------------- connections

    async def _on_connection(self, reader: asyncio.StreamReader,
                             writer: asyncio.StreamWriter) -> None:
        st = self.stats
        st.on_accept()
        if st.open_connections >= self.max_connections:
            # the breaker: shed BEFORE this connection costs anything —
            # an immediate 503 + honest Retry-After, then close
            st.conn_limit_sheds += 1
            try:
                writer.write(_json_response(
                    503, {"error": "connection limit reached"},
                    extra={"Retry-After": "1"}))
                await asyncio.wait_for(writer.drain(), timeout=1.0)
            except (ConnectionError, asyncio.TimeoutError):
                pass
            finally:
                writer.close()
            return
        st.open_connections += 1
        # bound the kernel-side write buffering: past the high mark,
        # drain() actually waits, which is what arms the slow-client
        # abort below
        writer.transport.set_write_buffer_limits(high=self.write_buffer)
        try:
            await self._serve_connection(reader, writer)
        except _SlowClientAbort:
            pass  # already counted + aborted in _write
        except (ConnectionError, asyncio.TimeoutError):
            # disconnect-without-FIN lands here too: the next read or
            # write on the dead socket raises, the slot frees, the
            # counter ticks — no 500, no co-tenant impact
            st.client_disconnects += 1
        except asyncio.CancelledError:
            raise
        except Exception:
            log.exception("edge connection crashed")
        finally:
            st.open_connections -= 1
            writer.close()

    async def _serve_connection(self, reader, writer) -> None:
        """One coroutine per connection: parse requests sequentially
        (pipelining-safe), dispatch, write responses in order."""
        while True:
            try:
                parsed = await _read_request(reader, self.io_timeout_s)
            except _HTTPError as e:
                await self._write(writer, _json_response(
                    e.status, {"error": str(e)}))
                return  # protocol errors close (framing is suspect)
            if parsed is None:
                return  # clean keep-alive close
            self.stats.requests += 1
            method, target, headers, body = parsed
            try:
                close = await self._dispatch(method, target, headers,
                                             body, writer)
            except _HTTPError as e:
                await self._write(writer, _json_response(
                    e.status, {"error": str(e)}))
                return  # >=400 closes (see _json_response)
            if close or headers.get("connection", "").lower() == "close":
                return

    async def _dispatch(self, method: str, target: str, headers: dict,
                        body: bytes, writer) -> bool:
        """Route one request; returns True when the connection must
        close after the response."""
        path, _, query = target.partition("?")
        loop = asyncio.get_running_loop()
        if method == "GET":
            if path == "/metrics":
                from tony_tpu_torch.obs import prometheus_text

                text = await loop.run_in_executor(
                    self._pool, prometheus_text, self.gateway)
                await self._write(writer, _response(
                    200, text.encode(),
                    "text/plain; version=0.0.4; charset=utf-8"))
                return False
            if path.startswith("/v1/stream/"):
                return await self._resume(path, query, writer)
            route = await loop.run_in_executor(
                self._pool, get_route, self.gateway, path)
            if route is None:
                await self._write(writer,
                                  _json_response(404,
                                                 {"error": "not found"}))
                return True
            await self._write(writer, _json_response(*route))
            return route[0] >= 400
        if method == "POST":
            if path == "/debug/profile":
                code, doc = await loop.run_in_executor(
                    self._pool, profile_request, self.gateway, query)
                await self._write(writer, _json_response(code, doc))
                return code >= 400
            if path == "/v1/generate":
                return await self._generate(headers, body, writer)
            await self._write(writer,
                              _json_response(404, {"error": "not found"}))
            return True
        raise _HTTPError(400, f"unsupported method {method}")

    # -------------------------------------------------------- generate

    async def _generate(self, headers: dict, body: bytes,
                        writer) -> bool:
        t_receive = time.monotonic()
        loop = asyncio.get_running_loop()
        try:
            doc = json.loads(body) if body else None
            if doc is None:
                raise ValueError("missing request body")
            req, stream = parse_generate(doc, self.encode)
            req.t_receive = t_receive
        except (TypeError, ValueError) as e:
            await self._write(writer, _json_response(400,
                                                     {"error": str(e)}))
            return True
        # the per-request event queue: replica threads push via
        # call_soon_threadsafe, this coroutine pops. ``aborted`` is the
        # slow-client detach: once set, further events are dropped at
        # the callback (no unbounded queue behind a dead reader).
        q: asyncio.Queue = asyncio.Queue()
        aborted = threading.Event()

        def on_event(_ticket, event):
            if aborted.is_set():
                return
            try:
                loop.call_soon_threadsafe(q.put_nowait, event)
            except RuntimeError:
                aborted.set()  # loop closed mid-shutdown

        try:
            # submit can block on admission bookkeeping — executor, not
            # the loop thread
            ticket = await loop.run_in_executor(
                self._pool, lambda: self.gateway.submit(req, on_event))
        except Shed as e:
            await self._write(writer, _json_response(
                e.http_status, {"error": e.reason},
                extra=shed_headers(e)))
            return True
        try:
            if stream:
                return await self._respond_stream(ticket, q, writer)
            return await self._respond_unary(ticket, q, writer)
        finally:
            aborted.set()  # detach: late events have no reader

    # ---------------------------------------------------------- resume

    async def _resume(self, path: str, query: str, writer) -> bool:
        """GET /v1/stream/<request_id>?offset=N: re-attach
        to a request's absolute token sequence. The gateway's
        ``resume_events`` is a blocking poll generator; parking it on
        the tiny shared executor would starve routing, so each resume
        gets a dedicated daemon pump thread that forwards docs onto an
        asyncio queue (same call_soon_threadsafe handoff as the
        generate path) and stops at the terminal line or when the
        watcher disconnects."""
        rid = unquote(path[len("/v1/stream/"):])
        if not rid:
            await self._write(writer,
                              _json_response(404, {"error": "not found"}))
            return True
        offset = 0
        for key, val in parse_qsl(query):
            if key == "offset":
                try:
                    offset = int(val)
                except ValueError:
                    await self._write(writer, _json_response(
                        400, {"error": "offset must be an integer"}))
                    return True
        if offset < 0:
            await self._write(writer, _json_response(
                400, {"error": "offset must be >= 0"}))
            return True
        loop = asyncio.get_running_loop()
        q: asyncio.Queue = asyncio.Queue()
        aborted = threading.Event()

        def pump():
            gen = self.gateway.resume_events(
                rid, offset, keepalive_s=self.keepalive_s)
            try:
                for doc in gen:
                    if aborted.is_set():
                        return
                    try:
                        loop.call_soon_threadsafe(q.put_nowait, doc)
                    except RuntimeError:
                        return  # loop closed mid-shutdown
                    if doc.get("gone") or doc.get("done") \
                            or doc.get("shed"):
                        return
            finally:
                try:
                    loop.call_soon_threadsafe(q.put_nowait, None)
                except RuntimeError:
                    pass

        threading.Thread(target=pump, daemon=True,
                         name=f"resume-{rid[:12]}").start()
        try:
            first = await q.get()
            if first is None or first.get("gone"):
                await self._write(writer, _json_response(
                    404,
                    {"error": f"unknown or reaped request {rid!r}"}))
                return True
            st = self.stats
            st.active_streams += 1
            try:
                await self._write(writer, _STREAM_HEAD)
                doc = first
                while doc is not None:
                    if doc.get("shed"):
                        await self._write(writer, _chunk(
                            {"id": rid, "request_id": rid,
                             "error": doc.get("reason", "shed"),
                             "status": doc.get("status", 503)})
                            + b"0\r\n\r\n")
                        return True
                    if doc.get("done"):
                        await self._write(writer, _chunk(
                            {"id": rid, "request_id": rid, "done": True,
                             "metrics": doc.get("metrics") or {}})
                            + b"0\r\n\r\n")
                        return False
                    if doc.get("keepalive"):
                        st.keepalives_sent += 1
                    doc.setdefault("id", rid)
                    doc.setdefault("request_id", rid)
                    await self._write(writer, _chunk(doc))
                    doc = await q.get()
                # pump died without a terminal line (shutdown): close
                await self._write(writer, b"0\r\n\r\n")
                return True
            finally:
                st.active_streams -= 1
        finally:
            aborted.set()  # detach: the pump stops at its next doc

    async def _respond_unary(self, ticket, q, writer) -> bool:
        """Unary waits on the SAME event queue the stream path uses —
        no executor thread parked on ticket.result(), so ten thousand
        concurrent unary requests cost queue entries, not threads."""
        while True:
            kind, *rest = await q.get()
            if kind == "tokens":
                continue  # unary: deltas accumulate server-side
            if kind == "done":
                res, metrics = rest
                await self._write(writer, _json_response(
                    200, finish_doc(res, metrics or {}, self.decode)))
                return False
            if kind == "shed":
                status, reason = rest
                await self._write(writer, _json_response(
                    status, {"error": reason}))
                return True

    async def _respond_stream(self, ticket, q, writer) -> bool:
        """Chunked NDJSON with lazy status commit (sheds keep real
        codes), keepalives once committed, and the slow-client abort
        armed on every write."""
        st = self.stats
        st.active_streams += 1
        headers_sent = False
        try:
            while True:
                try:
                    timeout = self.keepalive_s if headers_sent else None
                    kind, *rest = await asyncio.wait_for(
                        q.get(), timeout=timeout)
                except asyncio.TimeoutError:
                    st.keepalives_sent += 1
                    await self._write(writer, _chunk({"keepalive": True}))
                    continue
                if kind == "tokens":
                    if not headers_sent:
                        await self._write(writer, _STREAM_HEAD)
                        headers_sent = True
                    await self._write(writer, _chunk(
                        {"id": ticket.request.id,
                         "request_id": ticket.request.id,
                         "token_ids": rest[0]}))
                elif kind == "done":
                    res, metrics = rest
                    if not headers_sent:
                        await self._write(writer, _STREAM_HEAD)
                        headers_sent = True
                    await self._write(writer, _chunk(
                        finish_doc(res, metrics, self.decode))
                        + b"0\r\n\r\n")
                    return False
                elif kind == "shed":
                    status, reason = rest
                    if headers_sent:
                        await self._write(writer, _chunk(
                            {"id": ticket.request.id, "error": reason,
                             "status": status}) + b"0\r\n\r\n")
                        return True
                    await self._write(writer, _json_response(
                        status, {"error": reason}))
                    return True
        finally:
            st.active_streams -= 1

    # ----------------------------------------------------------- write

    async def _write(self, writer: asyncio.StreamWriter,
                     data: bytes) -> None:
        """The slow-client policy lives here: write, note the buffer
        watermark, then drain under a deadline. A drain timeout means
        the client stopped reading — abort the transport (RST, frees
        the fd now) and count it; the ConnectionResetError surfaces to
        _on_connection which frees the slot."""
        writer.write(data)
        buffered = writer.transport.get_write_buffer_size()
        if buffered > self.stats.write_buffer_hwm:
            self.stats.write_buffer_hwm = buffered
        try:
            await asyncio.wait_for(writer.drain(),
                                   timeout=self.drain_timeout_s)
        except asyncio.TimeoutError:
            self.stats.slow_client_aborts += 1
            writer.transport.abort()
            raise _SlowClientAbort(
                "slow client: write buffer not drained in "
                f"{self.drain_timeout_s:.1f}s") from None
