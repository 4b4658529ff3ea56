"""Threaded RPC server dispatching to a handler object.

The PyTorch port's copy of ``tony_tpu/rpc/server.py``.

Reference: rpc/ApplicationRpcServer.java:26 (random-port bind :38-41,
protobuf service build :123-134) and rpc/impl/MetricsRpcServer.java:22-43.
One server class serves both roles; the coordinator runs two instances with
different handler objects, mirroring the reference's two-server layout.

A handler is any object whose public methods (not starting with ``_``) are
the RPC verbs; params are passed as kwargs. Unknown methods and handler
exceptions return an error frame rather than killing the connection.
"""

from __future__ import annotations

import logging
import socket
import socketserver
import threading

from tony_tpu_torch.rpc import wire

log = logging.getLogger(__name__)


class RpcServer:
    def __init__(self, handler: object, host: str = "127.0.0.1", port: int = 0,
                 secret: str | None = None,
                 tls: tuple[str, str] | None = None):
        """``tls`` = (cert_path, key_path): serve the per-job self-signed
        cert; peers pin its fingerprint (rpc/tls.py — the SASL-transport
        analog of ApplicationMaster.java:484-504)."""
        self.handler = handler
        self.secret = secret
        self._ssl_ctx = None
        if tls:
            from tony_tpu_torch.rpc.tls import server_context

            self._ssl_ctx = server_context(*tls)
        outer = self

        class _Conn(socketserver.BaseRequestHandler):
            def handle(self) -> None:  # one connection, many frames
                sock: socket.socket = self.request
                sock.settimeout(600)
                if outer._ssl_ctx is not None:
                    try:
                        sock = outer._ssl_ctx.wrap_socket(sock,
                                                          server_side=True)
                    except (OSError, ConnectionError) as e:
                        # plaintext/garbled handshake must not kill the
                        # server thread pool
                        log.warning("TLS handshake failed: %s", e)
                        return
                try:
                    while True:
                        req = wire.recv_frame(sock)
                        if req is None:
                            return
                        wire.send_frame(sock, outer._dispatch(req))
                except (ConnectionError, TimeoutError, OSError):
                    return

        class _Server(socketserver.ThreadingTCPServer):
            daemon_threads = True
            allow_reuse_address = True

        self._server = _Server((host, port), _Conn)
        self.host, self.port = self._server.server_address[:2]
        self._thread: threading.Thread | None = None

    # -- dispatch -----------------------------------------------------------
    def _dispatch(self, req: dict) -> dict:
        req_id = req.get("id", 0)
        method = str(req.get("method", ""))
        params = req.get("params") or {}
        if method.startswith("_") or not hasattr(self.handler, method):
            return wire.make_response(req_id, error=f"unknown method: {method}")
        if self.secret and not wire.verify(self.secret, method, params, req.get("sig", "")):
            log.warning("rejecting unauthenticated call to %s", method)
            return wire.make_response(req_id, error="authentication failed")
        try:
            result = getattr(self.handler, method)(**params)
            return wire.make_response(req_id, result=result)
        except Exception as e:  # handler bug must not kill the control plane
            log.exception("RPC handler error in %s", method)
            return wire.make_response(req_id, error=f"{type(e).__name__}: {e}")

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> "RpcServer":
        self._thread = threading.Thread(
            target=self._server.serve_forever, name=f"rpc-{self.port}", daemon=True
        )
        self._thread.start()
        log.info("RPC server listening on %s:%d", self.host, self.port)
        return self

    def stop(self) -> None:
        if self._thread is not None:  # shutdown() deadlocks if never started
            self._server.shutdown()
        self._server.server_close()
        if self._thread:
            self._thread.join(timeout=5)
