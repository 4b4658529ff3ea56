"""RPC client with reconnect + poll helpers.

The PyTorch port's copy of ``tony_tpu/rpc/client.py``.

Reference: rpc/impl/ApplicationRpcClient.java (singleton per AM address) and
the pollTillNonNull registration loop (TaskExecutor.java:294-296 /
util/Utils.java:96-129).
"""

from __future__ import annotations

import logging
import socket
import threading
import time
from typing import Any, Callable

from tony_tpu_torch.rpc import wire

log = logging.getLogger(__name__)


class RpcError(RuntimeError):
    """Server-side error returned for a call."""


class RpcClient:
    def __init__(self, host: str, port: int, secret: str | None = None,
                 timeout: float = 30.0, tls_fingerprint: str | None = None):
        """``tls_fingerprint``: pin the coordinator's per-job self-signed
        cert by SHA-256 digest (rpc/tls.py); connections whose served cert
        doesn't match are refused."""
        self.host = host
        self.port = port
        self.secret = secret
        self.timeout = timeout
        self.tls_fingerprint = tls_fingerprint
        self._sock: socket.socket | None = None
        self._req_id = 0
        self._lock = threading.Lock()

    # -- connection ---------------------------------------------------------
    def _connect(self) -> socket.socket:
        if self._sock is None:
            sock = socket.create_connection((self.host, self.port), timeout=self.timeout)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            if self.tls_fingerprint:
                from tony_tpu_torch.rpc.tls import client_wrap

                try:
                    sock = client_wrap(sock, self.tls_fingerprint)
                except BaseException:
                    # handshake failure: the raw fd is not yet tracked in
                    # self._sock — close it here or every retry leaks one
                    sock.close()
                    raise
            self._sock = sock
        return self._sock

    def close(self) -> None:
        with self._lock:
            if self._sock is not None:
                try:
                    self._sock.close()
                finally:
                    self._sock = None

    # -- calls --------------------------------------------------------------
    def call(self, method: str, retries: int = 2, **params: Any) -> Any:
        """Invoke ``method`` on the server; reconnects once per retry on
        connection-level failure. Server-side errors raise RpcError."""
        with self._lock:
            last: Exception | None = None
            for _ in range(retries + 1):
                try:
                    sock = self._connect()
                    self._req_id += 1
                    wire.send_frame(
                        sock, wire.make_request(self._req_id, method, params, self.secret)
                    )
                    resp = wire.recv_frame(sock)
                    if resp is None:
                        raise ConnectionError("server closed connection")
                    if "error" in resp:
                        raise RpcError(resp["error"])
                    return resp.get("result")
                except (ConnectionError, TimeoutError, OSError) as e:
                    last = e
                    self._sock = None
                    time.sleep(0.2)
            raise ConnectionError(f"RPC {method} to {self.host}:{self.port} failed: {last}")

    def poll_till_non_null(self, fn: Callable[[], Any], interval_s: float = 0.5,
                           timeout_s: float | None = None) -> Any:
        """Reference: Utils.pollTillNonNull (util/Utils.java:96)."""
        deadline = None if timeout_s is None else time.monotonic() + timeout_s
        while True:
            value = fn()
            if value is not None:
                return value
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError("poll_till_non_null timed out")
            time.sleep(interval_s)
