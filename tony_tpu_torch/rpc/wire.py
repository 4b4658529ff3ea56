"""Wire format for the control-plane RPC: length-prefixed JSON frames with
per-job HMAC auth.

The PyTorch port's copy of ``tony_tpu/rpc/wire.py``.

Reference: Hadoop IPC + protobuf 2.5 service (rpc/ApplicationRpcServer.java,
tensorflow_cluster_service_protos.proto). The rebuild keeps the shape — a
small authenticated request/response service — with a dependency-free codec:
4-byte big-endian length prefix + UTF-8 JSON body. Auth mirrors the
ClientToAM token secret manager (ApplicationMaster.java:484-504): each
request carries an HMAC-SHA256 of its canonical body under the per-job
secret; the server verifies in constant time.
"""

from __future__ import annotations

import hashlib
import hmac
import json
import socket
import struct
from typing import Any

MAX_FRAME = 64 * 1024 * 1024  # sanity cap on a control-plane message
_LEN = struct.Struct(">I")


class WireError(ConnectionError):
    pass


def send_frame(sock: socket.socket, obj: dict) -> None:
    body = json.dumps(obj, separators=(",", ":")).encode()
    if len(body) > MAX_FRAME:
        raise WireError(f"frame too large: {len(body)}")
    sock.sendall(_LEN.pack(len(body)) + body)


def recv_frame(sock: socket.socket) -> dict | None:
    header = _recv_exact(sock, _LEN.size)
    if header is None:
        return None
    (length,) = _LEN.unpack(header)
    if length > MAX_FRAME:
        raise WireError(f"frame too large: {length}")
    body = _recv_exact(sock, length)
    if body is None:
        raise WireError("connection closed mid-frame")
    return json.loads(body)


def _recv_exact(sock: socket.socket, n: int) -> bytes | None:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None if not buf else None
        buf.extend(chunk)
    return bytes(buf)


def sign(secret: str, method: str, params: dict) -> str:
    msg = json.dumps([method, params], sort_keys=True, separators=(",", ":"))
    return hmac.new(secret.encode(), msg.encode(), hashlib.sha256).hexdigest()


def verify(secret: str, method: str, params: dict, signature: str) -> bool:
    return hmac.compare_digest(sign(secret, method, params), str(signature))


def make_request(req_id: int, method: str, params: dict, secret: str | None) -> dict:
    req: dict[str, Any] = {"id": req_id, "method": method, "params": params}
    if secret:
        req["sig"] = sign(secret, method, params)
    return req


def make_response(req_id: int, result: Any = None, error: str | None = None) -> dict:
    if error is not None:
        return {"id": req_id, "error": error}
    return {"id": req_id, "result": result}
