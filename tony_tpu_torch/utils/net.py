"""Port reservation.

The PyTorch port's copy of ``tony_tpu/utils/net.py``.

Reference: ServerPort/EphemeralPort/ReusablePort (+ reserve_reusable_port.py)
— TaskExecutor reserves rendezvous ports before registering, releases them
just before exec'ing the user process so the framework server can rebind
(TaskExecutor.java:89-101, 202-234). SO_REUSEPORT mode holds the port across
exec so there is no race window (rationale: ReusablePort.java:123-153).
On TPU the jax.distributed coordinator owns its own port, so the dance only
matters for chief rendezvous + TensorBoard ports; both modes are kept.

The port's SO_REUSEPORT reservation is bound but not listening: the
kernel spreads incoming connections over every LISTENING socket of a
reuse-port group, so a listening reservation that never accepts would
take a share of the rank-0 TCP store's connections (``distributed.py``
serves the store from its own SO_REUSEPORT socket on the held port). A
bound socket holds the port as well.
"""

from __future__ import annotations

import socket


class ServerPort:
    """A reserved TCP port; ``release()`` before handing it to the user
    process (unless SO_REUSEPORT keeps it held)."""

    def __init__(self, sock: socket.socket, reuse: bool):
        self._sock: socket.socket | None = sock
        self.reuse = reuse
        self.port: int = sock.getsockname()[1]

    def release(self) -> None:
        if self._sock is not None:
            self._sock.close()
            self._sock = None

    def __enter__(self) -> "ServerPort":
        return self

    def __exit__(self, *exc) -> None:
        self.release()


def reserve_port(reuse: bool = False, host: str = "") -> ServerPort:
    """EphemeralPort.create / ReusablePort.create equivalent."""
    sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    if reuse:
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
    sock.bind((host, 0))
    if not reuse:
        sock.listen(1)
    return ServerPort(sock, reuse)


def local_host_name() -> str:
    return socket.gethostname()
