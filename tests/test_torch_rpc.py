"""The port's control-plane RPC against the JAX package's, across the
wire in both directions: the port's ``RpcClient`` against the JAX
``RpcServer`` and the JAX client against the port's server, each serving
its own package's ``ClientRpcHandler`` (the coordinator's verbs) over a
stand-in coordinator, with HMAC frames and with the per-job TLS. Every
verb gives the same answer in every pairing; a bad HMAC, a missing one
and a wrong certificate pin are refused by both servers."""

import itertools
import threading

import pytest

from tony_tpu.coordinator import coordinator as jax_coord
from tony_tpu.rpc import RpcClient as JaxClient
from tony_tpu.rpc import RpcError as JaxRpcError
from tony_tpu.rpc import RpcServer as JaxServer
from tony_tpu.rpc import tls as jax_tls
from tony_tpu.session import TaskInfo as JaxTaskInfo
from tony_tpu_torch.coordinator import coordinator as port_coord
from tony_tpu_torch.rpc import RpcClient as PortClient
from tony_tpu_torch.rpc import RpcError as PortRpcError
from tony_tpu_torch.rpc import RpcServer as PortServer
from tony_tpu_torch.rpc import tls as port_tls
from tony_tpu_torch.session import TaskInfo as PortTaskInfo

SECRET = "job-token"
SERVERS = {"jax": (JaxServer, jax_coord.ClientRpcHandler, JaxTaskInfo),
           "port": (PortServer, port_coord.ClientRpcHandler, PortTaskInfo)}
CLIENTS = {"jax": (JaxClient, JaxRpcError), "port": (PortClient,
                                                    PortRpcError)}


class _Stub:
    """The parts of a ``Coordinator`` the verbs reach, answering the same
    whatever the package; it records what the verbs asked of it."""

    def __init__(self, task_info):
        self.calls = []
        self.tensorboard_url = ""
        self.client_done = threading.Event()
        self.killed = threading.Event()
        infos = [task_info("worker", 0, "http://h/log0"),
                 task_info("worker", 1, "http://h/log1")]
        self.session = type("S", (), {"task_infos": lambda _: infos})()
        self.liveness = type("L", (), {
            "ping": lambda _, t: self.calls.append(("ping", t))})()
        self.am_adapter = type("A", (), {
            "receive_task_callback_info":
                lambda _, t, i: self.calls.append(("callback", t, i))})()

    def cluster_spec_if_ready(self, task_id):
        return None if task_id == "worker:1" else '{"worker": ["h:1"]}'

    def register_worker_spec(self, task_id, spec):
        self.calls.append(("register", task_id, spec))
        return self.cluster_spec_if_ready(task_id)

    def register_execution_result(self, task_id, code, session_id,
                                  preempted):
        self.calls.append(("result", task_id, code, session_id, preempted))
        return True

    def application_status(self):
        return {"status": "RUNNING", "reason": "", "session_id": 0,
                "attempt": 0, "tensorboard_url": self.tensorboard_url,
                "phase": "NONE"}

    def drain_commands(self, task_id):
        return [{"type": "profile", "num_steps": 3}] \
            if task_id == "worker:0" else []

    def queue_command(self, task_id, command):
        self.calls.append(("queue", task_id, command))
        return task_id == "worker:0"

    def request_resize(self, role, instances):
        return role == "worker" and instances > 0


VERBS = [("get_task_infos", {}),
         ("get_cluster_spec", {"task_id": "worker:0"}),
         ("get_cluster_spec", {"task_id": "worker:1"}),
         ("register_worker_spec", {"task_id": "worker:0", "spec": "h:1"}),
         ("register_tensorboard_url", {"url": "http://h:6006"}),
         ("register_execution_result", {"task_id": "worker:0",
                                        "exit_code": 3, "session_id": 0,
                                        "preempted": True}),
         ("task_executor_heartbeat", {"task_id": "worker:0"}),
         ("task_executor_heartbeat", {"task_id": "worker:1"}),
         ("request_profile", {"task_id": "worker:0", "num_steps": 7}),
         ("resize_role", {"role": "worker", "instances": 3}),
         ("resize_role", {"role": "nope", "instances": 3}),
         ("register_callback_info", {"task_id": "worker:0", "info": "x"}),
         ("get_application_status", {}),
         ("finish_application", {}),
         ("force_kill", {})]


@pytest.fixture(scope="module")
def certs(tmp_path_factory):
    d = tmp_path_factory.mktemp("tls")
    cert, key = port_tls.mint_self_signed(str(d), "tony-test")
    assert port_tls.cert_fingerprint(cert) == jax_tls.cert_fingerprint(cert)
    return cert, key, port_tls.cert_fingerprint(cert)


def _run(server_pkg, client_pkg, tls, certs):
    server_cls, handler_cls, info_cls = SERVERS[server_pkg]
    client_cls, _ = CLIENTS[client_pkg]
    stub = _Stub(info_cls)
    server = server_cls(handler_cls(stub), secret=SECRET,
                        tls=certs[:2] if tls else None).start()
    try:
        c = client_cls(server.host, server.port, secret=SECRET,
                       tls_fingerprint=certs[2] if tls else None)
        answers = [c.call(v, **kw) for v, kw in VERBS]
        c.close()
    finally:
        server.stop()
    return answers, stub.calls, stub.tensorboard_url, \
        stub.client_done.is_set(), stub.killed.is_set()


@pytest.mark.parametrize("tls", [False, True], ids=["hmac", "tls"])
def test_every_verb_answers_alike_across_packages(tls, certs):
    runs = {(s, c): _run(s, c, tls, certs)
            for s, c in itertools.product(SERVERS, CLIENTS)}
    want = runs["jax", "jax"]
    assert want[0][0][0]["name"] == "worker" and want[3] and want[4]
    for pair, got in runs.items():
        assert got == want, pair


@pytest.mark.parametrize("server_pkg", list(SERVERS))
@pytest.mark.parametrize("client_pkg", list(CLIENTS))
def test_bad_hmac_refused(server_pkg, client_pkg, certs):
    server_cls, handler_cls, info_cls = SERVERS[server_pkg]
    client_cls, err = CLIENTS[client_pkg]
    server = server_cls(handler_cls(_Stub(info_cls)), secret=SECRET).start()
    try:
        for secret in ("WRONG", None):
            c = client_cls(server.host, server.port, secret=secret)
            with pytest.raises(err, match="authentication failed"):
                c.call("get_application_status")
            c.close()
    finally:
        server.stop()


@pytest.mark.parametrize("server_pkg", list(SERVERS))
@pytest.mark.parametrize("client_pkg", list(CLIENTS))
def test_wrong_certificate_pin_refused(server_pkg, client_pkg, certs):
    server_cls, handler_cls, info_cls = SERVERS[server_pkg]
    client_cls, _ = CLIENTS[client_pkg]
    server = server_cls(handler_cls(_Stub(info_cls)), secret=SECRET,
                        tls=certs[:2]).start()
    try:
        c = client_cls(server.host, server.port, secret=SECRET,
                       tls_fingerprint="0" * 64, timeout=5)
        with pytest.raises(Exception):
            c.call("get_application_status", retries=0)
        c.close()
    finally:
        server.stop()
