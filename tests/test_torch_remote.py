"""Remote replicas in the port: the replica agent (``serve/agent.py``),
the ``RemoteServer`` stub (``gateway/remote.py``) and ``cli.replica``,
against the JAX package on the same weights (``build_pair``), the same
requests and explicit EOS ids. Agents are in-process ``AgentHTTP``
servers speaking real HTTP on localhost (``kill()`` drops one off the
network as a SIGKILL would), and one is a ``cli.replica`` subprocess:

- the agent protocol: ``/healthz`` carries the JAX agent's keys, a
  submitted stream equals the JAX engine's, resumes by offset, submits
  are idempotent, refusals keep their kinds, a drain refuses new work;
- two agents behind a gateway: streams equal to a JAX gateway over two
  JAX agents;
- a stream migrated across the wire (local replica to agent) and
  between two agents, then its adopter killed: token-exact, the
  migration counters equal to the JAX gateway's;
- a stale radix summary: the delta doc refused and re-shipped full;
- a crashed gateway's successor adopts a parked session and recovers a
  result an agent buffered, token-exact;
- the profile fan-out reaches every agent;
- ``python -m tony_tpu_torch.cli.replica --demo-model --device cpu``
  behind a gateway, drained to exit 0 with no process left.

Mid-stream windows are made by ``torch_parity.Gate``, never by sleeps.
"""

import json
import os
import time
import urllib.error
import urllib.request

import pytest

from torch_parity import Gate, build_pair, tokens, wait_for
from tony_tpu.gateway import Gateway as JaxGateway
from tony_tpu.gateway import GenRequest as JaxGenRequest
from tony_tpu.gateway.remote import RemoteServer as JaxRemoteServer
from tony_tpu.serve import Request as JaxRequest
from tony_tpu.serve import Server as JaxServer
from tony_tpu.serve.agent import AgentHTTP as JaxAgentHTTP
from tony_tpu.serve.agent import ReplicaAgent as JaxReplicaAgent
from tony_tpu_torch.gateway import Gateway, GenRequest, journal
from tony_tpu_torch.gateway.remote import (RemoteServer, close_server,
                                           launch_local_agent)
from tony_tpu_torch.serve import Request, Server
from tony_tpu_torch.serve.agent import AgentHTTP, ReplicaAgent

pytestmark = pytest.mark.filterwarnings("ignore::ResourceWarning")

EOS = (38, 61)
KW = dict(batch_size=2, paged=True, kv_page_size=8, min_bucket=8,
          chunk_steps=1, eos_id=EOS, prefix_cache_mb=0.0)
LONG = tokens(76, 13).tolist()  # 40 tokens, no eos id, greedy or sampled
MIX = [(LONG, 40, {}), (tokens(51, 6).tolist(), 12, {}),
       (tokens(52, 24).tolist(), 12, dict(temperature=0.8, top_k=8,
                                          seed=3)),
       (tokens(53, 12).tolist(), 20, {})]


@pytest.fixture(scope="module")
def models():
    return build_pair(9)


def _pkg(models, jax: bool) -> dict:
    jm, jp, tm = models
    if jax:
        return dict(server=lambda **kw: JaxServer(jm, jp, **{**KW, **kw}),
                    agent=lambda srv, **kw: JaxAgentHTTP(
                        JaxReplicaAgent(srv, **kw)).start(),
                    stub=lambda addr, **kw: JaxRemoteServer(
                        addr, **{**STUB, **kw}),
                    gateway=JaxGateway, req=JaxGenRequest,
                    request=JaxRequest)
    return dict(server=lambda **kw: Server(tm, device="cpu",
                                           **{**KW, **kw}),
                agent=lambda srv, **kw: AgentHTTP(
                    ReplicaAgent(srv, **kw)).start(),
                stub=lambda addr, **kw: RemoteServer(addr, **{**STUB, **kw}),
                gateway=Gateway, req=GenRequest, request=Request)


# leases long enough that no load can expire a source mid-migration
STUB = dict(heartbeat_interval_s=0.1, lease_misses=100,
            boot_timeout_s=60.0)


def _call(address, method, path, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(f"http://{address}{path}", data=data,
                                 method=method)
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            text = r.read().decode()
            return r.status, [json.loads(ln) for ln in text.splitlines()
                              if ln.strip()]
    except urllib.error.HTTPError as e:
        return e.code, [json.loads(e.read().decode())]


def _stream(address, rid, offset=0):
    """The tokens of a finished stream from ``offset``, and its result."""
    status, lines = _call(address, "GET",
                          f"/v1/stream/{rid}?offset={offset}&epoch=0")
    assert status == 200
    toks = [t for ln in lines for t in ln.get("token_ids", [])]
    return toks, lines[-1]["result"]


def _control(pkg, prompt, budget, knobs) -> list:
    return list(pkg["server"]().run([pkg["request"](
        list(prompt), budget, id="c", **knobs)]))[0].tokens


def test_agent_protocol_matches_jax(models):
    port, jax = _pkg(models, False), _pkg(models, True)
    a, ja = port["agent"](port["server"]()), jax["agent"](jax["server"]())
    try:
        _, (hz,) = _call(a.address, "GET", "/healthz")
        _, (jhz,) = _call(ja.address, "GET", "/healthz")
        assert set(hz) == set(jhz) and hz["ok"] and hz["paged"]
        assert set(jhz["counters"]) <= set(hz["counters"])
        for addr in (a.address, ja.address):
            for i, (p, n, knobs) in enumerate(MIX):
                status, _ = _call(addr, "POST", "/v1/submit", {
                    "id": i, "prompt": p, "max_new_tokens": n,
                    "epoch": 0, **knobs})
                assert status == 200
            # a re-sent submit is a duplicate, not a second request
            _, (dup,) = _call(addr, "POST", "/v1/submit", {
                "id": 0, "prompt": MIX[0][0], "max_new_tokens": 4,
                "epoch": 0})
            assert dup["duplicate"]
        for i, (p, n, knobs) in enumerate(MIX):
            got, res = _stream(a.address, i)
            want, jres = _stream(ja.address, i)
            assert got == want == res["tokens"] == jres["tokens"]
            assert res["finish_reason"] == jres["finish_reason"]
            assert got == _control(port, p, n, knobs)
            assert _stream(a.address, i, offset=3)[0] == got[3:]
        for body in ({"id": "e", "prompt": [], "max_new_tokens": 4},
                     {"id": "q", "prompt": [1] * 80, "max_new_tokens": 4}):
            status, (err,) = _call(a.address, "POST", "/v1/submit",
                                   {**body, "epoch": 0})
            assert status == 400 and err["kind"] == "ValueError"
        status, _ = _call(a.address, "POST", "/v1/drain",
                          {"timeout_s": 60})
        assert status == 200
        status, (err,) = _call(a.address, "POST", "/v1/submit", {
            "id": "late", "prompt": [1, 2], "max_new_tokens": 2,
            "epoch": 0})
        assert status == 503 and err["kind"] == "Unavailable"
    finally:
        a.stop()
        ja.stop()


def _gateway_outs(pkg):
    agents = [pkg["agent"](pkg["server"]()) for _ in range(2)]
    gw = pkg["gateway"]([pkg["stub"](a.address) for a in agents]).start()
    try:
        sent = [gw.submit(pkg["req"](list(p), n, id=f"g{i}", **knobs))
                for i, (p, n, knobs) in enumerate(MIX)]
        outs = {t.request.id: (list(t.result(timeout=300).tokens))
                for t in sent}
        assert gw.snapshot()["shed"] == {}
        # each request's record names the agent that served it
        assert {t.metrics["host"] for t in sent} \
            <= {a.address for a in agents}
        return outs
    finally:
        gw.drain(timeout=120)
        for a in agents:
            a.stop()


def test_remote_gateway_matches_jax(models):
    assert _gateway_outs(_pkg(models, False)) \
        == _gateway_outs(_pkg(models, True))


def _wire_move(pkg, knobs):
    """A local replica and an agent; the stream, held after 3 tokens on
    the local replica, migrates across the wire to the agent."""
    local = pkg["server"]()
    remote = pkg["server"](prefix_cache_mb=4.0)
    gates = [Gate(local, 3), Gate(remote, 3)]
    a = pkg["agent"](remote)
    gw = pkg["gateway"]([local, pkg["stub"](a.address)],
                        stall_timeout_s=300.0).start()
    try:
        gw.replicas[1].outstanding = 500  # the stream starts locally
        t = gw.submit(pkg["req"](list(LONG), 40, id="wire", **knobs))
        wait_for(gates[0].held.is_set, what="the stream held locally")
        gw.replicas[1].outstanding = 0
        assert t.replica == 0
        # False while the agent's stub is still joining: retried
        wait_for(lambda: gw.migrate_session("wire"), what="the move")
        for g in gates:
            g.open()
        res = t.result(timeout=300)
        assert t.replica == 1

        def mig():
            return gw.snapshot()["engine"]["migrations"]

        # the agent's counters ride its next heartbeat
        wait_for(lambda: mig()["in"] >= 1 and mig()["pages_moved"] >= 1,
                 what="the migration counters on a heartbeat")
        m = mig()
        assert gw.snapshot()["shed"] == {}
        return list(res.tokens), {k: m[k] for k in (
            "out", "in", "local", "remote", "pages_moved", "bytes_wire")}
    finally:
        for g in gates:
            g.open()
        gw.drain(timeout=120)
        a.stop()


@pytest.mark.parametrize("knobs", [{}, dict(temperature=0.8, top_k=8,
                                            seed=7)],
                         ids=["greedy", "sampled"])
def test_cross_host_migration_matches_jax(models, knobs):
    port = _pkg(models, False)
    got = _wire_move(port, knobs)
    assert got == _wire_move(_pkg(models, True), knobs)
    assert got[0] == _control(port, LONG, 40, knobs)
    # 15 positions = 2 pages of 8, counted by the extract and the adopt
    assert got[1]["remote"] == 2 and got[1]["pages_moved"] == 4


def test_killed_adopter_reruns_token_exact(models):
    """A stream migrated between two agents, whose adopter then drops off
    the network: failover re-runs it from the prompt on the survivor,
    token-exact to the JAX engine's unmigrated stream, and no request is
    shed."""
    port = _pkg(models, False)
    want = _control(port, LONG, 40, {})
    assert want == _control(_pkg(models, True), LONG, 40, {})
    servers = [port["server"]() for _ in range(2)]
    gates = [Gate(s, 3) for s in servers]
    agents = [port["agent"](s) for s in servers]
    gw = Gateway([RemoteServer(a.address, heartbeat_interval_s=0.1,
                               lease_misses=20) for a in agents],
                 stall_timeout_s=300.0, breaker_base_s=0.05,
                 breaker_max_s=0.25).start()
    try:
        t = gw.submit(GenRequest(list(LONG), 40, id="chaos"))
        wait_for(lambda: any(g.held.is_set() for g in gates),
                 what="the stream held mid-flight")
        src = t.replica
        wait_for(lambda: gw.migrate_session("chaos"), what="the move")
        target = 1 - src
        wait_for(lambda: t.replica == target, what="the adopter")
        # the adopter holds the stream after its first tokens there;
        # it drops off the network there
        gates[src].open()
        wait_for(gates[target].held.is_set, what="the adopter holding")
        agents[target].kill()
        gates[target].open()
        res = t.result(timeout=300)
        assert list(res.tokens) == want
        snap = gw.snapshot()
        assert snap["shed"] == {}
        assert snap["supervision"]["failovers"] >= 1
    finally:
        for g in gates:
            g.open()
        gw.drain(timeout=120)
        for a in agents:
            a.stop()


class _ForcedSummary(RemoteServer):
    """A stub whose radix summary of its agent is pinned (the heartbeat
    cannot refresh it): a stale summary for as long as the test needs."""

    @property
    def _prefix_summary(self):
        return getattr(self, "_forced", [])

    @_prefix_summary.setter
    def _prefix_summary(self, value):
        pass


def test_stale_summary_falls_back_to_the_full_payload(models):
    """The stub trims the migrate doc against a summary the agent no
    longer backs: the agent refuses it (``StaleDelta``) and the stub
    re-ships the full doc once; the stream stays token-exact to the JAX
    engine's unmigrated one."""
    port = _pkg(models, False)
    want = _control(port, LONG, 40, {})
    assert want == _control(_pkg(models, True), LONG, 40, {})
    helper = port["server"](prefix_cache_mb=2.0)
    list(helper.run([Request(list(LONG) + want, 1, id="warm")]))
    local, remote = port["server"](), port["server"](prefix_cache_mb=2.0)
    gates = [Gate(local, 3), Gate(remote, 3)]
    a = port["agent"](remote)
    stub = _ForcedSummary(a.address, **STUB)
    gw = Gateway([local, stub], prefix_affinity=False,
                 stall_timeout_s=300.0).start()
    try:
        stub._forced = helper.prefix_summary()
        gw.replicas[1].outstanding = 500
        t = gw.submit(GenRequest(list(LONG), 40, id="d"))
        wait_for(gates[0].held.is_set, what="the stream held locally")
        gw.replicas[1].outstanding = 0
        wait_for(lambda: gw.migrate_session("d"), what="the move")
        for g in gates:
            g.open()
        assert list(t.result(timeout=300).tokens) == want
        assert gw.snapshot()["shed"] == {}
        assert stub.migrate_delta_trims == 1
        assert stub.migrate_delta_fallbacks == 1
    finally:
        for g in gates:
            g.open()
        gw.drain(timeout=120)
        a.stop()


def test_recovery_adopts_parked_and_buffered_results(models, tmp_path):
    """A gateway dies with two streams on two agents. One finishes into
    the void (its agent, with no watchdog, buffers the result); the
    other, held mid-stream, is frozen by its agent once the gateway has
    been silent past the grace. The successor replays the journal: the buffered result comes
    back terminal with its exact tokens (``_recover_finished``), the
    parked session resumes mid-stream on an engine migrate-in, both
    token-exact."""
    port = _pkg(models, False)
    short_p, long_p = tokens(52, 24).tolist(), LONG
    want_short = _control(port, short_p, 8, {})
    want_long = _control(port, long_p, 40, {})
    servers = [port["server"]() for _ in range(2)]
    gates = [Gate(s, 3) for s in servers]
    # the short stream's agent runs in-flight work to completion (no
    # watchdog, grace 0); the long one's freezes it after 1 s of silence
    grace = 1.0
    agents = [port["agent"](s, gateway_grace_s=g, park_ttl_s=120)
              for s, g in zip(servers, (0.0, grace))]
    gw2 = None
    try:
        j1 = journal.TicketJournal(str(tmp_path / "j1.ndjson"))
        gw1 = Gateway([RemoteServer(a.address, **STUB) for a in agents],
                      journal=j1, park_ttl_s=120,
                      stall_timeout_s=300.0).start()
        gw1.replicas[1].outstanding = 500
        ts = gw1.submit(GenRequest(list(short_p), 8, id="fin"))
        wait_for(gates[0].held.is_set, what="the short stream held")
        gw1.replicas[1].outstanding = 0
        gw1.replicas[0].outstanding = 500
        tl = gw1.submit(GenRequest(list(long_p), 40, id="mid"))
        wait_for(gates[1].held.is_set, what="the long stream held")
        wait_for(lambda: ts._n_emitted >= 3 and tl._n_emitted >= 3,
                 what="both streams past 3 tokens at the gateway")
        gw1.kill()
        entries = journal.replay(j1.path)
        assert entries["fin"].live and entries["mid"].live

        def rows():
            return [r for a in agents for r in a.agent.parked()["parked"]]

        gates[0].open()  # the short one finishes into the void
        wait_for(lambda: any(r["finished"] and r["rid"] == "fin"
                             for r in rows()), what="the buffered result")
        # the long one stays held until the gateway's silence passes the
        # grace; its agent then parks it at the next step boundary
        wait_for(lambda: time.monotonic() - agents[1].agent._last_contact
                 > grace, what="the gateway silent past the grace")
        gates[1].open()
        wait_for(lambda: any(not r["finished"] and r["rid"] == "mid"
                             for r in rows()), what="the parked session")
        j2 = journal.TicketJournal(str(tmp_path / "j2.ndjson"))
        gw2 = Gateway([RemoteServer(a.address, **STUB) for a in agents],
                      journal=j2, park_ttl_s=120).start()
        report = gw2.recover_from_journal(entries)
        assert (report["adopted"], report["finished"], report["rerun"],
                report["shed"]) == (1, 1, 0, 0), report
        tf = gw2.resume_ticket("fin")
        assert list(tf.result(timeout=60).tokens) == want_short
        assert tf.metrics["recovered"] and tf.metrics["attempts"] == 0
        tm = gw2.resume_ticket("mid")
        assert list(tm.result(timeout=300).tokens) == want_long
        assert tm.attempts == 0
        snap = gw2.snapshot()
        assert snap["shed"] == {}
        assert snap["recovery"]["recovered_finished"] == 1
        assert sum(s.migrations_in for s in servers) >= 1
    finally:
        for g in gates:
            g.open()
        if gw2 is not None:
            gw2.drain(timeout=120)
        for a in agents:
            a.stop()


def test_profile_fanout_reaches_every_agent(models, tmp_path):
    port = _pkg(models, False)
    agents = [AgentHTTP(ReplicaAgent(port["server"](),
                                     profile_dir=str(tmp_path / f"a{i}"))
                        ).start() for i in range(2)]
    gw = Gateway([RemoteServer(a.address, **STUB) for a in agents]).start()
    try:
        armed = gw.arm_remote_profiles(2)
        assert set(armed) == {a.address for a in agents}
        assert all(v["armed"] for v in armed.values()), armed
        status = gw.remote_profile_status()
        assert set(status) == set(armed)
        again = gw.arm_remote_profiles(2)  # one capture at a time
        assert not any(v["armed"] for v in again.values())
    finally:
        gw.drain(timeout=120)
        for a in agents:
            a.stop()


def test_replica_cli_behind_a_gateway_drains_clean(tmp_path):
    """``cli.replica`` as a subprocess on the CPU, launched as the
    gateway CLI launches it: it answers through a ``RemoteServer``, and
    closing the stub drains it to exit 0."""
    env = {**os.environ, "PYTHONPATH": os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))}
    proc, address = launch_local_agent(
        ["--demo-model", "--device", "cpu", "--serve-batch", "2",
         "--port", "0"], port_file=str(tmp_path / "agent.port"), env=env,
        boot_timeout_s=120.0)
    try:
        stub = RemoteServer(address, agent_proc=proc, **STUB)
        gw = Gateway([stub]).start()
        res = gw.submit(GenRequest([1, 2, 3], 6, id="x")).result(
            timeout=120)
        assert len(res.tokens) == 6 and res.finish_reason == "length"
        # the drain closes the stub, which drains and reaps its agent
        assert gw.drain(timeout=120)
        assert proc.wait(timeout=60) == 0
        close_server(stub, "again")  # a second close is harmless
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
