"""The port's gateway (``tony_tpu_torch.gateway``) over two port
``Server``s against the JAX gateway over two JAX ``Server``s, on the
same weights (``build_pair``) and the same requests, with explicit EOS
ids:

- through ``GatewayHTTP`` on ``127.0.0.1:0``: greedy requests, paged and
  unpaged, three sharing a prefix, unary and NDJSON-streamed, first one
  at a time (the fleet idle before each, so routing and every replica's
  engine counters on ``/stats`` must agree), then all at once (token
  streams and finish reasons only: routing then depends on timing);
- a ``FaultPlan.fail_at`` failover on replica 0, a drain (in-flight
  requests finish, new ones are shed) and a journal replay
  (``recover_from_journal``), each token-exact to the JAX gateway's.

Also the role split it refuses as the JAX gateway does; and the lock by
which
replica threads share the card (``models.graphs.DEVICE``), under more
threads than cores: no capture overlaps another holder, no step is
lost, nothing deadlocks."""

import json
import random
import sys
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import pytest

from torch_parity import build_pair, tokens
from tony_tpu.gateway import Gateway as JaxGateway
from tony_tpu.gateway import GatewayClosed as JaxGatewayClosed
from tony_tpu.gateway import GatewayHTTP as JaxGatewayHTTP
from tony_tpu.gateway import GenRequest as JaxGenRequest
from tony_tpu.gateway import journal as jax_journal
from tony_tpu.serve import FaultPlan as JaxFaultPlan
from tony_tpu.serve import Server as JaxServer
from tony_tpu_torch.gateway import (Gateway, GatewayClosed, GatewayHTTP,
                                    GenRequest)
from tony_tpu_torch.gateway import journal
from tony_tpu_torch.models.graphs import DeviceLock
from tony_tpu_torch.serve import FaultPlan, Server

EOS = (38, 61)  # fixed ids: two requests of the mix end on them
KW = dict(min_bucket=8, chunk_steps=4)
PAGED = dict(kv_page_size=8, prefix_cache_mb=4.0)

PRE = tokens(10, 12).tolist()
# (prompt, budget, stream): a shared 12-token prefix on three prompts
MIX = [(PRE + tokens(11, 3).tolist(), 10, False),
       (tokens(20, 4).tolist(), 8, True),
       (PRE + tokens(12, 5).tolist(), 14, True),
       (tokens(21, 9).tolist(), 1, False),
       (PRE + tokens(11, 3).tolist(), 6, False),
       (tokens(22, 6).tolist(), 12, True)]

JAX = dict(server=JaxServer, gateway=JaxGateway, http=JaxGatewayHTTP,
           req=JaxGenRequest, faults=JaxFaultPlan, closed=JaxGatewayClosed,
           journal=jax_journal)
PORT = dict(server=Server, gateway=Gateway, http=GatewayHTTP,
            req=GenRequest, faults=FaultPlan, closed=GatewayClosed,
            journal=journal)


@pytest.fixture(scope="module")
def models():
    return build_pair(9)


def _servers(pkg, models, paged, faults=(None, None), **extra):
    jm, jp, tm = models
    kw = {**KW, **(PAGED if paged else {}), **extra}
    if pkg is JAX:
        return [JaxServer(jm, jp, batch_size=2, eos_id=EOS, paged=paged,
                          fault_plan=f, **kw) for f in faults]
    return [Server(tm, batch_size=2, eos_id=EOS, paged=paged, device="cpu",
                   fault_plan=f, **kw) for f in faults]


def _post(url, prompt, budget, stream, rid):
    body = json.dumps({"id": rid, "token_ids": prompt,
                       "max_new_tokens": budget, "stream": stream}).encode()
    with urllib.request.urlopen(urllib.request.Request(
            url + "/v1/generate", data=body), timeout=120) as r:
        assert r.status == 200
        lines = [json.loads(ln) for ln in r.read().decode().splitlines()
                 if ln.strip()]
    final = lines[-1]
    new = final["token_ids"][len(prompt):]
    if stream:  # the deltas, in order, are the generated tokens
        assert [t for ln in lines[:-1] for t in ln["token_ids"]] == new
    return new, final["finish_reason"]


def _idle(url):
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        with urllib.request.urlopen(url + "/stats") as r:
            snap = json.loads(r.read())
        if all(row["active_slots"] == 0 and row["queued"] == 0
               and row["outstanding_tokens"] == 0
               for row in snap["replicas"]):
            return snap
        time.sleep(0.01)
    raise AssertionError("fleet never went idle")


def _http_run(pkg, models, paged):
    gw = pkg["gateway"](_servers(pkg, models, paged)).start()
    http = pkg["http"](gw, host="127.0.0.1", port=0).start()
    url = f"http://127.0.0.1:{http.port}"
    try:
        one = {}
        for i, (p, n, stream) in enumerate(MIX):
            _idle(url)
            one[f"s{i}"] = _post(url, p, n, stream, f"s{i}")
        rows = _idle(url)["replicas"]
        with ThreadPoolExecutor(len(MIX)) as ex:
            futs = {f"c{i}": ex.submit(_post, url, p, n, s, f"c{i}")
                    for i, (p, n, s) in enumerate(MIX)}
            many = {k: f.result() for k, f in futs.items()}
        with urllib.request.urlopen(url + "/metrics") as r:
            metrics = r.read().decode()
    finally:
        gw.drain(timeout=120)
        http.stop()
    return one, rows, many, metrics


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "unpaged"])
def test_http_streams_and_counters_match_jax(models, paged):
    j_one, j_rows, j_many, _ = _http_run(JAX, models, paged)
    t_one, t_rows, t_many, metrics = _http_run(PORT, models, paged)
    assert t_one == j_one and t_many == j_many
    reasons = {r for _, r in t_one.values()}
    assert reasons == {"eos", "length"}
    keys = set(Server(models[2], device="cpu", paged=paged,
                      **KW).counters())
    shared = sorted(keys & set(j_rows[0]) & set(t_rows[0]))
    assert {"prefills", "decode_steps", "dispatches"} <= set(shared)
    assert [{k: row[k] for k in shared} for row in t_rows] == \
        [{k: row[k] for k in shared} for row in j_rows]
    assert sum(row["prefix_hits"] for row in t_rows) > 0 or not paged
    assert "tony_goodput_fraction" in metrics


def _api_run(pkg, servers, reqs, during=None):
    """``reqs`` submitted to a gateway over ``servers``; ``during``
    runs once they are in (with the gateway); returns each request's
    (tokens, finish reason) and the final snapshot."""
    gw = pkg["gateway"](servers).start()
    try:
        tickets = [gw.submit(pkg["req"](list(p), n, id=f"r{i}"))
                   for i, (p, n, _) in enumerate(reqs)]
        extra = during(gw) if during is not None else None
        out = {}
        for t in tickets:
            res = t.result(timeout=120)
            out[t.request.id] = (list(res.tokens), res.finish_reason)
        snap = gw.snapshot()
    finally:
        gw.drain(timeout=120)
    return out, snap, extra


def test_failover_under_fail_at_matches_jax(models):
    """Replica 0 fails at its third dispatch: its requests re-run on
    replica 1 from the prompt, token-exact, and both gateways count the
    failure."""
    outs = []
    for pkg in (JAX, PORT):
        servers = _servers(pkg, models, True,
                           faults=(pkg["faults"].fail_at(3), None))
        out, snap, _ = _api_run(pkg, servers, MIX)
        assert snap["supervision"]["replica_failures"] >= 1
        outs.append(out)
    clean, _, _ = _api_run(PORT, _servers(PORT, models, True), MIX)
    assert outs[1] == outs[0] == clean


def test_drain_finishes_in_flight_and_sheds_new(models):
    outs = []
    for pkg in (JAX, PORT):
        def during(gw, pkg=pkg):
            t = threading.Thread(target=gw.drain, kwargs={"timeout": 120})
            t.start()
            while not gw.draining:
                time.sleep(0.001)
            with pytest.raises(pkg["closed"]):
                gw.submit(pkg["req"]([1, 2, 3], 4, id="late"))
            return t

        slow = pkg["faults"].wedge_at(1, 0.02, times=-1)
        out, _, t = _api_run(pkg, _servers(pkg, models, True,
                                           faults=(slow, None)),
                             MIX[:4], during)
        t.join(timeout=120)
        assert not t.is_alive()
        outs.append(out)
    assert outs[1] == outs[0] and len(outs[0]) == 4


def test_journal_replay_matches_jax(models, tmp_path):
    """Requests a dead gateway admitted and never finished, written by
    the port's journal: each package's gateway replays the file and
    re-runs them from the prompt under their original ids, with the
    same tokens."""
    path = str(tmp_path / "dead.ndjson")
    j = journal.TicketJournal(path)
    for i, (p, n, _) in enumerate(MIX[:3]):
        j.admit(f"j{i}", {"prompt": p, "max_new_tokens": n}, 100.0 + i)
        j.route(f"j{i}", i % 2, "local")
    j.close()
    outs = []
    for pkg in (JAX, PORT):
        entries = pkg["journal"].replay(path)
        assert sorted(e for e in entries if entries[e].live) == \
            ["j0", "j1", "j2"]
        gw = pkg["gateway"](_servers(pkg, models, True)).start()
        try:
            report = gw.recover_from_journal(entries)
            assert report["rerun"] == 3 and report["shed"] == 0
            outs.append({f"j{i}": list(gw.resume_ticket(f"j{i}").result(
                timeout=120).tokens) for i in range(3)})
        finally:
            gw.drain(timeout=120)
    assert outs[1] == outs[0]


def test_refuses_what_is_not_ported(models):
    """Remote replicas and the role split are ported now
    (tests/test_torch_remote.py, tests/test_torch_disagg.py): the
    gateway refuses only a role split it could not serve, as the JAX
    gateway does."""
    servers = _servers(PORT, models, True)
    jax_servers = _servers(JAX, models, True)
    for gw_cls, pair in ((JaxGateway, jax_servers), (Gateway, servers)):
        with pytest.raises(ValueError, match="at least one"):
            gw_cls(pair, roles=["decode", "decode"])
        with pytest.raises(ValueError, match="names 1 replicas"):
            gw_cls(pair, roles=["prefill"])
    gw = Gateway(servers, roles=["prefill", "decode"])
    assert [r.role for r in gw.replicas] == ["prefill", "decode"]


def test_device_lock_keeps_captures_alone():
    """Each thread runs steps holding the lock shared and, now and then,
    a capture inside a step holding it exclusively (re-entered, as a
    capture's first call and the capture itself nest): a capture never
    overlaps a step or another capture."""
    lock = DeviceLock()
    state = {"shared": 0, "exclusive": 0, "steps": 0, "captures": 0}
    guard = threading.Lock()
    errors = []

    def worker(seed):
        rng = random.Random(seed)
        for _ in range(200):
            with lock.shared():
                with guard:
                    if state["exclusive"]:
                        errors.append("a step inside a capture")
                    state["shared"] += 1
                if rng.random() < 0.1:
                    with guard:  # the capture gives up this step's hold
                        state["shared"] -= 1
                    with lock.exclusive(), lock.exclusive():
                        with guard:
                            if state["shared"] or state["exclusive"]:
                                errors.append("a capture beside a holder")
                            state["exclusive"] += 1
                        time.sleep(0)
                        with guard:
                            state["exclusive"] -= 1
                            state["captures"] += 1
                    with guard:
                        state["shared"] += 1
                time.sleep(0)
                with guard:
                    state["shared"] -= 1
                    state["steps"] += 1

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    assert state["steps"] == 16 * 200 and state["captures"] > 0
