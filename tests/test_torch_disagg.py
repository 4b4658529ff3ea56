"""The prefill/decode role split with page handoff, the port
(``tony_tpu_torch``) against the JAX package on the same weights
(``build_pair``), the same requests and explicit EOS ids:

- a ``prefill=1,decode=1`` gateway, with a private pool a replica and
  with one shared pool (owner-swap handoffs), chunked prefill on the
  prefill side, greedy and seeded sampled requests: streams and finish
  reasons equal to the JAX gateway's and to one generalist replica's,
  and the handoff counters equal to the JAX gateway's;
- a hot prompt hands off as a gather with no prefill at all;
- a handoff over the wire codec (``serve.agent.result_doc``) admits
  token-exact; a page-geometry mismatch is refused at submit;
- a failing decode replica re-runs its handoff token-exact;
- the split over two in-process agents speaking HTTP
  (``AgentHTTP`` + ``RemoteServer``).
"""

import os
from unittest import mock

import pytest

from torch_parity import build_pair, tokens
from tony_tpu.gateway import Gateway as JaxGateway
from tony_tpu.gateway import GenRequest as JaxGenRequest
from tony_tpu.serve import FaultPlan as JaxFaultPlan
from tony_tpu.serve import Request as JaxRequest
from tony_tpu.serve import Server as JaxServer
from tony_tpu.serve.slots import PagePool as JaxPagePool
from tony_tpu_torch.gateway import Gateway, GenRequest, RemoteServer
from tony_tpu_torch.serve import FaultPlan, PagePool, Request, Server
from tony_tpu_torch.serve.agent import (AgentHTTP, ReplicaAgent,
                                        result_doc, result_from_doc)

EOS = (38, 61)
PS = 8
KW = dict(batch_size=2, paged=True, kv_page_size=PS, min_bucket=8,
          eos_id=EOS, prefix_cache_mb=2.0)
PROMPTS = [tokens(50, 40).tolist(), tokens(51, 6).tolist(),
           tokens(52, 24).tolist(), tokens(53, 12).tolist()]


@pytest.fixture(scope="module")
def models():
    return build_pair(9)


def _pkg(models, jax: bool) -> dict:
    jm, jp, tm = models
    if jax:
        return dict(server=lambda **kw: JaxServer(jm, jp, **{**KW, **kw}),
                    pool=lambda n: JaxPagePool(jm, jp, n, PS, shared=True),
                    gateway=JaxGateway, req=JaxGenRequest,
                    request=JaxRequest, faults=JaxFaultPlan)
    return dict(server=lambda **kw: Server(tm, device="cpu",
                                           **{**KW, **kw}),
                pool=lambda n: PagePool(tm, n, PS, shared=True),
                gateway=Gateway, req=GenRequest, request=Request,
                faults=FaultPlan)


def _mix(pkg, prompts=PROMPTS, tag="r"):
    """Greedy and seeded sampled requests over the same prompts."""
    return [pkg["req"](list(p), 12, id=f"{tag}{i}", seed=i,
                       temperature=0.8 if i % 2 else 0.0,
                       top_k=8 if i % 2 else 0)
            for i, p in enumerate(prompts)]


def _outs(gw, reqs, tickets: list | None = None) -> dict:
    """{id: (tokens, finish reason)} of ``reqs`` sent at once;
    ``tickets`` collects their tickets."""
    sent = [gw.submit(r) for r in reqs]
    if tickets is not None:
        tickets.extend(sent)
    out = {}
    for t in sent:
        res = t.result(timeout=300)
        out[t.request.id] = (list(res.tokens), res.finish_reason)
    return out


def _split_run(pkg, shared: bool):
    pool = pkg["pool"](64) if shared else None
    gw = pkg["gateway"]([pkg["server"](prefill_chunk_tokens=16,
                                       page_pool=pool),
                         pkg["server"](page_pool=pool)],
                        roles=["prefill", "decode"]).start()
    tickets: list = []
    try:
        outs = _outs(gw, _mix(pkg), tickets)
        snap = gw.snapshot()
    finally:
        assert gw.drain(timeout=60)
    if pool is not None:
        assert pool.reserved == 0 and (pool.refcount >= 0).all()
    rows = {r["replica"]: r for r in snap["replicas"]}
    return outs, snap, rows, tickets[0].metrics


@pytest.mark.parametrize("shared", [False, True],
                         ids=["private", "shared"])
def test_role_split_matches_jax_and_the_generalist(models, shared):
    port = _pkg(models, False)
    want, jsnap, jrows, jmeta = _split_run(_pkg(models, True), shared)
    got, snap, rows, meta = _split_run(port, shared)
    assert got == want
    ctrl = port["gateway"]([port["server"]()]).start()
    try:
        assert _outs(ctrl, _mix(port)) == got
    finally:
        ctrl.drain(timeout=60)
    assert snap["shed"] == {} and jsnap["shed"] == {}
    assert snap["routing"]["handoffs"] == jsnap["routing"]["handoffs"] \
        == len(PROMPTS)
    assert snap["engine"]["handoffs"] == jsnap["engine"]["handoffs"]
    assert snap["engine"]["handoffs"]["in"] == len(PROMPTS)
    for key in ("role", "prefills", "handoffs_in"):
        assert [rows[i][key] for i in (0, 1)] \
            == [jrows[i][key] for i in (0, 1)], key
    assert rows[1]["prefills"] == 0  # the decode side never prefills
    assert (meta["prefill_replica"], meta["replica"]) == (0, 1)
    assert meta["prefill_chunks"] == jmeta["prefill_chunks"] == 3
    mig, jmig = snap["engine"]["migrations"], jsnap["engine"]["migrations"]
    assert mig["bytes_avoided"] == jmig["bytes_avoided"]
    assert (mig["bytes_avoided"] > 0) == shared


def _hot_run(pkg):
    prompt = tokens(60, 24).tolist()
    gw = pkg["gateway"]([pkg["server"](), pkg["server"]()],
                        roles=["prefill", "decode"]).start()
    try:
        a = gw.submit(pkg["req"](list(prompt), 4, id="a"))
        ra = a.result(timeout=300)
        before = gw.replicas[0].server.prefills
        b = gw.submit(pkg["req"](list(prompt), 4, id="b"))
        rb = b.result(timeout=300)
        return (ra.tokens, rb.tokens, gw.replicas[0].server.prefills
                - before, b.metrics["prefix_hit_tokens"],
                b.metrics["prefill_chunks"])
    finally:
        gw.drain(timeout=60)


def test_hot_prompt_skips_prefill_entirely(models):
    """An exact repeat on the prefill side hands off as a gather of its
    stored pages: no prefill dispatch, a full prefix hit, the same
    stream; as in the JAX package."""
    got = _hot_run(_pkg(models, False))
    assert got == _hot_run(_pkg(models, True))
    assert got[0] == got[1] and got[2:] == (0, 24, 0)


def _wire_run(pkg):
    """A handoff through its wire form (the agent's result doc): the
    prefill engine's Result encoded and decoded, then admitted by a
    second engine."""
    pre, dec = pkg["server"](), pkg["server"]()
    out = {}
    for i, r in enumerate(_mix(pkg)):
        pre.submit(pkg["request"](list(r.prompt), 12, id=r.id,
                                  prefill_only=True))
        (hand,) = pre.run()
        assert hand.finish_reason == "handoff" and hand.tokens == []
        wire = result_from_doc(result_doc(hand)).handoff \
            if pkg["request"] is Request else hand.handoff
        dec.submit(pkg["request"](list(r.prompt), 12, id=r.id,
                                  temperature=r.temperature,
                                  top_k=r.top_k, seed=r.seed,
                                  handoff=wire))
        (res,) = dec.run()
        out[r.id] = (res.tokens, res.finish_reason)
    keys = ("handoffs_out", "prefills", "kv_pages_reserved")
    return out, {k: pre.counters()[k] for k in keys}, \
        {k: dec.counters()[k] for k in ("handoffs_in", "prefills")}


def test_handoff_over_the_wire_matches_jax(models):
    port = _pkg(models, False)
    got = _wire_run(port)
    assert got == _wire_run(_pkg(models, True))
    assert got[1]["handoffs_out"] == len(PROMPTS)
    assert got[2] == {"handoffs_in": len(PROMPTS), "prefills": 0}
    srv = port["server"]()
    want = {r.id: (res.tokens, res.finish_reason) for r in _mix(port)
            for res in srv.run([Request(list(r.prompt), 12, id=r.id,
                                        temperature=r.temperature,
                                        top_k=r.top_k, seed=r.seed)])}
    assert got[0] == want


def test_handoff_geometry_mismatch_refused_at_submit(models):
    """A decode engine with smaller pages than the prefill engine's
    refuses the payload at submit, in both packages, and admits
    nothing."""
    prompt = tokens(61, 22).tolist()
    for pkg in (_pkg(models, True), _pkg(models, False)):
        pre = pkg["server"](kv_page_size=16)
        dec = pkg["server"](kv_page_size=4)
        pre.submit(pkg["request"](list(prompt), 4, id="x",
                                  prefill_only=True))
        (hand,) = pre.run()
        with pytest.raises(ValueError, match="page geometry"):
            dec.submit(pkg["request"](list(prompt), 4, id="x",
                                      handoff=hand.handoff))
        assert dec.done
        with pytest.raises(ValueError, match="HALVES"):
            dec.submit(pkg["request"](list(prompt), 4, prefill_only=True,
                                      handoff=hand.handoff))


def test_roles_validation(models):
    port = _pkg(models, False)
    paged = port["server"]()
    unpaged = port["server"](paged=False, prefix_cache_mb=0.0)
    with pytest.raises(ValueError, match="at least one"):
        Gateway([paged, port["server"]()], roles=["prefill", "prefill"])
    with pytest.raises(ValueError, match="paged"):
        Gateway([paged, unpaged], roles=["prefill", "decode"])
    with pytest.raises(ValueError, match="names"):
        Gateway([paged], roles=["prefill", "decode"])
    with pytest.raises(ValueError, match="disaggregation"):
        unpaged.submit(Request([1, 2], 2, prefill_only=True))
    with pytest.raises(ValueError, match="needs the paged"):
        Server(models[2], device="cpu", paged=False,
               page_pool=PagePool(models[2], 8, PS, shared=True))


def _failover_run(pkg):
    fault = '{"op": "fail", "dispatch": 3, "replica": 1}'
    with mock.patch.dict(os.environ, {"TONY_SERVE_FAULTS": fault}):
        servers = [pkg["server"](), pkg["server"](), pkg["server"]()]
        servers[1].fault_plan = pkg["faults"].from_env(replica=1)
    gw = pkg["gateway"](servers, roles=["prefill", "decode", "decode"],
                        stall_timeout_s=30.0, breaker_base_s=0.1).start()
    try:
        outs = {}
        for i, p in enumerate((tokens(62, 24).tolist(),
                               tokens(63, 18).tolist())):
            outs[i] = gw.submit(pkg["req"](list(p), 8, id=f"f{i}")) \
                .result(timeout=300).tokens
        snap = gw.snapshot()
    finally:
        gw.drain(timeout=60)
    return outs, snap["shed"], snap["supervision"]["replica_failures"] >= 1


def test_decode_failover_reruns_the_handoff(models):
    """The decode replica that fails mid-stream hands its ticket, with
    its handoff payload, to the other decode replica: the same tokens
    as the JAX gateway's, no shed request."""
    got = _failover_run(_pkg(models, False))
    assert got == _failover_run(_pkg(models, True))
    assert got[1] == {} and got[2]


def test_role_split_over_agents_matches_jax(models):
    """Both pools behind in-process agents speaking HTTP: the payload
    crosses the wire base64-encoded both ways (the prefill result to the
    gateway, the gateway to the decode agent), and the streams equal one
    JAX generalist replica's."""
    port = _pkg(models, False)
    prompts = PROMPTS[:3]
    https = [AgentHTTP(ReplicaAgent(port["server"](
        prefill_chunk_tokens=16))).start(),
        AgentHTTP(ReplicaAgent(port["server"]())).start()]
    stubs = [RemoteServer(h.address, heartbeat_interval_s=0.2,
                          lease_misses=50) for h in https]
    gw = Gateway(stubs, roles=["prefill", "decode"]).start()
    jax = _pkg(models, True)
    ctrl = JaxGateway([jax["server"]()]).start()
    try:
        got = _outs(gw, _mix(port, prompts))
        want = _outs(ctrl, _mix(jax, prompts))
        assert got == want
        snap = gw.snapshot()
        assert snap["shed"] == {}
        assert snap["routing"]["handoffs"] == len(prompts)
    finally:
        gw.drain(timeout=60)
        ctrl.drain(timeout=60)
        for h in https:
            h.stop()
