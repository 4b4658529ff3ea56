"""Fault injection in the port: ``tony_tpu_torch/serve/faults.py`` (a copy
of the JAX package's module) held to tests/test_faults.py's unit cases,
and its hooks in the port's ``Server``: a dispatch fault surfaces out of
``step()`` as the plain ``RuntimeError`` a dead dispatch would be, a
request fault fires at admission, and after either, ``reset()`` frees
every page (parked prefills included), keeps the graph cache usable and
the server serves on with the same tokens as the JAX ``Server`` and an
unfaulted run.

Tolerance: none; tokens are compared for equality.
"""

import json
import time

import pytest

from test_torch_graphs import StandIn
from torch_parity import build_pair
from tony_tpu.serve import Request as JaxRequest
from tony_tpu.serve import Server as JaxServer
from tony_tpu_torch.models.graphs import GraphCache
from tony_tpu_torch.serve import (Fault, FaultPlan, InjectedFault, Request,
                                  Server)

EOS = (9, 33, 71)


# ------------------------------------------------------ FaultPlan unit


def test_fault_spec_validation():
    with pytest.raises(ValueError, match="trigger"):
        Fault("fail")
    with pytest.raises(ValueError, match="fault op must be one of"):
        Fault("explode", dispatch=1)
    with pytest.raises(ValueError, match="seconds"):
        Fault("wedge", dispatch=1)


def test_fault_plan_dispatch_trigger_fires_once_then_spends():
    plan = FaultPlan.fail_at(2)
    plan.on_dispatch()  # dispatch 1: below the trigger
    with pytest.raises(InjectedFault, match="dispatch 2"):
        plan.on_dispatch()
    plan.on_dispatch()  # spent: dispatch 3 sails through
    assert plan.fired == 1 and plan.n_dispatches == 3


def test_fault_plan_times_minus_one_is_permanent():
    plan = FaultPlan.fail_at(1, times=-1)
    for _ in range(3):
        with pytest.raises(InjectedFault):
            plan.on_dispatch()
    assert plan.fired == 3


def test_fault_plan_request_trigger():
    plan = FaultPlan.fail_request("victim")
    plan.on_admit("bystander")
    with pytest.raises(InjectedFault, match="victim"):
        plan.on_admit("victim")
    plan.on_admit("victim")  # spent


def test_fault_plan_wedge_sleeps():
    plan = FaultPlan.wedge_at(1, seconds=0.05)
    t0 = time.monotonic()
    plan.on_dispatch()  # wedges, does not raise
    assert time.monotonic() - t0 >= 0.05
    assert plan.fired == 1


def test_fault_plan_from_env_parsing_and_replica_filter():
    assert FaultPlan.from_env(env={}) is None
    assert FaultPlan.from_env(env={"TONY_SERVE_FAULTS": "  "}) is None
    env = {"TONY_SERVE_FAULTS": json.dumps(
        [{"op": "fail", "dispatch": 3, "replica": 0},
         {"op": "wedge", "dispatch": 1, "seconds": 0.5}])}
    p0 = FaultPlan.from_env(replica=0, env=env)
    assert len(p0.faults) == 2  # its own + the broadcast fault
    p1 = FaultPlan.from_env(replica=1, env=env)
    assert len(p1.faults) == 1 and p1.faults[0].op == "wedge"
    solo = FaultPlan.from_env(env={"TONY_SERVE_FAULTS":
                                   '{"op": "fail", "dispatch": 1}'})
    assert len(solo.faults) == 1
    with pytest.raises(ValueError, match="not valid JSON"):
        FaultPlan.from_env(env={"TONY_SERVE_FAULTS": "{nope"})
    with pytest.raises(ValueError, match="objects"):
        FaultPlan.from_env(env={"TONY_SERVE_FAULTS": "[1]"})
    mixed = {"TONY_SERVE_FAULTS": json.dumps(
        [{"op": "fail", "dispatch": 2}, {"op": "refuse", "call": 1}])}
    assert [f.op for f in FaultPlan.from_env(env=mixed).faults] == ["fail"]
    assert [f.op for f in FaultPlan.transport_from_env(env=mixed).faults] \
        == ["refuse"]


# -------------------------------------------------- engine-level hooks


@pytest.fixture(scope="module")
def models():
    return build_pair(9)


def _jax_tokens(models, prompt, n, **kw):
    jm, jp, _ = models
    srv = JaxServer(jm, jp, batch_size=2, min_bucket=8, paged=True,
                    eos_id=EOS, **kw)
    return next(iter(srv.run([JaxRequest(list(prompt), n)]))).tokens


def _assert_all_pages_free(srv):
    pool = srv.slots.pool
    held = {p for e in srv.prefix._entries.values() for p in e.pages} \
        if srv.prefix is not None else set()
    assert pool.reserved == 0 and pool.n_used == len(held)
    assert srv.done and srv.n_active == 0


def test_engine_dispatch_fault_takes_real_failure_path(models):
    """An injected fault surfaces out of step() as a plain RuntimeError;
    after ``reset()`` the engine serves again, token-exact."""
    srv = Server(models[2], batch_size=2, min_bucket=8, eos_id=EOS,
                 device="cpu", fault_plan=FaultPlan.fail_at(2))
    srv.submit(Request([1, 2, 3], 6, id="r"))
    srv.step()  # dispatch 1 fine
    with pytest.raises(RuntimeError):
        srv.step()
    srv.reset()
    _assert_all_pages_free(srv)
    res = {r.id: r for r in srv.run([Request([1, 2, 3], 6, id="r2")])}
    assert res["r2"].tokens == _jax_tokens(models, [1, 2, 3], 6)


def test_engine_request_fault_fires_at_admission(models):
    """A request fault fires before the victim's prefill, with its page
    reservation handed back."""
    srv = Server(models[2], batch_size=2, min_bucket=8, device="cpu",
                 fault_plan=FaultPlan.fail_request("victim"))
    srv.submit(Request([1, 2], 2, id="ok"))
    srv.submit(Request([3, 4], 2, id="victim"))
    with pytest.raises(InjectedFault):  # admission happens inside step
        srv.step()
    # the victim's reservation went back; the bystander holds its page
    assert srv.slots.pool.reserved == 0 and srv.slots.pool.n_used == 1
    srv.reset()
    _assert_all_pages_free(srv)


@pytest.mark.parametrize("setting", ["chunked", "spec"])
def test_fault_mid_run_recovers_token_exact(models, setting):
    """A dispatch fault with requests in flight (a prefill parked
    mid-chunk, or slots mid-speculation), on a server replaying through
    the stand-in graph backend: ``reset()`` frees every page, and the
    same requests resubmitted give the unfaulted run's tokens and the JAX
    package's, replaying the keys captured before the fault."""
    kw = dict(batch_size=2, min_bucket=8, kv_page_size=8, eos_id=EOS,
              chunk_steps=4, prefix_cache_mb=2.0)
    kw.update(prefill_chunk_tokens=16) if setting == "chunked" \
        else kw.update(speculate_k=4)
    reqs = [(list(range(1, 41)), 20), ([5, 6, 7, 5, 6, 7, 5, 6], 30),
            ([1, 2, 3, 4] * 4, 28)]

    def serve(srv, req_cls):
        for i, (p, n) in enumerate(reqs):
            srv.submit(req_cls(list(p), n, id=i))
        return {r.id: (r.tokens, r.finish_reason) for r in srv.run()}

    jm, jp, tm = models
    want = serve(JaxServer(jm, jp, paged=True, **kw), JaxRequest)
    # the fault fires at the top of step 2 (the 40-token prompt parked
    # after two of its three chunks) or step 3 (two speculating rounds
    # done)
    fault = FaultPlan.fail_at(2 if setting == "chunked" else 3)
    srv = Server(tm, device="cpu", fault_plan=fault, **kw)
    srv.graphs = GraphCache("cpu", StandIn())
    with pytest.raises(InjectedFault):
        serve(srv, Request)
    if setting == "chunked":
        assert srv.n_prefilling == 1
    else:
        assert srv.spec_rounds > 0
    assert srv.n_active > 0
    captures = srv.graphs.calls.copy()
    srv.reset()
    _assert_all_pages_free(srv)
    assert serve(srv, Request) == want
    c = srv.counters()
    assert c["kv_pages_reserved"] == 0 and c["freeze_faults"] == 0
    assert sum(n for (_, what), n in srv.graphs.calls.items()
               if what == "replays") > sum(
        n for (_, what), n in captures.items() if what == "replays")
    assert all(srv.graphs.calls[k, "eager"] == 0
               for k in ("decode", "verify", "prefill", "prefill_chunk"))
