"""The port's autoscaler and rebalancer (``gateway/autoscale.py``,
``gateway/rebalance.py``, copies of the JAX package's) against the JAX
ones:

- the scaler's pure decision half on the same signal sequences
  (hysteresis and bounds, the floor, no flapping, cooldowns, the TTFT
  burn from histogram deltas, KV pressure): the same decisions and
  reasons;
- the backends: a provisioner slice a replica, released on destroy and
  on a failed build; a failing backend costs a recorded decision, never
  the gateway; a failed join releases its capacity;
- a burst over one port replica grows the fleet through probe admission
  and drains it back, every stream equal to the JAX ``Server``'s on the
  same weights, and the decisions land in the history;
- the rebalancer's skew classifier on the same signals, and a skewed
  two-replica fleet on one shared pool: one session live-migrated off
  the full replica, every stream equal to the JAX gateway's.

These run on the CPU only; on the card they are not measured
(ROADMAP.md).
"""

import json
import time

import pytest

from torch_parity import Gate, build_pair, tokens, wait_for
from tony_tpu.gateway import AutoScaler as JaxAutoScaler
from tony_tpu.gateway import Gateway as JaxGateway
from tony_tpu.gateway import GenRequest as JaxGenRequest
from tony_tpu.gateway import Rebalancer as JaxRebalancer
from tony_tpu.gateway import ThreadBackend as JaxThreadBackend
from tony_tpu.serve import Request as JaxRequest
from tony_tpu.serve import Server as JaxServer
from tony_tpu.serve.slots import PagePool as JaxPagePool
from tony_tpu_torch.gateway import (AutoScaler, Gateway, GatewayHistory,
                                    GenRequest, ProvisionerBackend,
                                    Rebalancer, ScaleError, ThreadBackend)
from tony_tpu_torch.serve import PagePool, Server

EOS = (38, 61)
KW = dict(batch_size=2, min_bucket=8, kv_page_size=8, eos_id=EOS,
          prefix_cache_mb=0.0)


@pytest.fixture(scope="module")
def models():
    return build_pair(9)


class _FakeGateway:
    """Just enough gateway for ``AutoScaler.decide``/``Rebalancer.decide``:
    the signals are handed in."""

    def __init__(self):
        self.scaler = None
        self.rebalancer = None
        self.live_replicas = []
        self.history = None


def _sig(**kw):
    base = dict(now=time.monotonic(), replicas_live=1,
                replicas_routable=1, depth=0, oldest_wait_s=0.0,
                enqueue_rate_per_s=0.0, by_tier={}, per_replica=[],
                active_slots=0, slots=4, shed_capacity_total=0,
                ttft_hist={"count": 0, "sum": 0.0, "buckets": {}},
                kv_pages_total=0, kv_pages_free=0)
    base.update(kw)
    return base


def _scalers(**kw):
    kw.setdefault("min_replicas", 1)
    kw.setdefault("max_replicas", 3)
    kw.setdefault("up_stable", 2)
    kw.setdefault("down_stable", 3)
    kw.setdefault("cooldown_up_s", 0.05)
    kw.setdefault("cooldown_down_s", 0.05)
    return (JaxAutoScaler(_FakeGateway(), JaxThreadBackend(lambda: None),
                          **kw),
            AutoScaler(_FakeGateway(), ThreadBackend(lambda: None), **kw))


# (scaler knobs, the signals of each tick; None = ``_after_action(up)``)
SCALER_CASES = {
    "hysteresis": ({}, [_sig(depth=10, oldest_wait_s=2.0)] * 3),
    "ceiling": ({"max_replicas": 1}, [_sig(depth=10)] * 5),
    "idle_down": ({}, [_sig(replicas_live=2)] * 4),
    "floor_idle": ({}, [_sig(replicas_live=1)] * 6),
    "below_floor": ({"min_replicas": 2},
                    [_sig(replicas_live=1), None, _sig(replicas_live=1)]),
    "no_flap": ({"up_stable": 2, "down_stable": 2},
                [_sig(depth=10, replicas_live=2, active_slots=4),
                 _sig(replicas_live=2, active_slots=2)] * 5),
    "cooldown": ({"up_stable": 1, "cooldown_up_s": 30.0},
                 [_sig(depth=10), None] + [_sig(depth=10)] * 4),
    "kv_pressure": ({"kv_used_frac": 0.9, "up_stable": 1},
                    [_sig(kv_pages_total=100, kv_pages_free=5),
                     _sig(kv_pages_total=100, kv_pages_free=50)]),
}


@pytest.mark.parametrize("case", sorted(SCALER_CASES))
def test_scaler_decisions_match_jax(case):
    knobs, ticks = SCALER_CASES[case]
    got = []
    for sc in _scalers(**knobs):
        now = time.monotonic()
        out = []
        for sig in ticks:
            if sig is None:
                sc._after_action(up=True)
                continue
            out.append(sc.decide(sig, now))
        got.append(out)
    assert got[1] == got[0]
    assert any(a is not None for a, _ in got[1]) \
        == (case not in ("ceiling", "floor_idle", "no_flap"))


def test_scaler_slo_burn_matches_jax():
    for knobs, hists in (
            ({"ttft_slo_s": 0.1}, [
                {"count": 10, "sum": 1.0, "buckets": {"0.1": 10}},
                {"count": 18, "sum": 9.0, "buckets": {"0.1": 12, "0.5": 6}},
                {"count": 19, "sum": 9.5, "buckets": {"0.1": 12,
                                                      "0.5": 7}}]),
            ({"ttft_slo_s": 0.3}, [
                {"count": 0, "sum": 0, "buckets": {}},
                {"count": 10, "sum": 2.8, "buckets": {"0.5": 10}},
                {"count": 20, "sum": 22.8, "buckets": {"0.5": 10,
                                                       "2.5": 10}}])):
        burns = [[sc._ttft_burn(_sig(ttft_hist=h)) for h in hists]
                 for sc in _scalers(up_stable=1, slo_burn=0.25,
                                    min_slo_sample=4, **knobs)]
        assert burns[1] == burns[0]
    assert burns[1][1:] == [0.0, pytest.approx(1.0)]


def test_provisioner_backend_acquires_and_releases():
    events = []

    class FakeProv:
        def __init__(self, slot, fail=False):
            self.slot, self.fail = slot, fail

        def provision(self):
            if self.fail:
                raise RuntimeError("quota")
            events.append(("provision", self.slot))
            return [f"10.0.0.{self.slot}"]

        def deprovision(self):
            events.append(("deprovision", self.slot))

    backend = ProvisionerBackend(FakeProv, lambda hosts: {"hosts": hosts})
    s0 = backend.create()
    assert s0 == {"hosts": ["10.0.0.0"]}
    backend.destroy(s0)
    assert events == [("provision", 0), ("deprovision", 0)]
    with pytest.raises(ScaleError, match="provision failed"):
        ProvisionerBackend(lambda slot: FakeProv(slot, fail=True),
                           lambda hosts: None).create()
    events.clear()

    def bad_build(hosts):
        raise RuntimeError("oom")

    with pytest.raises(ScaleError, match="server build"):
        ProvisionerBackend(FakeProv, bad_build).create()
    assert events == [("provision", 0), ("deprovision", 0)]


def _server(models, **kw):
    return Server(models[2], device="cpu", **{**KW, **kw})


def test_scaler_survives_backend_failure(models):
    def explode():
        raise RuntimeError("no capacity")

    gw = Gateway([_server(models)], max_queue=64).start()
    sc = AutoScaler(gw, ThreadBackend(explode), min_replicas=1,
                    max_replicas=2, up_stable=1, up_queue_depth=0.5,
                    cooldown_up_s=30.0)
    tickets = [gw.submit(GenRequest([1, 2, 3], max_new_tokens=8, id=i))
               for i in range(8)]
    assert sc.tick() == "up"
    assert sc.errors == 1 and sc.scale_ups == 0
    assert [d["action"] for d in sc.decisions] == ["up_failed"]
    assert sc.tick() is None  # the cooldown: no hot loop on the backend
    for t in tickets:
        t.result(timeout=120)
    assert gw.drain(timeout=60)


def test_scale_up_failed_join_releases_capacity(models):
    events = []

    class Backend:
        def create(self):
            events.append("create")
            return "capacity"

        def destroy(self, server):
            events.append(("destroy", server))

        def describe(self):
            return "fake"

    gw = Gateway([_server(models)], max_queue=8).start()
    sc = AutoScaler(gw, Backend(), min_replicas=1, max_replicas=2)
    assert gw.drain(timeout=60)
    sc._scale_up(_sig(), ["test"])  # add_replica -> GatewayClosed
    assert events == ["create", ("destroy", "capacity")]
    assert sc.scale_ups == 0 and sc.errors == 1


def test_burst_scales_up_then_drains_matching_jax(models, tmp_path):
    """A burst grows the fleet through probe admission, every stream
    equal to the JAX ``Server``'s on the same weights, no request shed;
    idle, it drains back to one replica; each decision lands in the
    history's ``scaling.jsonl``."""
    jm, jp, _ = models
    prompts = [[1 + i % 5, 2, 3] for i in range(16)]
    want = {r.id: r.tokens for r in JaxServer(
        jm, jp, chunk_steps=1, **KW).run(
        [JaxRequest(p, 12, id=i) for i, p in enumerate(prompts)])}
    hist = GatewayHistory(str(tmp_path), n_replicas=1)
    gw = Gateway([_server(models, chunk_steps=1)], max_queue=256,
                 history=hist, breaker_base_s=0.02,
                 breaker_max_s=0.1).start()
    sc = AutoScaler(gw, ThreadBackend(lambda: _server(models,
                                                      chunk_steps=1)),
                    min_replicas=1, max_replicas=2, interval_s=0.05,
                    up_queue_depth=1.5, up_wait_s=0.5, up_stable=1,
                    down_stable=3, cooldown_up_s=0.1, cooldown_down_s=0.2,
                    drain_timeout_s=120)
    tickets = [gw.submit(GenRequest(p, max_new_tokens=12, id=i))
               for i, p in enumerate(prompts)]
    assert sc.tick() == "up"  # the queue is deep: a replica joins
    sc.start()
    got = {t.request.id: t.result(timeout=240).tokens for t in tickets}
    assert got == want
    assert gw.stats.probes >= 1 and gw.stats.rejoins >= 1
    wait_for(lambda: sc.scale_ups >= 1 and sc.scale_downs >= 1
             and len(gw.live_replicas) == 1, what="the scale-down")
    snap = gw.snapshot()
    assert snap["completed"] == len(prompts) and snap["shed"] == {}
    assert gw.drain(timeout=120)
    rows = [json.loads(ln) for ln in open(
        tmp_path / "intermediate" / hist.app_id / "metrics" /
        "scaling.jsonl")]
    assert [r["action"] for r in rows][:1] == ["up"]
    assert "down" in [r["action"] for r in rows]


def _rows(*occupancy):
    return {"now": time.monotonic(), "replicas": [
        {"index": i, "active": a, "slots": s,
         "tickets": [{"rid": f"r{i}{k}", "prompt": [1, 2], "remaining": 9}
                     for k in range(a)]}
        for i, (a, s) in enumerate(occupancy)]}


@pytest.mark.parametrize("occupancy", [
    ((2, 2), (0, 2)), ((1, 2), (0, 2)), ((2, 2), (1, 2)),
    ((4, 4), (0, 4), (1, 4)), ((2, 2),), ((2, 2), (2, 2))],
    ids=["skewed", "one_session", "small_gap", "three", "alone", "even"])
def test_rebalancer_decisions_match_jax(occupancy):
    plans = []
    for cls in (JaxRebalancer, Rebalancer):
        rb = cls(_FakeGateway(), stable=2)
        out = []
        for _ in range(3):
            plan, reasons = rb.decide(_rows(*occupancy), time.monotonic())
            out.append((None if plan is None else (
                plan["hot"]["index"], plan["cold"]["index"],
                round(plan["gap"], 6)), reasons))
        plans.append(out)
    assert plans[1] == plans[0]
    assert (plans[1][1][0] is not None) \
        == (occupancy in (((2, 2), (0, 2)), ((4, 4), (0, 4), (1, 4))))


def _skewed_run(models, jax: bool):
    """Two live streams on replica 0 of two sharing one pool, none on
    replica 1: one rebalancer tick moves one stream, mid-flight."""
    jm, jp, tm = models
    if jax:
        pool = JaxPagePool(jm, jp, 64, 8, shared=True)
        servers = [JaxServer(jm, jp, page_pool=pool, chunk_steps=1, **KW)
                   for _ in range(2)]
        gw_cls, req, rb_cls = JaxGateway, JaxGenRequest, JaxRebalancer
    else:
        pool = PagePool(tm, 64, 8, shared=True)
        servers = [Server(tm, device="cpu", page_pool=pool, chunk_steps=1,
                          **KW) for _ in range(2)]
        gw_cls, req, rb_cls = Gateway, GenRequest, Rebalancer
    # both streams start on replica 0: hold it once each has 3 tokens
    gates = [Gate(s, 3, rows=2) for s in servers]
    gw = gw_cls(servers, stall_timeout_s=300.0).start()
    try:
        gw.replicas[1].outstanding = 500
        tickets = [gw.submit(req(tokens(76 + i, 13).tolist(), 30,
                                 id=f"s{i}")) for i in range(2)]
        wait_for(gates[0].held.is_set, what="both streams on replica 0")
        wait_for(lambda: all(t._n_emitted >= 3 for t in tickets),
                 what="both streams past 3 tokens")
        gw.replicas[1].outstanding = 0
        rb = rb_cls(gw, stable=1, cooldown_s=0.0)
        moved = rb.tick()
        for g in gates:
            g.open()
        outs = {t.request.id: t.result(timeout=300).tokens
                for t in tickets}
        return outs, moved, rb.moves, gw.snapshot()["shed"]
    finally:
        for g in gates:
            g.open()
        gw.drain(timeout=120)


def test_rebalancer_moves_a_session_matching_jax(models):
    got = _skewed_run(models, False)
    assert got == _skewed_run(models, True)
    assert got[1:] == (1, 1, {})
