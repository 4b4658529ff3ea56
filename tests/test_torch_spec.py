"""Speculative decoding in the port's ``Server`` (prompt-lookup drafts,
the verify round, fused and unfused) held against the JAX ``Server`` on
the same weights: the cases of tests/test_spec.py, run through both
packages. Greedy streams, finish reasons and the engine's counters
(dispatches, micro-steps, speculation totals, waste and frozen steps)
must be equal; a sampled request, whose draws come from a
``torch.Generator`` in the port, is held to its own stream with
speculation off. EOS ids are chosen up front, never read off a model's
output.

Also the drafter itself against the JAX one, the rewind over rejected
drafts (junk K/V past a slot's length), and the verify round through a
stand-in CUDA-graph backend: each verify key captured once then
replayed, and a round with a sampled row replayed at its sampled
variant.

Tolerance: none; tokens and counters are compared for equality.
"""

import numpy as np
import pytest

import tony_tpu.serve.engine as jax_engine
import tony_tpu_torch.serve.engine as engine
from test_torch_graphs import StandIn
from torch_parity import build_pair
from tony_tpu.serve import Request as JaxRequest
from tony_tpu.serve import Server as JaxServer
from tony_tpu_torch.models.graphs import GraphCache
from tony_tpu_torch.serve import Request, Server

# a repetitive prompt is prompt lookup's best case; greedy decode of the
# tiny random model also falls into cycles the drafter then rides
REP = [1, 2, 3, 4] * 4
REP2 = [5, 6, 7, 5, 6, 7, 5, 6]
SAMPLED = dict(temperature=0.9, top_k=8, seed=5)
# the counters the two packages keep alike
COUNTERS = ("dispatches", "decode_steps", "prefills", "spec_rounds",
            "spec_drafted", "spec_accepted", "wasted_steps", "frozen_steps",
            "freeze_faults", "prefix_hits", "prefix_hit_tokens")


@pytest.fixture(scope="module")
def models():
    return build_pair(9)


@pytest.fixture(scope="module")
def flash_models():
    return build_pair(9, decode_attention="flash")


def _serve(srv, req_cls, specs):
    """Submit ``specs`` = [(prompt, budget, knobs)] with ids 0.. and run
    to the end; {id: (tokens, finish_reason)}."""
    reqs = [req_cls(list(p), n, id=i, **kw)
            for i, (p, n, kw) in enumerate(specs)]
    return {r.id: (r.tokens, r.finish_reason) for r in srv.run(reqs)}


def _port(models, specs, **kw):
    srv = Server(models[2], min_bucket=8, device="cpu", **kw)
    return srv, _serve(srv, Request, specs)


def _both(models, specs, **kw):
    """The same requests through the JAX and the port ``Server``: greedy
    streams and ``COUNTERS`` equal; returns the port's server and
    results."""
    jm, jp, _ = models
    jsrv = JaxServer(jm, jp, min_bucket=8, paged=True, **kw)
    want = _serve(jsrv, JaxRequest, specs)
    srv, got = _port(models, specs, **kw)
    for i, (_, _, knobs) in enumerate(specs):
        if not knobs.get("temperature"):
            assert got[i] == want[i], i
    jc, c = jsrv.counters(), srv.counters()
    assert {k: c[k] for k in COUNTERS} == {k: jc[k] for k in COUNTERS}
    return srv, got


# --------------------------------------------------------------- drafter


@pytest.mark.parametrize("ctx, k, want", [
    ([9, 1, 2, 3, 7, 7, 1, 2, 3], 3, [7, 7, 1]),   # suffix [1,2,3] at 1
    ([9, 1, 2, 3, 7, 7, 1, 2, 3], 1, [7]),         # k clamps
    ([9, 1, 2, 3, 7, 7, 1, 2, 3], 50, [7, 7, 1, 2, 3]),  # to the tail
    (list(range(8)), 4, []),                       # no recurrence
    ([5], 4, []), ([], 4, []),                     # degenerate
    ([1, 2, 3, 4, 2, 3, 8, 0, 2, 3], 2, [8, 0]),   # most recent wins
    ([0, 3, 5, 9, 5, 1, 3, 5], 1, [9]),            # longest n wins
])
def test_propose_draft_matches_jax(ctx, k, want):
    got = engine._propose_draft(np.asarray(ctx, np.int64), k)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, jax_engine._propose_draft(np.asarray(ctx, np.int32), k))


def test_bucket_pow2():
    assert [engine._bucket_pow2(n) for n in (1, 2, 3, 4, 5, 8, 9)] == \
        [jax_engine._bucket_pow2(n) for n in (1, 2, 3, 4, 5, 8, 9)] == \
        [1, 2, 4, 4, 8, 8, 16]


# ------------------------------------------------------------- exactness


def test_greedy_parity_spec_on_off_mixed_batch(models):
    """Two drafting slots, a lookup miss and a sampled slot in one batch,
    chunk_steps 2 (verify rounds interleave with chunks at budget
    tails): the port equals the JAX package, and speculation on equals
    off in the port, the sampled stream included."""
    specs = [(REP, 16, {}), ([7, 9, 11], 12, {}), (REP2, 12, {}),
             ([9, 9, 2], 8, SAMPLED)]
    on, got = _both(models, specs, batch_size=3, chunk_steps=2,
                    speculate_k=4)
    _, off = _port(models, specs, batch_size=3, chunk_steps=2)
    assert got == off
    assert on.spec_rounds > 0 and on.spec_drafted > 0
    assert 0 <= on.spec_accepted <= on.spec_drafted


@pytest.mark.parametrize("case", ["dispatch_cut", "budgets", "prefix",
                                  "fused_no_drag", "drag_gate", "flash"])
def test_spec_parity(models, flash_models, case):
    """Speculation on equals speculation off in the port, and both equal
    the JAX package, in each of test_spec.py's settings:

    - dispatch_cut: chunk_steps 1, repetitive prompts; speculation
      strictly cuts the decode rounds;
    - budgets: budgets 1, 3 and 10, and a prompt near max_seq_len whose
      budget clamps: exactly the budget comes back, never more;
    - prefix: the prefix store and speculation together;
    - fused_no_drag: a lone drafter beside a sampled co-tenant at
      chunk_steps 8 with in-dispatch EOS on: it speculates, and needs at
      most one round more than speculation off;
    - drag_gate: the same with in-dispatch EOS off: the batch-drag gate
      keeps every round a chunk;
    - flash: chunk rounds through flash-decode, windows through the
      einsum path."""
    m = models
    kw = dict(batch_size=2, chunk_steps=1, speculate_k=4)
    if case == "dispatch_cut":
        rng = np.random.default_rng(0)
        specs = [((rng.integers(1, 60, size=3).tolist() * 6)[:14], 16, {})
                 for _ in range(4)]
        kw.update(batch_size=3, speculate_k=8)
    elif case == "budgets":
        long_p = (REP * 4)[:56]
        specs = [(REP, 1, {}), (REP, 3, {}), (REP, 10, {}), (long_p, 32, {})]
        kw.update(batch_size=1, speculate_k=8)
    elif case == "prefix":
        specs = [(REP + [21, 22], 8, {}), (REP + [23, 24], 8, {}),
                 (REP + [21, 22], 8, {})]
        kw.update(batch_size=1, speculate_k=6, prefix_cache_mb=8)
    elif case in ("fused_no_drag", "drag_gate"):
        specs = [(REP, 17, {}),
                 ([7, 9, 11], 17, dict(temperature=0.8, top_k=8, seed=3))]
        kw.update(chunk_steps=8, in_dispatch_eos=case == "fused_no_drag")
    else:
        m = flash_models
        specs = [([1, 2, 3] * 4, 8, {}), ([7, 9, 11], 6, {})]
    on, got = _both(m, specs, **kw)
    kw.pop("speculate_k")
    off, want = _both(m, specs, **kw)
    assert got == want
    assert on.freeze_faults == 0
    if case == "dispatch_cut":
        assert on.dispatches < off.dispatches
        assert on.spec_accepted > 0
    elif case == "budgets":
        assert [len(got[i][0]) for i in range(4)] == [1, 3, 10, 8]
    elif case == "prefix":
        assert on.prefix_hits > 0 and on.spec_rounds > 0
    elif case == "fused_no_drag":
        assert on.spec_rounds > 0 and on.spec_accepted > 0
        assert on.dispatches <= off.dispatches + 1
    elif case == "drag_gate":
        assert on.spec_rounds == 0
        assert on.dispatches == off.dispatches
    else:
        assert on.spec_rounds > 0


def test_sampled_request_keeps_its_draw_chain(models):
    """A sampled request draws once an emitted token on both paths, so
    riding verify rounds beside a drafter never moves its draws."""
    samp = ([9, 9, 2], 8, dict(temperature=0.9, top_k=8, seed=7))
    _, alone = _port(models, [samp], batch_size=2, chunk_steps=1)
    on, mixed = _port(models, [samp, (REP, 14, {})], batch_size=2,
                      chunk_steps=1, speculate_k=6)
    assert on.spec_rounds > 0
    assert mixed[0] == alone[0]


# the tiny model's greedy stream from REP2 runs 35 x 14, then turns to
# 26: with 26 as the eos id the stop lands inside a round that drafted
# 35s
MID_WINDOW_EOS = 26


@pytest.mark.parametrize("in_dispatch_eos", [True, False],
                         ids=["fused", "unfused"])
def test_mid_window_eos_trims_exactly(models, in_dispatch_eos):
    """An eos id landing mid-round: the stream stops at it, what followed
    is trimmed (fused: the acceptance is capped there and the
    continuation frozen), and the result equals speculation off and the
    JAX package."""
    specs = [(REP2, 30, {})]
    kw = dict(batch_size=1, chunk_steps=4, eos_id=MID_WINDOW_EOS,
              in_dispatch_eos=in_dispatch_eos)
    on, got = _both(models, specs, speculate_k=6, **kw)
    _, off = _both(models, specs, **kw)
    assert got == off
    toks, reason = got[0]
    assert reason == "eos" and toks[-1] == MID_WINDOW_EOS
    assert toks[:-1] == [35] * (len(toks) - 1) and len(toks) > 8
    assert on.spec_rounds > 0 and on.spec_drafted > 0


# --------------------------------------------------- rejected drafts


def _junk_draft(ctx, k, max_ngram=3):
    """One token the model rejects: never its greedy continuation."""
    return np.asarray([63 if ctx[-1] != 63 else 62], np.int64)


@pytest.fixture
def junk(monkeypatch):
    monkeypatch.setattr(engine, "_propose_draft", _junk_draft)
    monkeypatch.setattr(jax_engine, "_propose_draft", _junk_draft)


def test_donation_after_rejection_seeds_next_turn(models, junk):
    """Every round's draft is rejected, leaving junk K/V past each
    accepted position; the finished slot donates its pages to the
    prefix store and the next turn seeds from them and decodes over
    those positions: equal to cold serving and to the JAX package."""
    jm, jp, tm = models
    first = [7, 9, 11, 13]
    kw = dict(batch_size=1, min_bucket=8, chunk_steps=1,
              prefix_cache_mb=8, speculate_k=4)
    jsrv = JaxServer(jm, jp, paged=True, **kw)
    srv = Server(tm, device="cpu", **kw)
    for s in (jsrv, srv):
        s.SPEC_EMA_DISABLE = -1.0  # keep drafting, and being rejected
    t1 = {r.id: r for r in srv.run([Request(list(first), 6, id="t1")])}
    j1 = {r.id: r for r in jsrv.run([JaxRequest(list(first), 6, id="t1")])}
    assert t1["t1"].tokens == j1["t1"].tokens
    assert t1["t1"].drafted > 0 and t1["t1"].accepted == 0
    second = first + t1["t1"].tokens + [3]
    t2 = {r.id: r for r in srv.run([Request(list(second), 6, id="t2")])}
    j2 = {r.id: r for r in jsrv.run([JaxRequest(list(second), 6,
                                                id="t2")])}
    assert srv.prefix_hits > 0 and srv.prefix_hit_tokens > 0
    _, cold = _port(models, [(second, 6, {})], batch_size=1, chunk_steps=1)
    assert t2["t2"].tokens == cold[0][0] == j2["t2"].tokens


def test_ema_disables_hopeless_drafting(models, junk):
    """A slot whose drafts keep failing stops drafting once its EMA falls
    below the floor; a new tenant of the slot drafts again."""
    srv, got = _both(models, [([7, 9, 11], 20, {})], batch_size=1,
                     chunk_steps=1, speculate_k=4)
    assert srv._spec_ema[0] < srv.SPEC_EMA_DISABLE
    assert 0 < srv.spec_rounds <= 3 and srv.spec_accepted == 0
    rounds = srv.spec_rounds
    assert [r.id for r in srv.run([Request([5, 6], 4, id="y")])] == ["y"]
    assert srv.spec_rounds > rounds


def test_wasted_steps_count_rejected_drafts(models, junk):
    srv, _ = _both(models, [([7, 9, 11], 12, {})], batch_size=1,
                   chunk_steps=1, speculate_k=4)
    assert srv.spec_drafted > 0 and srv.spec_accepted == 0
    assert srv.wasted_steps == srv.spec_drafted


# --------------------------------------------------------- observability


def test_counters_and_result_fields(models):
    srv, _ = _port(models, [], batch_size=1, chunk_steps=1, speculate_k=4)
    res = next(iter(srv.run([Request(list(REP), 12, id="r")])))
    c = srv.counters()
    for key in ("wasted_steps", "spec_rounds", "spec_drafted",
                "spec_accepted", "spec_window_steps"):
        assert c[key] >= 0
    assert c["spec_drafted"] >= c["spec_accepted"] > 0
    assert res.drafted > 0 and 0 <= res.accepted <= res.drafted
    assert res.draft_hit_rate == res.accepted / res.drafted


@pytest.mark.parametrize("in_dispatch_eos", [False, True],
                         ids=["unfused", "fused"])
def test_wasted_steps_count_chunk_overshoot(models, in_dispatch_eos):
    """Budgets 3 and 10 at chunk_steps 8: the short slot needs 2 decode
    tokens of the 8-step chunk. With in-dispatch EOS off the other 6 are
    decoded and trimmed (``wasted_steps``); on, they are frozen
    re-emits (``frozen_steps``). Equal outputs either way."""
    specs = [([1, 2, 3], 3, {}), ([5, 9], 10, {})]
    srv, got = _both(models, specs, batch_size=2, chunk_steps=8,
                     in_dispatch_eos=in_dispatch_eos)
    waste, frozen = (0, 6) if in_dispatch_eos else (6, 0)
    assert srv.wasted_steps == waste and srv.frozen_steps == frozen
    assert srv.freeze_faults == 0


# ------------------------------------------------------ replayed rounds

GRAPH_MIX = [(REP, 20, {}), (REP2, 14, {}), ([7, 9, 11, 7, 9], 18, {}),
             ([1, 1, 1, 1, 1, 1], 9, {})]


@pytest.mark.parametrize("in_dispatch_eos", [True, False],
                         ids=["fused", "unfused"])
def test_verify_rounds_replay_through_graphs(flash_models,
                                             in_dispatch_eos):
    """Through the stand-in backend: every verify round and chunk of an
    all-greedy run is a capture or a replay, each verify key captured
    once (with continuation steps exactly when fused), and the streams
    equal the JAX package's."""
    jm, jp, tm = flash_models
    kw = dict(batch_size=2, chunk_steps=4, speculate_k=4, min_bucket=8,
              eos_id=(33, 71), in_dispatch_eos=in_dispatch_eos)
    want = _serve(JaxServer(jm, jp, paged=True, **kw), JaxRequest,
                  GRAPH_MIX)
    srv = Server(tm, device="cpu", **kw)
    srv.graphs = GraphCache("cpu", StandIn())
    assert _serve(srv, Request, GRAPH_MIX) == want
    c = srv.counters()
    keys = [k for k in srv.graphs.entries if k[0] == "verify"]
    assert c["graph_verify_captures"] == len(keys) > 0
    assert c["graph_verify_replays"] > 0
    assert c["graph_verify_captures"] + c["graph_verify_replays"] \
        == c["spec_rounds"]
    assert c["graph_verify_eager"] == c["graph_decode_eager"] == 0
    assert c["graph_decode_captures"] + c["graph_decode_replays"] \
        == c["dispatches"] - c["spec_rounds"]
    assert all((k[2] > 0) == in_dispatch_eos for k in keys)


def test_flash_decode_runs_once_a_layer_a_micro_step(flash_models,
                                                     monkeypatch):
    """flash-decode serves every single-token micro-step, chunk and
    continuation, and never a verify window: calls = n_layers x
    (decode_steps - spec_window_steps)."""
    import tony_tpu_torch.models.transformer as tmod

    calls = []
    real = tmod.flash_decode

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(tmod, "flash_decode", counting)
    srv, _ = _port(flash_models, GRAPH_MIX, batch_size=2, chunk_steps=4,
                   speculate_k=4, eos_id=(33, 71))
    c = srv.counters()
    assert c["spec_rounds"] > 0 and c["spec_window_steps"] > 0
    assert len(calls) == srv.model.cfg.n_layers * (
        c["decode_steps"] - c["spec_window_steps"])


def test_sampled_verify_rounds_run_eagerly_and_are_counted(models):
    """A verify round with a live sampled row is no longer eager: it
    replays at its key's sampled variant, and the streams equal the
    eager server's."""
    _, _, tm = models
    mix = [(REP, 16, {}), ([9, 9, 2], 12, SAMPLED)]
    kw = dict(batch_size=2, chunk_steps=2, speculate_k=4, min_bucket=8,
              device="cpu")
    want = _serve(Server(tm, **kw), Request, mix)
    srv = Server(tm, **kw)
    srv.graphs = GraphCache("cpu", StandIn())
    assert _serve(srv, Request, mix) == want
    c = srv.counters()
    assert c["graph_verify_eager"] == 0
    assert c["graph_verify_captures"] + c["graph_verify_replays"] \
        == c["spec_rounds"] > 0
    assert any(k[0] == "verify" and k[-1] == "sampled"
               for k in srv.graphs.entries)


def test_scan_int8_speculation_matches_jax():
    """tests/test_spec.py's ``scan_int8`` variant: stacked caches with
    int8 K/V and their scales under RoPE. The verify window scores and
    caches what single steps would (the port's [b, k] window against
    its own one-token steps, at that test's 1e-4 on logits and 1e-5 on
    cache values: the products differ in shape), and a speculating
    Server gives the JAX Server's greedy streams and counters."""
    import torch

    from tony_tpu_torch.models.generate import (init_cache,
                                                multi_decode_step,
                                                single_decode_step)

    m = build_pair(9, scan_layers=True, kv_cache_quant=True)
    tm = m[2]
    toks = torch.tensor([[3, 8, 1, 4], [6, 2, 9, 5]])
    pos = torch.tensor([[0, 1, 2, 3], [0, 1, 2, -1]])
    window = init_cache(tm, 2)
    _, logits = multi_decode_step(tm, window, toks, pos)
    steps = init_cache(tm, 2)
    for j in range(4):
        _, last = single_decode_step(tm, steps, toks[:, j], pos[:, j])
        live = pos[:, j] >= 0
        np.testing.assert_allclose(last[live].numpy(),
                                   logits[live, j].numpy(), atol=1e-4)
    for name, leaf in window["layers"].items():
        if isinstance(leaf, torch.Tensor):
            for row, n in ((0, 4), (1, 3)):
                np.testing.assert_allclose(
                    leaf[:, row, :n].float().numpy(),
                    steps["layers"][name][:, row, :n].float().numpy(),
                    atol=1e-5, err_msg=name)
    specs = [(REP, 12, {}), (REP2, 10, {}), ([7, 9, 11], 6, {})]
    on, got = _both(m, specs, batch_size=2, chunk_steps=4, speculate_k=4,
                    prefix_cache_mb=8)
    assert on.spec_rounds > 0 and on.freeze_faults == 0
    _, want = _both(m, specs, batch_size=2, chunk_steps=4,
                    prefix_cache_mb=8)
    assert got == want
