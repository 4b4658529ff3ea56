"""Sampled serving: the port's ``Server`` with sampled requests held
against the JAX ``Server`` on the CPU, on ``build_pair`` weights (fp32)
and explicit eos ids.

The mix has more requests than slots (re-admission), a shared preamble
(partial prefix hits) and an exact repeat (a full hit, whose first token
is drawn from the stored logits), and every second request samples
(temperature 0.8; top-k 5 on half of those, none on the others), each
with its own ``seed``. Both packages draw with Threefry from
``PRNGKey(seed)``, so the streams and finish reasons are token-exact,
paged and unpaged, with ``speculate_k`` 0 and 3, in-dispatch EOS on and
off. Through ``tests/test_torch_graphs.py``'s stand-in capture (under
its host-read guard) the same server gives the same tokens as the eager
one, and no decode chunk or verify round runs eagerly while sampled
rows are live: each replays at its key's sampled variant.

Tolerance: none; tokens, finish reasons and counters are compared for
equality.
"""

import pytest

from test_torch_graphs import StandIn
from torch_parity import build_pair, tokens
from tony_tpu.serve import Request as JaxRequest
from tony_tpu.serve import Server as JaxServer
from tony_tpu_torch.models.graphs import GraphCache
from tony_tpu_torch.serve import Request, Server

EOS = (9, 33, 71)


@pytest.fixture(scope="module")
def models():
    return build_pair(9, decode_attention="flash")


def _mix():
    pre = tokens(10, 12).tolist()
    tails = [tokens(11 + i, n).tolist() for i, n in enumerate((3, 7, 5))]
    loose = [tokens(20 + i, n).tolist() for i, n in enumerate((4, 9, 2))]
    rep = [5, 6, 7, 8] * 3
    prompts = [pre + t for t in tails] + loose + [pre + tails[0], rep, rep]
    return list(zip(prompts, [10, 6, 14, 8, 12, 1, 7, 12, 9]))


def _knobs(i: int, sampled: bool) -> dict:
    if not sampled or i % 2 == 0:
        return {}
    return dict(temperature=0.8, top_k=5 if i % 4 == 1 else 0)


def _serve(srv, cls, sampled=True):
    for i, (p, n) in enumerate(_mix()):
        srv.submit(cls(list(p), n, seed=100 + i, id=i, **_knobs(i, sampled)))
    out = {}
    while not srv.done:
        for r in srv.step():
            out[r.id] = (r.tokens, r.finish_reason)
    return out


def _kw(paged, spec, eos):
    kw = dict(batch_size=2, eos_id=EOS, chunk_steps=4, min_bucket=8,
              prefix_cache_mb=4.0, paged=paged, speculate_k=spec,
              in_dispatch_eos=eos)
    if paged:
        kw["kv_page_size"] = 8
    return kw


@pytest.mark.parametrize("eos", [True, False], ids=["eos_on", "eos_off"])
@pytest.mark.parametrize("spec", [0, 3], ids=["nospec", "spec3"])
@pytest.mark.parametrize("paged", [True, False], ids=["paged", "unpaged"])
def test_sampled_server_matches_jax(models, paged, spec, eos):
    jm, jp, tm = models
    kw = _kw(paged, spec, eos)
    jsrv = JaxServer(jm, jp, **kw)
    want = _serve(jsrv, JaxRequest)
    srv = Server(tm, device="cpu", **kw)
    got = _serve(srv, Request)
    assert got == want
    c, jc = srv.counters(), jsrv.counters()
    for key in ("dispatches", "decode_steps", "prefix_hits",
                "spec_rounds", "spec_accepted"):
        assert c[key] == jc[key], key
    assert c["prefix_hits"] > 0
    if spec and eos:
        # (EOS off, the batch-drag gate refuses rounds beside sampled
        # rows, in both packages alike)
        assert c["spec_rounds"] > 0
    # the sampled requests did sample: their streams leave the greedy ones
    greedy = _serve(Server(tm, device="cpu", **kw), Request, sampled=False)
    moved = [i for i in got if _knobs(i, True) and got[i] != greedy[i]]
    assert len(moved) >= 2
    assert all(got[i] == greedy[i] for i in got if not _knobs(i, True))


@pytest.mark.parametrize("spec", [0, 3], ids=["nospec", "spec3"])
@pytest.mark.parametrize("paged", [True, False], ids=["paged", "unpaged"])
def test_sampled_rounds_replay_through_the_graph_cache(models, paged, spec):
    _, _, tm = models
    kw = _kw(paged, spec, True)
    want = _serve(Server(tm, device="cpu", **kw), Request)
    srv = Server(tm, device="cpu", **kw)
    srv.graphs = GraphCache("cpu", StandIn())
    assert _serve(srv, Request) == want
    c = srv.counters()
    chunk, verify = ("decode", "verify") if paged \
        else ("chunk_rows", "verify_rows")
    assert c[f"graph_{chunk}_eager"] == c[f"graph_{verify}_eager"] == 0
    assert c[f"graph_{chunk}_captures"] + c[f"graph_{chunk}_replays"] \
        == c["dispatches"] - c["spec_rounds"]
    assert c[f"graph_{verify}_captures"] + c[f"graph_{verify}_replays"] \
        == c["spec_rounds"]
    sampled = [k for k in srv.graphs.entries if k[-1] == "sampled"]
    assert sampled and c[f"graph_{chunk}_replays"] > 0
    if spec:
        assert any(k[0] == verify for k in sampled)
