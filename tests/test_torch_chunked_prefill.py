"""Chunked prefill in the port's ``Server`` held against the JAX
``Server`` on the same weights: the paged cases of tests/test_disagg.py's
chunked-prefill section, run through both packages. Greedy streams,
finish reasons, ``prefill_chunks`` on each Result and the engine's
counters must be equal; a sampled request, whose draws come from a
``torch.Generator`` in the port, is held to its own stream unchunked.

Also the intermediate chunk through a stand-in CUDA-graph backend (each
``prefill_chunk`` key captured once, then replayed) and with speculation
on.

Tolerance: none; tokens and counters are compared for equality.
"""

import numpy as np
import pytest

from test_torch_graphs import StandIn
from torch_parity import build_pair
from tony_tpu.serve import Request as JaxRequest
from tony_tpu.serve import Server as JaxServer
from tony_tpu_torch.models.graphs import GraphCache
from tony_tpu_torch.serve import Request, Server

EOS = (9, 33, 71)
COUNTERS = ("prefills", "dispatches", "decode_steps",
            "prefill_chunk_dispatches", "prefill_chunked_requests",
            "prefix_hits", "prefix_hit_tokens", "prefill_tokens_saved",
            "spec_rounds", "spec_drafted", "spec_accepted")


@pytest.fixture(scope="module")
def models():
    return build_pair(5)


def _prompts(seed=0, sizes=(40, 6, 24, 12)):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 96, size=n).tolist() for n in sizes]


def _servers(models, **kw):
    jm, jp, tm = models
    kw = dict(batch_size=2, kv_page_size=8, eos_id=EOS, **kw)
    return (JaxServer(jm, jp, paged=True, **kw),
            Server(tm, device="cpu", **kw))


def _results(srv, req_cls, reqs):
    for i, (p, n, knobs) in enumerate(reqs):
        srv.submit(req_cls(list(p), n, id=i, **knobs))
    return {r.id: r for r in srv.run()}


def _both(models, reqs, **kw):
    """The requests through both packages: greedy tokens, finish reasons,
    ``prefill_chunks`` and ``COUNTERS`` equal; the port's server and
    {id: Result}."""
    jsrv, srv = _servers(models, **kw)
    want = _results(jsrv, JaxRequest, reqs)
    got = _results(srv, Request, reqs)
    for i, (_, _, knobs) in enumerate(reqs):
        fields = [(r.finish_reason, r.prefill_chunks, r.prefix_hit_tokens)
                  + ((r.tokens,) if not knobs else ())
                  for r in (got[i], want[i])]
        assert fields[0] == fields[1], i
    jc, c = jsrv.counters(), srv.counters()
    assert {k: c[k] for k in COUNTERS} == {k: jc[k] for k in COUNTERS}
    assert c["kv_pages_reserved"] == 0
    return srv, got


@pytest.mark.parametrize("speculate_k", [0, 4], ids=["plain", "spec"])
def test_chunked_prefill_token_parity(models, speculate_k):
    """Chunked equals monolithic, in the port and against the JAX
    package; a 40-token prompt at a 16-token budget takes 16 + 16 + a
    final 8 (three dispatches), a short one a single shot."""
    reqs = [(p, 6, {}) for p in _prompts()]
    mono, want = _both(models, reqs, speculate_k=speculate_k)
    srv, got = _both(models, reqs, speculate_k=speculate_k,
                     prefill_chunk_tokens=16)
    assert {i: r.tokens for i, r in got.items()} \
        == {i: r.tokens for i, r in want.items()}
    assert got[0].prefill_chunks == 3
    assert got[1].prefill_chunks == 1
    assert srv.prefill_chunk_dispatches >= 3
    assert srv.prefill_chunked == 2  # the 40- and the 24-token prompt


def test_sampled_first_token_survives_chunking(models):
    """A sampled request's first draw and its chain do not see the chunk
    boundaries."""
    req = [(_prompts()[0], 6, dict(temperature=0.8, top_k=5, seed=3))]
    _, mono = _both(models, req)
    _, chunked = _both(models, req, prefill_chunk_tokens=16)
    assert chunked[0].tokens == mono[0].tokens
    assert chunked[0].prefill_chunks == 3


def test_chunked_prefill_with_prefix_seed_parity(models):
    """The second request's suffix is chunked from the seeded offset of
    a prefix hit: equal to the store-on monolithic run and to the JAX
    package."""
    rng = np.random.default_rng(1)
    base = rng.integers(1, 96, size=32).tolist()
    prompts = [base + rng.integers(1, 96, size=8).tolist()
               for _ in range(2)]

    def run(chunk):
        jsrv, srv = _servers(models, prefix_cache_mb=2.0,
                             prefill_chunk_tokens=chunk)
        outs = []
        for s, req_cls in ((jsrv, JaxRequest), (srv, Request)):
            got = {}
            for i, p in enumerate(prompts):
                s.submit(req_cls(list(p), 5, id=i))
                got.update({r.id: r.tokens for r in s.run()})
            outs.append(got)
        assert outs[0] == outs[1]
        assert srv.prefix_hits == jsrv.prefix_hits >= 1
        return outs[1]

    assert run(0) == run(16)


def test_chunked_prefill_interleaves_decode_rounds(models):
    """A short co-tenant finishes while the long prompt is still
    mid-prefill: between two chunks every live slot gets its round."""
    rng = np.random.default_rng(2)
    long_p = rng.integers(1, 96, size=40).tolist()
    for srv, req_cls in zip(_servers(models, prefill_chunk_tokens=16),
                            (JaxRequest, Request)):
        srv.submit(req_cls(list(long_p), 6, id="long"))
        srv.submit(req_cls([9, 9, 9], 2, id="short"))
        finished = srv.step()  # admits both; the long one is chunked
        # the parked slot counts as active; the short one is done
        assert srv.n_prefilling == 1 and srv.n_active == 1
        assert [r.id for r in finished] == ["short"]
        rest = list(srv.run())
        assert [(r.id, r.prefill_chunks) for r in rest] == [("long", 3)]


@pytest.mark.parametrize("in_dispatch_eos", [True, False],
                         ids=["fused", "unfused"])
def test_reset_mid_prefill_releases_pages(models, in_dispatch_eos):
    """A reset with a slot parked mid-prefill hands back every page and
    reservation, and the server serves on."""
    _, srv = _servers(models, prefill_chunk_tokens=16,
                      in_dispatch_eos=in_dispatch_eos)
    srv.submit(Request(list(range(1, 41)), 6, id=0))
    srv.step()
    assert srv.n_prefilling == 1
    srv.reset()
    pool = srv.slots.pool
    assert srv.n_prefilling == 0 and srv.done
    assert pool.n_used == 0 and pool.reserved == 0
    assert [r.id for r in srv.run([Request(list(range(1, 41)), 6,
                                           id=1)])] == [1]


def test_prefill_chunks_replay_through_graphs(models):
    """Through the stand-in backend: each intermediate chunk is a capture
    or a replay, one capture a (bucket, page columns) key, and the
    streams equal the unchunked, graph-free run's."""
    reqs = [(p, 6, {}) for p in _prompts(3, (40, 33, 48, 12, 40))]
    _, want = _both(models, reqs)
    _, srv = _servers(models, prefill_chunk_tokens=16)
    srv.graphs = GraphCache("cpu", StandIn())
    got = _results(srv, Request, reqs)
    assert {i: r.tokens for i, r in got.items()} \
        == {i: r.tokens for i, r in want.items()}
    c = srv.counters()
    keys = [k for k in srv.graphs.entries if k[0] == "prefill_chunk"]
    assert c["graph_prefill_chunk_captures"] == len(keys) > 0
    assert c["graph_prefill_chunk_replays"] > 0
    assert c["graph_prefill_chunk_eager"] == 0
    assert c["graph_prefill_chunk_captures"] \
        + c["graph_prefill_chunk_replays"] == c["prefills"] - (
            c["graph_prefill_captures"] + c["graph_prefill_replays"])
