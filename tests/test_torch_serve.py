"""The port's ``Server`` (paged KV pool, prefix store on, flash-decode,
in-dispatch EOS) held against the JAX ``Server`` on the same weights and
the same request mix: token-exact greedy streams and finish reasons,
through prefix hits (partial and exact), slot reuse and chunk sizes 1
and 8. EOS ids are chosen up front, never read off a model's output;
the mix is checked to end some requests on them.

Also the allocator (reserve/alloc/share/unref), the store, and what the
constructor (a mesh and int8 models, not ported yet; a paged cache over
a sliding window; the host tier without a store) and ``submit`` refuse.
"""

import copy

import numpy as np
import pytest
import torch

from torch_parity import build_pair, tokens
from tony_tpu.serve import Request as JaxRequest
from tony_tpu.serve import Server as JaxServer
from tony_tpu_torch.models import quantize_for_serving
from tony_tpu_torch.ops.decode import flash_decode
from tony_tpu_torch.serve import (PagePool, PoolExhausted, QueueFull,
                                  Request, Server)

EOS = (9, 33, 71)
SERVE = dict(min_bucket=8, kv_page_size=8, prefix_cache_mb=4.0)


def _mix():
    """(prompt, budget) pairs: a shared 12-token preamble on three
    prompts (partial hits), one exact repeat (exact hit), and more
    requests than slots (slot reuse)."""
    pre = tokens(10, 12).tolist()
    tails = [tokens(11 + i, n).tolist() for i, n in enumerate((3, 7, 5))]
    loose = [tokens(20 + i, n).tolist() for i, n in enumerate((4, 9, 2))]
    prompts = [pre + t for t in tails] + loose + [pre + tails[0]]
    budgets = [10, 6, 14, 8, 12, 1, 7]
    return list(zip(prompts, budgets))


def _run(server_cls, req_cls, srv):
    out = {}
    for i, (p, n) in enumerate(_mix()):
        srv.submit(req_cls(list(p), n, id=i))
        # drive between submissions so later requests find the store
        # warm and earlier slots free again
        if i % 3 == 2:
            for r in srv.step():
                out[r.id] = (r.tokens, r.finish_reason)
    while not srv.done:
        for r in srv.step():
            out[r.id] = (r.tokens, r.finish_reason)
    return out


@pytest.fixture(scope="module")
def models():
    return build_pair(9, decode_attention="flash")


@pytest.fixture(scope="module")
def jax_results(models):
    jm, jp, _ = models
    srv = JaxServer(jm, jp, batch_size=2, eos_id=EOS, chunk_steps=8,
                    paged=True, **SERVE)
    return _run(JaxServer, JaxRequest, srv), srv.counters()


@pytest.mark.parametrize("chunk_steps", [1, 8])
def test_server_matches_jax(models, jax_results, chunk_steps):
    _, _, tm = models
    want, jc = jax_results
    flash_decode.launches = 0
    srv = Server(tm, batch_size=2, eos_id=EOS, chunk_steps=chunk_steps,
                 device="cpu", **SERVE)
    got = _run(Server, Request, srv)
    assert got == want
    c = srv.counters()
    assert c["prefix_hits"] == jc["prefix_hits"] > 0
    assert c["prefix_hit_tokens"] == jc["prefix_hit_tokens"]
    assert any(reason == "eos" for _, reason in got.values())
    assert any(reason == "length" for _, reason in got.values())
    assert c["freeze_faults"] == 0
    assert c["kv_pages_reserved"] == 0
    assert flash_decode.launches == 0  # CPU tensors: the plain version


def test_int8_kv_server_matches_jax():
    jm, jp, tm = build_pair(9, decode_attention="flash",
                            kv_cache_quant=True)
    want = _run(JaxServer, JaxRequest,
                JaxServer(jm, jp, batch_size=3, eos_id=EOS, paged=True,
                          **SERVE))
    got = _run(Server, Request, Server(tm, batch_size=3, eos_id=EOS,
                                       device="cpu", **SERVE))
    assert got == want


def test_greedy_rows_ignore_sampled_neighbours(models):
    """A greedy request's stream does not depend on a sampled request
    sharing its batch; the sampled stream is reproducible by seed."""
    _, _, tm = models
    p = tokens(30, 6).tolist()
    q = tokens(31, 5).tolist()

    def run(with_sampled):
        srv = Server(tm, batch_size=2, eos_id=EOS, device="cpu", **SERVE)
        reqs = [Request(p, 10, id="g")]
        if with_sampled:
            reqs.append(Request(q, 10, temperature=0.9, top_k=20, seed=3,
                                id="s"))
        return {r.id: r.tokens for r in srv.run(reqs)}

    alone = run(False)
    mixed = run(True)
    again = run(True)
    assert mixed["g"] == alone["g"]
    assert mixed["s"] == again["s"]


def test_submit_validation(models):
    _, _, tm = models
    srv = Server(tm, batch_size=1, max_pending=1, device="cpu",
                 kv_page_size=8, kv_pages=4)
    with pytest.raises(ValueError, match="empty"):
        srv.submit(Request([], 4))
    with pytest.raises(ValueError, match="no room"):
        srv.submit(Request(list(range(64)), 4))
    with pytest.raises(PoolExhausted):
        srv.submit(Request([1, 2, 3], 40))   # 43 tokens > 4 pages of 8
    r = Request([1, 2, 3], 20)
    srv.submit(r)
    with pytest.raises(QueueFull):
        srv.submit(Request([1], 2))
    big = Server(tm, batch_size=1, device="cpu")
    r = Request([1, 2, 3], 100)
    big.submit(r)
    assert r.max_new_tokens == 61            # clamped to max_seq_len


def test_server_refuses_what_is_not_ported(models):
    _, _, tm = models
    with pytest.raises(NotImplementedError):
        Server(tm, device="cpu", mesh=object())
    # ported since: the host page tier (it needs a prefix store, as in
    # the JAX package) and a shared page pool (paged only);
    # tests/test_torch_tier.py, tests/test_torch_migrate.py
    with pytest.raises(ValueError, match="prefix store"):
        Server(tm, device="cpu", kv_host_mb=1.0)
    assert Server(tm, device="cpu", kv_host_mb=1.0,
                  prefix_cache_mb=1.0).host_tier is not None
    pool = PagePool(tm, 16, 8, shared=True)
    assert Server(tm, device="cpu", page_pool=pool).slots.cache \
        is pool.cache
    with pytest.raises(ValueError, match="needs the paged"):
        Server(tm, device="cpu", paged=False, page_pool=pool)
    # ported since: the unpaged cache and sliding-window models (served
    # unpaged, as the JAX package serves them); parity in
    # tests/test_torch_unpaged.py and tests/test_torch_window.py
    assert not Server(tm, device="cpu", paged=False).paged
    _, _, windowed = build_pair(9, sliding_window=8)
    assert not Server(windowed, device="cpu").paged
    with pytest.raises(NotImplementedError, match="sliding-window"):
        Server(windowed, device="cpu", paged=True)
    with pytest.raises(NotImplementedError, match="quantized"):
        Server(quantize_for_serving(tm), device="cpu")
    with pytest.raises(ValueError, match="lives on"):
        Server(tm, device="meta")


def test_pool_reservation_and_refcounts(models):
    _, _, tm = models
    pool = PagePool(tm, n_pages=4, page_size=8)
    assert pool.reserve(3)
    assert not pool.reserve(2)
    got = pool.alloc(2, from_reservation=True)
    pool.share(got[:1])
    assert pool.cow_shared() == 1
    with pytest.raises(RuntimeError, match="available"):
        pool.alloc(2)
    pool.cancel(1)
    pool.unref(got)
    assert pool.n_used == 1  # the shared page keeps one holder
    pool.unref(got[:1])
    assert pool.n_used == 0 and pool.available() == 4
    with pytest.raises(ValueError, match="free page"):
        pool.unref(got[:1])


def test_reset_returns_every_page(models):
    _, _, tm = models
    srv = Server(tm, batch_size=2, eos_id=-1, device="cpu", **SERVE)
    for i, (p, n) in enumerate(_mix()[:3]):
        srv.submit(Request(copy.copy(p), n, id=i))
    srv.step()
    assert srv.n_active
    srv.reset()
    c = srv.counters()
    assert srv.done and c["kv_pages_reserved"] == 0
    # what stays resident is the prefix store's pinned pages
    assert c["kv_pages_used"] == len({p for e in
                                      srv.prefix._entries.values()
                                      for p in e.pages})
    assert np.all(srv.slots.page_table == srv.slots.pool.n_pages)
    assert torch.is_tensor(srv.slots.cache["block_0"]["cached_key"])


def test_live_progress_tails_match_jax(models):
    """``live_progress(since)``: each in-flight request's tail past the
    count already seen, as the JAX ``Server`` returns it (the gateway's
    streaming hook passes ``since`` positionally)."""
    jm, jp, tm = models
    servers = [(JaxServer(jm, jp, batch_size=2, eos_id=-1, chunk_steps=2,
                          paged=True, **SERVE), JaxRequest),
               (Server(tm, batch_size=2, eos_id=-1, chunk_steps=2,
                       device="cpu", **SERVE), Request)]
    for srv, req in servers:
        for i, (p, _) in enumerate(_mix()[:2]):
            srv.submit(req(list(p), 12, id=i))
    seen: dict = {}
    for _ in range(3):
        for srv, _ in servers:
            srv.step()
        (js, _), (ts, _) = servers
        full = ts.live_progress()
        assert full == js.live_progress() and len(full) == 2
        tail = ts.live_progress(seen)
        assert tail == js.live_progress(seen)
        assert all(tail[k] == full[k][seen.get(k, 0):] for k in full)
        # one request read to its tip, the other one token behind it
        seen = {k: len(v) - k for k, v in full.items()}


def test_paged_counters_keys_match_jax(models, jax_results):
    """Paged ``counters()`` carries the JAX ``Server``'s keys, with
    ``kv_tokens_resident`` equal on the same run; the port adds its
    documented ``graph_*`` and ``flash_decode_launches`` (on the card)
    and ``spec_window_steps``; the handoff and migration counters (ported
    since) are there and equal too."""
    _, _, tm = models
    _, jc = jax_results
    srv = Server(tm, batch_size=2, eos_id=EOS, chunk_steps=8, device="cpu",
                 **SERVE)
    _run(Server, Request, srv)
    c = srv.counters()
    assert set(c) - {"spec_window_steps"} == set(jc)
    fabric = [k for k in jc if k.startswith(("handoffs_", "migrat"))]
    assert fabric and {k: c[k] for k in fabric} == {k: jc[k] for k in fabric}
    assert c["kv_tokens_resident"] == jc["kv_tokens_resident"] > 0
    for key in ("kv_pages_used", "prefix_entries", "prefix_bytes"):
        assert c[key] == jc[key]
