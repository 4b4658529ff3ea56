"""The port's unpaged ``Server`` (``paged=False``: fixed-shape cache rows,
a row prefix store) held against the JAX ``Server`` with ``paged=False``
on the same weights and the same request mix: tokens, finish reasons
and the counters both packages keep (prefix hits, hit tokens, bytes
stored and evictions included) equal, in fp32.

- ``tests/test_paged.py``'s parity matrix (rope and learned positions,
  float and int8 KV, and its ``scan_layers=True`` cases) through both
  packages' unpaged servers, and against the port's paged server. Its
  sampled request matches the JAX package in distribution only, so it
  is checked for its length alone.
- Prefix hits (exact and partial), the slot-reuse mix of
  tests/test_torch_serve.py, eviction under a small budget, donation
  of a finished sequence, and ``_usable_prefix``'s shrink (a seed whose
  suffix bucket would overrun the row).
- Chunked prefill and speculation (fused and with in-dispatch EOS off).
- A row frozen mid-chunk writes nothing: the finished slot's row is
  untouched (position 0 above all) while its neighbour decodes on.

EOS ids are chosen up front, never read off a model's output.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import build_pair, tokens
from tony_tpu.serve import Request as JaxRequest
from tony_tpu.serve import Server as JaxServer
from tony_tpu.serve.engine import _usable_prefix as jax_usable_prefix
from tony_tpu_torch.serve import Request, Server
from tony_tpu_torch.serve.engine import _usable_prefix
from tony_tpu_torch.serve.slots import (read_slot_row, row_nbytes,
                                        write_slot_row)

EOS = (9, 33, 71)
STORE = dict(min_bucket=8, prefix_cache_mb=4.0)
# the counters both packages keep on the unpaged path
SHARED = ("prefills", "decode_steps", "dispatches", "wasted_steps",
          "frozen_steps", "freeze_faults", "spec_rounds", "spec_drafted",
          "spec_accepted", "prefix_lookups", "prefix_hits",
          "prefix_hit_tokens", "prefill_tokens_saved",
          "prefill_chunk_dispatches", "prefill_chunked_requests",
          "prefix_entries", "prefix_bytes", "prefix_evictions")


def _mix():
    """tests/test_torch_serve.py's mix: a shared 12-token preamble on
    three prompts (partial hits), one exact repeat (exact hit), and more
    requests than slots (slot reuse)."""
    pre = tokens(10, 12).tolist()
    tails = [tokens(11 + i, n).tolist() for i, n in enumerate((3, 7, 5))]
    loose = [tokens(20 + i, n).tolist() for i, n in enumerate((4, 9, 2))]
    prompts = [pre + t for t in tails] + loose + [pre + tails[0]]
    return list(zip(prompts, [10, 6, 14, 8, 12, 1, 7]))


def _run(srv, req_cls, mix=None):
    out = {}
    for i, (p, n) in enumerate(mix or _mix()):
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


def _both(models, mix=None, **kw):
    """The mix through both packages' unpaged servers: (port results,
    JAX results, port counters, JAX counters)."""
    jm, jp, tm = models
    js = JaxServer(jm, jp, eos_id=EOS, paged=False, **kw)
    ts = Server(tm, eos_id=EOS, paged=False, device="cpu", **kw)
    want = _run(js, JaxRequest, mix)
    got = _run(ts, Request, mix)
    assert not ts.paged and ts.slots.pool is None
    return got, want, ts.counters(), js.counters()


def _same_counters(tc, jc):
    for key in SHARED:
        if key in jc or key in tc:
            assert tc[key] == jc[key], key


@pytest.fixture(scope="module")
def models():
    return build_pair(9, decode_attention="flash")


# --------------------------------------------------- the parity matrix

MATRIX_REQS = [([1, 2, 3], 6, "a"), ([17, 46, 10, 20, 62], 5, "b"),
               ([5, 9], 6, "c"), ([7, 7, 2, 1], 4, "d")]


@pytest.mark.parametrize("positional,kv_int8", [
    ("rope", False), ("rope", True), ("learned", False), ("learned", True)])
def test_unpaged_parity_matrix(positional, kv_int8):
    """Unpaged servers in both packages, and the port's paged server,
    give the same greedy streams across positional encoding x int8 KV;
    the sampled request ("c") finishes at its budget."""
    _matrix(positional, kv_int8, scan_layers=False)


@pytest.mark.parametrize("positional,kv_int8", [
    ("rope", False), ("rope", True), ("learned", True)])
def test_unpaged_parity_matrix_scanned(positional, kv_int8):
    """The matrix's ``scan_layers=True`` cases (tests/test_paged.py):
    stacked caches through both packages' unpaged servers and the
    port's paged one."""
    _matrix(positional, kv_int8, scan_layers=True)


def _matrix(positional: str, kv_int8: bool, scan_layers: bool) -> None:
    jm, jp, tm = build_pair(
        3, vocab_size=64, d_model=32, n_heads=2, n_kv_heads=2,
        max_seq_len=32, positional=positional,
        norm="layer" if positional == "learned" else "rms",
        kv_cache_quant=kv_int8, scan_layers=scan_layers)

    def reqs(cls):
        return [cls(list(p), n, temperature=0.9 if i == "c" else 0.0,
                    top_k=8, seed=3, id=i) for p, n, i in MATRIX_REQS]

    want = {r.id: (r.tokens, r.finish_reason) for r in JaxServer(
        jm, jp, batch_size=2, eos_id=-1, min_bucket=8, paged=False).run(
            reqs(JaxRequest))}
    out = {}
    for paged in (False, True):
        srv = Server(tm, batch_size=2, eos_id=-1, min_bucket=8, paged=paged,
                     kv_page_size=8, device="cpu")
        out[paged] = {r.id: (r.tokens, r.finish_reason)
                      for r in srv.run(reqs(Request))}
    assert len(out[False]["c"][0]) == 6
    for rid in ("a", "b", "d"):
        assert out[False][rid] == out[True][rid] == want[rid], rid


# ---------------------------------------------------------- the store


@pytest.mark.parametrize("chunk_steps", [1, 8])
def test_unpaged_server_with_store_matches_jax(models, chunk_steps):
    got, want, tc, jc = _both(models, batch_size=2,
                              chunk_steps=chunk_steps, **STORE)
    assert got == want
    _same_counters(tc, jc)
    assert tc["prefix_hits"] > 0 and tc["prefix_entries"] > 0
    assert any(r == "eos" for _, r in got.values())
    assert any(r == "length" for _, r in got.values())
    assert tc["freeze_faults"] == 0
    row_bytes = row_nbytes(Server(models[2], paged=False,
                                  device="cpu").slots.cache)
    # two resident rows, each its row's bytes less the two counters'
    assert tc["kv_bytes_resident"] == 2 * (row_bytes - 4 * 2)


def test_exact_hit_skips_prefill(models):
    """A prompt served twice: the second admission copies the stored row
    and samples from the stored logits, with no prefill; both packages
    agree on the hit and on the tokens."""
    p = tokens(40, 13).tolist()
    mix = [(p, 6), (tokens(41, 5).tolist(), 4), (p, 6)]
    jm, jp, tm = models
    out = {}
    for name, cls, req, args in (("jax", JaxServer, JaxRequest, (jm, jp)),
                                 ("torch", Server, Request, (tm,))):
        extra = {"device": "cpu"} if name == "torch" else {}
        srv = cls(*args, batch_size=1, eos_id=EOS, paged=False, **STORE,
                  **extra)
        res = {}
        for i, (prompt, n) in enumerate(mix):
            for r in srv.run([req(list(prompt), n, id=i)]):
                res[r.id] = r
        out[name] = (res, srv.counters())
    (tres, tc), (jres, jc) = out["torch"], out["jax"]
    for i in range(3):
        assert tres[i].tokens == jres[i].tokens
        assert tres[i].prefix_hit_tokens == jres[i].prefix_hit_tokens
        assert tres[i].prefill_chunks == jres[i].prefill_chunks
    assert tres[2].prefix_hit_tokens == len(p) and tres[2].prefill_chunks == 0
    assert tres[2].tokens == tres[0].tokens
    _same_counters(tc, jc)
    assert tc["prefills"] == 2


def test_eviction_under_a_small_budget(models):
    """A budget of three rows: inserts past it evict the least recently
    used entries, the same ones in both packages."""
    rb = row_nbytes(Server(models[2], paged=False,
                           device="cpu").slots.cache)
    mb = (3 * rb + 3 * 4 * 96 + 16) / (1 << 20)
    got, want, tc, jc = _both(models, batch_size=2, min_bucket=8,
                              prefix_cache_mb=mb)
    assert got == want
    _same_counters(tc, jc)
    assert tc["prefix_evictions"] > 0
    assert tc["prefix_bytes"] <= tc["prefix_budget_bytes"]


def test_donated_sequence_seeds_the_next_turn(models):
    """A finished request's prompt + generated tokens go back to the
    store; a follow-up prompt extending them is seeded past the first
    prompt's length."""
    jm, jp, tm = models
    first = tokens(50, 9).tolist()
    out = {}
    for name, cls, req, args in (("jax", JaxServer, JaxRequest, (jm, jp)),
                                 ("torch", Server, Request, (tm,))):
        extra = {"device": "cpu"} if name == "torch" else {}
        srv = cls(*args, batch_size=1, eos_id=-1, paged=False, **STORE,
                  **extra)
        (r1,) = list(srv.run([req(list(first), 7, id="t1")]))
        turn2 = first + r1.tokens + tokens(51, 4).tolist()
        (r2,) = list(srv.run([req(turn2, 5, id="t2")]))
        out[name] = (r1.tokens, r2.tokens, r2.prefix_hit_tokens,
                     srv.counters())
    (t1, t2, hit, tc), (j1, j2, jhit, jc) = out["torch"], out["jax"]
    assert (t1, t2, hit) == (j1, j2, jhit)
    # the donated row covers prompt + generated[:-1]
    assert hit == len(first) + len(t1) - 1
    _same_counters(tc, jc)


def test_usable_prefix_matches_jax():
    for max_len in (32, 64):
        for n in range(2, max_len):
            for off in range(0, n):
                assert _usable_prefix(off, n, max_len, 8) \
                    == jax_usable_prefix(off, n, max_len, 8), (off, n)


def test_seed_shrinks_to_fit_the_row(models):
    """A stored 50-token prompt and a 59-token one extending it: the
    9-token suffix buckets to 16, and 50 + 16 overruns the 64-position
    row, so the seed shrinks to 48 (both packages)."""
    base = tokens(60, 50).tolist()
    mix = [(base, 1), (base + tokens(61, 9).tolist(), 3)]
    jm, jp, tm = models
    hits = {}
    for name, cls, req, args in (("jax", JaxServer, JaxRequest, (jm, jp)),
                                 ("torch", Server, Request, (tm,))):
        extra = {"device": "cpu"} if name == "torch" else {}
        srv = cls(*args, batch_size=1, eos_id=-1, paged=False, **STORE,
                  **extra)
        res = {}
        for i, (p, n) in enumerate(mix):
            for r in srv.run([req(list(p), n, id=i)]):
                res[r.id] = (r.tokens, r.prefix_hit_tokens)
        hits[name] = res
    assert hits["torch"] == hits["jax"]
    assert hits["torch"][1][1] == 48


def test_slot_rows_round_trip(models):
    tm = models[2]
    srv = Server(tm, batch_size=3, paged=False, device="cpu")
    cache = srv.slots.cache
    for layer in (v for k, v in cache.items() if k.startswith("block_")):
        for leaf in layer.values():
            if isinstance(leaf, torch.Tensor):
                leaf.copy_(torch.randn(leaf.shape))
    row = read_slot_row(cache, 1)
    assert row["block_0"]["cached_key"].shape[0] == 1
    write_slot_row(cache, row, 2)
    for layer in (v for k, v in cache.items() if k.startswith("block_")):
        for leaf in layer.values():
            if isinstance(leaf, torch.Tensor):
                assert torch.equal(leaf[1], leaf[2])
    assert row_nbytes(cache) == sum(
        t.numel() * t.element_size() for k, v in row.items()
        if k.startswith("block_") for t in v.values()
        if isinstance(t, torch.Tensor)) + 4 * tm.cfg.n_layers


def test_scanned_slot_rows_round_trip():
    """tests/test_serve.py's scanned int8 case: a row read from a
    stacked cache (slot axis 1 of every K/V leaf and int8 scale, the
    layer axis whole) writes back into another slot bit for bit, and
    holds the JAX package's read of the same content."""
    from tony_tpu.serve.slots import read_slot_row as jax_read_slot_row
    from tony_tpu_torch.models.generate import init_cache

    jm, jp, tm = build_pair(4, scan_layers=True, kv_cache_quant=True,
                            max_seq_len=16)
    cache = init_cache(tm, 3)
    stack = cache["layers"]
    gen = torch.Generator().manual_seed(0)
    for name, leaf in stack.items():
        if isinstance(leaf, torch.Tensor):
            leaf.copy_(torch.randint(-100, 100, leaf.shape, generator=gen)
                       if leaf.dtype == torch.int8
                       else torch.randn(leaf.shape, generator=gen))
    row = read_slot_row(cache, 1)
    assert row["layers"]["cached_key"].shape[:2] == (tm.cfg.n_layers, 1)
    write_slot_row(cache, row, 2)
    for name, leaf in stack.items():
        if isinstance(leaf, torch.Tensor):
            assert torch.equal(leaf[:, 1], leaf[:, 2]), name
    jcache = {"layers": {"block": {"attn": {
        name: jnp.asarray(leaf.numpy()) if isinstance(leaf, torch.Tensor)
        else jnp.zeros((tm.cfg.n_layers,), jnp.int32)
        for name, leaf in stack.items()}}}}
    want = jax_read_slot_row(jcache, 1)["layers"]["block"]["attn"]
    for name, leaf in row["layers"].items():
        if isinstance(leaf, torch.Tensor):
            np.testing.assert_array_equal(leaf.numpy(),
                                          np.asarray(want[name]))


# ------------------------------------------------------------ options


@pytest.mark.parametrize("chunk", [8, 16])
def test_unpaged_chunked_prefill_matches_jax(models, chunk):
    long_mix = [(tokens(70 + i, n).tolist(), b) for i, (n, b) in
                enumerate(((40, 6), (5, 9), (27, 4), (19, 7), (3, 5)))]
    got, want, tc, jc = _both(models, mix=long_mix, batch_size=2,
                              min_bucket=8, prefill_chunk_tokens=chunk)
    assert got == want
    _same_counters(tc, jc)
    assert tc["prefill_chunked_requests"] > 0


def test_unpaged_chunked_prefill_with_store_matches_jax(models):
    got, want, tc, jc = _both(models, batch_size=2, prefill_chunk_tokens=8,
                              **STORE)
    assert got == want
    _same_counters(tc, jc)
    assert tc["prefill_chunked_requests"] > 0 and tc["prefix_hits"] > 0


@pytest.mark.parametrize("in_dispatch_eos", [True, False])
def test_unpaged_speculation_matches_jax(models, in_dispatch_eos):
    rep = [((tokens(80 + i, 4).tolist() * 6)[:n], b) for i, (n, b) in
           enumerate(((14, 9), (20, 12), (9, 6), (17, 10)))]
    got, want, tc, jc = _both(models, mix=rep, batch_size=2, min_bucket=8,
                              speculate_k=3, in_dispatch_eos=in_dispatch_eos)
    assert got == want
    _same_counters(tc, jc)
    assert tc["spec_rounds"] > 0
    _, off, _, _ = _both(models, mix=rep, batch_size=2, min_bucket=8,
                         in_dispatch_eos=in_dispatch_eos)
    assert got == off


# ------------------------------------------------------- frozen rows


def test_frozen_row_writes_nothing(models):
    """Slot 0's request ends two tokens into an 8-step chunk while slot
    1's decodes on: slot 0's row, position 0 above all, is the same
    after the chunk and after every later one as right after its
    prefill, but for the one position its live micro-step wrote."""
    jm, jp, tm = models
    reqs = [([3, 4, 5, 6, 7], 2, "short"), ([8, 1, 2, 4, 5], 20, "long")]
    srv = Server(tm, batch_size=2, eos_id=-1, chunk_steps=8, min_bucket=8,
                 paged=False, device="cpu")
    snaps = []
    real = srv._decode_round

    def spy():
        snaps.append({k: {n: t[0].clone() for n, t in v.items()
                          if isinstance(t, torch.Tensor)}
                      for k, v in srv.slots.cache.items()
                      if k.startswith("block_")})
        return real()

    srv._decode_round = spy
    got = {r.id: r.tokens for r in srv.run(
        [Request(list(p), n, id=i) for p, n, i in reqs])}
    want = {r.id: r.tokens for r in JaxServer(
        jm, jp, batch_size=2, eos_id=-1, chunk_steps=8, min_bucket=8,
        paged=False).run([JaxRequest(list(p), n, id=i)
                          for p, n, i in reqs])}
    assert got == want and len(got["short"]) == 2
    assert len(snaps) >= 3
    first = snaps[0]
    for key, leaves in first.items():
        for name, before in leaves.items():
            after = srv.slots.cache[key][name][0]
            # the short request fed one token, at position 5
            assert torch.equal(after[:5], before[:5]), (key, name)
            assert torch.equal(after[6:], before[6:]), (key, name)
            for snap in snaps[1:]:
                assert torch.equal(snap[key][name], after), (key, name)
