"""The port's host-RAM page tier and page wire codec (``serve/tier.py``,
``serve.slots.gather_pages`` / ``scatter_pages``) against the JAX
package's, on the same weights (``build_pair``) and the same pool
content:

- a device -> host -> device page round trip is bitwise, fp32 and bf16,
  float and int8 KV (scales included), and the gathered pages are the
  JAX gather's bytes;
- the wire codec is bitwise, bf16 included, and reads the JAX package's
  wire form;
- a store squeezed to a couple of entries spills to the tier, and the
  resubmitted prompts page back in: tokens, finish reasons and every
  tier and prefix counter equal to the JAX ``Server``'s, outputs equal
  to a run without the tier, and each paged-in page bit-equal to the
  page that was spilled;
- the tier's own LRU budget and its asynchronous FIFO spills keep the
  JAX tier's accounting.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from torch_parity import build_pair, tokens
from tony_tpu.serve import Request as JaxRequest
from tony_tpu.serve import Server as JaxServer
from tony_tpu.serve.slots import PagePool as JaxPagePool
from tony_tpu.serve.slots import cache_batch_axis as jax_batch_axis
from tony_tpu.serve.slots import gather_pages as jax_gather_pages
from tony_tpu.serve.tier import HostPageTier as JaxHostPageTier
from tony_tpu.serve.tier import encode_array as jax_encode_array
from tony_tpu_torch.serve import HostPageTier, Request, Server
from tony_tpu_torch.serve.slots import (PagePool, gather_pages,
                                        pool_leaf_keys, scatter_pages)
from tony_tpu_torch.serve.tier import (decode_array, decode_payload,
                                       encode_array, encode_payload,
                                       pages_to_host, payload_nbytes,
                                       payload_pages, trim_payload)

EOS = (38, 61)
N_PAGES, PS = 7, 8


def _jax_leaves(tree) -> dict:
    """{(layer key, leaf name): array} of a JAX cache or payload's pool
    leaves."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = [str(getattr(p, "key", p)) for p in path]
        if jax_batch_axis(path, leaf) is None:
            continue
        block = next(k for k in keys if k.startswith("block_"))
        out[block, keys[-1]] = np.asarray(leaf)
    return out


def _pools(dtype: str, kv_int8: bool, seed: int = 0):
    """A JAX and a port page pool holding the same random bits."""
    jdt, tdt = {"fp32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jm, jp, tm = build_pair(9, jax_dtype=jdt, torch_dtype=tdt,
                            kv_cache_quant=kv_int8)
    jpool = JaxPagePool(jm, jp, N_PAGES, PS)
    pool = PagePool(tm, N_PAGES, PS)
    rng = np.random.default_rng(seed)
    fills = {}
    for key, name in pool_leaf_keys(pool.cache):
        leaf = pool.cache[key][name]
        shape = (N_PAGES, *leaf.shape[1:])
        if leaf.dtype == torch.int8:
            vals = rng.integers(-120, 120, size=shape).astype(np.int8)
            leaf[:N_PAGES] = torch.from_numpy(vals)
        else:
            vals = rng.standard_normal(shape).astype(np.float32)
            leaf[:N_PAGES] = torch.from_numpy(vals).to(leaf.dtype)
        fills[key, name] = vals

    def fill(path, leaf):
        if jax_batch_axis(path, leaf) is None:
            return leaf
        keys = [str(getattr(p, "key", p)) for p in path]
        block = next(k for k in keys if k.startswith("block_"))
        return jnp.asarray(fills[block, keys[-1]]).astype(leaf.dtype)

    jpool.cache = jax.tree_util.tree_map_with_path(fill, jpool.cache)
    return jpool, pool


def _bytes(leaf) -> bytes:
    t = torch.as_tensor(leaf).contiguous()
    return t.reshape(-1).view(torch.uint8).numpy().tobytes()


def _page_bytes(cache, idx) -> list:
    return [_bytes(cache[k][n][idx]) for k, n in pool_leaf_keys(cache)]


@pytest.mark.parametrize("dtype,kv_int8", [("fp32", False), ("fp32", True),
                                           ("bf16", False), ("bf16", True)])
def test_page_roundtrip_bitwise(dtype, kv_int8):
    """Gather three pages, copy them to the host and scatter them onto
    three OTHER pages: their bytes equal the sources', no other page
    changes, and the gathered payload holds the JAX gather's bytes for
    every leaf (int8 codes and their fp32 scales included)."""
    jpool, pool = _pools(dtype, kv_int8)
    src, dst = [1, 3, 4], [0, 2, 5]
    before = _page_bytes(pool.cache, src)
    payload = gather_pages(pool.cache, torch.tensor(src))
    want = _jax_leaves(jax_gather_pages(jpool.cache,
                                        jnp.asarray(src, jnp.int32)))
    for key, name in pool_leaf_keys(payload):
        got = payload[key][name]
        assert str(got.dtype).removeprefix("torch.") \
            == str(want[key, name].dtype)
        assert _bytes(got) == want[key, name].tobytes()
    assert payload_pages(payload) == 3
    host = pages_to_host(payload, 3)
    assert payload_pages(host) == 3
    untouched = [i for i in range(N_PAGES) if i not in dst]
    keep = _page_bytes(pool.cache, untouched)
    scatter_pages(pool.cache, host, torch.tensor(dst))
    assert _page_bytes(pool.cache, dst) == before
    assert _page_bytes(pool.cache, untouched) == keep


def test_wire_codec_bitwise_including_bf16():
    """The wire form is bitwise, bf16 and int8 leaves included, reads the
    JAX package's wire docs (bf16, fp32, uint32), cuts page-wise with
    ``trim_payload`` and refuses a payload of another leaf count."""
    jpool, pool = _pools("bf16", True, seed=1)
    payload = gather_pages(pool.cache, torch.tensor([0, 2, 5, 5]))
    doc = encode_payload(payload)
    assert encode_payload(doc) is doc  # a relay passes it through
    back = decode_payload(doc, pool_leaf_keys(pool.cache))
    for key, name in pool_leaf_keys(payload):
        assert back[key][name].dtype == payload[key][name].dtype
        assert _bytes(back[key][name]) == _bytes(payload[key][name])
    # each leaf's wire form is the JAX package's for the same content
    # (the leaf ORDER is each package's own)
    want = _jax_leaves(jax_gather_pages(
        jpool.cache, jnp.asarray([0, 2, 5, 5], jnp.int32)))
    for (key, name), d in zip(pool_leaf_keys(payload), doc["leaves"]):
        jd = jax_encode_array(want[key, name])
        assert (d["dtype"], d["shape"], d["b64"]) \
            == (jd["dtype"], jd["shape"], jd["b64"])
    for arr in (np.random.default_rng(0).standard_normal((1, 96)).astype(
            np.float32), np.array([7, 2 ** 32 - 1], np.uint32)):
        got = decode_array(jax_encode_array(arr))
        assert got.numpy().tobytes() == arr.tobytes()
        assert encode_array(arr) == jax_encode_array(arr)
    bf = jnp.asarray(np.linspace(-3, 3, 12), jnp.bfloat16).reshape(3, 4)
    got = decode_array(jax_encode_array(bf))
    assert got.dtype == torch.bfloat16
    assert _bytes(got) == np.asarray(bf).tobytes()
    cut = trim_payload(doc, 1, 3)
    cut_back = decode_payload(cut, pool_leaf_keys(pool.cache))
    for key, name in pool_leaf_keys(payload):
        assert _bytes(cut_back[key][name]) \
            == _bytes(payload[key][name][1:3])
    assert payload_nbytes(cut) * 2 == payload_nbytes(doc)
    with pytest.raises(ValueError, match="mismatched model configs"):
        decode_payload(doc, pool_leaf_keys(pool.cache)[:-1])


def test_tier_requires_paged_and_prefix_store():
    jm, jp, tm = build_pair(9)
    for make in (lambda **kw: JaxServer(jm, jp, batch_size=2, **kw),
                 lambda **kw: Server(tm, batch_size=2, device="cpu", **kw)):
        with pytest.raises(ValueError, match="prefix store"):
            make(kv_host_mb=4.0)
        with pytest.raises(ValueError, match="paged"):
            make(paged=False, prefix_cache_mb=2.0, kv_host_mb=4.0)


def _workload(make, req, prompts, *, kv_host_mb, prefix_mb):
    """Serial requests through one engine: distinct prompts that evict
    each other out of a tiny device store, then exact repeats."""
    srv = make(batch_size=2, paged=True, kv_page_size=PS, min_bucket=8,
               prefix_cache_mb=prefix_mb, kv_host_mb=kv_host_mb,
               prefix_donate=False, eos_id=EOS)
    outs = []
    for i, p in enumerate(prompts):
        srv.submit(req(list(p), 6, id=i))
        outs += [(r.id, r.tokens, r.finish_reason) for r in srv.run()]
    if srv.host_tier is not None:
        assert srv.host_tier.flush(timeout=60)
    return outs, srv


TIER_KEYS = ("kv_host_entries", "kv_host_tokens", "kv_host_spills",
             "kv_host_page_ins", "kv_host_page_in_bytes",
             "kv_host_evictions", "prefix_hits", "prefix_hit_tokens",
             "prefix_lookups", "prefix_evictions", "prefills",
             "kv_pages_used")


@pytest.mark.parametrize("kv_int8", [False, True], ids=["fp32", "int8"])
def test_spill_then_prefix_hit_matches_jax(kv_int8):
    """A store squeezed to about two entries spills its evictions to the
    tier; the repeated prompts page back in. Tokens, finish reasons and
    the tier and prefix counters equal the JAX ``Server``'s, the outputs
    equal a run without the tier, and every paged-in page holds the
    bytes the tier stored."""
    jm, jp, tm = build_pair(9, kv_cache_quant=kv_int8)
    distinct = [tokens(30 + i, 24).tolist() for i in range(3)]
    work = distinct + [distinct[0], distinct[1]]
    page = PagePool(tm, 1, PS).page_nbytes
    # two entries of 3 pages and [1, V] fp32 logits, not three
    prefix_mb = (2 * (3 * page + 4 * 96) + page) / (1 << 20)

    def jmake(**kw):
        return JaxServer(jm, jp, **kw)

    def tmake(**kw):
        return Server(tm, device="cpu", **kw)

    want, jsrv = _workload(jmake, JaxRequest, work, kv_host_mb=8.0,
                           prefix_mb=prefix_mb)
    got, srv = _workload(tmake, Request, work, kv_host_mb=8.0,
                         prefix_mb=prefix_mb)
    off, _ = _workload(tmake, Request, work, kv_host_mb=0.0,
                       prefix_mb=prefix_mb)
    assert got == want
    assert [t for _, t, _ in got] == [t for _, t, _ in off]
    c, jc = srv.counters(), jsrv.counters()
    assert {k: c[k] for k in TIER_KEYS} == {k: jc[k] for k in TIER_KEYS}
    assert c["kv_host_spills"] >= 2 and c["kv_host_page_ins"] >= 1, c
    # each prompt back in the device store holds the tier's bytes
    checked = 0
    for p in distinct[:2]:
        _, entry = srv.prefix.acquire(p)
        _, host = srv.host_tier.acquire(p)
        try:
            if entry is None or host is None \
                    or len(entry.tokens) != len(p):
                continue
            n = payload_pages(host.row)
            on_card = gather_pages(srv.slots.cache,
                                   torch.tensor(entry.pages[:n]))
            for key, name in pool_leaf_keys(host.row):
                assert _bytes(on_card[key][name]) \
                    == _bytes(host.row[key][name])
            checked += 1
        finally:
            if entry is not None:
                srv.prefix.release(entry)
            if host is not None:
                srv.host_tier.release(host)
    assert checked >= 1
    pool = srv.slots.pool
    assert pool.n_free + pool.n_used == pool.n_pages
    assert (pool.refcount >= 0).all() and c["kv_pages_reserved"] == 0


def test_match_len_and_summary_count_the_tier():
    """The routing probe and the heartbeat summary count what the host
    tier holds, as the JAX ``Server``'s do."""
    jm, jp, tm = build_pair(9)
    distinct = [tokens(40 + i, 24).tolist() for i in range(3)]
    page = PagePool(tm, 1, PS).page_nbytes
    prefix_mb = (2 * (3 * page + 4 * 96) + page) / (1 << 20)
    _, jsrv = _workload(lambda **kw: JaxServer(jm, jp, **kw), JaxRequest,
                        distinct, kv_host_mb=8.0, prefix_mb=prefix_mb)
    _, srv = _workload(lambda **kw: Server(tm, device="cpu", **kw),
                       Request, distinct, kv_host_mb=8.0,
                       prefix_mb=prefix_mb)
    assert srv.prefix.match_len(distinct[0]) == 0  # evicted on the card
    for p in distinct:
        assert srv.prefix_match_len(p) == jsrv.prefix_match_len(p) == 24
    assert srv.prefix_summary() == jsrv.prefix_summary()


def _tier_pair(budget):
    return JaxHostPageTier(budget_bytes=budget), \
        HostPageTier(budget_bytes=budget)


def test_tier_lru_eviction_under_budget():
    """The tier's own byte budget evicts its LRU entries, as the JAX
    tier's does on the same sizes."""
    jtier, tier = _tier_pair(2048)
    for i in range(3):
        toks = np.arange(8 * i, 8 * i + 8, dtype=np.int32)
        assert jtier.insert(toks, {"x": np.zeros((1, 8, 2, 16),
                                                 np.float32)}, None)
        assert tier.insert(toks, {"block_0": {"cached_key": torch.zeros(
            1, 8, 2, 16)}}, None)
    assert tier.stats() == jtier.stats()
    assert tier.stats()["entries"] == 2 and tier.stats()["evictions"] == 1
    assert tier.match_len(np.arange(16, 24)) == 8
    assert tier.match_len(np.arange(8)) == 0


def test_async_spill_fifo_ordering_and_accounting():
    """``spill_async``: the counters move when a spill is queued and
    equal the JAX tier's; ``has()`` sees queued content; the single
    worker lands inserts in order (under a two-entry budget the first
    queued is the one evicted); only the ``n`` real pages are stored,
    bitwise."""
    def jax_payload(v):
        return {"cached_key": np.full((4, 8, 2, 16), v, np.float32),
                "cached_value": np.full((4, 8, 2, 16), v, np.float32)}

    def payload(v):
        return {"block_0": {name: torch.full((4, 8, 2, 16), v)
                            for name in ("cached_key", "cached_value")}}

    jtier, tier = _tier_pair(10_000)
    toks = [np.arange(8 * i, 8 * i + 8, dtype=np.int32) for i in range(3)]
    for i, t in enumerate(toks):
        jtier.spill_async(t, jax_payload(float(i + 1)), 2, None)
        tier.spill_async(t, payload(float(i + 1)), 2, None)
        assert tier.has(t)
    assert tier.spills == 3 and tier.bytes_spilled == 3 * 4096
    assert tier.flush(timeout=10.0) and jtier.flush(timeout=10.0)
    assert tier.stats() == jtier.stats()
    assert tier.stats()["entries"] == 2
    assert tier.match_len(toks[0]) == 0 and tier.match_len(toks[2]) == 8
    match, entry = tier.acquire(toks[2])
    try:
        assert match == 8
        for leaf in entry.row["block_0"].values():
            assert leaf.shape[0] == 2 and bool((leaf == 3.0).all())
    finally:
        tier.release(entry)
