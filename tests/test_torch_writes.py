"""The port's fixed-shape KV writes held against the JAX package's drop
semantics, bit for bit, on the same numpy-seeded inputs.

- ``write_plan`` + ``WritePlan.put`` (one index write over every entry
  of the window, no ``nonzero``) against the JAX ``Attention``'s
  ``mode="drop"`` scatter: both packages' attention blocks, with K and
  V projections set to the identity so K = V = x exactly in each, write
  one decode window into the same starting cache, and the caches must
  then be equal. Per-slot windows ``[b, l]`` and steps ``[b]``, paged
  windows and steps, float and int8 caches; positions negative (padding,
  empty or frozen rows), past the buffer or the table's span, sentinel
  table entries, and a padded prefill window whose dropped entries would
  overwrite the kept write at position 0 under a naive clamp.
- ``paged_write_back`` against ``tony_tpu.serve.slots.paged_write_back``.
- The junk page: a pool has one page more than it counts, no table,
  slot, store entry or count ever names it, and dropped writes land
  only there.

Tolerance: none (bit-equal); the port's pools are compared without
their junk page, whose bytes the JAX pools have no counterpart for.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import build_pair, tokens
from tony_tpu.models.transformer import Attention as JaxAttention
from tony_tpu.serve.slots import paged_write_back as jax_write_back
from tony_tpu_torch.models.transformer import write_plan
from tony_tpu_torch.serve import Request, Server
from tony_tpu_torch.serve.slots import (PagePool, paged_cache,
                                        paged_write_back)

MAX_LEN, D, KVH, DH = 64, 48, 6, 8
N_PAGES, PS = 10, 4


@pytest.fixture(scope="module", params=[False, True], ids=["float", "int8"])
def blocks(request):
    """Block 0's attention of each package, MHA (so K/V are d_model
    wide), learned positions (no rotation inside attention), K and V
    projections the identity."""
    jm, jp, tm = build_pair(0, n_kv_heads=KVH, positional="learned",
                            qkv_bias=False, kv_cache_quant=request.param)
    eye = np.eye(D, dtype=np.float32)
    params = dict(jp["block_0"]["attn"])
    params["k"] = {"kernel": jnp.asarray(eye.reshape(D, KVH, DH))}
    params["v"] = {"kernel": jnp.asarray(eye.reshape(D, KVH, DH))}
    attn = tm.blocks[0].attn
    with torch.no_grad():
        attn.k.weight.copy_(torch.eye(D))
        attn.v.weight.copy_(torch.eye(D))
    return JaxAttention(jm.cfg), params, attn, request.param


def _start_cache(rng, quant: bool, rows: int, junk: bool):
    """A cache layer of random bytes: ``rows`` x PS pool pages (one more
    for the port's junk page) or ``rows`` x MAX_LEN per-slot rows."""
    lead = (rows + 1 if junk else rows, PS) if junk is not None \
        else (rows, MAX_LEN)
    leaves = {}
    for name in ("cached_key", "cached_value"):
        if quant:
            leaves[name] = rng.integers(-127, 128, (*lead, KVH, DH),
                                        dtype=np.int8)
        else:
            leaves[name] = rng.standard_normal(
                (*lead, KVH, DH)).astype(np.float32)
    if quant:
        for name in ("cached_key_scale", "cached_value_scale"):
            leaves[name] = rng.random((*lead, KVH)).astype(np.float32)
    return leaves


def _write_both(blocks, x, pos, table=None):
    """Run one decode window through both blocks from the same cache;
    returns (jax cache, port cache) as numpy, the port's pool without
    its junk page."""
    jattn, params, attn, quant = blocks
    rng = np.random.default_rng(7)
    paged = table is not None
    port = _start_cache(rng, quant, N_PAGES if paged else x.shape[0],
                        True if paged else None)
    jax_start = {k: v[:N_PAGES] if paged else v for k, v in port.items()}
    jcache = {k: jnp.asarray(v) for k, v in jax_start.items()}
    jcache["cache_index"] = jnp.asarray(0, jnp.int32)
    kw = {} if table is None else {"page_table": jnp.asarray(table)}
    _, v = jattn.apply({"params": params, "cache": jcache}, jnp.asarray(x),
                       decode=True, positions=jnp.asarray(pos),
                       mutable=["cache"], **kw)
    want = {k: np.asarray(a) for k, a in v["cache"].items()
            if k != "cache_index"}
    layer = {k: torch.as_tensor(a.copy()) for k, a in port.items()}
    layer["cache_index"] = 0
    tpos = torch.as_tensor(pos)
    pos2d = tpos[:, None] if tpos.dim() == 1 else tpos
    if paged:
        plan = write_plan(pos2d, torch.as_tensor(table), N_PAGES, PS)
    else:
        plan = write_plan(pos2d, buf_len=MAX_LEN)
    with torch.no_grad():
        attn(torch.as_tensor(x), decode=True, positions=tpos,
             page_table=None if table is None else torch.as_tensor(table),
             cache=layer, plan=plan)
    got = {k: t.numpy()[:N_PAGES] if paged else t.numpy()
           for k, t in layer.items() if k != "cache_index"}
    return want, got


def _assert_same(want, got):
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _x(b, l, seed=3):
    return np.random.default_rng(seed).standard_normal(
        (b, l, D)).astype(np.float32)


PER_SLOT_WINDOWS = {
    # a kept write at 0 followed by padding: a naive clamp of the padding
    # to position 0 would overwrite it
    "padded_at_zero": [[0, -1, -1, -1], [5, 6, -1, -1]],
    "past_buffer": [[61, 62, 63, 64], [63, 70, 200, -5]],
    "no_kept_entry": [[-1, -1, -1, -1], [-3, 64, 65, -1]],
    "mixed": [[0, 1, 2, 3], [-1, 9, -1, 10]],
}


@pytest.mark.parametrize("case", sorted(PER_SLOT_WINDOWS))
def test_per_slot_window_writes_match_jax(blocks, case):
    pos = np.asarray(PER_SLOT_WINDOWS[case], np.int32)
    want, got = _write_both(blocks, _x(*pos.shape), pos)
    _assert_same(want, got)


@pytest.mark.parametrize("pos", [[3, -1, 64, 0], [-1, -1, -1, -1],
                                 [63, 0, 1, 2]],
                         ids=["frozen_and_past", "all_frozen", "edges"])
def test_per_slot_step_writes_match_jax(blocks, pos):
    pos = np.asarray(pos, np.int32)
    want, got = _write_both(blocks, _x(len(pos), 1), pos)
    _assert_same(want, got)


S = N_PAGES  # the sentinel: an unallocated table entry
TABLE = np.asarray([[3, 1, 7, S], [0, 5, S, S], [S, S, S, S]], np.int32)
PAGED_WINDOWS = {
    # a padded prefill: dropped entries would land on page 3 offset 0
    # (row 0's kept position 0) under a naive clamp
    "padded_prefill": [[0, 1, 2, -1, -1, -1], [4, 5, -1, -1, -1, -1],
                       [-1, -1, -1, -1, -1, -1]],
    # positions past the span (16), on a sentinel column, negative
    "past_span_and_sentinel": [[10, 11, 12, 16, 17, -2],
                               [6, 7, 8, 9, 30, -1],
                               [0, 1, 2, 3, 4, 5]],
}


@pytest.mark.parametrize("case", sorted(PAGED_WINDOWS))
def test_paged_window_writes_match_jax(blocks, case):
    pos = np.asarray(PAGED_WINDOWS[case], np.int32)
    want, got = _write_both(blocks, _x(*pos.shape), pos, TABLE)
    _assert_same(want, got)


@pytest.mark.parametrize("pos", [[5, 7, 0], [15, -1, 3], [12, 8, -1]],
                         ids=["live", "frozen_and_sentinel", "sentinel"])
def test_paged_step_writes_match_jax(blocks, pos):
    pos = np.asarray(pos, np.int32)
    want, got = _write_both(blocks, _x(len(pos), 1), pos, TABLE)
    _assert_same(want, got)


def test_plans_never_let_a_dropped_entry_change_a_kept_address():
    """Over random windows: a paged plan sends every dropped entry, and
    only those, to the junk page; in a per-slot plan every entry that
    shares an address with a kept entry writes that entry's token, and
    a row that keeps its old value has no kept entry at all (a
    one-token window has no ``src``: each entry writes its own token)."""
    rng = np.random.default_rng(0)
    for _ in range(200):
        b, l = rng.integers(1, 5), rng.integers(1, 7)
        pos = torch.as_tensor(rng.integers(-3, 24, (b, l)))
        table = torch.as_tensor(rng.integers(0, N_PAGES + 2, (b, 5)))
        plan = write_plan(pos, table, N_PAGES, PS)
        valid = (pos >= 0) & (pos < 5 * PS)
        page = torch.gather(table, 1, torch.where(valid, pos, 0) // PS)
        valid &= page < N_PAGES
        assert torch.equal(plan.page == N_PAGES, ~valid)
        assert torch.equal(plan.page[valid], page[valid])
        plan = write_plan(pos, buf_len=20)
        valid = (pos >= 0) & (pos < 20)
        for i in range(b):
            assert bool(plan.keep[i, 0]) == (not bool(valid[i].any()))
            if plan.keep[i, 0]:
                continue
            kept = {int(pos[i, j]): j for j in range(l) if valid[i, j]}
            for j in range(l):
                to = int(plan.pos[i, j])
                src = j if plan.src is None else int(plan.src[i, j])
                assert to in kept
                assert int(pos[i, src]) == to and bool(valid[i, src])


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
def test_paged_write_back_matches_jax(quant):
    """A chunk's view written back to the pool: an empty slot, a slot
    whose positions run past the view and the table, sentinel entries,
    and a view shorter than the table's span."""
    rng = np.random.default_rng(11)
    b, n_steps, span = 4, 5, 14
    pool = _start_cache(rng, quant, N_PAGES, True)
    view = {k: rng.standard_normal((b, span, *v.shape[2:])).astype(
        v.dtype) if v.dtype != np.int8 else rng.integers(
            -127, 128, (b, span, *v.shape[2:]), dtype=np.int8)
        for k, v in pool.items()}
    table = np.asarray([[3, 1, 7, S], [0, 5, 2, 4], [S, S, S, S],
                        [9, 8, S, 6]], np.int64)
    start = np.asarray([-1, 11, 2, 6], np.int64)
    want = jax_write_back(
        {k: jnp.asarray(v[:N_PAGES]) for k, v in pool.items()},
        {k: jnp.asarray(v) for k, v in view.items()}, jnp.asarray(table),
        jnp.asarray(start), n_steps, MAX_LEN)
    port = {"block_0": {k: torch.as_tensor(v.copy())
                        for k, v in pool.items()}}
    paged_write_back(port, {"block_0": {k: torch.as_tensor(v) for k, v in
                                        view.items()}},
                     torch.as_tensor(table), torch.as_tensor(start),
                     n_steps, MAX_LEN)
    for k in pool:
        np.testing.assert_array_equal(port["block_0"][k].numpy()[:N_PAGES],
                                      np.asarray(want[k]), err_msg=k)


def test_junk_page_is_never_counted_or_handed_out():
    """The pool holds n_pages + 1 pages; through a served request mix
    with prefix hits, the allocator, the stats, slot tables and the
    prefix store only ever name the first n_pages."""
    _, _, tm = build_pair(9, decode_attention="flash")
    srv = Server(tm, batch_size=2, eos_id=(9, 33), chunk_steps=4,
                 min_bucket=8, kv_page_size=4, kv_pages=24,
                 prefix_cache_mb=4.0, device="cpu")
    pool = srv.slots.pool
    leaf = srv.slots.cache["block_0"]["cached_key"]
    assert leaf.shape[0] == pool.n_pages + 1 == 25
    assert pool.stats()["total"] == 24
    assert pool.page_nbytes == PagePool(tm, 3, 4).page_nbytes
    seen = set()
    pre = tokens(1, 9).tolist()
    for i, n in enumerate((3, 12, 5, 7)):
        srv.submit(Request(pre + tokens(2 + i, n).tolist(), 6, id=i))
    while not srv.done:
        for slot in range(srv.slots.batch_size):
            if srv.slots.active[slot]:
                n = int(srv.slots.n_slot_pages[slot])
                seen.update(srv.slots.slot_pages(slot, n * pool.page_size))
                row = srv.slots.page_table[slot]
                assert np.all((row < pool.n_pages) | (row == pool.n_pages))
        srv.step()
        st = pool.stats()
        assert st["used"] + st["free"] == 24
        assert st["bytes_resident"] == st["used"] * pool.page_nbytes
    assert seen and max(seen) < pool.n_pages
    entries = srv.prefix.stats()["entries"]
    assert entries > 0
    stored = [p for e in srv.prefix._entries.values() for p in e.pages]
    assert stored and max(stored) < pool.n_pages
    assert max(srv.prefix._page_refs) < pool.n_pages
    assert len(pool._free) + int((pool.refcount > 0).sum()) == 24


def test_paged_cache_adds_one_junk_page():
    _, _, tm = build_pair(0)
    pool = paged_cache(tm, N_PAGES, PS)
    assert pool["block_0"]["cached_key"].shape[0] == N_PAGES + 1
