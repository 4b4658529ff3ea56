"""Live session migration in the port (``serve/migrate.py``,
``Server.extract_session``, ``Gateway.migrate_session`` /
``remove_replica``) against the JAX package, on the same weights
(``build_pair``), the same requests and explicit EOS ids:

- two replicas on one shared page pool: a greedy and a seeded sampled
  stream frozen mid-stream move by owner swap (no page copied), their
  tokens equal to the JAX gateway's and to a run without migration, the
  migration counters equal to the JAX gateway's, the pool back to empty;
  the same through ``remove_replica`` and with speculation live;
- at the engine: the wire snapshot of a sampled session at the same
  token carries the JAX snapshot's key words, its doc round-trips, and
  the adopted stream equals the JAX adoption's;
- delta migration, f32 and int8 KV pages: exact, partial and no prefix
  cover, and a stale summary refused with ``StaleDelta`` and re-shipped
  full.

The mid-stream window is made by ``torch_parity.Gate`` (a server's
stepping held at a step boundary until the test releases it), so no
test depends on a sleep or the machine's speed.
"""

import threading

import pytest

from torch_parity import Gate, build_pair, tokens, wait_for
from tony_tpu.gateway import Gateway as JaxGateway
from tony_tpu.gateway import GenRequest as JaxGenRequest
from tony_tpu.serve import Request as JaxRequest
from tony_tpu.serve import Server as JaxServer
from tony_tpu.serve.migrate import StaleDelta as JaxStaleDelta
from tony_tpu.serve.migrate import delta_trim_doc as jax_delta_trim_doc
from tony_tpu.serve.tier import trim_payload as jax_trim_payload
from tony_tpu.serve.migrate import snapshot_to_doc as jax_snapshot_to_doc
from tony_tpu.serve.slots import PagePool as JaxPagePool
from tony_tpu_torch.gateway import Gateway, GenRequest
from tony_tpu_torch.serve import PagePool, Request, Server
from tony_tpu_torch.serve.migrate import (StaleDelta, delta_trim_doc,
                                          snapshot_from_doc,
                                          snapshot_to_doc)
from tony_tpu_torch.serve.tier import payload_nbytes

EOS = (38, 61)
PS = 8
KW = dict(batch_size=2, paged=True, kv_page_size=PS, min_bucket=8,
          chunk_steps=1, eos_id=EOS, prefix_cache_mb=0.0)
PROMPT = tokens(76, 13).tolist()  # 40 tokens, no eos id, both ways
BUDGET = 40
SAMPLED = dict(temperature=0.8, top_k=8, seed=7)
MIG_KEYS = ("out", "in", "local", "remote", "pages_moved",
            "bytes_avoided", "bytes_wire", "delta_in")


@pytest.fixture(scope="module")
def models():
    return build_pair(9)


@pytest.fixture(scope="module")
def int8_models():
    return build_pair(9, kv_cache_quant=True)


def _pkg(models, jax: bool) -> dict:
    jm, jp, tm = models
    if jax:
        return dict(server=lambda **kw: JaxServer(jm, jp, **{**KW, **kw}),
                    pool=lambda n: JaxPagePool(jm, jp, n, PS, shared=True),
                    gateway=JaxGateway, req=JaxGenRequest,
                    request=JaxRequest, stale=JaxStaleDelta,
                    to_doc=jax_snapshot_to_doc, trim=jax_delta_trim_doc)
    return dict(server=lambda **kw: Server(tm, device="cpu",
                                           **{**KW, **kw}),
                pool=lambda n: PagePool(tm, n, PS, shared=True),
                gateway=Gateway, req=GenRequest, request=Request,
                stale=StaleDelta, to_doc=snapshot_to_doc,
                trim=delta_trim_doc)


def _control(pkg, prompt, budget, knobs: dict, **kw) -> list:
    srv = pkg["server"](**kw)
    return list(srv.run([pkg["request"](list(prompt), budget, id="c",
                                        **knobs)]))[0].tokens


def _gateway_move(pkg, knobs: dict, *, retire: bool = False,
                  prompt=PROMPT, **kw):
    """Two replicas on one shared pool; the stream is frozen after 3
    tokens on whichever replica holds it and moves to the other (by
    ``migrate_session``, or by retiring its replica)."""
    pool = pkg["pool"](64)
    servers = [pkg["server"](page_pool=pool, **kw) for _ in range(2)]
    gates = [Gate(s, 3) for s in servers]
    gw = pkg["gateway"](servers, stall_timeout_s=300.0).start()
    try:
        t = gw.submit(pkg["req"](list(prompt), BUDGET, id="mig", **knobs))
        wait_for(lambda: any(g.held.is_set() for g in gates),
                 what="the stream held mid-flight")
        src = t.replica
        if retire:
            done = threading.Thread(target=gw.remove_replica, args=(src,),
                                    kwargs={"timeout": 120})
            done.start()
            wait_for(lambda: gw.replicas[src].retiring,
                     what="the replica retiring")
        else:
            assert gw.migrate_session("mig") is True
        for g in gates:
            g.open()
        res = t.result(timeout=300)
        if retire:
            done.join(120)
        snap = gw.snapshot()
        mig = {k: snap["engine"]["migrations"][k] for k in MIG_KEYS}
        spec_rounds = snap["engine"]["spec"]["rounds"]
        assert snap["shed"] == {}
        assert t.replica != src and t.replica is not None
    finally:
        for g in gates:
            g.open()
        assert gw.drain(timeout=120)
    assert pool.n_used == 0 and pool.reserved == 0
    assert (pool.refcount >= 0).all()
    return (list(res.tokens), res.finish_reason), mig, spec_rounds


@pytest.mark.parametrize("knobs", [{}, SAMPLED], ids=["greedy", "sampled"])
def test_owner_swap_migration_matches_jax(models, knobs):
    port = _pkg(models, False)
    got = _gateway_move(port, knobs)
    assert got == _gateway_move(_pkg(models, True), knobs)
    (toks, _), mig, _ = got
    assert toks == _control(port, PROMPT, BUDGET, knobs)
    assert len(toks) > 3  # the move happened mid-stream
    # an owner swap: both ends local, no page content moved
    assert mig["out"] == mig["in"] == 1 and mig["local"] == 2
    assert mig["remote"] == mig["pages_moved"] == 0
    assert mig["bytes_avoided"] > 0


def test_remove_replica_migrates_mid_stream(models):
    """Retiring the replica that holds a live stream moves the stream to
    the survivor: the same tokens as the JAX gateway's and as no move."""
    port = _pkg(models, False)
    got = _gateway_move(port, SAMPLED, retire=True)
    want = _gateway_move(_pkg(models, True), SAMPLED, retire=True)
    assert got[0] == want[0]
    assert got[0][0] == _control(port, PROMPT, BUDGET, SAMPLED)
    assert got[1]["out"] == got[1]["in"] == want[1]["in"] == 1


def test_migration_with_speculation_live(models):
    """A greedy stream that drafts keeps drafting on the adopter (the
    acceptance EMA travels): tokens and counters as the JAX gateway's."""
    prompt = [5, 6, 7] * 4 + [5, 6]
    port = _pkg(models, False)
    got = _gateway_move(port, {}, prompt=prompt, speculate_k=2)
    assert got == _gateway_move(_pkg(models, True), {}, prompt=prompt,
                                speculate_k=2)
    assert got[0][0] == _control(port, prompt, BUDGET, {}, speculate_k=2)
    assert got[2] >= 1


def _freeze(pkg, knobs, min_gen=5, prompt=PROMPT, budget=BUDGET, **kw):
    """A stream on one engine until it has ``min_gen`` tokens, then its
    wire snapshot."""
    srv = pkg["server"](**kw)
    srv.submit(pkg["request"](list(prompt), budget, id="src", **knobs))
    while not any(len(t) >= min_gen
                  for t in srv.live_progress().values()):
        assert not srv.done, "the stream ended before the freeze"
        srv.step()
    assert srv.extract_session("pending?", wire=True) is None
    snap = srv.extract_session("src", wire=True)
    assert snap is not None and srv.done
    assert srv.counters()["kv_pages_reserved"] == 0
    return snap


@pytest.mark.parametrize("knobs", [{}, SAMPLED], ids=["greedy", "sampled"])
def test_wire_snapshot_matches_jax(models, knobs):
    """Frozen at the same token, the port's snapshot carries the JAX
    snapshot's fields, its key words among them (a sampled slot's key
    advanced by its draws); through its wire doc it adopts on a second
    engine, and the stream goes on as the JAX adoption's and as a run
    never migrated."""
    port, jax = _pkg(models, False), _pkg(models, True)
    snap, jsnap = _freeze(port, knobs), _freeze(jax, knobs)
    fields = ("prompt", "generated", "max_new_tokens", "temperature",
              "top_k", "seed", "spec_ema", "n_tokens", "local",
              "page_size")
    assert {f: getattr(snap, f) for f in fields} \
        == {f: getattr(jsnap, f) for f in fields}
    assert snap.rng.tolist() == jsnap.rng.tolist()
    doc = snapshot_to_doc(snap)
    back = snapshot_from_doc(doc)
    assert back.rng.tolist() == snap.rng.tolist()
    assert back.generated == snap.generated
    jdoc = jax_snapshot_to_doc(jsnap)
    # the same page bytes: the port ships the session's pages only, the
    # JAX doc its power-of-two gather bucket (cut here to the real
    # pages) and each layer's int32 cache counter
    n = -(-snap.n_tokens // PS)
    assert payload_nbytes(doc["pages"]) == payload_nbytes(
        jax_trim_payload(jdoc["pages"], 0, n)) \
        - 4 * sum("page_axis" not in d for d in jdoc["pages"]["leaves"])
    outs = []
    for pkg, adopt in ((port, doc), (jax, jdoc)):
        tgt = pkg["server"]()
        tgt.submit(pkg["request"](list(PROMPT), BUDGET, id="a",
                                  migrate=adopt, **knobs))
        res = list(tgt.run())[0]
        c = tgt.counters()
        outs.append((res.tokens, res.finish_reason, c["migrations_in"],
                     c["migrations_remote"], c["migrate_pages_moved"],
                     c["migrate_bytes_wire"]))
    assert outs[0] == outs[1]
    assert outs[0][0] == _control(port, PROMPT, BUDGET, knobs)


def test_local_snapshots_need_a_shared_pool(models):
    """An owner-swap extract needs a shared pool, and a page-id
    snapshot is refused by an engine of another pool, in both
    packages; adopted in the same pool it moves no page."""
    for pkg in (_pkg(models, True), _pkg(models, False)):
        with pytest.raises(ValueError, match="shared pool"):
            src = pkg["server"]()
            src.submit(pkg["request"](list(PROMPT), 8, id="x"))
            src.step()
            src.extract_session("x", wire=False)
        pool = pkg["pool"](32)
        src = pkg["server"](page_pool=pool)
        src.submit(pkg["request"](list(PROMPT), 8, id="x"))
        src.step()
        snap = src.extract_session("x", wire=False)
        assert snap.local and snap.pool is pool
        with pytest.raises(ValueError, match="does not share"):
            pkg["server"]().submit(pkg["request"](
                list(PROMPT), 8, id="x", migrate=snap))
        tgt = pkg["server"](page_pool=pool)
        tgt.submit(pkg["request"](list(PROMPT), 8, id="x", migrate=snap))
        list(tgt.run())
        assert tgt.counters()["migrate_pages_moved"] == 0
        assert pool.n_used == 0


def _warm(srv, pkg, toks):
    """``toks``' KV into ``srv``'s prefix store (a run and donation)."""
    list(srv.run([pkg["request"](list(toks), 1, id=f"w{len(toks)}")]))


def _delta_cell(pkg, scenario):
    prompt, budget = tokens(71, 21).tolist(), 12
    snap = _freeze(pkg, {}, min_gen=4, prompt=prompt, budget=budget)
    doc = pkg["to_doc"](snap)
    ctx = list(snap.prompt) + list(snap.generated)[:-1]
    tgt = pkg["server"](prefix_cache_mb=2.0)
    if scenario == "exact":
        _warm(tgt, pkg, ctx)
    elif scenario == "partial":
        _warm(tgt, pkg, ctx[:2 * PS])
    summary = tgt.prefix_summary()
    if scenario == "stale":
        # an honest summary of ANOTHER warm engine: coverage the target
        # does not hold
        helper = pkg["server"](prefix_cache_mb=2.0)
        _warm(helper, pkg, ctx)
        summary = helper.prefix_summary()
    trimmed = pkg["trim"](doc, summary)
    send = trimmed if trimmed is not None else doc
    shipped = [d["shape"][0] for d in send["pages"]["leaves"]
               if "page_axis" in d][0]
    refused = False
    if scenario == "stale":
        with pytest.raises(pkg["stale"]):
            tgt.submit(pkg["request"](list(prompt), budget, id="a",
                                      migrate=send))
        assert not tgt._migrate_pins  # the refusal released its pin
        refused, send = True, doc     # the sender's re-ship
    tgt.submit(pkg["request"](list(prompt), budget, id="a", migrate=send))
    res = {r.id: r for r in tgt.run()}["a"]
    assert not tgt._migrate_pins
    c = tgt.counters()
    return (res.tokens, (trimmed or {}).get("delta"), shipped, refused,
            c["migrate_delta_in"], c["migrate_bytes_wire"],
            c["migrations_in"], c["migrations_remote"],
            -(-snap.n_tokens // PS))


@pytest.mark.parametrize("kv", ["f32kv", "int8kv"])
@pytest.mark.parametrize("scenario", ["exact", "partial", "nomatch",
                                      "stale"])
def test_delta_migration_matrix(models, int8_models, kv, scenario):
    """Delta migration cell by cell, as the JAX package does it: the
    trim ships only the pages the target's summary does not cover (the
    last page always ships), the adopter shares its own store pages for
    the rest, a stale summary is refused at submit and the full doc
    re-ships; every stream equals the one never migrated."""
    pair = models if kv == "f32kv" else int8_models
    port = _pkg(pair, False)
    got = _delta_cell(port, scenario)
    want = _delta_cell(_pkg(pair, True), scenario)
    # what ships may differ: the port's full doc holds the session's
    # pages, the JAX one its power-of-two gather bucket
    assert got[:2] + got[3:] == want[:2] + want[3:]
    assert got[0] == _control(port, tokens(71, 21).tolist(), 12, {})
    delta, shipped, n = got[1], got[2], got[8]
    k = delta["prefix_tokens"] // PS if delta else 0
    assert shipped == n - k <= want[2]
    if scenario == "exact":
        assert delta is not None and shipped == 1 and got[4] == 1
    elif scenario == "partial":
        assert delta == {"prefix_tokens": 2 * PS} and got[4] == 1
    else:
        assert got[4] == 0
    assert got[6:8] == (1, 1)
