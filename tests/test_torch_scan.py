"""``scan_layers`` in the port against the JAX package's scanned model
(``_scan_blocks``: every block leaf stacked under ``layers/block/`` with
a leading ``[n_layers]`` axis, and a cache stacked the same way), on the
same weights (``torch_parity.build_pair(scan_layers=True)``):

- the forward, ``return_hidden``, the cache shapes and the decode forms
  (scalar index, per-slot ``[b]`` and ``[b, l]``, paged, float and int8
  KV, einsum and flash) at ``test_torch_model.py``'s tolerance;
- gradients under the three remat policies, and a few ``Trainer``
  steps with accumulation 1 and 2, at ``test_torch_train.py``'s;
- the port's scanned model against its unscanned one with the weights
  stacked (``convert.stack_layers``): logits, gradients and training
  steps bit-equal on the CPU;
- ``convert`` both ways on a scanned tree and train state, strict;
- greedy ``generate`` and ``beam_search`` token for token;
- ``fit`` with a checkpoint resumed, and LoRA over a scanned tree with
  the reference's shapes.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_model as model_tests
import test_torch_train as train_tests
from torch_parity import QWEN_TINY, build_pair, tokens
from tony_tpu.models.generate import beam_search as jax_beam_search
from tony_tpu.models.generate import generate as jax_generate
from tony_tpu.models.generate import init_cache as jax_init_cache
from tony_tpu.serve.slots import paged_cache as jax_paged_cache
from tony_tpu.train.lora import lora_init as jax_lora_init
from tony_tpu_torch.models.convert import (from_jax_params,
                                           from_jax_train_state,
                                           stack_layers, to_jax_params,
                                           unstack_layers)
from tony_tpu_torch.models.generate import beam_search, generate, init_cache
from tony_tpu_torch.models.transformer import Transformer, TransformerConfig
from tony_tpu_torch.ops.adamw import FusedAdamW
from tony_tpu_torch.serve.slots import paged_cache
from tony_tpu_torch.train import Trainer, fit
from tony_tpu_torch.train.lora import lora_init, wrap_apply_fn

ATOL = model_tests.ATOL  # fp32 logits, reordered sums over 2 layers
N = QWEN_TINY["n_layers"]


def _scan_pair(seed=0, **kw):
    return build_pair(seed, scan_layers=True, **kw)


def _unscanned_twin(tm):
    """The port's unscanned model on ``tm``'s weights, unstacked."""
    cfg = dataclasses.replace(tm.cfg, scan_layers=False)
    twin = Transformer(cfg, device="cpu")
    twin.load_state_dict(unstack_layers(tm.state_dict()))
    return twin


def test_stacked_parameters_and_cache_shapes_match_jax():
    jm, jp, tm = _scan_pair()
    sd = tm.state_dict()
    assert not any(k.startswith("blocks.") for k in sd)
    cfg = tm.cfg
    assert sd["layers.block.attn.q.weight"].shape == \
        (N, cfg.n_heads * cfg.head_dim, cfg.d_model)
    assert jp["layers"]["block"]["attn"]["q"]["kernel"].shape == \
        (N, cfg.d_model, cfg.n_heads, cfg.head_dim)
    for quant in (False, True):
        jm_q, jp_q, tm_q = _scan_pair(kv_cache_quant=quant)
        jc = jax_init_cache(jm_q, jp_q, 3)["layers"]["block"]["attn"]
        tc = init_cache(tm_q, 3)["layers"]
        for name in jc:
            if name == "cache_index":
                continue
            assert tuple(tc[name].shape) == jc[name].shape, name
            assert str(tc[name].dtype).removeprefix("torch.") \
                == str(jc[name].dtype), name
        jpool = jax_paged_cache(jm_q, jp_q, 5, 4)["layers"]["block"]["attn"]
        pool = paged_cache(tm_q, 5, 4)["layers"]
        for name in pool:
            if name != "cache_index":
                # the port's pool has one page more: the junk page
                want = list(jpool[name].shape)
                want[1] += 1
                assert list(pool[name].shape) == want, name


@pytest.mark.parametrize("hidden", [False, True])
def test_forward_matches_jax(hidden):
    jm, jp, tm = _scan_pair()
    toks = tokens(1, (2, 20))
    want = np.asarray(jm.apply({"params": jp}, jnp.asarray(toks),
                               return_hidden=hidden))
    with torch.no_grad():
        got = tm(torch.as_tensor(toks), return_hidden=hidden).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("mode", ["scalar", "per_slot", "paged"])
@pytest.mark.parametrize("attn", ["einsum", "flash"])
@pytest.mark.parametrize("kv_int8", [False, True])
def test_cached_decode_matches_jax(mode, attn, kv_int8):
    """Prefill + 6 teacher-forced steps through each cache mode over the
    stacked cache (test_torch_model's helpers; seed 1 as there)."""
    jm, jp, tm = _scan_pair(1, decode_attention=attn,
                            kv_cache_quant=kv_int8)
    want = model_tests._run_jax(jm, jp, mode)
    got = model_tests._run_torch(tm, mode)
    live = [0, 1, 2] if mode == "scalar" else [0, 1]
    for step, (w, g) in enumerate(zip(want, got)):
        np.testing.assert_allclose(g[live], w[live], atol=ATOL, rtol=0,
                                   err_msg=f"step {step}")


def test_multi_token_window_matches_jax():
    """A [b, l] per-slot window (the verify form) after a prefill, over
    the stacked cache: every live position's logits."""
    from tony_tpu.models.generate import multi_decode_step as jax_multi
    from tony_tpu_torch.models.generate import multi_decode_step

    jm, jp, tm = _scan_pair(2)
    b, width = 3, 6
    toks, pos = model_tests._prefill_window((5, 3, 0), width)
    jc = jax_init_cache(jm, jp, b)
    jc, _ = jax_multi(jm, jp, jc, jnp.asarray(toks), jnp.asarray(pos))
    tc = init_cache(tm, b)
    tc, _ = multi_decode_step(tm, tc, torch.as_tensor(toks),
                              torch.as_tensor(pos))
    win = tokens(9, (b, 4))
    wpos = np.asarray([[5, 6, 7, -1], [3, 4, -1, -1], [-1] * 4])
    _, want = jax_multi(jm, jp, jc, jnp.asarray(win), jnp.asarray(wpos))
    _, got = multi_decode_step(tm, tc, torch.as_tensor(win),
                               torch.as_tensor(wpos))
    live = wpos >= 0
    np.testing.assert_allclose(got.numpy()[live], np.asarray(want)[live],
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("kv_int8", [False, True])
@pytest.mark.parametrize("mode", ["scalar", "per_slot", "paged"])
def test_scanned_decode_bit_equal_to_unscanned(mode, kv_int8):
    """The same forward a layer over slices: the scanned model's cached
    logits equal the unscanned model's, bit for bit."""
    _, _, tm = _scan_pair(1, decode_attention="flash",
                          kv_cache_quant=kv_int8)
    twin = _unscanned_twin(tm)
    for a, b in zip(model_tests._run_torch(tm, mode),
                    model_tests._run_torch(twin, mode)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("backend", ["reference", "blockwise", "pallas"])
@pytest.mark.parametrize("policy", [None, "nothing", "dots", "attn_saved"])
def test_logits_and_grads_bit_equal_to_unscanned(backend, policy):
    """Scanned against unscanned with the weights stacked, under every
    remat policy (None = remat off): the same logits, and gradients that
    stack to the same bits."""
    remat = dict(remat=policy is not None, remat_policy=policy or "nothing")
    _, _, tm = _scan_pair(attention_backend=backend,
                          attention_block_size=8, **remat)
    twin = _unscanned_twin(tm)
    toks = torch.as_tensor(tokens(3, (2, 20)))
    out = {}
    for name, m in (("scan", tm), ("flat", twin)):
        logits = m(toks)
        grads = torch.autograd.grad((logits ** 2).mean(),
                                    list(m.parameters()))
        out[name] = (logits, dict(zip([n for n, _ in m.named_parameters()],
                                      grads)))
    assert torch.equal(out["scan"][0], out["flat"][0])
    flat = stack_layers(out["flat"][1], N)
    for name, g in out["scan"][1].items():
        assert torch.equal(g, flat[name]), name


@pytest.mark.parametrize("policy", ["nothing", "dots", "attn_saved"])
def test_remat_gradients_match_jax(policy):
    """Gradients of the mean squared logits under remat (the JAX package
    remats the scan body, attn_saved inside the block) against the JAX
    scanned model's, at the fp32 training tolerance."""
    jm, jp, tm = _scan_pair(attention_backend="pallas",
                            attention_block_size=8, remat=True,
                            remat_policy=policy)
    toks = tokens(4, (2, 16))

    def loss(p):
        out = jm.apply({"params": p}, jnp.asarray(toks))
        return jnp.mean(out.astype(jnp.float32) ** 2)

    want = from_jax_params(jax.tree.map(np.asarray, jax.grad(loss)(jp)),
                           tm.cfg)
    got = torch.autograd.grad((tm(torch.as_tensor(toks)) ** 2).mean(),
                              list(tm.parameters()))
    for (name, _), g in zip(tm.named_parameters(), got):
        np.testing.assert_allclose(g.numpy(), want[name].numpy(),
                                   atol=2e-5, rtol=0, err_msg=name)


def _stacked_train_pair():
    """test_torch_train's pair (the unscanned seed-0 draw its tolerances
    were set on) with its weights stacked into both packages' scanned
    models. The scanned draw of the same seed is held apart, under its
    own bound (``test_trainer_matches_jax_on_the_scanned_draw``)."""
    jm, _, tm = train_tests._pair(scan_layers=True)
    _, _, flat = train_tests._pair()
    tm.load_state_dict(stack_layers(flat.state_dict(), N))
    jparams = jax.tree.map(jnp.asarray,
                           to_jax_params(tm.state_dict(), tm.cfg)["params"])
    return jm, jparams, tm


@pytest.mark.parametrize("accum", [1, 2])
def test_trainer_matches_jax(accum):
    """Three FusedAdamW steps of the scanned model in both packages
    (test_torch_train's helpers, weights and tolerances), then the same
    steps of the unscanned model on the stacked weights: losses and
    masters bit-equal."""
    jm, jparams, tm = _stacked_train_pair()
    batches = train_tests._batches(3)
    jstate, jl = train_tests._run_jax(
        train_tests._jax_trainer(jm, accum=accum), jparams, batches)
    twin = _unscanned_twin(tm)
    tr = Trainer(tm, train_tests._apply(None), FusedAdamW(train_tests.LR),
                 accum_steps=accum)
    tstate, tl = train_tests._run_torch(tr, batches, tr.init_state())
    np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-5)
    train_tests._close_params(jstate.params, tstate.params, tm.cfg, 2e-5)
    tr2 = Trainer(twin, train_tests._apply(None),
                  FusedAdamW(train_tests.LR), accum_steps=accum)
    fstate, fl = train_tests._run_torch(tr2, batches, tr2.init_state())
    assert fl == tl
    stacked = stack_layers(fstate.params, N)
    for name, p in tstate.params.items():
        assert torch.equal(p, stacked[name]), name


@pytest.mark.parametrize("accum", [1, 2])
def test_trainer_matches_jax_on_the_scanned_draw(accum):
    """``build_pair(0, scan_layers=True)``'s own draw (ROADMAP.md section
    3, item 4): the port's three fp32 steps against the JAX Trainer's.
    The draw gives each stacked kernel a fan-in of n_layers, so its
    weights are several times the unscanned draw's, and the two
    packages' first gradients part by up to 1.6e-5 (against 5.2e-7 on
    the unscanned draw; ``tests/torch_trainer_probe.py``). The port's
    ``_grads`` and update were held line by line against the JAX
    Trainer's and differ in nothing but the order of fp32 sums. AdamW
    turns that into a parameter difference where an element's gradient
    is a cancelled remainder: the largest, 4.8e-5 (accum 1) and 3.9e-5
    (accum 2), sit at one ``attn.q.weight`` element whose first gradient
    is -6.2e-8 in the port and -9.2e-8 in JAX. The probe's +-u nudge of
    every gradient element (u = 2^-24) carries up to 2.9e-5 and 4.3e-5
    into the params over the 3 steps. The bound, 1e-4, is a little over
    twice the largest of the two carries; the losses keep
    ``test_torch_train.py``'s 1e-5."""
    jm, jparams, tm = train_tests._pair(scan_layers=True)
    batches = train_tests._batches(3)
    jstate, jl = train_tests._run_jax(
        train_tests._jax_trainer(jm, accum=accum), jparams, batches)
    tr = Trainer(tm, train_tests._apply(None), FusedAdamW(train_tests.LR),
                 accum_steps=accum)
    tstate, tl = train_tests._run_torch(tr, batches, tr.init_state())
    np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-5)
    train_tests._close_params(jstate.params, tstate.params, tm.cfg, 1e-4)


def test_convert_both_ways_and_strict():
    jm, jp, tm = _scan_pair()
    cfg = tm.cfg
    params = jax.tree.map(np.asarray, jp)
    back = to_jax_params(tm.state_dict(), cfg)["params"]
    flat_want = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_got) == len(flat_want)
    for path, leaf in flat_want:
        np.testing.assert_array_equal(flat_got[path], leaf)
    extra = jax.tree.map(lambda x: x, params)
    extra["layers"]["block"]["attn"]["stray"] = np.zeros((N, 3), np.float32)
    with pytest.raises(ValueError, match="unmapped"):
        from_jax_params(extra, cfg)
    missing = jax.tree.map(lambda x: x, params)
    del missing["layers"]["block"]["ln2"]
    with pytest.raises(ValueError, match="missing"):
        from_jax_params(missing, cfg)
    # an unscanned tree does not load into a scanned config
    _, jp_flat, _ = build_pair(0)
    with pytest.raises(ValueError):
        from_jax_params(jax.tree.map(np.asarray, jp_flat), cfg)


def test_train_state_carries_stacked_leaves():
    """A JAX scanned TrainState after two steps carries across (masters,
    count, moments, compute copy) and both packages continue from it."""
    jm, jparams, tm = train_tests._pair(jnp.bfloat16, torch.bfloat16,
                                        scan_layers=True)
    jtr = train_tests._jax_trainer(jm, cdt=jnp.bfloat16)
    first, rest = train_tests._batches(2), train_tests._batches(4)[2:]
    jstate, _ = train_tests._run_jax(jtr, jparams, first)
    jfinal, jl = train_tests._run_jax(jtr, None, rest, state=jstate)
    tstate0 = from_jax_train_state(jax.tree.map(np.asarray, jstate),
                                   tm.cfg)
    mu = tstate0.opt_state.mu["layers.block.attn.q.weight"]
    assert mu.shape[0] == N and tstate0.step == 2
    tr = Trainer(tm, train_tests._apply(torch.bfloat16),
                 FusedAdamW(train_tests.LR), compute_dtype=torch.bfloat16)
    start = {n: t.clone() for n, t in tstate0.params.items()}
    tfinal, tl = train_tests._run_torch(tr, rest, tstate0)
    np.testing.assert_allclose(tl, jl, rtol=2e-2)
    train_tests._close_updates(jfinal.params, tfinal.params, start, tm.cfg,
                               0.15)


def test_fit_resumes_a_scanned_checkpoint(tmp_path):
    """fit with a checkpoint every 2 steps, resumed to 6, equals 6 steps
    in one run."""
    from tony_tpu_torch.data import ArraySource, DataLoader

    data = tokens(7, (16, train_tests.SEQ))

    def setup():
        _, _, tm = train_tests._pair(scan_layers=True)
        tr = Trainer(tm, train_tests._apply(None),
                     FusedAdamW(train_tests.LR))
        loader = DataLoader(ArraySource({"tokens": data}),
                            global_batch_size=4, seed=1, process_index=0,
                            process_count=1, device="cpu")
        return tr, loader

    ck = str(tmp_path / "ck")
    tr, loader = setup()
    fit(tr, None, loader, total_steps=4, checkpoint_dir=ck,
        checkpoint_every=2, log_every=0)
    tr, loader = setup()
    again = fit(tr, None, loader, total_steps=6, checkpoint_dir=ck,
                log_every=0)
    assert again.resumed_from == 4
    tr, loader = setup()
    whole = fit(tr, None, loader, num_steps=6, log_every=0)
    for name, p in whole.state.params.items():
        assert p.shape == again.state.params[name].shape
        torch.testing.assert_close(again.state.params[name], p, rtol=0,
                                   atol=1e-6)


@pytest.mark.parametrize("attn", ["einsum", "flash"])
def test_generate_and_beam_search_match_jax(attn):
    jm, jp, tm = _scan_pair(decode_attention=attn)
    prompt = tokens(5, (2, 7))
    eos = (7, 11)
    want = np.asarray(jax_generate(jm, jp, jnp.asarray(prompt),
                                   max_new_tokens=12, eos_id=eos))
    np.testing.assert_array_equal(
        generate(tm, prompt, max_new_tokens=12, eos_id=eos).numpy(), want)
    want = np.asarray(jax_beam_search(jm, jp, jnp.asarray(prompt),
                                      max_new_tokens=8, num_beams=3,
                                      eos_id=eos))
    got = beam_search(tm, prompt, max_new_tokens=8, num_beams=3,
                      eos_id=eos).numpy()
    np.testing.assert_array_equal(got, want)


def test_int8_beam_search_reorders_scales():
    """The reference's beam search does not widen the int8 scales of any
    cache (ROADMAP.md section 3); the port reorders every leaf along its
    batch axis, so a scanned int8 model's beams equal the unscanned
    int8 model's on the same weights."""
    _, _, tm = _scan_pair(kv_cache_quant=True)
    prompt = tokens(6, (2, 5))
    got = beam_search(tm, prompt, max_new_tokens=6, num_beams=2).numpy()
    want = beam_search(_unscanned_twin(tm), prompt, max_new_tokens=6,
                       num_beams=2).numpy()
    np.testing.assert_array_equal(got, want)


def test_lora_takes_a_scanned_tree_with_the_reference_shapes():
    """The JAX ``lora_init`` takes a scanned tree: each stacked kernel
    ``[n_layers, in, ...out]`` is factored over its first axis, A
    ``[n_layers, r]`` and B ``[r, in, ...out]``. The port's takes it with
    the same shapes, and a step of the merged view trains them."""
    jm, jp, tm = _scan_pair()
    targets = ("q", "v", "wo")
    want = jax_lora_init(jax.random.PRNGKey(0), {"params": jp}, rank=2,
                         targets=targets)
    want = {"/".join(str(getattr(k, "key", k)) for k in path): leaf.shape
            for path, leaf in jax.tree_util.tree_flatten_with_path(want)[0]}
    lora = lora_init(torch.Generator().manual_seed(0), tm, rank=2,
                     targets=targets)
    got = {n.replace(".", "/"): tuple(p.shape)
           for n, p in lora.named_parameters()}
    assert got == want
    with torch.no_grad():
        for p in lora.parameters():
            p.normal_(0.0, 0.1, generator=torch.Generator().manual_seed(1))
    apply_fn = wrap_apply_fn(train_tests._apply(None), tm, alpha=4.0)
    batch = {"tokens": torch.as_tensor(tokens(8, (2, train_tests.SEQ)))}
    loss = apply_fn(lora, batch)
    # the merged view against an unscanned model on the merged weights
    from tony_tpu_torch.train.lora import materialize_lora

    merged = Transformer(tm.cfg, device="cpu")
    merged.load_state_dict(materialize_lora(tm, lora, alpha=4.0))
    want_loss = train_tests._apply(None)(_unscanned_twin(merged), batch)
    torch.testing.assert_close(loss, want_loss, rtol=0, atol=1e-6)
    grads = torch.autograd.grad(loss, list(lora.parameters()))
    assert all(bool(torch.isfinite(g).all()) for g in grads)


def test_config():
    TransformerConfig(scan_layers=True)
    TransformerConfig(scan_layers=True, remat=True,
                      remat_policy="attn_saved", attention_backend="pallas")
    with pytest.raises(ValueError, match="uniform layers"):
        TransformerConfig(scan_layers=True, moe_every=2)


SERVE_OPTIONS = {
    "chunks": dict(chunk_steps=8),
    "spec_chunked": dict(chunk_steps=2, speculate_k=4,
                         prefill_chunk_tokens=8),
    "int8_unfused": dict(chunk_steps=4, in_dispatch_eos=False),
}


@pytest.mark.parametrize("option", list(SERVE_OPTIONS))
def test_replayed_scanned_server_matches_jax(option):
    """A scanned model through the paged Server with its dispatches
    replayed by the stand-in CUDA-graph backend, with the prefix store
    and each option (chunks with in-dispatch EOS; speculation with
    chunked prefill; int8 KV with in-dispatch EOS off): greedy streams
    equal to the JAX Server's over the scanned model, every chunk and
    prefill a capture or a replay; then the unscanned port model on
    the same weights gives the same streams, sampled rows included."""
    from test_torch_graphs import EOS, SERVE, StandIn, _serve
    from tony_tpu.serve import Request as JaxRequest
    from tony_tpu.serve import Server as JaxServer
    from tony_tpu_torch.models.graphs import GraphCache
    from tony_tpu_torch.serve import Request, Server

    kw = dict(SERVE_OPTIONS[option])
    jm, jp, tm = _scan_pair(9, decode_attention="flash",
                            kv_cache_quant=option.startswith("int8"))
    want = _serve(JaxServer(jm, jp, batch_size=2, eos_id=EOS, paged=True,
                            **SERVE, **kw), JaxRequest)
    temps = [0.0, 0.9, 0.0, 0.0, 0.8, 0.0, 0.0]
    out = {}
    for name, m in (("scan", tm), ("flat", _unscanned_twin(tm))):
        srv = Server(m, batch_size=2, eos_id=EOS, device="cpu", **SERVE,
                     **kw)
        srv.graphs = GraphCache("cpu", StandIn())
        out[name] = (_serve(srv, Request), _serve(
            Server(m, batch_size=2, eos_id=EOS, device="cpu", **SERVE, **kw),
            Request, temps))
        if name == "scan":
            c = srv.counters()
            assert c["graph_decode_eager"] == c["graph_prefill_eager"] == 0
            assert c["graph_decode_replays"] > 0
    assert out["scan"][0] == want
    assert out["scan"] == out["flat"]


@pytest.mark.parametrize("accum", [1, 2])
def test_captured_scanned_step_bit_equal(accum):
    """The scanned training step captured whole (the stand-in backend),
    remat ``attn_saved`` and the pallas backend as phase 22b runs it:
    one capture and three replays, bit-equal to the eager scanned steps
    and to the captured unscanned steps on the stacked weights."""
    from test_torch_graphs import StandIn
    from tony_tpu_torch.models.graphs import GraphCache

    _, _, tm = train_tests._pair(scan_layers=True, remat=True,
                                 remat_policy="attn_saved")
    batches = train_tests._batches(4)
    twin = _unscanned_twin(tm)
    starts = {id(m): {n: t.detach().clone()
                      for n, t in m.state_dict().items()}
              for m in (tm, twin)}
    runs = {}
    for name, m, capture in (("scan", tm, True), ("eager", tm, False),
                             ("flat", twin, True)):
        start = starts[id(m)]
        tr = Trainer(m, train_tests._apply(None),
                     FusedAdamW(train_tests.LR), accum_steps=accum)
        if capture:
            tr.graphs = GraphCache("cpu", StandIn())
        state, losses = train_tests._run_torch(tr, batches,
                                               tr.init_state(start))
        if capture:
            c = tr.graphs.counters(("train_step",))
            assert (c["train_step_captures"], c["train_step_replays"],
                    c["train_step_eager"]) == (1, 3, 0)
        runs[name] = (losses, state.params)
    assert runs["scan"][0] == runs["eager"][0] == runs["flat"][0]
    flat = stack_layers(runs["flat"][1], N)
    for name, p in runs["scan"][1].items():
        assert torch.equal(p, runs["eager"][1][name]), name
        assert torch.equal(p, flat[name]), name
