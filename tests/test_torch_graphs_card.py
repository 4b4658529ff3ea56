"""Replayed CUDA graphs against the same calls launched eagerly, on the
card. These tests import no JAX, so they run on a GPU machine without
it; with no CUDA device they skip (a CUDA graph has no CPU mode):

    python -m pytest --noconftest tests/test_torch_graphs_card.py -q

- The ``Server`` with its graphs and the same ``Server`` with none
  (every chunk and prefill eager) serve one request mix, with more
  requests than slots so slots are re-admitted between replays of a
  key, over a bf16 and an int8 KV cache: equal tokens, equal pool bytes
  (the junk page aside: dropped writes collide there in any order), and
  flash-decode launches of n_layers per micro-step in both.
- The same with speculation (``speculate_k``: verify rounds) and with
  chunked prefill (``prefill_chunk_tokens``: intermediate chunks), over
  repetitive prompts so that drafts land: equal tokens and pool bytes,
  every verify round and intermediate chunk a capture or a replay, and
  flash-decode launches of n_layers per single-token micro-step (chunk
  and continuation; none in a verify window).
- The unpaged ``Server`` (``paged=False``, and a sliding-window model,
  unpaged by default) with its graphs and with none, plain and with
  speculation: equal tokens and resident-cache bytes, every chunk and
  verify round a capture or a replay (keys ``chunk_rows`` and
  ``verify_rows``), every prefill one eager call.
- ``generate`` replayed (capturing on its first call, replaying every
  step of its second) and launched eagerly, with bf16 and int8 weights
  and with a repetition penalty: equal tokens, and q8_matmul launches
  of 7 x n_layers a forward.
- Sampled requests through the ``Server`` (paged, with speculation,
  unpaged with speculation) with its graphs and with none: equal
  tokens, no chunk or verify round eager; a sampled ``generate``
  replayed and eager from one generator state: equal tokens.
- ``Trainer.step`` captured whole and eager from equal states, one and
  two micro-batches: losses and masters bit-equal, each step adding
  one step's flash attention and fused AdamW launches, and replays after
  fused AdamW's table cache was emptied still equal.

Tolerance: none (bit-equal).
"""

import dataclasses

import numpy as np
import pytest
import torch

from tony_tpu_torch.models import quantize_for_serving
from tony_tpu_torch.models.generate import _generate_eager, generate
from tony_tpu_torch.models.transformer import Transformer, TransformerConfig
from tony_tpu_torch.ops.decode import flash_decode
from tony_tpu_torch.ops.quant import q8_matmul
from tony_tpu_torch.serve import Request, Server

CFG = dict(vocab_size=512, d_model=256, n_heads=4, n_kv_heads=2,
           n_layers=2, d_ff=512, max_seq_len=256, qkv_bias=True,
           gated_mlp=True, activation="silu", norm="rms", rope_theta=1e6,
           decode_attention="flash", attention_backend="reference")


def _model(**kw):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (a CUDA graph has no CPU mode)")
    cfg = TransformerConfig(**{**CFG, "dtype": torch.bfloat16, **kw})
    return Transformer(cfg, device="cuda").init_weights(
        torch.Generator(device="cuda").manual_seed(0))


def _serve(model, graphs: bool):
    rng = np.random.default_rng(0)
    pre = rng.integers(0, 512, 40).tolist()
    srv = Server(model, batch_size=3, eos_id=(5, 7), chunk_steps=8,
                 min_bucket=16, kv_page_size=16, prefix_cache_mb=8.0)
    if not graphs:
        srv.graphs = None
    before = flash_decode.launches
    for i in range(8):
        n = int(rng.integers(3, 90))
        prompt = (pre if i % 2 else []) + rng.integers(0, 512, n).tolist()
        srv.submit(Request(prompt, int(rng.integers(4, 40)), id=i))
    out = {}
    while not srv.done:
        for r in srv.step():
            out[r.id] = (r.tokens, r.finish_reason)
    torch.cuda.synchronize()
    return out, srv, flash_decode.launches - before


@pytest.mark.cuda
@pytest.mark.parametrize("kv_int8", [False, True], ids=["bf16", "int8"])
def test_replayed_server_bit_equal_to_eager(kv_int8):
    model = _model(kv_cache_quant=kv_int8)
    want, eager, eager_launches = _serve(model, graphs=False)
    got, srv, launches = _serve(model, graphs=True)
    assert got == want
    c = srv.counters()
    assert c["graph_decode_eager"] == 0 and c["graph_decode_replays"] > 0
    assert c["graph_decode_captures"] + c["graph_decode_replays"] \
        == c["dispatches"]
    assert c["graph_prefill_captures"] + c["graph_prefill_replays"] \
        == c["prefills"]
    assert launches == eager_launches \
        == model.cfg.n_layers * c["decode_steps"] > 0
    n = srv.slots.pool.n_pages
    for key, layer in srv.slots.cache.items():
        if key.startswith("block_"):
            for name, leaf in layer.items():
                if isinstance(leaf, torch.Tensor):
                    assert torch.equal(leaf[:n],
                                       eager.slots.cache[key][name][:n]), \
                        (key, name)


def _serve_option(model, graphs: bool, **option):
    """Eight requests whose prompts repeat a short pattern (so prompt
    lookup drafts), 20-200 tokens long (so a 64-token prefill chunk
    splits the longer ones), through a ``Server`` with ``option``."""
    rng = np.random.default_rng(1)
    srv = Server(model, batch_size=3, eos_id=(5, 7), chunk_steps=8,
                 min_bucket=16, kv_page_size=16, prefix_cache_mb=8.0,
                 **option)
    if not graphs:
        srv.graphs = None
    before = flash_decode.launches
    for i in range(8):
        pattern = rng.integers(0, 512, int(rng.integers(3, 9))).tolist()
        n = int(rng.integers(20, 201))
        srv.submit(Request((pattern * 70)[:n], int(rng.integers(8, 48)),
                           id=i))
    out = {}
    while not srv.done:
        for r in srv.step():
            out[r.id] = (r.tokens, r.finish_reason)
    torch.cuda.synchronize()
    return out, srv, flash_decode.launches - before


@pytest.mark.cuda
@pytest.mark.parametrize("option", [{"speculate_k": 4},
                                    {"prefill_chunk_tokens": 64}],
                         ids=["spec", "chunked"])
@pytest.mark.parametrize("kv_int8", [False, True], ids=["bf16", "int8"])
def test_replayed_options_bit_equal_to_eager(kv_int8, option):
    model = _model(kv_cache_quant=kv_int8)
    want, eager, eager_launches = _serve_option(model, False, **option)
    got, srv, launches = _serve_option(model, True, **option)
    assert got == want
    c = srv.counters()
    for kind in ("decode", "verify", "prefill", "prefill_chunk"):
        assert c[f"graph_{kind}_eager"] == 0, kind
    assert c["graph_verify_captures"] + c["graph_verify_replays"] \
        == c["spec_rounds"]
    assert c["graph_decode_captures"] + c["graph_decode_replays"] \
        == c["dispatches"] - c["spec_rounds"]
    assert c["graph_prefill_chunk_captures"] \
        + c["graph_prefill_chunk_replays"] \
        == c["prefill_chunk_dispatches"] - c["prefill_chunked_requests"]
    if "speculate_k" in option:
        assert c["spec_rounds"] > 0 and c["graph_verify_replays"] > 0
    else:
        assert c["graph_prefill_chunk_replays"] > 0
    assert launches == eager_launches == model.cfg.n_layers * (
        c["decode_steps"] - c["spec_window_steps"]) > 0
    n = srv.slots.pool.n_pages
    for key, layer in srv.slots.cache.items():
        if key.startswith("block_"):
            for name, leaf in layer.items():
                if isinstance(leaf, torch.Tensor):
                    assert torch.equal(leaf[:n],
                                       eager.slots.cache[key][name][:n]), \
                        (key, name)


def _serve_rows(model, graphs: bool, **option):
    """``_serve_option``'s requests through an unpaged ``Server``."""
    rng = np.random.default_rng(2)
    srv = Server(model, batch_size=3, eos_id=(5, 7), chunk_steps=8,
                 min_bucket=16, paged=False, **option)
    if not graphs:
        srv.graphs = None
    before = flash_decode.launches
    for i in range(8):
        pattern = rng.integers(0, 512, int(rng.integers(3, 9))).tolist()
        n = int(rng.integers(20, 201))
        srv.submit(Request((pattern * 70)[:n], int(rng.integers(8, 48)),
                           id=i))
    out = {}
    while not srv.done:
        for r in srv.step():
            out[r.id] = (r.tokens, r.finish_reason)
    torch.cuda.synchronize()
    return out, srv, flash_decode.launches - before


@pytest.mark.cuda
@pytest.mark.parametrize("option", [{}, {"speculate_k": 4}],
                         ids=["plain", "spec"])
@pytest.mark.parametrize("window", [0, 24], ids=["rows", "window"])
@pytest.mark.parametrize("kv_int8", [False, True], ids=["bf16", "int8"])
def test_replayed_unpaged_bit_equal_to_eager(kv_int8, window, option):
    model = _model(kv_cache_quant=kv_int8, sliding_window=window)
    if not window:
        option = {**option, "prefix_cache_mb": 8.0}
    want, eager, eager_launches = _serve_rows(model, False, **option)
    got, srv, launches = _serve_rows(model, True, **option)
    assert got == want
    c = srv.counters()
    assert not srv.paged
    for kind in ("chunk_rows", "verify_rows"):
        assert c[f"graph_{kind}_eager"] == 0, kind
    assert c["graph_chunk_rows_captures"] + c["graph_chunk_rows_replays"] \
        == c["dispatches"] - c["spec_rounds"]
    assert c["graph_verify_rows_captures"] \
        + c["graph_verify_rows_replays"] == c["spec_rounds"]
    assert c["graph_prefill_rows_eager"] == c["prefills"] > 0
    if "speculate_k" in option:
        assert c["spec_rounds"] > 0 and c["graph_verify_rows_replays"] > 0
    else:
        assert c["graph_chunk_rows_replays"] > 0
    assert launches == eager_launches == model.cfg.n_layers * (
        c["decode_steps"] - c["spec_window_steps"]) > 0
    for key, layer in srv.slots.cache.items():
        if key.startswith("block_"):
            for name, leaf in layer.items():
                if isinstance(leaf, torch.Tensor):
                    assert torch.equal(leaf, eager.slots.cache[key][name]), \
                        (key, name)


@pytest.mark.cuda
def test_replayed_generate_with_penalty_bit_equal_to_eager():
    model = _model()
    prompt = torch.randint(0, 512, (3, 40), device="cuda",
                           generator=torch.Generator(device="cuda")
                           .manual_seed(2))
    for penalty in (1.0, 1.3):
        want = _generate_eager(model, prompt, 32,
                               lambda x: torch.argmax(x, -1), (5,),
                               repetition_penalty=penalty)
        got = generate(model, prompt, max_new_tokens=32, eos_id=5,
                       repetition_penalty=penalty)
        assert torch.equal(got, want), penalty
    assert model.graphs.counters(("generate",))["generate_replays"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_replayed_generate_bit_equal_to_eager(int8):
    model = _model()
    if int8:
        fp32 = _model(dtype=torch.float32)
        q = quantize_for_serving(fp32)
        model = Transformer(dataclasses.replace(q.cfg, dtype=torch.bfloat16),
                            device="cuda")
        model.load_state_dict(q.state_dict())
    prompt = torch.randint(0, 512, (4, 30), device="cuda",
                           generator=torch.Generator(device="cuda")
                           .manual_seed(1))
    want = _generate_eager(model, prompt, 24,
                           lambda x: torch.argmax(x, -1), (5,))
    before = q8_matmul.launches
    for call in range(2):
        got = generate(model, prompt, max_new_tokens=24, eos_id=5)
        assert torch.equal(got, want), call
    torch.cuda.synchronize()
    c = model.graphs.counters(("generate",))
    assert c["generate_captures"] == 1 and c["generate_replays"] == 45
    if int8:
        # two prefills and 2 x 23 steps, each 7 projections a layer
        assert q8_matmul.launches - before \
            == 7 * model.cfg.n_layers * (2 + 46)


def _serve_sampled(model, graphs: bool, **option):
    """``_serve_option``'s eight repetitive prompts, every second request
    sampled (temperature 0.8, top-k 20 on half of those), a seed each."""
    rng = np.random.default_rng(2)
    srv = Server(model, batch_size=3, eos_id=(5, 7), chunk_steps=8,
                 min_bucket=16, kv_page_size=16, prefix_cache_mb=8.0,
                 **option)
    if not graphs:
        srv.graphs = None
    for i in range(8):
        pattern = rng.integers(0, 512, int(rng.integers(3, 9))).tolist()
        n = int(rng.integers(20, 201))
        knobs = {} if i % 2 == 0 else dict(
            temperature=0.8, top_k=20 if i % 4 == 1 else 0, seed=i)
        srv.submit(Request((pattern * 70)[:n], int(rng.integers(8, 48)),
                           id=i, **knobs))
    out = {}
    while not srv.done:
        for r in srv.step():
            out[r.id] = (r.tokens, r.finish_reason)
    torch.cuda.synchronize()
    return out, srv


@pytest.mark.cuda
@pytest.mark.parametrize("option", [{}, {"speculate_k": 4},
                                    {"paged": False, "speculate_k": 4}],
                         ids=["paged", "spec", "unpaged_spec"])
def test_sampled_rounds_replayed_bit_equal_to_eager(option):
    """Sampled chunks and verify rounds replay at their keys' sampled
    variants: the same tokens as the server with no graphs, none eager."""
    model = _model()
    want, _ = _serve_sampled(model, graphs=False, **option)
    got, srv = _serve_sampled(model, graphs=True, **option)
    assert got == want
    c = srv.counters()
    kinds = srv.graph_kinds[:2]
    assert all(c[f"graph_{k}_eager"] == 0 for k in kinds)
    assert any(k[-1] == "sampled" for k in srv.graphs.entries)


@pytest.mark.cuda
def test_replayed_sampled_generate_bit_equal_to_eager():
    from tony_tpu_torch.models.generate import _picker
    from tony_tpu_torch.ops.sampling import key_from_generator

    model = _model()
    prompt = torch.randint(0, 512, (4, 30), device="cuda",
                           generator=torch.Generator(device="cuda")
                           .manual_seed(3))
    kw = dict(temperature=0.8, top_k=20, top_p=0.9)
    for penalty in (1.0, 1.3):
        got = generate(model, prompt, max_new_tokens=24, eos_id=5,
                       repetition_penalty=penalty,
                       generator=torch.Generator(device="cuda")
                       .manual_seed(9), **kw)
        sampler = (key_from_generator(torch.Generator(device="cuda")
                                      .manual_seed(9), "cuda"), 0.8, 20, 0.9)
        want = _generate_eager(model, prompt, 24, _picker(model, sampler),
                               (5,), repetition_penalty=penalty)
        assert torch.equal(got, want), penalty
    c = model.graphs.counters(("generate",))
    # two calls of 23 steps at one key: the first call's first step is
    # the key's first call and capture
    assert (c["generate_captures"], c["generate_replays"],
            c["generate_eager"]) == (1, 45, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("accum", [1, 2])
def test_captured_train_step_bit_equal_to_eager(accum):
    """Trainer.step captured whole (flash attention forward and backward
    and fused AdamW inside the graph) against the eager step from equal
    states: losses and masters bit-equal, one capture and three
    replays, and each replay adding one step's launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (a CUDA graph has no CPU mode)")
    from tony_tpu_torch.models.graphs import launch_counts
    from tony_tpu_torch.ops import adamw as adw
    from tony_tpu_torch.ops.adamw import FusedAdamW
    from tony_tpu_torch.ops.xent import chunked_cross_entropy
    from tony_tpu_torch.train import Trainer

    def apply_fn(m, batch):
        hidden = m(batch["tokens"], return_hidden=True)
        return chunked_cross_entropy(hidden[:, :-1], m.embedding,
                                     batch["tokens"][:, 1:], chunk_size=128,
                                     compute_dtype=torch.bfloat16)

    def lr(count):
        return 1e-3 * torch.clamp((count + 1).float() / 3.0, max=1.0)

    batches = [torch.randint(0, 512, (4, 128), device="cuda",
                             generator=torch.Generator(device="cuda")
                             .manual_seed(10 + i)) for i in range(4)]
    runs = []
    for captured in (True, False):
        model = _model(attention_backend="pallas", remat=True,
                       remat_policy="attn_saved")
        tr = Trainer(model, apply_fn, FusedAdamW(lr),
                     compute_dtype=torch.bfloat16, accum_steps=accum)
        if not captured:
            tr.graphs = None
        state = tr.init_state()
        losses, rises = [], []
        for i, b in enumerate(batches):
            before = launch_counts()
            state, m = tr.step(state, {"tokens": b})
            losses.append(m["loss"])
            rises.append([a - c for a, c in zip(launch_counts(), before)])
            if captured and i == 1:
                # AdamW's table cache evicts: the graph keeps its table
                adw._tables.clear()
                junk = [torch.full((1 << k,), -1, dtype=torch.int64,
                                   device="cuda") for k in range(8, 20)]
                del junk
        torch.cuda.synchronize()
        runs.append((torch.stack(losses), state, rises))
        if captured:
            c = tr.graphs.counters(("train_step",))
            assert (c["train_step_captures"], c["train_step_replays"]) \
                == (1, 3)
    (lc, sc, rc), (le, se, re_) = runs
    assert torch.equal(lc, le)
    for name, p in sc.params.items():
        assert torch.equal(p, se.params[name]), name
    # the last four counts: flash attention fwd, dQ, dK/dV and AdamW
    assert rc == re_ and rc[0][-4:] == [model.cfg.n_layers * accum] * 3 + [1]
