"""Sliding-window models through the port's ``Server``, held against the
JAX ``Server`` on the same weights: ``paged=None`` resolves to the
unpaged cache in both, and tokens, finish reasons and the shared
counters are equal in fp32.

- ``build_pair(9, sliding_window=8)`` with einsum and flash decode
  attention, prompts longer than the window, chunk sizes 1 and 8 and
  in-dispatch EOS off; chunked prefill over the window.
- Speculation over a window (the case of tests/test_spec.py's
  ``test_spec_parity_on_deploy_configs[window]``): equal to speculation
  off, and to the JAX package.
- The refusals both packages make: a paged cache or a prefix store over
  a window, with the same error.
- One-shot ``generate`` over a window (einsum and flash) against the
  JAX ``generate``.
"""

import numpy as np
import pytest

from torch_parity import build_pair, tokens
from tony_tpu.models.generate import generate as jax_generate
from tony_tpu.serve import Request as JaxRequest
from tony_tpu.serve import Server as JaxServer
from tony_tpu_torch.models.generate import generate
from tony_tpu_torch.serve import Request, Server

EOS = (9, 33, 71)
WINDOW = 8
SHARED = ("prefills", "decode_steps", "dispatches", "wasted_steps",
          "frozen_steps", "freeze_faults", "spec_rounds", "spec_drafted",
          "spec_accepted", "prefill_chunk_dispatches",
          "prefill_chunked_requests")


def _mix():
    """Prompts of 3-30 tokens (most past the window), budgets 4-20, more
    requests than slots."""
    return [(tokens(100 + i, n).tolist(), b) for i, (n, b) in enumerate(
        ((12, 10), (3, 14), (30, 6), (17, 20), (9, 8), (25, 4), (5, 12)))]


def _run(srv, req_cls, mix):
    out = {}
    for i, (p, n) in enumerate(mix):
        srv.submit(req_cls(list(p), n, id=i))
    while not srv.done:
        for r in srv.step():
            out[r.id] = (r.tokens, r.finish_reason)
    return out


def _both(models, mix, **kw):
    jm, jp, tm = models
    js = JaxServer(jm, jp, eos_id=EOS, min_bucket=8, **kw)
    ts = Server(tm, eos_id=EOS, min_bucket=8, device="cpu", **kw)
    assert not js.paged and not ts.paged  # paged=None over a window
    want = _run(js, JaxRequest, mix)
    got = _run(ts, Request, mix)
    tc, jc = ts.counters(), js.counters()
    for key in SHARED:
        assert tc[key] == jc[key], key
    return got, want, tc


@pytest.fixture(scope="module", params=["einsum", "flash"])
def models(request):
    return build_pair(9, sliding_window=WINDOW,
                      decode_attention=request.param)


@pytest.mark.parametrize("opts", [
    {"chunk_steps": 1}, {"chunk_steps": 8},
    {"chunk_steps": 8, "in_dispatch_eos": False},
    {"chunk_steps": 4, "prefill_chunk_tokens": 8}],
    ids=["chunk1", "chunk8", "eos-off", "chunked-prefill"])
def test_windowed_server_matches_jax(models, opts):
    got, want, tc = _both(models, _mix(), batch_size=2, **opts)
    assert got == want
    assert any(len(p) > WINDOW for p, _ in _mix())
    assert any(r == "length" for _, r in got.values())
    if "prefill_chunk_tokens" in opts:
        assert tc["prefill_chunked_requests"] > 0


def test_speculation_over_a_window():
    """tests/test_spec.py's window case: speculation stays exact, in
    both packages, when the per-row window mask bounds the verify
    window's visibility too."""
    models = build_pair(4, vocab_size=64, d_model=32, n_heads=2,
                        n_kv_heads=2, max_seq_len=64, sliding_window=6)
    mix = [([1, 2, 3] * 4, 8), ([7, 9, 11], 6)]
    on, want, tc = _both(models, mix, batch_size=2, chunk_steps=1,
                         speculate_k=4)
    off, _, _ = _both(models, mix, batch_size=2, chunk_steps=1)
    assert on == want == off
    assert tc["spec_rounds"] > 0


@pytest.mark.parametrize("kw", [{"paged": True}, {"prefix_cache_mb": 4.0}],
                         ids=["paged", "prefix-store"])
def test_window_refusals_equal_jax(kw):
    jm, jp, tm = build_pair(9, sliding_window=WINDOW)
    with pytest.raises(NotImplementedError) as jerr:
        JaxServer(jm, jp, **kw)
    with pytest.raises(NotImplementedError) as terr:
        Server(tm, device="cpu", **kw)
    assert str(terr.value) == str(jerr.value)
    assert "sliding-window" in str(terr.value)


@pytest.mark.parametrize("attn", ["einsum", "flash"])
def test_windowed_generate_matches_jax(attn):
    jm, jp, tm = build_pair(9, sliding_window=WINDOW, decode_attention=attn)
    prompt = tokens(120, (2, 14))
    want = np.asarray(jax_generate(jm, jp, prompt.astype(np.int32),
                                   max_new_tokens=20, eos_id=EOS))
    got = generate(tm, prompt, max_new_tokens=20, eos_id=EOS).numpy()
    assert (got == want).all()
