"""``parallel.ring_attention.blockwise_attention`` against the JAX
package's (``tony_tpu/parallel/ring_attention.py``) on the same numpy
inputs: outputs and gradients, causal and not, a window, segment ids,
a length that is not a multiple of the block, a row no key reaches and
bf16 inputs; the model's ``blockwise`` backend through it; and a record
of every intermediate of the forward, none of which holds ``lq x lk``
elements per head.

Tolerances: fp32 outputs agree to 1e-5 and gradients to 2e-5 absolute
(the same online softmax, its sums reordered; values of magnitude ~1).
bf16 inputs are cast to fp32 inside both, so the outputs round once to
bf16 at the end: within one bf16 ulp of 2 (2^-7).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from torch_parity import build_pair, tokens
from tony_tpu.parallel.ring_attention import \
    blockwise_attention as jax_blockwise
from tony_tpu_torch.parallel import blockwise_attention
from tony_tpu_torch.parallel import ring_attention as ra

ATOL, GRAD_ATOL = 1e-5, 2e-5
B, H, D = 2, 3, 8


def _qkv(seed: int, lq: int, lk: int | None = None):
    rng = np.random.default_rng(seed)
    lk = lq if lk is None else lk
    return (rng.standard_normal((B, lq, H, D)).astype(np.float32),
            rng.standard_normal((B, lk, H, D)).astype(np.float32),
            rng.standard_normal((B, lk, H, D)).astype(np.float32))


def _segments(seed: int, l: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    cuts = np.sort(rng.choice(np.arange(1, l), 2, replace=False))
    seg = np.zeros((B, l), np.int32)
    for b in range(B):
        seg[b, cuts[0]:] = 1
        seg[b, cuts[1] + b:] = 2
    return seg


CASES = {
    "causal": dict(causal=True),
    "full": dict(causal=False),
    "window": dict(causal=True, window=5),
    "window_not_causal": dict(causal=False, window=5),
    "segments": dict(causal=True, segments=True),
}


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("l,block", [(24, 8), (21, 8), (19, 32)])
def test_outputs_and_grads_match_jax(name, l, block):
    kw = dict(CASES[name])
    seg = _segments(l, l) if kw.pop("segments", False) else None
    q, k, v = _qkv(l, l)
    dout = np.random.default_rng(99).standard_normal(q.shape).astype(
        np.float32)

    def jf(q, k, v):
        return jax_blockwise(q, k, v, block_size=block, segment_ids=None
                             if seg is None else jnp.asarray(seg), **kw)

    want, vjp = jax.vjp(jf, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want_g = vjp(jnp.asarray(dout))
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    got = blockwise_attention(tq, tk, tv, block_size=block,
                              segment_ids=None if seg is None
                              else torch.as_tensor(seg), **kw)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL, rtol=0)
    got_g = torch.autograd.grad(got, (tq, tk, tv), torch.as_tensor(dout))
    for g, w, nm in zip(got_g, want_g, "qkv"):
        np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                   atol=GRAD_ATOL, rtol=0, err_msg=nm)


def test_row_no_key_reaches_matches_jax():
    """Window 2 without causality over 3 keys for 8 queries: queries 5-7
    see no key. The reference's sum over max(l, 1e-30) then gives the
    mean of V over every key, the block's padding included (not 0 and
    not NaN), and so does the port."""
    q, k, v = _qkv(3, 8, 3)
    want = np.asarray(jax_blockwise(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), block_size=2,
                                    causal=False, window=2))
    got = blockwise_attention(torch.as_tensor(q), torch.as_tensor(k),
                              torch.as_tensor(v), block_size=2,
                              causal=False, window=2).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got[:, 5], v.sum(axis=1) / 4, atol=ATOL)


def test_bf16_inputs_match_jax():
    q, k, v = _qkv(5, 40)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    want = np.asarray(jax_blockwise(jq, jk, jv, block_size=16),
                      np.float32)
    tq, tk, tv = (torch.as_tensor(a).to(torch.bfloat16) for a in (q, k, v))
    got = blockwise_attention(tq, tk, tv, block_size=16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=2.0 ** -7,
                               rtol=0)


class _Shapes(TorchDispatchMode):
    """Records the shape of every tensor an operator returns."""

    def __init__(self):
        super().__init__()
        self.shapes = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in out if isinstance(out, (tuple, list)) else (out,):
            if isinstance(t, torch.Tensor):
                self.shapes.append(tuple(t.shape))
        return out


@pytest.mark.parametrize("segments", [False, True])
def test_forward_never_holds_the_scores(segments):
    """No intermediate of the forward holds lq x lk elements per head:
    each is at most [B, H, lq, block] (the reference's own scores are
    recorded as the check's control)."""
    l, block = 64, 16
    q, k, v = (torch.as_tensor(a) for a in _qkv(7, l))
    seg = torch.as_tensor(_segments(7, l)) if segments else None
    rec = _Shapes()
    with torch.no_grad(), rec:
        blockwise_attention(q, k, v, block_size=block, segment_ids=seg)
    per_head = [int(np.prod(s)) // (B * H) for s in rec.shapes]
    assert rec.shapes and max(per_head) < l * l, max(per_head)
    ctrl = _Shapes()
    with torch.no_grad(), ctrl:
        ra.reference_attention(q, k, v, segment_ids=seg)
    assert max(int(np.prod(s)) // (B * H) for s in ctrl.shapes) >= l * l


def test_model_blockwise_backend_runs_blockwise(monkeypatch):
    """``attention_backend="blockwise"`` computes through
    ``blockwise_attention`` with the config's block size and window,
    never through ``reference_attention``, and matches the JAX model's
    blockwise forward."""
    import tony_tpu_torch.models.transformer as tmod

    jm, jp, tm = build_pair(0, attention_backend="blockwise",
                            attention_block_size=8, sliding_window=6)
    calls = []
    real = tmod.blockwise_attention

    def spy(*a, **kw):
        calls.append((kw["block_size"], kw["window"]))
        return real(*a, **kw)

    def refuse(*a, **kw):
        raise AssertionError("reference_attention called")

    monkeypatch.setattr(tmod, "blockwise_attention", spy)
    monkeypatch.setattr(tmod, "reference_attention", refuse)
    toks = tokens(2, (2, 21))
    want = np.asarray(jm.apply({"params": jp}, jnp.asarray(toks)))
    with torch.no_grad():
        got = tm(torch.as_tensor(toks)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    assert calls == [(8, 6)] * tm.cfg.n_layers
