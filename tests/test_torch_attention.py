"""``flash_attention`` of the port against the JAX package's on the CPU:
the JAX Pallas kernels in interpret mode, the port's plain version (the
function its CUDA kernels compute), on the same numpy inputs; value and
gradients of a random cotangent.

Tolerance: fp32 throughout, 2e-5 absolute on values of order one and on
the gradients (reordered fp32 sums over at most 64 keys).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tony_tpu.ops.attention import flash_attention as jax_flash
from tony_tpu_torch.ops import attention as att

CASES = {  # b, l, h, kvh, causal, window, segments
    "causal-gqa6": (1, 64, 6, 1, True, 0, False),
    "noncausal-gqa2": (2, 64, 4, 2, False, 0, False),
    "causal-mha": (1, 64, 4, 4, True, 0, False),
    "window": (1, 64, 6, 1, True, 16, False),
    "segments-gqa2": (2, 64, 4, 2, True, 0, True),
    "odd-len-pad-path": (1, 63, 6, 1, True, 0, False),
}
D = 64


def _inputs(b, l, h, kvh, segments, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, l, h, D)).astype(np.float32)
    k = rng.standard_normal((b, l, kvh, D)).astype(np.float32)
    v = rng.standard_normal((b, l, kvh, D)).astype(np.float32)
    ct = rng.standard_normal((b, l, h, D)).astype(np.float32)
    seg = None
    if segments:
        seg = np.sort(rng.integers(0, 3, (b, l)), axis=1).astype(np.int32)
    return q, k, v, ct, seg


@pytest.mark.parametrize("case", list(CASES))
def test_flash_attention_matches_jax(case):
    b, l, h, kvh, causal, window, segments = CASES[case]
    q, k, v, ct, seg = _inputs(b, l, h, kvh, segments)

    def jloss(q_, k_, v_):
        out = jax_flash(q_, k_, v_, causal=causal, block_q=32, block_k=32,
                        window=window,
                        segment_ids=None if seg is None else jnp.asarray(seg))
        return jnp.sum(out * ct), out

    (_, jout), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                           has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = att.flash_attention(
        tq, tk, tv, causal=causal, block_q=32, block_k=32, window=window,
        segment_ids=None if seg is None else torch.from_numpy(seg))
    (out * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=2e-5, rtol=0)
    for got, want in zip((tq.grad, tk.grad, tv.grad), jgrads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=2e-5, rtol=0)


@pytest.mark.parametrize("blocks", [(512, 512), (32, 16), (8, 64)])
def test_block_sizes_change_nothing(blocks):
    q, k, v, _, seg = _inputs(2, 48, 4, 2, True)
    args = [torch.from_numpy(x) for x in (q, k, v)]
    base = att.flash_attention(*args, segment_ids=torch.from_numpy(seg))
    got = att.flash_attention(*args, block_q=blocks[0], block_k=blocks[1],
                              segment_ids=torch.from_numpy(seg))
    assert torch.equal(got, base)


@pytest.mark.parametrize("kw,msg", [
    (dict(causal=False, window=4), "requires causal"),
    (dict(lk=40, window=4), "self-attention"),
    (dict(causal=False, segments=True), "require causal"),
    (dict(lk=40, segments=True), "self-attention"),
    (dict(kvh=4), "not divisible"),
    (dict(lq=36, lk=44, block_q=16, block_k=16), "UNEQUAL"),
])
def test_semantic_errors_of_the_jax_function(kw, msg):
    lq, lk = kw.get("lq", 32), kw.get("lk", 32)
    q = torch.zeros(1, lq, 6, D)
    k = torch.zeros(1, lk, kw.get("kvh", 2), D)
    seg = torch.zeros(1, lq, dtype=torch.int32) if kw.get("segments") \
        else None
    with pytest.raises(ValueError, match=msg):
        att.flash_attention(q, k, k, causal=kw.get("causal", True),
                            block_q=kw.get("block_q", 512),
                            block_k=kw.get("block_k", 512),
                            window=kw.get("window", 0), segment_ids=seg)


def test_unequal_blockable_causal_lengths_are_allowed():
    """Where the JAX function needs no padding it takes lq != lk, with a
    top-left aligned causal mask; so does the port."""
    q, _, _, _, _ = _inputs(1, 32, 4, 2, False)
    _, k, v, _, _ = _inputs(1, 64, 4, 2, False, seed=1)
    want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     block_q=32, block_k=32)
    got = att.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                              block_q=32, block_k=32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window,segments", [(0, False), (0, True),
                                             (20, False)])
def test_plain_backward_is_the_plain_forwards_gradient(dtype, window,
                                                       segments):
    """``flash_attention_bwd_reference`` (what the backward kernels are
    held to) against autograd of ``flash_attention_reference``, within
    ``error_bound``: the same math with the cast points in other places."""
    q, k, v, ct, seg = _inputs(2, 80, 6, 2, segments)
    q, k, v, ct = (torch.from_numpy(x).to(dtype) for x in (q, k, v, ct))
    seg = None if seg is None else torch.from_numpy(seg)
    kw = dict(causal=True, window=window, segment_ids=seg)
    x = [t.clone().requires_grad_() for t in (q, k, v)]
    o = att.flash_attention_reference(*x, **kw)
    (o.float() * ct.float()).sum().backward()
    o, lse = att.flash_attention_reference(q, k, v, return_lse=True, **kw)
    grads = att.flash_attention_bwd_reference(q, k, v, o, lse, ct, **kw)
    lim = att.error_bound(q, k, v, o, lse, ct, **kw)
    for name, got, t in zip(("dq", "dk", "dv"), grads, x):
        # in bf16, autograd rounds each q head's dK/dV to bf16 before
        # the group sum and rounds the sum again: twice the limit, plus
        # one bf16 step of the result
        limit = lim[name] if dtype == torch.float32 else \
            2 * lim[name] + 2.0 ** -7 * t.grad.float().abs()
        excess = ((got.float() - t.grad.float()).abs() - limit).max()
        assert excess <= 0, (name, float(excess))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_error_bound_fails_a_dropped_tile(dtype):
    """The per-element limit is tight enough that a forward that drops
    one 64-key tile, or one q head of a KV group in dK/dV, fails it."""
    q, k, v, ct, _ = _inputs(1, 256, 6, 1, False, seed=2)
    q, k, v, ct = (torch.from_numpy(x).to(dtype) for x in (q, k, v, ct))
    o, lse = att.flash_attention_reference(q, k, v, return_lse=True)
    lim = att.error_bound(q, k, v, o, lse, ct)
    # drop keys 64..127 for every query
    k2 = k.clone()
    k2[:, 64:128] = -1e4 * torch.sign(q.float().mean((0, 1, 2)))
    bad = att.flash_attention_reference(q, k2, v)
    assert ((bad.float() - o.float()).abs() > lim["o"]).any()
    _, dk, dv = att.flash_attention_bwd_reference(q, k, v, o, lse, ct)
    ct2 = ct.clone()
    ct2[:, :, 5] = 0  # the group's last head contributes nothing
    _, dk2, dv2 = att.flash_attention_bwd_reference(q, k, v, o, lse, ct2)
    assert ((dv2.float() - dv.float()).abs() > lim["dv"]).any()
    assert ((dk2.float() - dk.float()).abs() > lim["dk"]).any()
