"""``chunked_cross_entropy`` of the port against the JAX package's on the
CPU: value and the gradients in hidden, embedding (and bias), on the same
numpy inputs.

Tolerance: fp32 operands agree to 2e-6 on the loss and 1e-6 on the
gradients (reordered fp32 sums); with bf16 operands (``compute_dtype``)
both round the same bf16 operands and keep fp32 products, so the loss
agrees to 2e-6, while the JAX gradients come out rounded to bf16 (the
cotangent of a bf16 operand is bf16): 2^-7 of each element (one bf16
step of both) plus 2^-9 of the largest.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tony_tpu.ops.xent import chunked_cross_entropy as jax_xent
from tony_tpu.ops.xent import full_cross_entropy as jax_full
from tony_tpu_torch.ops.xent import (chunked_cross_entropy,
                                     full_cross_entropy, logit_route)

CASES = {  # vocab, chunk, mask, z_loss, bias, bf16
    "plain": (96, 32, False, 0.0, False, False),
    "chunk-does-not-divide-vocab": (100, 32, False, 0.0, False, False),
    "mask": (96, 40, True, 0.0, False, False),
    "z-loss": (96, 32, False, 1e-2, False, False),
    "bias": (100, 48, False, 0.0, True, False),
    "everything-bf16": (100, 32, True, 1e-3, True, True),
}


def _inputs(v, seed=0):
    rng = np.random.default_rng(seed)
    hidden = rng.standard_normal((2, 7, 16)).astype(np.float32)
    emb = (0.3 * rng.standard_normal((v, 16))).astype(np.float32)
    labels = rng.integers(0, v, (2, 7)).astype(np.int32)
    mask = rng.integers(0, 2, (2, 7)).astype(np.float32)
    bias = (0.5 * rng.standard_normal(v)).astype(np.float32)
    return hidden, emb, labels, mask, bias


@pytest.mark.parametrize("case", list(CASES))
def test_chunked_cross_entropy_matches_jax(case):
    v, chunk, use_mask, z, use_bias, bf16 = CASES[case]
    hidden, emb, labels, mask, bias = _inputs(v)
    jdt = jnp.bfloat16 if bf16 else None
    tdt = torch.bfloat16 if bf16 else None

    def jloss(h, e, b):
        return jax_xent(h, e, jnp.asarray(labels), chunk_size=chunk,
                        z_loss=z, mask=jnp.asarray(mask) if use_mask else None,
                        bias=b if use_bias else None, compute_dtype=jdt)

    jl, jg = jax.value_and_grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(hidden), jnp.asarray(emb), jnp.asarray(bias))
    th, te, tb = (torch.from_numpy(x).requires_grad_()
                  for x in (hidden, emb, bias))
    tl = chunked_cross_entropy(
        th, te, torch.from_numpy(labels), chunk_size=chunk, z_loss=z,
        mask=torch.from_numpy(mask) if use_mask else None,
        bias=tb if use_bias else None, compute_dtype=tdt)
    tl.backward()
    assert tl.dtype == torch.float32
    assert abs(tl.item() - float(jl)) <= 2e-6 * max(1.0, abs(float(jl)))
    grads = [(th.grad, jg[0]), (te.grad, jg[1])]
    if use_bias:
        grads.append((tb.grad, jg[2]))
    for got, want in grads:
        want = np.asarray(want, np.float32)
        if bf16:
            np.testing.assert_allclose(got.numpy(), want, rtol=2.0 ** -7,
                                       atol=2.0 ** -9 * np.abs(want).max())
        else:
            np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


def test_full_cross_entropy_matches_jax_and_chunked():
    hidden, emb, labels, _, _ = _inputs(96)
    want = float(jax_full(jnp.asarray(hidden), jnp.asarray(emb),
                          jnp.asarray(labels)))
    args = (torch.from_numpy(hidden), torch.from_numpy(emb),
            torch.from_numpy(labels))
    assert abs(float(full_cross_entropy(*args)) - want) < 2e-6
    assert abs(float(chunked_cross_entropy(*args, chunk_size=16))
               - want) < 2e-6


def test_cpu_takes_the_upcast_route():
    assert logit_route("cpu") == "upcast"
