"""The port's int8 weight ops (``tony_tpu_torch.ops.quant``) against the
JAX package's on the same numpy-seeded inputs: ``quantize_q8`` bit for
bit, and ``q8_matmul``'s plain version (which CPU tensors run) against
the JAX ``q8_matmul``, whose Pallas kernel runs in interpret mode here.

Tolerances: fp32 outputs to 2e-5 (as ``tests/test_quantize.py`` holds
the JAX kernel against a dequantized product): both are fp32 sums over
k <= 1000 of products of magnitude ~1, taken in another order. A bf16
output to 2^-7 |want| + 1e-5 max|want|: each side rounds its fp32
result to bf16 once, so the two may sit one bf16 step apart, and a step
is up to 2^-7 of the value.
The last tests show that ``ops.quant.error_bound``, the per-element
limit the CUDA kernel is held to on the card, is tight enough to catch
a dropped 32-wide k-slice or a dropped column scale.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tony_tpu.ops.quant import dequantize_q8 as jax_dequantize_q8
from tony_tpu.ops.quant import q8_matmul as jax_q8_matmul
from tony_tpu.ops.quant import quantize_q8 as jax_quantize_q8
from tony_tpu_torch.ops import dequantize_q8, q8_matmul, quantize_q8
from tony_tpu_torch.ops.quant import error_bound, q8_matmul_reference


def _weights(seed, k, n):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((k, n)).astype(np.float32)
    w[:, 0] = 0.0  # an all-zero column: the scale's 1e-8 floor
    w[3 % k, 1 % n] = 40.0  # one large value sets its column's scale
    # values that land on .5 after the division: round half to even
    w[:, -1] = np.arange(k, dtype=np.float32) - k / 2 + 0.5
    return w


@pytest.mark.parametrize("k,n", [(64, 128), (37, 300), (1, 5)])
def test_quantize_q8_bit_equal_to_jax(k, n):
    w = _weights(0, k, n)
    jq, js = jax_quantize_q8(jnp.asarray(w))
    tq, ts = quantize_q8(torch.from_numpy(w))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert int(tq.min()) >= -127
    np.testing.assert_array_equal(
        dequantize_q8(tq, ts).numpy(),
        np.asarray(jax_dequantize_q8(jq, js)))


# (m, k, n): a prime m, a decode-sized m, an n with no divisor >= 64 (the
# JAX XLA fallback) and k not a multiple of the kernel's chunks
@pytest.mark.parametrize("m,k,n", [(257, 64, 128), (8, 96, 256),
                                   (13, 100, 263), (1, 1000, 64)])
def test_q8_matmul_plain_version_matches_jax(m, k, n):
    rng = np.random.default_rng(m + k + n)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w_q, scale = quantize_q8(torch.from_numpy(_weights(1, k, n)))
    want = np.asarray(jax_q8_matmul(jnp.asarray(x), jnp.asarray(w_q.numpy()),
                                    jnp.asarray(scale.numpy())))
    got = q8_matmul(torch.from_numpy(x), w_q, scale)
    assert got.dtype == torch.float32 and got.shape == (m, n)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("out_dtype", [None, jnp.float32])
def test_q8_matmul_plain_version_matches_jax_bf16(out_dtype):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((24, 128)).astype(np.float32)
    w_q, scale = quantize_q8(torch.from_numpy(_weights(2, 128, 192)))
    xj = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(jax_q8_matmul(xj, jnp.asarray(w_q.numpy()),
                                    jnp.asarray(scale.numpy()),
                                    out_dtype=out_dtype)).astype(np.float32)
    xt = torch.from_numpy(x).bfloat16()
    got = q8_matmul(xt, w_q, scale,
                    out_dtype=None if out_dtype is None else torch.float32)
    assert got.dtype == (torch.bfloat16 if out_dtype is None
                         else torch.float32)
    diff = np.abs(got.float().numpy() - want)
    rel = 2.0 ** -7 if out_dtype is None else 0.0
    assert (diff <= rel * np.abs(want) + 1e-5 * np.abs(want).max()).all()


def test_q8_matmul_refuses_mismatched_shapes():
    w_q, scale = quantize_q8(torch.randn(8, 4))
    with pytest.raises(ValueError, match="shape mismatch"):
        q8_matmul(torch.randn(2, 7), w_q, scale)
    with pytest.raises(ValueError, match="shape mismatch"):
        q8_matmul(torch.randn(2, 8), w_q, scale[:3])
    with pytest.raises(ValueError, match="int8"):
        q8_matmul(torch.randn(2, 8), w_q.float(), scale)


def _bound_case(dtype):
    """The kernel's decode shape at test size: x [8, 1536], int8 w."""
    g = torch.Generator().manual_seed(3)
    x = torch.randn(8, 1536, generator=g).to(dtype)
    w_q, scale = quantize_q8(0.02 * torch.randn(1536, 256, generator=g))
    want = q8_matmul_reference(x, w_q, scale)
    return x, w_q, scale, want, error_bound(x, w_q, scale, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_error_bound_catches_a_dropped_k_slice(dtype):
    x, w_q, scale, want, limit = _bound_case(dtype)
    for start in (0, 736, 1504):  # first, middle, last 32-wide slice
        dropped = x.clone()
        dropped[:, start:start + 32] = 0
        wrong = q8_matmul_reference(dropped, w_q, scale)
        excess = ((wrong.float() - want.float()).abs() - limit).max()
        assert excess > 0, start


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_error_bound_catches_a_dropped_column_scale(dtype):
    x, w_q, scale, want, limit = _bound_case(dtype)
    for col in (0, 129, 255):
        unscaled = scale.clone()
        unscaled[col] = 1.0
        wrong = q8_matmul_reference(x, w_q, unscaled)
        excess = ((wrong.float() - want.float()).abs() - limit)[:, col]
        assert (excess > 0).all(), col
