"""The port's fused norms (``tony_tpu_torch.ops.fused``) against the JAX
package's on the same numpy-seeded inputs: ``rmsnorm`` and
``add_rmsnorm``'s plain versions (which CPU tensors run) against the JAX
Pallas kernels in interpret mode, in fp32 and bf16, with a residual of
another dtype.

Tolerances: an fp32 output to 2^-20 |want| + 1e-7 (both take the mean of
squares in fp32, in another order, and the rsqrt of it; a few fp32
roundings of the element). A bf16 output to 2^-7 |want|: each side
rounds its fp32 result to bf16 once, so they may sit one bf16 step
apart, and a step is up to 2^-7 of the value. ``summed`` is bit-equal:
one fp32 add, one rounding, on both.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tony_tpu.ops.fused import add_rmsnorm as jax_add_rmsnorm
from tony_tpu.ops.fused import rmsnorm as jax_rmsnorm
from tony_tpu_torch.ops import add_rmsnorm, rmsnorm

DTYPES = {"fp32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _pair(a: np.ndarray, name: str):
    jdt, tdt = DTYPES[name]
    return jnp.asarray(a, jdt), torch.from_numpy(a).to(tdt)


def _assert_close(got: torch.Tensor, want, name: str):
    want = np.asarray(want).astype(np.float32)
    got = got.float().numpy()
    rel, atol = (2.0 ** -20, 1e-7) if name == "fp32" else (2.0 ** -7, 0.0)
    diff = np.abs(got - want)
    assert (diff <= rel * np.abs(want) + atol).all(), diff.max()


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("shape", [(4, 32, 64), (8, 1536), (3, 100),
                                   (2, 4096)])
def test_rmsnorm_plain_version_matches_jax(dtype, shape):
    rng = np.random.default_rng(len(shape) + shape[-1])
    xj, xt = _pair(rng.standard_normal(shape).astype(np.float32), dtype)
    scale = (1.0 + 0.1 * rng.standard_normal(shape[-1])).astype(np.float32)
    want = jax_rmsnorm(xj, jnp.asarray(scale))
    got = rmsnorm(xt, torch.from_numpy(scale))
    assert got.dtype == xt.dtype and got.shape == xt.shape
    _assert_close(got, want, dtype)


@pytest.mark.parametrize("x_dtype,r_dtype", [("fp32", "fp32"),
                                             ("bf16", "bf16"),
                                             ("fp32", "bf16"),
                                             ("bf16", "fp32")])
def test_add_rmsnorm_plain_version_matches_jax(x_dtype, r_dtype):
    rng = np.random.default_rng(5)
    xj, xt = _pair(rng.standard_normal((8, 2, 96)).astype(np.float32),
                   x_dtype)
    rj, rt = _pair(rng.standard_normal((8, 2, 96)).astype(np.float32),
                   r_dtype)
    scale = (1.0 + 0.1 * rng.standard_normal(96)).astype(np.float32)
    want_n, want_s = jax_add_rmsnorm(xj, rj, jnp.asarray(scale))
    got_n, got_s = add_rmsnorm(xt, rt, torch.from_numpy(scale))
    assert got_n.dtype == got_s.dtype == xt.dtype
    np.testing.assert_array_equal(got_s.float().numpy(),
                                  np.asarray(want_s).astype(np.float32))
    _assert_close(got_n, want_n, x_dtype)


def test_add_rmsnorm_normalises_the_fp32_sum():
    """The norm is taken of the fp32 sum, not of the bf16-rounded one
    it stores: with scale 1 the fp32 sum's norm differs from the
    stored sum's norm, and the result follows the former."""
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.standard_normal((16, 64)).astype(np.float32))
    r = torch.from_numpy(1e-3 * rng.standard_normal((16, 64))
                         .astype(np.float32))
    xb = x.bfloat16()
    normed, summed = add_rmsnorm(xb, r, torch.ones(64))
    s = xb.float() + r
    exact = (s * torch.rsqrt((s * s).mean(-1, keepdim=True) + 1e-6))
    stored = summed.float()
    of_stored = stored * torch.rsqrt((stored * stored).mean(-1, keepdim=True)
                                     + 1e-6)
    assert torch.equal(normed, exact.bfloat16())
    assert not torch.equal(normed, of_stored.bfloat16())


def test_norms_refuse_mismatched_shapes():
    with pytest.raises(ValueError, match="shape mismatch"):
        rmsnorm(torch.randn(2, 8), torch.ones(7))
    with pytest.raises(ValueError, match="shape mismatch"):
        add_rmsnorm(torch.randn(2, 8), torch.randn(3, 8), torch.ones(8))
