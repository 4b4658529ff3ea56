"""``FusedAdamW`` of the port against the JAX package's
``fused_adamw_update`` (its Pallas kernel forced on leaves of 1024+
elements, in interpret mode, as ``tests/test_adamw.py`` forces it) and
against ``optax.adamw``, over several steps, on the same numpy params and
gradients.

Tolerance: 2e-6 relative and 3e-7 absolute on params and moments (the
bounds ``tests/test_adamw.py`` holds the JAX kernel to against optax: the
same fp32 operations, possibly contracted into fused multiply-adds by
XLA); bf16 moments and compute copies to one bf16 step (2^-7 relative,
plus 2^-8 of the largest value for moments near zero),
and params under bf16 moments to 2^-8 of lr a step (a moment one bf16
step apart moves the update by that much).
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tony_tpu.ops.adamw import FusedAdamW as JaxFusedAdamW
from tony_tpu.ops.adamw import fused_adamw_update as jax_update
from tony_tpu_torch.ops.adamw import FusedAdamW, fused_adamw_update


def _params(seed=0):
    rng = np.random.default_rng(seed)
    return {"big": rng.standard_normal((64, 1024)).astype(np.float32),
            "w": rng.standard_normal((16, 48)).astype(np.float32),
            "b": rng.standard_normal(48).astype(np.float32)}


def _grads(params, step):
    return {n: (np.sin(p) * 0.1 + step * 0.01).astype(np.float32)
            for n, p in params.items()}


def _close(got: dict, want, rtol=2e-6, atol=3e-7):
    for n, t in got.items():
        np.testing.assert_allclose(t.float().numpy(),
                                   np.asarray(want[n], np.float32),
                                   rtol=rtol, atol=atol, err_msg=n)


def _torch(tree, dtype=None):
    return {n: torch.from_numpy(np.array(x, np.float32)).to(
        dtype or torch.float32) for n, x in tree.items()}


@pytest.mark.parametrize("schedule", [False, True])
def test_fused_adamw_matches_jax_kernel_and_optax(monkeypatch, schedule):
    monkeypatch.setenv("TONY_FUSED_ADAMW_MIN_ELEMS", "1024")
    if schedule:  # cosine decay from 1e-2 over 10 steps, both frameworks
        jlr = optax.cosine_decay_schedule(1e-2, 10)

        def tlr(count):
            frac = torch.clamp(count.float(), max=10.0) / 10.0
            return 1e-2 * 0.5 * (1.0 + torch.cos(np.pi * frac))
    else:
        jlr = tlr = 3e-4
    jopt = JaxFusedAdamW(learning_rate=jlr, weight_decay=1e-2)
    topt = FusedAdamW(learning_rate=tlr, weight_decay=1e-2)
    ref = optax.adamw(jlr, weight_decay=1e-2)
    p0 = _params()
    jp = {n: jnp.asarray(x) for n, x in p0.items()}
    rp = dict(jp)
    tp = _torch(p0)
    js, rs, ts = jopt.init(jp), ref.init(rp), topt.init(tp)
    for step in range(4):
        g = _grads(p0, step)
        jp, js = jax_update(jopt, {n: jnp.asarray(x) for n, x in g.items()},
                            js, jp)
        upd, rs = ref.update({n: jnp.asarray(x) for n, x in g.items()}, rs,
                             rp)
        rp = optax.apply_updates(rp, upd)
        tp, ts = fused_adamw_update(topt, _torch(g), ts, tp)
        _close(tp, jp)
        _close(tp, rp)
    assert int(ts.count) == 4
    _close(ts.mu, js.mu)
    _close(ts.nu, js.nu)


def test_fused_adamw_bf16_moments_and_carry_match_jax(monkeypatch):
    monkeypatch.setenv("TONY_FUSED_ADAMW_MIN_ELEMS", "1024")
    jopt = JaxFusedAdamW(learning_rate=1e-3, moment_dtype=jnp.bfloat16)
    topt = FusedAdamW(learning_rate=1e-3, moment_dtype=torch.bfloat16)
    p0 = _params(1)
    jp = {n: jnp.asarray(x) for n, x in p0.items()}
    tp = _torch(p0)
    js = jopt.init(jp, compute_dtype=jnp.bfloat16)
    ts = topt.init(tp, compute_dtype=torch.bfloat16)
    for step in range(3):
        g = _grads(p0, step)
        # grads arrive in the compute dtype under the carry
        jg = {n: jnp.asarray(x).astype(jnp.bfloat16) for n, x in g.items()}
        jp, js = jax_update(jopt, jg, js, jp, compute_dtype=jnp.bfloat16)
        tp, ts = fused_adamw_update(topt, _torch(g, torch.bfloat16), ts, tp,
                                    compute_dtype=torch.bfloat16)
    # a moment one bf16 step apart moves an update (about lr) by 2^-8
    _close(tp, jp, rtol=0, atol=3 * 2.0 ** -8 * 1e-3)
    for got, want in ((ts.mu, js.mu), (ts.nu, js.nu),
                      (ts.compute_params, js.compute_params)):
        assert all(t.dtype == torch.bfloat16 for t in got.values())
        # a moment that crosses zero keeps the earlier steps' rounding:
        # plus 2^-8 of the leaf's largest value
        top = max(float(np.abs(np.asarray(w, np.float32)).max())
                  for w in want.values())
        _close(got, want, rtol=2.0 ** -7, atol=2.0 ** -8 * top)


def test_nonfloat_leaf_carries_its_updated_value():
    """The JAX bug at ops/adamw.py:259 is not copied: a non-float leaf's
    compute copy is the updated value, not the stale one."""
    opt = FusedAdamW(learning_rate=0.5, weight_decay=0.0)
    params = {"w": torch.ones(8, 16),
              "steps": torch.tensor([10, 20], dtype=torch.int32)}
    state = opt.init(params, compute_dtype=torch.bfloat16)
    grads = {"w": torch.ones(8, 16),
             "steps": torch.tensor([100, 100], dtype=torch.int32)}
    new_p, new_s = fused_adamw_update(opt, grads, state, params,
                                      compute_dtype=torch.bfloat16)
    assert torch.equal(new_p["steps"], new_s.compute_params["steps"])
    assert new_s.compute_params["w"].dtype == torch.bfloat16


def test_refusals():
    """A spec that names an axis needs a mesh that has it (the sharded
    update itself runs on local shards: ``tests/test_torch_fsdp.py``)."""
    from tony_tpu_torch.parallel import MeshSpec, make_mesh
    from tony_tpu_torch.parallel.sharding import P

    opt = FusedAdamW()
    params = {"w": torch.ones(4)}
    state = opt.init(params)
    with pytest.raises(ValueError, match="no mesh"):
        fused_adamw_update(opt, params, state, params,
                           param_specs={"w": P("fsdp")})
    mesh = make_mesh(MeshSpec(data=2), devices=[0, 1], device_type="cpu")
    with pytest.raises(ValueError, match="not an axis"):
        fused_adamw_update(opt, params, state, params, mesh=mesh,
                           param_specs={"w": P("rows")})
    with pytest.raises(ValueError, match="compute_params"):
        fused_adamw_update(opt, params, state, params,
                           compute_dtype=torch.bfloat16)
