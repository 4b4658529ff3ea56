"""The port's ResNet (``tony_tpu_torch/models/resnet.py``) against
``tony_tpu/models/resnet.py`` on the CPU, in fp32, on the same weights
and batch statistics (seeded numpy, carried across by
``models.convert.from_jax_resnet``).

- ResNet18 at ``num_filters=8`` on NHWC inputs of 32x32 and 33x33 (even
  and odd sizes, so flax's ``"SAME"`` padding shows at the strided
  convolutions and the max pool): logits with ``train=False``, and with
  ``train=True`` the logits and the running statistics after the call,
  within 1e-4 of the largest |logit| (statistics: 1e-5 relative;
  reordered fp32 sums).
- ResNet-50 at ``num_filters=4`` on one 224x224 input, ``train=False``,
  the same limit: the size the chip run trains at.
- One ``Trainer`` step with SGD (``torch.optim.SGD``) against the JAX
  ``Trainer`` with ``optax.sgd``, ``train=False`` with the statistics
  closed over (as ``tests/test_data.py`` trains it): the loss to 1e-5
  relative, every parameter to 1e-5.
- Parameter counts equal the JAX models' (ResNet-50: 25 557 032), and
  the state_dict's keys are exactly what the conversion fills.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tony_tpu.models import resnet as jax_resnet
from tony_tpu.train import Trainer as JaxTrainer
from tony_tpu_torch.models import resnet
from tony_tpu_torch.models.convert import from_jax_resnet
from tony_tpu_torch.train import Trainer

CLASSES = 10


def _leaf(rng, path, shape):
    name = path[-1]
    if name == "scale":
        return (1.0 + 0.2 * rng.standard_normal(shape)).astype(np.float32)
    if name in ("bias", "mean"):
        return (0.1 * rng.standard_normal(shape)).astype(np.float32)
    if name == "var":
        return (1.0 + 0.3 * np.abs(rng.standard_normal(shape))).astype(
            np.float32)
    fan_in = int(np.prod(shape[:-1]))
    return (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _pair(seed=0, name="ResNet18", filters=8):
    """(jax model, numpy variables, port model on the CPU) on the same
    seeded weights and statistics."""
    jm = getattr(jax_resnet, name)(num_classes=CLASSES, num_filters=filters,
                                   dtype=jnp.float32)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.ones((1, 32, 32, 3)), train=False))
    rng = np.random.default_rng(seed)
    variables = jax.tree_util.tree_map_with_path(
        lambda p, s: _leaf(rng, [getattr(k, "key", k) for k in p], s.shape),
        shapes)
    variables = jax.tree.map(np.asarray, variables)
    tm = getattr(resnet, name)(num_classes=CLASSES, num_filters=filters,
                               dtype=torch.float32, device="cpu")
    tm.load_state_dict(from_jax_resnet(variables))
    return jm, variables, tm


def _images(seed, size, b=4):
    return np.random.default_rng(seed).standard_normal(
        (b, size, size, 3)).astype(np.float32)


def _close(got, want, rel=1e-4):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * np.abs(want).max())


@pytest.mark.parametrize("size", [32, 33])
def test_eval_logits_match_flax(size):
    jm, variables, tm = _pair()
    x = _images(1, size)
    want = np.asarray(jm.apply(variables, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), train=False)
    assert got.dtype == torch.float32 and got.shape == (4, CLASSES)
    _close(got.numpy(), want)


def test_resnet50_eval_logits_match_flax_at_224():
    """ResNet-50's bottleneck blocks at the 224x224 input that
    ``chip_smoke.py`` trains on, where every strided 3x3 convolution and
    the max pool pad an even size by (0, 1) (112, 56, 28, 14), at
    ``num_filters=4`` and batch 1; the same limit as above."""
    jm, variables, tm = _pair(name="ResNet50", filters=4)
    x = _images(5, 224, b=1)
    want = np.asarray(jm.apply(variables, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), train=False)
    assert got.shape == (1, CLASSES)
    _close(got.numpy(), want)


@pytest.mark.parametrize("size", [32, 33])
def test_train_logits_and_running_statistics_match_flax(size):
    jm, variables, _ = _pair()
    tm = resnet.ResNet18(num_classes=CLASSES, num_filters=8,
                         dtype=torch.float32, device="cpu")
    tm.load_state_dict(from_jax_resnet(variables))
    x = _images(2, size)
    want, new = jm.apply(variables, jnp.asarray(x), train=True,
                         mutable=["batch_stats"])
    with torch.no_grad():
        got = tm(torch.from_numpy(x), train=True)
    _close(got.numpy(), np.asarray(want))
    stats = from_jax_resnet({"params": variables["params"],
                             "batch_stats": jax.tree.map(
                                 np.asarray, new["batch_stats"])})
    sd = tm.state_dict()
    names = [k for k in stats if k.endswith((".mean", ".var"))]
    assert len(names) == 2 * 20  # ResNet18: 20 norms
    for k in names:
        np.testing.assert_allclose(sd[k].numpy(), stats[k].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
        assert not torch.equal(sd[k], from_jax_resnet(variables)[k])


def test_sgd_step_matches_the_jax_trainer():
    jm, variables, tm0 = _pair()
    tm = resnet.ResNet18(num_classes=CLASSES, num_filters=8,
                         dtype=torch.float32, device="cpu")
    tm.load_state_dict(tm0.state_dict())
    rng = np.random.default_rng(3)
    batch = {"image": _images(3, 32, b=8),
             "label": rng.integers(0, CLASSES, 8).astype(np.int32)}

    def jax_apply(p, b):
        logits = jm.apply({"params": p,
                           "batch_stats": variables["batch_stats"]},
                          b["image"], train=False)
        onehot = jax.nn.one_hot(b["label"], CLASSES)
        return -jnp.mean(jnp.sum(onehot * jax.nn.log_softmax(logits),
                                 axis=-1))

    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("data",))
    jt = JaxTrainer(mesh=mesh, apply_fn=jax_apply,
                    optimizer=optax.sgd(0.1), donate=False)
    step_fn, jstate = jt.build_step(jt.init_state(
        jax.tree.map(jnp.asarray, variables["params"])))
    jstate, jm_ = step_fn(jstate, {k: jnp.asarray(v)
                                   for k, v in batch.items()})

    def apply_fn(model, b):
        logits = model(b["image"], train=False)
        return torch.nn.functional.cross_entropy(logits, b["label"].long())

    trainer = Trainer(tm, apply_fn, functools.partial(torch.optim.SGD,
                                                      lr=0.1))
    state, m = trainer.step(trainer.init_state(),
                            {k: torch.from_numpy(v)
                             for k, v in batch.items()})
    np.testing.assert_allclose(float(m["loss"]), float(jm_["loss"]),
                               rtol=1e-5)
    want = from_jax_resnet({"params": jax.tree.map(np.asarray,
                                                   jstate.params),
                            "batch_stats": variables["batch_stats"]})
    moved = 0
    for name, t in state.params.items():
        np.testing.assert_allclose(t.numpy(), want[name].numpy(),
                                   atol=1e-5, rtol=0, err_msg=name)
        moved += not torch.equal(t, tm0.state_dict()[name])
    assert moved == len(state.params)


@pytest.mark.parametrize("name", ["ResNet18", "ResNet34", "ResNet50"])
def test_parameter_counts_and_names_match_jax(name):
    jm = getattr(jax_resnet, name)(num_classes=1000)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.ones((1, 64, 64, 3)), train=False))
    want = sum(int(np.prod(s.shape)) for s in
               jax.tree.leaves(shapes["params"]))
    tm = getattr(resnet, name)(num_classes=1000, device="meta")
    assert sum(p.numel() for p in tm.parameters()) == want
    if name == "ResNet50":
        assert want == 25_557_032
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    sd = from_jax_resnet(zeros)
    assert set(sd) == set(tm.state_dict())
    assert {k: tuple(v.shape) for k, v in sd.items()} == \
        {k: tuple(v.shape) for k, v in tm.state_dict().items()}


@pytest.mark.parametrize("n,k,s,want", [
    (112, 3, 2, (0, 1)), (7, 3, 2, (1, 1)), (56, 3, 1, (1, 1)),
    (56, 1, 2, (0, 0)), (33, 3, 2, (1, 1))])
def test_same_padding_puts_the_odd_pixel_last(n, k, s, want):
    assert resnet.same_padding(n, k, s) == want


def test_init_zeroes_each_blocks_last_norm():
    tm = resnet.ResNet50(num_classes=10, num_filters=8, device="cpu")
    tm.init_weights(torch.Generator().manual_seed(0))
    for block in tm.blocks:
        assert not block.norms[-1].scale.any()
        assert block.norms[0].scale.eq(1).all()
    with torch.no_grad():
        out = tm(torch.randn(2, 32, 32, 3), train=False)
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
