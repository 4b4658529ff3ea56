"""LoRA fine-tuning in the port (``tony_tpu_torch/train/lora.py``) against
``tony_tpu/train/lora.py`` on the CPU, on the same tiny Qwen2-style base
(``torch_parity.build_pair``) and the same adapters (``lora_init`` in the
JAX package, carried across by ``models.convert.from_jax_lora``).

- Adapter shapes and counts equal the JAX ``lora_init``'s for the
  default targets and the example's (``q, v, o, wi, wo``): A ``[shape[0],
  r]``, B ``[r, *shape[1:]]`` of the JAX kernel, so ``o`` (``[heads, dh,
  d]``) gets A ``[heads, r]``.
- ``merge_lora`` of carried-across adapters (B made non-zero) gives the
  JAX merged logits to rtol 1e-5 (of the largest |logit|); zero-init B
  gives the base's logits bit for bit; the trainer's frozen view computes
  what the merged model computes.
- 20 steps of the port's ``Trainer`` over the adapters (``FusedAdamW``
  with weight decay 0, which is Adam; its plain version on the CPU)
  against the JAX ``Trainer`` with ``optax.adam``: losses within 1e-5
  relative each step, adapters within 1e-4 at the end. The optimizer
  state is LoRA-sized and the base is bit-equal before and after.
- Six steps with remat off and under each policy, one and two
  accumulation steps, weight decay 0 and 0.1 (four cases, ``FusedAdamW``
  in both packages): losses within 1.04e-6 relative (2^-19 with two
  accumulation steps: the rounding argument in the test's docstring),
  adapters within 3.5e-5.
- The captured step (the graph cache's stand-in) equals the eager one
  bit for bit over the adapters.
- ``materialize_lora`` serves through ``generate`` with the JAX
  package's tokens; ``wrap_apply_fn(compute_dtype=bf16)`` hands the
  model bf16 weights (``tests/test_lora.py:135``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_graphs import StandIn
from torch_parity import build_pair, tokens
from tony_tpu.models import generate as jax_generate
from tony_tpu.ops.adamw import FusedAdamW as JaxFusedAdamW
from tony_tpu.train import Trainer as JaxTrainer
from tony_tpu.train import cross_entropy_loss as jax_xent
from tony_tpu.train import lora_init as jax_lora_init
from tony_tpu.train import lora_param_count as jax_lora_count
from tony_tpu.train import materialize_lora as jax_materialize
from tony_tpu.train import merge_lora as jax_merge
from tony_tpu.train import wrap_apply_fn as jax_wrap
from tony_tpu_torch.models import Transformer, generate
from tony_tpu_torch.models.convert import from_jax_lora
from tony_tpu_torch.models.graphs import GraphCache
from tony_tpu_torch.ops.adamw import FusedAdamW
from tony_tpu_torch.train import (DEFAULT_TARGETS, Trainer,
                                  cross_entropy_loss, lora_init,
                                  lora_param_count, materialize_lora,
                                  merge_lora, wrap_apply_fn)

EXAMPLE_TARGETS = ("q", "v", "o", "wi", "wo")
SEQ = 12
ALPHA = 16.0


@pytest.fixture(scope="module")
def pair():
    return build_pair(0)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _jax_lora(jparams, rank, targets, b_scale=0.0, seed=1):
    """A JAX adapter tree; ``b_scale`` > 0 replaces B by seeded normals of
    that scale, so the merge moves the weights."""
    lora = jax_lora_init(jax.random.PRNGKey(seed), {"params": jparams},
                         rank=rank, targets=targets)
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda p, x: jnp.asarray(b_scale * rng.standard_normal(
            x.shape).astype(np.float32)) if b_scale and p[-1].key == "b"
        else x, lora)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _model_like(tm, state_dict):
    m = Transformer(tm.cfg, device="cpu")
    m.load_state_dict(state_dict)
    return m


@pytest.mark.parametrize("targets", [DEFAULT_TARGETS, EXAMPLE_TARGETS],
                         ids=["default", "example"])
@pytest.mark.parametrize("rank", [1, 4])
def test_adapter_shapes_and_counts_match_jax(pair, targets, rank):
    _, jparams, tm = pair
    want = {k: v.shape for k, v in _flat(_np(
        _jax_lora(jparams, rank, targets))).items()}
    got = lora_init(torch.Generator().manual_seed(0), tm, rank=rank,
                    targets=targets)
    assert {n: tuple(p.shape) for n, p in got.named_parameters()} == want
    # the same rule over a JAX-shaped tree
    tree = lora_init(torch.Generator().manual_seed(0),
                     {"params": _np(jparams)}, rank=rank, targets=targets)
    assert {n: tuple(p.shape) for n, p in tree.named_parameters()} == want
    assert lora_param_count(got) == jax_lora_count(
        _jax_lora(jparams, rank, targets))
    if "o" in targets:
        cfg = tm.cfg
        o = got.get_submodule("params.block_0.attn.o.kernel")
        assert tuple(o.a.shape) == (cfg.n_heads, rank)
        assert tuple(o.b.shape) == (rank, cfg.head_dim, cfg.d_model)


def test_init_draws_std_one_over_rank_and_zero_b(pair):
    *_, tm = pair
    lora = lora_init(torch.Generator().manual_seed(0), tm, rank=4,
                     targets=EXAMPLE_TARGETS)
    a = torch.cat([p.flatten() for n, p in lora.named_parameters()
                   if n.endswith(".a")])
    assert abs(a.std().item() - 0.25) < 0.02  # 1/r, not 1/sqrt(r)
    assert all(not p.any() for n, p in lora.named_parameters()
               if n.endswith(".b"))
    with pytest.raises(ValueError, match="no kernels matched"):
        lora_init(torch.Generator(), tm, targets=("nope",))


def test_zero_init_is_exactly_the_base(pair):
    *_, tm = pair
    lora = lora_init(torch.Generator().manual_seed(0), tm, rank=4,
                     targets=EXAMPLE_TARGETS)
    x = torch.from_numpy(tokens(1, (2, SEQ)))
    merged = _model_like(tm, merge_lora(tm, lora, alpha=ALPHA))
    with torch.no_grad():
        assert torch.equal(merged(x), tm(x))


@pytest.mark.parametrize("targets", [DEFAULT_TARGETS, EXAMPLE_TARGETS],
                         ids=["default", "example"])
def test_merge_matches_the_jax_merged_logits(pair, targets):
    jm, jparams, tm = pair
    lora = _jax_lora(jparams, 4, targets, b_scale=0.05)
    x = tokens(2, (2, SEQ))
    want = np.asarray(jm.apply(jax_merge({"params": jparams}, lora,
                                         alpha=ALPHA), jnp.asarray(x)))
    port = from_jax_lora(_np(lora), tm.cfg)
    merged = _model_like(tm, merge_lora(tm, port, alpha=ALPHA))
    with torch.no_grad():
        got = merged(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    assert not np.allclose(want, np.asarray(jm.apply({"params": jparams},
                                                     jnp.asarray(x))))
    # the trainer's path: the frozen view, its weights merged at each read
    seen = {}

    def base_apply(model, batch):
        seen["logits"] = model(batch["tokens"])
        return seen["logits"].sum()

    adapters = lora_init(torch.Generator(), tm, rank=4, targets=targets)
    adapters.load_state_dict(port)
    with torch.no_grad():
        wrap_apply_fn(base_apply, tm, alpha=ALPHA)(
            adapters, {"tokens": torch.from_numpy(x)})
    np.testing.assert_allclose(seen["logits"].numpy(), got, rtol=1e-6,
                               atol=1e-6 * np.abs(want).max())


def _batches(n, b=4, vocab=96):
    out = []
    for i in range(n):
        rng = np.random.default_rng(50 + i)
        mask = (rng.random((b, SEQ)) < 0.6).astype(np.float32)
        out.append({"tokens": tokens(200 + i, (b, SEQ), vocab),
                    "loss_mask": mask})
    return out


def _port_apply(model, batch):
    logits = model(batch["tokens"])
    return cross_entropy_loss(logits[:, :-1], batch["tokens"][:, 1:],
                              mask=batch["loss_mask"][:, 1:])


def _port_trainer(tm, lora, lr):
    return Trainer(lora, wrap_apply_fn(_port_apply, tm, alpha=ALPHA),
                   FusedAdamW(lr, weight_decay=0.0))


def test_training_matches_the_jax_trainer(pair):
    jm, jparams, tm = pair
    lr, steps = 1e-2, 20
    jlora = _jax_lora(jparams, 4, EXAMPLE_TARGETS)
    batches = _batches(steps)

    def base_apply(p, b):
        logits = jm.apply(p, b["tokens"])
        return jax_xent(logits[:, :-1], b["tokens"][:, 1:],
                        mask=b["loss_mask"][:, 1:])

    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("data",))
    jt = JaxTrainer(mesh=mesh, apply_fn=jax_wrap(
        base_apply, {"params": jparams}, alpha=ALPHA),
        optimizer=optax.adam(lr), donate=False)
    step_fn, jstate = jt.build_step(jt.init_state(jlora))
    jlosses = []
    for b in batches:
        jstate, m = step_fn(jstate, {k: jnp.asarray(v)
                                     for k, v in b.items()})
        jlosses.append(float(m["loss"]))

    before = {k: v.clone() for k, v in tm.state_dict().items()}
    lora = lora_init(torch.Generator(), tm, rank=4,
                     targets=EXAMPLE_TARGETS)
    trainer = _port_trainer(tm, lora, lr)
    state = trainer.init_state(from_jax_lora(_np(jlora), tm.cfg))
    losses = []
    for b in batches:
        state, m = trainer.step(state, {k: torch.from_numpy(v)
                                        for k, v in b.items()})
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    assert losses[-1] < losses[0] - 0.1
    want = from_jax_lora(_np(jstate.params), tm.cfg)
    assert set(state.params) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(state.params[name].numpy(), w.numpy(),
                                   atol=1e-4, rtol=0, err_msg=name)
    # optimizer state for the adapters alone; the base untouched
    opt = state.opt_state
    n = lora_param_count(lora)
    assert sum(t.numel() for t in [*opt.mu.values(), *opt.nu.values()]) \
        == 2 * n < sum(t.numel() for t in tm.parameters())
    for k, v in tm.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_captured_step_equals_the_eager_step(pair):
    """The step through the graph cache's stand-in capture (one capture,
    then replays over static buffers) gives the eager step's bits."""
    *_, tm = pair
    batches = _batches(4)
    out = {}
    for how in ("eager", "captured"):
        lora = lora_init(torch.Generator().manual_seed(3), tm, rank=4,
                         targets=EXAMPLE_TARGETS)
        trainer = _port_trainer(tm, lora, 1e-2)
        if how == "captured":
            trainer.graphs = GraphCache("cpu", StandIn())
        state = trainer.init_state()
        losses = []
        for b in batches:
            state, m = trainer.step(state, {k: torch.from_numpy(v)
                                            for k, v in b.items()})
            losses.append(m["loss"].clone())
        out[how] = (torch.stack(losses), state.params)
        if how == "captured":
            calls = [trainer.graphs.calls["train_step", w]
                     for w in ("captures", "replays")]
            assert calls == [1, 3]
    assert torch.equal(out["eager"][0], out["captured"][0])
    for name, t in out["eager"][1].items():
        assert torch.equal(t, out["captured"][1][name]), name


def test_materialized_model_generates_the_jax_tokens(pair):
    jm, jparams, tm = pair
    lora = _jax_lora(jparams, 4, EXAMPLE_TARGETS, b_scale=0.05)
    prompt = tokens(4, (2, 6))
    served = jax_materialize({"params": jparams}, lora, alpha=ALPHA)
    want = np.asarray(jax_generate(jm, served["params"],
                                   jnp.asarray(prompt), max_new_tokens=8))
    port = _model_like(tm, materialize_lora(
        tm, from_jax_lora(_np(lora), tm.cfg), alpha=ALPHA))
    got = generate(port, torch.from_numpy(prompt), max_new_tokens=8)
    np.testing.assert_array_equal(got.numpy(), want)
    base = np.asarray(jax_generate(jm, jparams, jnp.asarray(prompt),
                                   max_new_tokens=8))
    assert not np.array_equal(base, want)  # the adapters moved the tokens


def test_wrap_apply_fn_compute_dtype_casts_the_base(pair):
    *_, tm = pair
    lora = lora_init(torch.Generator().manual_seed(5), tm, rank=2)
    seen = {}

    def base_apply(model, batch):
        seen["dtype"] = model.blocks[0].attn.q.weight.dtype
        seen["k"] = model.blocks[0].attn.k.weight.dtype
        return torch.zeros(())

    wrap_apply_fn(base_apply, tm, compute_dtype=torch.bfloat16)(lora, {})
    assert seen == {"dtype": torch.bfloat16, "k": torch.bfloat16}
    wrap_apply_fn(base_apply, tm)(lora, {})
    assert seen == {"dtype": torch.float32, "k": torch.float32}
    assert all(p.dtype == torch.float32 for p in tm.parameters())


@pytest.mark.parametrize("remat,accum,wd", [
    ("off", 1, 0.0), ("nothing", 2, 0.1), ("dots", 1, 0.1),
    ("attn_saved", 2, 0.0)])
def test_training_under_remat_accum_and_decay_matches_jax(remat, accum, wd):
    """Six steps over the example's adapters at rank 4 on the base of
    ``build_pair(0)``: remat off and under each policy, one and two
    accumulation steps, weight decay 0 and 0.1, each value in two of the
    four cases (``FusedAdamW`` in both packages): losses within 1.04e-6
    relative each step (2^-19 with two accumulation steps, below) and
    the adapters within 3.5e-5 at the end.

    Both packages accumulate alike: micro-batch i takes rows i, i +
    accum, ...; losses and gradients add into zeroed fp32 sums in
    micro-batch order and are scaled by 1/accum after the last. What
    differs is rounding. fp32 rounds to u = 2^-24 relative, and the two
    packages sum each gradient element in their own order: over the
    batch's rows and, with two accumulation steps, over two micro-batch
    gradients that partly cancel, so the elements may disagree by
    several ulps. AdamW divides each element by its own running RMS:
    the update keeps the relative disagreement at full size whatever
    the gradient's magnitude, and the adapters carry it into every later
    step. ``tests/torch_lora_probe.py`` measures that carry on this
    model: every gradient element moved by +-u at every step moves the
    six losses by at most about 4 u. Eight ulps of disagreement a
    element then allow 32 u = 2^-19 relative in the loss."""
    kw = {} if remat == "off" else dict(remat=True, remat_policy=remat)
    jm, jparams, tm = build_pair(0, **kw)
    lr, steps = 1e-2, 6
    jlora = _jax_lora(jparams, 4, EXAMPLE_TARGETS)
    batches = _batches(steps)

    def base_apply(p, b):
        logits = jm.apply(p, b["tokens"])
        return jax_xent(logits[:, :-1], b["tokens"][:, 1:],
                        mask=b["loss_mask"][:, 1:])

    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("data",))
    jt = JaxTrainer(mesh=mesh, apply_fn=jax_wrap(
        base_apply, {"params": jparams}, alpha=ALPHA),
        optimizer=JaxFusedAdamW(lr, weight_decay=wd), donate=False,
        accum_steps=accum)
    step_fn, jstate = jt.build_step(jt.init_state(jlora))
    jlosses = []
    for b in batches:
        jstate, m = step_fn(jstate, {k: jnp.asarray(v)
                                     for k, v in b.items()})
        jlosses.append(float(m["loss"]))

    lora = lora_init(torch.Generator(), tm, rank=4, targets=EXAMPLE_TARGETS)
    trainer = Trainer(lora, wrap_apply_fn(_port_apply, tm, alpha=ALPHA),
                      FusedAdamW(lr, weight_decay=wd), accum_steps=accum)
    state = trainer.init_state(from_jax_lora(_np(jlora), tm.cfg))
    losses = []
    for b in batches:
        state, m = trainer.step(state, {k: torch.from_numpy(v)
                                        for k, v in b.items()})
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(losses, jlosses,
                               rtol=2.0 ** -19 if accum == 2 else 1.04e-6,
                               atol=0)
    for name, w in from_jax_lora(_np(jstate.params), tm.cfg).items():
        np.testing.assert_allclose(state.params[name].numpy(), w.numpy(),
                                   atol=3.5e-5, rtol=0, err_msg=name)
