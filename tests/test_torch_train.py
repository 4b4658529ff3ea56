"""The port's training path against the JAX package on the CPU: the
``Trainer`` on QWEN_TINY with the pallas attention backend (the JAX
kernels in interpret mode, the port's plain versions), chunked
cross-entropy and FusedAdamW, on the same converted weights and the same
numpy batches; then ``fit`` (step caps, checkpoint resume, eval, EMA),
mirroring ``tests/test_fit.py``.

Tolerances: fp32 steps agree to 2e-5 on params and 1e-5 on losses
(reordered fp32 sums; Adam divides each gradient by its own magnitude,
so a parameter moves by about lr a step whatever the gradient's
rounding). The bf16 carry rounds every product's operands to bf16 at
slightly different points in the two frameworks, and Adam turns the
rounding of a near-zero gradient into a step of about lr either way: it
is held to 2e-2 on the loss trajectory and to 15% on the norm of the
difference of the two runs' total updates, against the update's norm.
That is the size of bf16 rounding itself here: the JAX package's own
fp32 and bf16-carry runs of the same 3 steps differ by 8.4%, and the
port's bf16 run differs from the JAX bf16 run by 8.3%.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torch_parity import build_pair, tokens
from tony_tpu.ops.adamw import FusedAdamW as JaxFusedAdamW
from tony_tpu.ops.xent import chunked_cross_entropy as jax_xent
from tony_tpu.train import Trainer as JaxTrainer
from tony_tpu_torch.data import ArraySource, DataLoader
from tony_tpu_torch.models.convert import (from_jax_params,
                                           from_jax_train_state)
from tony_tpu_torch.ops.adamw import FusedAdamW
from tony_tpu_torch.ops.xent import chunked_cross_entropy
from tony_tpu_torch.train import (JsonlMetricsLogger, Trainer,
                                  build_train_step, cross_entropy_loss, fit)

SEQ = 17
LR = 1e-3


def _pair(jax_dtype=jnp.float32, torch_dtype=torch.float32, **kw):
    return build_pair(0, jax_dtype=jax_dtype, torch_dtype=torch_dtype,
                      attention_backend="pallas", attention_block_size=8,
                      **kw)


def _jax_trainer(jm, cdt=None, accum=1):
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("data",))

    def apply_fn(p, batch):
        hidden = jm.apply(p, batch["tokens"], return_hidden=True)
        return jax_xent(hidden[:, :-1], p["params"]["embedding"],
                        batch["tokens"][:, 1:], chunk_size=40,
                        compute_dtype=cdt)

    return JaxTrainer(mesh=mesh, apply_fn=apply_fn,
                      optimizer=JaxFusedAdamW(LR), donate=False,
                      compute_dtype=cdt, accum_steps=accum)


def _apply(cdt):
    def apply_fn(model, batch):
        hidden = model(batch["tokens"], return_hidden=True)
        return chunked_cross_entropy(hidden[:, :-1], model.embedding,
                                     batch["tokens"][:, 1:], chunk_size=40,
                                     compute_dtype=cdt)

    return apply_fn


def _batches(n, b=4):
    return [tokens(100 + i, (b, SEQ)) for i in range(n)]


def _run_jax(trainer, params, batches, state=None):
    step_fn, placed = trainer.build_step(
        state if state is not None else trainer.init_state(
            {"params": params}))
    losses = []
    for x in batches:
        placed, m = step_fn(placed, {"tokens": jnp.asarray(x, jnp.int32)})
        losses.append(float(m["loss"]))
    return placed, losses


def _run_torch(trainer, batches, state):
    step_fn, placed = trainer.build_step(state)
    losses = []
    for x in batches:
        placed, m = step_fn(placed, {"tokens": torch.from_numpy(x)})
        losses.append(float(m["loss"]))
    return placed, losses


def _close_params(jparams, tparams, cfg, atol):
    want = from_jax_params(jax.tree.map(np.asarray, jparams), cfg)
    for name, w in want.items():
        np.testing.assert_allclose(tparams[name].float().numpy(),
                                   w.numpy(), atol=atol, rtol=0,
                                   err_msg=name)


def _close_updates(jparams, tparams, start, cfg, rel):
    """The two runs' total parameter updates (params - start) agree in
    norm to ``rel`` of the update's own norm."""
    want = from_jax_params(jax.tree.map(np.asarray, jparams), cfg)
    num = den = 0.0
    for name, w in want.items():
        dw = w - start[name]
        num += float(((tparams[name] - start[name]) - dw).norm() ** 2)
        den += float(dw.norm() ** 2)
    assert num ** 0.5 <= rel * den ** 0.5, (num ** 0.5, den ** 0.5)


@pytest.mark.parametrize("accum", [1, 2])
def test_trainer_fp32_matches_jax(accum):
    jm, jparams, tm = _pair()
    batches = _batches(3)
    jstate, jl = _run_jax(_jax_trainer(jm, accum=accum), jparams, batches)
    tr = Trainer(tm, _apply(None), FusedAdamW(LR), accum_steps=accum)
    tstate, tl = _run_torch(tr, batches, tr.init_state())
    np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-5)
    _close_params(jstate.params, tstate.params, tm.cfg, 2e-5)
    assert tstate.step == 3
    assert int(tstate.opt_state.count) == 3


def test_trainer_bf16_carry_matches_jax():
    jm, jparams, tm = _pair(jnp.bfloat16, torch.bfloat16)
    batches = _batches(3)
    jstate, jl = _run_jax(_jax_trainer(jm, cdt=jnp.bfloat16), jparams,
                          batches)
    tr = Trainer(tm, _apply(torch.bfloat16), FusedAdamW(LR),
                 compute_dtype=torch.bfloat16)
    # the fp32 weights as masters (the bf16 module holds rounded ones)
    start = from_jax_params(jax.tree.map(np.asarray, jparams), tm.cfg)
    tstate, tl = _run_torch(tr, batches, tr.init_state(start))
    np.testing.assert_allclose(tl, jl, rtol=2e-2)
    _close_updates(jstate.params, tstate.params, start, tm.cfg, 0.15)
    # fp32 masters and moments; the module holds the bf16 copy that the
    # update wrote, equal to the cast of the master
    for name, p in tm.named_parameters():
        m = tstate.params[name]
        assert m.dtype == torch.float32 and p.dtype == torch.bfloat16
        assert torch.equal(p.data, m.to(torch.bfloat16)), name
        assert p.data_ptr() == \
            tstate.opt_state.compute_params[name].data_ptr()
        assert tstate.opt_state.mu[name].dtype == torch.float32


@pytest.mark.parametrize("policy", ["nothing", "dots", "attn_saved"])
def test_remat_changes_no_bit(policy):
    batches = _batches(2)
    runs = []
    for remat in (False, True):
        _, _, tm = _pair(remat=remat, remat_policy=policy)
        tr = Trainer(tm, _apply(None), FusedAdamW(LR), log_grad_norm=True)
        state, losses = _run_torch(tr, batches, tr.init_state())
        runs.append((losses, state.params))
    assert runs[0][0] == runs[1][0]
    for name, p in runs[0][1].items():
        assert torch.equal(p, runs[1][1][name]), name


def test_resume_from_jax_train_state():
    """Both packages continue from the same non-zero JAX state."""
    jm, jparams, tm = _pair(jnp.bfloat16, torch.bfloat16)
    jtr = _jax_trainer(jm, cdt=jnp.bfloat16)
    first, rest = _batches(2), _batches(4)[2:]
    jstate, _ = _run_jax(jtr, jparams, first)
    jfinal, jl = _run_jax(jtr, None, rest, state=jstate)
    tstate0 = from_jax_train_state(jax.tree.map(np.asarray, jstate),
                                   tm.cfg)
    assert tstate0.step == 2 and int(tstate0.opt_state.count) == 2
    tr = Trainer(tm, _apply(torch.bfloat16), FusedAdamW(LR),
                 compute_dtype=torch.bfloat16)
    start = {n: t.clone() for n, t in tstate0.params.items()}
    tfinal, tl = _run_torch(tr, rest, tstate0)
    assert tfinal.step == 4
    np.testing.assert_allclose(tl, jl, rtol=2e-2)
    _close_updates(jfinal.params, tfinal.params, start, tm.cfg, 0.15)


def test_torch_optim_stands_for_optax():
    jm, jparams, tm = _pair()
    batches = _batches(3)
    jtr = dataclasses.replace(_jax_trainer(jm),
                              optimizer=optax.adamw(LR, weight_decay=1e-4))
    jstate, jl = _run_jax(jtr, jparams, batches)
    tr = Trainer(tm, _apply(None), functools.partial(
        torch.optim.AdamW, lr=LR, weight_decay=1e-4))
    tstate, tl = _run_torch(tr, batches, tr.init_state())
    np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-5)
    _close_params(jstate.params, tstate.params, tm.cfg, 2e-5)


def test_trainer_refuses_what_is_not_ported():
    """What stays refused once fsdp and batch_shardings are ported: a
    batch sharding past the batch dim (sequence parallelism) and a mesh
    whose tensor, pipe, seq or expert axis is above 1, both naming
    ROADMAP.md's item 5; and a batch that the accumulation cannot
    split."""
    from tony_tpu_torch.parallel import MeshSpec, make_mesh
    from tony_tpu_torch.parallel.sharding import NamedSharding, P

    _, _, tm = _pair()
    one = make_mesh(MeshSpec(), device_type="cpu")
    with pytest.raises(NotImplementedError, match="item 5.*Ulysses"):
        Trainer(tm, _apply(None), FusedAdamW(LR), mesh=one,
                batch_shardings=NamedSharding(one, P("data", "seq")))
    with pytest.raises(NotImplementedError, match="item 5.*Ulysses"):
        Trainer(tm, _apply(None), FusedAdamW(LR), mesh=one,
                batch_shardings={"tokens": NamedSharding(
                    one, P(None, ("data",)))})
    for axis in ("tensor", "pipe", "seq", "expert"):
        mesh = make_mesh(MeshSpec(data=1, **{axis: 2}), devices=[0, 1],
                         device_type="cpu")
        with pytest.raises(NotImplementedError, match=f"{axis}.*item 5"):
            Trainer(tm, _apply(None), FusedAdamW(LR), mesh=mesh)
    # what no longer raises: fsdp, a batch-dim sharding, a mesh of one
    tr = Trainer(tm, _apply(None), FusedAdamW(LR), fsdp=True, mesh=one,
                 batch_shardings=NamedSharding(one, P(("data", "fsdp"))))
    assert tr.ranks == 1 and not tr.distributed
    tr = Trainer(tm, _apply(None), FusedAdamW(LR), accum_steps=3)
    with pytest.raises(ValueError, match="not divisible"):
        tr.step(tr.init_state(), {"tokens": torch.from_numpy(
            tokens(0, (4, SEQ)))})


def test_cross_entropy_loss_matches_jax():
    from tony_tpu.train import cross_entropy_loss as jax_ce

    rng = np.random.default_rng(0)
    logits = rng.standard_normal((3, 5, 11)).astype(np.float32)
    labels = rng.integers(0, 11, (3, 5))
    mask = rng.integers(0, 2, (3, 5)).astype(np.float32)
    for m in (None, mask):
        want = float(jax_ce(jnp.asarray(logits), jnp.asarray(labels),
                            None if m is None else jnp.asarray(m)))
        got = float(cross_entropy_loss(
            torch.from_numpy(logits), torch.from_numpy(labels),
            None if m is None else torch.from_numpy(m)))
        assert abs(got - want) < 1e-6


# ------------------------------------------------------------------- fit
# a linear regression, as tests/test_fit.py drives the JAX loop


def _setup(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((64, 4)).astype(np.float32)
    w_true = np.array([[1.0], [-2.0], [0.5], [3.0]], np.float32)
    y = (x @ w_true)[:, 0] + 0.01 * rng.standard_normal(64).astype(
        np.float32)
    model = torch.nn.Linear(4, 1, bias=False)
    torch.nn.init.zeros_(model.weight)

    def apply_fn(m, batch):
        return ((m(batch["x"])[:, 0] - batch["y"]) ** 2).mean()

    trainer = Trainer(model, apply_fn,
                      functools.partial(torch.optim.Adam, lr=0.05))

    def loader(epochs):
        return DataLoader(ArraySource({"x": x, "y": y}),
                          global_batch_size=16, seed=1, num_epochs=epochs,
                          process_index=0, process_count=1, device="cpu")

    return trainer, loader


def test_fit_trains_logs_and_caps(tmp_path):
    trainer, loader = _setup()
    sink = tmp_path / "metrics.jsonl"
    result = fit(trainer, None, loader(10), log_every=5,
                 metric_sinks=[JsonlMetricsLogger(str(sink))])
    assert result.steps_run == 40 and result.resumed_from is None
    assert result.history[-1]["loss"] < result.history[0]["loss"]
    first = sink.read_text().splitlines()[0]
    assert '"step": 5' in first and "steps_per_sec" in first
    trainer, loader = _setup()
    result = fit(trainer, None, loader(None), num_steps=7, log_every=0)
    assert result.steps_run == 7 and result.state.step == 7


def test_fit_checkpoint_resume_completes_total_steps(tmp_path):
    trainer, loader = _setup()
    ck = str(tmp_path / "ck")
    first = fit(trainer, None, loader(None), total_steps=6,
                checkpoint_dir=ck, checkpoint_every=2, log_every=0)
    assert first.steps_run == 6
    trainer2, loader2 = _setup()
    again = fit(trainer2, None, loader2(None), total_steps=10,
                checkpoint_dir=ck, log_every=0)
    assert again.resumed_from == 6 and again.steps_run == 4
    assert again.state.step == 10
    # the same 10 steps in one run give the same weights
    trainer3, loader3 = _setup()
    whole = fit(trainer3, None, loader3(None), num_steps=10, log_every=0)
    for name, p in whole.state.params.items():
        torch.testing.assert_close(again.state.params[name], p, rtol=0,
                                   atol=1e-6)
    from tony_tpu_torch.train import CheckpointManager

    assert CheckpointManager(ck).steps() == [4, 6, 10]  # max_to_keep 3


def test_fit_eval_and_ema():
    trainer, loader = _setup()

    def eval_fn(m, batch):
        return ((m(batch["x"])[:, 0] - batch["y"]) ** 2).mean()

    result = fit(trainer, None, loader(4), log_every=0,
                 eval_data=list(loader(1)), eval_fn=eval_fn, eval_every=8,
                 ema_decay=0.8)
    evals = [h for h in result.history if "eval/loss" in h]
    assert len(evals) == 2 and evals[-1]["eval/loss"] < evals[0]["eval/loss"]
    # replay the same deterministic run by hand for the EMA's math
    trainer2, loader2 = _setup()
    step_fn, state = build_train_step(trainer2.model, trainer2.apply_fn,
                                      trainer2.optimizer)
    ema = state.params["weight"].clone()
    for batch in loader2(4):
        state, _ = step_fn(state, batch)
        ema = 0.8 * ema + (1 - 0.8) * state.params["weight"]
    torch.testing.assert_close(result.ema_params["weight"], ema,
                               rtol=1e-6, atol=1e-6)
    assert fit(trainer2, None, loader2(1), log_every=0).ema_params is None


def test_fit_closes_the_loader_on_early_exit():
    import threading

    trainer, loader = _setup()
    before = threading.active_count()
    fit(trainer, None, loader(None), num_steps=3, log_every=0)
    for _ in range(50):
        if threading.active_count() <= before:
            break
        import time

        time.sleep(0.02)
    assert threading.active_count() <= before


def test_cpu_training_never_launches_a_kernel():
    from tony_tpu_torch.ops import adamw, attention

    _, _, tm = _pair()
    attention.flash_attention_fwd.launches = 0
    adamw.fused_adamw_update.launches = 0
    tr = Trainer(tm, _apply(None), FusedAdamW(LR))
    _run_torch(tr, _batches(1), tr.init_state())
    assert attention.flash_attention_fwd.launches == 0
    assert attention.flash_attention_bwd_dq.launches == 0
    assert attention.flash_attention_bwd_dkv.launches == 0
    assert adamw.fused_adamw_update.launches == 0

