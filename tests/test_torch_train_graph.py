"""The training step captured whole (``Trainer.step`` through the graph
cache) on the CPU, with ``tests/test_torch_graphs.py``'s stand-in for
``torch.cuda.CUDAGraph`` (its capture under the host-read guard), held
against the JAX ``Trainer`` and against the port's eager step.

- The captured step against ``tony_tpu/train/trainer.py``: QWEN_TINY
  with the pallas attention backend and remat (``attn_saved``), chunked
  cross-entropy, ``FusedAdamW`` with a warmup schedule written as a
  tensor function of ``count`` (``optax``-style in the JAX package),
  compute dtype fp32 and bf16, ``accum_steps`` 1 and 2, 4 steps: one
  capture, three replays; losses and masters to the tolerances of
  ``tests/test_torch_train.py`` (fp32: 1e-5 on losses, 2e-5 on params;
  bf16: 2e-2 relative on losses, 15% on the norm of the difference of
  the total updates), and bit-equal to the eager step.
- A schedule that returns a Python number is refused when the step is
  captured; one that reads ``count`` on the host fails the capture's
  guard; a ``torch.optim`` optimizer without ``capturable`` runs the step
  eagerly, counted.
- ``fit``'s history through the captured step (``log_every=1``, metrics
  read a step late) equals the eager ``fit``'s step for step.
- A state restored from a checkpoint is a new key (the old graph is
  dropped), and replays over it equal the eager path from the same
  checkpoint.
- The training step draws no randomness: the CPU generator's state is
  the same before and after a step with remat on (``torch.utils.
  checkpoint`` runs with ``preserve_rng_state=False``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_graphs import HostRead, StandIn
from test_torch_train import (LR, _apply, _batches, _close_params,
                              _close_updates, _pair)
from tony_tpu.ops.adamw import FusedAdamW as JaxFusedAdamW
from tony_tpu.ops.xent import chunked_cross_entropy as jax_xent
from tony_tpu.train import Trainer as JaxTrainer
from tony_tpu_torch.data import ArraySource, DataLoader
from tony_tpu_torch.models.convert import from_jax_params
from tony_tpu_torch.models.graphs import GraphCache
from tony_tpu_torch.ops.adamw import FusedAdamW
from tony_tpu_torch.train import CheckpointManager, Trainer, fit

WARMUP = 3.0
REMAT = dict(remat=True, remat_policy="attn_saved")


def _warmup(count):
    """lr ramps over WARMUP steps, then holds: a tensor of ``count``."""
    return LR * torch.clamp((count + 1).float() / WARMUP, max=1.0)


def _jax_warmup(count):
    return LR * jnp.minimum((count + 1) / WARMUP, 1.0)


def _jax_trainer(jm, cdt, accum):
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("data",))

    def apply_fn(p, batch):
        hidden = jm.apply(p, batch["tokens"], return_hidden=True)
        return jax_xent(hidden[:, :-1], p["params"]["embedding"],
                        batch["tokens"][:, 1:], chunk_size=40,
                        compute_dtype=cdt)

    return JaxTrainer(mesh=mesh, apply_fn=apply_fn,
                      optimizer=JaxFusedAdamW(_jax_warmup), donate=False,
                      compute_dtype=cdt, accum_steps=accum)


def _captured(trainer):
    trainer.graphs = GraphCache("cpu", StandIn())
    return trainer


def _steps(trainer, state, batches):
    losses = []
    for x in batches:
        state, m = trainer.step(state, {"tokens": torch.from_numpy(x)})
        losses.append(float(m["loss"]))
    return state, losses


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
def test_captured_step_matches_jax_and_eager(bf16, accum):
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if bf16 \
        else (jnp.float32, torch.float32)
    jm, jparams, tm = _pair(jdt, tdt, **REMAT)
    batches = _batches(4)
    jtr = _jax_trainer(jm, jdt if bf16 else None, accum)
    step_fn, jstate = jtr.build_step(jtr.init_state({"params": jparams}))
    jl = []
    for x in batches:
        jstate, m = step_fn(jstate, {"tokens": jnp.asarray(x, jnp.int32)})
        jl.append(float(m["loss"]))
    start = from_jax_params(jax.tree.map(np.asarray, jparams), tm.cfg)
    runs = []
    for capture in (True, False):
        tr = Trainer(tm, _apply(tdt if bf16 else None),
                     FusedAdamW(_warmup), compute_dtype=tdt if bf16 else None,
                     accum_steps=accum)
        if capture:
            _captured(tr)
        state, losses = _steps(tr, tr.init_state(start), batches)
        runs.append((state, losses))
        if capture:
            c = tr.graphs.counters(("train_step",))
            assert (c["train_step_captures"], c["train_step_replays"],
                    c["train_step_eager"]) == (1, 3, 0)
            assert int(state.opt_state.count) == 4 and state.step == 4
    (state, tl), (eager, el) = runs
    assert tl == el
    for name, p in state.params.items():
        assert torch.equal(p, eager.params[name]), name
    if bf16:
        np.testing.assert_allclose(tl, jl, rtol=2e-2)
        _close_updates(jstate.params, state.params, start, tm.cfg, 0.15)
    else:
        np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-5)
        _close_params(jstate.params, state.params, tm.cfg, 2e-5)


def test_host_schedules_are_refused_when_captured():
    _, _, tm = _pair(**REMAT)
    batch = {"tokens": torch.from_numpy(_batches(1)[0])}

    def host_float(count):
        return LR * min(1.0, (int(count) + 1) / WARMUP)

    tr = _captured(Trainer(tm, _apply(None), FusedAdamW(host_float)))
    with pytest.raises(ValueError, match="schedule returned a Python"):
        tr.step(tr.init_state(), batch)
    assert tr.graphs.entries == {}

    def host_read(count):
        return torch.tensor(LR * min(1.0, (int(count) + 1) / WARMUP))

    tr = _captured(Trainer(tm, _apply(None), FusedAdamW(host_read)))
    with pytest.raises(HostRead):
        tr.step(tr.init_state(), batch)


def test_torch_optim_without_capturable_runs_eagerly():
    _, _, tm = _pair()
    tr = _captured(Trainer(tm, _apply(None), functools.partial(
        torch.optim.AdamW, lr=LR, weight_decay=1e-4)))
    _steps(tr, tr.init_state(), _batches(2))
    c = tr.graphs.counters(("train_step",))
    assert (c["train_step_captures"], c["train_step_replays"],
            c["train_step_eager"]) == (0, 0, 2)


def _loader(n_steps):
    data = np.concatenate(_batches(n_steps))
    return DataLoader(ArraySource({"tokens": data}), global_batch_size=4,
                      seed=1, num_epochs=1, process_index=0,
                      process_count=1, device="cpu")


def test_fit_history_through_the_captured_step():
    """Metrics are read a step late (``fit`` defers the fetch): a metric
    left in the graph's output would read the next replay's loss."""
    hist = []
    for capture in (True, False):
        _, _, tm = _pair(**REMAT)
        tr = Trainer(tm, _apply(None), FusedAdamW(_warmup), accum_steps=2,
                     log_grad_norm=True)
        if capture:
            _captured(tr)
        res = fit(tr, None, _loader(5), log_every=1)
        hist.append([{k: v for k, v in h.items() if k != "steps_per_sec"}
                     for h in res.history])
        if capture:
            assert tr.graphs.calls["train_step", "replays"] == 4
    assert len(hist[0]) == 5
    assert len({h["loss"] for h in hist[0]}) == 5
    assert hist[0] == hist[1]


def test_restored_checkpoint_is_a_new_key(tmp_path):
    _, _, tm = _pair()
    batches = _batches(4)
    tr = _captured(Trainer(tm, _apply(None), FusedAdamW(_warmup)))
    state, _ = _steps(tr, tr.init_state(), batches[:2])
    CheckpointManager(str(tmp_path)).save(state.step, state)
    first = next(iter(tr.graphs.entries))
    restored = tr.place(CheckpointManager(str(tmp_path)).restore())
    got, gl = _steps(tr, restored, batches[2:])
    assert tr.graphs.calls["train_step", "captures"] == 2
    assert list(tr.graphs.entries) != [first] and len(tr.graphs.entries) == 1
    eager_tr = Trainer(tm, _apply(None), FusedAdamW(_warmup))
    want, wl = _steps(eager_tr, eager_tr.place(
        CheckpointManager(str(tmp_path)).restore()), batches[2:])
    assert gl == wl
    for name, p in got.params.items():
        assert torch.equal(p, want.params[name]), name
    assert int(got.opt_state.count) == 4


def test_training_step_draws_no_randomness():
    _, _, tm = _pair(**REMAT)
    tr = Trainer(tm, _apply(None), FusedAdamW(LR))
    state = tr.init_state()
    before = torch.get_rng_state()
    tr.step(state, {"tokens": torch.from_numpy(_batches(1)[0])})
    assert torch.equal(torch.get_rng_state(), before)
