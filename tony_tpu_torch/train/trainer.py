"""The train step: the counterpart of ``tony_tpu/train/trainer.py`` on one
device.

``Trainer`` keeps fp32 master params in ``TrainState`` and runs the
module in ``compute_dtype``: the loss comes out in fp32, ``accum_steps``
splits the batch by the same strided rule as the JAX package (row i goes
to micro-batch i % accum), gradients accumulate in fp32, and one update
follows. ``FusedAdamW`` selects the fused kernel; any other optimizer is
a callable that builds a ``torch.optim.Optimizer`` over a list of
tensors (``functools.partial(torch.optim.AdamW, lr=...)``), standing
where the JAX package takes an optax transformation.

How the module and the master copy stay in step. The port's module
stores dense weights at ``cfg.dtype``, so the masters live outside it,
in ``TrainState.params`` (fp32, keyed as ``model.state_dict()``). Each
module parameter is then either the master itself (the same storage,
when its dtype is fp32 and no compute dtype is set: an in-place update
of the master is the update of the module), or a copy in the compute
dtype (``compute_dtype`` when set, else the parameter's own dtype). The
fused kernel writes that copy in the same pass as the master (the JAX
compute-dtype carry, with the copy written straight into the module's
parameters, which ``FusedAdamWState.compute_params`` then holds); after
a ``torch.optim`` step the trainer copies the masters into them.

One step, one graph. The JAX package jits the whole step; on the card
the port captures it whole as a CUDA graph (``models.graphs``) and
replays it: forward, backward (remat included), accumulation and the
optimizer update, with the flash attention kernels and fused AdamW
launching inside. The key is the batch's shapes and dtypes,
``accum_steps`` and the identity (data pointers) of every tensor of the
state and the module, so a state that ``place()`` rebuilt (a restored
checkpoint) is a new key, and the graph of a state it replaces is
dropped. The batch is copied into static buffers; the gradients go
into static buffers too (the fp32 accumulators, zeroed inside the
graph; with one micro-batch, buffers of the gradients' own dtype),
which keeps fused AdamW's device table (``ops.adamw``, keyed by those
pointers) the one the first call built. Gradients are taken with
``torch.autograd.grad`` on every path, captured or eager, so the two
give the same bits. The update happens in place (``count`` advances
in place), so the state a step returns holds the tensors it was given.
A step's metrics come back as device copies of the graph's output,
which the next replay overwrites. The first call at a key runs eagerly
on the graph cache's side stream and is then captured; a learning-rate
schedule must return a tensor computed from ``count`` on the device
(a Python float is refused there, not baked in). A ``torch.optim``
optimizer built with ``capturable=True`` runs inside the graph too;
any other runs the step eagerly, counted as a ``train_step`` eager
call. On the CPU every step runs eagerly.

Not ported (single device): ``fsdp`` and ``batch_shardings`` raise.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch
from torch import nn

from tony_tpu_torch.models.graphs import GraphCache
from tony_tpu_torch.ops.adamw import (FusedAdamW, FusedAdamWState,
                                     fused_adamw_update)


@dataclass
class TrainState:
    step: int
    params: dict  # name -> fp32 master tensor
    # FusedAdamWState, a torch.optim.Optimizer over the masters, or (as
    # read from a checkpoint) that optimizer's state_dict; None = fresh
    opt_state: Any = None


def cross_entropy_loss(logits, labels, mask=None):
    """logits [..., V], labels [...] int; ``mask`` (shaped like labels, 0/1
    or bool) drops positions from the mean."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = logp.gather(-1, labels.long()[..., None])[..., 0]
    if mask is None:
        return -ll.mean()
    mask = mask.float()
    return -(ll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


@dataclass
class Trainer:
    """One-device train step over ``model``.

    ``apply_fn(model, batch) -> loss`` (a scalar); the model's parameters
    hold the compute copy of the masters while it runs."""

    model: nn.Module
    apply_fn: Callable[[nn.Module, Any], torch.Tensor]
    optimizer: Any
    fsdp: bool = False
    # mixed precision: fp32 masters and optimizer state, forward and
    # backward in this dtype (every float parameter and float batch leaf
    # is cast to it), fp32 loss
    compute_dtype: Any = None
    # gradient accumulation: the batch's leading dim is split into this
    # many strided micro-batches, gradients are averaged in fp32 and ONE
    # update follows
    accum_steps: int = 1
    # opt-in telemetry: the global gradient norm re-reads every grad
    log_grad_norm: bool = False
    batch_shardings: Any = None

    def __post_init__(self):
        if self.fsdp:
            raise NotImplementedError("fsdp is not ported yet (single "
                                      "device; see ROADMAP.md)")
        if self.batch_shardings is not None:
            raise NotImplementedError("batch_shardings is not ported yet "
                                      "(single device; see ROADMAP.md)")
        if getattr(getattr(self.model, "cfg", None), "quantized", False):
            raise ValueError(
                "an int8 weight-only model (cfg.quantized) is for "
                "generation and scoring: int8 weights have no useful "
                "gradients. Train the float model, then convert it with "
                "models.quantize_for_serving")
        # the dtype each parameter is stored in when no compute dtype
        # overrides it (taken once: wiring changes it)
        self._own_dtype = {n: p.dtype
                           for n, p in self.model.named_parameters()}
        self._copies: dict[str, torch.Tensor] = {}
        # the captured step's graph on the card (None: every step eager)
        self.graphs = GraphCache(self.device) \
            if self.device.type == "cuda" else None

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    @property
    def fused(self) -> bool:
        return isinstance(self.optimizer, FusedAdamW)

    # ------------------------------------------------------------ state

    def init_state(self, params: dict | None = None) -> TrainState:
        """A fresh state: fp32 copies of ``params`` (a name -> tensor dict,
        e.g. ``models.convert.from_jax_params``; None = the model's own
        weights) on the model's device, the optimizer at step 0."""
        src = dict(self.model.named_parameters()) if params is None \
            else params
        masters = {}
        for name in self._own_dtype:
            t = src[name].detach()
            masters[name] = t.to(self.device, torch.float32).clone() \
                if t.is_floating_point() else t.to(self.device).clone()
        return self.place(TrainState(step=0, params=masters))

    def _wire(self, params: dict) -> dict:
        """Point each module parameter at its master or at a compute copy
        (see the module docstring); returns the copies by name."""
        copies = {}
        with torch.no_grad():
            for name, p in self.model.named_parameters():
                m = params[name]
                dt = self.compute_dtype if (self.compute_dtype is not None
                                            and m.is_floating_point()) \
                    else self._own_dtype[name]
                if dt == m.dtype:
                    p.data = m
                else:
                    p.data = m.to(dt)
                    copies[name] = p.data
        self._copies = copies
        return copies

    def place(self, state: TrainState) -> TrainState:
        """``state`` on the model's device, wired into the module, with
        its optimizer state built (or rebuilt from a state_dict)."""
        dev = self.device
        params = {n: t.to(dev, torch.float32) if t.is_floating_point()
                  else t.to(dev) for n, t in state.params.items()}
        copies = self._wire(params)
        opt = state.opt_state
        if self.fused:
            if opt is None:
                opt = self.optimizer.init(params)
            if isinstance(opt, dict):  # as a checkpoint stores it
                opt = FusedAdamWState(**opt)
            given = opt.compute_params
            with torch.no_grad():
                if given is not None:  # carried values, not recomputed
                    for name, c in copies.items():
                        c.copy_(given[name])
            opt = FusedAdamWState(
                count=opt.count.to(dev, torch.int32),
                mu={n: t.to(dev) for n, t in opt.mu.items()},
                nu={n: t.to(dev) for n, t in opt.nu.items()},
                compute_params=copies or None)
        elif not isinstance(opt, torch.optim.Optimizer) or any(
                p is not params[n] for n, p in zip(
                    params, opt.param_groups[0]["params"])):
            built = self.optimizer(list(params.values()))
            if opt is not None:
                built.load_state_dict(
                    opt if isinstance(opt, dict) else opt.state_dict())
            opt = built
        return TrainState(step=int(state.step), params=params,
                          opt_state=opt)

    # ------------------------------------------------------------- step

    def _loss(self, batch) -> torch.Tensor:
        if self.compute_dtype is not None:
            # float batch leaves too: one fp32 operand would promote the
            # ops downstream back to fp32
            batch = {k: v.to(self.compute_dtype) if v.is_floating_point() else v
                     for k, v in batch.items()}
            return self.apply_fn(self.model, batch).float()
        return self.apply_fn(self.model, batch)

    def _grads(self, batch, acc: dict | None = None
               ) -> tuple[torch.Tensor, dict]:
        """(mean loss, gradients by name) over ``accum_steps`` strided
        micro-batches, by ``torch.autograd.grad``. ``acc`` (the captured
        step's static buffers) receives the gradients: zeroed, then
        summed into (fp32, with several micro-batches) or copied into
        (one); without it they are new tensors."""
        named = list(self.model.named_parameters())
        accum = max(self.accum_steps, 1)

        def grads_of(b) -> tuple[torch.Tensor, list]:
            loss = self._loss(b)
            got = torch.autograd.grad(loss, [p for _, p in named],
                                      allow_unused=True)
            # contiguous: a convolution's weight gradient can come back
            # channels-last, and fused AdamW reads every leaf flat
            return loss.detach(), [torch.zeros_like(p) if g is None
                                   else g.contiguous()
                                   for (_, p), g in zip(named, got)]

        if accum == 1:
            loss, gs = grads_of(batch)
            if acc is None:
                return loss, {n: g for (n, _), g in zip(named, gs)}
            for (n, _), g in zip(named, gs):
                acc[n].copy_(g)
            return loss, acc

        def micro(x, i):
            b = x.shape[0]
            if b % accum:
                raise ValueError(f"batch dim {b} not divisible by "
                                 f"accum_steps {accum}")
            # strided split: row r goes to micro-batch r % accum
            return x.reshape(b // accum, accum, *x.shape[1:])[:, i]

        # fp32 accumulator even when the per-micro grads are bf16
        if acc is None:
            acc = self._accumulators()
        for g in acc.values():
            g.zero_()
        loss_sum = torch.zeros((), dtype=torch.float32, device=self.device)
        for i in range(accum):
            loss, gs = grads_of({k: micro(v, i) for k, v in batch.items()})
            loss_sum = loss_sum + loss
            for (n, _), g in zip(named, gs):
                acc[n].add_(g)
        scale = 1.0 / accum
        for g in acc.values():
            if g.is_floating_point():
                g.mul_(scale)
        return loss_sum * scale, acc

    def _accumulators(self) -> dict:
        """The gradients' buffers: fp32 for several micro-batches (the
        JAX package's accumulator), else each gradient's own dtype (the
        compute dtype's, or the parameter's)."""
        out = {}
        for n, p in self.model.named_parameters():
            dt = torch.float32 if p.is_floating_point() \
                and self.accum_steps > 1 else p.dtype
            out[n] = torch.zeros(p.shape, dtype=dt, device=p.device)
        return out

    def _update(self, state: TrainState, batch, acc=None) -> torch.Tensor:
        """The step's device work, in place on ``state``'s tensors:
        gradients (``_grads``), the optimizer update, and the metrics as
        one fp32 tensor, ``[loss]`` or ``[loss, grad_norm]``."""
        loss, grads = self._grads(batch, acc)
        if self.fused:
            fused_adamw_update(self.optimizer, grads, state.opt_state,
                               state.params)
        else:
            opt, params = state.opt_state, state.params
            for n, m in params.items():
                m.grad = grads[n].to(m.dtype)
            opt.step()
            with torch.no_grad():
                for n, m in params.items():
                    m.grad = None
                    if n in self._copies:
                        self._copies[n].copy_(m)
        out = [loss]
        if self.log_grad_norm:
            out.append(torch.sqrt(sum(
                (g.float() * g.float()).sum() for g in grads.values())))
        return torch.stack(out)

    def _capturable(self, state: TrainState) -> bool:
        """Whether the step can run inside a graph: fused AdamW (its
        schedule checked on the first call), or a ``torch.optim``
        optimizer built with ``capturable=True``."""
        if self.fused:
            return True
        return bool(state.opt_state.defaults.get("capturable", False))

    def _check_schedule(self, state: TrainState) -> None:
        lr = self.optimizer.learning_rate
        if callable(lr) and not torch.is_tensor(lr(state.opt_state.count)):
            raise ValueError(
                "the learning-rate schedule returned a Python number: a "
                "captured step would bake it in. Return a tensor computed "
                "from count on the device (e.g. with torch.clamp or "
                "torch.where)")

    def _key(self, state: TrainState, batch) -> tuple:
        """The captured step's key: the batch's shapes and dtypes,
        ``accum_steps`` and the data pointers of every tensor the step
        reads or writes in place."""
        opt = state.opt_state
        held = list(state.params.values()) + list(self.model.parameters()) \
            + list(self.model.buffers())
        if self.fused:
            held += [opt.count, *opt.mu.values(), *opt.nu.values()]
        else:
            held.append(id(opt))
        ptrs = tuple(t if isinstance(t, int) else t.data_ptr()
                     for t in held)
        shapes = tuple((k, tuple(v.shape), v.dtype)
                       for k, v in sorted(batch.items()))
        return ("train_step", shapes, self.accum_steps, ptrs)

    def _statics(self, state: TrainState, batch) -> tuple:
        """The captured step's buffers: the batch's and the gradients',
        then what the step writes in place (the masters, the module's
        compute copies and the optimizer's state)."""
        opt = state.opt_state
        written = (opt.count, opt.mu, opt.nu) if self.fused \
            else (opt.state,)
        return ({k: torch.empty_like(v) for k, v in batch.items()},
                self._accumulators(), state.params, self._copies, written)

    def step(self, state: TrainState, batch) -> tuple[TrainState, dict]:
        """One update: (new state, metrics); metrics are device scalars
        (fetching them is the caller's choice). On the card the step is
        one replay of its captured graph (the module docstring)."""
        if self.graphs is None:
            out = self._update(state, batch)
        elif not self._capturable(state):
            out = self.graphs.eager("train_step", self._update, state,
                                    batch)
        else:
            key = self._key(state, batch)
            stale = [k for k in self.graphs.entries
                     if k[0] == "train_step" and k != key]
            for k in stale:  # a replaced state's graph
                del self.graphs.entries[k]
            if self.fused and key not in self.graphs.entries:
                self._check_schedule(state)
            e = self.graphs.entry(key, lambda: self._statics(state, batch))
            for k, v in batch.items():
                e.statics[0][k].copy_(v)
            out = self.graphs.run(e, lambda b, acc, *_: self._update(
                state, b, acc)).clone()
        metrics = {"loss": out[0]}
        if self.log_grad_norm:
            metrics["grad_norm"] = out[1]
        return TrainState(step=state.step + 1, params=state.params,
                          opt_state=state.opt_state), metrics

    def build_step(self, state: TrainState):
        """(step_fn, placed_state); step_fn(state, batch) -> (state,
        metrics)."""
        return self.step, self.place(state)


def build_train_step(model: nn.Module, apply_fn, optimizer, params=None,
                     fsdp: bool = False):
    """One-call convenience: (step_fn, state)."""
    trainer = Trainer(model=model, apply_fn=apply_fn, optimizer=optimizer,
                      fsdp=fsdp)
    state = trainer.init_state(params)
    return trainer.step, state
