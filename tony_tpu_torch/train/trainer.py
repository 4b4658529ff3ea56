"""The train step: the counterpart of ``tony_tpu/train/trainer.py``.

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

Over a mesh (``mesh``: ``parallel.make_mesh``; None is one device, the
behaviour above). Every rank runs this trainer on its own rows (the
``DataLoader`` gives rank p the rows ``order[p::P]``). ``fsdp`` shards
each leaf that ``parallel.sharding.shard_params_by_size`` picks over the
``fsdp`` axis: the rank holds its master, moments and compute copy of
that leaf as contiguous local shards, and the module parameter whole,
whose gradient it computes whole: so only the optimizer's part of the
state is sharded at rest, where the JAX fsdp keeps the parameters
sharded too (ROADMAP.md section 1, item 5). A step runs forward and
backward on the local rows, accumulates the local micro-batches in fp32
as above, then casts the gradients to fp32 and sums them over the batch
axes (data, fsdp): a reduce-scatter a sharded leaf onto its local shard
(then an all-reduce over the batch axes the shard does not span), and
one all-reduce for the replicated leaves and the loss, packed into one
buffer; and scales by 1/(ranks on those axes). Fused AdamW then updates
the local shards and the replicated leaves in its one launch a dtype
group, and the compute copies' shards are all-gathered into the
module's parameters. Two ranks at ``accum_steps=1`` thus compute, bit
for bit, one process's step at ``accum_steps=2`` over the same loader
(each fp32 sum has two operands, and AdamW is elementwise). The JAX
step reduces the gradients in the dtype the backward gives them; the
port reduces in fp32 (a deliberate divergence, which makes that
equality hold under the bf16 carry).

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
call. With more than one rank the step runs eagerly too (a gloo
collective cannot live in a CUDA graph). On the CPU every step runs
eagerly.

Not ported: a mesh whose ``tensor``, ``pipe``, ``seq`` or ``expert``
axis is above 1, and ``batch_shardings`` that shard a dim past the batch
dim (sequence parallelism); both raise, naming ROADMAP.md section 1,
item 5.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass
from typing import Any, Callable

import torch
from torch import nn

from tony_tpu_torch.models.graphs import GraphCache
from tony_tpu_torch.ops.adamw import (FusedAdamW, FusedAdamWState,
                                     fused_adamw_update)
from tony_tpu_torch.parallel import collectives
from tony_tpu_torch.parallel.mesh import (DATA, EXPERT, FSDP, PIPE, SEQ,
                                          TENSOR)
from tony_tpu_torch.parallel.sharding import (NamedSharding, P, place,
                                              replicated,
                                              shard_params_by_size)

_NOT_PORTED = ("is not ported yet (ROADMAP.md section 1, item 5: ring and "
               "Ulysses attention, pipelining and expert parallelism)")


@dataclass
class TrainState:
    step: int
    params: dict  # name -> fp32 master tensor (a local shard if sharded)
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


def _shard_dim(sh: NamedSharding) -> tuple[int, Any]:
    """(dim, axes) of a sharding that splits exactly one dim."""
    dims = [(d, a) for d, a in enumerate(sh.spec)
            if sh.mesh.axis_size(a) > 1]
    if len(dims) != 1:
        raise NotImplementedError(f"a leaf sharded along {len(dims)} dims "
                                  f"({sh.spec}) {_NOT_PORTED}")
    return dims[0]


@dataclass
class Trainer:
    """The train step over ``model``, on one device or over ``mesh``.

    ``apply_fn(model, batch) -> loss`` (a scalar); the model's parameters
    hold the whole compute copy of the masters while it runs."""

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
    # the batch's shardings (a NamedSharding, or a dict of them by batch
    # key): only the batch dim may be sharded. The rank's loader already
    # gives it its rows, so they are checked, not applied
    batch_shardings: Any = None
    # the device mesh (parallel.make_mesh); None = one device
    mesh: Any = None

    def __post_init__(self):
        if getattr(getattr(self.model, "cfg", None), "quantized", False):
            raise ValueError(
                "an int8 weight-only model (cfg.quantized) is for "
                "generation and scoring: int8 weights have no useful "
                "gradients. Train the float model, then convert it with "
                "models.quantize_for_serving")
        self._check_batch_shardings()
        # the dtype each parameter is stored in when no compute dtype
        # overrides it (taken once: wiring changes it)
        named = dict(self.model.named_parameters())
        self._own_dtype = {n: p.dtype for n, p in named.items()}
        self._full_shape = {n: tuple(p.shape) for n, p in named.items()}
        self._copies: dict[str, torch.Tensor] = {}
        # sharded leaves: the module's whole parameter, by name
        self._whole: dict[str, torch.Tensor] = {}
        # the collective blocks' spans (collective_s): seconds already
        # read, and the card's (start, end) events not read yet
        self._collective_s = 0.0
        self._spans: list = []
        mesh = self.mesh
        self._batch_axes: tuple = ()
        self.param_shardings = None
        self._shards: dict[str, NamedSharding] = {}
        if mesh is not None:
            big = [a for a in (TENSOR, PIPE, SEQ, EXPERT)
                   if mesh.shape.get(a, 1) > 1]
            if big:
                raise NotImplementedError(
                    f"a mesh whose {'/'.join(big)} axis is above 1 "
                    f"{_NOT_PORTED}")
            self._batch_axes = tuple(a for a in (DATA, FSDP)
                                     if mesh.shape.get(a, 1) > 1)
            self.param_shardings = shard_params_by_size(mesh, named) \
                if self.fsdp else {n: replicated(mesh) for n in named}
            self._shards = {n: sh for n, sh in self.param_shardings.items()
                            if sh.is_sharded()}
        # the sharded leaves by the axes they are cut over, and each
        # one's dim
        self._shard_dims = {n: _shard_dim(sh)
                            for n, sh in self._shards.items()}
        self._by_axes: dict = {}
        for n, (_, axes) in self._shard_dims.items():
            self._by_axes.setdefault(axes, []).append(n)
        # ranks on the batch axes: the gradient sum's operands
        self.ranks = 1 if mesh is None else mesh.axis_size(self._batch_axes)
        # the captured step's graph on the card (None: every step eager)
        self.graphs = GraphCache(self.device) \
            if self.device.type == "cuda" else None

    def _check_batch_shardings(self) -> None:
        b = self.batch_shardings
        if b is None:
            return
        shardings = list(b.values()) if isinstance(b, dict) else [b]
        for sh in shardings:
            if not isinstance(sh, NamedSharding):
                raise TypeError(f"batch_shardings holds {sh!r}, not a "
                                "NamedSharding")
            past = [a for a in list(sh.spec)[1:] if a is not None]
            if past:
                raise NotImplementedError(
                    f"a batch sharding that shards a dim past the batch "
                    f"dim ({sh.spec}: sequence parallelism) {_NOT_PORTED}")

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    @property
    def fused(self) -> bool:
        return isinstance(self.optimizer, FusedAdamW)

    @property
    def distributed(self) -> bool:
        """Whether a step talks to other ranks."""
        return self.mesh is not None and self.mesh.size() > 1

    # ------------------------------------------------------------ state

    def init_state(self, params: dict | None = None) -> TrainState:
        """A fresh state: fp32 copies of ``params`` (a name -> tensor dict,
        e.g. ``models.convert.from_jax_params``; None = the model's own
        weights) on the model's device, sharded leaves cut to this rank's
        shard, the optimizer at step 0."""
        src = dict(self.model.named_parameters()) if params is None \
            else params
        masters = {}
        for name in self._own_dtype:
            t = src[name].detach()
            t = t.to(self.device, torch.float32) if t.is_floating_point() \
                else t.to(self.device)
            masters[name] = place(t, self._shards[name]) \
                if name in self._shards else t.clone()
        return self.place(TrainState(step=0, params=masters))

    def _local(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """``t`` as this rank holds it: a whole sharded leaf (as a
        checkpoint stores it) cut to the rank's shard."""
        sh = self._shards.get(name)
        if sh is None or tuple(t.shape) != self._full_shape[name]:
            return t
        return place(t, sh)

    def state_shardings(self, state: TrainState) -> TrainState:
        """Each leaf's ``NamedSharding`` (the JAX method's tree):
        ``shard_params_by_size`` over the fsdp axis under ``fsdp``, else
        replicated; the optimizer's leaves like their params."""
        if self.mesh is None:
            raise ValueError("state_shardings needs a mesh")
        rep = replicated(self.mesh)
        return TrainState(
            step=rep, params=dict(self.param_shardings),
            opt_state=_opt_shardings_like(self.mesh, state.opt_state,
                                          self.param_shardings,
                                          state.params))

    def _wire(self, params: dict) -> dict:
        """Point each module parameter at its master or at a compute copy
        (see the module docstring); returns the copies by name. A
        sharded leaf's module parameter is a whole tensor of its own and
        its copy a local shard, gathered into it (``_gather_copies``)."""
        copies, whole = {}, {}
        with torch.no_grad():
            for name, p in self.model.named_parameters():
                m = params[name]
                dt = self.compute_dtype if (self.compute_dtype is not None
                                            and m.is_floating_point()) \
                    else self._own_dtype[name]
                if name in self._shards:
                    p.data = whole[name] = torch.empty(
                        self._full_shape[name], dtype=dt, device=m.device)
                    copies[name] = m.to(dt, copy=True)
                elif dt == m.dtype:
                    p.data = m
                else:
                    p.data = m.to(dt)
                    copies[name] = p.data
        self._copies, self._whole = copies, whole
        return copies

    def place(self, state: TrainState) -> TrainState:
        """``state`` on the model's device, wired into the module, with
        its optimizer state built (or rebuilt from a state_dict). Whole
        sharded leaves (a checkpoint's) are cut to this rank's shards;
        over a mesh every rank calls it together."""
        dev = self.device
        params = {n: self._local(n, t.to(dev, torch.float32)
                                 if t.is_floating_point() else t.to(dev))
                  for n, t in state.params.items()}
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
                        c.copy_(self._local(name, given[name].to(dev)))
            opt = FusedAdamWState(
                count=opt.count.to(dev, torch.int32),
                mu={n: self._local(n, t.to(dev)) for n, t in opt.mu.items()},
                nu={n: self._local(n, t.to(dev)) for n, t in opt.nu.items()},
                compute_params=copies or None)
        elif not isinstance(opt, torch.optim.Optimizer) or any(
                p is not params[n] for n, p in zip(
                    params, opt.param_groups[0]["params"])):
            built = self.optimizer(list(params.values()))
            if opt is not None:
                sd = opt if isinstance(opt, dict) else opt.state_dict()
                built.load_state_dict(self._optim_local(sd, params))
            opt = built
        with torch.no_grad():
            self._gather_copies()
        return TrainState(step=int(state.step), params=params,
                          opt_state=opt)

    def _optim_local(self, sd: dict, params: dict) -> dict:
        """A ``torch.optim`` state_dict with whole sharded leaves' state
        cut to this rank's shards (``place``)."""
        if not self._shards:
            return sd
        names = list(params)
        state = {i: {k: self._local(names[i], v)
                     if torch.is_tensor(v) and v.dim() else v
                     for k, v in st.items()}
                 for i, st in sd["state"].items()}
        return {**sd, "state": state}

    def gather_state(self, state: TrainState) -> TrainState:
        """``state`` with every sharded leaf whole (all-gathered): what a
        one-device trainer holds, and what a checkpoint stores. Every
        rank calls it together; an unsharded state comes back as is."""
        if not self._shards:
            return state
        from tony_tpu_torch.parallel.sharding import gather

        def whole(name, t):
            sh = self._shards.get(name)
            return t if sh is None else gather(t, sh)

        params = {n: whole(n, t) for n, t in state.params.items()}
        opt = state.opt_state
        if isinstance(opt, FusedAdamWState):
            cp = opt.compute_params
            opt = FusedAdamWState(
                count=opt.count,
                mu={n: whole(n, t) for n, t in opt.mu.items()},
                nu={n: whole(n, t) for n, t in opt.nu.items()},
                compute_params=None if cp is None else {
                    n: self._whole.get(n, t) for n, t in cp.items()})
        elif isinstance(opt, torch.optim.Optimizer):
            sd = opt.state_dict()
            names = list(state.params)
            opt = {**sd, "state": {
                i: {k: whole(names[i], v) if torch.is_tensor(v) and v.dim()
                    else v for k, v in st.items()}
                for i, st in sd["state"].items()}}
        return TrainState(step=state.step, params=params, opt_state=opt)

    # ------------------------------------------------------ collectives

    @contextlib.contextmanager
    def _timed(self):
        """Adds the block's span to ``collective_s``: on the card a pair
        of CUDA events on the current stream (read later, so the step
        waits for nothing), on the CPU the host clock."""
        if self.device.type != "cuda":
            t0 = time.perf_counter()
            yield
            self._collective_s += time.perf_counter() - t0
            return
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        yield
        end.record()
        self._fold(wait=False)
        self._spans.append((start, end))

    def _fold(self, wait: bool) -> None:
        """Adds to the seconds read the spans the card has finished (all
        of them, waiting for the card, with ``wait``)."""
        keep = []
        for start, end in self._spans:
            if wait or end.query():
                end.synchronize()
                self._collective_s += start.elapsed_time(end) / 1e3
            else:
                keep.append((start, end))
        self._spans = keep

    @property
    def collective_s(self) -> float:
        """Seconds this trainer's steps spent in collectives (on the
        card, between the events around each block: gloo makes the
        stream wait for its host copies, so the span holds them)."""
        self._fold(wait=True)
        return self._collective_s

    def _reduce(self, loss: torch.Tensor, grads: dict
                ) -> tuple[torch.Tensor, dict]:
        """The fp32 sum over the batch axes, scaled by 1/ranks: the
        replicated gradients and the loss packed into one all-reduce,
        each sharded one reduce-scattered along its shard dim onto this
        rank's shard, straight from the gradient when it is fp32 already
        (then all-reduced over the batch axes the shard does not span).
        Returns the loss and the gradients as this rank updates them
        (local shards for sharded leaves)."""
        mesh, scale = self.mesh, 1.0 / self.ranks
        out = {}
        with self._timed():
            rep = [n for n, g in grads.items()
                   if n not in self._shards and g.is_floating_point()]
            flat = torch.cat([loss.reshape(1).float()]
                             + [grads[n].reshape(-1).float() for n in rep])
            flat = collectives.all_reduce_sum(flat, self._batch_axes, mesh)
            flat.mul_(scale)
            loss, at = flat[0], 1
            for n in rep:
                k = grads[n].numel()
                out[n] = flat[at:at + k].view(grads[n].shape)
                at += k
            for n, (d, axes) in self._shard_dims.items():
                piece = collectives.reduce_scatter(grads[n].float(), axes,
                                                   mesh, axis=d)
                rest = tuple(a for a in self._batch_axes
                             if a not in (axes if isinstance(axes, tuple)
                                          else (axes,)))
                if mesh.axis_size(rest) > 1:
                    piece = collectives.all_reduce_sum(piece, rest, mesh)
                out[n] = piece.mul_(scale)
        for n, g in grads.items():
            out.setdefault(n, g)
        return loss, {n: out[n] for n in grads}

    def _gather_copies(self) -> None:
        """All-gather the sharded leaves' compute copies (local shards)
        into the module's whole parameters: one all-gather a shard axis
        and dtype."""
        if not self._shards:
            return
        groups: dict = {}
        for axes, names in self._by_axes.items():
            for n in names:
                groups.setdefault((axes, self._copies[n].dtype), []).append(n)
        with self._timed():
            for (axes, _), names in groups.items():
                flat = torch.cat([self._copies[n].reshape(-1)
                                  for n in names])
                rows = collectives.all_gather(flat, axes, self.mesh,
                                              tiled=False)
                n_sh, at = rows.shape[0], 0
                for n in names:
                    c = self._copies[n]
                    d = self._shard_dims[n][0]
                    dst = self._whole[n].unflatten(d, (n_sh, -1)).movedim(
                        d, 0)
                    dst.copy_(rows[:, at:at + c.numel()].view(
                        n_sh, *c.shape))
                    at += c.numel()

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
        gradients (``_grads``), their sum over the ranks (``_reduce``),
        the optimizer update, the sharded copies gathered, and the
        metrics as one fp32 tensor, ``[loss]`` or ``[loss, grad_norm]``."""
        loss, grads = self._grads(batch, acc)
        if self.ranks > 1:
            loss, grads = self._reduce(loss, grads)
        if self.fused:
            specs = None if self.param_shardings is None else {
                n: sh.spec for n, sh in self.param_shardings.items()}
            fused_adamw_update(self.optimizer, grads, state.opt_state,
                               state.params, mesh=self.mesh,
                               param_specs=specs)
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
        with torch.no_grad():
            self._gather_copies()
        out = [loss]
        if self.log_grad_norm:
            out.append(self._grad_norm(grads))
        return torch.stack(out)

    def _grad_norm(self, grads: dict) -> torch.Tensor:
        """The global norm of the (summed) gradients: the sharded leaves'
        squares summed over their shard axes."""
        def sq(names):
            return sum(((grads[n].float() * grads[n].float()).sum()
                        for n in names),
                       torch.zeros((), device=self.device))

        total = sq([n for n in grads if n not in self._shards])
        for axes, names in self._by_axes.items():
            with self._timed():
                total = total + collectives.all_reduce_sum(
                    sq(names), axes, self.mesh)
        return torch.sqrt(total)

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
        elif self.distributed or not self._capturable(state):
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
                     fsdp: bool = False, mesh=None):
    """One-call convenience: (step_fn, state)."""
    trainer = Trainer(model=model, apply_fn=apply_fn, optimizer=optimizer,
                      fsdp=fsdp, mesh=mesh)
    state = trainer.init_state(params)
    return trainer.step, state


def _opt_shardings_like(mesh, opt_state, param_shardings, params):
    """Optimizer-state shardings: leaves keyed (or, in a ``torch.optim``
    state, indexed) like a param get that param's sharding (the moments,
    the compute copy); everything else replicated. The JAX function
    matches leaves to params by shape and dtype; the port's leaves carry
    the params' names."""
    rep = NamedSharding(mesh, P())

    def like(tree):
        return None if tree is None else {
            n: param_shardings.get(n, rep) for n in tree}

    if isinstance(opt_state, FusedAdamWState):
        return FusedAdamWState(count=rep, mu=like(opt_state.mu),
                               nu=like(opt_state.nu),
                               compute_params=like(opt_state.compute_params))
    if isinstance(opt_state, torch.optim.Optimizer):
        names = list(params)
        return {i: {k: param_shardings[names[i]]
                    if torch.is_tensor(v) and v.dim() else rep
                    for k, v in st.items()}
                for i, st in opt_state.state_dict()["state"].items()}
    return rep
