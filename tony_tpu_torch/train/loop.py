"""High-level training loop: loader -> train step -> checkpoints, eval,
logs. The counterpart of ``tony_tpu/train/loop.py``.

``fit`` wires a ``DataLoader``, the ``Trainer`` step, checkpointing (with
resume from ``TONY_CHECKPOINT_DIR``), periodic eval, an EMA of the
params and metric sinks. Metrics stay on the device between log
boundaries: a boundary only records them, and they are fetched at the
next one (or at the end), by when the steps behind them have long
finished, so the host never waits for the card at a boundary.

A mesh ``Trainer`` runs ``fit`` on every rank (a ``DataLoader`` gives each
rank its rows by default). Only rank 0 calls the metric sinks, as the
JAX payload arranges (``examples/lm-pretrain/pretrain.py``); every rank
keeps the history. A checkpoint holds the whole state, gathered from the
shards (``Trainer.gather_state``) and written by rank 0, the same file a
one-device run writes, so a run resumes on another world size.
"""

from __future__ import annotations

import json
import logging
import os
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Iterable

import torch

from tony_tpu_torch.train.checkpoint import (CheckpointManager,
                                             job_checkpoint_dir)
from tony_tpu_torch.train.trainer import Trainer, TrainState

log = logging.getLogger(__name__)


@dataclass
class FitResult:
    state: TrainState
    steps_run: int
    resumed_from: int | None
    history: list[dict] = field(default_factory=list)
    # exponential moving average of the master params (None unless
    # fit(ema_decay=...))
    ema_params: Any = None
    # the run's checkpoint manager, with its save and restore timings
    # (None without a checkpoint dir); the JAX FitResult has no such field
    manager: CheckpointManager | None = None


class JsonlMetricsLogger:
    """Metric sink appending one JSON object per logged step."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)

    def __call__(self, step: int, metrics: dict) -> None:
        with open(self.path, "a") as f:
            f.write(json.dumps({"step": step, **metrics}) + "\n")


def fit(trainer: Trainer, params: Any, train_data: Iterable, *,
        num_steps: int | None = None,
        total_steps: int | None = None,
        checkpoint_dir: str | None = None,
        checkpoint_every: int = 0,
        max_checkpoints: int = 3,
        eval_data: Iterable | None = None,
        eval_fn: Callable[[Any, Any], Any] | None = None,
        eval_every: int = 0,
        log_every: int = 50,
        metric_sinks: list[Callable[[int, dict], None]] | None = None,
        ema_decay: float = 0.0,
        ) -> FitResult:
    """Train until ``train_data`` is exhausted or the step budget is met.

    Arguments as the JAX ``fit``: ``params`` are the initial weights (a
    name -> tensor dict, or None for the model's own; ignored when a
    checkpoint is restored); ``num_steps`` caps the steps this call runs,
    ``total_steps`` is an absolute target a resumed run completes (both
    given: the earlier wins); ``checkpoint_dir`` defaults to
    ``TONY_CHECKPOINT_DIR``; ``eval_fn(model, batch)`` -> scalar or dict
    runs under ``torch.no_grad`` over all of ``eval_data`` every
    ``eval_every`` steps (on the model as it stands, so in the compute
    dtype: the JAX eval reads the fp32 masters); ``log_every`` is the
    metric cadence; ``ema_decay`` > 0 keeps ema = decay * ema + (1 -
    decay) * params of the fp32 masters after every step (not
    checkpointed)."""
    resumed_from = None
    manager = None
    placed = None
    primary = not trainer.distributed or _rank() == 0
    ckpt_dir = checkpoint_dir or job_checkpoint_dir()
    if ckpt_dir:
        manager = CheckpointManager(ckpt_dir, max_to_keep=max_checkpoints,
                                    gang=trainer.distributed)
        restored = manager.restore()
        if restored is not None:
            placed = trainer.place(restored)
            resumed_from = placed.step
            log.info("fit: resumed from checkpoint step %d", resumed_from)
    if placed is None:
        placed = trainer.init_state(params)

    ema_params = None
    if ema_decay:
        ema_params = {n: t.clone() for n, t in placed.params.items()}
    a = 1.0 - ema_decay
    b = 1.0 - a  # optax.incremental_update's (1 - step_size)

    sinks = list(metric_sinks or [])
    history: list[dict] = []
    start_step = placed.step
    target = None if num_steps is None else start_step + num_steps
    if total_steps is not None:
        target = total_steps if target is None else min(target, total_steps)
    steps_run = 0
    t0 = time.monotonic()

    def emit(step: int, metrics: dict) -> None:
        history.append({"step": step, **metrics})
        for sink in sinks if primary else ():
            sink(step, metrics)

    pending: tuple[int, dict, float] | None = None

    def flush_pending() -> None:
        nonlocal pending
        if pending is None:
            return
        p_step, p_metrics, p_rate = pending
        pending = None
        fetched = {k: float(v) for k, v in p_metrics.items()}
        log.info("step %d: %s (%.2f steps/s)", p_step,
                 {k: round(v, 4) for k, v in fetched.items()}, p_rate)
        emit(p_step, {**fetched, "steps_per_sec": p_rate})

    data_iter = None
    if target is None or start_step < target:
        if resumed_from and hasattr(train_data, "from_step"):
            data_iter = train_data.from_step(start_step)
        else:
            if resumed_from:
                log.warning(
                    "fit: resumed model state at step %d but train_data has "
                    "no from_step — the iterator restarts from its "
                    "beginning, replaying already-seen batches", resumed_from)
            data_iter = iter(train_data)

    try:
        while data_iter is not None and \
                (target is None or start_step + steps_run < target):
            try:
                batch = next(data_iter)
            except StopIteration:
                break
            placed, metrics = trainer.step(placed, batch)
            if ema_params is not None:
                with torch.no_grad():
                    for n, e in ema_params.items():
                        e.mul_(b).add_(placed.params[n] * a)
            steps_run += 1
            step = start_step + steps_run
            if log_every and steps_run % log_every == 0:
                flush_pending()  # the previous boundary's steps are done
                pending = (step, metrics,
                           steps_run / (time.monotonic() - t0))
            if manager and checkpoint_every and \
                    steps_run % checkpoint_every == 0:
                manager.save(step, trainer.gather_state(placed))
            if eval_fn and eval_data is not None and eval_every and \
                    steps_run % eval_every == 0:
                flush_pending()  # keep history and sinks step-ordered
                ev = _run_eval(eval_fn, trainer.model, eval_data)
                if ev:
                    emit(step, ev)
    finally:
        try:
            flush_pending()
        except Exception:
            log.exception("fit: failed to flush pending metrics")
        if data_iter is not None and hasattr(data_iter, "close"):
            data_iter.close()

    if manager:
        final = start_step + steps_run
        if manager.latest_step() != final:
            manager.save(final, trainer.gather_state(placed), force=True)
    return FitResult(state=placed, steps_run=steps_run,
                     resumed_from=resumed_from, history=history,
                     ema_params=ema_params, manager=manager)


def _rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def _run_eval(eval_fn, model, eval_data) -> dict:
    totals: dict[str, float] = {}
    n = 0
    with torch.no_grad():
        for batch in eval_data:
            out = eval_fn(model, batch)
            if not isinstance(out, dict):
                out = {"loss": out}
            for k, v in out.items():
                totals[k] = totals.get(k, 0.0) + float(v)
            n += 1
    if n == 0:
        log.warning("fit: eval pass saw no batches (eval_data exhausted? "
                    "pass a re-iterable like a DataLoader or a list)")
        return {}
    return {f"eval/{k}": v / n for k, v in totals.items()}
