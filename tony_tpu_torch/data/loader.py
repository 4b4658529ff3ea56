"""Prefetched data loading: host numpy -> batches of torch tensors on the
device. The counterpart of ``tony_tpu/data/loader.py``, with
``device_prefetch`` for any iterator of host batches.

The same contract as the JAX loader: every process sees the same seeded
(seed, epoch) permutation and takes a disjoint stride of it;
``drop_remainder`` caps every process at the same batch count;
``from_step`` resumes the data order by index arithmetic; a daemon thread
stages batches ahead and stops when the iterator is closed. In place of
the JAX loader's ``sharding`` (global ``jax.Array`` assembly), batches
land on ``device``: ``cuda`` unless the caller asks for another, as every
entry point of the port.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Mapping

import numpy as np
import torch

from tony_tpu_torch.data.sources import Source
from tony_tpu_torch.ops.platform import resolve_device

_STOP = object()


def _process_grid() -> tuple[int, int]:
    """(rank, world size) of the torch.distributed group, or (0, 1)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class DataLoader:
    """Iterates batches (dicts of torch tensors on ``device``) from a
    ``Source``.

    Args:
      source: random-access examples.
      global_batch_size: batch size summed over all processes.
      shuffle: reshuffle each epoch with a (seed, epoch)-derived
        permutation.
      seed: base shuffle seed (must match across processes).
      drop_remainder: drop the trailing partial batch.
      num_epochs: None = loop forever.
      process_index/process_count: which stride of the permutation this
        process owns; default = the torch.distributed rank/world size
        (0/1 without a process group).
      device: where batches land (None = cuda, which must exist).
      prefetch: how many batches to stage ahead (0 = synchronous).
    """

    def __init__(self, source: Source, global_batch_size: int, *,
                 shuffle: bool = True, seed: int = 0,
                 drop_remainder: bool = True, num_epochs: int | None = None,
                 process_index: int | None = None,
                 process_count: int | None = None, device=None,
                 prefetch: int = 2):
        self.source = source
        self.global_batch_size = global_batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_remainder = drop_remainder
        self.num_epochs = num_epochs
        rank, world = _process_grid()
        self.process_index = rank if process_index is None \
            else process_index
        self.process_count = world if process_count is None \
            else process_count
        if global_batch_size % self.process_count:
            raise ValueError(
                f"global_batch_size={global_batch_size} not divisible by "
                f"process_count={self.process_count}")
        self.local_batch_size = global_batch_size // self.process_count
        if drop_remainder and \
                len(source) // self.process_count < self.local_batch_size:
            raise ValueError(
                f"dataset too small: {len(source)} examples over "
                f"{self.process_count} processes yields less than one "
                f"local batch of {self.local_batch_size}")
        self.device = resolve_device(device)
        self.prefetch = prefetch

    def _epoch_indices(self, epoch: int) -> np.ndarray:
        n = len(self.source)
        if self.shuffle:
            order = np.random.default_rng((self.seed, epoch)).permutation(n)
        else:
            order = np.arange(n)
        return order[self.process_index::self.process_count]

    def _host_batches(self, start_batch: int = 0) \
            -> Iterator[Mapping[str, np.ndarray]]:
        lb = self.local_batch_size
        spe = self.steps_per_epoch()
        epoch, skip = (divmod(start_batch, spe) if spe else (0, 0))
        while self.num_epochs is None or epoch < self.num_epochs:
            mine = self._epoch_indices(epoch)
            if self.drop_remainder:
                # every process yields the same batch count: cap by the
                # minimum per-process example count, not this stride's
                stop = (len(self.source) // self.process_count) // lb * lb
            else:
                stop = len(mine)
            for start in range(skip * lb, stop, lb):
                rows = [self.source[int(i)] for i in mine[start:start + lb]]
                yield {k: np.stack([r[k] for r in rows]) for k in rows[0]}
            skip = 0
            epoch += 1

    def __iter__(self):
        return self.from_step(0)

    def from_step(self, step: int):
        """Iterator starting at global batch index ``step`` — the
        data-order half of checkpoint resume (no examples are read to
        skip). Requires drop_remainder."""
        if step and not self.drop_remainder:
            raise ValueError("from_step needs drop_remainder=True "
                             "(stable steps_per_epoch)")
        it = (self._to_device(b) for b in
              self._host_batches(start_batch=step))
        if self.prefetch > 0:
            it = _prefetch_iter(it, self.prefetch)
        return it

    def _to_device(self, batch: Mapping[str, np.ndarray]) -> dict:
        pin = self.device.type == "cuda"
        out = {}
        for k, v in batch.items():
            t = torch.from_numpy(np.ascontiguousarray(v))
            if pin:  # an asynchronous copy needs page-locked memory
                t = t.pin_memory()
            out[k] = t.to(self.device, non_blocking=pin)
        return out

    def steps_per_epoch(self) -> int:
        if self.drop_remainder:
            return (len(self.source) // self.process_count) \
                // self.local_batch_size
        per_proc = (len(self.source) + self.process_count - 1
                    - self.process_index) // self.process_count
        return (per_proc + self.local_batch_size - 1) // self.local_batch_size


def _prefetch_iter(it: Iterator, size: int) -> Iterator:
    """Stage up to ``size`` items from a daemon thread. Closing the
    generator (or dropping it) stops the worker, so an early exit leaks
    no thread and no staged batch."""
    q: queue.Queue = queue.Queue(maxsize=size)
    stop = threading.Event()
    err: list[BaseException] = []

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in it:
                if not put(item):
                    return
        except BaseException as e:  # surfaced on the consumer side
            err.append(e)
        finally:
            put(_STOP)

    threading.Thread(target=worker, daemon=True).start()
    try:
        while True:
            item = q.get()
            if item is _STOP:
                if err:
                    raise err[0]
                return
            yield item
    finally:
        stop.set()
        while True:  # unblock a producer stuck on a full queue
            try:
                q.get_nowait()
            except queue.Empty:
                break


def _tree_map(fn, batch):
    """``fn`` over the leaves of a batch of dicts, lists and tuples."""
    if isinstance(batch, Mapping):
        return {k: _tree_map(fn, v) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(_tree_map(fn, v) for v in batch)
    return fn(batch)


def device_prefetch(iterator: Iterator, device=None, size: int = 2):
    """Wrap any iterator of host batches (numpy arrays or CPU tensors, in
    dicts, lists or tuples): each batch is copied to ``device`` (None =
    cuda, which must exist) up to ``size`` batches ahead, so the next
    batch's copy overlaps the current step. The counterpart of the JAX
    ``device_put`` wrapper (``tony_tpu/data/loader.py:201``).

    On the card a daemon thread stages each host leaf in page-locked
    memory and copies it with ``non_blocking`` on a stream of its own;
    the consumer's current stream waits on that batch's copy (an event
    recorded after it) before the batch is handed out, and each tensor
    is recorded on the consumer's stream, so the allocator does not
    reuse its memory while the consumer's work is queued. The thread
    stages under a shared hold of ``models.graphs.DEVICE``, so it never
    allocates or copies while a step's first call or capture holds the
    card exclusively. Leaves already on the device pass through as they
    are."""
    device = resolve_device(device)

    def leaf(v):
        return v if torch.is_tensor(v) else torch.from_numpy(
            np.ascontiguousarray(v))

    if device.type != "cuda":
        return _prefetch_iter((_tree_map(lambda v: leaf(v).to(device), b)
                               for b in iterator), size)
    from tony_tpu_torch.models.graphs import DEVICE

    copies = torch.cuda.Stream(device)

    def put(batch):
        def move(v):
            t = leaf(v)
            if t.device == device:
                return t
            # an asynchronous copy needs page-locked memory
            return t.pin_memory().to(device, non_blocking=True)

        with DEVICE.shared(), torch.cuda.stream(copies):
            out = _tree_map(move, batch)
            done = torch.cuda.Event()
            done.record(copies)
        return out, done

    def handed_out():
        staged = _prefetch_iter((put(b) for b in iterator), size)
        try:
            for out, done in staged:
                consumer = torch.cuda.current_stream(device)
                consumer.wait_event(done)
                _tree_map(lambda t: t.record_stream(consumer), out)
                yield out
        finally:
            staged.close()

    return handed_out()
