"""Engine calls replayed as CUDA graphs: a shape-keyed cache of captured
callables, the port's form of the JAX package's jitted programs (the
serving decode chunk's ``lax.scan`` and paged prefill in
``tony_tpu/serve/engine.py``, ``generate``'s decode scan in
``tony_tpu/models/generate.py``). The JAX package has no module like
this one: ``jax.jit`` keeps its own cache. The training step
(``train.trainer.Trainer.step``) is captured whole through the same
cache.

A key names one static shape, as a jitted function's static arguments
do. The key's static buffers (``Entry.statics``) are made once; the
caller fills them before each call. The FIRST call at a key runs the
function eagerly, on a side stream, on those buffers, and its result is
the call's result; the capture that follows records the same function
on the same buffers and launches nothing. Every later call at the key
is one replay, and returns the capture's output tensor, which the next
replay overwrites: callers copy it out first. A capture or replay that
fails raises; nothing falls back to eager in silence.

All graphs of one cache share one memory pool
(``torch.cuda.graph_pool_handle``). Graphs replay one at a time and
each output is read before the next replay, so one graph's scratch may
be another's: a decode chunk's gathered page view alone is about a GB
at full width, and the serving engine holds tens of keys.

Launch counts: each kernel wrapper counts its launches in Python
(``flash_decode.launches``, ``q8_matmul.launches``,
``q8_matmul_experts.launches`` and their ``route_launches``, the flash
attention kernels' and fused AdamW's, ``COUNTED``). A capture calls the wrappers but launches
nothing, and a replay launches with no call, so a capture records what
it added to the counts and restores them, and each replay adds that
record back: the counts stay the launches on the card.

Several engines in one process (the gateway's replica threads) share
the card under one rule, held by ``DEVICE``: an engine's step holds it
shared, and a key's first call and capture hold it exclusively. A
capture's error mode is process-wide ("global"), and its first call
turns on ``set_sync_debug_mode("error")`` for the whole process, so
while one engine captures no other may allocate, sync, launch or even
copy its tokens to the host. Holding it exclusively waits for every
other engine to leave its step, and keeps new steps out until the
capture is done; the capturing engine gives up its own shared hold for
that time and takes it back after.
"""

from __future__ import annotations

import contextlib
import gc
import threading
import time
from collections import Counter
from dataclasses import dataclass, field
from typing import Any, Callable

import torch

from tony_tpu_torch.ops.adamw import fused_adamw_update
from tony_tpu_torch.ops.attention import (flash_attention_bwd_dkv,
                                          flash_attention_bwd_dq,
                                          flash_attention_fwd)
from tony_tpu_torch.ops.decode import flash_decode
from tony_tpu_torch.ops.quant import q8_matmul, q8_matmul_experts

# the counting wrappers a captured call reaches: the decode forward's,
# then the training step's
COUNTED = (flash_decode, q8_matmul, q8_matmul_experts,
           flash_attention_fwd, flash_attention_bwd_dq,
           flash_attention_bwd_dkv, fused_adamw_update)
# the parts of a capture that ``CudaGraphs.capture`` times
CAPTURE_PARTS = ("sync", "gc", "empty_cache", "record")


class DeviceLock:
    """A readers-writer lock over the card: ``shared()`` for an engine's
    step, ``exclusive()`` for a capture. Both re-enter on one thread. A
    thread that holds it shared and asks for it exclusively gives up its
    shared hold while it waits and takes it back after, so two engines
    that both need a capture inside their steps cannot deadlock. A
    waiting ``exclusive()`` keeps new shared holders out."""

    def __init__(self):
        self._cond = threading.Condition()
        self._readers = 0      # threads holding it shared
        self._writer = None    # the thread holding it exclusively
        self._depth = 0        # its exclusive re-entries
        self._waiting = 0      # threads waiting for it exclusively
        self._local = threading.local()

    def _take_shared(self) -> None:
        with self._cond:
            while self._writer is not None or self._waiting:
                self._cond.wait()
            self._readers += 1

    def _drop_shared(self) -> None:
        with self._cond:
            self._readers -= 1
            self._cond.notify_all()

    @contextlib.contextmanager
    def shared(self):
        held = getattr(self._local, "shared", 0)
        mine = self._writer is threading.current_thread()
        if not held and not mine:
            self._take_shared()
        self._local.shared = held + 1
        try:
            yield
        finally:
            self._local.shared = held
            if not held and not mine:
                self._drop_shared()

    @contextlib.contextmanager
    def joining(self):
        """A shared hold for a helper thread that a shared holder may be
        waiting on (the host page tier's copy thread, whose spills an
        engine's step flushes): it waits while the lock is HELD
        exclusively, but not for a thread waiting to take it so, which
        itself waits on that very shared holder."""
        with self._cond:
            while self._writer is not None:
                self._cond.wait()
            self._readers += 1
        try:
            yield
        finally:
            self._drop_shared()

    @contextlib.contextmanager
    def exclusive(self):
        me = threading.current_thread()
        if self._writer is me:
            self._depth += 1
            try:
                yield
            finally:
                self._depth -= 1
            return
        held = getattr(self._local, "shared", 0)
        with self._cond:
            if held:
                self._readers -= 1
                self._cond.notify_all()
            self._waiting += 1
            while self._writer is not None or self._readers:
                self._cond.wait()
            self._waiting -= 1
            self._writer = me
        try:
            yield
        finally:
            with self._cond:
                self._writer = None
                self._cond.notify_all()
            if held:
                self._take_shared()


# the card's lock, shared by every engine of the process
DEVICE = DeviceLock()
# a replay's read-add-write of the launch counts
_COUNTS = threading.Lock()


def launch_counts() -> list[int]:
    """Every wrapper's launch count, then its counts by route, flat."""
    out = []
    for w in COUNTED:
        out.append(w.launches)
        out.extend(getattr(w, "route_launches", ()))
    return out


def set_launch_counts(counts) -> None:
    """Set the counts ``launch_counts`` reads (route lists in place)."""
    it = iter(counts)
    for w in COUNTED:
        w.launches = next(it)
        routes = getattr(w, "route_launches", None)
        if routes is not None:
            routes[:] = [next(it) for _ in routes]


class CudaGraphs:
    """What the cache needs of the card: a side stream, on which the
    first call at a key runs and its capture is taken, and the pool the
    graphs share."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.stream = torch.cuda.Stream(self.device)
        self.pool = torch.cuda.graph_pool_handle()

    @contextlib.contextmanager
    def eager(self):
        """The first call at a key: on the side stream, ordered after
        the caller's stream and before what it enqueues next. A host
        sync in it raises (``set_sync_debug_mode``): it would break the
        capture that follows."""
        caller = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(caller)
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            with torch.cuda.stream(self.stream):
                yield
        finally:
            torch.cuda.set_sync_debug_mode(mode)
            caller.wait_stream(self.stream)

    def capture(self, fn: Callable[..., Any], statics: tuple):
        """``(graph, output)``: ``fn(*statics)`` recorded, not run. Its
        seconds by part go to ``last_parts`` (``_timed_entry``)."""
        graph = torch.cuda.CUDAGraph()
        parts = dict.fromkeys(CAPTURE_PARTS, 0.0)
        t0 = time.perf_counter()
        # no automatic collection while recording: one, in any thread,
        # can free an earlier key's graph that cyclic garbage still holds,
        # and destroying a graph invalidates the capture in progress (this
        # PyTorch runs no gc.collect() before a capture)
        enabled = gc.isenabled()
        gc.disable()
        try:
            with _timed_entry(parts):
                with torch.cuda.graph(graph, pool=self.pool,
                                      stream=self.stream):
                    out = fn(*statics)
        finally:
            if enabled:
                gc.enable()
        parts["record"] = time.perf_counter() - t0 - parts["sync"] \
            - parts["gc"] - parts["empty_cache"]
        self.last_parts = parts
        return graph, out

    def pool_bytes(self) -> int | None:
        """Bytes the caching allocator holds for the shared pool; None
        where its snapshot does not name pools."""
        segs = torch.cuda.memory_snapshot()
        if not any("segment_pool_id" in s for s in segs):
            return None
        return sum(s["total_size"] for s in segs
                   if tuple(s.get("segment_pool_id") or ()) ==
                   tuple(self.pool))


@contextlib.contextmanager
def _timed_entry(parts: dict):
    """Time what ``torch.cuda.graph`` does on entry, as it does it: its
    device synchronize (``sync``), its ``gc.collect()`` where this
    PyTorch runs one (``gc``), and its device and host allocator cache
    flushes (``empty_cache``), by wrapping those calls for the capture's
    length; the rest of the capture is the recording. A measurement
    only: the calls, their order and their effect are unchanged."""
    wrapped = [(torch.cuda, "synchronize", "sync"), (gc, "collect", "gc"),
               (torch.cuda, "empty_cache", "empty_cache"),
               (torch._C, "_host_emptyCache", "empty_cache")]
    saved = []
    for mod, name, part in wrapped:
        real = getattr(mod, name, None)
        if real is None:
            continue

        def timed(*a, _real=real, _part=part, **kw):
            t0 = time.perf_counter()
            try:
                return _real(*a, **kw)
            finally:
                parts[_part] += time.perf_counter() - t0

        saved.append((mod, name, real))
        setattr(mod, name, timed)
    try:
        yield
    finally:
        for mod, name, real in saved:
            setattr(mod, name, real)


@dataclass
class Entry:
    """One key: its static buffers and, once captured, the graph, its
    output and the launch counts a replay adds."""

    key: tuple
    statics: tuple
    graph: Any = None
    out: Any = None
    delta: list = field(default_factory=list)


class GraphCache:
    """Captured callables by key, sharing one pool. The first element of
    every key names its kind (``"decode"``, ``"prefill"``,
    ``"generate"``); ``calls`` counts captures, replays and eager calls
    by kind. ``backend`` defaults to ``CudaGraphs`` on ``device``;
    anything with the same three methods stands in for it."""

    def __init__(self, device, backend=None):
        self.device = torch.device(device)
        self.backend = backend if backend is not None \
            else CudaGraphs(self.device)
        self.entries: dict[tuple, Entry] = {}
        self.calls: Counter = Counter()
        self.capture_seconds = 0.0
        # capture seconds by part (``CAPTURE_PARTS``), where the backend
        # times them
        self.capture_parts: Counter = Counter()

    def entry(self, key: tuple, make: Callable[[], tuple]) -> Entry:
        """The key's entry; ``make()`` gives its static buffers the first
        time."""
        e = self.entries.get(key)
        if e is None:
            e = self.entries[key] = Entry(key, tuple(make()))
        return e

    def run(self, e: Entry, fn: Callable[..., Any]):
        """``fn(*e.statics)``: eagerly and then captured at a new key,
        replayed after that."""
        if e.graph is not None:
            e.graph.replay()
            with _COUNTS:
                set_launch_counts(
                    [a + d for a, d in zip(launch_counts(), e.delta)])
            self.calls[e.key[0], "replays"] += 1
            return e.out
        with DEVICE.exclusive():
            with self.backend.eager():
                out = fn(*e.statics)
            before = launch_counts()
            t0 = time.perf_counter()
            try:
                e.graph, e.out = self.backend.capture(fn, e.statics)
            except BaseException:
                # no half-captured graph stays: the next call at the
                # key starts over with a first call
                del self.entries[e.key]
                raise
            finally:
                e.delta = [a - b for a, b in zip(launch_counts(), before)]
                set_launch_counts(before)
            self.capture_seconds += time.perf_counter() - t0
            self.capture_parts.update(
                getattr(self.backend, "last_parts", None) or {})
        self.calls[e.key[0], "captures"] += 1
        return out

    def eager(self, kind: str, fn: Callable[..., Any], *args):
        """``fn(*args)`` with no graph (a call the cache does not
        capture), counted as an eager call of ``kind``."""
        self.calls[kind, "eager"] += 1
        return fn(*args)

    def counters(self, kinds) -> dict:
        """``{kind}_{captures|replays|eager}`` for each of ``kinds``, and
        the seconds spent capturing."""
        out = {f"{kind}_{what}": self.calls[kind, what] for kind in kinds
               for what in ("captures", "replays", "eager")}
        out["capture_s"] = self.capture_seconds
        return out

    def pool_bytes(self) -> int | None:
        return self.backend.pool_bytes()
