"""HostPageTier: a host-RAM second tier under the device prefix store,
and the wire codec for page payloads. The counterpart of
``tony_tpu/serve/tier.py``.

When the paged prefix store evicts an entry (LRU churn, or the engine's
pool-pressure squeeze), the entry's page CONTENT is copied to host
memory here (``PrefixStore.on_evict`` fires before the pages are
unpinned); when a later prompt's longest stored prefix lives here rather
than on the device, the engine pages it back in (allocate pool pages,
scatter the host bytes, re-insert into the device store) and the
admission that follows hits it as if it had never left. The budget is
``kv_host_mb`` of host RAM.

Spills are asynchronous: the engine gathers the pages on the device (a
copy it never waits on) and hands the still-on-device payload to
``spill_async``; one background thread makes the device-to-host copy and
the store insert, in order, so decode rounds go on meanwhile. A lookup
that feeds a page-in (``acquire``) flushes the queue first; the routing
probe (``match_len``) never blocks.

Exactness: the spill and the page-in are ``serve.slots.gather_pages`` /
``scatter_pages``, pure copies, so a device-host-device round trip gives
back the same bits (tests/test_torch_tier.py).

The tier's index is a ``PrefixStore`` without a pool: an entry keeps the
host payload (CPU tensors of the sequence's pages) as its ``row``.

The wire codec (base64 of each leaf's raw bytes, with its dtype name and
shape) serves the agent's handoff and migration ops and nothing else
needs to know the cache's layout: a payload is ``{layer: {leaf:
tensor}}`` (``gather_pages``), its leaves travel in
``slots.pool_leaf_keys`` order, and each carries ``page_axis`` so that a
relay can cut it page-wise (``trim_payload``). bf16 travels as its raw
16-bit words under the dtype name ``"bfloat16"``: numpy has no bf16 type
without ``ml_dtypes``, so a decoded leaf is a CPU torch tensor. A
scanned pool's payload sends each stacked leaf whole (``[n_layers, n,
ps, ..]``, ``page_axis`` 1): K for every layer, its scales, then V and
its scales, the JAX package's scanned wire form leaf for leaf. The JAX
form also carries each layer's int32 ``cache_index``, which no receiver
reads; the port's does not.
"""

from __future__ import annotations

import base64
import contextlib
import logging
import threading
import time
from collections import deque
from typing import Any

import numpy as np
import torch

from tony_tpu_torch.models.generate import batch_axis
from tony_tpu_torch.models.graphs import DEVICE
from tony_tpu_torch.serve.prefix import PrefixStore, tree_nbytes
from tony_tpu_torch.serve.slots import cache_device, pool_leaf_keys

log = logging.getLogger(__name__)

# ------------------------------------------------------ payload shaping


def payload_pages(tree: dict) -> int:
    """Page-axis length of a gathered payload."""
    for key, name in pool_leaf_keys(tree):
        leaf = tree[key][name]
        return int(leaf.shape[batch_axis(name, leaf)])
    raise ValueError("payload holds no paged leaves")


def pages_to_host(tree: dict, n: int) -> dict:
    """A device payload's first ``n`` pages as CPU tensors. The copy to
    the host is the device sync; the values are untouched."""
    out: dict = {}
    for key, name in pool_leaf_keys(tree):
        leaf = tree[key][name]
        out.setdefault(key, {})[name] = leaf.narrow(
            batch_axis(name, leaf), 0, n).to("cpu", copy=True)
    return out


# ----------------------------------------------------------- wire codec


def _dtype_name(arr) -> str:
    if isinstance(arr, torch.Tensor):
        return str(arr.dtype).removeprefix("torch.")
    return str(arr.dtype)


def encode_array(arr) -> dict:
    """One array (a torch tensor on any device, or numpy) as its wire
    form: dtype name, shape and the base64 of its raw bytes (bitwise; no
    float round trip through text)."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach().to("cpu").contiguous()
        raw = t.reshape(-1).view(torch.uint8).numpy().tobytes() \
            if t.numel() else b""
        shape = list(t.shape)
    else:
        a = np.ascontiguousarray(np.asarray(arr))
        raw, shape = a.tobytes(), list(a.shape)
    return {"dtype": _dtype_name(arr), "shape": shape,
            "b64": base64.b64encode(raw).decode("ascii")}


def decode_array(doc: dict) -> torch.Tensor:
    """The inverse of ``encode_array``: a CPU torch tensor of the
    carried dtype (``"bfloat16"`` included) and shape."""
    dtype = getattr(torch, doc["dtype"])
    raw = bytearray(base64.b64decode(doc["b64"]))
    shape = [int(d) for d in doc["shape"]]
    if not raw:
        return torch.empty(shape, dtype=dtype)
    return torch.frombuffer(raw, dtype=dtype).reshape(shape)


def encode_payload(tree: Any) -> dict:
    """A gathered page payload as JSON-safe wire form: its leaves in
    ``pool_leaf_keys`` order, each with its ``page_axis``. The receiver
    rebuilds it against its OWN cache's leaf order (both sides run the
    same model config; ``decode_payload`` checks the leaf count)."""
    if isinstance(tree, dict) and "leaves" in tree:
        return tree  # already wire form (a pure-router gateway relays)
    leaves = []
    for key, name in pool_leaf_keys(tree):
        leaf = tree[key][name]
        doc = encode_array(leaf)
        doc["page_axis"] = batch_axis(name, leaf)
        leaves.append(doc)
    return {"leaves": leaves}


def decode_payload(doc: dict, keys: list) -> dict:
    """A wire payload as ``{layer: {leaf: CPU tensor}}`` against
    ``keys``, the receiving cache's ``pool_leaf_keys``."""
    leaves = [decode_array(d) for d in doc["leaves"]]
    if len(keys) != len(leaves):
        raise ValueError(
            f"handoff payload carries {len(leaves)} leaves, this "
            f"engine's cache has {len(keys)} — mismatched model "
            "configs between the prefill and decode pools")
    out: dict = {}
    for (key, name), leaf in zip(keys, leaves):
        out.setdefault(key, {})[name] = leaf
    return out


def trim_payload(doc: dict, start: int, stop: int) -> dict:
    """A WIRE payload cut to pages ``[start, stop)`` along each leaf's
    ``page_axis``: the delta-migration trim, which ships only the suffix
    pages the adopter does not hold. Leaves without a page axis pass
    through. The bytes are untouched."""
    out = []
    for d in doc["leaves"]:
        ax = d.get("page_axis")
        if ax is None:
            out.append(d)
            continue
        a = decode_array(d)
        sl = [slice(None)] * a.ndim
        sl[int(ax)] = slice(int(start), int(stop))
        trimmed = encode_array(a[tuple(sl)])
        trimmed["page_axis"] = int(ax)
        out.append(trimmed)
    return {"leaves": out}


def payload_nbytes(doc: dict) -> int:
    """Decoded byte size of a wire payload's leaves: what a migration
    ships (base64 adds its 4/3 on the wire)."""
    return sum(int(np.prod(d["shape"])) * getattr(torch, d["dtype"]).itemsize
               for d in doc["leaves"])


# ------------------------------------------------------------- the tier


class HostPageTier:
    """Host-RAM KV pages under an explicit byte budget.

    The engine's own thread drives it; the inner ``PrefixStore``'s lock
    keeps cross-thread stat reads (gateway /stats) consistent."""

    def __init__(self, budget_bytes: int):
        self.store = PrefixStore(max(0, int(budget_bytes)))
        self.spills = 0          # entries copied device -> host
        self.page_ins = 0        # entries restored host -> device
        self.bytes_spilled = 0   # payload bytes copied out, lifetime
        self.bytes_paged_in = 0  # payload bytes restored, lifetime
        # the asynchronous spills: a FIFO of gathered-not-yet-copied
        # payloads drained by ONE background thread, so inserts land in
        # eviction order
        self._q: deque = deque()
        self._pending: set[bytes] = set()  # keys queued or mid-copy
        self._cond = threading.Condition()
        self._worker: threading.Thread | None = None

    # ------------------------------------------------------------ index

    def has(self, tokens) -> bool:
        key = np.asarray(tokens, np.int32).tobytes()
        with self._cond:
            if key in self._pending:
                return True  # queued content counts: don't re-spill
        return self.store.has(tokens)

    def touch(self, tokens) -> None:
        """Refresh a stored sequence's LRU position (the caller checked
        ``has()``): a re-evicted device entry whose content already lives
        here skips the copy."""
        key = np.asarray(tokens, np.int32).tobytes()
        with self._cond:
            if key in self._pending:
                return  # the queued copy lands with a fresh tick
        self.store.insert(tokens, row=None)

    def match_len(self, tokens) -> int:
        # pending spills are invisible here on purpose: this is the
        # routing probe, and blocking it on a flush would stall
        return self.store.match_len(tokens)

    def acquire(self, tokens):
        # the lookup that feeds a PAGE-IN sees every spill already
        # started, or an evict-then-resubmit race would re-prefill
        # depending on timing
        self.flush()
        return self.store.acquire(tokens)

    def release(self, entry) -> None:
        self.store.release(entry)

    # ------------------------------------------------------------ moves

    def insert(self, tokens, payload: Any, logits) -> bool:
        """One SYNCHRONOUS spill of a host ``payload`` (CPU tensors of the
        sequence's real pages) and its optional last-position logits.
        False when the budget refuses it."""
        ok = self.store.insert(tokens, row=payload, logits=logits)
        if ok:
            self.spills += 1
            self.bytes_spilled += tree_nbytes(payload) + (
                tree_nbytes(logits) if logits is not None else 0)
        return ok

    def spill_async(self, tokens, payload: Any, n: int, logits) -> None:
        """Queue one spill: ``payload`` is the still-on-device gather the
        engine just made (its first ``n`` pages are kept); the
        background thread copies it to the host and inserts it, in
        order. The counters move NOW: they count spills started, and
        equal the completed ones after ``flush()``."""
        tokens = np.asarray(tokens, np.int32)
        per_page = tree_nbytes(payload) // max(1, payload_pages(payload))
        self.spills += 1
        self.bytes_spilled += per_page * int(n) + (
            tree_nbytes(logits) if logits is not None else 0)
        with self._cond:
            self._pending.add(tokens.tobytes())
            self._q.append((tokens, payload, int(n), logits))
            if self._worker is None:
                self._worker = threading.Thread(
                    target=self._copy_loop, name="kv-host-spill",
                    daemon=True)
                self._worker.start()
            self._cond.notify_all()

    def flush(self, timeout: float | None = None) -> bool:
        """Block until every queued spill is in the store. True when
        drained, False on timeout."""
        deadline = None if timeout is None \
            else time.monotonic() + timeout
        with self._cond:
            while self._pending:
                left = None if deadline is None \
                    else deadline - time.monotonic()
                if left is not None and left <= 0:
                    return False
                self._cond.wait(timeout=0.5 if left is None else left)
        return True

    def _copy_loop(self) -> None:
        while True:
            with self._cond:
                while not self._q:
                    self._cond.wait()
                tokens, payload, n, logits = self._q[0]
            # the copy is device work: it must not meet another engine's
            # graph capture (models.graphs.DEVICE)
            hold = DEVICE.joining() \
                if cache_device(payload).type == "cuda" \
                else contextlib.nullcontext()
            try:
                with hold:
                    host = pages_to_host(payload, n)  # the sync
                    logits_h = logits.to("cpu", copy=True) \
                        if logits is not None else None
                self.store.insert(tokens, row=host, logits=logits_h)
            except Exception:
                log.exception("async KV spill failed")
            with self._cond:
                self._q.popleft()
                self._pending.discard(tokens.tobytes())
                self._cond.notify_all()

    def note_page_in(self, n_bytes: int) -> None:
        self.page_ins += 1
        self.bytes_paged_in += int(n_bytes)

    def summary(self, max_items: int = 512) -> list:
        """The tier's share of the heartbeat prefix summary (a page-in
        is still far cheaper than a re-prefill)."""
        return self.store.summary(max_items)

    # ------------------------------------------------------------ stats

    def stats(self) -> dict:
        st = self.store.stats()
        return {
            "entries": st["entries"],
            "bytes": st["bytes"],
            "budget_bytes": st["budget_bytes"],
            "tokens": st["tokens"],
            "nodes": st["nodes"],
            "max_depth": st["max_depth"],
            "evictions": st["evictions"],
            "rejected": st["rejected"],
            "spills": self.spills,
            "page_ins": self.page_ins,
            "bytes_spilled": self.bytes_spilled,
            "bytes_paged_in": self.bytes_paged_in,
        }
