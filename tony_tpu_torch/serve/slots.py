"""KV cache slots: the fixed-shape resident rows, page pools, the
host-side page allocator and the per-slot decode state. The counterpart
of ``tony_tpu/serve/slots.py``.

Unpaged, the device side is one cache dict (``models.generate.
init_cache`` at ``batch_size``) whose K/V leaves ``[batch, max_len,
kvh, dh]`` (int8 scales ``[batch, max_len, kvh]``) are the slots' rows,
written in place; a batch-1 row moves in and out of a slot with
``write_slot_row`` / ``read_slot_row``, and ``slot_view`` hands a
slot's row to the scalar-index forward as a batch-1 cache of views.

Paged, the device side is one cache dict (``models.generate.init_cache``) whose K/V
leaves are page POOLS ``[n_pages + 1, page_size, kvh, dh]`` (int8
scales ``[n_pages + 1, page_size, kvh]``), written in place. Host side:
numpy page tables, a free list, refcounts and a reservation ledger. A
table entry ``>= n_pages`` is an unallocated SENTINEL. Page ``n_pages``
is the JUNK page: the allocator never hands it out and no count
includes it; gathers clamp a sentinel onto it (the visibility mask
hides what they read), and every write the JAX package drops lands on
it, so the writes keep one shape whatever they drop (the JAX package's
``mode="drop"`` scatter) and a CUDA graph can hold them.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from tony_tpu_torch.models.generate import init_cache

_POOL_LEAVES = ("cached_key", "cached_value", "cached_key_scale",
                "cached_value_scale")


def _layers(cache: dict):
    return [v for k, v in cache.items() if k.startswith("block_")]


def pool_leaf_keys(cache: dict) -> list[tuple[str, str]]:
    """The page-pool leaves of a cache dict (or of a page payload), as
    ``(layer key, leaf name)`` in the FIXED order the wire codec sends
    them: layers by index, each layer's K/V (and int8 scales) in
    ``_POOL_LEAVES`` order. The shared counters are not pool leaves."""
    layers = sorted((k for k in cache if k.startswith("block_")),
                    key=lambda k: int(k.split("_", 1)[1]))
    return [(k, name) for k in layers for name in _POOL_LEAVES
            if name in cache[k]]


def write_slot_row(cache: dict, row: dict, slot: int) -> None:
    """Copy the batch-1 cache ``row`` into slot ``slot`` of ``cache``, in
    place: every K/V leaf (and int8 scale) of the row lands in the
    slot's row of the resident leaf. The shared counters are not
    copied: per-slot decode neither reads nor advances them."""
    for key, layer in cache.items():
        if key.startswith("block_"):
            for name in _POOL_LEAVES:
                leaf = layer.get(name)
                if leaf is not None:
                    leaf[slot].copy_(row[key][name][0])


def read_slot_row(cache: dict, slot: int) -> dict:
    """Slot ``slot`` of ``cache`` as a batch-1 row of copies: the
    inverse of ``write_slot_row``. The counters pass through (a consumer
    seeding a prefill from the row sets them anyway)."""
    out: dict = {}
    for key, layer in cache.items():
        if not key.startswith("block_"):
            out[key] = layer
            continue
        out[key] = {name: (leaf[slot:slot + 1].clone()
                           if name in _POOL_LEAVES else leaf)
                    for name, leaf in layer.items()}
    return out


def slot_view(cache: dict, slot: int, offset: int) -> dict:
    """Slot ``slot``'s row of ``cache`` as a batch-1 cache of VIEWS with
    every shared counter (``cache_index``, ``pos_index``) at ``offset``:
    the scalar-index forward over it writes the next tokens into the
    slot's row at ``offset``, rotates them there and lets them see every
    position before them (the JAX package's ``_seed_offset`` over a row
    that ``write_slot_row`` then places)."""
    out: dict = {}
    for key, layer in cache.items():
        if not key.startswith("block_"):
            out[key] = offset  # pos_index
            continue
        out[key] = {name: (leaf[slot:slot + 1] if name in _POOL_LEAVES
                           else offset)
                    for name, leaf in layer.items()}
    return out


def row_nbytes(cache: dict) -> int:
    """Bytes one slot's row costs in the prefix store: each K/V leaf's
    share of one slot, and 4 bytes for each shared counter (the int32
    scalar the JAX package's row carries), as ``read_slot_row`` of this
    cache would occupy."""
    total = 0
    for key, layer in cache.items():
        if not key.startswith("block_"):
            total += 4
            continue
        for name, leaf in layer.items():
            total += (leaf.numel() * leaf.element_size() // leaf.shape[0]
                      if name in _POOL_LEAVES else 4)
    return total


def paged_cache(model, n_pages: int, page_size: int) -> dict:
    """A page-pool cache dict: every K/V leaf ``[n_pages + 1, page_size,
    ...]``, the last page the junk page; the shared counters ride along
    unused (per-slot decode neither reads nor advances them)."""
    return init_cache(model, n_pages + 1, page_size)


def default_page_size(cfg) -> int:
    """The auto ``kv_page_size``: 64 tokens, scaled down (floor 16, never
    past max_seq_len) for short-context models."""
    ps = min(64, max(16, cfg.max_seq_len // 4))
    return max(1, min(ps, cfg.max_seq_len))


def kv_page_nbytes(cfg, page_size: int) -> int:
    """Bytes of ONE KV page across all layers (K + V, plus the int8
    mode's fp32 scales)."""
    item = 1 if cfg.kv_cache_quant else cfg.dtype.itemsize
    per = 2 * page_size * cfg.kv_heads * cfg.head_dim * item
    if cfg.kv_cache_quant:
        per += 2 * page_size * cfg.kv_heads * 4
    return cfg.n_layers * per


def page_nbytes(cache: dict) -> int:
    """Bytes one page occupies across a pool's leaves (all layers; the
    junk page is not counted anywhere)."""
    total = 0
    for layer in _layers(cache):
        for name in _POOL_LEAVES:
            leaf = layer.get(name)
            if leaf is not None:
                total += leaf.numel() * leaf.element_size() // leaf.shape[0]
    return total


def copy_page(cache: dict, src: int, dst: int) -> None:
    """Copy pool page ``src`` onto page ``dst`` in every leaf, in place:
    the copy-on-write FORK of a shared page a slot must write into."""
    for layer in _layers(cache):
        for name in _POOL_LEAVES:
            leaf = layer.get(name)
            if leaf is not None:
                leaf[dst] = leaf[src]


def cache_device(cache: dict) -> torch.device:
    """The device a cache dict (or page payload) lives on."""
    key, name = pool_leaf_keys(cache)[0]
    return cache[key][name].device


def gather_pages(cache: dict, idx: torch.Tensor) -> dict:
    """The CONTENT of pool pages ``idx`` ([n] int64) as a standalone
    payload ``{layer: {leaf: [n, ps, ..]}}`` (the pool leaves only; the
    counters are host ints and do not travel): the portable form of a
    page list that the role-split handoff, migration and the host tier
    move. A fresh copy: later writes to the pool leave
    it alone."""
    out: dict = {}
    for key, name in pool_leaf_keys(cache):
        leaf = cache[key][name]
        safe = torch.clamp(idx.to(leaf.device), 0, leaf.shape[0] - 1)
        out.setdefault(key, {})[name] = leaf.index_select(0, safe)
    return out


def scatter_pages(cache: dict, payload: dict, idx: torch.Tensor) -> None:
    """Write ``payload``'s page rows onto pool pages ``idx``, in place:
    the inverse of ``gather_pages``. Sentinel entries (``>= n_pages``)
    land on the junk page, so a payload longer than the pages it fills
    writes exactly those (the JAX package's ``mode="drop"``). Pure copies: a gather,
    a host hop and a scatter give back the same bits."""
    for key, name in pool_leaf_keys(cache):
        leaf = cache[key][name]
        safe = torch.clamp(idx.to(leaf.device), 0, leaf.shape[0] - 1)
        src = torch.as_tensor(payload[key][name])
        leaf[safe] = src.to(device=leaf.device, dtype=leaf.dtype)


def paged_view(cache: dict, table: torch.Tensor, max_len: int) -> dict:
    """Gather each slot's pages into an unpaged-looking cache: every
    pool leaf ``[n_pages + 1, ps, ..]`` becomes ``[b, span, ..]``
    through ``table`` [b, cols] (sentinels clamp to the junk page, which
    the visibility mask hides), with ``span = min(cols * ps, max_len)``.
    A decode chunk runs its micro-steps on this view and
    ``paged_write_back`` returns their writes to the pool."""
    out: dict = {}
    for key, layer in cache.items():
        if not key.startswith("block_"):
            out[key] = layer
            continue
        view = {"cache_index": layer["cache_index"]}
        for name in _POOL_LEAVES:
            leaf = layer.get(name)
            if leaf is None:
                continue
            safe = torch.clamp(table, 0, leaf.shape[0] - 1)
            v = leaf[safe]  # [b, cols, ps, ..]
            v = v.reshape(v.shape[0], v.shape[1] * v.shape[2],
                          *v.shape[3:])
            limit = min(max_len, v.shape[1])
            if limit < v.shape[1]:  # page-size rounding past max_len
                v = v[:, :limit].contiguous()
            view[name] = v
        out[key] = view
    return out


def paged_write_back(pool: dict, view: dict, table: torch.Tensor,
                     start: torch.Tensor, n_steps: int,
                     max_len: int) -> None:
    """Return a decode chunk's writes from ``view`` to ``pool``, in
    place: slot i's micro-step j wrote position ``start[i] + j``
    (``start < 0`` = empty slot), so only those ``b x n_steps`` entries
    move. Positions past the view or the table, and sentinel entries,
    are dropped, as the JAX package drops them: they land on the junk
    page, which no kept entry writes. Fixed shape, no host sync."""
    first = _layers(pool)[0]["cached_key"]
    junk, ps = first.shape[0] - 1, first.shape[1]
    span = _layers(view)[0]["cached_key"].shape[1]
    steps = torch.arange(n_steps, dtype=start.dtype, device=start.device)
    pos_w = torch.where(start[:, None] >= 0, start[:, None] + steps,
                        torch.full_like(steps, -1)[None, :])
    limit = min(max_len, table.shape[1] * ps, span)
    valid = (pos_w >= 0) & (pos_w < limit)
    safe = torch.where(valid, pos_w, torch.zeros_like(pos_w))
    page = torch.gather(table, 1, safe // ps)
    valid = valid & (page < junk)
    page = torch.where(valid, page, torch.full_like(page, junk))
    dst = (page, safe % ps)
    rows = torch.arange(table.shape[0], device=table.device)[:, None]
    for pl, vl in zip(_layers(pool), _layers(view)):
        for name in _POOL_LEAVES:
            leaf = pl.get(name)
            if leaf is not None:
                leaf[dst] = vl[name][rows, safe]


class PagePool:
    """Block-granular KV-cache pages + a host-side free-list allocator.

    The device pool (``paged_cache``) is handed to the owning
    ``SlotCache`` (``self.cache`` is None afterwards, so the allocation
    is not pinned twice). The host side owns which page belongs to
    whom: a LIFO free list, a per-page refcount (a page may be held by
    one slot table and any number of prefix-store entries —
    copy-on-write sharing), and a RESERVATION ledger: a slot reserves
    its worst-case page count up front and allocates lazily from it, so
    a mid-stream allocation never fails (``free >= reserved`` always).

    With ``shared=True`` the pool is lent to several co-located
    ``Server``s at once: every attached ``SlotCache`` works on the same
    device dict (allocated here once, before any of them captures a
    graph, and never reallocated: each graph holds its addresses), so
    moving a session or a prefill's pages between two of them is a page
    table and refcount swap, no KV bytes copied. The junk page is shared
    too: it only ever takes writes that are dropped.

    Two locks: allocator mutations (free list, refcounts, reservations)
    are atomic under the fine ``_mu``; ``lock`` (reentrant) brackets the
    eager page copies an engine makes on the shared dict (a fork, a
    scatter), so no two engines interleave them."""

    def __init__(self, model, n_pages: int, page_size: int,
                 shared: bool = False):
        if n_pages < 1 or page_size < 1:
            raise ValueError("n_pages and page_size must be >= 1")
        self.n_pages = int(n_pages)
        self.page_size = int(page_size)
        self.shared = bool(shared)
        self.lock = threading.RLock()
        self._mu = threading.RLock()
        self.cache = paged_cache(model, n_pages, page_size)
        self.page_nbytes = page_nbytes(self.cache)
        self.refcount = np.zeros(self.n_pages, np.int32)
        self._free = list(range(self.n_pages - 1, -1, -1))
        self.reserved = 0
        self.allocs = 0
        self.frees = 0
        self.forks = 0
        self.peak_used = 0

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_used(self) -> int:
        return self.n_pages - len(self._free)

    def available(self) -> int:
        """Pages grantable to a NEW reservation right now."""
        with self._mu:
            return len(self._free) - self.reserved

    def cow_shared(self) -> int:
        """Pages currently held by more than one owner."""
        with self._mu:
            return int((self.refcount > 1).sum())

    def reserve(self, n: int) -> bool:
        """Set aside ``n`` future pages; False when they are not there."""
        with self._mu:
            if n > self.available():
                return False
            self.reserved += n
            return True

    def cancel(self, n: int) -> None:
        """Return ``n`` unused reserved pages."""
        with self._mu:
            if n > self.reserved:
                raise ValueError(f"cancel({n}) exceeds reserved "
                                 f"{self.reserved}")
            self.reserved -= n

    def alloc(self, n: int, *, from_reservation: bool = False) -> list[int]:
        """Pop ``n`` pages (refcount 1 each); ``from_reservation``
        consumes reserved units, a bare alloc must fit ``available()``."""
        with self._mu:
            if from_reservation:
                if n > self.reserved:
                    raise RuntimeError(
                        f"alloc({n}) exceeds reservation {self.reserved}"
                        " — engine reservation accounting bug")
                self.reserved -= n
            elif n > self.available():
                raise RuntimeError(
                    f"alloc({n}) exceeds available {self.available()}")
            pages = [self._free.pop() for _ in range(n)]
            self.refcount[pages] = 1
            self.allocs += n
            self.peak_used = max(self.peak_used, self.n_used)
            return pages

    def share(self, pages) -> None:
        """One more holder for each of ``pages``."""
        with self._mu:
            for p in pages:
                if self.refcount[p] <= 0:
                    raise ValueError(f"share() of free page {p}")
                self.refcount[p] += 1

    def unref(self, pages) -> None:
        """Drop one holder; pages reaching refcount 0 return to the
        free list."""
        with self._mu:
            for p in pages:
                if self.refcount[p] <= 0:
                    raise ValueError(f"unref() of free page {p}")
                self.refcount[p] -= 1
                if self.refcount[p] == 0:
                    self._free.append(p)
                    self.frees += 1

    def stats(self) -> dict:
        with self._mu:
            return {
                "total": self.n_pages,
                "used": self.n_used,
                "free": self.n_free,
                "reserved": self.reserved,
                "cow_shared": self.cow_shared(),
                "page_size": self.page_size,
                "page_nbytes": self.page_nbytes,
                "bytes_resident": self.n_used * self.page_nbytes,
                "allocs": self.allocs,
                "frees": self.frees,
                "forks": self.forks,
                "peak_used": self.peak_used,
            }


class SlotCache:
    """``batch_size`` cache slots + per-slot decode state.

    With no ``pool`` the slots are the rows of one resident cache
    (``init_cache(model, batch_size)``): admission writes a slot's row
    in place and eviction is host bookkeeping only (an inactive slot's
    position is -1, so nothing reads its stale row, and the next admit
    overwrites it). With a ``pool``, ``self.cache`` is the pool's page
    dict (ownership taken from the pool); each slot owns a page table
    row ``[max_pages]`` (unallocated tail = the ``pool.n_pages``
    sentinel), a count of allocated pages and the rest of its
    admission-time reservation. A shared pool (``PagePool(shared=True)``)
    keeps its dict: every attached SlotCache works on it. Host arrays
    are numpy. The sampling
    state lives on the device, where the decode graphs read it:
    ``temps`` [b] float32, ``top_ks`` [b] int64 and ``keys`` [b, 2]
    (``ops.sampling`` keys, advanced in place as rows draw); ``admit``
    and ``evict`` write them with device fills and never read them
    back. The host keeps each slot's temperature too
    (``temperature``), which picks a call's greedy or sampled variant."""

    def __init__(self, model, batch_size: int, pool: PagePool | None = None):
        self.batch_size = batch_size
        self.max_seq_len = model.cfg.max_seq_len
        self.pool = pool
        if pool is None:
            self.cache = init_cache(model, batch_size)
        else:
            self.cache = pool.cache
            if not pool.shared:
                pool.cache = None
            self.max_pages = -(-self.max_seq_len // pool.page_size)
            self.page_table = np.full((batch_size, self.max_pages),
                                      pool.n_pages, np.int32)
            self.n_slot_pages = np.zeros(batch_size, np.int32)
            self.reserve_left = np.zeros(batch_size, np.int32)
        self.lengths = np.zeros(batch_size, np.int32)
        self.active = np.zeros(batch_size, bool)
        self.last_token = np.zeros(batch_size, np.int64)
        self.temperature = np.zeros(batch_size, np.float32)
        self.top_k = np.zeros(batch_size, np.int64)
        dev = model.device
        self.temps = torch.zeros(batch_size, dtype=torch.float32,
                                 device=dev)
        self.top_ks = torch.zeros(batch_size, dtype=torch.int64, device=dev)
        self.keys = torch.zeros(batch_size, 2, dtype=torch.int64,
                                device=dev)

    def free_slots(self) -> list[int]:
        return [i for i in range(self.batch_size) if not self.active[i]]

    @property
    def n_active(self) -> int:
        return int(self.active.sum())

    def positions(self) -> np.ndarray:
        """Per-slot positions for the next step: the slot's length, -1
        for empty slots."""
        return np.where(self.active, self.lengths, -1).astype(np.int64)

    def admit(self, slot: int, length: int, last_token: int,
              temperature: float, top_k: int,
              key: torch.Tensor | None = None) -> None:
        """Arm ``slot``: ``length`` = prompt length already in its row or
        pages, ``last_token`` = the first sampled continuation (fed next
        at position ``length``); ``key`` [2] = the request's key after
        its first draw (a sampled request's; a greedy one never
        draws)."""
        if self.active[slot]:
            raise ValueError(f"slot {slot} is occupied")
        if not 0 < length <= self.max_seq_len:
            raise ValueError(f"bad prompt length {length}")
        self.lengths[slot] = length
        self.last_token[slot] = last_token
        self.temperature[slot] = temperature
        self.top_k[slot] = top_k
        if temperature > 0.0:
            # a free slot's device temperature is already 0 (``evict``)
            self.temps[slot].fill_(temperature)
            self.top_ks[slot].fill_(top_k)
            self.keys[slot].copy_(key)
        self.active[slot] = True

    def evict(self, slot: int) -> None:
        """Free a slot: paged, its page references drop (pages a
        prefix-store entry also holds stay resident) and its unspent
        reservation returns; unpaged, its row stays as it is."""
        self.active[slot] = False
        self.lengths[slot] = 0
        self.last_token[slot] = 0
        if self.temperature[slot] > 0.0:
            self.temps[slot].fill_(0.0)
        self.temperature[slot] = 0.0
        self.top_k[slot] = 0
        if self.pool is not None:
            self.release_pages(slot)

    def release_pages(self, slot: int) -> None:
        """Drop the slot's page references + unspent reservation."""
        n = int(self.n_slot_pages[slot])
        if n:
            self.pool.unref(self.page_table[slot, :n].tolist())
        self.pool.cancel(int(self.reserve_left[slot]))
        self.page_table[slot] = self.pool.n_pages
        self.n_slot_pages[slot] = 0
        self.reserve_left[slot] = 0

    def seed_pages(self, slot: int, pages: list, seed_len: int,
                   reserve: int) -> bool:
        """Arm a fresh slot's table with a prefix entry's shared pages
        covering ``[0, seed_len)`` plus a granted reservation of
        ``reserve`` pages. A mid-page ``seed_len`` FORKS the boundary
        page (one page copy on the device). Returns whether it forked."""
        ps = self.pool.page_size
        n_alias = -(-seed_len // ps) if seed_len else 0
        use = [int(p) for p in pages[:n_alias]]
        self.pool.share(use)
        self.reserve_left[slot] = reserve
        self.n_slot_pages[slot] = n_alias
        self.page_table[slot, :n_alias] = use
        self.page_table[slot, n_alias:] = self.pool.n_pages
        if seed_len % ps == 0:
            return False
        (fresh,) = self.pool.alloc(1, from_reservation=True)
        self.reserve_left[slot] -= 1
        shared = use[-1]
        with self.pool.lock:
            copy_page(self.cache, shared, fresh)
        self.pool.unref([shared])
        self.page_table[slot, n_alias - 1] = fresh
        with self.pool._mu:
            self.pool.forks += 1
        return True

    def ensure_pages(self, slot: int, upto_pos: int) -> None:
        """Grow the slot's table (from its reservation) to cover
        positions ``[0, upto_pos)``; never past the reservation."""
        ps = self.pool.page_size
        have = int(self.n_slot_pages[slot])
        want = min(-(-upto_pos // ps), self.max_pages)
        grow = min(want - have, int(self.reserve_left[slot]))
        if grow <= 0:
            return
        pages = self.pool.alloc(grow, from_reservation=True)
        self.reserve_left[slot] -= grow
        self.page_table[slot, have:have + grow] = pages
        self.n_slot_pages[slot] = have + grow

    def slot_pages(self, slot: int, n_tokens: int) -> list[int]:
        """The slot's page ids covering positions ``[0, n_tokens)``."""
        n = -(-n_tokens // self.pool.page_size)
        if n > int(self.n_slot_pages[slot]):
            raise ValueError(
                f"slot {slot} holds {int(self.n_slot_pages[slot])} pages, "
                f"{n} needed for {n_tokens} tokens")
        return self.page_table[slot, :n].tolist()

    def reset(self) -> None:
        """Evict everything (same allocation, a fresh session)."""
        for i in range(self.batch_size):
            self.evict(i)
