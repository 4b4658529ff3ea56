"""PrefixStore: radix-keyed KV-cache rows or page references for
automatic prefix reuse.

The counterpart of ``tony_tpu/serve/prefix.py`` (the RadixAttention
idea): previously prefilled sequences are kept keyed by their TOKEN
SEQUENCE in a radix tree. On admit the engine looks up the longest
stored prefix of the prompt: an exact-prompt hit samples the first
token from the stored last-position logits, a partial hit prefills only
the suffix. Unpaged stores keep a copied batch-1 cache ROW an entry
(``insert(tokens, row=..., logits=...)``), which a hit copies into the
slot; paged stores (``PrefixStore(budget, pool)``) keep refcounted
references to pool pages, which a hit aliases.

A cache position's K/V depends only on tokens at or before it, so an
entry stored for sequence S is position-exact over ``[0, k)`` for any
prompt sharing S's first ``k`` tokens; what lies beyond is masked or
overwritten before it is ever visible.

Bookkeeping: entries are refcounted (``acquire`` pins until
``release``; eviction never touches a pinned entry), and a byte budget
counts a row entry's bytes, or each UNIQUE page once. The owning
scheduler thread drives the store; the lock keeps cross-thread stat
reads consistent.
"""

from __future__ import annotations

import itertools
import logging
import threading
import zlib
from typing import Any

import numpy as np
import torch

log = logging.getLogger(__name__)


def tree_nbytes(tree: Any) -> int:
    """Bytes of a tensor or numpy array, or of those in a (nested)
    dict/list; a host int (a cache row's shared counter) counts as the
    int32 scalar the JAX package's row carries."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, np.ndarray):
        return int(tree.nbytes)
    if isinstance(tree, int):
        return 4
    if isinstance(tree, dict):
        return sum(tree_nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_nbytes(v) for v in tree)
    return 0


class _Entry:
    """One stored sequence: a batch-1 cache ``row`` covering ``tokens``
    (unpaged) or the pool ``pages`` covering them (paged), and
    optionally the last-position ``logits`` (prefill-donated entries
    have them; the exact-hit path needs them)."""

    __slots__ = ("tokens", "row", "logits", "pages", "nbytes", "node",
                 "refcount", "tick")

    def __init__(self, tokens: np.ndarray, row: Any, logits: Any,
                 nbytes: int, node: "_Node", tick: int,
                 pages: list | None = None):
        self.tokens = tokens
        self.row = row
        self.logits = logits
        self.pages = pages
        self.nbytes = nbytes
        self.node = node
        self.refcount = 0
        self.tick = tick


class _Node:
    """Radix-tree node: ``edge`` is the token run from the parent; an
    entry, when present, covers exactly the path from the root."""

    __slots__ = ("edge", "children", "entry", "parent")

    def __init__(self, edge: np.ndarray, parent: "_Node | None"):
        self.edge = edge
        self.children: dict[int, _Node] = {}
        self.entry: _Entry | None = None
        self.parent = parent


def _common_len(a: np.ndarray, b: np.ndarray) -> int:
    n = min(len(a), len(b))
    neq = np.nonzero(a[:n] != b[:n])[0]
    return int(neq[0]) if neq.size else n


class PrefixStore:
    """Radix store of cache rows, or with ``pool`` (a
    ``serve.slots.PagePool``) of page references, under a byte budget:
    a paged insert pins the sequence's pages (``pool.share``, no device
    work), an eviction unpins them."""

    def __init__(self, budget_bytes: int, pool=None):
        self.budget_bytes = max(0, int(budget_bytes))
        self.bytes_used = 0
        self.pool = pool
        # eviction hook (serve/tier.py): called with the dying entry
        # BEFORE its pages are unpinned, so a host tier can copy the
        # content out; a raising hook never breaks the eviction
        self.on_evict = None
        self._page_refs: dict[int, int] = {}  # page -> #entries holding
        self.tokens_stored = 0
        self.root = _Node(np.empty(0, np.int32), None)
        self._entries: dict[bytes, _Entry] = {}
        self._lock = threading.Lock()
        self._ticks = itertools.count(1)
        self.lookups = 0
        self.matched = 0
        self.inserts = 0
        self.evictions = 0
        self.rejected = 0

    def acquire(self, tokens) -> tuple[int, _Entry | None]:
        """Longest stored prefix of ``tokens``: ``(match_len, entry)``
        with the entry pinned (caller MUST ``release()``), or ``(0,
        None)``. ``match_len`` may be shorter than the entry's sequence
        (partial match) or equal ``len(tokens)`` against a longer
        entry."""
        tokens = np.asarray(tokens, np.int32)
        with self._lock:
            self.lookups += 1
            hit = self._lookup(tokens)
            if hit is None:
                return 0, None
            match, entry = hit
            entry.refcount += 1
            entry.tick = next(self._ticks)
            self.matched += 1
            return match, entry

    def release(self, entry: _Entry) -> None:
        with self._lock:
            if entry.refcount <= 0:
                raise ValueError("release() without matching acquire()")
            entry.refcount -= 1

    def match_len(self, tokens) -> int:
        """Longest stored prefix of ``tokens`` WITHOUT pinning the entry
        or moving the lookup counters: the gateway's prefix-affinity
        routing probe must not skew the admission hit rate."""
        tokens = np.asarray(tokens, np.int32)
        with self._lock:
            hit = self._lookup(tokens)
            return 0 if hit is None else hit[0]

    def has(self, tokens) -> bool:
        """Whether this exact sequence is stored."""
        key = np.asarray(tokens, np.int32).tobytes()
        with self._lock:
            return key in self._entries

    def _lookup(self, tokens: np.ndarray) -> tuple[int, _Entry] | None:
        node, consumed = self.root, 0
        best: tuple[int, _Entry] | None = None
        while True:
            if node.entry is not None and consumed > 0:
                best = (consumed, node.entry)
            if consumed == len(tokens):
                # the node's own entry is the EXACT match (it may carry
                # logits); otherwise any longer entry below covers it
                if node.entry is None:
                    deeper = _freshest_entry(node)
                    if deeper is not None:
                        best = (consumed, deeper)
                return best
            child = node.children.get(int(tokens[consumed]))
            if child is None:
                if consumed > 0 and (best is None or best[0] < consumed):
                    deeper = _freshest_entry(node)
                    if deeper is not None:
                        best = (consumed, deeper)
                return best
            common = _common_len(child.edge, tokens[consumed:])
            if common < len(child.edge):
                deeper = _freshest_entry(child)
                if deeper is not None:
                    best = (consumed + common, deeper)
                return best
            node = child
            consumed += len(child.edge)

    def wants(self, tokens, nbytes: int) -> bool:
        """Cheap pre-check before a donor reads a row out of its slot:
        False when the sequence is already stored or when ``nbytes``
        cannot fit even after evicting every unpinned entry."""
        key = np.asarray(tokens, np.int32).tobytes()
        with self._lock:
            if key in self._entries:
                return False
            pinned = sum(e.nbytes for e in self._entries.values()
                         if e.refcount > 0)
            return nbytes + pinned <= self.budget_bytes

    def insert(self, tokens, row: Any = None, logits: Any = None,
               pages: list | None = None) -> bool:
        """Store ``row`` (a batch-1 cache dict covering ``tokens``) with
        optional last-position ``logits``; a paged store takes ``pages``
        (the pool pages covering ``tokens``) instead of ``row``. False
        when refused (budget); re-inserting a stored sequence refreshes
        its LRU position."""
        tokens = np.asarray(tokens, np.int32)
        if tokens.size == 0 or self.budget_bytes <= 0:
            return False
        if (pages is not None) != (self.pool is not None):
            raise ValueError("pages= requires a pool-backed store "
                             "(and vice versa)")
        key = tokens.tobytes()
        with self._lock:
            existing = self._entries.get(key)
            if existing is not None:
                existing.tick = next(self._ticks)
                return True
            if pages is not None:
                return self._insert_pages(tokens, key, list(pages), logits)
            nbytes = tree_nbytes(row)
            if logits is not None:
                nbytes += tree_nbytes(logits)
            if not self._make_room(nbytes):
                self.rejected += 1
                return False
            self._add(tokens, key, _Entry(tokens, row, logits, nbytes, None,
                                          next(self._ticks)))
            return True

    def _insert_pages(self, tokens: np.ndarray, key: bytes, pages: list,
                      logits: Any) -> bool:
        """Paged insert under ``self._lock``. The charge depends on which
        pages are already pinned (shared pages are free) and an eviction
        can un-share a page, so it is recomputed after every eviction."""
        logits_b = tree_nbytes(logits) if logits is not None else 0
        while True:
            fresh = sum(1 for p in set(pages)
                        if self._page_refs.get(p, 0) == 0)
            nbytes = fresh * self.pool.page_nbytes + logits_b
            if self.bytes_used + nbytes <= self.budget_bytes:
                break
            victim = self._lru_victim()
            if victim is None or nbytes > self.budget_bytes:
                self.rejected += 1
                return False
            self._evict(victim)
        self._add(tokens, key, _Entry(tokens, None, logits, nbytes, None,
                                      next(self._ticks), pages))
        self.pool.share(pages)
        for p in pages:
            self._page_refs[p] = self._page_refs.get(p, 0) + 1
        return True

    def _add(self, tokens: np.ndarray, key: bytes, entry: _Entry) -> None:
        node = self._insert_node(tokens)
        entry.node = node
        node.entry = entry
        self._entries[key] = entry
        self.bytes_used += entry.nbytes
        self.tokens_stored += int(tokens.size)
        self.inserts += 1

    def _make_room(self, nbytes: int) -> bool:
        """Evict LRU unpinned entries until ``nbytes`` more fit; False
        when it cannot (everything left pinned, or ``nbytes`` over the
        whole budget)."""
        if nbytes > self.budget_bytes:
            return False
        while self.bytes_used + nbytes > self.budget_bytes:
            victim = self._lru_victim()
            if victim is None:
                return False
            self._evict(victim)
        return True

    def evict_one(self) -> bool:
        """Evict the least-recently-used unpinned entry (the engine's
        pool-pressure squeeze). False when everything is pinned or the
        store is empty."""
        with self._lock:
            victim = self._lru_victim()
            if victim is None:
                return False
            self._evict(victim)
            return True

    def _lru_victim(self) -> _Entry | None:
        return min((e for e in self._entries.values() if e.refcount == 0),
                   key=lambda e: e.tick, default=None)

    def _insert_node(self, tokens: np.ndarray) -> _Node:
        node, consumed = self.root, 0
        while consumed < len(tokens):
            first = int(tokens[consumed])
            child = node.children.get(first)
            if child is None:
                leaf = _Node(tokens[consumed:].copy(), node)
                node.children[first] = leaf
                return leaf
            common = _common_len(child.edge, tokens[consumed:])
            if common < len(child.edge):
                # split the edge at the divergence point
                mid = _Node(child.edge[:common].copy(), node)
                node.children[first] = mid
                child.edge = child.edge[common:]
                child.parent = mid
                mid.children[int(child.edge[0])] = child
                node = mid
            else:
                node = child
            consumed += common
        return node

    def _evict(self, entry: _Entry) -> None:
        if self.on_evict is not None:
            try:
                self.on_evict(entry)
            except Exception:
                log.exception("prefix on_evict hook failed")
        del self._entries[entry.tokens.tobytes()]
        if entry.pages is not None:
            # only pages no OTHER entry still holds stop being charged
            released = 0
            for p in entry.pages:
                self._page_refs[p] -= 1
                if self._page_refs[p] == 0:
                    del self._page_refs[p]
                    released += self.pool.page_nbytes
            self.pool.unref(entry.pages)
            if entry.logits is not None:
                released += tree_nbytes(entry.logits)
            self.bytes_used -= released
        else:
            self.bytes_used -= entry.nbytes
        self.tokens_stored -= int(entry.tokens.size)
        self.evictions += 1
        node = entry.node
        node.entry = None
        # prune entry-less leaves, then merge a single-child pass-through
        while node.parent is not None and node.entry is None \
                and not node.children:
            parent = node.parent
            del parent.children[int(node.edge[0])]
            node = parent
        if node.parent is not None and node.entry is None \
                and len(node.children) == 1:
            (child,) = node.children.values()
            child.edge = np.concatenate([node.edge, child.edge])
            child.parent = node.parent
            node.parent.children[int(child.edge[0])] = child

    def summary(self, max_items: int = 512, grain: int = 8) -> list:
        """Bounded summary of what this store could seed: ``[[n_tokens,
        crc32], ...]``, one pair per stored sequence's prefix on a
        ``grain``-token grid (plus its full length), most recent entries
        first, without repeats; ``summary_match_len`` probes it. The
        grid makes partial matches visible."""
        with self._lock:
            entries = sorted(self._entries.values(),
                             key=lambda e: e.tick, reverse=True)
        out: list = []
        seen: set = set()
        for e in entries:
            n = int(e.tokens.size)
            lens = list(range(grain, n + 1, grain))
            if not lens or lens[-1] != n:
                lens.append(n)
            for ln in reversed(lens):
                item = (ln, zlib.crc32(e.tokens[:ln].tobytes()))
                if item in seen:
                    continue
                seen.add(item)
                out.append([item[0], item[1]])
                if len(out) >= max_items:
                    return out
        return out

    def __len__(self) -> int:
        return len(self._entries)

    def stats(self) -> dict:
        with self._lock:
            # the radix tree's shape (root included; depth in tokens)
            nodes, max_depth = 0, 0
            stack: list[tuple[_Node, int]] = [(self.root, 0)]
            while stack:
                node, depth = stack.pop()
                nodes += 1
                max_depth = max(max_depth, depth)
                for child in node.children.values():
                    stack.append((child, depth + len(child.edge)))
            return {
                "entries": len(self._entries),
                "bytes": self.bytes_used,
                "budget_bytes": self.budget_bytes,
                "tokens": self.tokens_stored,
                "nodes": nodes,
                "max_depth": max_depth,
                "lookups": self.lookups,
                "matched": self.matched,
                "inserts": self.inserts,
                "evictions": self.evictions,
                "rejected": self.rejected,
            }


def summary_match_len(summary, tokens) -> int:
    """Longest summarized prefix of ``tokens``: the probe side of
    ``PrefixStore.summary()`` (int32 bytes, crc32, as the producer
    hashes them). A crc collision costs one mis-routed request, never a
    wrong token."""
    toks = np.asarray(tokens, np.int32)
    by_len: dict[int, set] = {}
    for ln, crc in summary or ():
        if 0 < int(ln) <= toks.size:
            by_len.setdefault(int(ln), set()).add(int(crc))
    for ln in sorted(by_len, reverse=True):
        if zlib.crc32(toks[:ln].tobytes()) in by_len[ln]:
            return ln
    return 0


def _freshest_entry(node: _Node) -> _Entry | None:
    """Most-recently-used entry in ``node``'s subtree."""
    best = node.entry
    for child in node.children.values():
        e = _freshest_entry(child)
        if e is not None and (best is None or e.tick > best.tick):
            best = e
    return best
