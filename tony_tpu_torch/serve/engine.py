"""Continuous-batching scheduler over the paged KV cache: the counterpart
of ``tony_tpu/serve/engine.py`` (its paged, in-dispatch-EOS path).

Each ``step()`` admits pending prompts into free slots — a prefill is
one multi-token window written straight into the slot's pages, or, on
an exact prefix-store hit, no model call at all — then runs a CHUNK of
K decode micro-steps for every slot, and evicts the slots that finished.
The JAX package runs the chunk as one ``lax.scan`` dispatch and jits
the prefill per bucket. On the card the port replays each as a CUDA
graph (``models.graphs``): a chunk keyed by ``(K, page columns)`` holds
the page gather (``paged_view``), the K micro-steps with their sampling
and frozen-row carry, and the write-back to the pool
(``paged_write_back``); a prefill keyed by ``(bucket, page columns)``
holds the forward and the pick of the last real position's logits. The
host packs each call's inputs into one buffer, copies it up, replays,
and reads the result back. The first call at a key runs eagerly and is
then captured. A chunk with a live sampled row runs eagerly (its
per-request generators and the host read of the frozen rows cannot be
captured) and is counted so (``counters()``); a prefill's first-token
sample runs after the graph. On the CPU every call runs eagerly. A
slot that samples EOS or spends its budget mid-chunk FREEZES: its later
micro-steps write nothing, draw nothing, and re-emit its last token.

Greedy outputs are token-exact against the JAX ``Server`` on the same
weights and request mix (tests/test_torch_serve.py). Sampled requests
draw from a per-request ``torch.Generator`` seeded from
``Request.seed`` and match the JAX package in distribution only.

Left out of this slice, refused by the constructor: speculation, a
mesh, chunked prefill, the host-RAM page tier, a shared page pool,
fault injection, the unpaged cache, sliding-window models, the
pre-freeze decode loop, and int8-weight models; also migration,
handoff and the timeline/goodput ledger.
"""

from __future__ import annotations

import functools
import itertools
import logging
import threading
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Iterable, Iterator

import numpy as np
import torch

from tony_tpu_torch.models.generate import (_is_eos, multi_decode_step,
                                            normalize_eos_ids,
                                            single_decode_step)
from tony_tpu_torch.models.graphs import GraphCache
from tony_tpu_torch.ops.platform import resolve_device
from tony_tpu_torch.serve.prefix import PrefixStore
from tony_tpu_torch.serve.slots import (PagePool, SlotCache,
                                        default_page_size, paged_view,
                                        paged_write_back)

log = logging.getLogger(__name__)


def bucket_len(n: int, max_len: int, minimum: int = 16) -> int:
    """Smallest power-of-two bucket >= n (floor ``minimum``, cap
    ``max_len``)."""
    b = minimum
    while b < n:
        b *= 2
    return min(b, max_len)


def _bucket_pow2(n: int) -> int:
    """Smallest power of two >= n (n >= 1)."""
    b = 1
    while b < n:
        b *= 2
    return b


def _sample_rows(logits, generators, temps, top_ks, done=None):
    """Per-row sampling: greedy rows (temp == 0) take the argmax;
    sampled rows apply a per-row top-k cut by rank and draw from their
    own generator. Rows flagged ``done`` take the greedy path, so a
    frozen row never advances its generator; greedy rows never draw at
    all, so a request's draws do not depend on its batch. An all-greedy
    batch stays on the device (no host sync)."""
    greedy = torch.argmax(logits, dim=-1)
    rows = [i for i in range(len(temps)) if temps[i] > 0.0]
    if not rows:
        return greedy
    if done is not None:
        done_h = done.cpu().numpy()
        rows = [i for i in rows if not done_h[i]]
    out = greedy.clone()
    for i in rows:
        x = logits[i].float() / max(float(temps[i]), 1e-6)
        k = int(top_ks[i])
        if 0 < k < x.shape[-1]:
            keep = torch.zeros_like(x, dtype=torch.bool)
            keep[torch.topk(x, k).indices] = True
            x = torch.where(keep, x, torch.full_like(x, -1e30))
        out[i] = torch.multinomial(torch.softmax(x, dim=-1), 1,
                                   generator=generators[i])[0]
    return out


def _sample_first(logits, temp: float, top_k: int, generator) -> int:
    """The exact-hit admit: the first continuation from the stored
    last-position logits [1, V], with THIS request's knobs."""
    return int(_sample_rows(logits, [generator], [temp], [top_k])[0])


@torch.no_grad()
def _prefill_last(model, cache, flat, lb: int, cols: int):
    """The paged admit's forward on its packed inputs ``flat`` = window
    [lb] | positions [lb] | table row [cols] | last real index [1]: the
    window (the prompt's suffix, right-padded to its bucket; padding at
    position -1, whose writes drop) goes through the pool in one
    forward. Returns the last real position's logits [1, V]."""
    window, positions = flat[:lb][None], flat[lb:2 * lb][None]
    table = flat[2 * lb:2 * lb + cols][None]
    _, logits = multi_decode_step(model, cache, window, positions,
                                  page_table=table)
    return logits[0].index_select(0, flat[-1:])


@torch.no_grad()
def _decode_chunk(model, cache, flat, b: int, cols: int, temps, top_ks,
                  generators, n_steps: int, eos_ids: tuple):
    """``n_steps`` decode micro-steps for every slot over the page view,
    with in-dispatch EOS, on packed inputs ``flat`` = tokens [b] |
    positions [b] | remaining budgets [b] | page table [b, cols]: carry
    ``(tok, positions, done, rem)``; a row that emitted an eos id or
    spent its budget freezes — its later micro-steps write to position
    -1 (dropped), take the greedy path, and re-emit its token. Empty
    slots (position < 0) start frozen. Returns the emitted tokens [b,
    n_steps]; the pool is updated in place."""
    tok, positions, rem = flat[:b], flat[b:2 * b], flat[2 * b:3 * b]
    table = flat[3 * b:].view(b, cols)
    max_len = model.cfg.max_seq_len
    start = positions
    view = paged_view(cache, table, max_len)
    done = positions < 0
    out = []
    for _ in range(n_steps):
        eff_pos = torch.where(done, torch.full_like(positions, -1),
                              positions)
        view, last = single_decode_step(model, view, tok, positions=eff_pos)
        nxt = _sample_rows(last, generators, temps, top_ks, done)
        nxt = torch.where(done, tok, nxt)
        positions = torch.where(done | (positions < 0), positions,
                                positions + 1)
        rem = torch.where(done, rem, rem - 1)
        done = done | _is_eos(nxt, eos_ids) | (rem <= 0)
        tok = nxt
        out.append(nxt)
    paged_write_back(cache, view, table, start, n_steps, max_len)
    return torch.stack(out, dim=1)


class QueueFull(RuntimeError):
    """``submit()`` refused: the pending queue is at ``max_pending``."""


class PoolExhausted(RuntimeError):
    """``submit()`` refused: the request's worst-case KV-page need
    exceeds the ENTIRE page pool, so it could never be admitted.
    Transient pressure never raises: the request stays pending."""


@dataclass
class Request:
    """One generation request: ``prompt`` token ids and per-request
    sampling knobs (greedy default); ``id`` is echoed on the Result."""

    prompt: list
    max_new_tokens: int
    temperature: float = 0.0
    top_k: int = 0
    seed: int = 0
    id: Any = None


@dataclass
class Result:
    """A finished request: ``tokens`` = generated ids (a hit eos id is
    the last element); ``finish_reason`` is "eos" or "length".
    ``prefix_hit_tokens`` = prompt tokens seeded from the prefix store;
    ``prefill_tokens_saved`` = bucketed prefill work skipped."""

    id: Any
    prompt: list
    tokens: list
    finish_reason: str
    prefix_hit_tokens: int = 0
    prefill_tokens_saved: int = 0


@dataclass
class _Live:
    request: Request
    generated: list = field(default_factory=list)
    prefix_hit_tokens: int = 0
    prefill_tokens_saved: int = 0


class Server:
    """Slot-based continuous-batching server over a paged KV pool.

    ``submit()`` enqueues (from any thread); ``step()`` runs one
    scheduler iteration and returns what finished; ``run()`` drives to
    completion as a generator. One thread owns stepping. ``eos_id`` is
    an int (-1 = none) or a list of ids (stop on any). The pool holds
    ``kv_pages`` pages of ``kv_page_size`` tokens (0 = auto: every slot
    can hold a full-length sequence); admission reserves each request's
    worst case, so pool pressure only delays admission. With
    ``prefix_cache_mb`` > 0 the prefix store shares pages copy-on-write.
    The model's device must be the one ``device`` resolves to (``cuda``
    unless ``device="cpu"``)."""

    def __init__(self, model, *, batch_size: int = 4, eos_id=-1,
                 min_bucket: int = 16, chunk_steps: int = 8,
                 max_pending: int = 1024, prefix_cache_mb: float = 0.0,
                 prefix_donate: bool = True, speculate_k: int = 0,
                 fault_plan=None, paged: bool | None = None,
                 kv_page_size: int = 0, kv_pages: int = 0,
                 prefill_chunk_tokens: int = 0, kv_host_mb: float = 0.0,
                 in_dispatch_eos: bool = True, mesh=None, page_pool=None,
                 device=None):
        cfg = model.cfg
        later = {
            "int8-weight (quantized) models": cfg.quantized,
            "sliding-window models": bool(cfg.sliding_window),
            "speculate_k > 0": speculate_k > 0,
            "mesh (sharded serving)": mesh is not None,
            "prefill_chunk_tokens > 0": prefill_chunk_tokens > 0,
            "kv_host_mb > 0 (host page tier)": kv_host_mb > 0,
            "a shared page_pool": page_pool is not None,
            "fault_plan": fault_plan is not None,
            "paged=False (fixed-shape cache rows)": paged is False,
            "in_dispatch_eos=False": not in_dispatch_eos,
        }
        for name, on in later.items():
            if on:
                raise NotImplementedError(
                    f"serving with {name} is not ported to PyTorch yet "
                    "(see ROADMAP.md)")
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model lives on {model.device}, the server "
                             f"was asked for {self.device}")
        self.model = model
        self.eos_ids = normalize_eos_ids(eos_id)
        self.min_bucket = min_bucket
        self.chunk_steps = max(1, chunk_steps)
        self.max_pending = max(1, max_pending)
        self.frozen_steps = 0   # positions spent frozen (no KV writes)
        self.freeze_faults = 0  # frozen-tail consistency violations
        ps = int(kv_page_size) or default_page_size(cfg)
        ps = max(1, min(ps, cfg.max_seq_len))
        max_pages = -(-cfg.max_seq_len // ps)
        n_pages = int(kv_pages) or batch_size * max_pages
        self.slots = SlotCache(model, batch_size,
                               PagePool(model, n_pages, ps))
        self.pending: deque[Request] = deque()
        self._pending_lock = threading.Lock()
        self._live: list[_Live | None] = [None] * batch_size
        self._ids = itertools.count()
        self.steps = 0       # decode micro-steps, summed over dispatches
        self.dispatches = 0  # decode chunks
        self.prefills = 0    # prefill forwards (exact hits skip one)
        # decode chunks and prefills replayed as CUDA graphs on the card
        self.graphs = GraphCache(self.device) \
            if self.device.type == "cuda" else None
        self.prefix = PrefixStore(int(prefix_cache_mb * (1 << 20)),
                                  self.slots.pool) \
            if prefix_cache_mb > 0 else None
        self.prefix_donate = prefix_donate
        self.prefix_lookups = 0
        self.prefix_hits = 0
        self.prefix_hit_tokens = 0
        self.prefill_tokens_saved = 0
        # the smallest useful entry is one page + its [1, V] fp32 logits
        entry_nbytes = self.slots.pool.page_nbytes + 4 * cfg.vocab_size
        if self.prefix is not None \
                and entry_nbytes > self.prefix.budget_bytes:
            # a store that cannot hold one entry would refuse every
            # insert: turn it off loudly
            log.warning(
                "prefix cache disabled: one cached entry needs %.1f MB, "
                "budget is %.1f MB (raise --prefix-cache-mb)",
                entry_nbytes / (1 << 20), prefix_cache_mb)
            self.prefix = None

    # ------------------------------------------------------------ intake

    def submit(self, request: Request):
        """Enqueue a request; returns its id. Rejects prompts the cache
        cannot hold, clamps max_new_tokens to the remaining capacity,
        raises ``PoolExhausted`` for a request no pool state could
        admit and ``QueueFull`` past ``max_pending``."""
        p = list(request.prompt)
        max_len = self.model.cfg.max_seq_len
        if not p:
            raise ValueError("empty prompt")
        if len(p) >= max_len:
            raise ValueError(
                f"prompt ({len(p)}) leaves no room for generation in "
                f"max_seq_len ({max_len})")
        if request.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if request.id is None:
            request.id = next(self._ids)
        request.max_new_tokens = min(request.max_new_tokens,
                                     max_len - len(p))
        pool = self.slots.pool
        worst = -(-(len(p) + request.max_new_tokens) // pool.page_size)
        if worst > pool.n_pages:
            raise PoolExhausted(
                f"request needs {worst} KV pages worst-case, the pool "
                f"holds {pool.n_pages} (raise --kv-pages or lower "
                "max_new_tokens)")
        with self._pending_lock:
            if len(self.pending) >= self.max_pending:
                raise QueueFull(f"pending queue at "
                                f"max_pending={self.max_pending}")
            self.pending.append(request)
        return request.id

    @property
    def n_pending(self) -> int:
        return len(self.pending)

    @property
    def n_active(self) -> int:
        return self.slots.n_active

    @property
    def done(self) -> bool:
        return not self.pending and self.slots.n_active == 0

    def live_progress(self) -> dict:
        """{request_id: tokens generated so far} for every in-flight
        request (copies)."""
        return {lv.request.id: list(lv.generated)
                for lv in self._live if lv is not None}

    # --------------------------------------------------------- scheduling

    def _admit_one(self, req: Request, finished: list) -> bool:
        """Admit ``req`` into a free slot: prefix lookup, worst-case page
        reservation (squeezing LRU store entries when tight; False =
        stay pending), page aliasing with a copy-on-write fork of a
        mid-page boundary, then either the exact-hit first-token sample
        or a prefill of the bucketed suffix straight into the slot's
        pages. A request whose first token already ends it finishes
        here without arming the slot."""
        s = self.slots
        pool = s.pool
        ps = pool.page_size
        p = np.asarray(req.prompt, np.int64)
        max_len = self.model.cfg.max_seq_len
        slot = s.free_slots()[0]
        off, entry = 0, None
        if self.prefix is not None:
            self.prefix_lookups += 1
            off, entry = self.prefix.acquire(p)
        full_bucket = bucket_len(len(p), max_len, self.min_bucket)
        exact = (entry is not None and off == len(p)
                 and len(entry.tokens) == len(p)
                 and entry.logits is not None)
        if not exact and entry is not None:
            # partial hit: seed at most len(p) - 1 tokens so >= 1 real
            # token remains to prefill the first-continuation logits
            off = min(off, len(p) - 1)
            if off <= 0:
                self.prefix.release(entry)
                off, entry = 0, None
        seed = len(p) if exact else off
        worst = -(-(len(p) + req.max_new_tokens) // ps)
        n_alias = -(-seed // ps)
        fork = 1 if seed % ps else 0
        need = worst - n_alias + fork
        granted = pool.reserve(need)
        while not granted and self.prefix is not None \
                and self.prefix.evict_one():
            granted = pool.reserve(need)
        if not granted:
            if entry is not None:
                self.prefix.release(entry)
            if self.prefix is not None:
                self.prefix_lookups -= 1
            return False
        gen = None
        if req.temperature > 0.0:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(int(req.seed))
        hit_tokens = saved = 0
        try:
            s.seed_pages(slot, entry.pages if entry is not None else [],
                         seed, need)
            if exact:
                tok = _sample_first(entry.logits, req.temperature,
                                    req.top_k, gen)
                hit_tokens, saved = len(p), full_bucket
            else:
                suffix = p[off:]
                lb = bucket_len(len(suffix), max_len, self.min_bucket)
                s.ensure_pages(slot, len(p))
                # the view spans the prompt's page bucket, not max_len
                cols = min(_bucket_pow2(-(-len(p) // ps)), s.max_pages)
                flat = np.full(2 * lb + cols + 1, -1, np.int64)
                flat[:lb] = 0
                flat[:len(suffix)] = suffix
                flat[lb:lb + len(suffix)] = off + np.arange(len(suffix))
                flat[2 * lb:2 * lb + cols] = s.page_table[slot, :cols]
                flat[-1] = len(suffix) - 1
                # a copy: a replay's output is overwritten by the next
                last = self._dispatch("prefill", (lb, cols), flat,
                                      functools.partial(
                                          _prefill_last, self.model,
                                          s.cache, lb=lb,
                                          cols=cols)).clone()
                tok = _sample_first(last, req.temperature, req.top_k, gen)
                self.prefills += 1
                if self.prefix is not None:
                    self.prefix.insert(p, s.slot_pages(slot, len(p)),
                                       logits=last)
                if entry is not None:
                    hit_tokens, saved = off, full_bucket - lb
        finally:
            if entry is not None:
                self.prefix.release(entry)
        if hit_tokens:
            self.prefix_hits += 1
            self.prefix_hit_tokens += hit_tokens
            self.prefill_tokens_saved += saved
        if tok in self.eos_ids or req.max_new_tokens == 1:
            reason = "eos" if tok in self.eos_ids else "length"
            finished.append(Result(req.id, list(req.prompt), [tok], reason,
                                   hit_tokens, saved))
            s.release_pages(slot)
            return True
        s.admit(slot, len(p), tok, req.temperature, req.top_k, gen)
        self._live[slot] = _Live(req, [tok], hit_tokens, saved)
        return True

    def _tensor(self, x: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.int64, device=self.device)

    def _dispatch(self, kind: str, shape: tuple, flat: np.ndarray, fn):
        """``fn`` on the packed int64 inputs ``flat``, copied to the
        device in one transfer: replayed at the key ``(kind, *shape)``
        (its first call eager, then captured), or eager on the CPU."""
        if self.graphs is None:
            return fn(self._tensor(flat))
        e = self.graphs.entry((kind, *shape), lambda: (torch.empty(
            flat.size, dtype=torch.int64, device=self.device),))
        e.statics[0].copy_(torch.from_numpy(flat))
        return self.graphs.run(e, fn)

    def _run_chunk(self, flat: np.ndarray, k: int, cols: int) -> np.ndarray:
        """One decode chunk of ``k`` micro-steps over the first ``cols``
        page columns, on packed inputs (``_decode_chunk``); returns the
        tokens [b, k] on the host. A chunk with a live sampled row runs
        eagerly and is counted so."""
        s = self.slots
        fn = functools.partial(
            _decode_chunk, self.model, s.cache, b=s.batch_size, cols=cols,
            temps=s.temperature.copy(), top_ks=s.top_k.copy(),
            generators=list(s.generators), n_steps=k, eos_ids=self.eos_ids)
        if self.graphs is not None and (s.temperature > 0).any():
            toks = self.graphs.eager("decode", fn, self._tensor(flat))
        else:
            toks = self._dispatch("decode", (k, cols), flat, fn)
        return toks.cpu().numpy()

    def _chunk_size(self) -> int:
        """Micro-steps for this round: enough for the longest-remaining
        live slot, capped at ``chunk_steps``, rounded DOWN to a power of
        two."""
        rem = max(live.request.max_new_tokens - len(live.generated)
                  for live in self._live if live is not None)
        k = 1
        while k * 2 <= min(self.chunk_steps, rem):
            k *= 2
        return k

    def step(self) -> list[Result]:
        """One scheduler iteration: admit, one decode round, evict;
        returns the requests that finished."""
        finished: list[Result] = []
        while self.slots.free_slots():
            with self._pending_lock:
                if not self.pending:
                    break
                req = self.pending.popleft()
            if not self._admit_one(req, finished):
                # the pool cannot grant the reservation now: requeue at
                # the FRONT and stop admitting until pages free
                with self._pending_lock:
                    self.pending.appendleft(req)
                break
        if self.slots.n_active:
            finished.extend(self._decode_round())
        return finished

    def _prepare_chunk(self) -> tuple[int, int, np.ndarray]:
        """The next chunk's micro-steps ``k``, page columns ``cols`` and
        packed inputs (``_decode_chunk``: the slots' last tokens,
        positions, remaining budgets and the table's first ``cols``
        columns). The page table is fixed across the chunk, so every
        live slot is first grown to cover the positions the chunk writes
        (capped at its budget), and the table is column-sliced to a
        power-of-two bucket of the live extent."""
        s = self.slots
        k = self._chunk_size()
        hi = 0
        rem = np.zeros(s.batch_size, np.int64)
        for slot, live in enumerate(self._live):
            if live is not None:
                s.ensure_pages(slot, min(
                    int(s.lengths[slot]) + k,
                    len(live.request.prompt) + live.request.max_new_tokens))
                hi = max(hi, int(s.lengths[slot]) + k)
                rem[slot] = live.request.max_new_tokens \
                    - len(live.generated)
        cols = min(_bucket_pow2(-(-hi // s.pool.page_size)), s.max_pages)
        flat = np.concatenate([s.last_token, s.positions(), rem,
                               s.page_table[:, :cols].ravel()])
        return k, cols, flat.astype(np.int64)

    def _decode_round(self) -> list[Result]:
        """One decode chunk over the live slots + EOS/evict."""
        finished: list[Result] = []
        s = self.slots
        k, cols, flat = self._prepare_chunk()
        toks = self._run_chunk(flat, k, cols)
        self.steps += k
        self.dispatches += 1
        for slot in range(s.batch_size):
            live = self._live[slot]
            if live is None:
                continue
            req = live.request
            reason = None
            for j in range(k):
                tok = int(toks[slot, j])
                live.generated.append(tok)
                if tok in self.eos_ids:
                    reason = "eos"
                elif len(live.generated) >= req.max_new_tokens:
                    reason = "length"
                if reason:
                    break
            if reason is None:
                s.lengths[slot] += k
                s.last_token[slot] = int(toks[slot, k - 1])
                continue
            # the trailing positions were frozen re-emits: the trim is a
            # consistency check
            self.frozen_steps += k - (j + 1)
            if j + 1 < k and not (toks[slot, j + 1:] == toks[slot, j]).all():
                self.freeze_faults += 1
            finished.append(Result(req.id, list(req.prompt),
                                   live.generated, reason,
                                   live.prefix_hit_tokens,
                                   live.prefill_tokens_saved))
            if self.prefix is not None and self.prefix_donate:
                self._donate(live, slot)
            self._live[slot] = None
            s.evict(slot)
        return finished

    def _donate(self, live: _Live, slot: int) -> None:
        """Give a finished slot's sequence back to the prefix store by
        REFERENCE (a refcount on the slot's pages): its pages are
        position-exact over prompt + generated[:-1] (the final token was
        sampled but never fed)."""
        seq = np.asarray(list(live.request.prompt) + live.generated[:-1],
                         np.int64)
        if seq.size:
            self.prefix.insert(seq, self.slots.slot_pages(slot,
                                                          int(seq.size)))

    def drain(self) -> list[Result]:
        """Finish every in-flight slot (no new admissions); pending
        requests stay queued."""
        finished: list[Result] = []
        while self.slots.n_active:
            finished.extend(self._decode_round())
        return finished

    def counters(self) -> dict:
        """Engine counters: dispatch/step totals, frozen-step accounting,
        prefix-store and page-pool state; on the card also the graphs:
        ``graph_{decode|prefill}_{captures|replays|eager}`` (a capture is
        the first call at its key, so captures + replays + eager equals
        ``dispatches`` or ``prefills``) and ``graph_capture_s``."""
        out = {
            "prefills": self.prefills,
            "decode_steps": self.steps,
            "dispatches": self.dispatches,
            "frozen_steps": self.frozen_steps,
            "freeze_faults": self.freeze_faults,
            "prefix_lookups": self.prefix_lookups,
            "prefix_hits": self.prefix_hits,
            "prefix_hit_tokens": self.prefix_hit_tokens,
            "prefill_tokens_saved": self.prefill_tokens_saved,
        }
        if self.prefix is not None:
            st = self.prefix.stats()
            out["prefix_entries"] = st["entries"]
            out["prefix_bytes"] = st["bytes"]
            out["prefix_budget_bytes"] = st["budget_bytes"]
            out["prefix_evictions"] = st["evictions"]
        if self.graphs is not None:
            for name, n in self.graphs.counters(("decode",
                                                  "prefill")).items():
                out["graph_" + name] = n
        ps = self.slots.pool.stats()
        out["kv_pages_total"] = ps["total"]
        out["kv_pages_used"] = ps["used"]
        out["kv_pages_free"] = ps["free"]
        out["kv_pages_reserved"] = ps["reserved"]
        out["kv_cow_shared"] = ps["cow_shared"]
        out["kv_cow_forks"] = ps["forks"]
        out["kv_page_size"] = ps["page_size"]
        out["kv_bytes_resident"] = ps["bytes_resident"]
        return out

    def reset(self) -> None:
        """Drop pending and in-flight requests and free every slot (no
        Result for the dropped ones)."""
        with self._pending_lock:
            self.pending.clear()
        self._live = [None] * self.slots.batch_size
        self.slots.reset()

    def run(self, requests: Iterable[Request] = ()) -> Iterator[Result]:
        """Submit ``requests`` and drive the loop until everything
        finishes."""
        for r in requests:
            self.submit(r)
        while not self.done:
            yield from self.step()
