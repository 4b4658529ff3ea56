"""Continuous-batching scheduler over a paged or a fixed-shape KV cache:
the counterpart of ``tony_tpu/serve/engine.py``.

Each ``step()`` admits pending prompts into free slots, advances any
chunked prefills by one chunk, then runs one decode round for every
live slot and evicts the slots that finished. Paged (the default but
for sliding-window models, as in the JAX package), a prefill is one
multi-token window written straight into the slot's pages, and an
exact prefix-store hit makes no model call at all. Unpaged
(``paged=False``, and every sliding-window model), the slots are the
rows of one resident cache: a prefill is the scalar-index forward over
the slot's row at the prompt's offset (the JAX package's batch-1
prefill, whose row it then places in the slot), an exact hit copies a
stored row into the slot, and the decode micro-steps run straight on
the resident rows. A decode round is a CHUNK of K
micro-steps, or, with speculation on and a slot drafting, one VERIFY
round. The JAX package runs each as one jitted dispatch. On the card
the port replays each as a CUDA graph (``models.graphs``):

- a chunk keyed by ``("decode", K, page columns)`` holds the page
  gather (``paged_view``), the K micro-steps with their sampling and
  frozen-row carry, and the write-back to the pool
  (``paged_write_back``);
- a prefill keyed by ``("prefill", bucket, page columns)`` holds the
  forward and the last real position's logits;
- an intermediate prefill chunk, ``("prefill_chunk", bucket, page
  columns)``, holds the forward up to the final activations (its logits
  are never used, so the LM head is not run);
- a verify round, ``("verify", window, continuation steps, page
  columns)``, holds the window pass over every slot's last token and
  draft, the greedy verdicts and the accepted run, and (in-dispatch EOS
  on) the continuation micro-steps from each slot's bonus token, then
  one write-back of the whole span.

Unpaged, the chunk replays at ``("chunk_rows", K)`` and the verify
round at ``("verify_rows", window, continuation steps)``, with the
resident cache as their static state and no gather or write-back; the
prefill runs eagerly, one dispatch an admission or chunk, counted as
``prefill_rows`` eager calls.

The host packs each call's inputs into one buffer, copies it up,
replays, and reads the result back: one H2D and one D2H copy a call.
The first call at a key runs eagerly and is then captured. Each chunk
and verify round key has two variants, picked on the host from the
slots' temperatures: greedy (every row takes the argmax, as the JAX
engine's ``lax.cond`` skips its sampler for an all-greedy batch) and,
once any live slot samples, sampled (the key with a ``"sampled"``
suffix): every micro-step draws on the device (``ops.sampling.
sample_rows``: a top-k cut by rank and a Threefry draw a row) from the
slots' device temperatures, top-ks and keys, and the keys advance in
place inside the graph; nothing is read back to the host. A prefill's
first-token sample runs after the graph. On the CPU every call runs
eagerly.

With in-dispatch EOS on (the default) a slot that samples EOS or spends
its budget mid-chunk FREEZES: its later micro-steps write nothing, draw
nothing, and re-emit its last token. With it off, every row decodes
every micro-step and the host trims the overshoot (``wasted_steps``).

Speculation (``speculate_k``) drafts by prompt lookup on the host
(``_propose_draft``) and verifies every slot's draft in one window
pass; a rejected draft is rewound by pointer arithmetic (its K/V stays
past the slot's length, hidden by the masks, overwritten later).
Chunked prefill (``prefill_chunk_tokens``) parks a long prompt's slot
and writes one chunk a step between decode rounds. ``fault_plan``
(``serve.faults``) fires at the top of ``step()`` and before an
admission's prefill, never inside a capture; the fault reaches the
caller, and ``reset()`` frees every page.

Greedy outputs are token-exact against the JAX ``Server`` on the same
weights and request mix (tests/test_torch_serve.py, test_torch_spec.py,
test_torch_chunked_prefill.py), and so are sampled ones
(tests/test_torch_sampled_serving.py): a request's key is
``PRNGKey(Request.seed)``, split once a draw, and its draws are the JAX
package's Threefry bits; they part only where ``torch.log`` and XLA's
``log`` round a Gumbel variate differently at a near tie.

Each admission, prefill chunk, decode chunk and verify round leaves
one record on the dispatch timeline (``obs.timeline``, ``timeline=True``
by default), priced by ``obs.goodput.CostModel`` against the card's
roofline; ``goodput()`` folds the records into the goodput ledger. A
record's duration is the host's wall time up to the host copy of the
call's tokens that the call makes anyway (an intermediate prefill chunk
has none: its record closes when it is enqueued, and on the card it
carries no bytes or FLOPs estimate, which that time would misprice);
its first-call flag
says the call ran a graph key's first call (eager, then captured). No
record adds a sync.

On the card every ``step()``, ``drain()`` and ``reset()`` holds
``models.graphs.DEVICE`` shared, and a capture holds it exclusively:
several servers in one process (the gateway's replicas, each stepped by
its own thread) never meet a capture with device work of their own.

The KV fabric (paged only), as the JAX package has it: a
``prefill_only`` request leaves as a handoff of its prompt's pages and
logits, which a ``Request(handoff=...)`` admits elsewhere (the role
split); ``extract_session`` freezes a live slot between two dispatches
and a ``Request(migrate=...)`` adopts it (live migration); a pool lent
to several servers (``page_pool``, ``PagePool(shared=True)``) turns both
into page-table swaps; ``kv_host_mb`` spills evicted prefix entries to
host RAM and pages them back in (``serve.tier``). Their page moves are
eager gathers and scatters on the current stream, never inside a
capture. ``step``, ``drain``, ``reset`` and ``extract_session`` hold
the engine's own ``_dispatch_lock``.

Refused by the constructor, as the JAX package refuses them: a paged
cache or a prefix store over a sliding-window model, a shared pool or
the host tier without the paged cache (the tier without a prefix store
too). Left out, refused too: a mesh and int8-weight models.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import logging
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Iterable, Iterator

import numpy as np
import torch

from tony_tpu_torch.models.generate import (_is_eos, is_layer_key,
                                            multi_decode_step,
                                            normalize_eos_ids,
                                            single_decode_step)
from tony_tpu_torch.models.graphs import DEVICE, GraphCache
from tony_tpu_torch.obs.goodput import (CostModel, detect_hbm_gbps,
                                        detect_peak_flops, ledger)
from tony_tpu_torch.obs.timeline import DispatchRecord, DispatchTimeline
from tony_tpu_torch.ops.decode import flash_decode
from tony_tpu_torch.ops.platform import resolve_device
from tony_tpu_torch.ops.sampling import key_tensor, sample_rows
from tony_tpu_torch.serve.faults import FaultPlan
from tony_tpu_torch.serve.migrate import (SessionSnapshot, StaleDelta,
                                          snapshot_from_doc)
from tony_tpu_torch.serve.prefix import PrefixStore
from tony_tpu_torch.serve.slots import (PagePool, SlotCache,
                                        default_page_size, gather_pages,
                                        paged_view, paged_write_back,
                                        pool_leaf_keys, read_slot_row,
                                        row_nbytes, scatter_pages,
                                        slot_view, write_slot_row)
from tony_tpu_torch.serve.tier import (HostPageTier, decode_array,
                                       decode_payload, pages_to_host,
                                       payload_pages)

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


def _propose_draft(ctx: np.ndarray, k: int,
                   max_ngram: int = 3) -> np.ndarray:
    """Prompt-lookup drafting: find the most RECENT earlier occurrence
    of the longest suffix n-gram of ``ctx`` (n from ``max_ngram`` down
    to 1) and propose the up-to-``k`` tokens that followed it. No draft
    model, no device work: one numpy scan over the context a live slot
    a round. Returns [0..k] proposed tokens (empty = no match)."""
    n_ctx = len(ctx)
    for n in range(min(max_ngram, n_ctx - 1), 0, -1):
        pat = ctx[n_ctx - n:]
        # windows over ctx[:-1]: every start with >= 1 token following
        # the match; the suffix itself is structurally excluded
        win = np.lib.stride_tricks.sliding_window_view(ctx[:-1], n)
        hits = np.flatnonzero((win == pat).all(axis=1))
        if hits.size:
            start = int(hits[-1]) + n
            return ctx[start:start + k]
    return ctx[:0]


def _pick(last, samp, done=None):
    """The next token of every row from its logits ``last`` [b, V]:
    the argmax when ``samp`` is None (the greedy variant), else
    ``ops.sampling.sample_rows`` over ``samp`` = (temperatures, top-ks,
    keys), ``done`` rows greedy and their keys kept. Returns (tokens,
    samp with the keys advanced)."""
    if samp is None:
        return torch.argmax(last, dim=-1), None
    temps, top_ks, keys = samp
    tok, keys = sample_rows(last, keys, temps, top_ks, done)
    return tok, (temps, top_ks, keys)


def _sample_first(logits, temp: float, top_k: int, seed: int):
    """The first continuation from the last prompt position's logits
    [1, V] with THIS request's knobs, as the JAX package's admits draw
    it: from ``PRNGKey(seed)``, split once when the request samples.
    Returns (token, the key [2] to carry, or None for a greedy
    request)."""
    if temp <= 0.0:
        return int(torch.argmax(logits[0])), None
    dev = logits.device
    tok, keys = sample_rows(
        logits, key_tensor(seed, dev)[None],
        torch.full((1,), temp, dtype=torch.float32, device=dev),
        torch.full((1,), top_k, dtype=torch.int64, device=dev))
    return int(tok[0]), keys[0]


def _usable_prefix(off: int, n: int, max_len: int, minimum: int) -> int:
    """Largest usable seed length <= ``off`` for an ``n``-token prompt
    on the unpaged cache: the suffix's bucket must still fit the row
    (``off + bucket <= max_len``). Shrinking ``off`` grows the suffix
    (and maybe its bucket), so iterate; 0 (full prefill) always fits."""
    while off > 0:
        lb = bucket_len(n - off, max_len, minimum)
        if off + lb <= max_len:
            return off
        off = max(0, max_len - lb)
    return 0


@torch.no_grad()
def _prefill_rows(model, cache, slot: int, window, offset: int,
                  last: int | None):
    """The unpaged prefill: the window [1, Lb] (a prompt's suffix,
    right-padded to its bucket) through the scalar-index forward over
    slot ``slot``'s row of the resident ``cache``, written, rotated and
    attended from position ``offset`` (``slot_view``). The padding's
    K/V lands past the prompt, where the slot's length hides it until
    decode overwrites it. Returns the logits [1, V] at window index
    ``last``, or nothing (an intermediate chunk: no LM head)."""
    hidden = model(window, decode=True, cache=slot_view(cache, slot, offset),
                   return_hidden=True)
    if last is not None:
        return model.logits(hidden[0, last:last + 1])
    return None


def _window_inputs(flat, lb: int):
    """A prefill's window [1, lb] and positions [1, lb], the head of its
    packed inputs ``flat``."""
    return flat[:lb][None], flat[lb:2 * lb][None]


@torch.no_grad()
def _prefill_last(model, cache, flat, lb: int, cols: int):
    """The paged admit's forward on its packed inputs ``flat`` = window
    [lb] | positions [lb] | table row [cols] | last real index [1]: the
    window (the prompt's suffix, right-padded to its bucket; padding at
    position -1, whose writes drop) goes through the pool in one
    forward. Only the last real position's activations reach the LM
    head; returns its logits [1, V]."""
    window, positions = _window_inputs(flat, lb)
    table = flat[2 * lb:2 * lb + cols][None]
    hidden = model(window, decode=True, positions=positions,
                   page_table=table, cache=cache, return_hidden=True)
    return model.logits(hidden[0].index_select(0, flat[-1:]))


@torch.no_grad()
def _paged_prefill_chunk(model, cache, flat, lb: int, cols: int):
    """One INTERMEDIATE chunk of a chunked prefill on packed inputs
    ``flat`` = window [lb] | positions [lb] | table row [cols]: the
    window written straight into the slot's pages, with no sampling
    (only the final chunk holds the prompt's last position) and no LM
    head (its logits would be dropped)."""
    window, positions = _window_inputs(flat, lb)
    model(window, decode=True, positions=positions,
          page_table=flat[2 * lb:2 * lb + cols][None], cache=cache,
          return_hidden=True)


def _frozen_steps(model, view, tok, positions, rem, done, n_steps: int,
                  samp, eos_ids: tuple):
    """``n_steps`` in-dispatch-EOS micro-steps on the page ``view`` from
    carry ``(tok, positions, rem, done)``: a row that emits an eos id or
    spends its budget ``rem`` freezes — its later micro-steps write to
    position -1 (dropped), take the greedy path (no draw) and re-emit
    its token. Shared by the decode chunk and the verify round's
    continuation. Returns the emitted tokens [b, n_steps] and ``samp``
    (``_pick``) with the keys advanced."""
    out = []
    for _ in range(n_steps):
        eff_pos = torch.where(done, torch.full_like(positions, -1),
                              positions)
        view, last = single_decode_step(model, view, tok, positions=eff_pos)
        nxt, samp = _pick(last, samp, done)
        nxt = torch.where(done, tok, nxt)
        positions = torch.where(done | (positions < 0), positions,
                                positions + 1)
        rem = torch.where(done, rem, rem - 1)
        done = done | _is_eos(nxt, eos_ids) | (rem <= 0)
        tok = nxt
        out.append(nxt)
    return torch.stack(out, dim=1), samp


def _keep_keys(rows: tuple, samp) -> None:
    """Write the advanced keys back into the slots' key tensor, in place
    (inside a graph, the replay's own update)."""
    if rows:
        rows[2].copy_(samp[2])


@torch.no_grad()
def _decode_chunk(model, cache, flat, *rows, b: int, cols: int,
                  n_steps: int, eos_ids: tuple, freeze: bool = True):
    """``n_steps`` decode micro-steps for every slot over the page view,
    on packed inputs ``flat`` = tokens [b] | positions [b] | remaining
    budgets [b] | page table [b, cols]; ``cols`` = 0 runs them straight
    on the resident rows of an unpaged cache (no table in ``flat``).
    ``rows`` is empty for the greedy variant (every row takes the
    argmax) and the slots' device (temperatures, top-ks, keys) for the
    sampled one, whose keys advance in place. ``freeze`` (in-dispatch
    EOS) runs ``_frozen_steps``, empty slots (position < 0) starting
    frozen; without it every row decodes every micro-step and draws, and
    the host trims what follows a finish. Returns the emitted tokens
    [b, n_steps]; the cache is updated in place."""
    tok, positions, rem = flat[:b], flat[b:2 * b], flat[2 * b:3 * b]
    table = flat[3 * b:].view(b, cols)
    max_len = model.cfg.max_seq_len
    start = positions
    samp = rows or None
    view = paged_view(cache, table, max_len) if cols else cache
    if freeze:
        toks, samp = _frozen_steps(model, view, tok, positions, rem,
                                   positions < 0, n_steps, samp, eos_ids)
    else:
        out = []
        for _ in range(n_steps):
            view, last = single_decode_step(model, view, tok,
                                            positions=positions)
            tok, samp = _pick(last, samp)
            positions = torch.where(positions >= 0, positions + 1,
                                    positions)
            out.append(tok)
        toks = torch.stack(out, dim=1)
    if cols:
        paged_write_back(cache, view, table, start, n_steps, max_len)
    _keep_keys(rows, samp)
    return toks


@torch.no_grad()
def _verify_chunk(model, cache, flat, *rows, b: int, window: int, cols: int,
                  n_steps: int, eos_ids: tuple):
    """The speculative verify round on packed inputs ``flat`` = tokens
    [b, window] | positions [b, window] | draft lengths [b] | remaining
    budgets [b] | page table [b, cols], and ``rows`` as
    ``_decode_chunk`` takes them. Row i is ``[last_token, draft_1
    .. draft_d, pad..]`` at ``[p, p+1 .. p+d, -1..]`` (padding writes
    drop). One window pass scores every row (``multi_decode_step``):

    - ``emit[i, 0]`` follows ``last_token`` under the row's own knobs
      (a sampled row draws once); ``emit[i, 1:]`` are greedy verdicts;
    - ``accepted[i]`` is the leading run of drafts equal to the previous
      position's verdict; the host appends ``emit[i, :accepted + 1]``.

    ``n_steps`` > 0 is the FUSED round (in-dispatch EOS): ``accepted``
    is capped at the first emitted eos id, and every row continues
    ``n_steps`` frozen micro-steps (``_frozen_steps``, flash-decode)
    from its own bonus verdict, all on one page view, then one
    ``paged_write_back`` returns the whole ``window + n_steps`` span
    (positions a row did not write copy their gathered bytes back).
    ``n_steps`` = 0 runs the window pass on the pool directly. ``cols``
    = 0 runs all of it straight on the resident rows of an unpaged
    cache (no table in ``flat``, no gather, no write-back).

    Returns ``emit [b, window] | accepted [b] | cont [b, n_steps]`` as
    one [b, window + 1 + n_steps] tensor."""
    bw = b * window
    toks = flat[:bw].view(b, window)
    positions = flat[bw:2 * bw].view(b, window)
    draft_len = flat[2 * bw:2 * bw + b]
    rem = flat[2 * bw + b:2 * bw + 2 * b]
    table = flat[2 * bw + 2 * b:].view(b, cols)
    max_len = model.cfg.max_seq_len
    start = positions[:, 0]
    if not cols:
        view = cache
        _, logits = multi_decode_step(model, cache, toks, positions)
    elif n_steps > 0:
        view = paged_view(cache, table, max_len)
        _, logits = multi_decode_step(model, view, toks, positions)
    else:
        _, logits = multi_decode_step(model, cache, toks, positions,
                                      page_table=table)
    greedy = torch.argmax(logits, dim=-1)  # [b, window]
    tok0, samp = _pick(logits[:, 0], rows or None)
    emit = torch.cat([tok0[:, None], greedy[:, 1:]], dim=1)
    j = torch.arange(window - 1, device=flat.device)[None, :]
    match = (toks[:, 1:] == greedy[:, :-1]) & (j < draft_len[:, None])
    accepted = torch.cumprod(match.long(), dim=1).sum(dim=1)
    if n_steps == 0:
        _keep_keys(rows, samp)
        return torch.cat([emit, accepted[:, None]], dim=1)
    if eos_ids:
        # the host stops at the first eos id: capping accepted there
        # makes the device agree that nothing past it was accepted
        idx = torch.arange(window, device=flat.device)[None, :]
        first_stop = torch.where(_is_eos(emit, eos_ids), idx,
                                 torch.full_like(idx, window)).amin(dim=1)
        accepted = torch.minimum(accepted, first_stop)
    rows_i = torch.arange(b, device=flat.device)
    bonus = emit[rows_i, accepted]
    live = start >= 0
    consumed = accepted + 1
    rem_c = torch.where(live, rem - consumed, torch.zeros_like(rem))
    done = ~live | _is_eos(bonus, eos_ids) | (rem_c <= 0)
    cont_pos = torch.where(live, start + consumed, torch.full_like(start, -1))
    cont, samp = _frozen_steps(model, view, bonus, cont_pos, rem_c, done,
                               n_steps, samp, eos_ids)
    if cols:
        paged_write_back(cache, view, table, start, window + n_steps,
                         max_len)
    _keep_keys(rows, samp)
    return torch.cat([emit, accepted[:, None], cont], dim=1)


class QueueFull(RuntimeError):
    """``submit()`` refused: the pending queue is at ``max_pending``."""


class PoolExhausted(RuntimeError):
    """``submit()`` refused: the request's worst-case KV-page need
    exceeds the ENTIRE page pool, so it could never be admitted.
    Transient pressure never raises: the request stays pending."""


@dataclass
class Request:
    """One generation request: ``prompt`` token ids and per-request
    sampling knobs (greedy default); ``id`` is echoed on the Result.

    The role-split fields (paged only): ``prefill_only`` stops after the
    prefill, and the Result comes back ``finish_reason="handoff"`` with
    the prompt's page content and last-position logits in place of
    tokens; ``handoff`` is the other half, such a payload, which the
    admission scatters into fresh pages before it samples the first
    token with THIS request's knobs and seed and decodes (token-exact
    against one engine doing both). ``migrate`` adopts a
    ``SessionSnapshot`` (or its wire doc) that another engine froze with
    ``extract_session``: no prefill and no first draw, decode resumes at
    the exact position."""

    prompt: list
    max_new_tokens: int
    temperature: float = 0.0
    top_k: int = 0
    seed: int = 0
    id: Any = None
    prefill_only: bool = False
    handoff: Any = None
    migrate: Any = None


@dataclass
class Result:
    """A finished request: ``tokens`` = generated ids (a hit eos id is
    the last element); ``finish_reason`` is "eos" or "length".
    ``prefix_hit_tokens`` = prompt tokens seeded from the prefix store;
    ``prefill_tokens_saved`` = bucketed prefill work skipped;
    ``drafted``/``accepted`` = draft tokens this request sent through
    verify rounds / had accepted; ``prefill_chunks`` = prefill
    dispatches its prompt took (>= 2 means chunked; 0 = exact hit);
    ``handoff`` = a prefill_only run's payload."""

    id: Any
    prompt: list
    tokens: list
    finish_reason: str
    prefix_hit_tokens: int = 0
    prefill_tokens_saved: int = 0
    drafted: int = 0
    accepted: int = 0
    prefill_chunks: int = 0
    # finish_reason "handoff" only: the page payload and last-position
    # logits a prefill_only run produced
    handoff: Any = None

    @property
    def draft_hit_rate(self) -> float:
        """Fraction of drafted tokens accepted (0.0 with no drafts)."""
        return self.accepted / self.drafted if self.drafted else 0.0


@dataclass
class _Live:
    request: Request
    generated: list = field(default_factory=list)
    prefix_hit_tokens: int = 0
    prefill_tokens_saved: int = 0
    drafted: int = 0
    accepted: int = 0
    prefill_chunks: int = 0


@dataclass
class _PrefillState:
    """A slot mid-CHUNKED-prefill: reserved and seeded, its prompt
    written up to ``done``, not yet decoding; it is neither free nor in
    the decode batch until its final chunk samples the first token."""

    request: Request
    done: int
    chunks: int
    hit_tokens: int
    saved: int


class Server:
    """Slot-based continuous-batching server over a paged KV pool or
    fixed-shape cache rows.

    ``submit()`` enqueues (from any thread); ``step()`` runs one
    scheduler iteration and returns what finished; ``run()`` drives to
    completion as a generator. One thread owns stepping. ``eos_id`` is
    an int (-1 = none) or a list of ids (stop on any). ``paged`` (None =
    on unless the model has a sliding window; True over a window is
    refused) picks the cache. Paged, the pool holds ``kv_pages`` pages
    of ``kv_page_size`` tokens (0 = auto: every slot can hold a
    full-length sequence); admission reserves each request's worst
    case, so pool pressure only delays admission; the prefix store
    (``prefix_cache_mb`` > 0) shares pages copy-on-write. Unpaged, the
    cache is ``batch_size`` resident rows of ``max_seq_len`` and the
    store keeps copied rows (refused over a sliding window).

    ``speculate_k`` > 0 drafts up to k tokens a greedy slot a round by
    prompt lookup and verifies them in one window pass; greedy outputs
    are unchanged, and a per-slot acceptance EMA (``SPEC_EMA_DECAY``,
    floor ``SPEC_EMA_DISABLE``) silences hopeless drafters.
    ``prefill_chunk_tokens`` > 0 (quantized down to the bucket grid)
    writes a longer prompt in chunks, one a step, between decode
    rounds. ``fault_plan`` injects failures (``serve.faults``).
    ``in_dispatch_eos=False`` decodes every micro-step of every row and
    trims on the host (the JAX package's A/B control). ``timeline``
    keeps the dispatch timeline (``goodput()``); ``hbm_gbps`` > 0 sets
    the roofline's memory rate (0: the card's, from
    ``obs.goodput.HBM_BW_TABLE``; unknown: no utilization).
    ``page_pool`` (a ``PagePool(shared=True)``) lends one pool to several
    servers; ``kv_host_mb`` > 0 puts a host-RAM tier of that size under
    the prefix store (``serve.tier``).

    The model's device must be the one ``device`` resolves to (``cuda``
    unless ``device="cpu"``)."""

    # a slot drafts while its acceptance EMA (1.0 at admit, updated a/d
    # each verify round it drafted in) stays >= SPEC_EMA_DISABLE
    SPEC_EMA_DECAY = 0.5
    SPEC_EMA_DISABLE = 0.25

    def __init__(self, model, *, batch_size: int = 4, eos_id=-1,
                 min_bucket: int = 16, chunk_steps: int = 8,
                 max_pending: int = 1024, prefix_cache_mb: float = 0.0,
                 prefix_donate: bool = True, speculate_k: int = 0,
                 fault_plan: FaultPlan | None = None,
                 paged: bool | None = None, kv_page_size: int = 0,
                 kv_pages: int = 0, prefill_chunk_tokens: int = 0,
                 kv_host_mb: float = 0.0, in_dispatch_eos: bool = True,
                 timeline: bool = True, hbm_gbps: float = 0.0,
                 mesh=None, page_pool=None, device=None):
        cfg = model.cfg
        later = {
            "int8-weight (quantized) models": cfg.quantized,
            "mesh (sharded serving)": mesh is not None,
        }
        for name, on in later.items():
            if on:
                raise NotImplementedError(
                    f"serving with {name} is not ported to PyTorch yet "
                    "(see ROADMAP.md)")
        # the JAX package's refusals: bitwise greedy parity of these
        # against its unpaged windowed prefill is unpinned there
        if prefix_cache_mb > 0 and cfg.sliding_window:
            raise NotImplementedError(
                "prefix cache over sliding-window models is untested")
        if paged and cfg.sliding_window:
            raise NotImplementedError(
                "paged KV cache over sliding-window models is untested")
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model lives on {model.device}, the server "
                             f"was asked for {self.device}")
        self.model = model
        self.fault_plan = fault_plan
        self.eos_ids = normalize_eos_ids(eos_id)
        self.min_bucket = min_bucket
        self.in_dispatch_eos = bool(in_dispatch_eos)
        self.chunk_steps = max(1, chunk_steps)
        self.max_pending = max(1, max_pending)
        self.frozen_steps = 0   # positions spent frozen (no KV writes)
        self.freeze_faults = 0  # frozen-tail consistency violations
        self.paged = not cfg.sliding_window if paged is None \
            else bool(paged)
        if page_pool is not None and not self.paged:
            raise ValueError("a shared page_pool needs the paged KV "
                             "cache")
        if self.paged:
            if page_pool is not None:
                # a fleet pool lent to every co-located engine: the
                # device dict stays the pool's (serve.slots.PagePool)
                pool = page_pool
            else:
                ps = int(kv_page_size) or default_page_size(cfg)
                ps = max(1, min(ps, cfg.max_seq_len))
                max_pages = -(-cfg.max_seq_len // ps)
                n_pages = int(kv_pages) or batch_size * max_pages
                pool = PagePool(model, n_pages, ps)
            self.slots = SlotCache(model, batch_size, pool)
        else:
            self.slots = SlotCache(model, batch_size)
        # this engine's scheduler lock: ``step``, ``drain``, ``reset``
        # and ``extract_session`` (called from another thread) hold it,
        # so a freeze lands between two dispatches
        self._dispatch_lock = threading.RLock()
        # the page-pool leaves in wire order (the codec's receiving side)
        self._pool_keys = pool_leaf_keys(self.slots.cache) \
            if self.paged else []
        # the graph kinds of this server's calls (``counters()``):
        # unpaged keys never meet paged ones, and unpaged prefills are
        # eager calls of ``prefill_rows``
        self.graph_kinds = ("decode", "prefill", "verify",
                            "prefill_chunk") if self.paged else (
                                "chunk_rows", "verify_rows", "prefill_rows")
        self.pending: deque[Request] = deque()
        self._pending_lock = threading.Lock()
        self._live: list[_Live | None] = [None] * batch_size
        self._ids = itertools.count()
        self.steps = 0       # dispatch depth, summed (chunk k; verify
        #                      window + continuation)
        self.window_steps = 0  # the verify windows' share of ``steps``
        self.dispatches = 0  # decode rounds (chunks and verify rounds)
        self.prefills = 0    # prefill forwards, chunks included
        self.wasted_steps = 0  # per-slot positions decoded and dropped:
        #                        rejected drafts, and with in-dispatch
        #                        EOS off, overshoot past a finish
        # chunks, prefills, verify rounds and prefill chunks replayed as
        # CUDA graphs on the card (unpaged: chunks and verify rounds)
        self.graphs = GraphCache(self.device) \
            if self.device.type == "cuda" else None
        self.speculate_k = max(0, int(speculate_k))
        self._spec_ema = np.ones(batch_size, np.float64)
        self.spec_rounds = 0    # verify rounds run
        self.spec_drafted = 0   # draft tokens sent through verify
        self.spec_accepted = 0  # draft tokens accepted
        self.prefix = PrefixStore(int(prefix_cache_mb * (1 << 20)),
                                  self.slots.pool) \
            if prefix_cache_mb > 0 else None
        self._row_nbytes = 0 if self.paged else row_nbytes(self.slots.cache)
        self.prefix_donate = prefix_donate
        self.prefix_lookups = 0
        self.prefix_hits = 0
        self.prefix_hit_tokens = 0
        self.prefill_tokens_saved = 0
        # the smallest useful entry: one page (unpaged: one row) + its
        # [1, V] fp32 logits
        entry_nbytes = (self.slots.pool.page_nbytes if self.paged
                        else self._row_nbytes) + 4 * cfg.vocab_size
        if self.prefix is not None \
                and entry_nbytes > self.prefix.budget_bytes:
            # a store that cannot hold one entry would refuse every
            # insert: turn it off loudly
            log.warning(
                "prefix cache disabled: one cached entry needs %.1f MB, "
                "budget is %.1f MB (raise --prefix-cache-mb)",
                entry_nbytes / (1 << 20), prefix_cache_mb)
            self.prefix = None
        # chunked prefill: the budget quantized DOWN to the bucket grid
        # (min_bucket * 2^k), so every intermediate chunk is one full
        # bucket with no padding; 0 = off
        chunk = max(0, int(prefill_chunk_tokens))
        if chunk:
            b = min_bucket
            while b * 2 <= chunk:
                b *= 2
            chunk = min(b, cfg.max_seq_len)
        self.prefill_chunk = chunk
        self._prefilling: dict[int, _PrefillState] = {}
        self.prefill_chunk_dispatches = 0  # chunk dispatches run
        self.prefill_chunked = 0           # requests that took > 1 chunk
        self.handoffs_out = 0  # prefill_only requests handed off
        self.handoffs_in = 0   # handoff admissions (decode side)
        # live session migration
        self.migrations_out = 0      # sessions frozen and extracted here
        self.migrations_in = 0       # sessions adopted and resumed here
        self.migrations_local = 0    # as zero-copy owner swaps
        self.migrations_remote = 0   # as gathered content
        self.migrate_pages_moved = 0  # pages whose CONTENT moved
        self.migrate_bytes_avoided = 0  # bytes owner swaps did not move
        #                                 (migration and shared-pool
        #                                 handoff aliasing)
        self.migrate_freeze_resume_ms = 0.0  # summed freeze->resume ms
        self.migrate_bytes_wire = 0  # page bytes that crossed the wire
        #                              INTO this engine
        self.migrate_delta_in = 0    # adoptions whose prefix came from
        #                              this engine's own store pages
        # prefix entries pinned between a delta doc's submit-time check
        # and its admission (an eviction between the two would free the
        # pages the adopt aliases), by request id
        self._migrate_pins: dict = {}
        # the host-RAM page tier under the prefix store: evicted entries
        # spill to the host and page back in on a later hit
        self.host_tier = None
        if kv_host_mb > 0:
            if not self.paged or self.prefix is None:
                raise ValueError(
                    "kv_host_mb needs the paged KV cache and a prefix "
                    "store (prefix_cache_mb > 0): the tier holds "
                    "evicted prefix-store pages")
            self.host_tier = HostPageTier(int(kv_host_mb * (1 << 20)))
            self.prefix.on_evict = self._spill_entry
        # the dispatch timeline and the goodput ledger's roofline
        self.timeline = DispatchTimeline() if timeline else None
        self._first = False  # the last dispatch ran a key's first call
        self._t0 = time.monotonic()
        self.hbm_gbps = float(hbm_gbps) if hbm_gbps > 0 \
            else detect_hbm_gbps()
        self.peak_flops = detect_peak_flops()
        self.cost = None
        if self.timeline is not None:
            kv_tok = (self.slots.pool.page_nbytes / self.slots.pool.page_size
                      if self.paged
                      else row_nbytes(self.slots.cache) / cfg.max_seq_len)
            self.cost = CostModel(
                param_bytes=sum(p.numel() * p.element_size()
                                for p in model.parameters()),
                param_count=sum(p.numel() for p in model.parameters()),
                kv_token_bytes=kv_tok, n_heads=cfg.n_heads,
                head_dim=cfg.head_dim, vocab_size=cfg.vocab_size,
                hbm_gbps=self.hbm_gbps, peak_flops=self.peak_flops)
        self._hold = DEVICE.shared if self.graphs is not None \
            else contextlib.nullcontext

    # ------------------------------------------------------------ intake

    def submit(self, request: Request):
        """Enqueue a request; returns its id. Rejects prompts the cache
        cannot hold, clamps max_new_tokens to the remaining capacity,
        raises ``PoolExhausted`` for a request no pool state could
        admit (paged) and ``QueueFull`` past ``max_pending``."""
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
        if request.prefill_only and request.handoff is not None:
            raise ValueError("prefill_only and handoff are the two "
                             "HALVES of a disaggregated request — one "
                             "request cannot be both")
        if request.migrate is not None \
                and (request.prefill_only or request.handoff is not None):
            raise ValueError("a migrated session is already past "
                             "prefill — it cannot also be a "
                             "prefill_only/handoff half")
        if (request.prefill_only or request.handoff is not None
                or request.migrate is not None) and not self.paged:
            raise ValueError(
                "prefill/decode disaggregation needs the paged KV "
                "cache (the handoff unit is a page list)")
        if request.id is None:
            request.id = next(self._ids)
        if request.migrate is not None:
            # checked HERE, where a mismatch is one request's refusal
            # and not a failed admission inside step(); needs the id: a
            # delta doc's check pins a prefix entry under it
            self._check_migrate(request, p)
        if request.handoff is not None:
            if int(request.handoff["n_tokens"]) != len(p):
                raise ValueError(
                    f"handoff payload covers "
                    f"{request.handoff['n_tokens']} tokens, prompt "
                    f"has {len(p)}")
            self._check_handoff_geometry(request.handoff, len(p))
            if "page_ids" in request.handoff \
                    and request.handoff.get("pool") \
                    is not self.slots.pool:
                raise ValueError(
                    "an owner-swap handoff carries page ids in a "
                    "shared pool this engine does not hold — gather "
                    "it to wire form to cross pools")
        request.max_new_tokens = min(request.max_new_tokens,
                                     max_len - len(p))
        try:
            if self.paged:
                pool = self.slots.pool
                # a prefill_only request never decodes here: its worst
                # case is the prompt's pages
                life = len(p) if request.prefill_only \
                    else len(p) + request.max_new_tokens
                worst = -(-life // pool.page_size)
                if worst > pool.n_pages:
                    raise PoolExhausted(
                        f"request needs {worst} KV pages worst-case, "
                        f"the pool holds {pool.n_pages} (raise "
                        "--kv-pages or lower max_new_tokens)")
            with self._pending_lock:
                if len(self.pending) >= self.max_pending:
                    raise QueueFull(f"pending queue at "
                                    f"max_pending={self.max_pending}")
                self.pending.append(request)
        except BaseException:
            # a refusal after _check_migrate pinned a prefix entry must
            # not strand the pin
            self._release_migrate_pin(request.id)
            raise
        return request.id

    def _release_migrate_pin(self, rid) -> None:
        entry = self._migrate_pins.pop(rid, None)
        if entry is not None and self.prefix is not None:
            self.prefix.release(entry)

    @property
    def n_pending(self) -> int:
        return len(self.pending)

    @property
    def n_active(self) -> int:
        # parked mid-prefill slots count: they hold a request
        return self.slots.n_active + len(self._prefilling)

    @property
    def n_prefilling(self) -> int:
        return len(self._prefilling)

    @property
    def done(self) -> bool:
        return not self.pending and self.slots.n_active == 0 \
            and not self._prefilling

    def _free_slots(self) -> list[int]:
        """Slots admittable now: free, and not parked mid-prefill."""
        return [i for i in self.slots.free_slots()
                if i not in self._prefilling]

    def live_progress(self, since: dict | None = None) -> dict:
        """{request_id: tokens generated so far} for every in-flight
        request: the streaming hook. ``since`` (request_id -> count
        already seen) returns each request's TAIL past that count, so a
        long generation's repeated snapshots cost its new tokens only.
        Copies."""
        out = {}
        for live in self._live:
            if live is not None:
                start = since.get(live.request.id, 0) if since else 0
                out[live.request.id] = live.generated[start:]
        return out

    def prefix_match_len(self, tokens) -> int:
        """Longest prompt prefix this server could seed without prefill
        work, from the device store or the host tier: the gateway's
        prefix-affinity routing signal. No counter moves."""
        n = self.prefix.match_len(tokens) if self.prefix is not None \
            else 0
        if self.host_tier is not None:
            n = max(n, self.host_tier.match_len(tokens))
        return n

    def prefix_summary(self, max_items: int = 512) -> list:
        """``[[n_tokens, crc32], ...]``: what this server could seed
        (``PrefixStore.summary`` of the device store and the host tier,
        without repeats)."""
        out: list = []
        seen: set = set()
        for store in (self.prefix, self.host_tier):
            if store is None:
                continue
            for ln, crc in store.summary(max_items):
                if (ln, crc) not in seen:
                    seen.add((ln, crc))
                    out.append([ln, crc])
        return out[:max_items]

    # ----------------------------------------------------- observability

    def _record_dispatch(self, kind: str, t0: float, occ: int, bucket: int,
                         tokens: int, *, first: bool = False,
                         request_id=None, tags: dict | None = None,
                         work: int = 0, fed: int = 0, rejected: int = 0,
                         est: tuple = (0.0, 0.0)) -> None:
        """One timeline record from ``t0`` to now, with its position
        accounting (work/fed/rejected: the ledger's split of its
        duration), the cost model's bytes/FLOPs, and its HBM-BW% and MFU
        where the roofline is known."""
        dur_ms = (time.monotonic() - t0) * 1e3
        tags = tags or {}
        est_bytes, est_flops = est
        if est_bytes:
            bw, mfu = self.cost.utilization(est_bytes, est_flops, dur_ms)
            if bw is not None:
                tags["hbm_bw_pct"] = bw
            if mfu is not None:
                tags["mfu_pct"] = mfu
        self.timeline.record(DispatchRecord(
            kind, t0, dur_ms, occ, bucket, tokens, first,
            request_id=request_id, tags=tags, work=work, fed=fed,
            rejected=rejected, est_bytes=est_bytes, est_flops=est_flops))

    def _record_admit(self, kind: str, t0: float, occ: int, req: Request,
                      lb: int, off: int, cols: int, *, chunk: int = 0,
                      hit_tokens: int = 0) -> None:
        """The record of an admission (``prefill``, ``cow_admit`` or
        ``hit_admit``) or an intermediate ``prefill_chunk`` of ``lb``
        positions at offset ``off`` over ``cols`` page columns."""
        p = len(req.prompt)
        view = cols * self.slots.pool.page_size if cols else 0
        tags = {"prompt_len": p}
        if chunk:
            tags["chunk"] = chunk
        if hit_tokens:
            tags["prefix_hit_tokens"] = hit_tokens
        if off and kind != "cow_admit":
            tags["offset"] = int(off)
        if view:
            tags["view_tokens"] = view
        if kind == "prefill_chunk" and self.graphs is not None:
            # on the card an intermediate chunk's record closes when it
            # is enqueued (no host copy to wait for): priced against that
            # time its bytes would read as a rate the card cannot reach
            work, fed = lb, min(lb, p - off)
            est = (0.0, 0.0)
            tags["enqueued"] = True
        elif kind == "cow_admit":
            work = fed = 1
            est = self.cost.cow_admit()
        elif kind == "hit_admit":
            work = fed = 1
            est = self.cost.hit_admit(self._row_nbytes)
        else:
            work, fed = lb, min(lb, p - off)
            est = self.cost.prefill(lb, off, view)
        self._record_dispatch(
            kind, t0, occ, lb, 0 if kind == "prefill_chunk" else 1,
            first=self._first, request_id=req.id, tags=tags, work=work,
            fed=fed, est=est)

    def goodput(self) -> dict | None:
        """The goodput ledger (``obs.goodput.ledger``): this server's
        wall clock split into useful, first-call, padding, overshoot,
        rejected-draft and idle fractions that sum to at most 1, with
        each kind's HBM-BW% and MFU where the roofline is known. None
        with the timeline off."""
        if self.timeline is None:
            return None
        wall_ms = (time.monotonic() - self._t0) * 1e3
        return ledger(self.timeline.summary(), wall_ms,
                      hbm_gbps=self.hbm_gbps, peak_flops=self.peak_flops)

    # --------------------------------------------------------- scheduling

    def _admit_one(self, req: Request, finished: list) -> bool:
        """Admit ``req`` into a free slot (``_admit_paged`` or
        ``_admit_rows``); False = no pages now, stay pending."""
        if self.paged:
            return self._admit_paged(req, finished)
        return self._admit_rows(req, finished)

    def _admit_rows(self, req: Request, finished: list) -> bool:
        """The unpaged admission: the fault hook, prefix lookup, then an
        exact hit's row copy into the slot (the first token sampled from
        the stored logits), a partial hit's row copy seeding the slot
        before a prefill of the bucketed suffix at the usable offset, a
        full prefill, or, for a suffix longer than the prefill chunk,
        its first chunk with the slot parked. A request whose first
        token already ends it finishes here (its row written, the slot
        never armed)."""
        if self.fault_plan is not None:
            self.fault_plan.on_admit(req.id)
        s = self.slots
        t0, occ = time.monotonic(), s.n_active
        p = np.asarray(req.prompt, np.int64)
        max_len = self.model.cfg.max_seq_len
        slot = self._free_slots()[0]
        off, entry = 0, None
        if self.prefix is not None:
            self.prefix_lookups += 1
            off, entry = self.prefix.acquire(p)
        full_bucket = bucket_len(len(p), max_len, self.min_bucket)
        hit_tokens = saved = 0
        chunks = 1
        try:
            if entry is not None and off == len(p) \
                    and len(entry.tokens) == len(p) \
                    and entry.logits is not None:
                write_slot_row(s.cache, entry.row, slot)
                last = entry.logits
                hit_tokens, saved, chunks = len(p), full_bucket, 0
            else:
                if entry is not None:
                    # seed at most len(p) - 1 tokens, so >= 1 real token
                    # remains to prefill the first-continuation logits
                    off = _usable_prefix(min(off, len(p) - 1), len(p),
                                         max_len, self.min_bucket)
                    if off <= 0:
                        self.prefix.release(entry)
                        entry = None
                if entry is not None:
                    write_slot_row(s.cache, entry.row, slot)
                    hit_tokens = off
                    saved = full_bucket - bucket_len(
                        len(p) - off, max_len, self.min_bucket)
                if self.prefill_chunk and len(p) - off > self.prefill_chunk:
                    if hit_tokens:
                        self._count_hit(hit_tokens, saved)
                    st = _PrefillState(req, off, 0, hit_tokens, saved)
                    self._prefilling[slot] = st
                    self._prefill_chunk_rows(slot, st)
                    return True
                last = self._prefill_row(slot, p, off)
        finally:
            if entry is not None:
                self.prefix.release(entry)
        if hit_tokens:
            self._count_hit(hit_tokens, saved)
        self._arm(slot, req, last, hit_tokens, saved, chunks, finished)
        if self.timeline is not None:
            exact = chunks == 0
            self._first = False  # unpaged prefills run eagerly
            self._record_admit(
                "hit_admit" if exact else "prefill", t0, occ, req,
                0 if exact else bucket_len(len(p) - off, max_len,
                                           self.min_bucket),
                off, 0, hit_tokens=hit_tokens)
        return True

    def _prefill_row(self, slot: int, p: np.ndarray, off: int):
        """Prefill ``p[off:]`` (right-padded to its bucket) into the
        slot's row at positions from ``off``, and store the prompt's row
        and logits in the prefix store; returns the last position's
        logits [1, V]."""
        suffix = p[off:]
        lb = bucket_len(len(suffix), self.model.cfg.max_seq_len,
                        self.min_bucket)
        window = np.zeros(lb, np.int64)
        window[:len(suffix)] = suffix
        last = self._run_prefill_rows(slot, window, off, len(suffix) - 1)
        self.prefills += 1
        if self.prefix is not None:
            self.prefix.insert(p, read_slot_row(self.slots.cache, slot),
                               logits=last)
        return last

    def _run_prefill_rows(self, slot: int, window: np.ndarray, off: int,
                          last: int | None):
        """One unpaged prefill dispatch (``_prefill_rows``), eager and
        counted as a ``prefill_rows`` call on the card."""
        fn = functools.partial(_prefill_rows, self.model, self.slots.cache,
                               slot, self._tensor(window)[None], off, last)
        self._first = False
        if self.graphs is None:
            return fn()
        return self.graphs.eager("prefill_rows", fn)

    def _admit_paged(self, req: Request, finished: list) -> bool:
        """Admit ``req`` into a free slot: prefix lookup, worst-case page
        reservation (squeezing LRU store entries when tight; False =
        stay pending), the fault hook, page aliasing with a
        copy-on-write fork of a mid-page boundary, then the exact-hit
        first-token sample, a prefill of the bucketed suffix straight
        into the slot's pages, or, for a suffix longer than the prefill
        chunk, its first chunk with the slot parked. A request whose
        first token already ends it finishes here without arming the
        slot. A migrated session or a handoff takes its own admission; a
        ``prefill_only`` request reserves its prompt's pages only and
        leaves as a handoff (an exact hit without any prefill)."""
        if req.migrate is not None:
            return self._admit_migrate(req, finished)
        if req.handoff is not None:
            return self._admit_handoff(req, finished)
        s = self.slots
        pool = s.pool
        ps = pool.page_size
        t0, occ = time.monotonic(), s.n_active
        p = np.asarray(req.prompt, np.int64)
        max_len = self.model.cfg.max_seq_len
        slot = self._free_slots()[0]
        off, entry = 0, None
        if self.prefix is not None:
            self.prefix_lookups += 1
            off, entry = self.prefix.acquire(p)
            if self.host_tier is not None:
                # the host tier may hold a LONGER prefix: restore it
                # into the pool and the store, so the admission hits it
                off, entry = self._maybe_page_in(p, off, entry)
        full_bucket = bucket_len(len(p), max_len, self.min_bucket)
        exact = (entry is not None and off == len(p)
                 and len(entry.tokens) == len(p)
                 and entry.logits is not None)
        if exact and req.prefill_only:
            # the whole prompt is resident with its logits: no
            # reservation, no writes, no sampling; hand the pages off
            try:
                if self.fault_plan is not None:
                    self.fault_plan.on_admit(req.id)
                self._finish_handoff(req, entry.pages, len(p),
                                     entry.logits, finished,
                                     hit_tokens=len(p),
                                     saved=full_bucket, chunks=0)
            finally:
                self.prefix.release(entry)
            self._count_hit(len(p), full_bucket)
            return True
        if not exact and entry is not None:
            # partial hit: seed at most len(p) - 1 tokens so >= 1 real
            # token remains to prefill the first-continuation logits
            off = min(off, len(p) - 1)
            if off <= 0:
                self.prefix.release(entry)
                off, entry = 0, None
        seed = len(p) if exact else off
        # prefill_only reserves the prompt's pages only: the decode side
        # pays for the generation budget
        life = len(p) if req.prefill_only else len(p) + req.max_new_tokens
        worst = -(-life // ps)
        n_alias = -(-seed // ps)
        fork = 1 if seed % ps else 0
        need = worst - n_alias + fork
        if not self._reserve(need):
            if entry is not None:
                self.prefix.release(entry)
            if self.prefix is not None:
                self.prefix_lookups -= 1
            return False
        if self.fault_plan is not None:
            # after the capacity check (a requeued request must not burn
            # triggers on every retry), before the reservation is the
            # slot's: an injected failure hands it back itself
            try:
                self.fault_plan.on_admit(req.id)
            except BaseException:
                pool.cancel(need)
                if entry is not None:
                    self.prefix.release(entry)
                raise
        hit_tokens = saved = 0
        try:
            s.seed_pages(slot, entry.pages if entry is not None else [],
                         seed, need)
            if not exact and self.prefill_chunk \
                    and len(p) - off > self.prefill_chunk:
                # chunked admission: the first chunk now, the slot
                # parked; step() advances a chunk an iteration
                if entry is not None:
                    hit_tokens = off
                    saved = full_bucket - bucket_len(
                        len(p) - off, max_len, self.min_bucket)
                    self._count_hit(hit_tokens, saved)
                st = _PrefillState(req, off, 0, hit_tokens, saved)
                self._prefilling[slot] = st
                self._prefill_chunk_paged(slot, st)
                return True
            if exact:
                last = entry.logits
                hit_tokens, saved = len(p), full_bucket
            else:
                last = self._prefill_suffix(slot, p, off)
                if entry is not None:
                    hit_tokens = off
                    saved = full_bucket - bucket_len(
                        len(p) - off, max_len, self.min_bucket)
        finally:
            if entry is not None:
                self.prefix.release(entry)
        if hit_tokens:
            self._count_hit(hit_tokens, saved)
        self._arm(slot, req, last, hit_tokens, saved, 0 if exact else 1,
                  finished)
        if self.timeline is not None:
            if exact:
                self._first = False
                self._record_admit("cow_admit", t0, occ, req, 0, off, 0,
                                   hit_tokens=hit_tokens)
            else:
                self._record_admit(
                    "prefill", t0, occ, req,
                    bucket_len(len(p) - off, max_len, self.min_bucket),
                    off, min(_bucket_pow2(-(-len(p) // ps)), s.max_pages),
                    hit_tokens=hit_tokens)
        return True

    def _reserve(self, need: int) -> bool:
        """Reserve ``need`` pages, squeezing LRU prefix-store entries
        while the pool is short; False = not now (stay pending)."""
        pool = self.slots.pool
        granted = pool.reserve(need)
        while not granted and self.prefix is not None \
                and self.prefix.evict_one():
            granted = pool.reserve(need)
        return granted

    def _count_hit(self, hit_tokens: int, saved: int) -> None:
        self.prefix_hits += 1
        self.prefix_hit_tokens += hit_tokens
        self.prefill_tokens_saved += saved

    def _prefill_suffix(self, slot: int, p: np.ndarray, off: int):
        """Prefill ``p[off:]`` (right-padded to its bucket) into the
        slot's pages at positions from ``off``, and pin the prompt in
        the prefix store; returns the last position's logits [1, V]."""
        s = self.slots
        ps = s.pool.page_size
        suffix = p[off:]
        lb = bucket_len(len(suffix), self.model.cfg.max_seq_len,
                        self.min_bucket)
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
        last = self._dispatch("prefill", (lb, cols), flat, functools.partial(
            _prefill_last, self.model, s.cache, lb=lb, cols=cols)).clone()
        self.prefills += 1
        if self.prefix is not None:
            self.prefix.insert(p, pages=s.slot_pages(slot, len(p)),
                               logits=last)
        return last

    def _arm(self, slot: int, req: Request, last, hit_tokens: int,
             saved: int, chunks: int, finished: list) -> None:
        """Sample the first token from ``last`` [1, V] and arm the slot,
        or finish the request there when that token ends it; a
        ``prefill_only`` request leaves as a handoff of the slot's pages
        instead."""
        s = self.slots
        if req.prefill_only:
            n = len(req.prompt)
            self._finish_handoff(req, s.slot_pages(slot, n), n, last,
                                 finished, hit_tokens=hit_tokens,
                                 saved=saved, chunks=chunks)
            s.release_pages(slot)
            return
        tok, key = _sample_first(last, req.temperature, req.top_k, req.seed)
        if tok in self.eos_ids or req.max_new_tokens == 1:
            reason = "eos" if tok in self.eos_ids else "length"
            finished.append(Result(req.id, list(req.prompt), [tok], reason,
                                   hit_tokens, saved, prefill_chunks=chunks))
            if self.paged:
                s.release_pages(slot)
            return
        s.admit(slot, len(req.prompt), tok, req.temperature, req.top_k,
                key)
        self._spec_ema[slot] = 1.0  # a new tenant drafts again
        self._live[slot] = _Live(req, [tok], hit_tokens, saved,
                                 prefill_chunks=chunks)

    # ------------------------------------------------- chunked prefill

    def _advance_prefills(self, finished: list) -> None:
        """One chunk for each parked slot: between two chunks of a long
        prompt every live slot gets a decode round. The last chunk is
        the usual suffix prefill, which samples the first token."""
        for slot in sorted(self._prefilling):
            st = self._prefilling[slot]
            if len(st.request.prompt) - st.done > self.prefill_chunk:
                if self.paged:
                    self._prefill_chunk_paged(slot, st)
                else:
                    self._prefill_chunk_rows(slot, st)
                continue
            del self._prefilling[slot]
            self._finalize_prefill(slot, st, finished)

    def _prefill_chunk_paged(self, slot: int, st: _PrefillState) -> None:
        """One intermediate chunk: ``prefill_chunk`` prompt tokens at
        positions from ``st.done``, straight into the slot's pages."""
        s = self.slots
        ps = s.pool.page_size
        take = self.prefill_chunk
        t0, occ = time.monotonic(), s.n_active
        s.ensure_pages(slot, st.done + take)
        cols = min(_bucket_pow2(-(-(st.done + take) // ps)), s.max_pages)
        flat = np.concatenate([
            np.asarray(st.request.prompt[st.done:st.done + take], np.int64),
            st.done + np.arange(take, dtype=np.int64),
            s.page_table[slot, :cols].astype(np.int64)])
        self._dispatch("prefill_chunk", (take, cols), flat,
                       functools.partial(_paged_prefill_chunk, self.model,
                                         s.cache, lb=take, cols=cols))
        self.prefills += 1
        self.prefill_chunk_dispatches += 1
        st.done += take
        st.chunks += 1
        if self.timeline is not None:
            self._record_admit("prefill_chunk", t0, occ, st.request, take,
                               st.done - take, cols, chunk=st.chunks)

    def _prefill_chunk_rows(self, slot: int, st: _PrefillState) -> None:
        """The unpaged intermediate chunk: ``prefill_chunk`` prompt
        tokens at positions from ``st.done`` into the slot's row, with
        no LM head."""
        take = self.prefill_chunk
        t0, occ = time.monotonic(), self.slots.n_active
        window = np.asarray(st.request.prompt[st.done:st.done + take],
                            np.int64)
        self._run_prefill_rows(slot, window, st.done, None)
        self.prefills += 1
        self.prefill_chunk_dispatches += 1
        st.done += take
        st.chunks += 1
        if self.timeline is not None:
            self._record_admit("prefill_chunk", t0, occ, st.request, take,
                               st.done - take, 0, chunk=st.chunks)

    def _finalize_prefill(self, slot: int, st: _PrefillState,
                          finished: list) -> None:
        """The final chunk: the suffix prefill at offset ``st.done``,
        position-exact with the chunks before it, then the first-token
        sample. Unpaged, the offset first shrinks until the suffix's
        bucket fits the row (``_usable_prefix``): the re-prefilled
        tokens write the same values at the same positions."""
        s = self.slots
        t0, occ = time.monotonic(), s.n_active
        p = np.asarray(st.request.prompt, np.int64)
        max_len = self.model.cfg.max_seq_len
        off, cols = st.done, 0
        if self.paged:
            last = self._prefill_suffix(slot, p, off)
            cols = min(_bucket_pow2(-(-len(p) // s.pool.page_size)),
                       s.max_pages)
        else:
            off = _usable_prefix(off, len(p), max_len, self.min_bucket)
            last = self._prefill_row(slot, p, off)
        self.prefill_chunk_dispatches += 1
        st.chunks += 1
        self.prefill_chunked += 1
        self._arm(slot, st.request, last, st.hit_tokens, st.saved,
                  st.chunks, finished)
        if self.timeline is not None:
            self._record_admit(
                "prefill", t0, occ, st.request,
                bucket_len(len(p) - off, max_len, self.min_bucket), off,
                cols, chunk=st.chunks)

    # ------------------------------------------------ role-split handoff

    def _gather(self, pages: list) -> dict:
        """The content of ``pages`` (``gather_pages``), on the device:
        eager, so any page count goes as it is, with no bucket padding
        on the wire or in the tier."""
        idx = self._tensor(np.asarray(pages, np.int64))
        with self.slots.pool.lock:
            return gather_pages(self.slots.cache, idx)

    def _scatter(self, payload: dict, dst: list) -> None:
        """Write ``payload``'s pages onto the pool pages ``dst``
        (sentinels land on the junk page), in place."""
        idx = self._tensor(np.asarray(dst, np.int64))
        with self.slots.pool.lock:
            scatter_pages(self.slots.cache, payload, idx)

    def _finish_handoff(self, req: Request, pages: list, n_tok: int,
                        logits, finished: list, *, hit_tokens: int = 0,
                        saved: int = 0, chunks: int = 0) -> None:
        """The prefill side's exit: the prompt's page CONTENT (a padded
        gather, on the device) and the last-position logits, finished
        ``finish_reason="handoff"``. A decode engine in this process
        scatters it into its own pool (device to device); the agent wire
        encodes it (``serve.tier``). On a SHARED pool nothing is
        gathered: the payload is the page ids, pinned by one refcount
        that transfers to whoever consumes the doc (a co-located decode
        engine's owner-swap admission, or the remote stub's late
        gather)."""
        pool = self.slots.pool
        n = len(pages)
        t0, occ = time.monotonic(), self.slots.n_active
        res = Result(req.id, list(req.prompt), [], "handoff", hit_tokens,
                     saved, prefill_chunks=chunks)
        if pool.shared:
            pool.share(pages)  # the doc's own ref; its consumer unrefs
            res.handoff = {"n_tokens": int(n_tok),
                           "page_ids": [int(pg) for pg in pages],
                           "pool": pool, "logits": logits}
            finished.append(res)
            self.handoffs_out += 1
            if self.timeline is not None:
                self._record_dispatch(
                    "handoff_out", t0, occ, n, 0, request_id=req.id,
                    tags={"pages": n, "n_tokens": int(n_tok),
                          "owner_swap": True}, work=1, fed=1)
            return
        payload = self._gather(pages)
        res.handoff = {"n_tokens": int(n_tok), "pages": payload,
                       "logits": logits}
        finished.append(res)
        self.handoffs_out += 1
        if self.timeline is not None:
            self._record_dispatch(
                "handoff_out", t0, occ, payload_pages(payload), 0,
                request_id=req.id,
                tags={"pages": n, "n_tokens": int(n_tok)}, work=1, fed=1,
                est=self.cost.host_move(n * pool.page_nbytes))

    def _handoff_page_count(self, doc: dict) -> int:
        """Page-axis length of a handoff payload in any form: shared-pool
        page ids, wire (shapes carried by each leaf), or a payload of
        tensors; nothing is decoded."""
        if "page_ids" in doc:
            return len(doc["page_ids"])
        pages = doc["pages"]
        if isinstance(pages, dict) and "leaves" in pages:
            if len(pages["leaves"]) != len(self._pool_keys):
                raise ValueError(
                    f"handoff payload carries {len(pages['leaves'])} "
                    f"leaves, this engine's cache has "
                    f"{len(self._pool_keys)} — mismatched model configs "
                    "between the prefill and decode pools")
            leaf = pages["leaves"][0]
            return int(leaf["shape"][int(leaf.get("page_axis", 0))])
        return payload_pages(pages)

    def _check_handoff_geometry(self, doc: dict, n_tok: int) -> None:
        ps = self.slots.pool.page_size
        need = -(-n_tok // ps)
        have = self._handoff_page_count(doc)
        if have < need:
            raise ValueError(
                f"handoff payload holds {have} pages, the prompt "
                f"needs {need} at page_size {ps} — mismatched page "
                "geometry between the prefill and decode pools")

    def _decode_handoff(self, doc: dict) -> tuple:
        """A handoff payload's pages and logits, from either form: a
        payload of tensors (used as it is) or the agent wire form
        (rebuilt against THIS engine's cache leaves)."""
        pages, logits = doc["pages"], doc["logits"]
        if isinstance(pages, dict) and "leaves" in pages:
            pages = decode_payload(pages, self._pool_keys)
        if isinstance(logits, dict) and "b64" in logits:
            logits = decode_array(logits)
        return pages, torch.as_tensor(logits).to(self.device)

    def _admit_handoff(self, req: Request, finished: list) -> bool:
        """The decode side's entry: reserve the request's whole-life
        worst case, scatter the payload into fresh pages, sample the
        first token from the carried logits with THIS request's knobs
        and seed, arm the slot. Token-exact against one engine doing
        both: the pages arrive bit for bit and the first draw uses the
        key the prefill admission would have. The shared-pool form
        (``page_ids``) aliases the pages instead."""
        s = self.slots
        pool = s.pool
        ps = pool.page_size
        p = np.asarray(req.prompt, np.int64)
        n_tok = int(req.handoff["n_tokens"])
        worst = -(-(len(p) + req.max_new_tokens) // ps)
        if "page_ids" in req.handoff:
            return self._admit_handoff_shared(req, finished, p, n_tok,
                                              worst)
        if not self._reserve(worst):
            return False  # transient: stays pending until pages free
        if self.fault_plan is not None:
            try:
                self.fault_plan.on_admit(req.id)
            except BaseException:
                pool.cancel(worst)
                raise
        slot = self._free_slots()[0]
        t0, occ = time.monotonic(), s.n_active
        pages_tree, logits = self._decode_handoff(req.handoff)
        s.seed_pages(slot, [], 0, worst)
        s.ensure_pages(slot, n_tok)
        n = -(-n_tok // ps)
        n_ship = payload_pages(pages_tree)
        if n_ship < n:  # submit() checked it; a caller bug lands here
            s.release_pages(slot)
            raise ValueError(
                f"handoff payload holds {n_ship} pages, prompt needs "
                f"{n} at page_size {ps}")
        self._scatter(pages_tree, s.page_table[slot, :n].tolist()
                      + [pool.n_pages] * (n_ship - n))
        if self.prefix is not None:
            # the decode side learns the prompt too: the next sharer
            # routed here hits without another handoff
            self.prefix.insert(p, pages=s.slot_pages(slot, n_tok),
                               logits=logits)
        self.handoffs_in += 1
        if self.timeline is not None:
            self._record_dispatch(
                "handoff_admit", t0, occ, n_ship, 1, request_id=req.id,
                tags={"prompt_len": len(p), "pages": n}, work=1, fed=1,
                est=self.cost.host_move(n * pool.page_nbytes))
        self._arm_handed(slot, req, logits, finished)
        return True

    def _admit_handoff_shared(self, req: Request, finished: list,
                              p: np.ndarray, n_tok: int,
                              worst: int) -> bool:
        """Owner-swap admission: the handoff pages already live in THIS
        engine's pool, so the slot aliases them (``seed_pages``: full
        pages shared, a partial tail page forked, since several decode
        requests may adopt the same prompt) and the doc's transfer ref
        drops. KV bytes moved: one page when the prompt ends mid-page,
        else none."""
        s = self.slots
        pool = s.pool
        ps = pool.page_size
        page_ids = [int(pg) for pg in req.handoff["page_ids"]]
        n_alias = -(-n_tok // ps)
        fork = 1 if n_tok % ps else 0
        need = worst - n_alias + fork
        if not self._reserve(need):
            return False  # transient; the doc's ref keeps the pages
        if self.fault_plan is not None:
            try:
                self.fault_plan.on_admit(req.id)
            except BaseException:
                pool.cancel(need)
                raise
        slot = self._free_slots()[0]
        t0, occ = time.monotonic(), s.n_active
        s.seed_pages(slot, page_ids[:n_alias], n_tok, need)
        pool.unref(page_ids)  # the transfer ref moves to the slot
        logits = torch.as_tensor(req.handoff["logits"]).to(self.device)
        if self.prefix is not None:
            self.prefix.insert(p, pages=s.slot_pages(slot, n_tok),
                               logits=logits)
        self.handoffs_in += 1
        self.migrate_bytes_avoided += (n_alias - fork) * pool.page_nbytes
        if self.timeline is not None:
            self._record_dispatch(
                "handoff_admit", t0, occ, n_alias, 1, request_id=req.id,
                tags={"prompt_len": len(p), "pages": n_alias,
                      "owner_swap": True}, work=1, fed=1,
                est=self.cost.host_move(fork * pool.page_nbytes))
        self._arm_handed(slot, req, logits, finished)
        return True

    def _arm_handed(self, slot: int, req: Request, logits,
                    finished: list) -> None:
        """Sample a handed-off request's first token from the carried
        logits and arm its slot, or finish it there."""
        s = self.slots
        tok, key = _sample_first(logits, req.temperature, req.top_k,
                                 req.seed)
        if tok in self.eos_ids or req.max_new_tokens == 1:
            reason = "eos" if tok in self.eos_ids else "length"
            finished.append(Result(req.id, list(req.prompt), [tok],
                                   reason))
            s.release_pages(slot)
            return
        s.admit(slot, len(req.prompt), tok, req.temperature, req.top_k,
                key)
        self._spec_ema[slot] = 1.0
        self._live[slot] = _Live(req, [tok])

    # ------------------------------------------------- live migration

    def _check_migrate(self, req: Request, p: list) -> None:
        """Continuity and geometry of a migrate payload at submit time (a
        mismatch is one request's refusal, not a failed admission). Takes
        a ``SessionSnapshot`` (a local owner swap, or in-process remote)
        or the agent wire doc. A DELTA doc (suffix pages only and
        ``delta.prefix_tokens``) is also checked against this engine's
        own prefix store: the covering entry is acquired and PINNED in
        ``_migrate_pins`` until admission, so no eviction in between
        frees the pages the adoption aliases; a store that no longer
        covers the prefix raises ``StaleDelta``, and the sender re-ships
        the full payload. The probe is the device store's only (a host
        tier page-in is device work, and this runs on the caller's
        thread)."""
        snap = req.migrate
        delta = None
        if isinstance(snap, dict):
            gen = snap.get("generated") or []
            n_tok = int(snap.get("n_tokens", -1))
            prompt = [int(t) for t in snap.get("prompt", ())]
            pages = snap.get("pages")
            delta = snap.get("delta")
            if not (isinstance(pages, dict) and "leaves" in pages):
                raise ValueError(
                    "a wire migrate doc carries base64 leaf pages")
            have = self._handoff_page_count({"pages": pages})
        else:
            gen = list(snap.generated)
            n_tok = int(snap.n_tokens)
            prompt = [int(t) for t in snap.prompt]
            if snap.local:
                if snap.pool is not self.slots.pool:
                    raise ValueError(
                        "a local (owner-swap) snapshot holds page ids "
                        "in a pool this engine does not share — "
                        "extract with wire=True to cross pools")
                have = len(snap.pages)
            else:
                have = self._handoff_page_count({"pages": snap.pages})
        if not gen:
            raise ValueError(
                "a migrated session carries at least one generated "
                "token (pre-first-token sessions re-run as ordinary "
                "requests)")
        if prompt != [int(t) for t in p]:
            raise ValueError(
                "migrate snapshot prompt differs from the request "
                "prompt — the stream would not be continuous")
        if n_tok != len(p) + len(gen) - 1:
            raise ValueError(
                f"migrate snapshot holds {n_tok} KV positions, "
                f"prompt + generated - 1 is {len(p) + len(gen) - 1} "
                "— the final sampled token is never fed, so its K/V "
                "must not be present")
        ps = self.slots.pool.page_size
        need = -(-n_tok // ps)
        if delta is None:
            if have < need:
                raise ValueError(
                    f"migrate snapshot holds {have} pages, the "
                    f"session needs {need} at page_size {ps} — "
                    "mismatched page geometry between source and "
                    "target")
            return
        pt = int(delta.get("prefix_tokens", 0))
        if pt <= 0 or pt % ps:
            raise ValueError(
                f"delta prefix_tokens ({pt}) must be a positive "
                f"multiple of page_size {ps}")
        k = pt // ps
        if k > need - 1:
            raise ValueError(
                f"delta prefix covers {k} pages of a {need}-page "
                "session — at least one page always ships")
        if have < need - k:
            raise ValueError(
                f"delta payload holds {have} pages, the suffix needs "
                f"{need - k} at page_size {ps}")
        if self.prefix is None:
            raise StaleDelta(
                "delta migrate doc arrived but this engine runs no "
                "prefix store — nothing can cover the prefix")
        ctx = prompt + [int(t) for t in gen][:-1]
        match, entry = self.prefix.acquire(ctx)
        if entry is None or match < pt or entry.pages is None \
                or len(entry.pages) < k:
            if entry is not None:
                self.prefix.release(entry)
            raise StaleDelta(
                f"adopter covers {match} prefix tokens on-device, the "
                f"delta assumed {pt} — the sender's radix summary was "
                "stale; re-ship the full payload")
        # a re-sent submit (the agent's idempotency) must not leak the
        # first pin
        self._release_migrate_pin(req.id)
        self._migrate_pins[req.id] = entry

    def extract_session(self, request_id, *, wire: bool = False):
        """Freeze a live decode slot into a ``SessionSnapshot`` and evict
        it: the source half of a migration, safe from any thread (it
        holds the dispatch lock, so the freeze falls between two
        dispatches). None when ``request_id`` holds no live decode slot
        (pending or mid-prefill: the caller re-runs it as an ordinary
        request).

        ``wire=False`` (local owner swap, a shared pool): the snapshot
        holds page IDS pinned by one ref that transfers with it; no KV
        bytes move. ``wire=True``: it holds the gathered page CONTENT,
        copied to the host before the slot's pages are released and
        while no later dispatch can queue work ahead of the copies (the
        encode for the agent wire, ``snapshot_to_doc``, then waits on
        nothing the engine does meanwhile). The key is the
        slot's device key (two 32-bit words) for a sampled slot, and
        ``PRNGKey(seed)`` for a greedy one, which never draws."""
        with self._dispatch_lock, self._hold():
            s = self.slots
            pool = s.pool
            if not self.paged:
                raise ValueError("live migration needs the paged KV "
                                 "cache (a session moves as pages)")
            if wire is False and not pool.shared:
                raise ValueError(
                    "a local owner-swap snapshot needs a shared pool "
                    "— extract with wire=True")
            slot = next((i for i, live in enumerate(self._live)
                         if live is not None
                         and live.request.id == request_id), None)
            if slot is None:
                return None
            live = self._live[slot]
            req = live.request
            t0, occ = time.monotonic(), s.n_active
            n_tok = int(s.lengths[slot])
            n = -(-n_tok // pool.page_size)
            pages = [int(pg) for pg in s.page_table[slot, :n]]
            sampled = s.temperature[slot] > 0.0
            key = s.keys[slot] if sampled \
                else key_tensor(req.seed, "cpu")
            rng = key.cpu().numpy().astype(np.uint32)
            if wire:
                payload = pages_to_host(self._gather(pages), n)  # syncs
                self.migrations_remote += 1
                self.migrate_pages_moved += n
            else:
                pool.share(pages)  # the snapshot's transfer ref
                payload = pages
                self.migrations_local += 1
                self.migrate_bytes_avoided += n * pool.page_nbytes
            snap = SessionSnapshot(
                prompt=list(req.prompt),
                generated=list(live.generated),
                max_new_tokens=int(req.max_new_tokens),
                temperature=float(s.temperature[slot]),
                top_k=int(s.top_k[slot]),
                seed=int(req.seed),
                rng=rng,
                spec_ema=float(self._spec_ema[slot]),
                n_tokens=n_tok,
                pages=payload,
                local=not wire,
                t_freeze=time.time(),
                pool=pool if not wire else None,
                page_size=pool.page_size)
            self._live[slot] = None
            s.evict(slot)
            self.migrations_out += 1
            if self.timeline is not None:
                est = self.cost.host_move(n * pool.page_nbytes) \
                    if wire else (0.0, 0.0)
                self._record_dispatch(
                    "migrate_out", t0, occ, n, 0, request_id=req.id,
                    tags={"pages": n, "n_tokens": n_tok,
                          "local": not wire}, work=1, fed=1, est=est)
            return snap

    def _admit_migrate(self, req: Request, finished: list) -> bool:
        """Adopt a frozen session: restore its pages (owner swap, or a
        scatter of the shipped pages after the delta prefix shared from
        this engine's own store), then arm the slot straight from the
        snapshot, with no prefill and no first draw: the key resumes at
        its position in the chain, and the next decode round goes on as
        if the slot had lived here all along."""
        snap = req.migrate
        delta_pt = 0
        if isinstance(snap, dict):
            delta_pt = int((snap.get("delta") or {})
                           .get("prefix_tokens", 0))
            snap = snapshot_from_doc(snap)
        s = self.slots
        pool = s.pool
        ps = pool.page_size
        p = np.asarray(req.prompt, np.int64)
        n_tok = int(snap.n_tokens)
        n = -(-n_tok // ps)
        worst = -(-(len(p) + req.max_new_tokens) // ps)
        t0, occ = time.monotonic(), s.n_active
        if snap.local:
            # owner swap: the snapshot's ref moves to the slot by a
            # direct page-table install; no fork, a migration has one
            # writer
            if snap.pool is not pool:
                raise ValueError(
                    "local migrate snapshot is from a different pool")
            need = worst - n
            if not self._reserve(need):
                return False  # transient; the snapshot ref pins pages
            if self.fault_plan is not None:
                try:
                    self.fault_plan.on_admit(req.id)
                except BaseException:
                    pool.cancel(need)
                    raise
            slot = self._free_slots()[0]
            s.reserve_left[slot] = need
            s.n_slot_pages[slot] = n
            s.page_table[slot, :n] = np.asarray(snap.pages, np.int32)
            s.page_table[slot, n:] = pool.n_pages
            self.migrate_bytes_avoided += n * pool.page_nbytes
        else:
            # delta: pages [0, k) alias this engine's own store pages,
            # so the reservation shrinks by k
            k = delta_pt // ps
            need = worst - k
            if not self._reserve(need):
                return False  # transient; the pin keeps the prefix
            if self.fault_plan is not None:
                try:
                    self.fault_plan.on_admit(req.id)
                except BaseException:
                    pool.cancel(need)
                    raise
            slot = self._free_slots()[0]
            pages_tree = snap.pages
            if isinstance(pages_tree, dict) and "leaves" in pages_tree:
                pages_tree = decode_payload(pages_tree, self._pool_keys)
            if k:
                # the entry pinned at _check_migrate time; the seed is
                # page-aligned, so no fork
                entry = self._migrate_pins.pop(req.id)
                s.seed_pages(slot, [int(pg) for pg in entry.pages[:k]],
                             k * ps, need)
                self.prefix.release(entry)
            else:
                s.seed_pages(slot, [], 0, need)
            s.ensure_pages(slot, n_tok)
            n_ship = payload_pages(pages_tree)
            if n_ship < n - k:
                s.release_pages(slot)
                raise ValueError(
                    f"migrate payload holds {n_ship} pages, the "
                    f"session needs {n - k} at page_size {ps}")
            self._scatter(pages_tree, s.page_table[slot, k:n].tolist()
                          + [pool.n_pages] * (n_ship - (n - k)))
            self.migrate_pages_moved += n - k
            self.migrate_bytes_wire += (n - k) * pool.page_nbytes
            if k:
                self.migrate_bytes_avoided += k * pool.page_nbytes
                self.migrate_delta_in += 1
        gen = [int(t) for t in snap.generated]
        key = torch.as_tensor(np.asarray(snap.rng, np.int64),
                              device=self.device)
        s.admit(slot, n_tok, gen[-1], snap.temperature, snap.top_k, key)
        self._spec_ema[slot] = float(snap.spec_ema)
        self._live[slot] = _Live(req, gen)
        self.migrations_in += 1
        if snap.local:
            self.migrations_local += 1
        else:
            self.migrations_remote += 1
        self.migrate_freeze_resume_ms += \
            max(0.0, (time.time() - snap.t_freeze) * 1e3)
        if self.timeline is not None:
            moved = 0 if snap.local else n - (delta_pt // ps)
            est = (0.0, 0.0) if snap.local \
                else self.cost.host_move(moved * pool.page_nbytes)
            self._record_dispatch(
                "migrate_in", t0, occ, n, 0, request_id=req.id,
                tags={"pages": n, "n_tokens": n_tok,
                      "generated": len(gen), "local": snap.local,
                      "delta_prefix_pages": delta_pt // ps},
                work=1, fed=1, est=est)
        return True

    # --------------------------------------------------- host page tier

    def _spill_entry(self, entry) -> None:
        """``PrefixStore.on_evict``: before a dying entry's pages are
        unpinned, gather their content (on the device) and queue its
        copy to the host tier; an entry already in the tier only
        refreshes its LRU position."""
        tier = self.host_tier
        tokens = entry.tokens
        if tier.has(tokens):
            tier.touch(tokens)
            return
        pool = self.slots.pool
        n = -(-int(tokens.size) // pool.page_size)
        t0 = time.monotonic()
        payload = self._gather(list(entry.pages[:n]))
        tier.spill_async(tokens, payload, n, entry.logits)
        if self.timeline is not None:
            self._record_dispatch(
                "host_spill", t0, self.slots.n_active,
                payload_pages(payload), 0,
                tags={"pages": n, "tokens": int(tokens.size),
                      "async": True}, work=1, fed=1,
                est=self.cost.host_move(n * pool.page_nbytes))

    def _maybe_page_in(self, p: np.ndarray, off: int, entry):
        """When the host tier holds a strictly longer prefix of ``p``
        than the device store matched, restore that entry into the pool
        and the device store (a host-to-device scatter) and look ``p``
        up again, so the admission that follows hits it. Nothing happens
        when the pool cannot afford the pages after squeezing the device
        store."""
        tier = self.host_tier
        t_off, t_entry = tier.acquire(p)
        if t_entry is None or t_off <= off:
            if t_entry is not None:
                tier.release(t_entry)
            return off, entry
        pool = self.slots.pool
        n = -(-int(t_entry.tokens.size) // pool.page_size)
        try:
            while pool.available() < n and self.prefix.evict_one():
                pass
            if pool.available() < n:
                return off, entry
            t0 = time.monotonic()
            pages = pool.alloc(n)
            self._scatter(t_entry.row, pages)
            logits = t_entry.logits.to(self.device) \
                if t_entry.logits is not None else None
            ok = self.prefix.insert(t_entry.tokens, pages=pages,
                                    logits=logits)
            # the store holds its own pins now (or, refused, nobody
            # does and the pages go back to the free list)
            pool.unref(pages)
            tier.note_page_in(n * pool.page_nbytes)
            if self.timeline is not None:
                self._record_dispatch(
                    "host_page_in", t0, self.slots.n_active, n, 0,
                    tags={"pages": n,
                          "tokens": int(t_entry.tokens.size)},
                    work=1, fed=1,
                    est=self.cost.host_move(n * pool.page_nbytes))
            if not ok:
                return off, entry
        finally:
            tier.release(t_entry)
        if entry is not None:
            self.prefix.release(entry)
        return self.prefix.acquire(p)

    # ------------------------------------------------------- dispatches

    def _tensor(self, x: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.int64, device=self.device)

    def _dispatch(self, kind: str, shape: tuple, flat: np.ndarray, fn,
                  rows: tuple = ()):
        """``fn`` on the packed int64 inputs ``flat``, copied to the
        device in one transfer, and on ``rows`` (device tensors the
        call reads and writes in place): replayed at the key ``(kind,
        *shape)`` (its first call eager, then captured), or eager on the
        CPU."""
        if self.graphs is None:
            self._first = False
            return fn(self._tensor(flat), *rows)
        e = self.graphs.entry((kind, *shape), lambda: (torch.empty(
            flat.size, dtype=torch.int64, device=self.device), *rows))
        e.statics[0].copy_(torch.from_numpy(flat))
        self._first = e.graph is None
        return self.graphs.run(e, fn)

    def _variant(self) -> tuple[tuple, tuple]:
        """A decode round's variant, picked from the host's temperatures:
        greedy (no suffix, no state) while no live slot samples, else
        sampled (key suffix ``"sampled"``, the slots' device sampling
        state as the call's ``rows``). One capture a key serves every
        mix of its variant."""
        s = self.slots
        if (s.temperature > 0.0).any():
            return ("sampled",), (s.temps, s.top_ks, s.keys)
        return (), ()

    def _run_chunk(self, flat: np.ndarray, k: int, cols: int) -> np.ndarray:
        """One decode chunk of ``k`` micro-steps over the first ``cols``
        page columns (0: the resident rows), on packed inputs
        (``_decode_chunk``); returns the tokens [b, k] on the host."""
        s = self.slots
        fn = functools.partial(
            _decode_chunk, self.model, s.cache, b=s.batch_size, cols=cols,
            n_steps=k, eos_ids=self.eos_ids, freeze=self.in_dispatch_eos)
        kind, shape = ("decode", (k, cols)) if self.paged \
            else ("chunk_rows", (k,))
        tag, rows = self._variant()
        return self._dispatch(kind, shape + tag, flat, fn,
                              rows).cpu().numpy()

    def _run_verify(self, flat: np.ndarray, window: int, n_steps: int,
                    cols: int) -> np.ndarray:
        """One verify round (``_verify_chunk``); returns ``emit |
        accepted | cont`` [b, window + 1 + n_steps] on the host."""
        s = self.slots
        fn = functools.partial(
            _verify_chunk, self.model, s.cache, b=s.batch_size,
            window=window, cols=cols, n_steps=n_steps, eos_ids=self.eos_ids)
        kind, shape = ("verify", (window, n_steps, cols)) if self.paged \
            else ("verify_rows", (window, n_steps))
        tag, rows = self._variant()
        return self._dispatch(kind, shape + tag, flat, fn,
                              rows).cpu().numpy()

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
        """One scheduler iteration: the fault hook, admit, one chunk for
        each parked prefill, one decode round, evict; returns the
        requests that finished."""
        with self._dispatch_lock:
            if self.fault_plan is not None:
                self.fault_plan.on_dispatch()
            with self._hold():
                return self._step()

    def _step(self) -> list[Result]:
        finished: list[Result] = []
        while self._free_slots():
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
        self._advance_prefills(finished)
        if self.slots.n_active:
            finished.extend(self._decode_round())
        return finished

    def _remaining(self) -> np.ndarray:
        """Each live slot's remaining budget [b] (0 for the others)."""
        rem = np.zeros(self.slots.batch_size, np.int64)
        for slot, live in enumerate(self._live):
            if live is not None:
                rem[slot] = live.request.max_new_tokens \
                    - len(live.generated)
        return rem

    def _prepare_chunk(self) -> tuple[int, int, np.ndarray]:
        """The next chunk's micro-steps ``k``, page columns ``cols`` and
        packed inputs (``_decode_chunk``: the slots' last tokens,
        positions, remaining budgets and the table's first ``cols``
        columns). The page table is fixed across the chunk, so every
        live slot is first grown to cover the positions the chunk writes
        (capped at its budget), and the table is column-sliced to a
        power-of-two bucket of the live extent. Unpaged: ``cols`` = 0
        and no table."""
        s = self.slots
        k = self._chunk_size()
        if not self.paged:
            flat = np.concatenate([s.last_token, s.positions(),
                                   self._remaining()])
            return k, 0, flat.astype(np.int64)
        hi = 0
        for slot, live in enumerate(self._live):
            if live is not None:
                s.ensure_pages(slot, min(
                    int(s.lengths[slot]) + k,
                    len(live.request.prompt) + live.request.max_new_tokens))
                hi = max(hi, int(s.lengths[slot]) + k)
        cols = min(_bucket_pow2(-(-hi // s.pool.page_size)), s.max_pages)
        flat = np.concatenate([s.last_token, s.positions(),
                               self._remaining(),
                               s.page_table[:, :cols].ravel()])
        return k, cols, flat.astype(np.int64)

    def _decode_round(self) -> list[Result]:
        """One decode round over the live slots + EOS/evict: a verify
        round when speculation is on and a slot drafts, else a chunk."""
        if self.speculate_k > 0:
            drafts = self._collect_drafts()
            if drafts is not None:
                return self._verify_round(drafts)
        finished: list[Result] = []
        s = self.slots
        k, cols, flat = self._prepare_chunk()
        t0, occ = time.monotonic(), s.n_active
        riders = [lv.request.id for lv in self._live if lv is not None]
        toks = self._run_chunk(flat, k, cols)
        first = self._first
        self.steps += k
        self.dispatches += 1
        landed = 0
        for slot in range(s.batch_size):
            live = self._live[slot]
            if live is None:
                continue
            reason, j = self._append(live, toks[slot])
            landed += j
            if reason is None:
                s.lengths[slot] += k
                s.last_token[slot] = int(toks[slot, k - 1])
                continue
            if self.in_dispatch_eos:
                # the trailing positions were frozen re-emits: the trim
                # is a consistency check
                self.frozen_steps += k - j
                if j < k and not (toks[slot, j:] == toks[slot, j - 1]).all():
                    self.freeze_faults += 1
            else:
                # overshoot: decoded, paid for, never reported
                self.wasted_steps += k - j
            self._finish(slot, live, reason, finished)
        if self.timeline is not None:
            view = cols * s.pool.page_size if cols else 0
            tags = {"requests": riders}
            if view:
                tags["view_tokens"] = view
            # in-dispatch EOS: every fed position landed a kept token
            # and frozen tails are padding; off, the excess of k x occ
            # over landed is the overshoot
            fed = landed if self.in_dispatch_eos else k * occ
            if self.in_dispatch_eos:
                tags["frozen"] = k * occ - landed
            self._record_dispatch(
                "decode", t0, occ, k, landed, first=first, tags=tags,
                work=k * s.batch_size, fed=fed,
                est=self.cost.decode(k, s.batch_size,
                                     view or self.model.cfg.max_seq_len))
        return finished

    def _append(self, live: _Live, toks) -> tuple[str | None, int]:
        """Append ``toks`` to the request up to an eos id or its budget;
        returns ``(finish reason or None, tokens appended)``."""
        req = live.request
        n = 0
        for tok in toks:
            live.generated.append(int(tok))
            n += 1
            if int(tok) in self.eos_ids:
                return "eos", n
            if len(live.generated) >= req.max_new_tokens:
                return "length", n
        return None, n

    def _finish(self, slot: int, live: _Live, reason: str,
                finished: list) -> None:
        req = live.request
        finished.append(Result(req.id, list(req.prompt), live.generated,
                               reason, live.prefix_hit_tokens,
                               live.prefill_tokens_saved, live.drafted,
                               live.accepted, live.prefill_chunks))
        if self.prefix is not None and self.prefix_donate:
            self._donate(live, slot)
        self._live[slot] = None
        self.slots.evict(slot)

    # ------------------------------------------------- speculative decode

    def _collect_drafts(self) -> list | None:
        """Host-side prompt-lookup proposals, one per slot, or None when
        nobody drafts (the round is then a plain chunk). A slot drafts
        when greedy, its acceptance EMA is at or above the floor, and
        >= 2 budget tokens remain (a draft of d can land d + 1 tokens,
        so d is clamped to remaining - 1).

        With in-dispatch EOS off, a verify round advances a
        non-drafting slot one token where a chunk would advance it
        ``chunk_size``, so the batch-drag gate refuses the round when
        some live slot is not drafting and the round's expected yield
        (one a live slot + EMA-weighted drafts) is below the chunk's.
        It is checked first on an upper bound (full draft caps), so a
        round it would refuse skips the n-gram scans. The fused round
        (in-dispatch EOS on) continues every row a chunk's depth inside
        the same dispatch, so it needs no gate."""
        out: list = [None] * self.slots.batch_size
        n_live = 0
        all_eligible = True
        bound = 0.0
        eligible: list = []
        fused = self.in_dispatch_eos
        for slot, live in enumerate(self._live):
            if live is None:
                continue
            n_live += 1
            bound += 1.0
            req = live.request
            if req.temperature != 0.0 \
                    or self._spec_ema[slot] < self.SPEC_EMA_DISABLE:
                all_eligible = False
                continue
            d_cap = min(self.speculate_k,
                        req.max_new_tokens - len(live.generated) - 1)
            if d_cap <= 0:
                all_eligible = False
                continue
            eligible.append((slot, live, d_cap))
            bound += self._spec_ema[slot] * d_cap
        if not eligible:
            return None
        if not fused and not all_eligible \
                and bound < self._chunk_size() * n_live:
            return None  # gate precheck: refused before any lookup
        any_draft = False
        expected = float(n_live)
        for slot, live, d_cap in eligible:
            ctx = np.asarray(list(live.request.prompt) + live.generated,
                             np.int64)
            draft = _propose_draft(ctx, d_cap)
            if draft.size:
                out[slot] = draft
                any_draft = True
                expected += self._spec_ema[slot] * draft.size
        if not any_draft:
            return None
        drafting = sum(d is not None for d in out)
        if not fused and drafting < n_live and \
                expected < self._chunk_size() * n_live:
            return None  # batch-drag gate: the chunk yields more
        return out

    def _prepare_verify(self, drafts: list) -> tuple:
        """The verify round's window, continuation steps, page columns
        (0 unpaged), packed inputs (``_verify_chunk``) and draft lengths.
        Every live slot rides: drafting slots lay out ``[last_token,
        draft..]`` at their own positions, the others ``[last_token]``.
        Paged, each live slot is first grown to cover what the round
        writes: its window and, fused, the continuation (capped at its
        reservation)."""
        s = self.slots
        b = s.batch_size
        k_cont = self._chunk_size() if self.in_dispatch_eos else 0
        window = _bucket_pow2(max(d.size for d in drafts
                                  if d is not None)) + 1
        toks = np.zeros((b, window), np.int64)
        positions = np.full((b, window), -1, np.int64)
        draft_len = np.zeros(b, np.int64)
        hi = 0
        for slot, live in enumerate(self._live):
            if live is None:
                continue
            toks[slot, 0] = s.last_token[slot]
            positions[slot, 0] = s.lengths[slot]
            d = drafts[slot]
            if d is not None:
                toks[slot, 1:1 + d.size] = d
                positions[slot, 1:1 + d.size] = \
                    s.lengths[slot] + 1 + np.arange(d.size)
                draft_len[slot] = d.size
            if self.paged:
                upto = int(s.lengths[slot]) + int(draft_len[slot]) + 1 \
                    + k_cont
                s.ensure_pages(slot, upto)
                hi = max(hi, upto)
        parts = [toks.ravel(), positions.ravel(), draft_len,
                 self._remaining()]
        cols = 0
        if self.paged:
            cols = min(_bucket_pow2(-(-hi // s.pool.page_size)),
                       s.max_pages)
            parts.append(s.page_table[:, :cols].ravel())
        flat = np.concatenate(parts)
        return window, k_cont, cols, flat.astype(np.int64), draft_len

    def _verify_round(self, drafts: list) -> list[Result]:
        """One verify round + acceptance/evict. Each live slot appends
        its accepted drafts and the bonus verdict after them (and, fused,
        its continuation tokens) up to an eos id or its budget. The
        rewind for rejected drafts is pointer arithmetic only: their K/V
        stays past the slot's length, invisible to every later query
        and overwritten as the slot decodes on."""
        finished: list[Result] = []
        s = self.slots
        window, k_cont, cols, flat, draft_len = self._prepare_verify(drafts)
        t0, occ = time.monotonic(), s.n_active
        riders = [lv.request.id for lv in self._live if lv is not None]
        out = self._run_verify(flat, window, k_cont, cols)
        first = self._first
        landed = cont_fed = 0
        emit, accepted = out[:, :window], out[:, window]
        cont = out[:, window + 1:]
        self.steps += window + k_cont
        self.window_steps += window
        self.dispatches += 1
        self.spec_rounds += 1
        for slot in range(s.batch_size):
            live = self._live[slot]
            if live is None:
                continue
            d = int(draft_len[slot])
            a = int(accepted[slot])
            if d:
                live.drafted += d
                live.accepted += a
                self.spec_drafted += d
                self.spec_accepted += a
                # rejected drafts were scored and thrown away (fused, the
                # eos cap folds drafts past a stop token in here too)
                self.wasted_steps += d - a
                self._spec_ema[slot] = (
                    self.SPEC_EMA_DECAY * self._spec_ema[slot]
                    + (1.0 - self.SPEC_EMA_DECAY) * a / d)
            reason, consumed = self._append(live, emit[slot, :a + 1])
            landed += consumed
            cont_consumed = 0
            if k_cont:
                if reason is None:
                    reason, cont_consumed = self._append(live, cont[slot])
                    if reason is not None and cont_consumed < k_cont \
                            and not (cont[slot, cont_consumed:]
                                     == cont[slot, cont_consumed - 1]).all():
                        self.freeze_faults += 1
                # a row that finished in the window froze for the whole
                # continuation, one that finished in it for its tail
                self.frozen_steps += k_cont - cont_consumed
                landed += cont_consumed
                cont_fed += cont_consumed
            if reason is None:
                # fed last_token + a accepted drafts (+ the continuation)
                s.lengths[slot] += a + 1 + cont_consumed
                s.last_token[slot] = int(cont[slot, k_cont - 1]) \
                    if k_cont else int(emit[slot, a])
                continue
            self.wasted_steps += (a + 1) - consumed
            # the donated span [0, len) covers fed, accepted tokens only;
            # rejected drafts' K/V lies past it
            self._finish(slot, live, reason, finished)
        if self.timeline is not None:
            drafted_n = int(draft_len.sum())
            accepted_n = int(accepted.sum())
            view = cols * s.pool.page_size if cols else 0
            tags = {"requests": riders, "drafted": drafted_n,
                    "accepted": accepted_n}
            if view:
                tags["view_tokens"] = view
            if k_cont:
                tags["cont_steps"] = k_cont
            span = view or self.model.cfg.max_seq_len
            est = self.cost.verify(window, s.batch_size, span)
            if k_cont:
                dec = self.cost.decode(k_cont, s.batch_size, span)
                est = (est[0] + dec[0], est[1] + dec[1])
            # fed = a seed token a live slot + every draft + the live
            # continuation positions; fed - landed = the rejected drafts
            self._record_dispatch(
                "verify", t0, occ, window, landed, first=first, tags=tags,
                work=(window + k_cont) * s.batch_size,
                fed=occ + drafted_n + cont_fed,
                rejected=drafted_n - accepted_n, est=est)
        return finished

    def _donate(self, live: _Live, slot: int) -> None:
        """Give a finished slot's sequence back to the prefix store: its
        row or pages are position-exact over prompt + generated[:-1]
        (the final token was sampled but never fed). Paged, by
        REFERENCE (a refcount on the slot's pages); unpaged, a copy of
        the row, read only when ``wants()`` says the store takes it."""
        seq = np.asarray(list(live.request.prompt) + live.generated[:-1],
                         np.int64)
        if not seq.size:
            return
        if self.paged:
            self.prefix.insert(seq, pages=self.slots.slot_pages(
                slot, int(seq.size)))
        elif self.prefix.wants(seq, self._row_nbytes):
            self.prefix.insert(seq, read_slot_row(self.slots.cache, slot))

    def drain(self) -> list[Result]:
        """Finish every in-flight request, parked prefills included (no
        new admissions); pending requests stay queued."""
        finished: list[Result] = []
        while self.slots.n_active or self._prefilling:
            # the locks a round at a time: an extract from another
            # thread may land between two rounds
            with self._dispatch_lock, self._hold():
                self._advance_prefills(finished)
                if self.slots.n_active:
                    finished.extend(self._decode_round())
        return finished

    def counters(self) -> dict:
        """Engine counters: dispatch/step totals, waste and frozen-step
        accounting, speculation and chunked-prefill totals, prefix-store
        state, and the page pool's (paged) or the resident rows' bytes
        (unpaged: always ``batch x max_seq_len``); on the card also
        ``graph_{kind}_{captures|replays|eager}`` for each of
        ``graph_kinds`` (a capture is the first call at its key),
        ``graph_capture_s``, and the whole process's
        ``flash_decode_launches`` (replays included) and
        ``cuda_peak_bytes``. Handoff and migration counters,
        and with the host tier its ``kv_host_*`` block, as the JAX
        package keeps them. ``spec_window_steps`` is the verify
        windows' share of ``decode_steps``: the rest are single-token
        micro-steps, each one flash-decode launch a layer."""
        out = {
            "prefills": self.prefills,
            "decode_steps": self.steps,
            "dispatches": self.dispatches,
            "wasted_steps": self.wasted_steps,
            "frozen_steps": self.frozen_steps,
            "freeze_faults": self.freeze_faults,
            "spec_rounds": self.spec_rounds,
            "spec_drafted": self.spec_drafted,
            "spec_accepted": self.spec_accepted,
            "spec_window_steps": self.window_steps,
            "prefix_lookups": self.prefix_lookups,
            "prefix_hits": self.prefix_hits,
            "prefix_hit_tokens": self.prefix_hit_tokens,
            "prefill_tokens_saved": self.prefill_tokens_saved,
            "prefill_chunk_dispatches": self.prefill_chunk_dispatches,
            "prefill_chunked_requests": self.prefill_chunked,
            "handoffs_out": self.handoffs_out,
            "handoffs_in": self.handoffs_in,
            "migrations_out": self.migrations_out,
            "migrations_in": self.migrations_in,
            "migrations_local": self.migrations_local,
            "migrations_remote": self.migrations_remote,
            "migrate_pages_moved": self.migrate_pages_moved,
            "migrate_bytes_avoided": self.migrate_bytes_avoided,
            "migrate_bytes_wire": self.migrate_bytes_wire,
            "migrate_delta_in": self.migrate_delta_in,
            "migrate_freeze_resume_ms": round(
                self.migrate_freeze_resume_ms, 3),
        }
        if self.host_tier is not None:
            hs = self.host_tier.stats()
            out["kv_host_entries"] = hs["entries"]
            out["kv_host_bytes"] = hs["bytes"]
            out["kv_host_budget_bytes"] = hs["budget_bytes"]
            out["kv_host_tokens"] = hs["tokens"]
            out["kv_host_spills"] = hs["spills"]
            out["kv_host_page_ins"] = hs["page_ins"]
            out["kv_host_spill_bytes"] = hs["bytes_spilled"]
            out["kv_host_page_in_bytes"] = hs["bytes_paged_in"]
            out["kv_host_evictions"] = hs["evictions"]
        if self.prefix is not None:
            st = self.prefix.stats()
            out["prefix_entries"] = st["entries"]
            out["prefix_bytes"] = st["bytes"]
            out["prefix_budget_bytes"] = st["budget_bytes"]
            out["prefix_evictions"] = st["evictions"]
        if self.graphs is not None:
            for name, n in self.graphs.counters(self.graph_kinds).items():
                out["graph_" + name] = n
            # the process's flash-decode launches (replays included) and
            # its peak device memory: an agent reports its own over the
            # wire
            out["flash_decode_launches"] = flash_decode.launches
            out["cuda_peak_bytes"] = torch.cuda.max_memory_allocated(
                self.device)
        if not self.paged:
            out["kv_bytes_resident"] = sum(
                leaf.numel() * leaf.element_size()
                for key, layer in self.slots.cache.items()
                if is_layer_key(key) for leaf in layer.values()
                if isinstance(leaf, torch.Tensor))
            return out
        ps = self.slots.pool.stats()
        out["kv_pages_total"] = ps["total"]
        out["kv_pages_used"] = ps["used"]
        out["kv_pages_free"] = ps["free"]
        out["kv_pages_reserved"] = ps["reserved"]
        out["kv_cow_shared"] = ps["cow_shared"]
        out["kv_cow_forks"] = ps["forks"]
        out["kv_page_size"] = ps["page_size"]
        out["kv_bytes_resident"] = ps["bytes_resident"]
        # real tokens in the resident pages: live slots and the store's
        # entries (a page shared copy-on-write counts once a holder)
        s = self.slots
        tokens = int(s.lengths[s.active].sum())
        if self.prefix is not None:
            tokens += self.prefix.stats()["tokens"]
        out["kv_tokens_resident"] = tokens
        return out

    def reset(self) -> None:
        """Hard reset, the recovery after a failed ``step()``: drop
        pending, in-flight and mid-prefill requests (no Result for
        them) and free every slot (paged: its pages and reservation;
        unpaged: host state only, the next admit overwrites the row).
        The prefix store and the graphs stay."""
        with self._dispatch_lock, self._hold():
            with self._pending_lock:
                self.pending.clear()
            self._live = [None] * self.slots.batch_size
            self._prefilling.clear()
            # dropped migrate requests never reach admission: their
            # pinned prefix entries must not stay pinned
            for rid in list(self._migrate_pins):
                self._release_migrate_pin(rid)
            self.slots.reset()

    def run(self, requests: Iterable[Request] = ()) -> Iterator[Result]:
        """Submit ``requests`` and drive the loop until everything
        finishes."""
        for r in requests:
            self.submit(r)
        while not self.done:
            yield from self.step()
