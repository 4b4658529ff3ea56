"""Live session migration: freeze an in-flight stream, resume it elsewhere
token-exact. The counterpart of ``tony_tpu/serve/migrate.py``.

At a dispatch boundary the source engine freezes a live decode slot into
a ``SessionSnapshot``: everything the decode loop's exactness invariant
says the slot is:

- ``n_tokens`` positions of KV (prompt + generated, less the last
  token), as shared-pool page ids (a local owner swap, no bytes moved)
  or gathered page content (remote, over the agent wire);
- the sampler state: the slot's key at its current position in the
  chain (advanced only by its own draws, so resuming from it continues
  the exact sequence a never-migrated slot would have drawn), its
  temperature and top-k, and the speculation acceptance EMA;
- the absolute emitted prefix (``generated``) and the ORIGINAL budget.

The target engine adopts the snapshot with no prefill and no first
draw: the slot is armed straight from it and the next decode round goes
on as if it had lived there all along.

Failure model: MOVE semantics with copy-then-delete on the remote path:
the source frees its half only after the target's adopt returns, so a
crash of either end leaves at most one live copy plus the gateway's
ticket, and the ordinary failover re-runs the request from the prompt.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from tony_tpu_torch.serve.prefix import summary_match_len
from tony_tpu_torch.serve.tier import (decode_array, encode_array,
                                       encode_payload, trim_payload)


class StaleDelta(ValueError):
    """A delta (suffix-only) snapshot arrived but the adopter no longer
    holds the prefix its trim assumed (the radix summary the sender
    diffed against was stale). Raised at SUBMIT time, before any slot or
    page is touched; the sender falls back to the full payload."""


@dataclass
class SessionSnapshot:
    """One frozen in-flight session, captured at a dispatch boundary.

    The decode invariant after any dispatch: ``n_tokens`` (the slot's
    length) is ``len(prompt) + len(generated) - 1``: the last sampled
    token was never fed back, so its K/V is not in the pages, and
    ``generated[-1]`` is the token the next step feeds."""

    prompt: list
    generated: list        # absolute emitted tokens, first to last
    max_new_tokens: int    # ORIGINAL budget; remaining is derived
    temperature: float
    top_k: int
    seed: int
    rng: Any               # np.uint32[2] key, current chain position
    spec_ema: float        # speculation acceptance EMA
    n_tokens: int          # KV positions held
    pages: Any             # local: [page_id] (shared, transferable);
    # remote: gathered page content (a device payload or wire dict)
    local: bool            # True = pages are ids in a shared pool
    t_freeze: float        # wall clock at freeze (freeze->resume ms)
    pool: Any = None       # the shared PagePool the ids live in (local)
    page_size: int = 0     # tokens a page at the SOURCE (wire only; 0 =
    # unknown, and delta trimming declines)

    @property
    def remaining(self) -> int:
        """Token budget left at resume time."""
        return max(0, int(self.max_new_tokens) - len(self.generated))


def gather_local(pool, pages) -> dict:
    """The CONTENT of shared-pool ``pages`` as a standalone payload, and
    the transfer ref they carried released: the bridge from an
    owner-swap payload (page ids) to a wire one, taken when routing
    sends the session to a REMOTE replica after all. The gather is
    complete (a stream synchronize) BEFORE the unref, so the pages
    cannot be reused and overwritten while they are read. The caller
    replaces the id payload with the returned one IN PLACE, so the ref
    is consumed exactly once."""
    from tony_tpu_torch.models.graphs import DEVICE
    from tony_tpu_torch.serve.slots import cache_device, gather_pages

    ids = [int(p) for p in pages]
    cache = pool.cache
    dev = cache_device(cache)
    # device work off an engine's step: never beside a graph capture
    hold = DEVICE.shared() if dev.type == "cuda" \
        else contextlib.nullcontext()
    with hold, pool.lock:
        idx = torch.as_tensor(ids, dtype=torch.int64,
                              device=dev)
        payload = gather_pages(cache, idx)
        if dev.type == "cuda":
            torch.cuda.current_stream(dev).synchronize()
        pool.unref(ids)
    return payload


def snapshot_to_doc(snap: SessionSnapshot) -> dict:
    """Wire form (JSON-safe) of a REMOTE snapshot: it rides the agent's
    ``POST /v1/migrate_in``, its pages through the same codec as
    ``/v1/handoff``."""
    if snap.local:
        raise ValueError(
            "a local (owner-swap) snapshot holds page ids, not page "
            "content — extract with wire pages to cross hosts")
    return {
        "prompt": [int(t) for t in snap.prompt],
        "generated": [int(t) for t in snap.generated],
        "max_new_tokens": int(snap.max_new_tokens),
        "temperature": float(snap.temperature),
        "top_k": int(snap.top_k),
        "seed": int(snap.seed),
        "rng": encode_array(np.asarray(snap.rng, np.uint32)),
        "spec_ema": float(snap.spec_ema),
        "n_tokens": int(snap.n_tokens),
        "pages": encode_payload(snap.pages),
        "t_freeze": float(snap.t_freeze),
        "page_size": int(snap.page_size),
    }


def snapshot_from_doc(doc: dict) -> SessionSnapshot:
    """Inverse of ``snapshot_to_doc``. ``pages`` stays in wire form: the
    adopting engine decodes it against its OWN cache's leaves."""
    return SessionSnapshot(
        prompt=[int(t) for t in doc["prompt"]],
        generated=[int(t) for t in doc["generated"]],
        max_new_tokens=int(doc["max_new_tokens"]),
        temperature=float(doc["temperature"]),
        top_k=int(doc["top_k"]),
        seed=int(doc["seed"]),
        rng=decode_array(doc["rng"]).numpy().astype(np.uint32).reshape(2),
        spec_ema=float(doc["spec_ema"]),
        n_tokens=int(doc["n_tokens"]),
        pages=doc["pages"],
        local=False,
        t_freeze=float(doc["t_freeze"]),
        page_size=int(doc.get("page_size", 0)),
    )


# ----------------------------------------------------- delta migration


def delta_trim_doc(doc: dict, summary) -> dict | None:
    """Prefix-delta trim of a wire snapshot doc against the TARGET's
    radix summary (the ``[[n_tokens, crc32], ...]`` pairs on its agent
    heartbeat): when the target already holds a prefix of this session's
    context, ship only the uncovered SUFFIX pages. The returned doc
    carries ``delta.prefix_tokens`` (a page multiple) and the pages
    ``[k, n)``; the adopter rebuilds ``[0, k)`` by sharing its own store
    pages.

    None when trimming buys nothing (no overlap, unknown page size, one
    page). Advisory: a stale summary makes the ADOPTER raise
    ``StaleDelta`` and the sender re-ships the full doc. At least one
    page always ships (``k <= n - 1``)."""
    ps = int(doc.get("page_size", 0))
    if ps <= 0 or not summary:
        return None
    n_tok = int(doc["n_tokens"])
    n = -(-n_tok // ps)
    # the context whose KV the pages hold: prompt + generated minus the
    # never-fed final token (the snapshot invariant)
    ctx = [int(t) for t in doc["prompt"]]
    ctx += [int(t) for t in doc["generated"]][:-1]
    covered = summary_match_len(summary, ctx)
    k = min(covered // ps, n - 1)
    if k <= 0:
        return None
    out = dict(doc)
    out["pages"] = trim_payload(doc["pages"], k, n)
    out["delta"] = {"prefix_tokens": k * ps}
    return out
