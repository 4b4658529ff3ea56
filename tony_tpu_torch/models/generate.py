"""Autoregressive generation over the explicit KV cache: the counterpart
of ``tony_tpu/models/generate.py``.

The JAX package runs prefill and a ``lax.scan`` of decode steps inside
one jitted program. Here the prefill is one eager forward, and on the
card a greedy ``generate`` replays its decode step as a CUDA graph
(``models.graphs``), one replay a token: the step carries the token,
the position and the frozen rows in its own buffers and reads its
position from the device (the per-slot mode, every row at one
position, bit-equal to the scalar-index step). The graph owns its KV
cache, one per batch size, cache length and eos ids, kept on the model
(``model.graphs``) so a later call at the same shape replays what an
earlier one captured. A sampled ``generate``, a sliding-window model
whose decode attention is not flash (the scalar step attends over a
slice there, so the per-slot step is not bit-equal to it) and any CPU
run launch every step eagerly; on the card those steps are counted as
eager. The cache is a dict of tensors
(``init_cache``) written in place. Greedy decoding is token-exact
against the JAX package on the same weights; sampled decoding draws
from ``torch.Generator``s and matches it in distribution only. Beam
search is ported in a later slice.
"""

from __future__ import annotations

import functools

import torch

from tony_tpu_torch.models.graphs import GraphCache


def init_cache(model, batch_size: int, length: int | None = None) -> dict:
    """The per-layer KV cache: ``{"block_i": {"cached_key",
    "cached_value", ["cached_key_scale", "cached_value_scale"],
    "cache_index"}, ["pos_index"]}`` with K/V buffers ``[batch_size,
    length, kv_heads, head_dim]`` (``length`` defaults to
    ``cfg.max_seq_len``; a page pool is the same dict with
    ``(n_pages, page_size)`` leading dims), zero-filled on the model's
    device. int8 caches (``kv_cache_quant``) add fp32 scales
    ``[batch_size, length, kv_heads]``. The counters are host ints: the
    scalar-index mode reads and advances them, per-slot modes ignore
    them."""
    cfg = model.cfg
    dev = model.device
    length = cfg.max_seq_len if length is None else int(length)
    quant = cfg.kv_cache_quant
    dt = torch.int8 if quant else cfg.dtype
    shape = (batch_size, length, cfg.kv_heads, cfg.head_dim)
    cache: dict = {}
    for i in range(cfg.n_layers):
        layer = {"cached_key": torch.zeros(shape, dtype=dt, device=dev),
                 "cached_value": torch.zeros(shape, dtype=dt, device=dev),
                 "cache_index": 0}
        if quant:
            for name in ("cached_key_scale", "cached_value_scale"):
                layer[name] = torch.zeros(shape[:3], dtype=torch.float32,
                                          device=dev)
        cache[f"block_{i}"] = layer
    if cfg.positional == "learned":
        cache["pos_index"] = 0
    return cache


def sample_logits(logits, generator, temperature: float, top_k: int,
                  top_p: float = 1.0):
    """Greedy when ``temperature == 0``, else softmax sampling with
    optional top-k and top-p (nucleus) cuts, drawing from
    ``generator``."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    scaled = logits / max(float(temperature), 1e-6)
    neg = torch.full_like(scaled, -1e30)
    if top_k > 0:
        kth = torch.sort(scaled, dim=-1).values[..., -top_k][..., None]
        scaled = torch.where(scaled < kth, neg, scaled)
    if top_p < 1.0:
        # a token survives if the probability mass strictly before it
        # (in descending order) is < top_p; the top token always does
        order = torch.argsort(-scaled, dim=-1)
        sorted_probs = torch.softmax(
            torch.gather(scaled, -1, order).float(), dim=-1)
        mass_before = torch.cumsum(sorted_probs, dim=-1) - sorted_probs
        keep_sorted = mass_before < top_p
        keep_sorted[..., 0] = True
        keep = torch.gather(keep_sorted, -1, torch.argsort(order, dim=-1))
        scaled = torch.where(keep, scaled, neg)
    probs = torch.softmax(scaled.float(), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[..., 0]


def normalize_eos_ids(eos_id) -> tuple:
    """Normalize eos_id to a tuple of valid ids: int (-1/None = none) or
    a tuple/list of ids (HF configs ship lists); negatives are
    dropped."""
    if isinstance(eos_id, (list, tuple)):
        return tuple(int(e) for e in eos_id if int(e) >= 0)
    return (int(eos_id),) if eos_id is not None and int(eos_id) >= 0 else ()


def _is_eos(tok: torch.Tensor, eos_ids) -> torch.Tensor:
    """True where ``tok`` equals ANY of the eos ids."""
    hit = torch.zeros(tok.shape, dtype=torch.bool, device=tok.device)
    for e in eos_ids:
        hit = hit | (tok == e)
    return hit


@torch.no_grad()
def single_decode_step(model, cache: dict, tok, positions=None,
                       page_table=None):
    """ONE token step through the KV cache: feed ``tok`` [b] at the
    current position(s); returns ``(cache, last_logits [b, V])``. The
    scalar-index path (``positions=None``) and the per-slot path
    (``positions`` [b], negative = empty slot) differ only in position
    bookkeeping; ``page_table`` [b, cols] selects page pools."""
    logits = model(tok[:, None], decode=True, positions=positions,
                   page_table=page_table, cache=cache)
    return cache, logits[:, -1]


@torch.no_grad()
def multi_decode_step(model, cache: dict, toks, positions, page_table=None):
    """A ``k``-token per-slot window in one forward: ``toks`` [b, k] at
    ``positions`` [b, k] (negative = padding: no write, junk logits);
    returns ``(cache, logits [b, k, V])``, ``logits[:, j]`` scoring the
    token after ``toks[:, j]``. The paged engine's prefill is one such
    window writing straight into the slot's pages."""
    logits = model(toks, decode=True, positions=positions,
                   page_table=page_table, cache=cache)
    return cache, logits


def model_graphs(model) -> GraphCache | None:
    """The model's graph cache, made at first use on the card (None on
    the CPU, unless a caller set one)."""
    if model.graphs is None and model.device.type == "cuda":
        model.graphs = GraphCache(model.device)
    return model.graphs


def _replayable(cfg) -> bool:
    """Whether the per-slot step is bit-equal to the scalar-index one:
    everywhere but a windowed scalar step on the einsum path, which
    attends over a slice of the cache."""
    return not cfg.sliding_window or cfg.decode_attention == "flash"


def _greedy_step(model, freeze: int, eos_ids: tuple, cache, tok, pos,
                 done):
    """One greedy decode step on the step's own buffers, advanced in
    place (the scan carry): feed ``tok`` at ``pos``, freeze the rows
    already ``done``; returns ``tok``, now the next token."""
    _, last = single_decode_step(model, cache, tok, positions=pos)
    nxt = torch.argmax(last, dim=-1)
    nxt = torch.where(done, torch.full_like(nxt, freeze), nxt)
    done.logical_or_(_is_eos(nxt, eos_ids))
    tok.copy_(nxt)
    pos.add_(1)
    return tok


@torch.no_grad()
def generate(model, prompt, *, max_new_tokens: int,
             temperature: float = 0.0, top_k: int = 0, top_p: float = 1.0,
             generator: torch.Generator | None = None,
             eos_id=-1) -> torch.Tensor:
    """Generate ``max_new_tokens`` continuations of ``prompt`` [b, Lp]
    on the model's device; returns [b, max_new_tokens] int64. Rows that
    hit an eos id re-emit the first eos id after it (the JAX package's
    frozen-row contract). On the card a greedy call replays its decode
    step as a CUDA graph (the module docstring). The JAX
    ``repetition_penalty`` is not ported yet."""
    eos_ids = normalize_eos_ids(eos_id)
    prompt = torch.as_tensor(prompt, device=model.device).long()
    cfg = model.cfg
    if prompt.shape[1] + max_new_tokens > cfg.max_seq_len:
        raise ValueError(
            f"prompt ({prompt.shape[1]}) + max_new_tokens "
            f"({max_new_tokens}) exceeds cfg.max_seq_len "
            f"({cfg.max_seq_len}): the KV cache would overflow")
    graphs = model_graphs(model)
    if graphs is not None and temperature == 0.0 and _replayable(cfg):
        return _generate_replayed(model, graphs, prompt, max_new_tokens,
                                  eos_ids)
    pick = functools.partial(sample_logits, generator=generator,
                             temperature=temperature, top_k=top_k,
                             top_p=top_p)
    return _generate_eager(model, prompt, max_new_tokens, pick, eos_ids,
                           graphs)


def _generate_replayed(model, graphs: GraphCache, prompt,
                       max_new_tokens: int, eos_ids: tuple):
    """Greedy generation: an eager prefill into the step graph's own
    cache, then one replay a token."""
    b, prompt_len = prompt.shape
    dev = model.device
    entry = graphs.entry(
        ("generate", b, model.cfg.max_seq_len, eos_ids),
        lambda: (init_cache(model, b),
                 torch.zeros(b, dtype=torch.long, device=dev),
                 torch.zeros(b, dtype=torch.long, device=dev),
                 torch.zeros(b, dtype=torch.bool, device=dev)))
    cache, tok, pos, done = entry.statics
    for key, layer in cache.items():
        if key.startswith("block_"):
            layer["cache_index"] = 0
    if "pos_index" in cache:
        cache["pos_index"] = 0
    # positions past the prompt may hold an earlier call's K/V: the
    # visibility mask hides them, and a masked key adds exactly 0
    logits = model(prompt, decode=True, cache=cache)
    out = torch.empty(b, max_new_tokens, dtype=torch.long, device=dev)
    tok.copy_(torch.argmax(logits[:, -1], dim=-1))
    out[:, 0] = tok
    pos.fill_(prompt_len)
    done.copy_(_is_eos(tok, eos_ids))
    step = functools.partial(_greedy_step, model,
                             eos_ids[0] if eos_ids else -1, eos_ids)
    for t in range(1, max_new_tokens):
        out[:, t] = graphs.run(entry, step)
    return out


def _generate_eager(model, prompt, max_new_tokens: int, pick,
                    eos_ids: tuple, graphs: GraphCache | None = None):
    """Generation launching every step eagerly: a prefill, then one
    scalar-index forward a token; ``pick`` chooses each token from the
    logits [b, V]; ``graphs``, when given, counts each step as an eager
    call."""
    freeze = eos_ids[0] if eos_ids else -1
    cache = init_cache(model, prompt.shape[0])
    logits = model(prompt, decode=True, cache=cache)
    nxt = pick(logits[:, -1])
    done = _is_eos(nxt, eos_ids)
    out = [nxt]
    for _ in range(max_new_tokens - 1):
        if graphs is not None:
            cache, last = graphs.eager("generate", single_decode_step,
                                       model, cache, nxt)
        else:
            cache, last = single_decode_step(model, cache, nxt)
        nxt = pick(last)
        nxt = torch.where(done, torch.full_like(nxt, freeze), nxt)
        done = done | _is_eos(nxt, eos_ids)
        out.append(nxt)
    return torch.stack(out, dim=1)
