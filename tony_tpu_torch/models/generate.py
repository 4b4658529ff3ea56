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
eager. The repetition penalty rides every step, replayed or eager: the
``seen`` mask [b, V] and the penalty are the step's own buffers, and a
penalty of 1.0 divides and multiplies by one, a no-op on the same
program. ``beam_search`` prefills once at batch b, widens the cache to
b x k rows and reorders them a step; its steps run eagerly (counted as
``beam`` eager calls on the card). The cache is a dict of tensors
(``init_cache``) written in place. Greedy decoding and beam search are
token-exact against the JAX package on the same weights; sampled
decoding draws from ``torch.Generator``s and matches it in distribution
only.
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


def _penalize_repeats(logits, seen, penalty):
    """CTRL-style repetition penalty: a token already in the sequence
    (``seen`` [b, V]) has its logit divided by ``penalty`` when
    positive, multiplied when negative; 1.0 leaves every logit as it
    is."""
    penalized = torch.where(logits > 0, logits / penalty, logits * penalty)
    return torch.where(seen, penalized, logits)


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
                 done, seen, penalty):
    """One greedy decode step on the step's own buffers, advanced in
    place (the scan carry): feed ``tok`` at ``pos``, penalize the
    tokens ``seen``, freeze the rows already ``done``; returns ``tok``,
    now the next token."""
    _, last = single_decode_step(model, cache, tok, positions=pos)
    nxt = torch.argmax(_penalize_repeats(last, seen, penalty), dim=-1)
    nxt = torch.where(done, torch.full_like(nxt, freeze), nxt)
    seen.scatter_(1, nxt[:, None], True)
    done.logical_or_(_is_eos(nxt, eos_ids))
    tok.copy_(nxt)
    pos.add_(1)
    return tok


@torch.no_grad()
def generate(model, prompt, *, max_new_tokens: int,
             temperature: float = 0.0, top_k: int = 0, top_p: float = 1.0,
             generator: torch.Generator | None = None,
             eos_id=-1, repetition_penalty: float = 1.0) -> torch.Tensor:
    """Generate ``max_new_tokens`` continuations of ``prompt`` [b, Lp]
    on the model's device; returns [b, max_new_tokens] int64. Rows that
    hit an eos id re-emit the first eos id after it (the JAX package's
    frozen-row contract). ``repetition_penalty`` > 1 discourages tokens
    already in the prompt or generated (``_penalize_repeats``). On the
    card a greedy call replays its decode step as a CUDA graph (the
    module docstring)."""
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
                                  eos_ids, repetition_penalty)
    pick = functools.partial(sample_logits, generator=generator,
                             temperature=temperature, top_k=top_k,
                             top_p=top_p)
    return _generate_eager(model, prompt, max_new_tokens, pick, eos_ids,
                           graphs, repetition_penalty)


def _seen_mask(prompt, vocab: int):
    """[b, V]: True at every token id of each row of ``prompt``."""
    seen = torch.zeros(prompt.shape[0], vocab, dtype=torch.bool,
                       device=prompt.device)
    return seen.scatter_(1, prompt, True)


def _generate_replayed(model, graphs: GraphCache, prompt,
                       max_new_tokens: int, eos_ids: tuple,
                       repetition_penalty: float = 1.0):
    """Greedy generation: an eager prefill into the step graph's own
    cache, then one replay a token."""
    b, prompt_len = prompt.shape
    dev = model.device
    vocab = model.cfg.vocab_size
    entry = graphs.entry(
        ("generate", b, model.cfg.max_seq_len, eos_ids),
        lambda: (init_cache(model, b),
                 torch.zeros(b, dtype=torch.long, device=dev),
                 torch.zeros(b, dtype=torch.long, device=dev),
                 torch.zeros(b, dtype=torch.bool, device=dev),
                 torch.zeros(b, vocab, dtype=torch.bool, device=dev),
                 torch.ones((), dtype=torch.float32, device=dev)))
    cache, tok, pos, done, seen, penalty = entry.statics
    for key, layer in cache.items():
        if key.startswith("block_"):
            layer["cache_index"] = 0
    if "pos_index" in cache:
        cache["pos_index"] = 0
    # positions past the prompt may hold an earlier call's K/V: the
    # visibility mask hides them, and a masked key adds exactly 0
    logits = model(prompt, decode=True, cache=cache)
    out = torch.empty(b, max_new_tokens, dtype=torch.long, device=dev)
    seen.copy_(_seen_mask(prompt, vocab))
    penalty.fill_(repetition_penalty)
    tok.copy_(torch.argmax(_penalize_repeats(logits[:, -1], seen, penalty),
                           dim=-1))
    seen.scatter_(1, tok[:, None], True)
    out[:, 0] = tok
    pos.fill_(prompt_len)
    done.copy_(_is_eos(tok, eos_ids))
    step = functools.partial(_greedy_step, model,
                             eos_ids[0] if eos_ids else -1, eos_ids)
    for t in range(1, max_new_tokens):
        out[:, t] = graphs.run(entry, step)
    return out


def _generate_eager(model, prompt, max_new_tokens: int, pick,
                    eos_ids: tuple, graphs: GraphCache | None = None,
                    repetition_penalty: float = 1.0):
    """Generation launching every step eagerly: a prefill, then one
    scalar-index forward a token; ``pick`` chooses each token from the
    penalized logits [b, V]; ``graphs``, when given, counts each step
    as an eager call."""
    freeze = eos_ids[0] if eos_ids else -1
    cache = init_cache(model, prompt.shape[0])
    logits = model(prompt, decode=True, cache=cache)
    seen = _seen_mask(prompt, model.cfg.vocab_size)
    nxt = pick(_penalize_repeats(logits[:, -1], seen, repetition_penalty))
    seen.scatter_(1, nxt[:, None], True)
    done = _is_eos(nxt, eos_ids)
    out = [nxt]
    for _ in range(max_new_tokens - 1):
        if graphs is not None:
            cache, last = graphs.eager("generate", single_decode_step,
                                       model, cache, nxt)
        else:
            cache, last = single_decode_step(model, cache, nxt)
        nxt = pick(_penalize_repeats(last, seen, repetition_penalty))
        nxt = torch.where(done, torch.full_like(nxt, freeze), nxt)
        seen.scatter_(1, nxt[:, None], True)
        done = done | _is_eos(nxt, eos_ids)
        out.append(nxt)
    return torch.stack(out, dim=1)


_KV_LEAVES = ("cached_key", "cached_value", "cached_key_scale",
              "cached_value_scale")


def _map_rows(cache: dict, fn) -> None:
    """Replace every K/V leaf (and int8 scale) of ``cache`` by ``fn`` of
    it, in the dict: the batch axis is 0 for all of them."""
    for key, layer in cache.items():
        if key.startswith("block_"):
            for name in _KV_LEAVES:
                if name in layer:
                    layer[name] = fn(layer[name])


@torch.no_grad()
def beam_search(model, prompt, *, max_new_tokens: int, num_beams: int = 4,
                eos_id=-1, length_penalty: float = 1.0) -> torch.Tensor:
    """Beam-search decode: the highest-scoring continuation [b,
    max_new_tokens] of ``prompt`` [b, Lp]. The prompt is prefilled once
    at batch b and the cache widened to b x k rows (beam-major within
    each prompt); each step scores every beam's next token, takes one
    top-k over the [b, k x V] joint candidates and reorders the cache
    rows by the winning parents (a batch-axis ``index_select`` of every
    K/V leaf). Beams finishing on any eos id freeze: they re-emit the
    first eos id at no added score. The winner of each row maximizes
    score / (generated length ** ``length_penalty``), HF-style."""
    eos_ids = normalize_eos_ids(eos_id)
    freeze = eos_ids[0] if eos_ids else 0
    prompt = torch.as_tensor(prompt, device=model.device).long()
    b, prompt_len = prompt.shape
    k = num_beams
    cfg = model.cfg
    if prompt_len + max_new_tokens > cfg.max_seq_len:
        raise ValueError(
            f"prompt ({prompt_len}) + max_new_tokens ({max_new_tokens}) "
            f"exceeds cfg.max_seq_len ({cfg.max_seq_len})")
    vocab = cfg.vocab_size
    dev = model.device
    graphs = model_graphs(model)
    cache = init_cache(model, b)
    logits = model(prompt, decode=True, cache=cache)
    _map_rows(cache, lambda x: x.repeat_interleave(k, dim=0))
    logp0 = torch.log_softmax(logits[:, -1].float(), dim=-1)
    scores, tok = torch.topk(logp0, k)  # [b, k]
    finished = _is_eos(tok, eos_ids)
    out = torch.full((b, k, max_new_tokens), freeze, dtype=torch.long,
                     device=dev)
    out[:, :, 0] = tok
    lengths = torch.ones(b, k, dtype=torch.long, device=dev)
    eos_only = torch.full((vocab,), -1e30, device=dev)
    eos_only[freeze] = 0.0
    base = torch.arange(b, device=dev)[:, None] * k

    def step(cache, tok):
        _, last = single_decode_step(model, cache, tok.reshape(b * k))
        return torch.log_softmax(last.float(), dim=-1).reshape(b, k, vocab)

    for t in range(1, max_new_tokens):
        logp = step(cache, tok) if graphs is None \
            else graphs.eager("beam", step, cache, tok)
        if eos_ids:
            logp = torch.where(finished[:, :, None], eos_only, logp)
        cand = scores[:, :, None] + logp
        scores, flat = torch.topk(cand.reshape(b, k * vocab), k)
        beam_idx = flat // vocab
        new_tok = flat % vocab
        rows = (base + beam_idx).reshape(-1)
        _map_rows(cache, lambda x: x.index_select(0, rows))
        out = torch.gather(out, 1, beam_idx[:, :, None].expand(
            b, k, max_new_tokens))
        lengths = torch.gather(lengths, 1, beam_idx)
        was_finished = torch.gather(finished, 1, beam_idx)
        out[:, :, t] = torch.where(was_finished,
                                   torch.full_like(new_tok, freeze), new_tok)
        lengths = torch.where(was_finished, lengths, lengths + 1)
        finished = was_finished | _is_eos(new_tok, eos_ids)
        tok = new_tok
    norm = scores / lengths.float() ** length_penalty
    best = torch.argmax(norm, dim=1)
    return out[torch.arange(b, device=dev), best]
