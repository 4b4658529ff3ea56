"""Counter-based sampling on the device: the Threefry-2x32 generator of
``jax.random`` in plain tensor operations, and the two samplers built on
it, per-row (the serving engine's) and per-batch (``generate``'s).

The JAX package draws with ``jax.random`` under
``jax_threefry_partitionable``: a key is two 32-bit words; ``split(key,
n)[i]`` is ``threefry2x32(key, (0, i))``; ``random_bits(key, shape)``
XORs the two words of ``threefry2x32(key, (hi, lo))`` over the 64-bit
row-major index of each element; ``uniform`` puts 23 of those bits
under a 1.0 exponent; ``gumbel`` is ``-log(-log(u))``; and
``categorical(key, logits)`` is ``argmax(logits + gumbel(key))``. The
same here, with each 32-bit word held in an int64 tensor and every
operation masked to 32 bits, so the integers are exact on the CPU and
on the card and a key gives the same draw eagerly and replayed in a
CUDA graph. The floats part from XLA's only where ``torch.log`` and
XLA's ``log`` round differently (the last ulp), which moves a draw
only at a near tie.

Nothing here reads a tensor on the host: every function is fit for a
CUDA-graph capture. A key tensor has a last axis of 2 (int64 words).
"""

from __future__ import annotations

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
# np.finfo(np.float32).tiny: uniform's lower end for the gumbel draw
_TINY = 1.1754943508222875e-38
# the top-k cut's masked value and the scale's floor (the JAX engine's)
_NEG = -1e30
_TEMP_FLOOR = 1e-6


def key_tensor(seed: int, device) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``'s two words as a [2] int64 tensor on
    ``device``. A seed in int32 range is a 32-bit seed there (high word
    0, the low word its two's complement); a wider one splits into its
    two halves."""
    seed = int(seed)
    hi = 0 if -2 ** 31 <= seed < 2 ** 31 else (seed >> 32) & _MASK
    return torch.tensor([hi, seed & _MASK], dtype=torch.int64, device=device)


def _rotl(v: torch.Tensor, r: int) -> torch.Tensor:
    return ((v << r) & _MASK) | (v >> (32 - r))


def threefry2x32(k0, k1, x0, x1) -> tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 (20 rounds) of the counter words ``(x0, x1)`` under
    the key words ``(k0, k1)``, all int64 tensors holding 32-bit values
    (broadcast together)."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def split(keys: torch.Tensor, n: int = 2) -> torch.Tensor:
    """``jax.random.split`` of each key of ``keys`` [..., 2]: [..., n, 2]."""
    i = torch.arange(n, dtype=torch.int64, device=keys.device)
    b0, b1 = threefry2x32(keys[..., 0:1], keys[..., 1:2],
                          torch.zeros_like(i), i)
    return torch.stack([b0, b1], dim=-1)


def random_bits(keys: torch.Tensor, shape: tuple) -> torch.Tensor:
    """``jax.random.bits`` (32-bit) of each key of ``keys`` [..., 2] over
    ``shape``: [..., *shape] int64 in [0, 2^32)."""
    n = 1
    for s in shape:
        n *= int(s)
    idx = torch.arange(n, dtype=torch.int64, device=keys.device)
    lead = keys.shape[:-1]
    k0 = keys[..., 0].reshape(*lead, 1)
    k1 = keys[..., 1].reshape(*lead, 1)
    b0, b1 = threefry2x32(k0, k1, idx >> 32, idx & _MASK)
    return (b0 ^ b1).reshape(*lead, *shape)


def uniform(keys: torch.Tensor, shape: tuple, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in float32: the top 23 bits under a 1.0
    exponent, less 1, scaled to ``[minval, maxval)`` and held at or above
    ``minval``."""
    bits = (random_bits(keys, shape) >> 9) | 0x3F800000
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    lo = np.float32(minval)
    span = float(np.float32(maxval) - lo)
    return torch.clamp_min(floats * span + float(lo), float(lo))


def gumbel(keys: torch.Tensor, shape: tuple) -> torch.Tensor:
    """``jax.random.gumbel`` in float32 (its default, low mode)."""
    return -torch.log(-torch.log(uniform(keys, shape, _TINY, 1.0)))


def _rank_cut(scaled: torch.Tensor, top_ks: torch.Tensor) -> torch.Tensor:
    """Keep each row's ``top_ks`` largest entries by rank (a stable
    descending order: of equal values the lower index ranks first, so
    ties past rank k are dropped); a top-k of 0 or less keeps the row."""
    order = torch.sort(scaled, dim=-1, descending=True, stable=True).indices
    pos = torch.arange(scaled.shape[-1], device=scaled.device)
    ranks = torch.empty_like(order).scatter_(
        -1, order, pos.expand_as(order).contiguous())
    k = top_ks[:, None]
    keep = (k <= 0) | (ranks < k)
    return torch.where(keep, scaled, torch.full_like(scaled, _NEG))


def sample_rows(logits: torch.Tensor, keys: torch.Tensor,
                temps: torch.Tensor, top_ks: torch.Tensor,
                done: torch.Tensor | None = None):
    """The serving engine's per-row draw (``tony_tpu/serve/engine.py``
    ``_sample_rows``): greedy rows (temperature 0) and ``done`` rows take
    the argmax; the others scale by ``max(temperature, 1e-6)``, cut to
    their top-k by rank, and draw ``argmax(cut + gumbel(sub))`` with
    ``(key, sub) = split(key)``. A row's key advances only when it
    draws (the reference advances every row's key once any row draws;
    only a drawing row's key is read again before the next admission
    re-seeds it, so the draws are the same). ``logits`` [b, V],
    ``keys`` [b, 2] int64, ``temps`` [b] float32, ``top_ks`` [b] int64,
    ``done`` [b] bool. Returns (tokens [b] int64, keys [b, 2])."""
    greedy = torch.argmax(logits, dim=-1)
    draw = temps > 0.0
    if done is not None:
        draw = draw & ~done
    scaled = logits.float() / torch.clamp_min(temps, _TEMP_FLOOR)[:, None]
    cut = _rank_cut(scaled, top_ks)
    pair = split(keys)
    drawn = torch.argmax(cut + gumbel(pair[:, 1], (logits.shape[-1],)),
                         dim=-1)
    tok = torch.where(draw, drawn, greedy)
    return tok, torch.where(draw[:, None], pair[:, 0], keys)


def sample_logits(logits: torch.Tensor, key: torch.Tensor, temperature,
                  top_k: int, top_p: float = 1.0) -> torch.Tensor:
    """``generate``'s draw (``tony_tpu/models/generate.py``
    ``sample_logits``): greedy where ``temperature`` is 0, else the
    logits scaled by ``max(temperature, 1e-6)``, cut at the static
    ``top_k``-th value (ties at it kept) and to the static ``top_p``
    nucleus (a token survives when the mass strictly before it in a
    stable descending order is below ``top_p``; the first always does),
    then ``argmax(cut + gumbel(key))`` with one key [2] for the whole
    batch [b, V], as ``jax.random.categorical`` draws. ``temperature``
    is a float or a float32 device scalar (a graph's static buffer)."""
    greedy = torch.argmax(logits, dim=-1)
    if not torch.is_tensor(temperature):
        if temperature == 0.0:
            return greedy
        temperature = torch.full((), temperature, dtype=logits.dtype,
                                 device=logits.device)
    scaled = logits / torch.clamp_min(temperature, _TEMP_FLOOR)
    neg = torch.full_like(scaled, _NEG)
    if top_k > 0:
        kth = torch.topk(scaled, top_k, dim=-1).values[..., -1:]
        scaled = torch.where(scaled < kth, neg, scaled)
    if top_p < 1.0:
        order = torch.sort(-scaled, dim=-1, stable=True).indices
        probs = torch.softmax(torch.gather(scaled, -1, order).float(),
                              dim=-1)
        keep_sorted = (torch.cumsum(probs, dim=-1) - probs) < top_p
        keep_sorted[..., 0] = True
        keep = torch.empty_like(keep_sorted).scatter_(-1, order, keep_sorted)
        scaled = torch.where(keep, scaled, neg)
    drawn = torch.argmax(scaled + gumbel(key, tuple(scaled.shape)), dim=-1)
    return torch.where(temperature == 0.0, greedy, drawn)


def next_subkey(key: torch.Tensor) -> torch.Tensor:
    """``key, sub = split(key)`` as ``generate``'s scan carries its rng:
    ``key`` [2] advances in place; returns ``sub``."""
    pair = split(key)
    key.copy_(pair[0])
    return pair[1]


def key_from_generator(generator: torch.Generator | None,
                       device) -> torch.Tensor:
    """A [2] key read once from ``generator`` on the device (one
    ``torch.randint``, no host read); ``PRNGKey(0)``'s words when there
    is no generator, as the JAX ``generate`` defaults."""
    if generator is None:
        return key_tensor(0, device)
    return torch.randint(0, 2 ** 32, (2,), generator=generator,
                         dtype=torch.int64, device=device)
