"""The port's device-side sampler (``tony_tpu_torch.ops.sampling``) held
against ``jax.random`` and the JAX package's two samplers on the CPU.

- Bits: ``PRNGKey``, ``split``, ``bits`` and ``uniform`` equal
  ``jax.random``'s exactly (Threefry-2x32 in int64 tensor operations,
  ``jax_threefry_partitionable`` on) over a grid of seeds and shapes;
  ``gumbel`` to within 2^-21 relative and absolute: XLA's ``log`` and
  ``torch.log`` part in the last ulp (at most 2.4e-7 over this grid).
- Per-row draws (the serving engine's ``sample_rows``) against
  ``tony_tpu/serve/engine.py`` ``_sample_rows`` on fp32 logits made from
  a seed, over 40 steps of key advance: temperatures 0, 0.7 and 1.5,
  top-k 0, 1, 5 and V, exact ties at rank k, ``done`` rows (the
  reference's frozen body zeroes their temperature). Tokens are equal;
  a drawing row's key is equal, and a row that does not draw keeps its
  key (the reference advances it, unread).
- Distribution: 20000 draws a row at V = 32, each from its own seed,
  held to softmax over the row's top-k set by a chi-square test (p >
  1e-3; bins under 5 expected draws merged; fixed seeds, so the test is
  deterministic), and no token outside the set ever drawn.
- A request's draws do not depend on its batch: alone, or beside greedy,
  sampled and done rows, its tokens and keys are the same.
- ``generate``'s sampler: ``sample_logits`` with ``top_k`` and ``top_p``
  against ``tony_tpu/models/generate.py`` ``sample_logits`` on the same
  key (equal tokens) and by distribution; ties at the k-th value are
  kept. ``generate`` itself against the JAX ``generate`` with the key
  the port reads from its generator as ``rng``: equal tokens.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.stats import chisquare

from torch_parity import build_pair, tokens
from tony_tpu.models.generate import generate as jax_generate
from tony_tpu.models.generate import sample_logits as jax_sample_logits
from tony_tpu.serve.engine import _sample_rows as jax_sample_rows
from tony_tpu_torch.models.generate import generate
from tony_tpu_torch.ops import sampling

SEEDS = (0, 1, 7, 12345, -1, 2 ** 31 - 1, -2 ** 31)
SHAPES = ((5,), (3, 7), (2, 3, 4), (151,))
GUMBEL_TOL = 2.0 ** -21


def _jax_keys(seeds):
    return jnp.stack([jax.random.PRNGKey(s) for s in seeds])


def _keys(seeds):
    return torch.stack([sampling.key_tensor(s, "cpu") for s in seeds])


def _words(x):
    return np.asarray(x).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_bits_equal_jax_random(seed):
    jk = jax.random.PRNGKey(seed)
    tk = sampling.key_tensor(seed, "cpu")
    np.testing.assert_array_equal(_words(jk), tk.numpy())
    for n in (2, 3):
        np.testing.assert_array_equal(_words(jax.random.split(jk, n)),
                                      sampling.split(tk, n).numpy())
    for shape in SHAPES:
        np.testing.assert_array_equal(
            _words(jax.random.bits(jk, shape, jnp.uint32)),
            sampling.random_bits(tk, shape).numpy())
        np.testing.assert_array_equal(
            np.asarray(jax.random.uniform(jk, shape)),
            sampling.uniform(tk, shape).numpy())
        np.testing.assert_allclose(
            sampling.gumbel(tk, shape).numpy(),
            np.asarray(jax.random.gumbel(jk, shape)),
            rtol=GUMBEL_TOL, atol=GUMBEL_TOL)


def test_batched_keys_equal_vmapped_jax():
    seeds = list(range(6))
    want = jax.vmap(lambda k: jax.random.bits(k, (9,), jnp.uint32))(
        _jax_keys(seeds))
    np.testing.assert_array_equal(
        _words(want), sampling.random_bits(_keys(seeds), (9,)).numpy())
    want = jax.vmap(lambda k: jax.random.split(k, 2))(_jax_keys(seeds))
    np.testing.assert_array_equal(_words(want),
                                  sampling.split(_keys(seeds)).numpy())


V = 32


def _row_logits(seed, b, v=V):
    """fp32 logits [b, v] from a seed; row 3 has exact ties at ranks 4-6
    (a top-k of 5 cuts inside the tie), row 5 one value repeated."""
    x = np.random.default_rng(seed).standard_normal((b, v)).astype(
        np.float32) * 2.0
    if b > 3:
        order = np.argsort(-x[3], kind="stable")
        x[3, order[4:7]] = x[3, order[4]]
    if b > 5:
        x[5, :] = 0.5
    return x


# (temperature, top_k) a row: greedy, sampled with every cut, and a
# greedy row with a top-k (dead weight in the reference)
ROWS = ((0.0, 0), (0.7, 0), (1.5, 5), (0.7, 5), (1.5, 1), (0.7, V),
        (1.0, 5), (0.0, 5))


def test_per_row_draws_equal_the_reference():
    b = len(ROWS)
    temps = np.array([t for t, _ in ROWS], np.float32)
    top_ks = np.array([k for _, k in ROWS], np.int64)
    seeds = list(range(100, 100 + b))
    jkeys, tkeys = _jax_keys(seeds), _keys(seeds)
    drew = 0
    for step in range(40):
        logits = _row_logits(step, b)
        # rows 1 and 6 are done from step 10 and 20 on
        done = np.zeros(b, bool)
        done[1] = step >= 10
        done[6] = step >= 20
        jt = np.where(done, 0.0, temps).astype(np.float32)
        jtok, jkeys_next = jax_sample_rows(
            jnp.asarray(logits), jkeys, jnp.asarray(jt),
            jnp.asarray(top_ks, jnp.int32))
        ttok, tkeys_next = sampling.sample_rows(
            torch.from_numpy(logits), tkeys, torch.from_numpy(temps),
            torch.from_numpy(top_ks), torch.from_numpy(done))
        np.testing.assert_array_equal(np.asarray(jtok), ttok.numpy(),
                                      err_msg=f"step {step}")
        draws = (temps > 0) & ~done
        drew += int(draws.sum())
        np.testing.assert_array_equal(
            _words(jkeys_next)[draws], tkeys_next.numpy()[draws])
        # a row that does not draw keeps its key
        np.testing.assert_array_equal(tkeys_next.numpy()[~draws],
                                      tkeys.numpy()[~draws])
        # both go on from the same keys: the drawing rows' agree, and
        # the others' the reference advanced unread
        tkeys = tkeys_next
        jkeys = jnp.asarray(tkeys.numpy().astype(np.uint32))
        for i in np.flatnonzero((top_ks == 1) & (temps > 0)):
            assert int(ttok[i]) == int(np.argmax(logits[i]))
    assert drew > 150


def _chi2(draws: np.ndarray, probs: np.ndarray) -> float:
    """p-value of ``draws`` (token ids) against ``probs`` [V], bins under
    5 expected draws merged into one."""
    n = len(draws)
    seen = np.bincount(draws, minlength=len(probs))
    exp = probs * n
    small = exp < 5
    obs = np.append(seen[~small], seen[small].sum())
    want = np.append(exp[~small], exp[small].sum())
    if want[-1] == 0:
        obs, want = obs[:-1], want[:-1]
    return chisquare(obs, want * obs.sum() / want.sum()).pvalue


def _cut_probs(logits: np.ndarray, temp: float, k: int,
               by_rank: bool) -> np.ndarray:
    """Softmax over the kept set: the top k by stable rank, or every
    entry at or above the k-th value."""
    x = logits.astype(np.float64) / max(temp, 1e-6)
    keep = np.ones_like(x, bool)
    if 0 < k < len(x):
        if by_rank:
            keep[:] = False
            keep[np.argsort(-x, kind="stable")[:k]] = True
        else:
            keep = x >= np.sort(x)[-k]
    p = np.where(keep, np.exp(x - x[keep].max()), 0.0)
    return p / p.sum()


N_DRAWS = 20000


@pytest.mark.parametrize("temp,k", [(0.7, 0), (1.5, 5), (1.0, V),
                                    (0.7, 5)], ids=str)
def test_per_row_distribution(temp, k):
    row = _row_logits(3, 4)[3]  # ties at ranks 4-6
    logits = torch.from_numpy(np.tile(row, (N_DRAWS, 1)))
    keys = _keys(range(N_DRAWS))
    tok, _ = sampling.sample_rows(
        logits, keys, torch.full((N_DRAWS,), temp),
        torch.full((N_DRAWS,), k, dtype=torch.int64))
    probs = _cut_probs(row, temp, k, by_rank=True)
    drawn = tok.numpy()
    assert probs[drawn].min() > 0, "a token outside the top-k set"
    assert _chi2(drawn, probs) > 1e-3


def test_draws_do_not_depend_on_the_batch():
    """Row 0 (sampled, top-k 5) alone and beside greedy, sampled and done
    rows: the same tokens and keys, step after step."""
    alone_key, mixed_keys = _keys([42]), _keys([42, 1, 2, 3])
    temps = torch.tensor([0.9, 0.0, 1.2, 0.8])
    top_ks = torch.tensor([5, 0, 3, 0])
    done = torch.tensor([False, False, False, True])
    for step in range(20):
        logits = torch.from_numpy(_row_logits(50 + step, 4))
        a, alone_key = sampling.sample_rows(logits[:1], alone_key,
                                            temps[:1], top_ks[:1])
        m, mixed_keys = sampling.sample_rows(logits, mixed_keys, temps,
                                             top_ks, done)
        assert int(a[0]) == int(m[0])
        assert torch.equal(alone_key[0], mixed_keys[0])
    assert torch.equal(mixed_keys[3], _keys([3])[0])  # done: never drew


@pytest.mark.parametrize("k,p", [(0, 0.9), (5, 1.0), (5, 0.8), (0, 1.0)],
                         ids=str)
def test_generate_sampler_equals_the_reference(k, p):
    """The same key: equal tokens to ``jax.random.categorical``'s draw,
    over a batch of 6 rows and 30 keys."""
    logits = _row_logits(9, 6)
    for s in range(30):
        jk = jax.random.PRNGKey(s)
        want = jax_sample_logits(jnp.asarray(logits), jk, 0.8, k, p)
        got = sampling.sample_logits(torch.from_numpy(logits),
                                     sampling.key_tensor(s, "cpu"),
                                     torch.tensor(0.8), k, p)
        np.testing.assert_array_equal(np.asarray(want), got.numpy())


def test_generate_sampler_distribution_keeps_ties_at_k():
    """Top-k 5 over a row whose ranks 4-6 tie: every tied token is kept
    (the threshold is the k-th value), so 7 tokens are drawn, at
    softmax over them."""
    row = _row_logits(3, 4)[3]
    logits = torch.from_numpy(np.tile(row, (N_DRAWS, 1)))
    tok = sampling.sample_logits(logits, sampling.key_tensor(5, "cpu"),
                                 1.0, 5).numpy()
    probs = _cut_probs(row, 1.0, 5, by_rank=False)
    assert (probs > 0).sum() == 7
    assert set(np.unique(tok)) == set(np.flatnonzero(probs > 0))
    assert _chi2(tok, probs) > 1e-3


def test_generate_nucleus_distribution():
    """top_p 0.8 at temperature 1.5: the smallest set whose mass before
    each token is below 0.8, at softmax over it."""
    row = _row_logits(4, 1)[0]
    logits = torch.from_numpy(np.tile(row, (N_DRAWS, 1)))
    tok = sampling.sample_logits(logits, sampling.key_tensor(6, "cpu"),
                                 1.5, 0, 0.8).numpy()
    x = row.astype(np.float64) / 1.5
    order = np.argsort(-x, kind="stable")
    p = np.exp(x[order] - x.max())
    p /= p.sum()
    keep = np.zeros(V, bool)
    keep[order[(np.cumsum(p) - p) < 0.8]] = True
    assert 3 <= keep.sum() < V
    probs = np.where(keep, np.exp(x - x.max()), 0.0)
    probs /= probs.sum()
    assert probs[tok].min() > 0
    assert _chi2(tok, probs) > 1e-3


@pytest.mark.parametrize("penalty", [1.0, 1.3])
def test_sampled_generate_equals_jax_with_the_same_key(penalty):
    """The key the port reads from its generator, given to the JAX
    ``generate`` as ``rng``: equal tokens (fp32, eos ids on)."""
    jm, jp, tm = build_pair(2)
    prompt = tokens(8, (3, 6))
    kw = dict(max_new_tokens=10, temperature=0.8, top_k=20, top_p=0.95,
              eos_id=(7, 11), repetition_penalty=penalty)
    gen = torch.Generator().manual_seed(4)
    key = sampling.key_from_generator(
        torch.Generator().set_state(gen.get_state()), "cpu")
    got = generate(tm, prompt, generator=gen, **kw).numpy()
    want = np.asarray(jax_generate(jm, jp, jnp.asarray(prompt),
                                   rng=jnp.asarray(key.numpy(), jnp.uint32),
                                   **kw))
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got)) > 3
