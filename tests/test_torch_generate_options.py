"""The port's one-shot generation options held against the JAX package on
the same weights, in fp32, token for token:

- ``repetition_penalty`` 1.0 and 1.3 in ``generate`` (eager, and through
  the replayed step on the CPU stand-in for CUDA graphs of
  tests/test_torch_graphs.py, where the seen mask and the penalty are
  the step's own buffers), with and without eos ids; 1.0 gives what no
  penalty gives;
- ``beam_search``: tests/test_generate.py's eos-list case (frozen beams
  re-emit the first listed id; a tuple, a scalar and a list with a
  negative id decode alike), its numpy reference case (a brute-force
  beam search over full forwards, here of the port's own model), and
  ``num_beams=1`` against greedy; with a sliding window too.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_graphs import StandIn
from torch_parity import build_pair, tokens
from tony_tpu.models.generate import beam_search as jax_beam_search
from tony_tpu.models.generate import generate as jax_generate
from tony_tpu_torch.models.generate import (_penalize_repeats, beam_search,
                                            generate)
from tony_tpu_torch.models.graphs import GraphCache

EOS = (9, 33)


@pytest.fixture(scope="module")
def models():
    return build_pair(9)


def _jax(jm, jp, prompt, **kw):
    return np.asarray(jax_generate(jm, jp, jnp.asarray(prompt, jnp.int32),
                                   **kw))


@pytest.mark.parametrize("eos", [-1, EOS], ids=["no-eos", "eos"])
@pytest.mark.parametrize("penalty", [1.0, 1.3])
def test_repetition_penalty_matches_jax(models, penalty, eos):
    jm, jp, tm = models
    prompt = tokens(200, (3, 10))
    want = _jax(jm, jp, prompt, max_new_tokens=24, eos_id=eos,
                repetition_penalty=penalty)
    got = generate(tm, prompt, max_new_tokens=24, eos_id=eos,
                   repetition_penalty=penalty).numpy()
    assert (got == want).all()


def test_penalty_one_is_no_penalty(models):
    _, _, tm = models
    prompt = tokens(201, (2, 9))
    plain = generate(tm, prompt, max_new_tokens=16)
    assert torch.equal(generate(tm, prompt, max_new_tokens=16,
                                repetition_penalty=1.0), plain)
    assert not torch.equal(generate(tm, prompt, max_new_tokens=16,
                                    repetition_penalty=3.0), plain)


def test_penalize_repeats():
    logits = torch.tensor([[2.0, -2.0, 0.5, -0.5]])
    seen = torch.tensor([[True, True, False, False]])
    out = _penalize_repeats(logits, seen, 2.0)
    assert out.tolist() == [[1.0, -4.0, 0.5, -0.5]]
    assert torch.equal(_penalize_repeats(logits, seen, 1.0), logits)


@pytest.mark.parametrize("penalty", [1.0, 1.3])
def test_replayed_generate_with_penalty_matches_jax(models, penalty):
    """The replayed path on the stand-in: the seen mask and the penalty
    are the step graph's own buffers, refilled on every call."""
    jm, jp, tm = models
    tm.graphs = GraphCache("cpu", StandIn())
    try:
        for seed in (202, 203):
            prompt = tokens(seed, (2, 11))
            want = _jax(jm, jp, prompt, max_new_tokens=18, eos_id=EOS,
                        repetition_penalty=penalty)
            got = generate(tm, prompt, max_new_tokens=18, eos_id=EOS,
                           repetition_penalty=penalty).numpy()
            assert (got == want).all(), seed
        c = tm.graphs.counters(("generate",))
        assert c["generate_captures"] == 1 and c["generate_replays"] > 0
    finally:
        tm.graphs = None


def test_beam_search_eos_list_matches_jax(models):
    jm, jp, tm = models
    prompt = np.array([[1, 2]])
    first = int(beam_search(tm, prompt, max_new_tokens=1, num_beams=2)[0, 0])
    eos = (first, 63)
    want = np.asarray(jax_beam_search(jm, jp, jnp.asarray(prompt, jnp.int32),
                                      max_new_tokens=5, num_beams=2,
                                      eos_id=eos))
    got = beam_search(tm, prompt, max_new_tokens=5, num_beams=2,
                      eos_id=eos).numpy()
    assert (got == want).all()
    seen = False
    for t in got[0].tolist():
        if seen:
            assert t == first  # frozen to the FIRST listed id
        seen = seen or t in eos
    a = beam_search(tm, prompt, max_new_tokens=5, num_beams=2,
                    eos_id=(first,))
    b = beam_search(tm, prompt, max_new_tokens=5, num_beams=2, eos_id=first)
    c = beam_search(tm, prompt, max_new_tokens=5, num_beams=2,
                    eos_id=[first, -1])
    assert torch.equal(a, b) and torch.equal(c, b)


def _np_beam_search(model, prompt, steps: int, k: int):
    """Brute-force beam search: every beam rescored by a full forward of
    ``model`` each step, candidates sorted in numpy."""
    out = []
    for row in prompt:
        beams = [([], 0.0)]
        for _ in range(steps):
            cands = []
            for toks, score in beams:
                seq = torch.tensor([list(row) + toks])
                with torch.no_grad():
                    logp = torch.log_softmax(model(seq)[0, -1].float(),
                                             dim=-1).numpy()
                cands += [(toks + [v], score + float(logp[v]))
                          for v in range(logp.shape[0])]
            cands.sort(key=lambda c: -c[1])
            beams = cands[:k]
        out.append(max(beams, key=lambda c: c[1] / len(c[0]))[0])
    return np.asarray(out)


@pytest.mark.parametrize("window", [0, 6])
def test_beam_search_matches_jax_and_numpy(window):
    jm, jp, tm = build_pair(9, sliding_window=window)
    prompt = np.array([[3, 9, 1], [7, 2, 5]])
    want = np.asarray(jax_beam_search(jm, jp, jnp.asarray(prompt, jnp.int32),
                                      max_new_tokens=4, num_beams=3))
    got = beam_search(tm, prompt, max_new_tokens=4, num_beams=3).numpy()
    assert (got == want).all()
    assert (got == _np_beam_search(tm, prompt, 4, 3)).all()


def test_beam_search_one_beam_is_greedy(models):
    _, _, tm = models
    prompt = tokens(204, (2, 7))
    assert torch.equal(beam_search(tm, prompt, max_new_tokens=9,
                                   num_beams=1, eos_id=EOS),
                       generate(tm, prompt, max_new_tokens=9, eos_id=EOS))


def test_beam_search_longer_run_matches_jax(models):
    jm, jp, tm = models
    prompt = tokens(205, (2, 12))
    want = np.asarray(jax_beam_search(jm, jp, jnp.asarray(prompt, jnp.int32),
                                      max_new_tokens=20, num_beams=4,
                                      eos_id=EOS, length_penalty=0.7))
    got = beam_search(tm, prompt, max_new_tokens=20, num_beams=4,
                      eos_id=EOS, length_penalty=0.7).numpy()
    assert (got == want).all()
